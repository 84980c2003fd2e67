"""Traffic driver `closed_batches`: a user's campaign, a closed loop of
lockstep batches through `ipddp2tpu_torch.batch.solve_batch`.

The mix file gives the batch size B and the line search: `hybrid`, K = 8
step sizes at once and then backtracking (the options of the upstream
benchmark script), or `backtracking`.

The cell's B instances are drawn in set-up from a fixed key: every run of
the cell solves the same instances. Each batch of the window holds all of
them, in a new lane order drawn from `--seed`. A lockstep batch lasts as
long as its slowest lane, so fresh draws would change the work from seed
to seed and from batch to batch; in this way a window of one batch and a
window of two do the same work a batch.

The window holds whole batches: after a batch returns, the next is
submitted only if the window so far plus the longest batch so far stays
within the seconds asked for. At least one batch runs.

A traced run profiles iterations of its first batch (`TRACE_SLICES`, see
`devicetrace.IterationLog`): the device alone, which the per-layer metrics
read, and with the host's operators, which name the idle gaps.
"""

import dataclasses
import itertools
import time

import torch

from devicetrace import IterationLog
from judge import map_instances

POOL_KEY = 1            # the instances' draw, the same in every run
HYBRID_K = 8            # step sizes a hybrid line search tries at once
WARMUP_ITERATIONS = 3
TRACE_SLICES = {"warmup": (100, 102), "device": (110, 130),
                "host": (135, 138)}


def port_inputs(ctx, inst, dtype):
    """The program's arguments for one batch: (problem, bounds, x1,
    u_init, theta) on the device in `dtype`."""
    from ipddp2tpu_torch.problem import Bounds
    cfg, dev = ctx.cfg, ctx.device
    to = lambda a: a.to(device=dev, dtype=dtype)
    B, T, nu = inst["x1"].shape[0], cfg["T"], cfg["nu"]
    stage = lambda a: to(a)[:, None, :].expand(B, T, nu)
    bounds = Bounds(lower=stage(inst["lower"]), upper=stage(inst["upper"]))
    u0 = torch.tensor(cfg["u_init"], dtype=dtype, device=dev).expand(
        B, T, nu)
    theta = ctx.model.Theta(**{k: to(v) for k, v in inst["theta"].items()})
    return ctx.model.problem(), bounds, to(inst["x1"]), u0, theta


def options(ctx, **changes):
    """The cell's solver options: the configuration's, the mix's line
    search, then `changes`."""
    from ipddp2tpu_torch.options import Options
    search = ({"ls_speculative": HYBRID_K, "ls_spec_continue": True}
              if ctx.traffic["search"] == "hybrid" else {})
    return dataclasses.replace(Options(**ctx.cfg["options"], **search),
                               **changes)


def next_batch(ctx):
    """The next batch's inputs on the device: the cell's instances in the
    next lane order of the seed. The instances, as ordered, are kept for
    the judge in `ctx.batches_in`."""
    lanes = torch.randperm(ctx.traffic["batch"], generator=ctx.order)
    inst = map_instances(ctx.pool, lambda a: a[lanes].contiguous())
    ctx.batches_in.append(inst)
    return port_inputs(ctx, inst, ctx.dtype)


def setup(ctx):
    """Draw the instances, put the first batch on the device, and warm up:
    a solve of a few iterations at the cell's full shapes (kernels built
    and loaded, the rollout graph captured, the allocator grown)."""
    ctx.pool = ctx.instances.draw(ctx.cfg, ctx.traffic["batch"],
                                  torch.Generator().manual_seed(POOL_KEY))
    ctx.order = torch.Generator().manual_seed(ctx.seed)
    ctx.batches_in = []
    ctx.inputs = next_batch(ctx)
    ctx.options = options(ctx)
    problem, bounds, x1, u0, theta = ctx.inputs
    ctx.solve(problem, bounds, x1, u0, theta=theta,
              options=options(ctx, max_iterations=WARMUP_ITERATIONS),
              device=ctx.device, trace=IterationLog())
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def window(ctx):
    """Run whole batches for `ctx.seconds`; returns the batch records."""
    records = []
    start = time.perf_counter()
    for i in itertools.count():
        problem, bounds, x1, u0, theta = (ctx.inputs if i == 0
                                          else next_batch(ctx))
        log = IterationLog(TRACE_SLICES if ctx.trace and i == 0 else None)
        t0 = log.t0 = time.perf_counter()
        sol = ctx.solve(problem, bounds, x1, u0, theta=theta,
                        options=ctx.options, device=ctx.device, trace=log)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        log.close()
        records.append({"index": i, "seconds": t1 - t0, "log": log,
                        "solution": sol})
        longest = max(r["seconds"] for r in records)
        if t1 - start + longest > ctx.seconds:
            break
    ctx.window_s = time.perf_counter() - start
    return records
