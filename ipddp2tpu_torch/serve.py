"""Continuous-batching solve pool: the serving layer (PyTorch port).

Counterpart of `ipddp2tpu/serve.py`. A lockstep batch runs until its
slowest instance has converged, while long-converged instances hold their
slots. These pools keep a fixed number of device slots busy instead:
after every chunk of iterations, slots whose instance has converged or
failed are harvested into the result set and refilled with fresh instances
from the queue, as continuous batching does in LLM serving. Per-slot
iteration limits ride `run(k_limit=...)` as a `[slots]` tensor, so freshly
seated instances and veterans advance together in one loop, and idle slots
are frozen with their limit at their own counter.

Two pools, as in the JAX package:
  * `solve_pool` harvests and refills on the host: after each chunk it reads
    the slots' counters and flags, copies finished slots' solutions to the
    host and seats new instances one by one;
  * `solve_pool_resident` keeps the queue on the device: the reservoir of
    instance data, result buffers with one dump row at index n, and the
    seat bookkeeping are device tensors; each chunk scatters finished slots
    into the buffers, ranks them by a cumulative sum and seats the next
    instances of the queue from a batched `initialize` gathered at their
    indices. The host reads one scalar per chunk ("every slot retired")
    beyond what `run` reads itself.

Both return the solutions on the host (CPU tensors, leading axis = the
instances, in input order). Their `occupancy` is each function's own, as in
the JAX package: `solve_pool` divides the useful slot-iterations by the
slot-iterations of the slots that were live in a chunk, the resident pool by
every slot of every chunk, retired slots included.

The JAX package's docstring gives pool and lockstep rates measured on a TPU
(5.71 and 23.93 instances a second at 512 instances, 256 slots, chunk 40,
float32 to 3e-4): TPU figures, not comparable with the port's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .options import Options
from .problem import Bounds, Problem, batch_bounds
from .solve import (Solution, SolverState, _to_device, initialize,
                    resolve_device, run, tree_map)

Tensor = torch.Tensor

# the SolverState fields a Solution is made of, in Solution's order
_OUT_FIELDS = ("x", "u", "phi", "zl", "zu", "lam", "objective", "k",
               "status", "converged", "primal_inf", "dual_inf", "cs_inf",
               "mu")


class PoolResult(NamedTuple):
    solutions: Solution      # leading axis = number of instances
    chunks: int              # device steps executed
    occupancy: float         # mean fraction of useful slot-iterations


def _take(tree, idx):
    return tree_map(lambda a: a[idx], tree)


def _inputs(bounds, x1, u_init, theta, device):
    x1, u_init = x1.to(device), u_init.to(device)
    bounds = batch_bounds(_to_device(bounds, device), x1.shape[0])
    return bounds, x1, u_init, _to_device(theta, device)


def solve_pool(problem: Problem, bounds: Bounds, x1: Tensor, u_init: Tensor,
               theta=None, options: Optional[Options] = None,
               slots: int = 16, chunk: int = 20,
               device=None) -> PoolResult:
    """Solve N stacked instances using `slots` device slots, harvesting and
    refilling on the host.

    All tensor arguments carry the instance axis (N >= slots; bounds may be
    `[T, nu]`, shared). Returns per-instance Solutions in input order.
    `occupancy`: useful iterations over `chunk` times the slots that were
    live in each chunk. Runs on `device` (default the GPU; raises without
    one)."""
    options = options or Options()
    device = resolve_device(device)
    bounds, x1, u_init, theta = _inputs(bounds, x1, u_init, theta, device)
    n = x1.shape[0]
    assert n >= slots, "need at least as many instances as slots"

    idxs = torch.arange(slots, device=device)
    slot_bounds = _take(bounds, idxs)
    slot_theta = _take(theta, idxs)
    state = initialize(problem, slot_theta, slot_bounds, x1[:slots],
                       u_init[:slots], options, device=device)
    active = list(range(slots))        # instance index seated in each slot
    seated = slots
    live = torch.ones(slots, dtype=torch.bool)

    results = [None] * n
    chunks = 0
    useful = 0
    total_slot_iters = 0

    def seat(tree, slot, fresh):
        def put(a, f):
            a = a.clone()
            a[slot] = f[0]
            return a
        return tree_map(put, tree, fresh)

    while bool(live.any()):
        k_now = state.k.cpu()
        k_limits = torch.where(live, k_now + chunk, k_now)  # idle: frozen
        state = run(problem, slot_bounds, state, slot_theta, options,
                    k_limit=k_limits.to(device), device=device)
        chunks += 1
        status, conv, k_after = (state.status.cpu(), state.converged.cpu(),
                                 state.k.cpu())
        useful += int((k_after - k_now)[live].sum())
        total_slot_iters += int(live.sum()) * chunk

        # finished = converged, hard failure, or true iteration budget spent
        finished = live & (conv | ((status != 0) & (status != 8))
                           | (k_after >= options.max_iterations))
        # slots that merely hit the chunk cap continue
        resume = live & ~finished & (status == 8)
        if bool(resume.any()):
            state = state._replace(status=torch.where(
                resume.to(device), torch.zeros_like(state.status),
                state.status))

        for slot in torch.nonzero(finished)[:, 0].tolist():
            results[active[slot]] = [getattr(state, f)[slot].cpu()
                                     for f in _OUT_FIELDS]
            if seated < n:
                i = seated
                one = slice(i, i + 1)
                fresh = initialize(problem, _take(theta, one),
                                   _take(bounds, one), x1[one], u_init[one],
                                   options, device=device)
                state = seat(state, slot, fresh)
                slot_bounds = seat(slot_bounds, slot, _take(bounds, one))
                slot_theta = seat(slot_theta, slot, _take(theta, one))
                active[slot] = i
                seated += 1
            else:
                live[slot] = False

    solutions = Solution(*(torch.stack(leaves) for leaves in zip(*results)))
    return PoolResult(solutions=solutions, chunks=chunks,
                      occupancy=useful / max(total_slot_iters, 1))


def solve_pool_resident(problem: Problem, bounds: Bounds, x1: Tensor,
                        u_init: Tensor, theta=None,
                        options: Optional[Options] = None,
                        slots: int = 16, chunk: int = 20,
                        device=None) -> PoolResult:
    """`solve_pool` with the harvest / refill queue on the device.

    The reservoir (instance data), the result buffers and the seat
    bookkeeping are device tensors. Each chunk advances every slot, scatters
    the finished slots' solutions into the result buffers (unfinished and
    idle slots into a dump row at index n), and re-seats fresh instances
    from the reservoir in queue order; the host reads a single "all done"
    scalar per chunk and copies the results once at the end.

    A retired slot reads the data of the instance it last held, where the
    JAX package gathers the last instance's: the results are the same, but
    the port's iteration runs the line search of every lane that its state
    does not mark converged, and a state evaluated against another
    instance's data would walk the backtracking loop to its end, holding
    every other lane, in each iteration.
    `occupancy`: useful iterations over `chunk` times every slot of every
    chunk, retired slots included (the JAX package's definition for this
    pool)."""
    options = options or Options()
    device = resolve_device(device)
    bounds, x1, u_init, theta = _inputs(bounds, x1, u_init, theta, device)
    n = x1.shape[0]
    assert n >= slots, "need at least as many instances as slots"

    def init(idx):
        return initialize(problem, _take(theta, idx), _take(bounds, idx),
                          x1[idx], u_init[idx], options, device=device)

    state = init(torch.arange(slots, device=device))
    # result buffers with one DUMP row at index n: unfinished / idle slots
    # scatter there. Only the Solution fields are buffered.
    out = {f: getattr(state, f).new_zeros((n + 1,)
                                          + getattr(state, f).shape[1:])
           for f in _OUT_FIELDS}
    active = torch.arange(slots, device=device)
    held = active.clone()      # the instance whose data each slot reads
    seated = torch.tensor(slots, device=device)
    useful = torch.zeros((), dtype=torch.int64, device=device)
    chunks = 0
    while True:
        live = active < n
        k0 = state.k
        k_lim = torch.where(live, k0 + chunk, k0)       # idle slots frozen
        state = run(problem, _take(bounds, held), state, _take(theta, held),
                    options, k_limit=k_lim, device=device)
        useful = useful + torch.where(live, state.k - k0, 0).sum()

        finished = live & (state.converged
                           | ((state.status != 0) & (state.status != 8))
                           | (state.k >= options.max_iterations))
        resume = live & ~finished & (state.status == 8)
        state = state._replace(status=torch.where(
            resume, torch.zeros_like(state.status), state.status))

        # harvest: scatter finished slots' states into the result buffers
        dst = torch.where(finished, active, n)
        for f in _OUT_FIELDS:
            out[f][dst] = getattr(state, f)

        # refill: rank finished slots; seat reservoir instances in order
        ranks = torch.cumsum(finished.to(torch.int64), 0) - 1
        new_idx = torch.where(finished, seated + ranks, n)
        valid = new_idx < n
        fresh = init(torch.clamp(new_idx, max=n - 1))
        put = finished & valid
        state = SolverState(*(
            torch.where(put.reshape((-1,) + (1,) * (f.dim() - 1)), f, s)
            for s, f in zip(state, fresh)))
        active = torch.where(finished, torch.where(valid, new_idx, n),
                             active)
        held = torch.where(put, new_idx, held)
        seated = torch.clamp(seated + finished.sum(), max=n)
        chunks += 1
        if bool((active >= n).all()):          # one scalar read
            break

    solutions = Solution(*(out[f][:n].cpu() for f in _OUT_FIELDS))
    return PoolResult(solutions=solutions, chunks=chunks,
                      occupancy=int(useful) / max(chunks * slots * chunk, 1))
