"""Chunked solving: the iteration loop resumed from state at chunk boundaries.

Counterpart of `ipddp2tpu/chunked.py`. There, chunks exist because the TPU
runtime kills long device programs; here nothing runs long on the device
(`solve.run` is already a host loop), and the chunk boundaries remain as
the points where the host reads every lane's progress and acts on it:

  * per-lane iteration limits (`state.k + chunk`, capped at `total`), so a
    batch with heterogeneous progress advances every live lane;
  * the stall freeze (status 9, `stall_step`);
  * batch compaction: the still-running lanes gathered into a smaller
    batch, solved on, and scattered back;
  * `adapt_ls`: the hybrid line search's K chosen per chunk.

Resuming `run` with a higher limit continues the identical trajectory, so a
chunked solve without these takes the steps of the one-call solve.

Deliberate differences from the JAX package: the port is batch-first, so
there is no `batched` flag (B = 1 behaves like the JAX package's batched
call with one lane); and nothing is compiled, so there is no cache of
chunk runners. What a compaction rung costs the first time instead is the
capture of the CUDA graphs that `graphs.Graphed` keeps per shape (the plain
rollout): every rung captures its own once, so the rungs must stay few.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .autotune import tune
from .options import Options
from .problem import Bounds, Problem, batch_bounds
from .solve import (_solution, _to_device, initialize, resolve_device, run,
                    tree_map)

Tensor = torch.Tensor


def gather_lanes(tree, idx: Tensor):
    """Lanes `idx` of every tensor leaf of a state, bounds or theta."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def scatter_lanes(tree, idx: Tensor, sub):
    """`tree` with lanes `idx` replaced by the lanes of `sub`, in order."""
    return tree_map(lambda a, b: a.index_copy(0, idx, b), tree, sub)


class StallBaseline(NamedTuple):
    """Per-lane reference point of the stall rule (host tensors, [B])."""

    err: Tensor     # best max(primal, dual, cs) error so far
    mu: Tensor      # smallest barrier parameter so far
    k: Tensor       # iteration of the last improvement


def stall_step(baseline: Optional[StallBaseline], err: Tensor, mu: Tensor,
               k: Tensor, running: Tensor, window: int):
    """One chunk boundary of the stall rule: returns (baseline, stalled).

    A lane improves when its KKT error falls below its best by 1.2x or its
    mu below its smallest; a running lane that has not improved for
    `window` iterations is stalled. The first boundary only sets the
    baseline, with the error at +inf: `initialize` zeroes the error fields,
    so a baseline taken from them could never be improved on before the
    first mu decrease, and converging lanes would be frozen."""
    if baseline is None:
        return (StallBaseline(torch.full_like(err, float("inf")), mu,
                              k.to(torch.float64)),
                torch.zeros_like(running))
    improved = (err < baseline.err / 1.2) | (mu < baseline.mu)
    baseline = StallBaseline(
        err=torch.where(improved, err, baseline.err),
        mu=torch.minimum(mu, baseline.mu),
        k=torch.where(improved, k.to(torch.float64), baseline.k))
    return baseline, running & (k - baseline.k >= window)


def solve_chunked(problem: Problem, bounds: Bounds, x1, u_init, theta=None,
                  options: Optional[Options] = None, chunk: int = 25,
                  return_state: bool = False,
                  stall_window: Optional[int] = None,
                  compact_sizes=None, adapt_ls=None, device=None):
    """Solve a batch of instances (`x1` [B, nx], `u_init` [B, T, nu]) in
    chunks of at most `chunk` iterations resumed from state.

    `stall_window` (iterations) enables the stall freeze: a lane whose
    barrier parameter has not decreased AND whose KKT error has not
    improved by 1.2x over the window is frozen with status 9 (in a lockstep
    batch a stalled lane otherwise runs to the cap and so does the batch).
    `compact_sizes` and `adapt_ls`: see `run_chunked`. Runs on `device`
    (default: the GPU; raises without one)."""
    options = options or Options()
    device = resolve_device(device)
    options = tune(options, x1.shape[0], u_init.dtype, device)
    state = initialize(problem, theta, bounds, x1, u_init, options,
                       device=device)
    state = run_chunked(problem, bounds, state, theta, options, chunk=chunk,
                        stall_window=stall_window,
                        compact_sizes=compact_sizes, adapt_ls=adapt_ls,
                        device=device)
    sol = _solution(state)
    return (sol, state) if return_state else sol


def run_chunked(problem: Problem, bounds: Bounds, state, theta=None,
                options: Optional[Options] = None, chunk: int = 25,
                total=None, stall_window: Optional[int] = None,
                compact_sizes=None, adapt_ls=None, device=None):
    """Continue `run` from an existing state in chunks (the warm-start entry
    point of chunked execution).

    Iteration limits are per lane (state.k + chunk for the running ones),
    so a batch with heterogeneous progress, e.g. a warm-started second
    phase where some lanes already spent their budget, advances every live
    lane. `total` overrides options.max_iterations as the ceiling; it may
    be a per-lane int tensor `[B]` (e.g. `state.k + budget`).

    `adapt_ls` (ascending candidate Ks) picks, at each chunk boundary, the
    smallest K covering the 90th percentile of the running lanes' last
    line-search trial counts (`state.num_ls`). Only for the hybrid search
    (`ls_speculative > 0` with `ls_spec_continue`), whose accepted step, the
    largest acceptable one, does not depend on K; otherwise it is ignored.

    `compact_sizes` (batch sizes) enables batch compaction at chunk
    boundaries: when the running lanes fit a size of the schedule below the
    batch's, they are gathered (padded with non-running lanes up to the
    smallest size that fits) into a smaller batch that goes on in chunks,
    and scattered back on return. In a lockstep batch a finished lane still
    pays for every iteration; compaction stops that. Not together with
    `stall_window` (the stall freeze is a phase-1 tool, compaction a
    phase-2 one)."""
    options = options or Options()
    device = resolve_device(device)
    state, theta = _to_device(state, device), _to_device(theta, device)
    B = state.k.shape[0]
    bounds = batch_bounds(_to_device(bounds, device), B)
    if total is None:
        total = options.max_iterations
    total = torch.as_tensor(total).cpu().to(torch.int64).expand(B)
    if compact_sizes:
        if stall_window is not None:
            raise ValueError("compact_sizes does not go with stall_window")
        compact_sizes = tuple(sorted({int(s) for s in compact_sizes},
                                     reverse=True))
    if adapt_ls:
        if options.ls_speculative <= 0 or not options.ls_spec_continue:
            adapt_ls = None     # only the hybrid search is K-invariant
        else:
            adapt_ls = tuple(sorted({int(k) for k in adapt_ls}))

    baseline = None
    while True:
        # the host reads every lane's progress: one synchronization a chunk
        k_now = state.k.cpu().to(torch.int64)
        status = state.status.cpu()
        running = (~state.converged.cpu() & ((status == 0) | (status == 8))
                   & (k_now < total))
        if stall_window is not None:
            err = torch.maximum(state.primal_inf,
                                torch.maximum(state.dual_inf, state.cs_inf))
            baseline, stalled = stall_step(baseline, err.cpu(),
                                           state.mu.cpu(), k_now, running,
                                           stall_window)
            if bool(stalled.any()):
                state = state._replace(status=torch.where(
                    stalled.to(device), torch.full_like(state.status, 9),
                    state.status))
                running = running & ~stalled
        if not bool(running.any()):
            break
        if compact_sizes:
            r = int(running.sum())
            fit = [s for s in compact_sizes if r <= s < B]
            if fit:
                idx = torch.cat([torch.nonzero(running)[:, 0],
                                 torch.nonzero(~running)[:, 0]])[:min(fit)]
                lanes = idx.to(device)
                # the padding lanes do not run: the recursion's own running
                # mask keeps them as they are
                sub = run_chunked(problem, gather_lanes(bounds, lanes),
                                  gather_lanes(state, lanes),
                                  gather_lanes(theta, lanes), options,
                                  chunk=chunk, total=total[idx],
                                  compact_sizes=compact_sizes, device=device)
                return scatter_lanes(state, lanes, sub)
        if adapt_ls:
            num_ls = state.num_ls.cpu()
            if bool((num_ls > 0).any()):
                # the smallest K covering the running lanes' p90 depth (lanes
                # beyond it fall to the sequential continuation)
                d90 = float(torch.quantile(
                    num_ls[running].to(torch.float64), 0.9))
                K = next((k for k in adapt_ls if k >= d90), adapt_ls[-1])
                if K != options.ls_speculative:
                    options = dataclasses.replace(options, ls_speculative=K)
        # clear the chunk-limit stops of the running lanes
        state = state._replace(status=torch.where(
            (running & (status == 8)).to(device),
            torch.zeros_like(state.status), state.status))
        k_next = torch.where(running, torch.minimum(k_now + chunk, total),
                             k_now)
        state = run(problem, bounds, state, theta, options,
                    k_limit=k_next.to(device), device=device)
    return state
