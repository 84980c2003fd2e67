"""Mixed-precision continuation: f32 bulk phase + f64 certification endgame.

Counterpart of `ipddp2tpu/mixed.py`. The barrier path down to mu ~ 1e-4 is
insensitive to f32 rounding, so the bulk of the iterations can run in f32;
the state that reached the phase-1 tolerance is then promoted to f64 and
warm-starts the endgame, which alone certifies the 1e-7 KKT point (eps_f32
~ 1.2e-7 cannot). The JAX package has this because the TPU emulates f64;
the H100 has native FP64, so whether the f32 phase saves anything here is a
measurement (`chip_smoke.py`), not an assumption.

Products stay in the working type in both phases: `solve.resolve_device`
turns TF32 off on a GPU, as the JAX bench sets matmul precision "highest".

Not ported: the JAX package's `_host_final_wave` and the
`rescue_host_final` argument of `solve_mixed_chunked`, which re-solve on the
host CPU in native f64 the instances that the TPU's double-single kernels
(a ~49-bit mantissa) leave on a dual-infeasibility plateau. Here the f64
phases run in native FP64 on the card, so there is nothing to escape from;
passing `rescue_host_final` raises `TypeError`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .autotune import tune
from .chunked import gather_lanes, run_chunked, scatter_lanes, solve_chunked
from .derivatives import evaluate_constraints, relax_constraints
from .forward import barrier_lagrangian
from .options import Options
from .problem import Bounds, Problem, batch_bounds
from .solve import (SolverState, _reset_filter, _solution, _to_device,
                    initialize, resolve_device, run, tree_map)


def _cast_state(state, dtype):
    """A state (or bounds, theta, any nested tuple of tensors) with its
    floating-point leaves in `dtype`; integer and bool leaves stay."""
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    state)


def promote_state(problem: Problem, bounds: Bounds, state: SolverState,
                  theta, options: Options, device=None) -> SolverState:
    """Cast an f32 state to f64 and refresh the merit bookkeeping in full
    precision: constraints, barrier Lagrangian and objective recomputed,
    the filter reset, status and convergence cleared."""
    device = resolve_device(device)
    s = _cast_state(_to_device(state, device), torch.float64)
    theta = _to_device(theta, device)
    bounds = batch_bounds(_to_device(bounds, device), s.x.shape[0])
    c_raw = evaluate_constraints(problem, theta, s.x, s.u)
    c_rel = relax_constraints(problem, c_raw, s.mu)
    L, J = barrier_lagrangian(problem, theta, bounds, s.x, s.u, c_rel,
                              s.phi, s.il, s.iu, s.mu)
    empty = s.mu.new_zeros((s.mu.shape[0], options.filter_capacity, 2))
    return s._replace(
        c_raw=c_raw, objective=J, L_curr=L,
        theta_curr=c_rel.abs().sum(dim=(1, 2)),
        filter_pts=_reset_filter(empty, s.max_primal_1),
        filter_n=torch.ones_like(s.filter_n),
        status=torch.zeros_like(s.status),
        converged=torch.zeros_like(s.converged))


def _phase1_options(options: Options, phase1_tolerance,
                    phase1_max_iterations) -> Options:
    p1_max = min(options.max_iterations,
                 phase1_max_iterations or options.max_iterations)
    return dataclasses.replace(options, optimality_tolerance=phase1_tolerance,
                               max_iterations=p1_max)


def solve_mixed(problem: Problem, bounds: Bounds, x1, u_init, theta=None,
                options: Optional[Options] = None,
                phase1_tolerance: float = 3e-4,
                phase1_max_iterations: Optional[int] = None,
                return_state: bool = False, device=None):
    """Two-phase solve of a batch (`x1` [B, nx], `u_init` [B, T, nu]; the
    inputs may be f32 or f64): phase 1 in f32 to `phase1_tolerance`, phase 2
    in f64 to `options.optimality_tolerance`.

    `phase1_max_iterations` caps the f32 phase separately: the iteration
    budget (`options.max_iterations`) is shared across the phases (k
    carries through the promotion), so without a cap an f32-stalled lane
    burns its whole budget before the f64 endgame can rescue it."""
    options = options or Options()
    device = resolve_device(device)
    f32, f64 = torch.float32, torch.float64
    opts32 = _phase1_options(options, phase1_tolerance, phase1_max_iterations)
    bounds32, theta32 = _cast_state(bounds, f32), _cast_state(theta, f32)
    s32 = initialize(problem, theta32, bounds32, x1.to(f32), u_init.to(f32),
                     opts32, device=device)
    s32 = run(problem, bounds32, s32, theta32, opts32, device=device)

    bounds64, theta64 = _cast_state(bounds, f64), _cast_state(theta, f64)
    s64 = promote_state(problem, bounds64, s32, theta64, options,
                        device=device)
    s64 = run(problem, bounds64, s64, theta64, options, device=device)
    sol = _solution(s64)
    return (sol, s64) if return_state else sol


def solve_mixed_chunked(problem: Problem, bounds: Bounds, x1, u_init,
                        theta=None, options: Optional[Options] = None,
                        phase1_tolerance: float = 3e-4, chunk: int = 25,
                        phase1_max_iterations: Optional[int] = None,
                        phase2_max_iterations: Optional[int] = None,
                        phase2_ls_speculative: Optional[int] = None,
                        phase1_stall_window: Optional[int] = None,
                        rescue_failed=True,
                        rescue_ls_speculative: Optional[int] = None,
                        rescue_max_iterations: Optional[int] = None,
                        phase2_chunk: Optional[int] = None,
                        phase2_compact=False,
                        phase1_adapt_ls=None,
                        return_info: bool = False, device=None):
    """Chunked two-phase solve of a batch: the f32 bulk phase, then the f64
    endgame, each with `chunked.run_chunked`.

    `phase1_max_iterations`: see `solve_mixed`. `phase2_max_iterations`
    caps each lane's f64 iterations beyond its promotion point: endgames
    take ~6-25 f64 iterations, but a lane whose f32 phase FAILED (not
    merely hit its tolerance) would start a near-full-length f64 rescue.
    `phase2_ls_speculative` sets the endgame's K (over the tuned one).
    `phase1_stall_window` and `phase1_adapt_ls`: the phase-1 solve's
    `stall_window` and `adapt_ls` (`chunked`).

    `phase2_compact`: gather the still-running lanes into a smaller batch
    at phase-2 chunk boundaries (`phase2_chunk`, default `chunk`: keep it
    well below the phase-2 cap, or there are no boundaries to compact at).
    True = powers of two from half the batch down to 64; or a tuple of
    sizes.

    `rescue_failed`: what becomes of lanes whose f32 phase FAILED (stalled
    or capped without reaching the phase-1 tolerance):
      * True — promote them anyway; the f64 endgame re-solves them in
        lockstep with the healthy batch (correct, and the whole batch waits
        for them);
      * False — deny them the endgame and report their f32 status;
      * "restart" — deny them the lockstep endgame, then solve them again
        from scratch in pure f64 as a batch of their own, padded to the
        smallest compaction rung (64 without `phase2_compact`) that holds
        them, after the endgame of the healthy lanes;
        `rescue_ls_speculative` and `rescue_max_iterations` override K and
        the iteration cap of that batch.

    `return_info`: also return a dict of host tensors that attributes every
    lane's path: "p1" and "p2" (converged, status, k and the KKT errors at
    the end of each phase) and "rescue" (None, or its lane indices and the
    same fields of the rescued lanes).

    The JAX package's `rescue_host_final` (a host-CPU native-f64 wave after
    the rescue) is not ported: it exists because the TPU's f64 is
    double-single arithmetic; the f64 phases here run in native FP64.
    Passing it raises TypeError. Nor is its `batched` flag: the port is
    batch-first."""
    options = options or Options()
    device = resolve_device(device)
    f32, f64 = torch.float32, torch.float64
    opts32 = _phase1_options(options, phase1_tolerance, phase1_max_iterations)
    _, s32 = solve_chunked(problem, _cast_state(bounds, f32), x1.to(f32),
                           u_init.to(f32), theta=_cast_state(theta, f32),
                           options=opts32, chunk=chunk, return_state=True,
                           stall_window=phase1_stall_window,
                           adapt_ls=phase1_adapt_ls, device=device)
    info = {"p1": _phase_snapshot(s32)} if return_info else None

    B = s32.k.shape[0]
    b64 = batch_bounds(_to_device(_cast_state(bounds, f64), device), B)
    th64 = _to_device(_cast_state(theta, f64), device)
    opts64 = tune(options, B, f64, device)
    if phase2_ls_speculative is not None:
        # an explicit K beats the table; the other tuned knobs still apply
        opts64 = dataclasses.replace(opts64,
                                     ls_speculative=phase2_ls_speculative)
    s64 = promote_state(problem, b64, s32, th64, opts64, device=device)
    k64 = s64.k.cpu().to(torch.int64)
    total2 = None
    if phase2_max_iterations is not None:
        total2 = torch.clamp(k64 + phase2_max_iterations,
                             max=options.max_iterations)
    healthy = s32.converged
    if rescue_failed is not True:
        # deny the endgame to lanes whose f32 phase failed: in a lockstep
        # batch one near-full-length f64 re-solve drags every lane along
        base = (torch.full_like(k64, options.max_iterations)
                if total2 is None else total2)
        total2 = torch.where(healthy.cpu(), base, k64)
        # keep their f32 status (promote_state cleared it)
        s64 = s64._replace(status=torch.where(healthy, s64.status,
                                              s32.status))
    compact = None
    if phase2_compact is True:
        compact = tuple(reversed([1 << i for i in range(B.bit_length())
                                  if 64 <= 1 << i < B])) or None
    elif phase2_compact:
        compact = tuple(phase2_compact)
    s64 = run_chunked(problem, b64, s64, th64, opts64,
                      chunk=phase2_chunk or chunk, total=total2,
                      compact_sizes=compact, device=device)
    if return_info:
        info["p2"] = _phase_snapshot(s64)
        info["rescue"] = None

    if rescue_failed == "restart":
        failed = torch.nonzero(~s64.converged.cpu())[:, 0]
        if failed.numel():
            real = _restart(problem, b64, th64, x1, u_init, failed, options,
                            compact or (64,), phase2_chunk or chunk,
                            rescue_ls_speculative, rescue_max_iterations,
                            device)
            s64 = scatter_lanes(s64, failed.to(device), real)
            if return_info:
                info["rescue"] = {"indices": failed, **_phase_snapshot(real)}

    sol = _solution(s64)
    return (sol, info) if return_info else sol


def _restart(problem: Problem, bounds: Bounds, theta, x1, u_init, failed,
             options: Options, rungs, chunk, ls_speculative, max_iterations,
             device) -> SolverState:
    """Solve lanes `failed` from scratch in pure f64 as a batch of their
    own, padded to the smallest of the (descending) `rungs` that holds them,
    else to the whole batch, and compacted below it; returns the state of
    the real lanes. The padding lanes repeat failed instances (the same
    work in a lockstep batch). The K and the cap default to `options`'; the
    tune table is not consulted."""
    n = failed.numel()
    target = next((s for s in reversed(rungs) if n <= s), x1.shape[0])
    lanes = torch.cat([failed, failed[torch.arange(target - n) % n]])
    lanes = lanes.to(device)
    opts = dataclasses.replace(
        options, auto_tune=False,
        ls_speculative=(options.ls_speculative if ls_speculative is None
                        else ls_speculative),
        max_iterations=(options.max_iterations if max_iterations is None
                        else max_iterations))
    f64 = torch.float64
    _, state = solve_chunked(
        problem, gather_lanes(bounds, lanes),
        gather_lanes(x1.to(device=device, dtype=f64), lanes),
        gather_lanes(u_init.to(device=device, dtype=f64), lanes),
        theta=gather_lanes(theta, lanes), options=opts, chunk=chunk,
        return_state=True,
        compact_sizes=tuple(s for s in rungs if s < target) or None,
        device=device)
    return gather_lanes(state, torch.arange(n, device=device))


def _phase_snapshot(state: SolverState) -> dict:
    """Host copies of the per-lane fields that attribute failures."""
    return {f: getattr(state, f).cpu()
            for f in ("converged", "status", "k",
                      "primal_inf", "dual_inf", "cs_inf", "mu")}
