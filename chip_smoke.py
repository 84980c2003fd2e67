#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on an NVIDIA H100, end to end.

    python3 chip_smoke.py [--batch 2048] [--max-iterations 1000] [--ptxas]
                          [--kernels-only] [--log FILE] [--turns]
                          [--parent DIR]

Needs one CUDA device of compute capability 9.0 and `nvcc`; with no device it
exits non-zero at the first phase. It imports `torch` and `ipddp2tpu_torch`
only. Phases, each printing one JSON line:

  device     the card, its capability, its power limit and highest SM
             clock;
  build      compiles every kernel from the sources in this checkout, all
             `nvcc` processes started together: the backward sweep (concar,
             double integrator, a tiny nc=0 model), the forward kernels of
             the same three and the chain probes; prints the compiler's
             registers, spills and stack of every kernel and the sweep's
             launch geometry (lanes per instance, instances and shared
             memory per block);
  kernels    holds every kernel against its plain PyTorch version on the
             card, at the main path's shapes (a mid-solve concar state, B
             lanes, T=100, K=8) and on the small models, with some lanes
             perturbed so that flags of both values occur; times kernel and
             plain version and computes each kernel's lower bound. A
             kernel's `ms` is from replaying a CUDA graph of 10 launches
             through its wrapper (the wrapper's host time left out),
             `ms_eager` from 10 back-to-back Python calls. For the sweep
             also a crafted batch on which a pivot search spread over lanes
             can go wrong (exact ties, a NaN diagonal, exact zero pivots) in
             all three dimensions, batches that do not fill their last
             block (B - 3 and 1), its time at 256 to 8192 lanes, the time of
             preparing its inputs, and its cycle counters. For the metrics
             kernel (K3) also its checks at K = 1, 3, 8, 13, 40 on B, B - 3
             and 1 lanes of all three models (`metrics_grid`) and its time
             at 256 to 8192 lanes (`metrics_scaling`);
  probes     the two chain probes, driven once at their size;
  graphs     the rollout replayed from a CUDA graph equals the eager one;
  solve_hybrid_f64  the flat solve in pure f64: `solve_batch` on concar at
             its published size (T=100), B instances (lane 0 = the
             reference's seed-1 instance), float64, tolerance 1e-7, hybrid
             line search (K=8 speculative step sizes, then backtracking)
             through the sweep, forward-metrics and forward-trial kernels;
             checks lane 0 against the golden result and that >= 95 % of
             the lanes converge; prints how the accepted step sizes are
             distributed;
  solve_mixed  THE MAIN PATH, as `bench.py` runs it: `solve_mixed_chunked` on
             the same batch, an f32 bulk phase to 3e-4 (K1 and the f32
             forward kernels), the f64 endgame compacted at rungs B/2 to
             B/16, the restart rescue of the lanes that failed in f32 (f64
             kernels on the compacted and padded batches); prints each
             phase's seconds, lanes converged and iterations, the rungs
             visited and the launches at each; checks lane 0 against the
             golden objective (rtol 1e-4, dual error < 1e-7), that >= 95 %
             of the lanes converge and that K1 ran; `mixed_vs_pure` puts
             its wall time beside the flat solve's;
  mixed_rescue  the first 128 lanes with a 120-iteration f32 phase in
             chunks of 5, the stall freeze and the adaptive K: checks that
             the rescue takes exactly the lanes phase 2 left unconverged and
             solves >= 95 % of them;
  residue    the 24 round-5 residue instances (the port's data file) through
             the mixed solve and from scratch in pure f64: each lane's
             status, iterations and KKT errors (checks that they are
             finite);
  turns      with --turns: the flat pure-f64 solve and the mixed solve in
             turns on the same batch (pure, mixed, mixed, pure);
  solve_hybrid_f32  30 iterations of the same in float32;
  solve_f64  the pure backtracking path (graph-replayed plain rollout,
             sweep kernel) at 64 lanes, same gates;
  backtrack_cuda  20 iterations of pure backtracking with the forward-trial
             kernel as the rollout;
  phases     a timed split of a few mid-solve iterations into the solver's
             phases, with the backtracking and with the hybrid forward pass;
  parent_and_change  with --parent DIR (a checkout of the parent commit):
             K3 built from that checkout's source under another stem and
             K3 of this tree in turns (parent, change, change, parent): K3's
             time in both types and the hybrid solve with each.

Any failed assertion or exception ends the run with a non-zero exit code and
without the last line. The last three lines are the kernels' JSON object
(`launches`: the main path's, `solve_mixed`), the card's name and power
limit, and the result object.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from ipddp2tpu_torch import (Options, Problem, solve_batch, solve_chunked,
                             solve_mixed_chunked)
from ipddp2tpu_torch import chunked
from ipddp2tpu_torch.backward import (backward_pass, costate_scan,
                                      sweep_plain)
from ipddp2tpu_torch.derivatives import (contract_dynamics_hessian,
                                         evaluate_derivatives,
                                         relax_constraints)
from ipddp2tpu_torch import graphs
from ipddp2tpu_torch.forward import (forward_pass, forward_pass_hybrid,
                                     rollout)
from ipddp2tpu_torch.mixed import _cast_state
from ipddp2tpu_torch.models import concar, double_integrator
from ipddp2tpu_torch.ops import backward_cuda, build, forward_cuda
from ipddp2tpu_torch.ops import probe_chain
from ipddp2tpu_torch.ops.backward_cuda import (backward_sweep_cuda,
                                               launch_geometry,
                                               prepare_sweep, sweep_prepared)
from ipddp2tpu_torch.ops.forward_cuda import (forward_metrics_cuda,
                                              forward_metrics_plain,
                                              forward_trial_cuda,
                                              forward_trial_plain,
                                              metrics_geometry)
from ipddp2tpu_torch.ops.profile_sweep import (CRAFTED_LANES, SECTIONS,
                                               crafted_inputs)
from ipddp2tpu_torch.problem import Bounds
from ipddp2tpu_torch.solve import (SolverState, _nominal_trial, initialize,
                                   iteration)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): device
# memory rate, and the vector (non-tensor-core) rates the sweep can use.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
# Clocks from the start of a floating-point multiply or multiply-add to the
# start of one that needs its result: 4 is the least on NVIDIA SMs since
# Volta (Jia et al., "Dissecting the NVIDIA Volta GPU Architecture via
# Microbenchmarking", 2018: 4 for FMUL/FFMA, 8 for DMUL/DFMA). Taken for
# both types, so that the probes' latency bound stays a lower bound.
DEPENDENT_OP_CLOCKS = 4
# kernel-vs-plain tolerances, relative to each tensor's scale. Sweep gains:
# both sides do the same arithmetic in another order (and the kernel with
# fused multiply-adds), so they differ by rounding amplified by the KKT
# systems' conditioning. Forward measures and trials: the same closed-loop
# rollout of T dependent stages with fused multiply-adds and the device's
# sin/cos/log on one side and PyTorch's on the other, the rounding fed back
# through the gains at every stage and summed over T stages.
TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
# ... and for the forward candidates that leave the interior (they fail the
# boundary test and are never accepted): there slacks and duals run through
# zero, where the feedback gains (Sigma = z / s, 1e8 and more) amplify one
# rounding by up to that much, on either side
TOL_OUTSIDE = {torch.float64: 1e-6, torch.float32: 1e-2}
GAIN_NAMES = ("alpha", "beta", "psi", "omega", "chi_l", "zeta_l", "chi_u",
              "zeta_u")


LOG = None          # --log: a file that gets every phase line as well
STARTED = time.perf_counter()


def emit(phase, **fields):
    line = json.dumps({"phase": phase, **fields,
                       "elapsed": time.perf_counter() - STARTED})
    print(line, flush=True)
    if LOG is not None:
        with open(LOG, "a") as f:
            f.write(line + "\n")


def tiny_problem():
    """nx=2, nu=3, T=6 without constraints: the nc=0 instantiation."""
    def dynamics(x, u, t, theta):
        return torch.stack([
            x[0] + 0.1 * x[1] + 0.05 * u[0] + 0.01 * torch.sin(u[1]),
            x[1] + 0.1 * u[0] - 0.02 * x[0] * u[2]])

    def cost(x, u, t, theta):
        return ((x ** 2).sum() + 0.1 * (u ** 2).sum()
                + 0.01 * x[0] * u[1] + 0.001 * u[0] ** 3)

    def terminal(x, theta):
        return 2.0 * (x ** 2).sum() + 0.1 * x[0] * x[1]

    return Problem(T=6, nx=2, nu=3, nc=0, dynamics=dynamics, stage_cost=cost,
                   terminal_cost=terminal, device_model="tiny_nc0")


def concar_batch(batch, dtype, device, seed):
    """Lane 0 is the reference's seed-1 instance, the rest are random."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    theta, f_lim, tau_lim, x1 = concar.random_instances(
        batch, gen, dtype=torch.float64, device=device)
    th1, f1, tau1, x11 = concar.seed1_instance(device=device)
    theta.obstacles[0] = th1.obstacles
    f_lim[0], tau_lim[0], x1[0] = f1, tau1, x11
    theta = concar.Theta(theta.obstacles.to(dtype))
    bounds = concar.bounds(f_lim, tau_lim, dtype=dtype, device=device)
    u0 = concar.initial_controls(dtype, device).expand(
        batch, concar.T, concar.NU)
    return theta, bounds, x1.to(dtype), u0


def sweep_inputs(problem, theta, s):
    """The 21 tensors one backward sweep reads, as the solver's iteration
    prepares them from a state; reg is the one the state last passed with."""
    deriv = evaluate_derivatives(problem, theta, s.x, s.u, s.phi)
    c_rel = relax_constraints(problem, s.c_raw, s.mu)
    lam = costate_scan(deriv, s.phi)
    sec = deriv.cH_phi + contract_dynamics_hessian(
        problem, theta, s.x, s.u, lam[:, 1:])
    reg = torch.zeros_like(s.mu) if s.reg_last is None else s.reg_last
    return [deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
            deriv.luu, deriv.cx, deriv.cu, sec, c_rel, s.il, s.iu, s.phi,
            s.zl, s.zu, deriv.lTx, deriv.lTxx, s.mu, reg,
            torch.zeros_like(s.mu)]


def perturb(args, nu):
    """Vary (reg, delta_c) over the lanes and make every 16th lane's control
    Hessian indefinite, so that the inertia test fails there."""
    args = [a.contiguous().clone() for a in args]
    B = args[18].shape[0]
    lane = torch.arange(B, device=args[0].device)
    args[6][lane % 16 == 3] -= 50.0 * torch.eye(
        nu, dtype=args[6].dtype, device=args[6].device)
    args[19] = torch.where(lane % 4 == 1, 8.0 * args[19] + 1e-3, args[19])
    args[20] = torch.where(lane % 8 == 2, 1e-8, 0.0).to(args[18].dtype)
    return args


def sweep_flops(T, nx, nu, nc, refine):
    """Floating-point operations of one instance's sweep (a multiply-add
    counts two), from the dimensions: the work does not depend on the data."""
    m, nk = nu + nc, nx + 1
    tri = sum(m - 1 - j for j in range(m))
    factor = sum(2 * (m - 1 - j) ** 2 + (m - 1 - j) for j in range(m))
    solve = nk * (4 * tri + m)
    resid = 2 * m * m * nk
    assemble = (2 * nx * nx * (nu + nx)          # fuV, fxV
                + 2 * nx * nx * (nx + nu)        # C, B
                + 2 * nu * nu * nx               # H
                + 2 * nu * (nx + nc) + 8 * nu)   # Qu, Sigma
    value = 2 * m * nx * (nx + 1) + 2 * nx * (nx + nc) + 2 * m
    gains = 6 * nu + 2 * nu * nx
    per_stage = (factor + (1 + refine) * (solve + resid) + resid // nk
                 + assemble + value + gains)
    return T * per_stage


def cuda_ms(fn, reps):
    """ms per call of `fn` over `reps` back-to-back calls from Python:
    a kernel's wrapper costs its host time here too (checks, ctypes)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps, replays=3):
    """ms per call of `fn` from replaying a CUDA graph that holds `reps`
    calls, captured on inputs made beforehand: the launches (the wrapper's
    ctypes call launches on the capturing stream) and whatever the wrapper
    does on the device are in, its host time is out."""
    fn()                                     # build, allocator, first use
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (reps * replays)


def borderline(args, dims, rtol):
    """Lanes whose plain residual lies within 10x of the gate: their `fail`
    flips between rtol/10 and rtol*10."""
    lo = sweep_plain(*args, **dims, rtol=rtol / 10.0)[2]
    hi = sweep_plain(*args, **dims, rtol=rtol * 10.0)[2]
    return lo != hi


def check_kernel(name, args, dims, rtol, time_reps, need_both=True):
    """Kernel against plain on the same inputs; returns the measured fields."""
    dtype = args[18].dtype
    out_k = backward_sweep_cuda(*args, **dims, rtol=rtol)
    torch.cuda.synchronize()
    out_p = sweep_plain(*args, **dims, rtol=rtol)
    (gk, dLk, fk, sk), (gp, dLp, fp, sp) = out_k, out_p
    edge = borderline(args, dims, rtol)
    firm = ~edge
    assert bool((fk == fp)[firm].all()), f"{name}: fail flags differ"
    assert bool((sk == sp)[firm & fp].all()), f"{name}: singular flags differ"
    ok = firm & ~fp
    assert not need_both or (int(ok.sum()) > 0 and int(fp.sum()) > 0), \
        f"{name}: need passing and failing lanes ({int(ok.sum())} pass)"
    max_abs, max_rel, per_out = 0.0, 0.0, {}
    for gname, a, b in list(zip(GAIN_NAMES, gk, gp)) + [("dL", dLk, dLp)]:
        a, b = a[ok], b[ok]
        if b.numel() == 0:
            continue
        assert bool(torch.isfinite(a).all()), f"{name}: {gname} not finite"
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-300)
        per_out[gname] = rel
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
    assert max_rel <= TOL[dtype], \
        f"{name}: max relative error {max_rel} > {TOL[dtype]}: {per_out}"
    fields = dict(max_abs_err=max_abs, max_rel_err=max_rel, rel_err=per_out,
                  lanes=int(fp.numel()), lanes_failing=int(fp.sum()),
                  lanes_borderline=int(edge.sum()))
    if time_reps:
        kernel = lambda: backward_sweep_cuda(*args, **dims, rtol=rtol)
        fields["ms"] = graph_ms(kernel, time_reps)
        fields["ms_eager"] = cuda_ms(kernel, time_reps)
        fields["plain_ms"] = cuda_ms(
            lambda: sweep_plain(*args, **dims, rtol=rtol), 1)
        nbytes = sum(a.numel() * a.element_size() for a in args)
        nbytes += sum(g.numel() * g.element_size() for g in gk)
        nbytes += dLk.numel() * dLk.element_size() + 2 * fk.numel()
        B, T = args[11].shape[0], args[11].shape[1]
        flops = B * sweep_flops(T, dims["nx"], dims["nu"], dims["nc"],
                                dims["refine"])
        fields.update(kernel_bound(nbytes, flops, dtype))
    return fields


def check_crafted(name, dims, dtype, device, rtol):
    """The crafted lanes (ties, NaN diagonal, zero pivots) through the
    kernel: every flag as the plain version sets it and as the lane was
    built to give, gains within tolerance on the passing lanes. Six lanes
    never fill a block, so this is a ragged batch too."""
    args = crafted_inputs(dims["nx"], dims["nu"], dims["nc"], dtype, device)
    fields = check_kernel(name, args, dims, rtol, 0)
    assert fields["lanes_borderline"] == 0, f"{name}: borderline lanes"
    _, _, fail, sing = backward_sweep_cuda(*args, **dims, rtol=rtol)
    want_fail = [False, False, True, True, True, False]
    want_sing = [False, False, False, True, True, False]
    assert fail.tolist() == want_fail, f"{name}: fail {fail.tolist()}"
    assert sing.tolist() == want_sing, f"{name}: singular {sing.tolist()}"
    return dict(lanes=list(CRAFTED_LANES), fail=fail.tolist(),
                singular=sing.tolist(), max_rel_err=fields["max_rel_err"],
                max_abs_err=fields["max_abs_err"])


def sweep_scaling(args, dims, rtol, sizes, reps):
    """The sweep's time by batch size (the main shapes' inputs cut or
    repeated to B lanes), the time of preparing the inputs when every one of
    them has to be copied, and the cycle counters at the full batch."""
    B0 = args[18].shape[0]
    times = {}
    for B in sizes:
        rep = -(-B // B0)
        sized = [torch.cat([a] * rep)[:B].contiguous() for a in args]
        times[str(B)] = graph_ms(
            lambda: backward_sweep_cuda(*sized, **dims, rtol=rtol), reps)
        del sized
    shape = {k: dims[k] for k in ("nx", "nu", "nc")}
    # slices of wider tensors, as the Jacobians arrive from the derivatives
    wide = [torch.cat([a, a], dim=-1)[..., :a.shape[-1]] for a in args[:19]]
    prepare_ms = graph_ms(lambda: prepare_sweep(*wide, **shape), reps)
    prepared = prepare_sweep(*args[:19], **shape)
    launch_ms = graph_ms(lambda: sweep_prepared(
        prepared, args[19], args[20], refine=dims["refine"], rtol=rtol), reps)
    prof = torch.zeros(len(SECTIONS), dtype=torch.int64,
                       device=args[0].device)
    backward_sweep_cuda(*args, **dims, rtol=rtol, profile=prof)
    torch.cuda.synchronize()
    geo = launch_geometry(**shape)
    blocks = -(-B0 // geo.instances_per_block)
    T = args[11].shape[1]
    return dict(ms_by_batch=times, prepare_ms_all_inputs_copied=prepare_ms,
                launch_ms_on_prepared_inputs=launch_ms,
                cycles_per_stage_of_a_block_first_warp={
                    k: c / (T * blocks)
                    for k, c in zip(SECTIONS, prof.tolist())})


# a (nested) tuple of tensors (a state, gains, bounds), or None, in another
# floating type; integer and bool tensors stay
cast_tree = _cast_state


def forward_args(problem, theta, bounds, s, gains, options):
    """What the forward kernels' wrappers take up to `tau`, from a state and
    the gains of a backward pass."""
    tau = torch.clamp(1.0 - s.mu, min=options.tau_min)
    return [problem, theta, bounds.lower.contiguous(),
            bounds.upper.contiguous(), tuple(gains), s.x, s.u, s.phi, s.zl,
            s.zu, s.il, s.iu, s.mu, tau]


def perturb_forward(args):
    """Every 16th lane gets an infinite feedforward entry mid-horizon (its
    candidates are not finite), another 16th a dual step that crosses zero
    for the large step sizes (the boundary test fails there)."""
    args = list(args)
    gains = [g.clone() for g in args[4]]
    lane = torch.arange(args[6].shape[0], device=args[6].device)
    T = args[6].shape[1]
    gains[0][lane % 16 == 5, T // 2, 0] = float("inf")              # alpha
    gains[4][lane % 16 == 7, 1] = -10.0 * args[8][lane % 16 == 7, 1]  # chi_l
    args[4] = tuple(gains)
    return args


def forward_flops(problem, lanes):
    """Operations of `lanes` rollouts (a multiply-add counts two, a sin, cos
    or log one): the affine rows, the boundary test, the barrier terms and
    about 60 for the model's stage. The work does not depend on the data."""
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    rows = 3 * nu + nc
    per_stage = rows * (2 * nx + 2) + nx + 8 * nu + 4 * nc + 4 * nu + 60
    return lanes * problem.T * per_stage


def rel_err(a, b, where=None):
    """max |a - b| over the finite entries of b (inside `where`), absolute
    and relative to their largest magnitude; infinities must coincide."""
    if where is not None:
        a, b = a[where], b[where]
    fin = torch.isfinite(b)
    assert bool((torch.isfinite(a) == fin).all()), "finiteness differs"
    assert bool((a[~fin] == b[~fin]).all()), "infinities differ"
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((a[fin] - b[fin]).abs().max())
    return err, err / max(float(b[fin].abs().max()), 1e-300)


TRIAL_NAMES = ("x", "u", "phi", "zl", "zu", "il", "iu", "c_raw")
# K of the hybrid search on the main path: the JAX package's value for large
# float64 batches, a starting value and not one tuned on this card
SPECULATIVE = 8
# lanes of the pure backtracking path, which is driven at a smaller size
SMALL_BATCH = 64


def boundary_edge(trial, args, tol):
    """Lanes whose fraction-to-the-boundary test lies within rounding of its
    threshold in the plain trial: |current - (1-tau) nominal| <= tol times
    the scale of the quantity (for a slack, that of the control it is the
    difference of). Their flag may flip between kernel and plain."""
    x, u, phi, zl, zu, il, iu, c = trial
    ubar, zlbar, zubar, ilbar, iubar, tau = (args[6], args[8], args[9],
                                             args[10], args[11], args[13])
    s = (1.0 - tau)[:, None, None]
    edge = torch.zeros_like(tau, dtype=torch.bool)
    for nom, cur, ref in ((ilbar, il, u), (iubar, iu, u), (zlbar, zl, zlbar),
                          (zubar, zu, zubar)):
        d = cur - s * nom
        scale = torch.maximum(cur.abs().nan_to_num(posinf=0.0),
                              ref.abs().nan_to_num(nan=0.0, posinf=0.0))
        # (0 against 0, a dual at an absent bound, is exact on both sides)
        near = torch.isfinite(d) & (d.abs() <= tol * scale) & (scale > 0)
        edge |= near.flatten(1).any(dim=1)
    return edge


def _held(failures, name, what, per_kernel, per_plain, tol, wide):
    """Record a failure unless every tensor's kernel error is within `tol`
    or (float32) 4x the plain version's own error against float64."""
    for key, rel in per_kernel.items():
        limit = max(tol, 4.0 * per_plain.get(key, 0.0)) if wide else tol
        if not rel <= limit:
            failures.append(f"{name}: {what} {key}: {rel} > {limit}")


def _fold(kernel, plain, ref, where, acc_kernel, acc_plain, key, wide):
    """Fold one tensor's errors against `ref` on `where` into the
    per-tensor maxima; returns the absolute error."""
    err, rel = rel_err(kernel, ref, where)
    acc_kernel[key] = max(acc_kernel.get(key, 0.0), rel)
    if wide:
        acc_plain[key] = max(acc_plain.get(key, 0.0),
                             rel_err(plain, ref, where)[1])
    return err


def hold_metrics(name, mk, mp, mr, edge, dtype, need_both_flags, failures):
    """K3's outputs `mk` against the plain version's `mp` and the reference
    `mr` (`mp` itself in float64; in float32 the float64 plain version on
    the same inputs). The finite flags everywhere, the boundary flags away
    from the threshold (`edge [B, K]`), the measures inside the boundary
    and theta, J on every finite candidate (L takes the log of a negative
    slack outside). Appends to `failures`; returns the measured fields."""
    wide = dtype != torch.float64
    fin_k, ftb_k, fin_p, ftb_p = mk[3], mk[4], mp[3], mp[4]
    fin_r = fin_p & mr[3]
    if not bool((fin_k == fin_p).all()):
        failures.append(f"{name}: finite flags differ on "
                        f"{int((fin_k != fin_p).sum())} candidates")
    firm = fin_p & ~edge
    if not bool((ftb_k == ftb_p)[firm].all()):
        failures.append(f"{name}: boundary flags differ on "
                        f"{int((ftb_k != ftb_p)[firm].sum())} firm "
                        "candidates")
    if need_both_flags and not (
            int((~fin_p).sum()) > 0 and int((fin_p & ~ftb_p).sum()) > 0
            and int((fin_p & ftb_p).sum()) > 0):
        failures.append(f"{name}: need non-finite, boundary-failing and "
                        "passing candidates")
    inside = fin_r & ftb_p & mr[4] & ~edge
    m_abs, m_kernel, m_plain, m_out_kernel, m_out_plain = 0.0, {}, {}, {}, {}
    for mname, i in (("theta", 0), ("L", 1), ("J", 2)):
        m_abs = max(m_abs, _fold(mk[i], mp[i], mr[i], inside, m_kernel,
                                 m_plain, mname, wide))
        if mname != "L":
            _fold(mk[i], mp[i], mr[i], fin_r, m_out_kernel, m_out_plain,
                  mname, wide)
    _held(failures, name, "measure", m_kernel, m_plain, TOL[dtype], wide)
    _held(failures, name, "measure (all finite candidates)", m_out_kernel,
          m_out_plain, TOL_OUTSIDE[dtype], wide)
    fields = dict(
        max_abs_err=m_abs, max_rel_err=max(m_kernel.values(), default=0.0),
        rel_err=m_kernel, rel_err_all_finite=m_out_kernel,
        against="plain float64" if wide else "plain",
        inside=int(inside.sum()), candidates=int(fin_p.numel()),
        not_finite=int((~fin_p).sum()),
        boundary_failing=int((fin_p & ~ftb_p).sum()),
        borderline=int((fin_p & edge).sum()),
        boundary_flags_differing_on_borderline=int(
            ((ftb_k != ftb_p) & fin_p & edge).sum()))
    if wide:
        fields.update(plain_rel_err=m_plain,
                      plain_rel_err_all_finite=m_out_plain)
    return fields


def wide_args(args, dtype):
    """The float64 reference's inputs: `args` themselves in float64, the
    same (float32) inputs cast to float64 otherwise."""
    if dtype == torch.float64:
        return args
    return [args[0]] + [cast_tree(a, torch.float64) for a in args[1:]]


def same_type(t, dtype):
    return [a.to(dtype) if a.is_floating_point() else a for a in t]


def candidate_steps(K, dtype, device):
    """The hybrid search's K candidates 2^-k, built on the host (exact)."""
    return torch.tensor([0.5 ** i for i in range(K)], dtype=dtype,
                        device=device)


def kernel_bound(nbytes, flops, dtype):
    """The least time for the work: bytes over the memory rate against
    operations over the vector rate, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_forward(name, args, K, dtype, time_reps, need_both_flags):
    """K3 and K4 against their plain versions on the same inputs.

    float64: kernel against plain, relative to each tensor's scale: TOL on
    the candidates that stay inside the boundary, TOL_OUTSIDE on the rest.
    float32: the rollout feeds its rounding back through gains of 1e3 and
    more for T stages, so two float32 evaluations of one trajectory part by
    far more than rounding on the worst lanes, whatever computes them. Both
    the kernel and the float32 plain version are therefore held against the
    plain version in float64 on the same (float32) inputs, and the kernel
    must come as close to it as the plain version does, within a factor 4,
    or within the tolerances above. Returns the measured fields of the
    metrics and of the trial kernel and the list of failed checks."""
    problem = args[0]
    B, device = args[6].shape[0], args[6].device
    gammas = candidate_steps(K, dtype, device)
    tol = TOL[dtype]
    wide = dtype != torch.float64
    ref_args = wide_args(args, dtype)
    failures = []

    mk = forward_metrics_cuda(*args, gammas)
    torch.cuda.synchronize()
    mp = forward_metrics_plain(*args, gammas)
    mr = (same_type(forward_metrics_plain(*ref_args,
                                          gammas.to(torch.float64)), dtype)
          if wide else mp)
    fin_r = mp[3] & mr[3]

    # K4 at every candidate step size: the trial, and which lanes sit on the
    # boundary test's threshold there
    edge = torch.zeros((B, K), dtype=torch.bool, device=device)
    lanes = torch.arange(B, device=device)
    mixed = [None] * 8
    t_abs, t_kernel, t_plain, t_out_kernel, t_out_plain = 0.0, {}, {}, {}, {}
    inside = fin_r & mp[4] & mr[4]
    for k in range(K):
        g = gammas[k].expand(B).contiguous()
        tk = forward_trial_cuda(*args, g)
        torch.cuda.synchronize()
        tp = forward_trial_plain(*args, g)
        tr = (same_type(forward_trial_plain(*ref_args, g.to(torch.float64)),
                        dtype) if wide else tp)
        edge[:, k] = boundary_edge(tp, args, tol)
        for tname, a, b, r in zip(TRIAL_NAMES, tk, tp, tr):
            if b[0].numel() == 0:
                continue
            t_abs = max(t_abs, _fold(a, b, r, inside[:, k], t_kernel,
                                     t_plain, tname, wide))
            _fold(a, b, r, fin_r[:, k], t_out_kernel, t_out_plain, tname,
                  wide)
        pick = lanes % K == k
        mixed = [r if m is None else
                 torch.where(pick.reshape((-1,) + (1,) * (r.dim() - 1)), r, m)
                 for m, r in zip(mixed, tr)]
    _held(failures, name, "trial", t_kernel, t_plain, tol, wide)
    _held(failures, name, "trial (all finite candidates)", t_out_kernel,
          t_out_plain, TOL_OUTSIDE[dtype], wide)
    # one launch with a different step size on every lane
    g_mixed = gammas[lanes % K].contiguous()
    tk = forward_trial_cuda(*args, g_mixed)
    torch.cuda.synchronize()
    ok = inside[lanes, lanes % K]
    _held(failures, name, "mixed-gamma trial",
          {n: rel_err(a, b, ok)[1]
           for n, a, b in zip(TRIAL_NAMES, tk, mixed) if b[0].numel()},
          t_plain, tol, wide)

    metrics = hold_metrics(name, mk, mp, mr, edge, dtype, need_both_flags,
                           failures)
    trial = dict(max_abs_err=t_abs, max_rel_err=max(t_kernel.values()),
                 rel_err=t_kernel, rel_err_all_finite=t_out_kernel,
                 against=metrics["against"])
    if wide:
        trial.update(plain_rel_err=t_plain,
                     plain_rel_err_all_finite=t_out_plain)
    if time_reps:
        size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        theta_leaves = [] if args[1] is None else list(args[1])
        shared = [args[2], args[3], *args[4], *args[5:10], *theta_leaves]
        for fields, kernel, plain, reads, writes, lanes_n in (
                (metrics, lambda: forward_metrics_cuda(*args, gammas),
                 lambda: forward_metrics_plain(*args, gammas),
                 shared + list(args[10:14]) + [gammas], mk, B * K),
                (trial, lambda: forward_trial_cuda(*args, g_mixed),
                 lambda: forward_trial_plain(*args, g_mixed),
                 shared + [g_mixed], tk, B)):
            fields["ms"] = graph_ms(kernel, time_reps)
            fields["ms_eager"] = cuda_ms(kernel, time_reps)
            fields["plain_ms"] = cuda_ms(plain, 1)
            fields.update(kernel_bound(size(reads) + size(writes),
                                       forward_flops(problem, lanes_n),
                                       dtype))
    return metrics, trial, failures


# the K and batch sizes at which K3 is held against its plain version
METRICS_KS = (1, 3, 8, 13, 40)


def check_metrics(name, args, K, dtype, need_both_flags=False):
    """K3 alone against its plain version at K candidates, held as
    `check_forward` holds it; the plain versions (and the plain trials that
    mark the boundary test's threshold) run on 8 candidates at a time."""
    B, device = args[6].shape[0], args[6].device
    gammas = candidate_steps(K, dtype, device)
    wide = dtype != torch.float64
    ref_args = wide_args(args, dtype)
    mk = forward_metrics_cuda(*args, gammas)
    torch.cuda.synchronize()
    parts_p, parts_r, edges = [], [], []
    for g in gammas.split(8):
        parts_p.append(forward_metrics_plain(*args, g))
        parts_r.append(same_type(forward_metrics_plain(
            *ref_args, g.to(torch.float64)), dtype) if wide else parts_p[-1])
        # the plain trials of these candidates, as B * len(g) lanes
        rep = repeat_candidates(args, g.shape[0])
        edges.append(boundary_edge(forward_trial_plain(*rep, g.repeat(B)),
                                   rep, TOL[dtype]).reshape(B, -1))
    mp = [torch.cat(p, dim=1) for p in zip(*parts_p)]
    mr = [torch.cat(p, dim=1) for p in zip(*parts_r)]
    failures = []
    fields = hold_metrics(name, mk, mp, mr, torch.cat(edges, dim=1), dtype,
                          need_both_flags, failures)
    return fields, failures


def map_lanes(args, fn):
    """The forward wrappers' arguments with `fn` applied to every
    lane-indexed tensor (theta's leaves, bounds, gains, state, mu, tau)."""
    out = list(args)
    out[1] = None if args[1] is None else type(args[1])(
        *(fn(x) for x in args[1]))
    out[2:4] = [fn(a) for a in args[2:4]]
    out[4] = tuple(fn(g) for g in args[4])
    out[5:14] = [fn(a) for a in args[5:14]]
    return out


def repeat_candidates(args, K):
    """Every lane repeated K times in place (lane b's candidates are lanes
    b*K .. b*K+K-1), as `forward_metrics_plain` lays them out."""
    return map_lanes(args, lambda a: a.repeat_interleave(K, dim=0))


def metrics_grid(label, args, dtype, batch):
    """K3 at every K of METRICS_KS on `batch` lanes and on ragged batches
    (batch - 3 and 1): max relative error by K and B. Raises on a failed
    check."""
    errs, failures = {}, []
    for B in (batch, batch - 3, 1):
        sized = lanes_of(args, B)
        for K in METRICS_KS:
            fields, bad = check_metrics(f"{label}/B={B}/K={K}", sized, K,
                                        dtype)
            errs[f"B={B},K={K}"] = fields["max_rel_err"]
            failures += bad
    assert not failures, "\n".join(failures)
    return errs


def lanes_of(args, B):
    """The forward wrappers' arguments cut or repeated to B lanes."""
    rep = -(-B // args[6].shape[0])
    return map_lanes(args, lambda a: torch.cat([a] * rep)[:B].contiguous())


def metrics_scaling(args, dtype, K, sizes, reps):
    """K3's time by batch size (the main shapes' inputs cut or repeated to
    B lanes), from graph replay."""
    gammas = candidate_steps(K, dtype, args[6].device)
    times = {}
    for B in sizes:
        sized = lanes_of(args, B)
        times[str(B)] = graph_ms(
            lambda: forward_metrics_cuda(*sized, gammas), reps)
        del sized
    return times


def check_probes(dtype, device, batch, steps, seed, sm_mhz):
    """P1 and P2 against their plain versions (and P1 in double against the
    closed form); times and bounds like any kernel, and a latency bound:
    each is a chain of `steps` dependent operations (P1 a multiply, P2 the
    one multiply-add a step that carries position, heading and speed to the
    next step: the sine and cosine feed no later step), which takes at least
    DEPENDENT_OP_CLOCKS clocks each at the SM's highest clock `sm_mhz`."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, dtype=torch.float64)
    c = 1.0000001
    x0 = (0.5 + 0.5 * rand(8, batch)).to(device, dtype)
    x1 = torch.stack([rand(batch), rand(batch), 0.3 + 0.6 * rand(batch),
                      0.1 + 0.4 * rand(batch)], dim=1).to(device, dtype)
    u = (rand(batch, steps, concar.NU) - 0.5).to(device, dtype)
    tol = {torch.float64: 1e-13, torch.float32: 1e-5}[dtype]
    out = {}
    for name, kernel, plain, reads in (
            ("mul_chain", lambda: probe_chain.mul_chain_cuda(x0, c, steps),
             lambda: probe_chain.mul_chain_plain(x0, c, steps), [x0]),
            ("dynamics_chain", lambda: probe_chain.dynamics_chain_cuda(x1, u),
             lambda: probe_chain.dynamics_chain_plain(x1, u), [x1, u])):
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err, rel = rel_err(got, ref)
        assert rel <= tol, f"{name} {dtype}: {rel} > {tol}"
        fields = dict(max_abs_err=err, max_rel_err=rel)
        if name == "mul_chain" and dtype == torch.float64:
            closed = float(((got - x0 * c ** steps) / got).abs().max())
            assert closed <= tol, f"mul_chain against c**T: {closed}"
            fields["rel_err_against_closed_form"] = closed
        fields["ms"] = graph_ms(kernel, 10)
        fields["ms_eager"] = cuda_ms(kernel, 10)
        fields["plain_ms"] = cuda_ms(plain, 1)
        nbytes = sum(t.numel() * t.element_size() for t in reads + [got])
        flops = (x0.numel() * steps if name == "mul_chain"
                 else batch * steps * 30)        # RK2 step: about 30
        fields.update(kernel_bound(nbytes, flops, dtype))
        fields.update(
            latency_bound_ms=steps * DEPENDENT_OP_CLOCKS / (sm_mhz * 1e3),
            latency_bound_by="latency", dependent_steps=steps,
            clocks_per_step=DEPENDENT_OP_CLOCKS, sm_clock_mhz=sm_mhz)
        out[name] = fields
    # the probes' own path: one run at this size, counted
    probe_chain.reset_launch_counts()
    probe_chain.mul_chain_cuda(x0, c, steps)
    probe_chain.dynamics_chain_cuda(x1, u)
    torch.cuda.synchronize()
    return out, dict(probe_chain.launch_counts)


def reset_counts():
    for mod in (backward_cuda, forward_cuda, probe_chain):
        mod.reset_launch_counts()


def read_counts():
    return {**backward_cuda.launch_counts, **forward_cuda.launch_counts}


def line_search_statistics(trace, K):
    """From the solve's per-iteration trace: over all (iteration, lane)
    pairs that accepted a step, how the accepted candidate index
    i (step 2^-i) and the counted trials are distributed."""
    stepped = torch.stack([t[0] for t in trace])
    step = torch.stack([t[1] for t in trace])[stepped]
    num_ls = torch.stack([t[2] for t in trace])[stepped]
    index = torch.round(-torch.log2(step)).to(torch.int64)
    n = max(int(index.numel()), 1)
    by_index = torch.bincount(index.clamp(max=K), minlength=K + 1).tolist()
    deep = (torch.stack([t[1] for t in trace]) < 0.5 ** (K - 1)) & stepped
    return dict(
        accepted_steps=int(index.numel()),
        accepted_index_counts={(str(i) if i < K else f">={K}"): c
                               for i, c in enumerate(by_index)},
        share_full_step=by_index[0] / n,
        share_below_2pow_minus_4=float((index > 4).sum()) / n,
        share_below_the_candidates=by_index[K] / n,
        iterations_with_a_step_below_the_candidates=int(
            deep.any(dim=1).sum()),
        num_ls_counts={(str(i) if i < 3 else ">=3"): c for i, c in enumerate(
            torch.bincount(num_ls.to(torch.int64).clamp(max=3),
                           minlength=4).tolist())})


def phase_split(problem, theta, bounds, s, options, hybrid_options, iters):
    """Host-clock split of `iters` iterations from state `s`, synchronizing
    after each phase (so the phases do not overlap as they may in a solve).
    The forward pass is timed twice on the same gains: backtracking under
    `options`, hybrid under `hybrid_options`; the state then advances by
    `options`. Also returns on how many (iteration, lane) pairs that took
    the step the two searches chose different ones (rounding at a
    threshold). Timed alone, a search runs its trials on every lane; inside
    an iteration the lanes that take no step are left out."""
    names = ("derivatives", "costate", "contraction", "backward", "forward",
             "forward_hybrid")
    acc = dict.fromkeys(names, 0.0)
    differing = 0          # lanes where the two searches chose another step

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        return out

    for _ in range(iters):
        deriv = timed("derivatives", lambda: evaluate_derivatives(
            problem, theta, s.x, s.u, s.phi))
        c_rel = relax_constraints(problem, s.c_raw, s.mu)
        lam = timed("costate", lambda: costate_scan(deriv, s.phi))
        second = timed("contraction", lambda: deriv.cH_phi
                       + contract_dynamics_hessian(problem, theta, s.x, s.u,
                                                   lam[:, 1:]))
        bw = timed("backward", lambda: backward_pass(
            problem, deriv, (c_rel, s.il, s.iu, s.phi, s.zl, s.zu), s.mu,
            s.reg_last, options, lam=lam, second=second))
        ls_args = (problem, theta, bounds, bw.gains, _nominal_trial(s),
                   bw.dL, s.mu, s.theta_curr, s.L_curr, s.min_primal_1,
                   s.filter_pts)
        fw = timed("forward", lambda: forward_pass(*ls_args, options))
        hy = timed("forward_hybrid",
                   lambda: forward_pass_hybrid(*ls_args, hybrid_options))
        # the speculative step sizes are exact powers of two, as halving is
        assert bool((torch.frexp(hy.step_size).mantissa == 0.5).all()), \
            "a hybrid step size is not a power of two"
        s_next = iteration(problem, bounds, s, theta, options)
        differing += int(((fw.step_size != hy.step_size)
                          & (s_next.k > s.k)).sum())
        s = s_next
    return {k: v / iters * 1e3 for k, v in acc.items()}, differing


def golden_gates(sol, batch):
    """The repo's golden rule on lane 0 (tests/test_benchmarks.py:_check)
    and the share of converged lanes."""
    assert all(bool(torch.isfinite(t).all()) for t in (sol.x, sol.u))
    obj0, it0 = float(sol.objective[0]), int(sol.iterations[0])
    assert bool(sol.converged[0]), "seed-1 lane did not converge"
    assert math.isclose(obj0, concar.SEED1_GOLDEN_OBJECTIVE, rel_tol=1e-6), \
        obj0
    g_it = concar.SEED1_GOLDEN_ITERATIONS
    assert abs(it0 - g_it) <= max(3, int(0.1 * g_it) + 1), it0
    solved = int(sol.converged.sum())
    assert solved >= 0.95 * batch, f"only {solved}/{batch} converged"


def solve_fields(sol, batch, wall):
    iters = sol.iterations.to(torch.float64)
    solved = int(sol.converged.sum())
    return dict(
        batch=batch, solved=solved, median_iterations=float(iters.median()),
        max_iterations=int(iters.max()), seconds=wall,
        ocps_per_second=solved / wall,
        lane0=dict(objective=float(sol.objective[0]),
                   iterations=int(sol.iterations[0]),
                   converged=bool(sol.converged[0])),
        status_counts={str(k): int((sol.status == k).sum())
                       for k in sol.status.unique().tolist()})


def timed_solve(*args, **kwargs):
    """`solve_batch` with every launch count set to 0 just before and read
    just after. Returns (solution, seconds, counts)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_batch(*args, **kwargs)
    torch.cuda.synchronize()
    return sol, time.perf_counter() - t0, read_counts()


# the mixed solve as `bench.py` runs it (max_iterations=600, chunk=40, the
# phase caps and compaction rungs below), with the hybrid search and the
# kernels named in the options: the port's autotune table is empty, so the
# endgame's K=8 alone would be a speculative-only search (a lane without an
# acceptable candidate fails with status 7), and the rescue would backtrack
MIXED_ITERATIONS = 600
SUCCESS = dict(chunk=40, phase2_max_iterations=40, phase2_ls_speculative=8,
               phase2_chunk=8, rescue_failed="restart",
               rescue_ls_speculative=8, rescue_max_iterations=1000,
               return_info=True)
# the first lanes of the batch, driven so that the rescue, the stall freeze
# and the adaptive K run: most lanes leave a 120-iteration f32 phase
# unconverged. (Measured: no lane has a counted line-search trial, which
# is what the adaptive K reads, before about iteration 80, so a shorter
# phase would never switch K.)
RESCUE_BATCH = 128
RESCUE_PATH = dict(SUCCESS, chunk=5, phase1_max_iterations=120,
                   phase1_stall_window=10, phase1_adapt_ls=(2, 4, 8),
                   phase2_compact=True)


def mixed_options(max_iterations):
    return Options(optimality_tolerance=1e-7, max_iterations=max_iterations,
                   ls_speculative=SPECULATIVE, ls_spec_continue=True,
                   forward_kernel="cuda", backward_kernel="cuda")


def bench_rungs(batch):
    """`bench.py`'s endgame compaction rungs: B/2 down to B/16, at least
    64 lanes (1024, 512, 256, 128 at B=2048)."""
    return tuple(s for s in (batch // 2, batch // 4, batch // 8,
                             batch // 16) if s >= 64) or False


def record_chunks(events):
    """Route the chunked loop's `run` and `initialize` through recorders:
    every chunk appends its lanes, type, K, host-clock span and kernel
    launches to `events`, every initialize its lanes and type. The loop
    reads its state on the host after each chunk anyway, so the
    synchronization here adds nothing. Returns the function that undoes
    it."""
    run_, init_ = chunked.run, chunked.initialize

    def run(problem, bounds, state, theta, options, **kw):
        before = read_counts()
        # what `adapt_ls` read at this boundary: the last line-search counts
        num_ls = state.num_ls.cpu()
        t0 = time.perf_counter()
        out = run_(problem, bounds, state, theta, options, **kw)
        torch.cuda.synchronize()
        events.append(dict(
            kind="chunk", lanes=state.k.shape[0], dtype=str(state.x.dtype),
            K=options.ls_speculative, t0=t0, t1=time.perf_counter(),
            num_ls_nonzero=int((num_ls > 0).sum()),
            launches={k: v - before[k] for k, v in read_counts().items()
                      if v != before[k]}))
        return out

    def initialize_(problem, theta, bounds, x1, u_init, options, **kw):
        events.append(dict(kind="init", lanes=x1.shape[0],
                           dtype=str(u_init.dtype), t0=time.perf_counter()))
        return init_(problem, theta, bounds, x1, u_init, options, **kw)

    chunked.run, chunked.initialize = run, initialize_

    def undo():
        chunked.run, chunked.initialize = run_, init_
    return undo


def timed_mixed(problem, bounds, x1, u0, theta, options, kwargs):
    """`solve_mixed_chunked` with every launch count set to 0 just before
    and read just after, its chunks recorded. Returns (solution, info,
    seconds, counts, events, start time)."""
    events = []
    undo = record_chunks(events)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sol, info = solve_mixed_chunked(problem, bounds, x1, u0, theta=theta,
                                        options=options, **kwargs)
        torch.cuda.synchronize()
    finally:
        undo()
    return sol, info, time.perf_counter() - t0, read_counts(), events, t0


def _sum_launches(chunks):
    out = {}
    for c in chunks:
        for k, v in c["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _k_stats(k):
    k = k.to(torch.float64)
    return dict(median_k=float(k.median()) if k.numel() else None,
                max_k=int(k.max()) if k.numel() else None)


def mixed_fields(sol, info, wall, counts, events, t_start):
    """What a `solve_mixed_chunked` run did, phase by phase: host-clock
    seconds (phase 1 ends with its last chunk, the rescue starts with its
    initialize), lanes converged, iterations, the compaction rungs and the
    kernel launches at each, the rescue's size, padding and result."""
    f32 = str(torch.float32)
    inits = [e for e in events if e["kind"] == "init"]
    rescue_at = next((e["t0"] for e in inits if e["dtype"] != f32), None)
    chunks = [e for e in events if e["kind"] == "chunk"]
    p1 = [c for c in chunks if c["dtype"] == f32]
    p2 = [c for c in chunks if c["dtype"] != f32
          and (rescue_at is None or c["t0"] < rescue_at)]
    rescue = [c for c in chunks if rescue_at is not None
              and c["t0"] >= rescue_at]
    t_end = t_start + wall
    p1_end = p1[-1]["t1"] if p1 else t_start
    p2_end = rescue_at if rescue_at is not None else t_end

    def by_rung(cs):
        out = {}
        for c in cs:
            row = out.setdefault(str(c["lanes"]), {"chunks": 0})
            row["chunks"] += 1
            for k, v in c["launches"].items():
                row[k] = row.get(k, 0) + v
        return out

    def rungs(cs):
        seq = []
        for c in cs:
            if not seq or seq[-1] != c["lanes"]:
                seq.append(c["lanes"])
        return seq

    healthy = info["p1"]["converged"]
    p2_iters = (info["p2"]["k"] - info["p1"]["k"])[healthy]
    out = dict(
        p1=dict(seconds=p1_end - t_start,
                converged=int(info["p1"]["converged"].sum()),
                status_counts=_status_counts(info["p1"]["status"]),
                K_by_chunk=[c["K"] for c in p1],
                lanes_with_counted_trials_by_chunk=[c["num_ls_nonzero"]
                                                    for c in p1],
                launches=_sum_launches(p1),
                **_k_stats(info["p1"]["k"])),
        p2=dict(seconds=p2_end - p1_end,
                converged=int(info["p2"]["converged"].sum()),
                lanes_promoted_converged_in_f32=int(healthy.sum()),
                f64_iterations=_k_stats(p2_iters), rungs=rungs(p2),
                launches_by_rung=by_rung(p2), launches=_sum_launches(p2)),
        rescue=None)
    if info["rescue"] is not None:
        r = info["rescue"]
        padded = next(e["lanes"] for e in inits if e["dtype"] != f32)
        out["rescue"] = dict(
            seconds=t_end - rescue_at, lanes=int(r["indices"].numel()),
            padded_to=padded, solved=int(r["converged"].sum()),
            status_counts=_status_counts(r["status"]), rungs=rungs(rescue),
            launches_by_rung=by_rung(rescue),
            launches=_sum_launches(rescue), **_k_stats(r["k"]))
    conv = sol.converged
    raw = lambda t: float(t[conv].max()) if bool(conv.any()) else None
    out.update(
        solved=int(conv.sum()), seconds=wall,
        ocps_per_second=int(conv.sum()) / wall,
        launches={k: v for k, v in counts.items() if v},
        largest_raw_errors_of_converged_lanes=dict(
            primal=raw(sol.primal_inf), dual=raw(sol.dual_inf),
            cs=raw(sol.cs_inf)),
        status_counts=_status_counts(sol.status))
    return out


def _status_counts(status):
    return {str(k): int((status == k).sum()) for k in status.unique().tolist()}


def all_finite(sol):
    return all(bool(torch.isfinite(t).all())
               for t in (sol.x, sol.u, sol.phi, sol.zl, sol.zu))


def residue_solves(problem, max_iterations, device):
    """The 24 round-5 residue instances (the port's data file), once through
    the mixed solve in the configuration of the main path and once from
    scratch in pure f64 (`solve_chunked`, hybrid K=8, 1000 iterations).
    Returns the phase's fields."""
    seeds, index, theta, f_lim, tau_lim, x1 = concar.residue_instances(
        device)
    n = x1.shape[0]
    bounds = concar.bounds(f_lim, tau_lim, device=device)
    u0 = concar.initial_controls(device=device).expand(n, concar.T,
                                                       concar.NU)
    sol_m, info, wall_m, counts_m, events, t0 = timed_mixed(
        problem, bounds, x1, u0, theta, mixed_options(max_iterations),
        dict(SUCCESS, phase2_compact=bench_rungs(n), device=device))
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sol_p = solve_chunked(problem, bounds, x1, u0, theta=theta,
                          options=mixed_options(1000), chunk=40,
                          device=device)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t1
    counts_p = read_counts()

    def lanes(sol):
        return [dict(seed=s, index=i, converged=bool(sol.converged[j]),
                     status=int(sol.status[j]), k=int(sol.iterations[j]),
                     primal=float(sol.primal_inf[j]),
                     dual=float(sol.dual_inf[j]), cs=float(sol.cs_inf[j]))
                for j, (s, i) in enumerate(zip(seeds, index))]

    finite = all_finite(sol_m) and all_finite(sol_p)
    fields = dict(
        instances=n, finite=finite,
        mixed=dict(**mixed_fields(sol_m, info, wall_m, counts_m, events, t0),
                   lanes=lanes(sol_m)),
        f64=dict(solved=int(sol_p.converged.sum()), seconds=wall_p,
                 launches={k: v for k, v in counts_p.items() if v},
                 **_k_stats(sol_p.iterations), lanes=lanes(sol_p)))
    return fields, finite


def mixed_against_pure(data, pure_options, mixed_opts, mixed_kw):
    """The flat pure-f64 hybrid solve (`solve_batch`) and the mixed solve
    on the same batch in turns: pure, mixed, mixed, pure. Returns each
    turn and the ratio of the two medians (mixed over pure)."""
    prob, bounds, x1, u0, theta = data
    turns = []
    for which in ("pure", "mixed", "mixed", "pure"):
        if which == "pure":
            sol, wall, _ = timed_solve(prob, bounds, x1, u0, theta=theta,
                                       options=pure_options)
        else:
            sol, _, wall, *_ = timed_mixed(prob, bounds, x1, u0, theta,
                                           mixed_opts, mixed_kw)
        turns.append(dict(which=which, seconds=wall,
                          solved=int(sol.converged.sum()),
                          lane0_iterations=int(sol.iterations[0]),
                          lane0_objective=float(sol.objective[0])))
    median = lambda w: sum(t["seconds"] for t in turns
                           if t["which"] == w) / 2
    return dict(turns=turns, mixed_over_pure=median("mixed") / median("pure"))


def parent_metrics(lib):
    """The `forward_metrics_<type>` functions of another checkout's forward
    library, by type, each taking this tree's arguments (ptrs, B, T, K, geo,
    stream). A library that exports `forward_metrics_geometry` takes the
    geometry as this tree's does; an older one (its K3 of one thread per
    candidate) has no such argument, and it is dropped."""
    has_geo = hasattr(lib, "forward_metrics_geometry")
    out = {}
    for sfx_ in ("f32", "f64"):
        fn = getattr(lib, f"forward_metrics_{sfx_}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                        ctypes.c_int, ctypes.c_int]
                       + [ctypes.POINTER(ctypes.c_int)] * has_geo
                       + [ctypes.c_void_p])
        out[sfx_] = fn if has_geo else (
            lambda fn: lambda ptrs, B, T, K, geo, stream: fn(ptrs, B, T, K,
                                                             stream))(fn)
    return out


class _ParentMetrics:
    """A forward library whose metrics kernels come from another build;
    everything else from the library it wraps."""

    def __init__(self, parent, current):
        self.metrics, self.current = parent_metrics(parent), current

    def __getattr__(self, name):
        if name.startswith("forward_metrics_"):
            return self.metrics[name.rsplit("_", 1)[1]]
        return getattr(self.current, name)


def parent_library(problem, parent_dir):
    """The forward library of another checkout (the parent commit unpacked
    into `parent_dir`), built from its own sources under another stem; the
    wrapper's object for it launches that checkout's metrics kernels and
    this tree's trial kernels."""
    src = Path(parent_dir) / "ipddp2tpu_torch/ops/csrc/forward_pass.cu"
    model, nx, nu, nc, mask = (problem.device_model, problem.nx, problem.nu,
                               problem.nc, sum(1 << i for i in
                                               problem.compl_indices))
    path = build.finish(build.start(
        f"forward_pass_parent_{model}_nx{nx}_nu{nu}_nc{nc}_m{mask}", src,
        defines=(f"NX={nx}", f"NU={nu}", f"NC={nc}", f"COMPL_MASK={mask}",
                 f'MODEL_HEADER="models/{model}.cuh"'),
        depends=(src.parent / "models" / f"{model}.cuh",
                 *sorted(src.parent.glob("*.cuh")))))
    current = forward_cuda._library(problem)
    return types.SimpleNamespace(
        lib=_ParentMetrics(ctypes.CDLL(str(path)), current.lib),
        theta_dim=current.theta_dim)


def parent_and_change(parent_dir, prob, forward_main, K, solve_args,
                      options, reps):
    """K3 of the parent checkout and of this tree, in turns parent, change,
    change, parent inside this one process: K3's time in both types on the
    main shapes (graph replay), and the main path's hybrid solve."""
    key = forward_cuda._key(prob)
    current = forward_cuda._library(prob)
    libs = {"parent": parent_library(prob, parent_dir), "change": current}
    # the two kernels agree on the main shapes
    same = {}
    for dtype, fa in forward_main.items():
        gammas = candidate_steps(K, dtype, fa[6].device)
        outs = {}
        for which, lib in libs.items():
            forward_cuda._libs[key] = lib
            outs[which] = forward_metrics_cuda(*fa, gammas)
        torch.cuda.synchronize()
        same[str(dtype)] = max(
            float((p_.to(torch.float64) - c_.to(torch.float64)).abs()
                  .nan_to_num(posinf=0.0, neginf=0.0).max())
            for p_, c_ in zip(outs["parent"], outs["change"]))
    turns = []
    for which in ("parent", "change", "change", "parent"):
        forward_cuda._libs[key] = libs[which]
        k3 = {}
        for dtype, fa in forward_main.items():
            gammas = candidate_steps(K, dtype, fa[6].device)
            k3[str(dtype)] = graph_ms(
                lambda: forward_metrics_cuda(*fa, gammas), reps)
        sol, wall, counts = timed_solve(*solve_args[:4], theta=solve_args[4],
                                        options=options)
        turns.append(dict(
            which=which, k3_ms=k3, solve_seconds=wall,
            solved=int(sol.converged.sum()),
            lane0_iterations=int(sol.iterations[0]),
            lane0_objective=float(sol.objective[0]),
            forward_metrics_launches=counts["forward_metrics_f64"]))
    forward_cuda._libs[key] = current
    return dict(max_abs_diff_parent_vs_change=same, turns=turns)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--max-iterations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register / memory report")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels and probes phases")
    ap.add_argument("--log", default=None,
                    help="also append every phase line to this file")
    ap.add_argument("--turns", action="store_true",
                    help="time the pure-f64 hybrid solve and the mixed "
                         "solve in turns on the same batch: pure, mixed, "
                         "mixed, pure")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of the parent commit: time its "
                         "forward-metrics kernel against this tree's, in "
                         "turns, and the hybrid solve with each")
    a = ap.parse_args()
    global LOG
    LOG = a.log
    K = SPECULATIVE
    started = time.perf_counter()

    # ---- device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    emit("device", kind=kind, capability=list(cap), nvidia_smi=smi,
         sm_clock_max_mhz=sm_mhz, torch=torch.__version__,
         cuda=torch.version.cuda)
    assert cap == (9, 0), f"built for sm_90a, found capability {cap}"

    # ---- build: every library in one parallel round ----------------------
    prob = concar.problem()
    tiny = tiny_problem()
    di = double_integrator.problem()
    dims_c = dict(nx=prob.nx, nu=prob.nu, nc=prob.nc)
    dims_t = dict(nx=tiny.nx, nu=tiny.nu, nc=tiny.nc)
    dims_d = dict(nx=di.nx, nu=di.nu, nc=di.nc)
    t0 = time.perf_counter()
    started_builds = (
        [backward_cuda.start_build(*d.values(), verbose=True)
         for d in (dims_c, dims_d, dims_t)]
        + [forward_cuda.start_build(p, verbose=True)
           for p in (prob, di, tiny)]
        + [probe_chain.start_build(verbose=True)])
    logs = {}
    libs = build.finish_all(started_builds, verbose=True, logs=logs)
    if a.ptxas:
        print("\n".join(logs.values()), flush=True)
    geometry = {}
    for d in (dims_c, dims_d, dims_t):
        geo = launch_geometry(**d)
        geometry["nx{nx}_nu{nu}_nc{nc}".format(**d)] = dict(
            lanes_per_instance=geo.lanes,
            instances_per_block=geo.instances_per_block,
            threads_per_block=geo.threads,
            smem_bytes_per_block={str(k): v
                                  for k, v in geo.smem_bytes.items()})
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs],
         ptxas={name: build.ptxas_report(log) for name, log in logs.items()},
         sweep_geometry=geometry)

    # ---- kernels ---------------------------------------------------------
    opts64 = Options(optimality_tolerance=1e-7,
                     max_iterations=a.max_iterations, backward_kernel="cuda")
    hyb = dict(ls_speculative=K, ls_spec_continue=True,
               forward_kernel="cuda")
    hyb64 = Options(optimality_tolerance=1e-7,
                    max_iterations=a.max_iterations, backward_kernel="cuda",
                    **hyb)
    rtol, refine = opts64.kkt_residual_rtol, max(opts64.refine_steps, 1)
    theta, bounds, x1, u0 = concar_batch(a.batch, torch.float64, dev, a.seed)
    plain = Options(optimality_tolerance=1e-7, backward_kernel="torch")
    t0 = time.perf_counter()
    mid = initialize(prob, theta, bounds, x1, u0, plain)
    for _ in range(10):                 # a mid-solve state: non-uniform duals
        mid = iteration(prob, bounds, mid, theta, plain)
    torch.cuda.synchronize()
    emit("mid_state", plain_iterations=10, seconds=time.perf_counter() - t0)

    # a mid-solve state of the double integrator (64 lanes, varied starts)
    gen = torch.Generator(device="cpu").manual_seed(a.seed + 2)
    Bd = 64
    di_x1 = torch.stack([0.5 * torch.rand(Bd, generator=gen,
                                          dtype=torch.float64),
                         torch.zeros(Bd, dtype=torch.float64)], dim=1).to(dev)
    di_u0 = double_integrator.initial_controls(device=dev).expand(
        Bd, di.T, di.nu)
    di_bounds = Bounds(*(b.expand(Bd, di.T, di.nu)
                         for b in double_integrator.bounds(device=dev)))
    di_mid = initialize(di, None, di_bounds, di_x1, di_u0, plain)
    for _ in range(4):
        di_mid = iteration(di, di_bounds, di_mid, None, plain)

    def gains_of(problem, th, s):
        deriv = evaluate_derivatives(problem, th, s.x, s.u, s.phi)
        c_rel = relax_constraints(problem, s.c_raw, s.mu)
        return backward_pass(problem, deriv,
                             (c_rel, s.il, s.iu, s.phi, s.zl, s.zu), s.mu,
                             s.reg_last, plain).gains

    kernels = []
    by_name = {}

    def add_kernel(name, source, replaces, *field_sets):
        main_f = field_sets[0]
        row = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, launches_by_path={},
            max_abs_err=max(f["max_abs_err"] for f in field_sets),
            max_rel_err=max(f["max_rel_err"] for f in field_sets),
            ms=main_f["ms"], ms_eager=main_f["ms_eager"],
            plain_ms=main_f["plain_ms"],
            bound_ms=main_f["bound_ms"], bound_by=main_f["bound_by"],
            library_ms=None)
        kernels.append(row)
        by_name[name] = row

    sfx = {torch.float32: "f32", torch.float64: "f64"}
    forward_main = {}           # the forward kernels' concar inputs, by type
    sweep_replaces = {
        torch.float32: "ipddp2tpu/ops/backward_pallas.py:308",
        torch.float64: "ipddp2tpu/ops/backward_pallas_df64.py:418"}
    for dtype in (torch.float64, torch.float32):
        kname = f"backward_sweep_{sfx[dtype]}"
        th = concar.Theta(theta.obstacles.to(dtype))
        args = perturb(sweep_inputs(prob, th, cast_tree(mid, dtype)),
                       prob.nu)
        main_fields = check_kernel(kname, args, dict(dims_c, refine=refine),
                                   rtol, time_reps=10)
        # batches that do not fill their last block
        ragged = {
            str(n): check_kernel(f"{kname}/B={n}", [x[:n] for x in args],
                                 dict(dims_c, refine=refine), rtol, 0,
                                 need_both=False)["max_rel_err"]
            for n in (a.batch - 3, 1) if n >= 1}
        crafted = {
            label: check_crafted(f"{kname}/crafted/{label}",
                                 dict(d, refine=refine), dtype, dev, rtol)
            for label, d in (("concar", dims_c), ("double_integrator", dims_d),
                             ("tiny_nc0", dims_t))}
        scaling = sweep_scaling(args, dict(dims_c, refine=refine), rtol,
                                (256, 1024, 2048, 8192), 5)
        gen = torch.Generator(device="cpu").manual_seed(a.seed + 1)
        rnd = lambda *shape: torch.rand(shape, generator=gen,
                                        dtype=torch.float64).to(dev, dtype)
        Bt = 64
        st = SolverState(
            x=rnd(Bt, 7, 2) - 0.5, u=rnd(Bt, 6, 3) - 0.5,
            c_raw=rnd(Bt, 6, 0), il=0.5 + rnd(Bt, 6, 3),
            iu=0.5 + rnd(Bt, 6, 3), phi=rnd(Bt, 6, 0),
            zl=0.1 + rnd(Bt, 6, 3), zu=0.1 + rnd(Bt, 6, 3),
            lam=rnd(Bt, 7, 2), mu=torch.full((Bt,), 0.1, dtype=dtype,
                                             device=dev),
            **{f: None for f in SolverState._fields[10:]})
        targs = perturb(sweep_inputs(tiny, None, st), tiny.nu)
        tiny_fields = check_kernel(kname + "/nc0", targs,
                                   dict(dims_t, refine=refine), rtol, 0)
        emit("kernels", name=kname, dtype=str(dtype), concar=main_fields,
             tiny_nc0=tiny_fields, ragged_batch_max_rel_err=ragged,
             crafted=crafted)
        emit("sweep_scaling", name=kname, dtype=str(dtype), T=prob.T,
             **scaling)
        add_kernel(kname, "ipddp2tpu_torch/ops/csrc/backward_sweep.cu",
                   sweep_replaces[dtype], main_fields, tiny_fields,
                   *crafted.values())

        # the forward kernels: concar at the main path's shapes, the double
        # integrator, and the tiny problem without constraints
        s_c = cast_tree(mid, dtype)
        b_c = cast_tree(bounds, dtype)
        fargs = perturb_forward(forward_args(
            prob, th, b_c, s_c, cast_tree(gains_of(prob, theta, mid), dtype),
            plain))
        m_c, t_c, bad_c = check_forward(f"forward/{sfx[dtype]}/concar",
                                        fargs, K, dtype, 10,
                                        need_both_flags=True)
        s_d = cast_tree(di_mid, dtype)
        dargs = perturb_forward(forward_args(
            di, None, cast_tree(di_bounds, dtype), s_d,
            cast_tree(gains_of(di, None, di_mid), dtype), plain))
        m_d, t_d, bad_d = check_forward(
            f"forward/{sfx[dtype]}/double_integrator", dargs, K, dtype, 0,
            need_both_flags=False)
        lo_t = st.u - st.il
        hi_t = st.u + st.iu
        hi_t[:, :, 2] = float("inf")
        st_t = st._replace(iu=hi_t - st.u)
        small = lambda *shape: 0.1 * (rnd(Bt, 6, *shape) - 0.5)
        tgains = (small(3), small(3, 2), small(0), small(0, 2), small(3),
                  small(3, 2), small(3), small(3, 2))
        targs_f = forward_args(tiny, None, Bounds(lo_t, hi_t), st_t, tgains,
                               plain)
        m_t, t_t, bad_t = check_forward(f"forward/{sfx[dtype]}/tiny_nc0",
                                        targs_f, K, dtype, 0,
                                        need_both_flags=False)
        kname = f"forward_metrics_{sfx[dtype]}"
        emit("kernels", name=kname, dtype=str(dtype), K=K, concar=m_c,
             double_integrator=m_d, tiny_nc0=m_t,
             geometry={str(k): metrics_geometry(
                 prob.nx, prob.nu, prob.nc, k, dtype,
                 theta.obstacles[0].numel())._asdict()
                 for k in METRICS_KS})
        # K3 alone at every K of METRICS_KS, on full and ragged batches of
        # all three models; its time by batch size
        emit("metrics_grid", name=kname, dtype=str(dtype),
             max_rel_err={label: metrics_grid(
                 f"{kname}/{label}", lanes_of(fa, a.batch), dtype, a.batch)
                 for label, fa in (("concar", fargs),
                                   ("double_integrator", dargs),
                                   ("tiny_nc0", targs_f))})
        emit("metrics_scaling", name=kname, dtype=str(dtype), K=K, T=prob.T,
             ms_by_batch=metrics_scaling(fargs, dtype, K,
                                         (256, 1024, 2048, 8192), 10))
        forward_main[dtype] = fargs
        emit("kernels", name=f"forward_trial_{sfx[dtype]}", dtype=str(dtype),
             concar=t_c, double_integrator=t_d, tiny_nc0=t_t)
        failures = bad_c + bad_d + bad_t
        assert not failures, "\n".join(failures)
        src = "ipddp2tpu_torch/ops/csrc/forward_pass.cu"
        add_kernel(f"forward_metrics_{sfx[dtype]}", src,
                   "ipddp2tpu/ops/forward_pallas.py:625", m_c, m_d, m_t)
        add_kernel(f"forward_trial_{sfx[dtype]}", src,
                   "ipddp2tpu/ops/forward_pallas.py:716", t_c, t_d, t_t)

    # ---- probes ----------------------------------------------------------
    probe_rows = (("mul_chain", "scripts/tpu_dd_probe.py:49"),
                  ("dynamics_chain", "scripts/tpu_dd_probe.py:98"))
    for dtype in (torch.float32, torch.float64):
        fields, counts = check_probes(dtype, dev, a.batch, prob.T, a.seed + 3,
                                      sm_mhz)
        emit("probes", dtype=str(dtype), batch=a.batch, steps=prob.T,
             launches=counts, **fields)
        for pname, replaces in probe_rows:
            kname = f"{pname}_{sfx[dtype]}"
            add_kernel(kname, "ipddp2tpu_torch/ops/csrc/probe_chain.cu",
                       replaces, fields[pname])
            assert counts[kname] > 0, f"probe run missed {kname}"
            by_name[kname]["launches"] = counts[kname]
            by_name[kname]["launches_by_path"] = {"probes": counts[kname]}
    if a.kernels_only:
        print(json.dumps({"kernels": kernels}), flush=True)
        print("chip_smoke: --kernels-only, stopping before the solves",
              file=sys.stderr)
        return 10

    # ---- graphs: the replayed rollout against the eager one --------------
    c_rel = relax_constraints(prob, mid.c_raw, mid.mu)
    deriv = evaluate_derivatives(prob, theta, mid.x, mid.u, mid.phi)
    bw = backward_pass(prob, deriv,
                       (c_rel, mid.il, mid.iu, mid.phi, mid.zl, mid.zu),
                       mid.mu, mid.reg_last, opts64)
    gamma = torch.full_like(mid.mu, 0.5)
    roll = lambda: rollout(prob, theta, bounds, bw.gains, mid.x, mid.u,
                           mid.phi, mid.zl, mid.zu, gamma)
    timings = {}
    trials = {}
    for mode in ("eager", "graph"):
        graphs.ENABLED = mode == "graph"
        roll()                                   # warm-up / capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials[mode] = roll()
        torch.cuda.synchronize()
        timings[mode] = (time.perf_counter() - t0) * 1e3
    diff = max(float((a_ - b_).abs().nan_to_num(posinf=0.0).max())
               for a_, b_ in zip(trials["eager"], trials["graph"]))
    emit("graphs", rollout_eager_ms=timings["eager"],
         rollout_graph_ms=timings["graph"], max_abs_diff=diff)
    assert diff == 0.0, "graph replay differs from the eager rollout"

    def record(path, counts, names):
        for name in names:
            assert counts[name] > 0, f"{path} missed the kernel {name}"
            by_name[name]["launches_by_path"][path] = counts[name]

    # ---- solve_hybrid_f64: the flat solve in pure f64 --------------------
    trace = []
    sol, wall, counts = timed_solve(prob, bounds, x1, u0, theta=theta,
                                    options=hyb64, trace=trace)
    names64 = ("backward_sweep_f64", "forward_metrics_f64",
               "forward_trial_f64")
    names32 = ("backward_sweep_f32", "forward_metrics_f32",
               "forward_trial_f32")
    record("solve_hybrid_f64", counts, names64)
    emit("solve_hybrid_f64", T=prob.T, K=K, **solve_fields(sol, a.batch, wall),
         launches={k: v for k, v in counts.items() if v},
         forward_passes=counts["forward_metrics_f64"],
         backtracking_trials_below_the_candidates=(
             counts["forward_trial_f64"] - counts["forward_metrics_f64"]),
         line_search=line_search_statistics(trace, K))
    golden_gates(sol, a.batch)
    pure_seconds = wall

    # ---- solve_mixed: THE MAIN PATH --------------------------------------
    mix_opts = mixed_options(MIXED_ITERATIONS)
    mixed_kw = dict(SUCCESS, phase2_compact=bench_rungs(a.batch))
    sol, info, wall, counts, events, t0 = timed_mixed(
        prob, bounds, x1, u0, theta, mix_opts, mixed_kw)
    record("solve_mixed", counts, names32 + names64)
    for name in names32 + names64:
        by_name[name]["launches"] = counts[name]
    fields = mixed_fields(sol, info, wall, counts, events, t0)
    emit("solve_mixed", batch=a.batch, T=prob.T, K=K,
         max_iterations=MIXED_ITERATIONS,
         compact_rungs=mixed_kw["phase2_compact"],
         tf32=torch.backends.cuda.matmul.allow_tf32, **fields,
         lane0=dict(objective=float(sol.objective[0]),
                    iterations=int(sol.iterations[0]),
                    converged=bool(sol.converged[0]),
                    dual_inf=float(sol.dual_inf[0])))
    emit("mixed_vs_pure", batch=a.batch, pure_f64_seconds=pure_seconds,
         mixed_seconds=wall, mixed_over_pure=wall / pure_seconds)
    assert all_finite(sol)
    assert not torch.backends.cuda.matmul.allow_tf32
    # lane 0 under the rule of tests/test_mixed.py::test_mixed_concar
    assert bool(sol.converged[0]), "seed-1 lane did not converge"
    assert math.isclose(float(sol.objective[0]),
                        concar.SEED1_GOLDEN_OBJECTIVE, rel_tol=1e-4)
    assert float(sol.dual_inf[0]) < 1e-7
    assert fields["solved"] >= 0.95 * a.batch, \
        f"only {fields['solved']}/{a.batch} converged"
    assert counts["backward_sweep_f32"] > 0

    # ---- mixed_rescue: the rescue, the stall freeze, the adaptive K -------
    nr = min(RESCUE_BATCH, a.batch)
    sol, info, wall, counts, events, t0 = timed_mixed(
        prob, Bounds(bounds.lower[:nr], bounds.upper[:nr]), x1[:nr],
        u0[:nr], concar.Theta(theta.obstacles[:nr]), mix_opts, RESCUE_PATH)
    record("mixed_rescue", counts, names32 + names64)
    fields = mixed_fields(sol, info, wall, counts, events, t0)
    emit("mixed_rescue", batch=nr, **fields)
    left = torch.nonzero(~info["p2"]["converged"])[:, 0]
    assert info["rescue"] is not None, "no lane left for the rescue"
    assert torch.equal(info["rescue"]["indices"], left), \
        "the rescue did not take exactly the lanes phase 2 left"
    assert fields["rescue"]["solved"] >= 0.95 * left.numel()
    assert all_finite(sol)

    # ---- residue: the round-5 residue instances in native f64 -----------
    fields, finite = residue_solves(prob, MIXED_ITERATIONS, dev)
    emit("residue", **fields)
    assert finite

    # ---- turns: mixed against pure f64 in turns on the same batch --------
    if a.turns:
        emit("turns", batch=a.batch, **mixed_against_pure(
            (prob, bounds, x1, u0, theta), hyb64, mix_opts, mixed_kw))

    # ---- solve_hybrid_f32 ------------------------------------------------
    th32, b32, x32, u32 = concar_batch(a.batch, torch.float32, dev, a.seed)
    hyb32 = Options(optimality_tolerance=1e-7, max_iterations=30,
                    backward_kernel="cuda", **hyb)
    s0 = initialize(prob, th32, b32, x32, u32, hyb32)
    p0 = s0.c_raw.abs().flatten(1).amax(dim=1)
    sol32, wall32, counts = timed_solve(prob, b32, x32, u32, theta=th32,
                                        options=hyb32)
    record("solve_hybrid_f32", counts, names32)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (sol32.x, sol32.u, sol32.phi, sol32.zl, sol32.zu))
    emit("solve_hybrid_f32", batch=a.batch, iterations=30, K=K,
         seconds=wall32, finite=finite,
         launches={k: v for k, v in counts.items() if v},
         primal_inf_initial_median=float(p0.median()),
         primal_inf_final_median=float(sol32.primal_inf.median()))
    assert finite and sol32.x.dtype == torch.float32
    assert float(sol32.primal_inf.median()) < float(p0.median())

    # ---- solve_f64: pure backtracking, plain rollout, at fewer lanes -----
    nb = min(SMALL_BATCH, a.batch)
    th_s = concar.Theta(theta.obstacles[:nb])
    b_s = Bounds(bounds.lower[:nb], bounds.upper[:nb])
    sol_b, wall_b, counts = timed_solve(prob, b_s, x1[:nb], u0[:nb],
                                        theta=th_s, options=opts64)
    record("solve_f64", counts, ("backward_sweep_f64",))
    assert counts["forward_metrics_f64"] == 0 \
        and counts["forward_trial_f64"] == 0
    emit("solve_f64", T=prob.T, **solve_fields(sol_b, nb, wall_b),
         sweep_launches=counts["backward_sweep_f64"])
    golden_gates(sol_b, nb)

    # the same path in float32, 30 iterations
    opts32 = Options(optimality_tolerance=1e-7, max_iterations=30,
                     backward_kernel="cuda")
    sol_b32, wall_b32, counts = timed_solve(
        prob, Bounds(*(x[:nb] for x in b32)), x32[:nb], u32[:nb],
        theta=concar.Theta(th32.obstacles[:nb]), options=opts32)
    record("solve_f32", counts, ("backward_sweep_f32",))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (sol_b32.x, sol_b32.u, sol_b32.phi, sol_b32.zl,
                           sol_b32.zu))
    emit("solve_f32", batch=nb, iterations=30, seconds=wall_b32,
         finite=finite, sweep_launches=counts["backward_sweep_f32"],
         primal_inf_initial_median=float(p0[:nb].median()),
         primal_inf_final_median=float(sol_b32.primal_inf.median()))
    assert finite and sol_b32.x.dtype == torch.float32
    assert float(sol_b32.primal_inf.median()) < float(p0[:nb].median())

    # ---- backtrack_cuda: K4 as the rollout of pure backtracking ----------
    bt = Options(optimality_tolerance=1e-7, max_iterations=20,
                 backward_kernel="cuda", forward_kernel="cuda")
    sol_k, wall_k, counts = timed_solve(prob, b_s, x1[:nb], u0[:nb],
                                        theta=th_s, options=bt)
    record("backtrack_cuda", counts, ("backward_sweep_f64",
                                      "forward_trial_f64"))
    assert counts["forward_metrics_f64"] == 0
    ref20 = solve_batch(prob, b_s, x1[:nb], u0[:nb], theta=th_s,
                        options=Options(optimality_tolerance=1e-7,
                                        max_iterations=20,
                                        backward_kernel="cuda"))
    same_steps = bool((ref20.iterations == sol_k.iterations).all())
    drift = float((ref20.x - sol_k.x).abs().max())
    emit("backtrack_cuda", batch=nb, iterations=20, seconds=wall_k,
         trial_launches=counts["forward_trial_f64"],
         same_iteration_counts_as_graph_rollout=same_steps,
         max_abs_state_difference_to_graph_rollout=drift)
    assert bool(torch.isfinite(sol_k.x).all())

    # ---- phases: split of mid-solve f64 iterations -----------------------
    split, differing = phase_split(prob, theta, bounds, mid, opts64, hyb64,
                                   iters=5)
    emit("phases", ms_per_iteration=split, batch=a.batch, K=K,
         stepping_lanes_where_hybrid_and_backtracking_differ=differing)

    # ---- parent_and_change: K3 of the parent commit against this tree ----
    if a.parent:
        emit("parent_and_change", parent=a.parent, batch=a.batch, K=K,
             **parent_and_change(a.parent, prob, forward_main, K,
                                 (prob, bounds, x1, u0, theta), hyb64, 10))

    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
