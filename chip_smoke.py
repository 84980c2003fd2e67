#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on an NVIDIA H100, end to end.

    python3 chip_smoke.py [--batch 2048] [--max-iterations 1000] [--ptxas]
                          [--kernels-only] [--log FILE] [--turns]
                          [--parent DIR] [--lane-independence]

Needs one CUDA device of compute capability 9.0 and `nvcc`; with no device it
exits non-zero at the first phase. It imports `torch` and `ipddp2tpu_torch`
only. Phases, each printing one JSON line:

  device     the card, its capability, its power limit and highest SM
             clock;
  build      compiles every kernel from the sources in this checkout, all
             `nvcc` processes started together: the backward sweep's LDL^T
             instantiation (concar, double integrator, a tiny nc=0 model,
             quadrotor, cartpole swing-up) and its Bunch-Kaufman
             instantiation (acrobot, cartpole, pushing), the forward kernels
             of every model and the chain probes; prints the compiler's
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
             kernel (K3) also its checks at K = 1, 3, 8, 13, 40 on 256, 253
             and 1 lanes of all three models (`metrics_grid`) and its time
             at 256 to 8192 lanes (`metrics_scaling`). On mid-solve states
             of the six further models (their 100 campaign instances, T=100,
             10 iterations): the Bunch-Kaufman sweep against
             `sweep_plain(inertia="bk")` on the three contact models in f64
             and f32 (flags equal on every lane, gains within BK_TOL; timed),
             at concar's m = 14 on mid-solve states of the 24 residue
             instances (the shape of `residue_levers`' `bk` lever), and on
             the crafted lanes of both kinds at each model's
             dimensions (`crafted_inputs`, `crafted_bk_inputs`: a rook chain
             of several trips, a tie in the column search), the LDL^T sweep
             on the three smooth ones and on cartpole's m = 35, whole warps
             an instance (flags equal on every lane, timed; the crafted
             lanes there too; `kernels_by_model`),
             K3 / K4 with each new model's device functions in f64, timed
             (`forward_by_model`);
  probes     the two chain probes, driven once at their size (B lanes,
             T=100), each against its plain version and timed; both timed
             at 100, 400 and 1600 steps (a line through the three: the
             cost of a dependent step and the fixed cost) beside an empty
             kernel of their launch geometry (the floor of one launch in a
             replayed graph); P2's registers and shared memory (`-Xptxas
             -v`) and the FP64 instructions of its step from `cuobjdump
             -sass` (its issue floor); with --parent DIR, the parent's P2
             against this tree's bit for bit at each length in both types,
             in turns (parent, change, change, parent) and by steps;
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
  parallel   (after the main path, alone on the card) the time-parallel
             backward pass (`backward_mode="parallel"`,
             `parallel/priccati.py`) against the
             sequential one through the sweep kernel on the first 256 lanes
             of the mid-solve state: status and reg equal on every lane,
             gains within PARALLEL_TOL on the lanes that pass (f64; f32
             against K1 reported); then both passes timed in turns
             (sequential, parallel, parallel, sequential) at B = 1 to 2048
             in both types, with the device's launches for one pass of each
             (`torch.profiler`);
  parallel_solves  (in a further process, while the campaign runs)
             concar's seed 1 alone and the
             first 256 lanes in float64 in the parallel mode with the hybrid
             search: seed 1 on its golden objective (rtol 1e-6), >= 95 % of
             the lanes solved, K3 / K4 launched;
  parallel_dist  (while the campaign runs) `solve_timesharded` of the
             double integrator at T=1024, 8 iterations, on one NCCL rank
             (world size 1): equal to the parallel mode bit for bit, within
             1e-6 of "scan"; then two ranks sharing the card over gloo
             (spawned): the same solve at D = 2 within 1e-8 of the parallel
             mode, and 2 x 128 lanes of the main batch through
             `solve_sharded` and `solve_global` (each rank generating only
             its own lanes) against `solve_batch` on the union and its
             `batch_stats`; the phase's seconds include the processes'
             start;
  mixed_rescue  (after `facade`, while the campaign runs) the first 128
             lanes with a 120-iteration f32 phase in chunks of 5, the stall
             freeze and the adaptive K: checks that the rescue takes exactly
             the lanes phase 2 left unconverged and solves >= 95 % of them;
  independent_check  (in a further process, while the campaign runs)
             `ipddp2tpu_torch.experiments.independent_check.main` on the
             double integrator (cold and warm starts) and on the first two
             committed instances of concar and acrobot (warm starts):
             solved on the card, SLSQP on the host; its lines read back by
             the port's `slsqp_table`; fails unless every certificate
             holds, the double integrator's cold start lands in our basin
             and each "ours" objective is within 1e-4 of its row in
             `experiments/results/<file>`; K2 and the bk sweep launched;
  residue_levers  (in a further process, with `profile_iteration`) the
             levers base and bk of `ipddp2tpu_torch.scripts.residue_levers`
             on the residue instances of seeds 1002 and 1004 (chunks of 50,
             1000 iterations): the script's lines, solved beside the
             `residue` phase's pure f64 solve; fails on non-finite
             iterates or the bk sweep (m = 14) not launched;
  profile_iteration  `ipddp2tpu_torch.scripts.profile_iteration` on the
             card: ms per piece of one iteration on concar's seed-1
             iterate (B = 1, T = 100, CUDA events, 20 repetitions); fails
             on a non-finite piece or K2 not launched;
  trajectories  (in a further process) the solving half of
             `ipddp2tpu_torch.experiments.plot_trajectories`: the seed-1
             solves of concar, cartpole, acrobot and the quadrotor (its
             default instance; pushing's is left out for the run's time)
             at B = 1, their arrays written to
             `smoke_out/trajectories/<stem>.npz`; each beside its golden
             anchor and row 1 of the JAX results file; fails unless every
             solve converged, is finite and launched its sweep kernel (K2,
             or the bk sweep on the contact models), and concar's lies on
             its anchor (99 / 4.46466505, the golden rule);
  residue_levers_untried  (eigh in a further process alone, the other
             three with `trajectories` and `flops`) the levers refine3,
             eigh, resets and qn on seed 1002's 9 residue instances, each
             beside `residue_levers`' base; fails on
             non-finite iterates, refine3 or resets solving fewer than 9,
             or a sweep kernel launched under eigh (its route is the plain
             sweep: eigh has no kernel in either package);
  flops      (after `phases`) `ipddp2tpu_torch.scripts.flops_analysis`'s
             count of one concar iteration at B = 1 in float64 with the
             speculative search (on CPU tensors, in the process of
             `trajectories`), set beside `phases`' mid-solve iteration at
             B: the achieved rate and its share of the card's FP64 peak
             (reported, not gated); fails if an aten operation went
             uncounted;
  residue    (in a further process, while the campaign runs) the 24
             round-5 residue instances (the
             port's data file) through the mixed solve and from scratch in
             pure f64: each lane's status, iterations and KKT errors (checks
             that they are finite);
  facade     concar's seed-1 instance built through the reference-style
             `Solver` from per-stage (x, u) closures, published widths,
             float64, default options (backtracking, the graph-replayed
             plain rollout: a facade problem has no device functions; K2):
             the golden rule (99 iterations, 4.46466505), its first two
             iterations once more inside `utils.profiling.trace` (the trace
             must name the sweep kernel), once verbose with stdout captured
             (the table's rows counted), and a checkpoint: `save_state` at
             iteration 40, `load_state`, `run` to the end, equal bit for bit
             to the uninterrupted run;
  serve      (in a further process, while the campaign runs) the first
             512 instances of the batch through `solve_pool`,
             `solve_pool_resident` (256 slots, chunks of 40) and a lockstep
             `solve_batch`, float64 to 1e-7 with the hybrid search: solved,
             chunks, occupancy, seconds and instances a second of each;
             every instance against the lockstep result (status equal on
             >= 99 %, objectives within 1e-6 where both converged,
             iteration differences reported); K2, K3, K4 launched;
  campaign   the JAX package's 100-instance campaign of concar and the six
             further models (`experiments/params`, solved through
             `ipddp2tpu_torch.experiments.run_benchmarks` as the JAX
             campaign solves them: `solve_batch`,
             f64, tolerance 1e-7, backtracking, inertia "auto" -> bk on the
             contact models) in one batch of 101 lanes, lane 100 the golden
             anchor's instance (gated for concar: 99 / 4.46466505 by the
             golden rule): solved, median and largest iterations,
             seconds, launches, objectives matching the JAX results file to
             1e-4, seed 1 beside its row there, the golden lane beside its
             anchor; acrobot's batch once more with the hybrid search (K3 /
             K4 inside a contact solve) and for 20 float32 iterations (the
             bk instantiation in float); fails on non-finite iterates, fewer
             than 95 solved, or a path's kernel not launched. Each
             backtracking batch's table is written in the JAX results format
             to `smoke_out/campaign_tables/`. In concar's process, every
             converged row whose objective differs from the JAX results
             file by more than 1e-4 (relative) gets SLSQP's warm-start
             certificate from that lane's controls
             (`independent_check.check_instance`, `campaign_certificates`;
             fails unless each holds);
  distributions  `plot_distributions.summary` on those tables: fails
             unless each problem's solved count and total equal the
             campaign line's. Right after
             the main path the batches are solved in three further
             processes on the same card (pushing's alone; the other seven
             in two groups), `serve`, `residue`, `parallel_solves` and
             `independent_check` each in one more, `residue_levers` with
             `profile_iteration` in another, `trajectories` with three of
             the untried levers, the FLOP count and the older paths
             `solve_f64`, `solve_f32` and `backtrack_cuda` in another, and
             the eigh lever in another, while this one runs `facade`,
             acrobot's float32 smoke, `mixed_rescue`, `solve_hybrid_f32`
             and `parallel_dist`; the further processes' lines come after
             those paths. The seconds of all of these are taken with eleven
             processes running;
  turns      with --turns: the flat pure-f64 solve and the mixed solve in
             turns on the same batch (pure, mixed, mixed, pure);
  solve_hybrid_f32  30 iterations of the same in float32;
  solve_f64  (in a further process, `older_paths`) the pure backtracking
             path (graph-replayed plain rollout, sweep kernel) at 16 lanes,
             same gates; `solve_f32` the same for 30 iterations in float32;
  backtrack_cuda  (in the same process) 20 iterations of pure
             backtracking with the forward-trial kernel as the rollout;
  phases     a timed split of a few mid-solve iterations into the solver's
             phases, with the backtracking and with the hybrid forward pass;
  parent_and_change  with --parent DIR (a checkout of the parent commit):
             K3 built from that checkout's source under another stem and
             K3 of this tree in turns (parent, change, change, parent): K3's
             time in both types and the hybrid solve with each; and right
             after the kernel checks (`sweep_parent_and_change`, also with
             --kernels-only) every sweep instantiation of that checkout's
             `backward_sweep.cu`, built with its own geometry, against this
             tree's on the same inputs (K1 / K2 on the main shapes; the
             Bunch-Kaufman sweep on the three contact models' and the wide
             LDL^T sweep on cartpole's campaign states): flags equal on
             every lane, the gains' largest difference, times in turns;
  lane_independence  with --lane-independence, after the build and instead
             of the rest: pushing's campaign batch (101 lanes) against its
             rows 7, 55, 64, 88 alone, and those against row 7 alone, each
             pair stepped an iteration at a time in the associative order
             and compared bit for bit on the shared lanes after
             `initialize` and after each phase of `solve._body`; at the
             first difference, the phase is run again under an operation
             log on both batches and the first operation whose inputs agree
             on the shared lanes while its outputs do not is named, with
             its shapes (`_first_op`); and every phase of iterations 1 and
             30 run on the whole batch and on the same inputs cut to the
             shared lanes (`phase_invariance`).

Any failed assertion or exception ends the run with a non-zero exit code and
without the last line. The last three lines are the kernels' JSON object
(`launches`: the main path's, `solve_mixed`; for the Bunch-Kaufman sweep the
campaign's contact solves in f64 and its float32 solve), the card's name and
power limit, and the result object.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import io
import importlib
import json
import math
import multiprocessing
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from ipddp2tpu_torch import (Bound, Constraint, Dynamics, Objective, Solver,
                             solve_pool)
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
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.experiments import (independent_check, run_benchmarks,
                                         slsqp_table)
from ipddp2tpu_torch.models import (acrobot, cartpole, cartpole_swingup,
                                    concar, concar_quad, double_integrator,
                                    pushing, quadrotor)
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
from ipddp2tpu_torch.ops.profile_sweep import (CRAFTED_BK_LANES,
                                               CRAFTED_LANES, SECTIONS,
                                               crafted_bk_inputs,
                                               crafted_inputs, mid_state,
                                               model_inputs, perturb,
                                               sweep_inputs)
from ipddp2tpu_torch.batch import batch_stats
from ipddp2tpu_torch.parallel.priccati import backward_pass_parallel
from ipddp2tpu_torch.problem import Bounds, batch_bounds, uniform_bounds
from ipddp2tpu_torch.scripts import (flops_analysis, profile_iteration,
                                     residue_levers)
from ipddp2tpu_torch.experiments import (plot_distributions,
                                         plot_trajectories)
from ipddp2tpu_torch.serve import solve_pool_resident
from ipddp2tpu_torch.utils import load_state, profiling, save_state
from ipddp2tpu_torch.solve import (SolverState, _nominal_trial, initialize,
                                   iteration, resolve_options, run,
                                   select_state)

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
# ... and by type, against which P1's measured clocks a step are held: the
# multiply chain is at its latency bound within 2x of these
MUL_CLOCKS = {torch.float32: 4, torch.float64: 8}
# clocks a warp's FP64 instruction holds its sub-partition's FP64 pipe (16
# FP64 lanes a sub-partition on the H100): P2's issue floor
FP64_CLOCKS_PER_WARP_INSTRUCTION = 2
# the chains' lengths at which the probes are timed for their cost a step
PROBE_STEPS = (100, 400, 1600)
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


def check_kernel(name, args, dims, rtol, time_reps, need_both=True,
                 every_lane=False):
    """Kernel against plain on the same inputs; returns the measured fields.
    The flags are held on the lanes whose plain residual is not within 10x
    of the gate, or with `every_lane` on every lane."""
    dtype = args[18].dtype
    out_k = backward_sweep_cuda(*args, **dims, rtol=rtol)
    torch.cuda.synchronize()
    out_p = sweep_plain(*args, **dims, rtol=rtol)
    (gk, dLk, fk, sk), (gp, dLp, fp, sp) = out_k, out_p
    if every_lane:
        differ = [int((fk != fp).sum()), int((sk != sp).sum())]
        assert differ == [0, 0], \
            f"{name}: fail / singular flags differ on {differ} lanes"
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
SMALL_BATCH = 16


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


def hold_metrics(name, mk, mp, mr, edge, dtype, need_both_flags, failures,
                 hold_outside=True):
    """K3's outputs `mk` against the plain version's `mp` and the reference
    `mr` (`mp` itself in float64; in float32 the float64 plain version on
    the same inputs). The finite flags everywhere, the boundary flags away
    from the threshold (`edge [B, K]`), the measures inside the boundary
    and theta, J on every finite candidate (L takes the log of a negative
    slack outside; with `hold_outside` False those are reported, not held).
    Appends to `failures`; returns the measured fields."""
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
    if hold_outside:
        _held(failures, name, "measure (all finite candidates)",
              m_out_kernel, m_out_plain, TOL_OUTSIDE[dtype], wide)
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


def check_forward(name, args, K, dtype, time_reps, need_both_flags,
                  hold_outside=True):
    """K3 and K4 against their plain versions on the same inputs.

    float64: kernel against plain, relative to each tensor's scale: TOL on
    the candidates that stay inside the boundary, TOL_OUTSIDE on the rest.
    float32: the rollout feeds its rounding back through gains of 1e3 and
    more for T stages, so two float32 evaluations of one trajectory part by
    far more than rounding on the worst lanes, whatever computes them. Both
    the kernel and the float32 plain version are therefore held against the
    plain version in float64 on the same (float32) inputs, and the kernel
    must come as close to it as the plain version does, within a factor 4,
    or within the tolerances above. With `hold_outside` False the
    candidates outside the boundary are reported and not held (a model
    whose closed loop diverges there: the search rejects them by their
    flags, which stay held). Returns the measured fields of the metrics and
    of the trial kernel and the list of failed checks."""
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
    if hold_outside:
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
                           failures, hold_outside)
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
# lanes of the K3 grid (`metrics_grid`): its full batch, and that less 3 so
# that the last block is not filled (the main shapes' check, at B lanes and
# K = 8, is the `kernels` line's)
GRID_BATCH = 256


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
    DEPENDENT_OP_CLOCKS clocks each at the SM's highest clock `sm_mhz`.
    Returns the fields, the launch counts of one counted run of both, and
    the inputs (x0 of P1, x1 and u of P2)."""
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
    out["dynamics_chain"]["geometry"] = probe_chain.chain_geometry(
        batch, steps, dtype)._asdict()
    # the probes' own path: one run at this size, counted
    probe_chain.reset_launch_counts()
    probe_chain.mul_chain_cuda(x0, c, steps)
    probe_chain.dynamics_chain_cuda(x1, u)
    torch.cuda.synchronize()
    return out, dict(probe_chain.launch_counts), (x0, x1, u)


def step_fit(ms_by_steps, sm_mhz):
    """The least-squares line through (steps, ms): the cost of one more
    dependent step (ns, and clocks at `sm_mhz`) and the fixed cost."""
    steps = np.array(list(ms_by_steps), dtype=float)
    slope, intercept = np.polyfit(steps, np.array(list(ms_by_steps.values())),
                                  1)
    return dict(ms_by_steps={str(k): v for k, v in ms_by_steps.items()},
                ns_per_step=float(slope) * 1e6,
                clocks_per_step=float(slope) * sm_mhz * 1e3,
                intercept_ms=float(intercept))


def probe_steps(dtype, inputs, sm_mhz, seed):
    """Both probes' time against their chain's length (PROBE_STEPS, graph
    replay) with its line (`step_fit`), and the empty kernel at each
    probe's launch geometry in the same harness: the floor of one launch.
    P1's clocks a step are set beside the multiply's latency."""
    x0, x1, u = inputs
    c = 1.0000001
    batch = u.shape[0]
    mul = step_fit({n: graph_ms(lambda: probe_chain.mul_chain_cuda(x0, c, n),
                                10) for n in PROBE_STEPS}, sm_mhz)
    mul["empty_kernel_ms"] = graph_ms(lambda: probe_chain.empty_cuda(
        -(-x0.numel() // 128), 128), 10)
    mul["multiply_clocks"] = MUL_CLOCKS[dtype]
    mul["within_2x_of_multiply_latency"] = (
        mul["clocks_per_step"] <= 2 * MUL_CLOCKS[dtype])
    # longer chains' controls drawn on the card, within +-0.5 as `u`'s
    gen = torch.Generator(device=u.device).manual_seed(seed)
    us = {n: u if n == u.shape[1] else torch.rand(
        (batch, n, u.shape[2]), generator=gen, dtype=u.dtype,
        device=u.device) - 0.5 for n in PROBE_STEPS}
    dyn = step_fit({n: graph_ms(
        lambda: probe_chain.dynamics_chain_cuda(x1, us[n]), 10)
        for n in PROBE_STEPS}, sm_mhz)
    geo = probe_chain.chain_geometry(batch, u.shape[1], dtype)
    dyn["empty_kernel_ms"] = graph_ms(lambda: probe_chain.empty_cuda(
        geo.blocks, geo.instances_per_block, geo.smem_bytes), 10)
    return dict(mul_chain=mul, dynamics_chain=dyn), us


def _opcode(ins):
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def step_instructions(lib, kernel):
    """The FP64 instructions (opcodes D..., and conversions .F64) of one
    step of `kernel` (the start of its mangled name) in `lib`, read from
    `cuobjdump -sass`: the step loop is the innermost backward branch whose
    body holds a DFMA (P2's step loop is not unrolled), counted statically
    over every path of its body. None where the toolkit has no
    `cuobjdump` or no such loop is found."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip().startswith(kernel)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, ins in body:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?0x([0-9a-f]+)$", ins)
        if m and int(m.group(1), 16) < addr:
            span = [i for a, i in body if int(m.group(1), 16) <= a <= addr]
            if any(_opcode(i) == "DFMA" for i in span):
                loops.append((addr - int(m.group(1), 16), span))
    if not loops:
        return None
    span = min(loops, key=lambda x: x[0])[1]
    f64 = {}
    for i in span:
        op = _opcode(i)
        if (op[0] == "D" and not op.startswith("DEPBAR")) or ".F64" in op:
            f64[op] = f64.get(op, 0) + 1
    return dict(f64_instructions=sum(f64.values()), by_opcode=f64,
                instructions=len(span))


def parent_probe_library(parent_dir):
    """P2 built from the parent checkout's `probe_chain.cu` under another
    stem, bound with that design's interface (one thread an instance:
    x0, u, out, B, steps, stream)."""
    src = Path(parent_dir) / "ipddp2tpu_torch/ops/csrc/probe_chain.cu"
    lib = ctypes.CDLL(str(build.finish(build.start(
        "probe_chain_parent", src, depends=(
            src.parent / "models" / "concar.cuh",
            src.parent / "scalar_math.cuh")))))
    p, i = ctypes.c_void_p, ctypes.c_int
    for sfx in ("f32", "f64"):
        f = getattr(lib, f"dynamics_chain_{sfx}")
        f.restype, f.argtypes = i, [p, p, p, i, i, p]
    return lib


def parent_probe(lib, x1, us, sm_mhz):
    """The parent's P2 against this tree's on the same inputs (`us`: the
    controls by steps): x_T equal bit for bit at every length (asserted);
    times in turns parent, change, change, parent at the main length; the
    parent's time against the chain's length and its empty kernel."""
    fn = getattr(lib, "dynamics_chain_" + (
        "f64" if x1.dtype == torch.float64 else "f32"))

    def parent(u):
        out = torch.empty_like(x1)
        err = fn(x1.data_ptr(), u.data_ptr(), out.data_ptr(), u.shape[0],
                 u.shape[1], torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"parent dynamics_chain: CUDA error {err}"
        return out

    bits = torch.int64 if x1.dtype == torch.float64 else torch.int32
    for n, u in us.items():
        a_, b_ = parent(u), probe_chain.dynamics_chain_cuda(x1, u)
        torch.cuda.synchronize()
        differ = int((a_.view(bits) != b_.view(bits)).sum())
        assert differ == 0, \
            f"dynamics_chain {x1.dtype} T={n}: {differ} entries differ " \
            "from the parent's"
    u = us[PROBE_STEPS[0]]
    turns = [dict(which=w, ms=graph_ms(
        (lambda: parent(u)) if w == "parent"
        else (lambda: probe_chain.dynamics_chain_cuda(x1, u)), 10))
        for w in ("parent", "change", "change", "parent")]
    fit = step_fit({n: graph_ms(lambda: parent(u_), 10)
                    for n, u_ in us.items()}, sm_mhz)
    fit["empty_kernel_ms"] = graph_ms(lambda: probe_chain.empty_cuda(
        -(-x1.shape[0] // 128), 128), 10)
    return dict(bit_equal_steps=list(us), turns=turns, **fit)


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


def lane0_split(info):
    """Lane 0's path through the mixed solve: its f32 iterations and
    whether phase 1 converged it, its f64 endgame iterations, and whether
    the rescue took it (then its iterations there, from scratch)."""
    p1, p2, r = info["p1"], info["p2"], info["rescue"]
    out = dict(phase1_iterations=int(p1["k"][0]),
               phase1_converged=bool(p1["converged"][0]),
               phase2_f64_iterations=int(p2["k"][0] - p1["k"][0]),
               phase2_converged=bool(p2["converged"][0]), rescued=False)
    if r is not None and bool((r["indices"] == 0).any()):
        j = int(torch.nonzero(r["indices"] == 0)[0, 0])
        out.update(rescued=True, rescue_iterations=int(r["k"][j]))
    return out


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


# ---- the experiment layer: independent check, residue levers, profile ----

# `independent_check.main`'s runs: the double integrator with its cold and
# warm starts, and the warm starts of concar's and acrobot's first two
# committed instances (the JAX package's logs: a warm start of concar 5-19
# s, of acrobot 8-30 s; a cold start of concar 85-735 s, left out)
CHECK_RUNS = (["--problems", "double_integrator"],
              ["--problems", "concar", "acrobot_contact", "--seeds", "2",
               "--warm-only"])
# the (problem, seed) lines the runs must print
CHECK_ROWS = {("double_integrator", 1), ("concar", 1), ("concar", 2),
              ("acrobot_contact", 1), ("acrobot_contact", 2)}
# "ours" against the JAX campaign's results file: relative tolerance
CHECK_RTOL = 1e-4
# the residue seeds and the levers of the `residue_levers` phase
LEVER_SEEDS = (1002, 1004)
LEVERS = ("base", "bk")
PROFILE_REPS = 20


def residue_mid_state(problem, device, iterations=10):
    """(theta, state) of the 24 residue instances after `iterations`
    iterations of the default options."""
    _, _, theta, f_lim, tau_lim, x1 = concar.residue_instances(device)
    u0 = concar.initial_controls(device=device).expand(
        x1.shape[0], problem.T, problem.nu)
    return theta, mid_state(problem, theta, concar.bounds(
        f_lim, tau_lim, device=device), x1, u0, iterations, device=device)


def independent_check_phase(device):
    """`independent_check.main` on each of CHECK_RUNS (solves on `device`,
    SLSQP on the host), its standard output captured and read back through
    the port's `slsqp_table`. Returns (fields, launch counts)."""
    reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        codes = [independent_check.main(run + ["--device", device.type])
                 for run in CHECK_RUNS]
    lines = out.getvalue().splitlines()
    rows = [r for r in map(slsqp_table.parse_line, lines) if r]
    counts = read_counts()
    return dict(seconds=time.perf_counter() - t0, exit_codes=codes,
                lines=[ln for ln in lines if ln.strip()], rows=rows,
                launches={k: v for k, v in counts.items() if v}), counts


def independent_check_gates(fields):
    """Every run exits 0 and checks every instance of CHECK_ROWS (none
    unconverged); every stationarity certificate holds; the double
    integrator's cold start is in our basin; each "ours" objective within
    CHECK_RTOL of its row in `experiments/results/<file>`. Returns each
    row's relative difference to that file."""
    assert fields["exit_codes"] == [0] * len(CHECK_RUNS), fields["exit_codes"]
    rows, lines = fields["rows"], fields["lines"]
    assert not [ln for ln in lines if "unconverged" in ln], lines
    assert {(r["problem"], r["seed"]) for r in rows} == CHECK_ROWS, lines
    tallies = [ln for ln in lines if "certificates held" in ln]
    assert len(tallies) == len(CHECK_RUNS) and all(
        t.split()[0].split("/")[0] == t.split()[0].split("/")[1]
        for t in tallies), tallies
    diffs = {}
    for r in rows:
        assert not r["violated"], f"independent_check: {r}"
        ref = float(run_benchmarks.reference_results(r["problem"])[2][
            r["seed"] - 1])
        diffs[f"{r['problem']}/{r['seed']}"] = abs(r["ours"] - ref) / abs(ref)
    assert max(diffs.values()) <= CHECK_RTOL, diffs
    di = [r for r in rows if r["problem"] == "double_integrator"]
    assert di[0]["cold"] is not None and di[0]["same"], di
    return diffs


def residue_levers_phase(device, seeds=LEVER_SEEDS, levers=LEVERS):
    """`residue_levers` with `levers` on each seed of `seeds` (chunks of
    50, 1000 iterations, on `device`): per (seed, lever) the script's
    lines, solved, seconds, whether the iterates are finite, and the
    launch counts. Returns (fields, counts by (seed, lever))."""
    fields, counts = {}, {}
    for seed in seeds:
        data = residue_levers.instances(seed, device)
        for lever in levers:
            key = f"{seed}/{lever}"
            reset_counts()
            sol, wall = residue_levers.solve_lever(lever, data, 1000, device)
            counts[key] = read_counts()
            fields[key] = dict(
                instances=len(data[0]), solved=int(sol.converged.sum()),
                seconds=wall, finite=all_finite(sol),
                lines=residue_levers.report(lever, data[0], sol, wall),
                launches={k: v for k, v in counts[key].items() if v})
    return fields, counts


def profile_phase(device):
    """`profile_iteration.profile` on `device` with PROFILE_REPS
    repetitions: ms and finiteness per piece, the launch counts. Returns
    (fields, counts)."""
    reset_counts()
    out = profile_iteration.profile(device, PROFILE_REPS)
    counts = read_counts()
    return dict(reps=PROFILE_REPS, ms={k: v[0] for k, v in out.items()},
                finite={k: v[1] for k, v in out.items()},
                launches={k: v for k, v in counts.items() if v}), counts


def older_paths(batch, seed, max_iterations, device):
    """The three older paths on the first SMALL_BATCH lanes of the main
    batch (`concar_batch(batch, ..., seed)`): `solve_f64` (pure
    backtracking, the graph-replayed plain rollout, the sweep kernel; the
    golden gates), `solve_f32` (the same path in float32, 30 iterations)
    and `backtrack_cuda` (20 iterations with the forward-trial kernel as the
    rollout, against the graph rollout). Returns {path: (fields, launch
    counts)}; the kernels each must launch are checked by the caller."""
    prob = concar.problem()
    nb = min(SMALL_BATCH, batch)
    theta, bounds, x1, u0 = concar_batch(batch, torch.float64, device, seed)
    th_s = concar.Theta(theta.obstacles[:nb])
    b_s = Bounds(bounds.lower[:nb], bounds.upper[:nb])
    out = {}

    # ---- solve_f64: pure backtracking, plain rollout, fewer lanes --------
    opts64 = Options(optimality_tolerance=1e-7,
                     max_iterations=max_iterations, backward_kernel="cuda")
    sol_b, wall_b, counts = timed_solve(prob, b_s, x1[:nb], u0[:nb],
                                        theta=th_s, options=opts64)
    assert counts["forward_metrics_f64"] == 0 \
        and counts["forward_trial_f64"] == 0
    golden_gates(sol_b, nb)
    out["solve_f64"] = (dict(T=prob.T, **solve_fields(sol_b, nb, wall_b),
                             sweep_launches=counts["backward_sweep_f64"]),
                        counts)

    # the same path in float32, 30 iterations
    th32, b32, x32, u32 = concar_batch(batch, torch.float32, device, seed)
    b32 = Bounds(*(x[:nb] for x in b32))
    th32, x32, u32 = concar.Theta(th32.obstacles[:nb]), x32[:nb], u32[:nb]
    opts32 = Options(optimality_tolerance=1e-7, max_iterations=30,
                     backward_kernel="cuda")
    p0 = initialize(prob, th32, b32, x32, u32, opts32).c_raw.abs() \
        .flatten(1).amax(dim=1)
    sol_b32, wall_b32, counts = timed_solve(prob, b32, x32, u32, theta=th32,
                                            options=opts32)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (sol_b32.x, sol_b32.u, sol_b32.phi, sol_b32.zl,
                           sol_b32.zu))
    assert finite and sol_b32.x.dtype == torch.float32
    assert float(sol_b32.primal_inf.median()) < float(p0.median())
    out["solve_f32"] = (dict(
        batch=nb, iterations=30, seconds=wall_b32, finite=finite,
        sweep_launches=counts["backward_sweep_f32"],
        primal_inf_initial_median=float(p0.median()),
        primal_inf_final_median=float(sol_b32.primal_inf.median())), counts)

    # ---- backtrack_cuda: K4 as the rollout of pure backtracking ----------
    bt = Options(optimality_tolerance=1e-7, max_iterations=20,
                 backward_kernel="cuda", forward_kernel="cuda")
    sol_k, wall_k, counts = timed_solve(prob, b_s, x1[:nb], u0[:nb],
                                        theta=th_s, options=bt)
    assert counts["forward_metrics_f64"] == 0
    assert bool(torch.isfinite(sol_k.x).all())
    ref20 = solve_batch(prob, b_s, x1[:nb], u0[:nb], theta=th_s,
                        options=Options(optimality_tolerance=1e-7,
                                        max_iterations=20,
                                        backward_kernel="cuda"))
    out["backtrack_cuda"] = (dict(
        batch=nb, iterations=20, seconds=wall_k,
        trial_launches=counts["forward_trial_f64"],
        same_iteration_counts_as_graph_rollout=bool(
            (ref20.iterations == sol_k.iterations).all()),
        max_abs_state_difference_to_graph_rollout=float(
            (ref20.x - sol_k.x).abs().max())), counts)
    return out


# the kernels each older path must launch
OLDER_PATH_KERNELS = {"solve_f64": ("backward_sweep_f64",),
                      "solve_f32": ("backward_sweep_f32",),
                      "backtrack_cuda": ("backward_sweep_f64",
                                         "forward_trial_f64")}


# ---- the last slice: trajectories, the untried levers, the FLOP count,
# the campaign's tables and the certificates of its off-file rows ----------

# what this run writes for reading afterwards (git-ignored)
OUT_DIR = Path(__file__).resolve().parent / "smoke_out"
TRAJECTORY_DIR = OUT_DIR / "trajectories"
TABLE_DIR = OUT_DIR / "campaign_tables"
# the seed-1 solves of `plot_trajectories` that the run makes, and the
# sweep kernel each must launch; pushing's (374 iterations, 154 s beside
# the other processes) is left out for the run's time: the campaign solves
# its instance as lane 100
TRAJECTORY_KERNELS = {"concar": "backward_sweep_f64",
                      "quadrotor": "backward_sweep_f64",
                      "cartpole": "backward_sweep_bk_f64",
                      "acrobot": "backward_sweep_bk_f64"}
# the levers of `residue_levers` the card had not run, on one seed, in two
# processes: eigh (the plain sweep, eager, the slowest by far) alone; the
# JAX package's native-f64 record solves 9 of 9 there with refine3 and the
# resets (docs/PERF.md, round-5 lever measurements)
UNTRIED_GROUPS = (("refine3", "resets", "qn"), ("eigh",))
UNTRIED_LEVERS = tuple(lever for group in UNTRIED_GROUPS for lever in group)
UNTRIED_SEED = 1002
LEVERS_SOLVING_ALL = ("refine3", "resets")
SWEEP_KERNELS = ("backward_sweep_f64", "backward_sweep_f32",
                 "backward_sweep_bk_f64", "backward_sweep_bk_f32")
# the campaigns whose rows off the JAX results file (objective beyond this
# relative difference) get SLSQP's warm-start certificate
CERTIFY = ("concar",)
OFF_FILE_RTOL = 1e-4


def trajectories_phase(device):
    """The solving half of `plot_trajectories` for the models of
    TRAJECTORY_KERNELS on `device` (B = 1 each), the arrays saved under
    TRAJECTORY_DIR: per model
    iterations, objective, status, finiteness, seconds, launches, its
    golden anchor (and whether it is on it, by the campaign's rule) and row
    1 of the JAX results file. Returns (fields, counts by model)."""
    fields, counts = {}, {}
    for name in TRAJECTORY_KERNELS:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = plot_trajectories.trajectories(name, device)
        torch.cuda.synchronize()
        wall, counts[name] = time.perf_counter() - t0, read_counts()
        path = plot_trajectories.save(data, TRAJECTORY_DIR)
        mod, stem = run_benchmarks.MODELS[name]
        g_obj, g_it = run_benchmarks.golden_of(name, mod)
        its, obj = int(data["iterations"]), float(data["objective"])
        conv = bool(data["converged"])
        r_conv, r_its, r_obj = run_benchmarks.reference_results(stem, 1)
        fields[name] = dict(
            iterations=its, objective=obj, converged=conv,
            status=int(data["status"]),
            tolerance=plot_trajectories.options(name).optimality_tolerance,
            finite=bool(np.isfinite(data["x"]).all()
                        and np.isfinite(data["u"]).all()),
            seconds=wall, npz=str(path.relative_to(OUT_DIR.parent)),
            launches={k: v for k, v in counts[name].items() if v},
            golden=dict(objective=g_obj, iterations=g_it,
                        on_golden=run_benchmarks.on_golden(
                            name, obj, its, conv, (g_obj, g_it))),
            jax_results_row1=dict(objective=float(r_obj[0]),
                                  iterations=int(r_its[0]),
                                  converged=bool(r_conv[0])))
    return fields, counts


def trajectories_gates(fields, counts):
    """Every solve converged, finite, and launched its sweep kernel;
    concar's on its golden anchor."""
    for name, f in fields.items():
        assert f["converged"] and f["finite"], f"trajectories/{name}: {f}"
        kernel = TRAJECTORY_KERNELS[name]
        assert counts[name][kernel] > 0, \
            f"trajectories/{name} missed the kernel {kernel}"
    assert fields["concar"]["golden"]["on_golden"], fields["concar"]


def untried_levers_gates(fields, counts, base):
    """Finite on every lever; refine3 and the resets solve every instance;
    the eigh lever launched no sweep kernel (its route is the plain sweep).
    Returns each lever's solved and median k beside `base`'s."""
    beside = {}
    for lever in UNTRIED_LEVERS:
        key = f"{UNTRIED_SEED}/{lever}"
        f = fields[key]
        assert f["finite"], f"residue_levers {key}: non-finite iterates"
        if lever in LEVERS_SOLVING_ALL:
            assert f["solved"] == f["instances"], \
                f"residue_levers {key}: {f['solved']}/{f['instances']}"
        beside[lever] = dict(solved=f["solved"], seconds=f["seconds"],
                             base_solved=base["solved"],
                             base_seconds=base["seconds"])
    eigh = counts[f"{UNTRIED_SEED}/eigh"]
    assert not any(eigh[k] for k in SWEEP_KERNELS), \
        f"the eigh lever launched a sweep kernel: {eigh}"
    return beside


def flops_phase():
    """`flops_analysis.count` of one concar iteration at B = 1 in float64
    with the speculative search (K = 8), on CPU tensors."""
    t0 = time.perf_counter()
    c = flops_analysis.count(1, torch.float64, "cpu")
    return dict(per_instance_iteration=c["flops"],
                transcendentals=c["transcendentals"],
                line_search_rollouts=c["trials"],
                by_piece={k: v["flops"] for k, v in c["by_piece"].items()},
                uncounted=c["uncounted"], T=c["T"],
                ls_speculative=c["ls_speculative"],
                seconds=time.perf_counter() - t0,
                line=flops_analysis.report(c)[0])


def off_file_certificates(name, sol, device):
    """SLSQP's warm-start certificate (`independent_check.check_instance`,
    no cold start) of every converged row of a campaign whose objective
    differs from the JAX results file's beyond OFF_FILE_RTOL, warm-started
    from that lane's controls. Returns one dict a row."""
    mod, stem = run_benchmarks.MODELS[name]
    n = CAMPAIGN_SEEDS
    _, _, r_obj = run_benchmarks.reference_results(stem, n)
    obj = sol.objective[:n].cpu()
    off = (((obj - r_obj).abs() > OFF_FILE_RTOL * r_obj.abs())
           & sol.converged[:n].cpu())
    th, b, x1, u0 = run_benchmarks.instances(name, n, device=device)
    rows = []
    for i in torch.nonzero(off)[:, 0].tolist():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, held = independent_check.check_instance(
                f"{name} seed {i + 1}", mod.problem(),
                Bounds(b.lower[i], b.upper[i]),
                type(th)(*(a[i] for a in th)), x1[i], u0[i], sol.u[i],
                maxiter=400, cold_start=False)
        rows.append(dict(seed=i + 1, objective=float(obj[i]),
                         jax_objective=float(r_obj[i]),
                         iterations=int(sol.iterations[i]), held=held,
                         seconds=time.perf_counter() - t0,
                         line=out.getvalue().strip()))
    return rows


# ---- the six further benchmark models: campaign and kernel checks ---------

# the six further models (modules), whose kernels the script checks on
# their campaign instances
CAMPAIGN = (("concar_quad", concar_quad), ("quadrotor", quadrotor),
            ("cartpole_swingup", cartpole_swingup), ("acrobot", acrobot),
            ("cartpole", cartpole), ("pushing", pushing))
CONTACT = run_benchmarks.CONTACT
CAMPAIGN_SEEDS = run_benchmarks.SEEDS
# the campaign's solves, (model, search) pairs in three groups, each group
# solved in a process of its own (`campaign_beside`) while the main process
# runs other paths, for the script's time: pushing's batch (its slowest
# lanes take the 1000-iteration cap) alone, and the other seven in two
# groups of about the same time
BESIDE = ((("pushing", "backtracking"),),
          (("acrobot", "backtracking"), ("cartpole_swingup", "backtracking"),
           ("concar_quad", "backtracking")),
          (("concar", "backtracking"), ("acrobot", "hybrid"),
           ("quadrotor", "backtracking"), ("cartpole", "backtracking")))
# the order of the campaign's lines
CAMPAIGN_LINES = ("concar",) + tuple(name for name, _ in CAMPAIGN)
# the least share of the 100 that a campaign solve must converge: the JAX
# package solves 100 of 100 on each of them but pushing (98)
CAMPAIGN_SOLVED = {"pushing": 0.95}
# the models whose golden lane (lane 100) is gated on its anchor's rule
CAMPAIGN_GOLDEN = ("concar",)
# kernel-against-plain tolerance of the Bunch-Kaufman sweep, relative to
# each gain tensor's scale on the lanes that pass, in the working type on
# both sides. The solve is plain substitution without refinement on the
# contact models' KKT matrices, so one rounding of the two (other order,
# fused multiply-adds) is amplified by their conditioning (measured on the
# H100: 3.4e-13 in float64; in float32 both sides 1.7e-4 from the float64
# plain version).
BK_TOL = {torch.float64: 1e-8, torch.float32: 1e-3}


def campaign_batch(name, dtype, device):
    """Lanes 0..99: the JAX campaign's instances (experiments/params, seed
    1 first); lane 100: the golden anchor's instance."""
    return run_benchmarks.instances(name, dtype=dtype, device=device,
                                    golden=True)


def campaign_kernels(name, search):
    """The kernels a campaign solve must launch: the sweep (bk on the
    contact models), and K3 / K4 with the hybrid search."""
    sweep = ("backward_sweep_bk_f64" if name in CONTACT
             else "backward_sweep_f64")
    forward = (("forward_metrics_f64", "forward_trial_f64")
               if search == "hybrid" else ())
    return (sweep,) + forward


def campaign_solve(name, search, device):
    """One model's campaign batch (and its golden lane) solved through
    `ipddp2tpu_torch.experiments.run_benchmarks` as the JAX campaign solves
    it (f64, tolerance 1e-7, backtracking, inertia "auto") or with the
    hybrid search, beside the JAX results file. Returns (fields, finite,
    launch counts)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = run_benchmarks.solve(name, run_benchmarks.options(search=search),
                               device=device, golden=True)
    torch.cuda.synchronize()
    wall, counts = time.perf_counter() - t0, read_counts()
    fields = dict(run_benchmarks.compare(name, sol, CAMPAIGN_SEEDS),
                  seconds=wall, launches={k: v for k, v in counts.items()
                                          if v})
    if search == "backtracking":
        # the JAX results format, read back by `plot_distributions`
        TABLE_DIR.mkdir(parents=True, exist_ok=True)
        (TABLE_DIR / f"{run_benchmarks.MODELS[name][1]}.txt").write_text(
            run_benchmarks.results_table(sol, CAMPAIGN_SEEDS))
        if name in CERTIFY:
            fields["off_file_certificates"] = off_file_certificates(
                name, sol, device)
    return fields, all_finite(sol), counts


def beside_job(job, device):
    """One job of a process beside the main one: a campaign solve (model,
    search), `residue_solves` ("residue", None), or `serve_phase` or
    `parallel_solves` on the main batch's first lanes ("serve" or
    "parallel_solves", (batch, seed)), or a phase of the experiment layer
    ("independent_check", "residue_levers", "profile_iteration", None),
    or of the last slice ("trajectories", None), ("untried_levers", a
    tuple of levers), ("flops", None), or the three older paths
    ("older_paths", (batch, seed, max_iterations))."""
    kind, arg = job
    if kind == "residue":
        return residue_solves(concar.problem(), MIXED_ITERATIONS, device)
    if kind == "independent_check":
        return independent_check_phase(device)
    if kind == "residue_levers":
        return residue_levers_phase(device)
    if kind == "profile_iteration":
        return profile_phase(device)
    if kind == "trajectories":
        return trajectories_phase(device)
    if kind == "untried_levers":
        return residue_levers_phase(device, (UNTRIED_SEED,), arg)
    if kind == "flops":
        return flops_phase()
    if kind == "older_paths":
        return older_paths(*arg, device)
    if kind == "serve":
        theta, bounds, x1, u0 = concar_batch(arg[0], torch.float64, device,
                                             arg[1])
        return serve_phase(concar.problem(), bounds, x1, u0, theta,
                           SPECULATIVE, device=device)
    if kind == "parallel_solves":
        theta, bounds, x1, u0 = concar_batch(arg[0], torch.float64, device,
                                             arg[1])
        return parallel_solves(concar.problem(), bounds, x1, u0, theta,
                               SPECULATIVE)
    return campaign_solve(kind, arg, device)


def campaign_beside(jobs, device, conn):
    """A further process's work: `beside_job` of each job in `jobs` on
    `device`, the list of results, or the error, sent back through
    `conn`. One intra-op thread: eleven processes share the host's cores,
    and a pool of threads in each would compete for them."""
    torch.set_num_threads(1)
    try:
        conn.send(("ok", [beside_job(job, torch.device(device))
                          for job in jobs]))
    except BaseException as e:
        conn.send(("error", f"{type(e).__name__}: {e}"))
        raise
    finally:
        conn.close()


def start_beside(jobs, device="cuda", target=None):
    """Start `campaign_beside(jobs, device)` (or `target`, which takes the
    same arguments) in a new process, spawned: this one holds a CUDA
    context. It loads the libraries this process built."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=target or campaign_beside,
                       args=(jobs, device, send))
    proc.start()
    send.close()
    return proc, recv


def finish_beside(beside, timeout=1000.0):
    """A further process's results; raises on its error, on its end
    without results, and after `timeout` seconds."""
    proc, recv = beside
    assert recv.poll(timeout), "campaign_beside: no result in time"
    kind, out = recv.recv()
    assert kind == "ok", f"campaign_beside: {out}"
    proc.join(60)
    assert proc.exitcode == 0, f"campaign_beside: exit {proc.exitcode}"
    return out


def stop_beside(beside):
    """End a further process, whatever state it is in."""
    proc, recv = beside
    recv.close()
    if proc.is_alive():
        proc.terminate()
    proc.join(10)
    if proc.is_alive():
        proc.kill()
        proc.join()


def campaign_gates(name, fields, finite, counts, names):
    """What fails the run: non-finite iterates, fewer solved than
    CAMPAIGN_SOLVED (95 %), a kernel of the path never launched, and for
    CAMPAIGN_GOLDEN the golden lane off its anchor."""
    assert finite, f"campaign/{name}: non-finite iterates"
    least = CAMPAIGN_SOLVED.get(name, 0.95) * CAMPAIGN_SEEDS
    assert fields["solved"] >= least, \
        f"campaign/{name}: {fields['solved']} solved < {least}"
    if name in CAMPAIGN_GOLDEN:
        assert fields["golden"]["on_golden"], \
            f"campaign/{name}: golden lane {fields['golden']}"
    for k in names:
        assert counts[k] > 0, f"campaign/{name} missed the kernel {k}"


# pushing's campaign rows (0 = seed 1) that end with a failed line search
# (status 7) in the campaign's batch of 101 in the associative costate
# order on an H100; with rows 2 and 87 at the iteration cap that leaves 94
# of the 100 solved, below the campaign's gate of 95, where the sequential
# order solves 97. Solved as a batch of their own they converge: on the card
# a lane's path depends on its batch (`lane_independence`).
ORDER_ROWS = (7, 55, 64, 88)


@contextlib.contextmanager
def costate_order(mode):
    """The solver's costate scan in `mode` ("seq" or "assoc") while the
    block runs: the script patches the name that `solve._body` calls."""
    module = importlib.import_module("ipddp2tpu_torch.solve")
    scan = module.costate_scan
    module.costate_scan = lambda deriv, phi: scan(deriv, phi, mode=mode)
    try:
        yield
    finally:
        module.costate_scan = scan


# ---- --lane-independence: does a lane's path depend on its batch? ---------

# the names `solve._body` calls, in its order: the phases compared after
# each iteration
BODY_PHASES = ("evaluate_derivatives", "relax_constraints", "costate_scan",
               "contract_dynamics_hessian", "backward_pass", "dual_error",
               "cs_error", "barrier_lagrangian", "forward_pass",
               "_augment_filter", "_reset_filter")


def _leaves(tree, path=""):
    """(path, tensor) of every tensor in a nested tuple / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, item in zip(names, tree):
            yield from _leaves(item, f"{path}.{name}" if path else str(name))


def _lane_view(t, batch, lanes):
    """The rows of `lanes` of a tensor whose first axis is the batch (or
    the batch times a count, batch-major, as a flattened `[B*T, ...]`), as
    `[len(lanes), ...]`; None for any other tensor."""
    if t.dim() == 0 or t.shape[0] % batch:
        return None
    per = t.shape[0] // batch
    view = t.reshape((batch, per) + tuple(t.shape[1:]))
    return view[lanes].clone()


def _bits(t):
    """A tensor's bit pattern (NaN equal to the same NaN)."""
    if t.is_floating_point():
        return t.contiguous().view({8: torch.int64, 4: torch.int32,
                                    2: torch.int16}[t.element_size()])
    return t


def _same(a, b):
    return (a is not None and b is not None and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _first_difference(a, b):
    """Where two lane views of one shape first differ: index, both values
    (as `float.hex` too) and the largest absolute difference."""
    diff = _bits(a) != _bits(b)
    at = [int(i) for i in torch.nonzero(diff)[0]]
    va, vb = a[tuple(at)].item(), b[tuple(at)].item()
    out = dict(index=at, value_a=va, value_b=vb)
    if a.is_floating_point():
        gap = (a.double() - b.double())[diff].abs()
        out.update(hex_a=float(va).hex(), hex_b=float(vb).hex(),
                   differing=int(diff.sum()),
                   max_abs_diff=float(gap.nan_to_num(nan=float("inf"))
                                      .max()))
    return out


class PhaseRecorder:
    """Wraps the names of BODY_PHASES in `ipddp2tpu_torch.solve` while it
    is entered: every call keeps its arguments and the rows of `lanes` of
    its outputs."""

    def __init__(self, batch, lanes):
        self.batch, self.lanes, self.calls = batch, lanes, []

    def __enter__(self):
        module = importlib.import_module("ipddp2tpu_torch.solve")
        self.saved = {n: getattr(module, n) for n in BODY_PHASES}

        def wrap(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                self.calls.append((name, fn, args, kw, [
                    (p, _lane_view(t, self.batch, self.lanes))
                    for p, t in _leaves(out if isinstance(out, tuple)
                                        else (out,))]))
                return out
            return call

        for name, fn in self.saved.items():
            setattr(module, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        module = importlib.import_module("ipddp2tpu_torch.solve")
        for name, fn in self.saved.items():
            setattr(module, name, fn)


def _op_log(fn, args, kw, batch, lanes):
    """Every aten operation `fn(*args, **kw)` dispatches, in order: (name,
    inputs, outputs, shapes), the tensors as rows of `lanes` (or whole,
    when they have no batch axis and at most 1e5 elements). A launch
    through `ctypes` (the sweep kernels) is no aten operation: its outputs
    show up as inputs of the next one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def keep(t):
        if not isinstance(t, torch.Tensor):
            return None
        v = _lane_view(t, batch, lanes)
        if v is None and t.numel() <= 100_000:
            v = ("whole", t.detach().clone())
        return v

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, a=(), k=None):
            k = k or {}
            flat = [x for _, x in _leaves(tuple(a) + tuple(k.values()))]
            ins = [keep(x) for x in flat]
            out = func(*a, **k)
            outs = [keep(x) for _, x in
                    _leaves(out if isinstance(out, tuple) else (out,))]
            self.ops.append((str(func), ins, outs,
                             [list(x.shape) for x in flat]))
            return out

    enabled = graphs.ENABLED
    graphs.ENABLED = False            # a replayed graph hides its operations
    try:
        with Log() as log:
            out = fn(*args, **kw)
    finally:
        graphs.ENABLED = enabled
    return log.ops, [_lane_view(t, batch, lanes) for _, t in
                     _leaves(out if isinstance(out, tuple) else (out,))]


def _comparable(x, y):
    """Both kept the same way (rows of the lanes, or whole) and of one
    shape: only then are two recorded tensors compared."""
    return (x is not None and y is not None
            and isinstance(x, tuple) == isinstance(y, tuple)
            and (x[1] if isinstance(x, tuple) else x).shape
            == (y[1] if isinstance(y, tuple) else y).shape)


def _views_equal(x, y):
    """Equal, or not comparable."""
    if not _comparable(x, y):
        return True
    return _same(*((x[1], y[1]) if isinstance(x, tuple) else (x, y)))


def _first_op(ops_a, ops_b):
    """Pair the two operation logs (the longest matching runs of names;
    a host loop may run more often in one batch) and find, among the pairs
    whose inputs have the same shapes but for the batch axis and whose
    outputs carry the batch axis, the first whose outputs differ on the
    shared lanes and the first whose inputs agree there while its outputs
    do not: the operation that makes the difference, with its input shapes
    in both batches. (An output without the batch axis, such as one lane
    picked out by `vmap`'s loop over lanes for an operation without a
    batching rule, is not compared.)"""
    import difflib
    names = [[op[0] for op in ops] for ops in (ops_a, ops_b)]
    blocks = difflib.SequenceMatcher(None, *names,
                                     autojunk=False).get_matching_blocks()
    pairs = [(m.a + i, m.b + i) for m in blocks for i in range(m.size)]
    found = dict(ops=[len(ops_a), len(ops_b)], paired=len(pairs))
    lanes_of = lambda x: x is not None and not isinstance(x, tuple)
    for i, j in pairs:
        name, ia, oa, sa = ops_a[i]
        _, ib, ob, sb = ops_b[j]
        if len(sa) != len(sb) or any(x[1:] != y[1:]
                                     for x, y in zip(sa, sb)):
            continue
        bad = [n for n, (x, y) in enumerate(zip(oa, ob))
               if lanes_of(x) and lanes_of(y) and not _views_equal(x, y)]
        if not bad:
            continue
        row = dict(op_index=[i, j], op=name, input_shapes_a=sa,
                   input_shapes_b=sb, output=bad[0],
                   **_first_difference(oa[bad[0]], ob[bad[0]]))
        found.setdefault("first_differing_output", row)
        if all(_views_equal(x, y) for x, y in zip(ia, ib)):
            found["culprit"] = row
            break
    return found


def lane_paths(problem, batches, options, max_iterations):
    """Step two batches (each (theta, bounds, x1, u0, lanes): the rows of
    the lanes they share) one iteration at a time, as `solve.run` does,
    recording the outputs of every phase of `_body`; after each iteration
    compare the shared lanes bit for bit. At the first difference, run the
    first differing phase once more on each batch's recorded arguments
    under an operation log and find the operation that makes it. Returns
    the fields of the comparison."""
    states = [initialize(problem, th, batch_bounds(b, x.shape[0]), x, u,
                         options, device=x.device)
              for th, b, x, u, _ in batches]
    sa, sb = (tree_lanes(s, b_[4]) for s, b_ in zip(states, batches))
    for name, a_, b_ in zip(sa._fields, sa, sb):
        if not _same(a_, b_):
            return dict(differ=True, iteration=0, phase="initialize",
                        output=name, **_first_difference(a_, b_))
    for it in range(max_iterations):
        lives = [(s.status == 0) & ~s.converged & (s.k < max_iterations)
                 for s in states]
        shared = [live[lanes] for live, (*_, lanes) in zip(lives, batches)]
        if not bool(shared[0].any() or shared[1].any()):
            return dict(differ=False, iterations=it,
                        k=states[0].k[batches[0][4]].tolist(),
                        status=states[0].status[batches[0][4]].tolist())
        recs = []
        for i, ((th, b, x, u, lanes), s) in enumerate(zip(batches, states)):
            bb = batch_bounds(b, x.shape[0])
            with PhaseRecorder(x.shape[0], lanes) as rec:
                new = iteration(problem, bb, s, th, options,
                                device=x.device)
            states[i] = select_state(lives[i], new, s)
            recs.append(rec.calls)
        first = None
        for ca, cb in zip(*recs):
            assert ca[0] == cb[0], (ca[0], cb[0])
            for (path, va), (_, vb) in zip(ca[4], cb[4]):
                if va is not None and not _same(va, vb):
                    first = (ca, cb, path, _first_difference(va, vb))
                    break
            if first:
                break
        sa, sb = (tree_lanes(s, b_[4]) for s, b_ in zip(states, batches))
        state_same = all(_same(a_, b_) for a_, b_ in zip(sa, sb))
        if first is None and state_same:
            continue
        fields = dict(differ=True, iteration=it + 1, k_after=sa.k.tolist(),
                      status_after=[sa.status.tolist(), sb.status.tolist()])
        if first is None:
            fields["phase"] = "select (state after the iteration)"
            return fields
        ca, cb, path, where = first
        fields.update(phase=ca[0], output=path, **where)
        logs = [_op_log(c[1], c[2], c[3], bt[2].shape[0], bt[4])
                for c, bt in zip((ca, cb), batches)]
        fields["rerun_reproduces"] = all(
            all(_views_equal(v, w) for (_, v), w in zip(c[4], log[1]))
            for c, log in zip((ca, cb), logs))
        fields["operations"] = _first_op(logs[0][0], logs[1][0])
        return fields
    return dict(differ=False, iterations=max_iterations)


def tree_lanes(state, lanes):
    return type(state)(*(t[lanes] for t in state))


def _slice_args(tree, batch, lanes):
    """Every tensor of a nested tuple whose first axis is the batch, cut
    to the rows `lanes` (the problem, options and other leaves as they
    are)."""
    if isinstance(tree, torch.Tensor):
        return tree[lanes] if tree.dim() and tree.shape[0] == batch else tree
    if isinstance(tree, dict):
        return {k: _slice_args(v, batch, lanes) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_slice_args(t, batch, lanes) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree


def phase_invariance(problem, data, lanes, options, iterations):
    """Each phase of `_body` (and `initialize`) run on the batch `data` =
    (theta, bounds, x1, u0) and once more on the same inputs cut to
    `lanes`, at each iteration in `iterations` of the batch's own path:
    whether the lanes' outputs agree bit for bit and, where they do not,
    the first operation that makes them differ (`_first_op`). What differs
    here differs with identical inputs, so it is the batch's shape alone."""
    th, b, x, u = data
    B = x.shape[0]
    sub = len(lanes)
    everyone = torch.arange(sub, device=x.device)
    out = {}

    def check(fn, args, kw):
        full = fn(*args, **kw)
        cut = fn(*_slice_args(args, B, lanes), **_slice_args(kw, B, lanes))
        pairs = [(_lane_view(t, B, lanes), _lane_view(c, sub, everyone))
                 for (_, t), (_, c) in zip(
                     _leaves(full if isinstance(full, tuple) else (full,)),
                     _leaves(cut if isinstance(cut, tuple) else (cut,)))]
        bad = [i for i, (p, q) in enumerate(pairs)
               if p is not None and not _same(p, q)]
        row = dict(invariant=not bad)
        if bad:
            row.update(output=bad[0], **_first_difference(*pairs[bad[0]]))
            logs = (_op_log(fn, args, kw, B, lanes)[0],
                    _op_log(fn, _slice_args(args, B, lanes),
                            _slice_args(kw, B, lanes), sub, everyone)[0])
            row["operations"] = _first_op(*logs)
        return row

    bb = batch_bounds(b, B)
    init_args = (problem, th, bb, x, u, options)
    out["initialize"] = check(initialize, init_args, dict(device=x.device))
    s = initialize(*init_args, device=x.device)
    for it in range(max(iterations) + 1):
        live = (s.status == 0) & ~s.converged
        with PhaseRecorder(B, lanes) as rec:
            new = iteration(problem, bb, s, th, options, device=x.device)
        if it in iterations:
            seen = {}
            for name, fn, args, kw, _ in rec.calls:
                if name not in seen:
                    seen[name] = check(fn, args, kw)
            out[f"iteration_{it + 1}"] = seen
        s = select_state(live, new, s)
    return out


def lane_independence(device, rows=ORDER_ROWS, problem=None,
                      max_iterations=1000):
    """--lane-independence: pushing's campaign batch (101 lanes, f64,
    backtracking, inertia "auto" -> bk, the associative costate order)
    against the batch of `rows` alone, and that batch against its first
    row alone, each pair stepped by `lane_paths`. `problem` replaces
    pushing's (a shorter horizon on the CPU). Returns the phase's
    fields."""
    prob = problem or pushing.problem()
    T = prob.T
    cut = lambda data: (data[0], Bounds(data[1].lower[:, :T],
                                        data[1].upper[:, :T]),
                        data[2], data[3][:, :T])
    big = cut(campaign_batch("pushing", torch.float64, device))
    few = cut(pushing.from_params(convert.params_rows(pushing.PARAMS, rows),
                                  torch.float64, device))
    one = cut(pushing.from_params(convert.params_rows(pushing.PARAMS,
                                                      rows[:1]),
                                  torch.float64, device))
    idx = lambda r: torch.tensor(r, device=device)
    opts = Options(optimality_tolerance=1e-7)
    out = dict(rows=list(rows), batch=big[2].shape[0], T=T)
    t0 = time.perf_counter()
    with costate_order("assoc"):
        out["campaign_batch_against_rows"] = lane_paths(
            prob, ((*big, idx(list(rows))),
                   (*few, idx(list(range(len(rows)))))),
            opts, max_iterations)
        out["rows_against_first_alone"] = lane_paths(
            prob, ((*few, idx([0])), (*one, idx([0]))), opts,
            max_iterations)
        out["phases_rows"] = phase_invariance(
            prob, big, idx(list(rows)), opts, (0, 29))
        out["phases_first_row"] = phase_invariance(
            prob, big, idx(list(rows[:1])), opts, (0,))
    out["seconds"] = time.perf_counter() - t0
    return out


# ---- parallel / parallel_dist: the time-parallel pass and time sharding ---

# lanes of the main batch's mid-solve state held against the sweep kernel,
# and solved in the parallel mode
PARALLEL_BATCH = 256
PARALLEL_SIZES = (1, 8, 64, 512, 2048)
# parallel against sequential gains, relative to each tensor's scale on the
# lanes that pass: tests/test_priccati.py:144-150 (non-commuting concar)
PARALLEL_TOL = 1e-7
# the time-sharded solve: tests/test_timeshard.py's long-horizon case
DIST_T, DIST_ITERATIONS = 1024, 8
SHARD_LANES, SHARD_ITERATIONS = 128, 5
DIST_WORLD = 2


def backward_inputs(problem, theta, s):
    """What `solve._body` hands the backward pass at the state `s`:
    (deriv, nominal, lam, second)."""
    deriv = evaluate_derivatives(problem, theta, s.x, s.u, s.phi)
    lam = costate_scan(deriv, s.phi)
    second = deriv.cH_phi + contract_dynamics_hessian(problem, theta, s.x,
                                                      s.u, lam[:, 1:])
    nominal = (relax_constraints(problem, s.c_raw, s.mu), s.il, s.iu, s.phi,
               s.zl, s.zu)
    return deriv, nominal, lam, second


def backward_both(problem, theta, s, options):
    """The sequential backward pass (the sweep kernel in `options`' type)
    and the parallel one, as functions of nothing, on the state `s`."""
    deriv, nominal, lam, second = backward_inputs(problem, theta, s)
    args = (problem, deriv, nominal, s.mu, s.reg_last, options)
    kw = dict(lam=lam, second=second)
    return (lambda: backward_pass(*args, **kw),
            lambda: backward_pass_parallel(*args, **kw))


def parallel_against_sweep(problem, theta, s, options):
    """The parallel backward pass against the sequential one through the
    sweep kernel on one state: status and reg on every lane, each gain
    tensor's largest difference relative to its scale on the lanes where
    both pass."""
    seq, par = backward_both(problem, theta, s, options)
    reset_counts()
    a = seq()
    sweeps = sum(read_counts().values())
    b = par()
    both = (a.status == 0) & (b.status == 0)
    errs = {name: rel_err(x, y, both)[1]
            for name, x, y in zip(GAIN_NAMES, b.gains, a.gains)}
    return dict(lanes=int(s.mu.shape[0]),
                status_equal=bool((a.status == b.status).all()),
                reg_equal=bool(torch.equal(a.reg, b.reg)),
                lanes_passing=int(both.sum()),
                sweep_launches=sweeps, max_rel_err=errs,
                worst_rel_err=max(errs.values()))


def device_launches(fn):
    """Kernels and copies the device runs for one call of `fn`
    (`torch.profiler`); None where the profiler sees no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    copies = sum(e.count for e in events
                 if e.key.startswith(("Memcpy", "Memset")))
    return dict(kernels=sum(e.count for e in events) - copies,
                copies=copies)


def backward_turns(problem, theta, mid, sizes, reps=3):
    """The sequential pass through the sweep kernel and the parallel pass
    at each batch size of `sizes` (the first lanes of `mid`), in float64
    and float32: ms per pass from CUDA events over `reps` passes, in
    turns (sequential, parallel, parallel, sequential), and the device's
    launches for one pass of each."""
    rows = {}
    for dtype in (torch.float64, torch.float32):
        opts = Options(optimality_tolerance=1e-7, backward_kernel="cuda")
        for B in sizes:
            s = cast_tree(tree_lanes(mid, slice(0, B)), dtype)
            th = concar.Theta(theta.obstacles[:B].to(dtype))
            fns = dict(zip(("sequential", "parallel"),
                           backward_both(problem, th, s, opts)))
            ms = {k: [] for k in fns}
            for k in ("sequential", "parallel", "parallel", "sequential"):
                ms[k].append(cuda_ms(fns[k], reps))
            rows[f"{'f64' if dtype == torch.float64 else 'f32'}/B={B}"] = \
                dict(turns_ms=ms,
                     **{f"{k}_ms": sum(v) / len(v) for k, v in ms.items()},
                     **{f"{k}_launches": device_launches(f)
                        for k, f in fns.items()})
    return rows


def parallel_solves(problem, bounds, x1, u0, theta, K):
    """Concar's seed-1 instance alone, then the first PARALLEL_BATCH lanes
    of the main batch, in float64 with backward_mode="parallel" and the
    hybrid search (K3 / K4). Returns the fields of both."""
    opts = Options(optimality_tolerance=1e-7, backward_mode="parallel",
                   ls_speculative=K, ls_spec_continue=True)
    out = {}
    for label, n in (("seed1", 1), ("batch", PARALLEL_BATCH)):
        sol, wall, counts = timed_solve(
            problem, Bounds(bounds.lower[:n], bounds.upper[:n]), x1[:n],
            u0[:n], theta=concar.Theta(theta.obstacles[:n]), options=opts)
        out[label] = dict(
            **solve_fields(sol, n, wall),
            lane0_on_golden=bool(sol.converged[0]) and math.isclose(
                float(sol.objective[0]), concar.SEED1_GOLDEN_OBJECTIVE,
                rel_tol=1e-6),
            finite=all_finite(sol),
            launches={k: v for k, v in counts.items() if v})
    return out


def di_long(T, device):
    """The double integrator at horizon T (tests/test_timeshard.py's
    long-horizon case): (problem, bounds, x1 [1, nx], u0 [1, T, nu])."""
    prob = dataclasses.replace(double_integrator.problem(), T=T)
    inf = float("inf")
    lo = torch.tensor([-double_integrator.FORCE_LIMIT, 0.0, 0.0],
                      dtype=torch.float64, device=device)
    hi = torch.tensor([double_integrator.FORCE_LIMIT, inf, inf],
                      dtype=torch.float64, device=device)
    return (prob, uniform_bounds(T, lo, hi),
            double_integrator.initial_state(device=device)[None],
            torch.full((1, T, double_integrator.NU), 0.01,
                       dtype=torch.float64, device=device))


def dist_options(iterations, **kw):
    return Options(optimality_tolerance=1e-7, max_iterations=iterations,
                   auto_tune=False, **kw)


def one_rank_nccl(device):
    """World size 1 over NCCL on the card: `solve_timesharded` of the long
    double integrator against the parallel and the sequential modes."""
    from ipddp2tpu_torch.parallel import make_mesh
    from ipddp2tpu_torch.parallel.timeshard import solve_timesharded
    SCRATCH.mkdir(exist_ok=True)
    store = SCRATCH / "nccl_store"
    store.unlink(missing_ok=True)
    data = di_long(DIST_T, device)
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        ts = solve_timesharded(*data, options=dist_options(DIST_ITERATIONS),
                               mesh=make_mesh(axis="sp"), device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    par = solve_batch(*data, options=dist_options(
        DIST_ITERATIONS, backward_mode="parallel"), device=device)
    seq = solve_batch(*data, options=dist_options(DIST_ITERATIONS),
                      device=device)
    close = lambda a, b: bool(torch.allclose(a, b, rtol=1e-6, atol=1e-8))
    fields = dict(T=DIST_T, iterations=DIST_ITERATIONS,
                  timeshard_seconds=wall,
                  equal_to_parallel=bool(torch.equal(ts.x, par.x)
                                         and torch.equal(ts.u, par.u)),
                  close_to_scan=close(ts.x, seq.x) and close(ts.u, seq.u),
                  max_abs_diff_to_scan=float(max((ts.x - seq.x).abs().max(),
                                                 (ts.u - seq.u).abs().max())))
    return fields, par


def dist_rank(rank, world, work, device="cuda"):
    """One rank of the two-rank run on the card (spawned): a gloo group
    through a `FileStore` file in `work`, the long double integrator with
    its value scan sharded over time, then SHARD_LANES lanes a rank of the
    batch in `work/lanes.npz` through `solve_sharded` and `solve_global`
    (each rank generating only its own lanes); writes `rank<r>.npz`."""
    import numpy as np
    from ipddp2tpu_torch.parallel import make_mesh, solve_sharded
    from ipddp2tpu_torch.parallel.multihost import (initialize_distributed,
                                                    solve_global)
    from ipddp2tpu_torch.parallel.timeshard import solve_timesharded
    work = Path(work)
    dev = torch.device(device)
    initialize_distributed(init_method=f"file://{work / 'store'}",
                           world_size=world, rank=rank, backend="gloo",
                           device=dev)
    out, generated = {}, []
    try:
        ts = solve_timesharded(*di_long(DIST_T, dev),
                               options=dist_options(DIST_ITERATIONS),
                               mesh=make_mesh(axis="sp"), device=dev)
        out.update(ts_x=ts.x, ts_u=ts.u)
        lanes = {k: torch.as_tensor(v) for k, v in
                 np.load(work / "lanes.npz").items()}
        batch = concar_lanes(lanes, dev)

        def gen(i):
            generated.append(i)
            th, b, x, u = concar_lanes({k: v[i:i + 1]
                                        for k, v in lanes.items()}, dev)
            return (Bounds(b.lower[0], b.upper[0]), x[0], u[0],
                    concar.Theta(th.obstacles[0]))

        opts = dist_options(SHARD_ITERATIONS)
        for tag, (sol, stats) in (
                ("sh", solve_sharded(concar.problem(), *batch[1:],
                                     theta=batch[0], options=opts,
                                     device=dev)),
                ("gl", solve_global(concar.problem(), gen,
                                    batch[2].shape[0], options=opts,
                                    device=dev))):
            for f in ("x", "u", "iterations", "status", "converged"):
                out[f"{tag}_{f}"] = getattr(sol, f)
            out[f"{tag}_stats"] = torch.stack(
                [torch.as_tensor(v, dtype=torch.float64).cpu()
                 for v in stats])
        out["generated"] = torch.tensor(generated)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(work / f"rank{rank}.npz",
             **{k: v.cpu().numpy() for k, v in out.items()})


def concar_lanes(lanes, device):
    """(theta, bounds, x1, u0) of concar instances given as tensors
    obstacles [n, 4, 3], f_lim [n], tau_lim [n], x1 [n, 4]."""
    n = lanes["x1"].shape[0]
    return (concar.Theta(lanes["obstacles"].to(device)),
            concar.bounds(lanes["f_lim"], lanes["tau_lim"], device=device),
            lanes["x1"].to(device),
            concar.initial_controls(device=device).expand(n, concar.T,
                                                          concar.NU))


def two_ranks_gloo(par, bounds, x1, theta, device):
    """Two ranks sharing the card over gloo (`dist_rank`, spawned): the
    time-sharded solve at D = 2 against the parallel one `par`, the sharded
    and globally generated solves of 2 x SHARD_LANES lanes of the main
    batch against `solve_batch` on the same lanes and against `batch_stats`
    of the union (the median as the mean of the shards' medians). Returns
    the fields and whether every gate holds."""
    import numpy as np
    work = SCRATCH / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n = DIST_WORLD * SHARD_LANES
    np.savez(work / "lanes.npz", obstacles=theta.obstacles[:n].cpu().numpy(),
             f_lim=bounds.upper[:n, 0, 0].cpu().numpy(),
             tau_lim=bounds.upper[:n, 0, 1].cpu().numpy(),
             x1=x1[:n].cpu().numpy())
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dist_rank,
                         args=(r, DIST_WORLD, str(work), str(device)))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    assert codes == [0] * DIST_WORLD, f"parallel_dist ranks: exit {codes}"
    outs = [{k: torch.as_tensor(v) for k, v in
             np.load(work / f"rank{r}.npz").items()}
            for r in range(DIST_WORLD)]
    th, b, x, u = concar_lanes({k: torch.as_tensor(v) for k, v in
                                np.load(work / "lanes.npz").items()}, device)
    ref = solve_batch(concar.problem(), b, x, u, theta=th,
                      options=dist_options(SHARD_ITERATIONS), device=device)
    union = batch_stats(ref)
    medians = [float(ref.iterations[r * SHARD_LANES:(r + 1) * SHARD_LANES]
                     .to(torch.float64).quantile(0.5))
               for r in range(DIST_WORLD)]
    expect = torch.tensor([float(v) for v in union], dtype=torch.float64)
    expect[4] = sum(medians) / DIST_WORLD
    close = lambda a, b_, rtol, atol: bool(torch.allclose(
        a.to(b_.device), b_, rtol=rtol, atol=atol))
    fields = dict(ranks=DIST_WORLD, backend="gloo", seconds_with_start=wall)
    ok = True
    for r, o in enumerate(outs):
        rows = slice(r * SHARD_LANES, (r + 1) * SHARD_LANES)
        shard = dict(
            timeshard_close_to_parallel=close(o["ts_x"], par.x, 1e-8, 1e-10)
            and close(o["ts_u"], par.u, 1e-8, 1e-10),
            timeshard_max_abs_diff=float(max(
                (o["ts_x"].to(device) - par.x).abs().max(),
                (o["ts_u"].to(device) - par.u).abs().max())),
            sharded_equal_bits=bool(
                torch.equal(o["sh_x"].to(device), ref.x[rows])
                and torch.equal(o["sh_u"].to(device), ref.u[rows])),
            sharded_close=close(o["sh_x"], ref.x[rows], 1e-8, 1e-8)
            and close(o["sh_u"], ref.u[rows], 1e-8, 1e-8),
            counters_equal=bool(
                torch.equal(o["sh_iterations"].to(device),
                            ref.iterations[rows])
                and torch.equal(o["sh_status"].to(device),
                                ref.status[rows])),
            stats=o["sh_stats"].tolist(),
            stats_as_union=close(o["sh_stats"], expect, 1e-8, 0.0),
            global_equal_to_sharded=all(
                torch.equal(o[f"gl_{f}"], o[f"sh_{f}"]) for f in
                ("x", "u", "iterations", "status", "converged", "stats")),
            generated=[int(o["generated"].min()), int(o["generated"].max()),
                       int(o["generated"].numel())])
        shard["generated_only_its_own"] = shard["generated"] == [
            rows.start, rows.stop - 1, SHARD_LANES]
        ok = ok and all(shard[k] for k in (
            "timeshard_close_to_parallel", "sharded_close", "counters_equal",
            "stats_as_union", "global_equal_to_sharded",
            "generated_only_its_own"))
        fields[f"rank{r}"] = shard
    fields["union_stats"] = expect.tolist()
    return fields, ok


def bk_sweep_flops(T, nx, nu, nc):
    """Floating-point operations of one instance's Bunch-Kaufman sweep (a
    multiply-add counts two): the eliminations of the trailing matrix
    (1x1 and 2x2 pivots cost the same to first order), substitution for
    nx + 1 right-hand sides without refinement, assembly, gains and value
    recursion as `sweep_flops`."""
    m, nk = nu + nc, nx + 1
    tri = sum(m - 1 - j for j in range(m))
    factor = sum(2 * (m - 1 - j) ** 2 + (m - 1 - j) for j in range(m))
    solve = nk * (4 * tri + m)
    assemble = (2 * nx * nx * (nu + nx) + 2 * nx * nx * (nx + nu)
                + 2 * nu * nu * nx + 2 * nu * (nx + nc) + 8 * nu)
    value = 2 * m * nx * (nx + 1) + 2 * nx * (nx + nc) + 2 * m
    gains = 6 * nu + 2 * nu * nx
    return T * (factor + solve + assemble + value + gains)


def check_bk(name, args, dims, atol, time_reps):
    """The Bunch-Kaufman instantiation against `sweep_plain(inertia="bk")`
    on the same inputs: the fail and singular flags (the stage decisions:
    n_pos == nu, info) equal on every lane, the gains on the lanes that pass
    within BK_TOL. Returns the measured fields."""
    dtype = args[18].dtype
    kw = dict(dims, refine=1, rtol=1e-6, inertia="bk", atol=atol)
    gk, dLk, fk, sk = backward_sweep_cuda(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    gp, dLp, fp, sp = sweep_plain(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)    # one call: some 10^5 launches
    differing = int((fk != fp).sum()), int((sk != sp).sum())
    assert differing == (0, 0), \
        f"{name}: fail / singular flags differ on {differing} lanes"
    ok = ~fp
    assert int(ok.sum()) > 0 and int(fp.sum()) > 0, \
        f"{name}: need passing and failing lanes ({int(ok.sum())} pass)"
    max_abs, per_k = 0.0, {}
    for gname, a, b in list(zip(GAIN_NAMES, gk, gp)) + [("dL", dLk, dLp)]:
        if b[ok].numel() == 0:
            continue
        err, per_k[gname] = rel_err(a, b, ok)
        max_abs = max(max_abs, err)
    max_rel = max(per_k.values())
    assert max_rel <= BK_TOL[dtype], \
        f"{name}: max relative error {max_rel} > {BK_TOL[dtype]}: {per_k}"
    fields = dict(max_abs_err=max_abs, max_rel_err=max_rel, rel_err=per_k,
                  lanes=int(fp.numel()), lanes_failing=int(fp.sum()),
                  lanes_singular=int(sp.sum()))
    if time_reps:
        kernel = lambda: backward_sweep_cuda(*args, **kw)
        fields["ms"] = graph_ms(kernel, time_reps)
        fields["ms_eager"] = cuda_ms(kernel, time_reps)
        fields["plain_ms"] = plain_ms
        nbytes = sum(a.numel() * a.element_size() for a in args)
        nbytes += sum(g.numel() * g.element_size() for g in gk)
        nbytes += dLk.numel() * dLk.element_size() + 2 * fk.numel()
        B, T = args[11].shape[0], args[11].shape[1]
        fields.update(kernel_bound(nbytes, B * bk_sweep_flops(
            T, dims["nx"], dims["nu"], dims["nc"]), dtype))
    return fields


def check_crafted_bk(name, dims, dtype, device, atol):
    """The crafted lanes of both kinds through the Bunch-Kaufman kernel
    (`crafted_inputs`: ties, a NaN diagonal, exact zero pivots;
    `crafted_bk_inputs`: a rook chain of several trips, a tie in the column
    search), eight lanes in one ragged batch: flags equal to the plain
    version's on every lane, gains within BK_TOL on the passing lanes, and
    the two Bunch-Kaufman lanes passing."""
    args = [torch.cat([a, b]) for a, b in zip(
        crafted_inputs(dims["nx"], dims["nu"], dims["nc"], dtype, device),
        crafted_bk_inputs(dims["nx"], dims["nu"], dims["nc"], dtype,
                          device))]
    fields = check_bk(name, args, dims, atol, 0)
    _, _, fail, sing = backward_sweep_cuda(
        *args, **dims, refine=1, rtol=1e-6, inertia="bk", atol=atol)
    assert not fail[len(CRAFTED_LANES):].any(), \
        f"{name}: a Bunch-Kaufman lane failed: {fail.tolist()}"
    return dict(lanes=list(CRAFTED_LANES + CRAFTED_BK_LANES),
                fail=fail.tolist(), singular=sing.tolist(),
                max_rel_err=fields["max_rel_err"],
                max_abs_err=fields["max_abs_err"])


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


# ---- the facade and the serving pools -----------------------------------
SCRATCH = Path(__file__).resolve().parent / "_smoke_scratch"
ROW = re.compile(r"^\s+\d+\s+[\d.e+-]+\s")
SERVE_BATCH, SERVE_SLOTS, SERVE_CHUNK = 512, 256, 40
SWEEP_EVENT = "backward_sweep"      # in the names of the sweep's kernels
# iterations of the facade's solve that run inside `profiling.trace`: the
# whole solve's trace holds every operator of 99 iterations (1.41 GB, and
# 307 s for the phase on an NVIDIA H100 80GB HBM3 at 700 W); a few
# iterations launch the sweep too
TRACE_ITERATIONS = 2
CHECKPOINT_AT = 40                  # the facade's checkpoint iteration


def facade_concar(device):
    """concar's seed-1 instance built through the reference-style facade
    from per-stage (x, u) closures over the instance, at its published
    widths (nx=4, nu=10, nc=4, T=100), float64, default options."""
    th, f_lim, tau_lim, x1 = concar.seed1_instance(device=device)
    nx, nu, nc, T = concar.NX, concar.NU, concar.NC, concar.T
    dyn = Dynamics(lambda x, u: concar.dynamics(x, u, 0, None), nx, nu)
    stage = Objective(lambda x, u: concar.stage_cost(x, u, 0, None), nx, nu)
    term = Objective(lambda x, u: concar.terminal_cost(x, None), nx, 0)
    con = Constraint(lambda x, u: concar.constraints(x, u, 0, th), nx, nu,
                     num_constraint=nc)
    slack = 2 * concar.NUM_OBSTACLES
    bound = Bound([-f_lim, -tau_lim] + [0.0] * slack,
                  [f_lim, tau_lim] + [math.inf] * slack)
    solver = Solver([dyn] * T, [stage] * T + [term],
                    [con] * T + [Constraint(nx, 0)], [bound] * T + [Bound(0)],
                    options=Options(optimality_tolerance=1e-7),
                    device=device)
    return solver, x1, concar.initial_controls(device=device)


def facade_gate(sol):
    """tests/test_benchmarks.py:_check on the facade's single instance."""
    it = int(sol.iterations)
    g_it = concar.SEED1_GOLDEN_ITERATIONS
    assert bool(sol.converged), f"facade: status {int(sol.status)}"
    assert math.isclose(float(sol.objective), concar.SEED1_GOLDEN_OBJECTIVE,
                        rel_tol=1e-6), float(sol.objective)
    assert abs(it - g_it) <= max(3, int(0.1 * g_it) + 1), it


def facade_phase(device):
    """The facade's solve: plain (golden gate, K2 launched, the plain
    rollout only), its first TRACE_ITERATIONS iterations inside
    `profiling.trace` (the trace must name the sweep kernel), verbose with
    stdout captured (the table's rows counted),
    and as a checkpointed run: `save_state` at iteration CHECKPOINT_AT,
    `load_state`,
    `run` to the end, equal bit for bit to the uninterrupted run."""
    solver, x1, u0 = facade_concar(device)
    reset_counts()
    sol = solver.solve(x1, u0)
    counts = read_counts()
    facade_gate(sol)
    assert counts["backward_sweep_f64"] > 0, "the facade missed K2"
    assert counts["forward_metrics_f64"] == counts["forward_trial_f64"] == 0
    fields = dict(iterations=int(sol.iterations),
                  objective=float(sol.objective),
                  converged=bool(sol.converged), seconds=solver.wall_time,
                  launches={k: v for k, v in counts.items() if v})

    SCRATCH.mkdir(exist_ok=True)
    trace_dir = SCRATCH / "facade_trace"
    plain_options = solver.options
    solver.options = dataclasses.replace(plain_options,
                                         max_iterations=TRACE_ITERATIONS)
    t0 = time.perf_counter()
    with profiling.trace(str(trace_dir)) as prof:
        solver.solve(x1, u0)
    traced = time.perf_counter() - t0
    solver.options = plain_options
    events = [e for e in prof.key_averages() if SWEEP_EVENT in e.key]
    text = (trace_dir / "trace.json").read_text()
    device_us = sum(getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
                    for e in events)
    fields["trace"] = dict(
        iterations=TRACE_ITERATIONS, seconds=traced, trace_bytes=len(text),
        sweep_events=sorted({e.key for e in events}),
        sweep_calls=sum(e.count for e in events),
        sweep_device_ms=device_us / 1e3,
        kernel_named_in_trace_file=SWEEP_EVENT in text)
    assert events and SWEEP_EVENT in text, \
        "the trace does not name the sweep kernel"

    out = io.StringIO()
    solver.options = dataclasses.replace(plain_options, verbose=True)
    with contextlib.redirect_stdout(out):
        sol_v = solver.solve(x1, u0)
    solver.options = plain_options
    lines = out.getvalue().splitlines()
    rows = [line for line in lines if ROW.match(line)]
    fields["verbose"] = dict(
        rows=len(rows), lines=len(lines), seconds=solver.wall_time,
        exit_message="Optimal solution found" in out.getvalue(),
        same_result=bool(sol_v.objective == sol.objective
                         and sol_v.iterations == sol.iterations))
    assert len(rows) >= int(sol.iterations) // 10 and \
        fields["verbose"]["exit_message"], "verbose: table or message missing"

    problem, options = solver.problem, solver.options
    bounds = Bounds(*(b.to(device) for b in solver.bounds))
    s0 = initialize(problem, None, bounds, x1[None], u0[None], options,
                    device=device)
    whole = run(problem, bounds, s0, None, options, device=device)
    part = run(problem, bounds, s0, None, options, k_limit=CHECKPOINT_AT,
               device=device)
    path = SCRATCH / "facade_k40.npz"
    save_state(str(path), part)
    back = load_state(str(path), device=device)
    round_trip = all(a.dtype == b.dtype and torch.equal(a, b)
                     for a, b in zip(back, part))
    back = back._replace(status=torch.zeros_like(back.status))
    resumed = run(problem, bounds, back, None, options, device=device)
    same = [f for f, a, b in zip(SolverState._fields, resumed, whole)
            if not torch.equal(a, b)]
    fields["checkpoint"] = dict(
        at_iteration=int(part.k[0]), bytes=path.stat().st_size,
        round_trip_bit_for_bit=round_trip,
        resumed_iterations=int(resumed.k[0]),
        fields_differing_from_uninterrupted=same)
    shutil.rmtree(SCRATCH)
    assert int(part.k[0]) == CHECKPOINT_AT and round_trip and not same, \
        f"checkpoint: {fields['checkpoint']}"
    return fields


def pool_fields(sol, wall, counts, chunks=None, occupancy=None):
    solved = int(sol.converged.sum())
    iters = sol.iterations.to(torch.float64)
    fields = dict(solved=solved, seconds=wall,
                  instances_per_second=solved / wall,
                  median_iterations=float(iters.median()),
                  max_iterations=int(iters.max()),
                  launches={k: v for k, v in counts.items() if v})
    if chunks is not None:
        fields.update(chunks=chunks, occupancy=occupancy)
    return fields


def against_lockstep(sol, lock):
    """Per instance against the lockstep solve of the same batch: status,
    objective where both converged, iterations."""
    status, objective, iterations, converged = (
        getattr(sol, f).to(lock.status.device)
        for f in ("status", "objective", "iterations", "converged"))
    both = converged & lock.converged
    rel = ((objective - lock.objective).abs()
           / lock.objective.abs().clamp(min=1e-300))[both]
    d_it = (iterations - lock.iterations)
    return dict(
        same_status=int((status == lock.status).sum()),
        both_converged=int(both.sum()),
        max_rel_objective_diff=float(rel.max()) if rel.numel() else 0.0,
        same_iterations=int((d_it == 0).sum()),
        iteration_diff_max_abs=int(d_it.abs().max()),
        iteration_diff_sum=int(d_it.sum()),
        bitwise_equal_objectives=int((objective == lock.objective).sum()))


def serve_phase(prob, bounds, x1, u0, theta, K, device=None):
    """`solve_pool`, `solve_pool_resident` and a lockstep `solve_batch` of
    the same first SERVE_BATCH instances of the main batch, in that order:
    float64 to 1e-7 with the hybrid search, SERVE_SLOTS slots, chunks of
    SERVE_CHUNK iterations. Each instance's status as the lockstep solve's
    on >= 99 % of them, objectives within 1e-6 where both converged (the
    caller's gate)."""
    n, slots, chunk = SERVE_BATCH, SERVE_SLOTS, SERVE_CHUNK
    args = (prob, Bounds(bounds.lower[:n], bounds.upper[:n]), x1[:n], u0[:n])
    th = concar.Theta(theta.obstacles[:n])
    opts = Options(optimality_tolerance=1e-7, max_iterations=1000,
                   ls_speculative=K, ls_spec_continue=True)
    runs = {}
    for name, fn in (("solve_pool", solve_pool),
                     ("solve_pool_resident", solve_pool_resident)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, theta=th, options=opts, slots=slots, chunk=chunk,
                 device=device)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t0, read_counts())
    lock, wall, counts = timed_solve(*args, theta=th, options=opts,
                                     device=device)
    fields = dict(batch=n, slots=slots, chunk=chunk, K=K,
                  lockstep=pool_fields(lock, wall, counts))
    for name, (res, wall_p, counts_p) in runs.items():
        f = pool_fields(res.solutions, wall_p, counts_p, res.chunks,
                        res.occupancy)
        f["against_lockstep"] = against_lockstep(res.solutions, lock)
        fields[name] = f
    return fields, {name: r[2] for name, r in runs.items()}


def parent_geometry(parent_dir, nx, nu, nc, inertia):
    """The instances per block that another checkout's wrapper computes for
    these dimensions (its own rule, asked in a process of its own, where
    its package is the one imported)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from ipddp2tpu_torch.ops.backward_cuda import launch_geometry; "
            "print(launch_geometry(*map(int, sys.argv[2:5]), "
            "**({'inertia': 'bk'} if sys.argv[5] == 'bk' else {}))"
            ".instances_per_block)")
    out = subprocess.run(
        [sys.executable, "-c", code, str(Path(parent_dir).resolve()),
         str(nx), str(nu), str(nc), inertia], capture_output=True,
        text=True, check=True, cwd=str(Path(parent_dir).resolve()))
    return int(out.stdout.strip().splitlines()[-1])


def _differences(pairs, lanes):
    """Over the `lanes` of each (a, b) pair: the largest |a - b| where both
    are finite, and the entries where one is finite and the other not or
    both are infinite and differ."""
    max_abs, odd = 0.0, 0
    for a_, b_ in pairs:
        a_, b_ = a_[lanes], b_[lanes]
        fin = torch.isfinite(a_) & torch.isfinite(b_)
        if bool(fin.any()):
            max_abs = max(max_abs, float((a_ - b_)[fin].abs().max()))
        odd += int((~fin & ~((a_ == b_) | (a_.isnan() & b_.isnan())))
                   .sum())
    return dict(max_abs_diff=max_abs, entries_finiteness_or_inf_differ=odd)


def parent_sweep(parent_dir, inertia, dims, inputs, reps):
    """The sweep of `inertia` ("ldl" or "bk") built from the parent
    checkout's `backward_sweep.cu` with its own geometry, and this tree's,
    on the same inputs (`inputs`: the sweep's arguments by type): the
    flags equal on every lane (asserted), the largest difference of the
    gains and dL on the lanes that pass in both and on all lanes, and
    their times in turns parent, change, change, parent (graph replay)."""
    nx, nu, nc = dims["nx"], dims["nu"], dims["nc"]
    ipb = parent_geometry(parent_dir, nx, nu, nc, inertia)
    src = Path(parent_dir) / "ipddp2tpu_torch/ops/csrc/backward_sweep.cu"
    solve = "bk_" if inertia == "bk" else ""
    path = build.finish(build.start(
        f"backward_sweep_parent_{solve}nx{nx}_nu{nu}_nc{nc}", src,
        defines=(f"NX={nx}", f"NU={nu}", f"NC={nc}", f"IPB={ipb}",
                 *(("SWEEP_BK=1",) if inertia == "bk" else ())),
        depends=tuple(sorted(src.parent.glob("*.cuh")))))
    key = (nx, nu, nc, inertia)
    libs = {"parent": backward_cuda.bind(path, nx, nu, nc, inertia,
                                         check=False),
            "change": backward_cuda._library(nx, nu, nc, inertia)}
    kw = dict(dims, rtol=Options().kkt_residual_rtol, inertia=inertia,
              atol=Options().inertia_atol)
    diff = {}
    for dtype, args in inputs.items():
        outs = {}
        for which, lib in libs.items():
            backward_cuda._libs[key] = lib
            outs[which] = backward_sweep_cuda(*args, **kw)
        torch.cuda.synchronize()
        (gp, dLp, fp, sp), (gc, dLc, fc, sc) = outs["parent"], outs["change"]
        flags = [int((fp != fc).sum()), int((sp != sc).sum())]
        assert flags == [0, 0], \
            f"{inertia} sweep against its parent: flags differ on {flags}"
        pairs = list(zip(list(gp) + [dLp], list(gc) + [dLc]))
        diff[str(dtype)] = dict(
            lanes=int(fp.numel()), lanes_failing=int(fp.sum()),
            flags_differ=flags,
            passing=_differences(pairs, ~fp & ~fc),
            all_lanes=_differences(pairs, torch.ones_like(fp)))
    turns = []
    for which in ("parent", "change", "change", "parent"):
        backward_cuda._libs[key] = libs[which]
        turns.append(dict(which=which, ms={
            str(dtype): graph_ms(lambda: backward_sweep_cuda(*args, **kw),
                                 reps)
            for dtype, args in inputs.items()}))
    backward_cuda._libs[key] = libs["change"]
    return dict(parent_instances_per_block=ipb,
                threads_per_instance=launch_geometry(nx, nu, nc,
                                                     inertia).lanes,
                parent_vs_change=diff, turns=turns)


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
    ap.add_argument("--lane-independence", action="store_true",
                    help="after the build, only pushing's campaign batch "
                         "against its rows 7, 55, 64, 88 alone and the "
                         "first of them alone, stepped an iteration at a "
                         "time and compared bit for bit after each phase "
                         "(no result line)")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of the parent commit (its package): "
                         "hold its sweep kernels and its dynamics-chain "
                         "probe against this tree's and time them in "
                         "turns, and its forward-metrics kernel with the "
                         "hybrid solve")
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
    more = {name: mod.problem() for name, mod in CAMPAIGN}
    dims_of = lambda p: dict(nx=p.nx, nu=p.nu, nc=p.nc)
    dims_ldl = [dims_of(more[n]) for n in ("quadrotor", "cartpole_swingup",
                                           "cartpole")]
    dims_bk = {n: dims_of(more[n]) for n in CONTACT}
    t0 = time.perf_counter()
    started_builds = (
        [backward_cuda.start_build(*d.values(), verbose=True)
         for d in (dims_c, dims_d, dims_t, *dims_ldl)]
        + [backward_cuda.start_build(*d.values(), verbose=True,
                                     inertia="bk")
           for d in (*dims_bk.values(), dims_c)]
        + [forward_cuda.start_build(p, verbose=True)
           for p in (prob, di, tiny, *more.values())]
        + [probe_chain.start_build(verbose=True)])
    logs = {}
    libs = build.finish_all(started_builds, verbose=True, logs=logs)
    if a.ptxas:
        print("\n".join(logs.values()), flush=True)
    geometry = {}
    for inertia, dims in (("ldl", (dims_c, dims_d, dims_t, *dims_ldl)),
                          ("bk", (*dims_bk.values(), dims_c))):
        for d in dims:
            geo = launch_geometry(**d, inertia=inertia)
            key = "{}nx{nx}_nu{nu}_nc{nc}".format(
                "bk_" if inertia == "bk" else "", **d)
            geometry[key] = dict(
                lanes_per_instance=geo.lanes,
                instances_per_block=geo.instances_per_block,
                threads_per_block=geo.threads,
                smem_bytes_per_block={str(k): v
                                      for k, v in geo.smem_bytes.items()})
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs],
         ptxas={name: build.ptxas_report(log) for name, log in logs.items()},
         sweep_geometry=geometry)
    if a.lane_independence:
        emit("lane_independence", **lane_independence(dev))
        print("chip_smoke: --lane-independence, stopping after it",
              file=sys.stderr)
        return 10

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
    # a mid-solve state (non-uniform duals), 10 iterations through the sweep
    # kernel: only an input of the checks below, which hold every kernel
    # against its plain version on it
    mid = initialize(prob, theta, bounds, x1, u0, opts64)
    for _ in range(10):
        mid = iteration(prob, bounds, mid, theta, opts64)
    torch.cuda.synchronize()
    emit("mid_state", iterations=10, seconds=time.perf_counter() - t0)

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
    sweep_main = {}             # the sweep's concar inputs, by type
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
        sweep_main[dtype] = args
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
        grid = min(GRID_BATCH, a.batch)
        emit("metrics_grid", name=kname, dtype=str(dtype),
             max_rel_err={label: metrics_grid(
                 f"{kname}/{label}", lanes_of(fa, grid), dtype, grid)
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

    # ---- kernels on the campaign's models (B = 100, T = 100) -------------
    # mid-solve states of the six models on the campaign's instances
    t0 = time.perf_counter()
    mids = {}
    for name, mod in CAMPAIGN:
        th_m, b_m, x_m, u_m = mod.from_params(
            convert.params_rows(mod.PARAMS), torch.float64, dev)
        mids[name] = (th_m, b_m, mid_state(more[name], th_m, b_m, x_m, u_m,
                                           10))
    torch.cuda.synchronize()
    emit("mid_state", models=list(mids), batch=CAMPAIGN_SEEDS,
         iterations=10, seconds=time.perf_counter() - t0)
    atol = opts64.inertia_atol
    bk_fields = {}
    sweep_models = {}           # (inertia, model, dtype): the inputs above
    for dtype in (torch.float64, torch.float32):
        kname = f"backward_sweep_bk_{sfx[dtype]}"
        per_model, crafted_bk = {}, {}
        for name in CONTACT:
            th_m, _, s_m = mids[name]
            args = model_inputs(more[name], th_m, s_m, dtype)
            sweep_models[("bk", name, dtype)] = args
            per_model[name] = check_bk(f"{kname}/{name}", args,
                                       dims_bk[name], atol, 10)
            crafted_bk[name] = check_crafted_bk(f"{kname}/crafted/{name}",
                                                dims_bk[name], dtype, dev,
                                                atol)
        bk_fields[dtype] = per_model
        emit("kernels", name=kname, dtype=str(dtype), batch=CAMPAIGN_SEEDS,
             T=100, crafted=crafted_bk, **per_model)
        add_kernel(kname, "ipddp2tpu_torch/ops/csrc/backward_sweep_bk.cuh",
                   "ipddp2tpu/backward.py:219 (XLA scan branch, no Pallas "
                   "kernel)", per_model["acrobot"], per_model["cartpole"],
                   per_model["pushing"], *crafted_bk.values())
    # the bk sweep at concar's m = 14, the shape of the `bk` lever of
    # `residue_levers`: mid-solve states of the 24 residue instances and
    # the crafted lanes at concar's dimensions, against the plain version
    t0 = time.perf_counter()
    mid_r = residue_mid_state(prob, dev)
    for dtype in (torch.float64, torch.float32):
        kname = f"backward_sweep_bk_{sfx[dtype]}"
        args = model_inputs(prob, *mid_r, dtype)
        f = check_bk(f"{kname}/concar_m14", args, dims_c, atol, 10)
        f["crafted"] = check_crafted_bk(f"{kname}/crafted/concar", dims_c,
                                        dtype, dev, atol)
        emit("kernels", name=kname, dtype=str(dtype), model="concar", m=14,
             batch=args[11].shape[0], T=prob.T,
             mid_state_seconds=time.perf_counter() - t0, **f)
        row = by_name[kname]
        row["concar_m14"] = {k: f[k] for k in (
            "ms", "ms_eager", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "max_rel_err")}
        row["max_abs_err"] = max(row["max_abs_err"], f["max_abs_err"],
                                 f["crafted"]["max_abs_err"])
        row["max_rel_err"] = max(row["max_rel_err"], f["max_rel_err"],
                                 f["crafted"]["max_rel_err"])
    # the LDL^T instantiations of the smooth models' dimensions
    ldl_models = {}
    for dtype in (torch.float64, torch.float32):
        for name in ("concar_quad", "quadrotor", "cartpole_swingup"):
            th_m, _, s_m = mids[name]
            args = model_inputs(more[name], th_m, s_m, dtype)
            ldl_models[f"{name}/{sfx[dtype]}"] = check_kernel(
                f"backward_sweep_{sfx[dtype]}/{name}", args,
                dict(dims_of(more[name]), refine=refine), rtol, 0,
                need_both=False)["max_rel_err"]
    # the LDL^T sweep at cartpole's m = 35 (a warp an instance): flags equal
    # on every lane, timed; a quarter of the lanes regularized well into
    # the right inertia, so that passing lanes are compared too
    cartpole_ldl = {}
    dims_cp = dict(dims_of(more["cartpole"]), refine=refine)
    for dtype in (torch.float64, torch.float32):
        th_m, _, s_m = mids["cartpole"]
        args = model_inputs(more["cartpole"], th_m, s_m, dtype,
                            regularize=True)
        sweep_models[("ldl", "cartpole", dtype)] = args
        kname = f"backward_sweep_{sfx[dtype]}"
        f = check_kernel(f"{kname}/cartpole_ldl", args, dims_cp, rtol, 10,
                         every_lane=True)
        f["crafted"] = check_crafted(f"{kname}/cartpole_ldl/crafted",
                                     dims_cp, dtype, dev, rtol)
        f["geometry"] = launch_geometry(**dims_of(more["cartpole"]))._asdict()
        f["geometry"]["smem_bytes"] = {
            str(k): v for k, v in f["geometry"]["smem_bytes"].items()}
        cartpole_ldl[sfx[dtype]] = f
        row = by_name[kname]
        row["cartpole_ldl"] = {k: f[k] for k in (
            "ms", "ms_eager", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "max_rel_err")}
        row["max_abs_err"] = max(row["max_abs_err"], f["max_abs_err"],
                                 f["crafted"]["max_abs_err"])
        row["max_rel_err"] = max(row["max_rel_err"], f["max_rel_err"],
                                 f["crafted"]["max_rel_err"])
    emit("kernels_by_model", name="backward_sweep (ldl)",
         max_rel_err=ldl_models, cartpole_ldl=cartpole_ldl)
    # K3 / K4 with each new model's device functions, float64, K = 8
    fwd_models = {}
    for name, mod in CAMPAIGN:
        th_m, b_m, s_m = mids[name]
        deriv = evaluate_derivatives(more[name], th_m, s_m.x, s_m.u, s_m.phi)
        gains = backward_pass(
            more[name], deriv, (relax_constraints(more[name], s_m.c_raw,
                                                  s_m.mu),
                                s_m.il, s_m.iu, s_m.phi, s_m.zl, s_m.zu),
            s_m.mu, s_m.reg_last,
            resolve_options(Options(optimality_tolerance=1e-7),
                            more[name])).gains
        fa = perturb_forward(forward_args(more[name], th_m, b_m, s_m, gains,
                                          plain))
        # outside the boundary the swing-up's closed loop diverges, and one
        # rounding grows to O(1) over 100 stages (1.85 relative in x on the
        # H100): those candidates are reported there, their flags held
        m_f, t_f, bad = check_forward(
            f"forward/f64/{name}", fa, K, torch.float64, 10,
            need_both_flags=False, hold_outside=name != "cartpole_swingup")
        assert not bad, "\n".join(bad)
        fwd_models[name] = dict(metrics=m_f, trial=t_f)
    emit("forward_by_model", dtype=str(torch.float64), K=K,
         batch=CAMPAIGN_SEEDS, T=100, **fwd_models)

    # ---- probes ----------------------------------------------------------
    probe_rows = (("mul_chain", "scripts/tpu_dd_probe.py:49"),
                  ("dynamics_chain", "scripts/tpu_dd_probe.py:98"))
    probe_lib = next(p for p in libs if p.name.startswith("probe_chain_"))
    probe_ptxas = {k: v for k, v in build.ptxas_report(
        logs.get(probe_lib.name, "")).items()
        if k.startswith("dynamics_chain")}
    step_f64 = step_instructions(probe_lib, "_Z21dynamics_chain_kernelId")
    parent_lib = parent_probe_library(a.parent) if a.parent else None
    for dtype in (torch.float32, torch.float64):
        fields, counts, inputs = check_probes(dtype, dev, a.batch, prob.T,
                                              a.seed + 3, sm_mhz)
        by_steps, us = probe_steps(dtype, inputs, sm_mhz, a.seed + 3)
        for pname in by_steps:
            fields[pname]["by_steps"] = by_steps[pname]
        dyn = fields["dynamics_chain"]
        if dtype == torch.float64:
            dyn["step_sass"] = step_f64
            dyn["issue_floor_ms"] = None if step_f64 is None else (
                step_f64["f64_instructions"]
                * FP64_CLOCKS_PER_WARP_INSTRUCTION * prob.T / (sm_mhz * 1e3))
        if parent_lib is not None:
            dyn["parent"] = parent_probe(parent_lib, inputs[1], us, sm_mhz)
        del us
        emit("probes", dtype=str(dtype), batch=a.batch, steps=prob.T,
             launches=counts, ptxas=probe_ptxas, **fields)
        for pname, replaces in probe_rows:
            kname = f"{pname}_{sfx[dtype]}"
            add_kernel(kname, "ipddp2tpu_torch/ops/csrc/probe_chain.cu",
                       replaces, fields[pname])
            assert counts[kname] > 0, f"probe run missed {kname}"
            by_name[kname]["launches"] = counts[kname]
            by_name[kname]["launches_by_path"] = {"probes": counts[kname]}
    # ---- the sweeps of the parent commit against this tree, in turns ----
    if a.parent:
        emit("sweep_parent_and_change", parent=a.parent, batch=a.batch,
             T=prob.T, **parent_sweep(a.parent, "ldl",
                                      dict(dims_c, refine=refine),
                                      sweep_main, 10))
        for inertia, name in dict.fromkeys((i, n) for i, n, _ in
                                           sweep_models):
            emit("sweep_parent_and_change", parent=a.parent, inertia=inertia,
                 model=name, batch=CAMPAIGN_SEEDS, T=100,
                 **parent_sweep(a.parent, inertia,
                                dict(dims_of(more[name]), refine=refine),
                                {dt: sweep_models[(inertia, name, dt)]
                                 for dt in (torch.float64, torch.float32)},
                                10))
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
                    dual_inf=float(sol.dual_inf[0]), **lane0_split(info)))
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

    # ---- parallel: the parallel backward pass against the sweep -----
    t0 = time.perf_counter()
    lanes_p = slice(0, PARALLEL_BATCH)
    against = {}
    for dtype in (torch.float64, torch.float32):
        against[sfx[dtype]] = parallel_against_sweep(
            prob, concar.Theta(theta.obstacles[lanes_p].to(dtype)),
            cast_tree(tree_lanes(mid, lanes_p), dtype),
            Options(optimality_tolerance=1e-7, backward_kernel="cuda"))
    turns = backward_turns(prob, theta, mid, PARALLEL_SIZES)
    emit("parallel", batch=PARALLEL_BATCH, T=prob.T,
         tolerance=PARALLEL_TOL, against_sweep=against,
         backward_by_batch=turns, seconds=time.perf_counter() - t0)
    check = against["f64"]
    assert check["status_equal"] and check["reg_equal"], \
        f"parallel: status / reg differ from the sweep kernel: {check}"
    assert check["worst_rel_err"] <= PARALLEL_TOL, \
        f"parallel: gains {check['worst_rel_err']} from the sweep kernel"

    # ---- the paths solved in further processes beside this one ---------
    # Every model's campaign batch is solved in one of three further
    # processes on the card (`campaign_beside`, the groups of BESIDE),
    # `serve`, `residue`, `parallel_solves` and `independent_check` each in
    # one more, `residue_levers` and `profile_iteration` in one; meanwhile
    # this one runs `facade`, acrobot's float32 smoke, `mixed_rescue`, the
    # four older paths and `parallel_dist`. The lines
    # of the further processes come after those: serve, residue,
    # parallel_solves, the campaign in CAMPAIGN_LINES' order, then the
    # experiment layer's.
    bk64, bk32 = "backward_sweep_bk_f64", "backward_sweep_bk_f32"
    campaign_launches = {}
    besides = []
    serve_job = ("serve", (a.batch, a.seed))
    paths_job = ("parallel_solves", (a.batch, a.seed))
    check_job = ("independent_check", None)
    levers_job, profile_job = ("residue_levers", None), ("profile_iteration",
                                                         None)
    traj_job, flops_job = ("trajectories", None), ("flops", None)
    untried_jobs = tuple(("untried_levers", group)
                         for group in UNTRIED_GROUPS)
    older_job = ("older_paths", (a.batch, a.seed, a.max_iterations))
    groups = BESIDE + ((serve_job,), (("residue", None),), (paths_job,),
                       (check_job,), (levers_job, profile_job),
                       (traj_job, untried_jobs[0], flops_job, older_job),
                       untried_jobs[1:])
    shutil.rmtree(TABLE_DIR, ignore_errors=True)    # written again below
    campaign_solved = {}
    try:
        for jobs in groups:
            besides.append(start_beside(jobs))

        # ---- facade: concar through the reference-style Solver ----------
        emit("facade", T=prob.T, **facade_phase(dev))

        # ---- campaign_f32: acrobot's batch, 20 float32 iterations --------
        # the bk instantiation in float
        th32c, b32c, x32c, u32c = campaign_batch("acrobot", torch.float32,
                                                 dev)
        sol, wall, counts = timed_solve(
            more["acrobot"], b32c, x32c, u32c, theta=th32c,
            options=Options(optimality_tolerance=1e-7, max_iterations=20))
        finite = all_finite(sol) and sol.x.dtype == torch.float32
        emit("campaign_f32", model="acrobot", iterations=20, seconds=wall,
             finite=finite, launches={k: v for k, v in counts.items()
                                      if v})
        assert finite
        record("campaign_f32/acrobot", counts, (bk32,))
        by_name[bk32]["launches"] = counts[bk32]

        # ---- mixed_rescue: the rescue, the stall freeze, the adaptive K
        nr = min(RESCUE_BATCH, a.batch)
        sol, info, wall, counts, events, t0 = timed_mixed(
            prob, Bounds(bounds.lower[:nr], bounds.upper[:nr]), x1[:nr],
            u0[:nr], concar.Theta(theta.obstacles[:nr]), mix_opts,
            RESCUE_PATH)
        record("mixed_rescue", counts, names32 + names64)
        fields = mixed_fields(sol, info, wall, counts, events, t0)
        emit("mixed_rescue", batch=nr, **fields)
        left = torch.nonzero(~info["p2"]["converged"])[:, 0]
        assert info["rescue"] is not None, "no lane left for the rescue"
        assert torch.equal(info["rescue"]["indices"], left), \
            "the rescue did not take exactly the lanes phase 2 left"
        assert fields["rescue"]["solved"] >= 0.95 * left.numel()
        assert all_finite(sol)

        # ---- solve_hybrid_f32 ------------------------------------------
        th32, b32, x32, u32 = concar_batch(a.batch, torch.float32, dev, a.seed)
        hyb32 = Options(optimality_tolerance=1e-7, max_iterations=30,
                        backward_kernel="cuda", **hyb)
        s0 = initialize(prob, th32, b32, x32, u32, hyb32)
        p0 = s0.c_raw.abs().flatten(1).amax(dim=1)
        sol32, wall32, counts = timed_solve(prob, b32, x32, u32, theta=th32,
                                            options=hyb32)
        record("solve_hybrid_f32", counts, names32)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (sol32.x, sol32.u, sol32.phi, sol32.zl,
                               sol32.zu))
        emit("solve_hybrid_f32", batch=a.batch, iterations=30, K=K,
             seconds=wall32, finite=finite,
             launches={k: v for k, v in counts.items() if v},
             primal_inf_initial_median=float(p0.median()),
             primal_inf_final_median=float(sol32.primal_inf.median()))
        assert finite and sol32.x.dtype == torch.float32
        assert float(sol32.primal_inf.median()) < float(p0.median())

        # ---- parallel_dist: time sharding and the sharded batch ----------
        t0 = time.perf_counter()
        one, par = one_rank_nccl(dev)
        two, two_ok = two_ranks_gloo(par, bounds, x1, theta, dev)
        emit("parallel_dist", one_rank_nccl=one, two_ranks_gloo=two,
             seconds=time.perf_counter() - t0)
        assert one["equal_to_parallel"] and one["close_to_scan"], \
            f"parallel_dist: one NCCL rank {one}"
        assert two_ok, "parallel_dist: two gloo ranks, see the line above"

        # ---- what the further processes solved beside the paths above ---
        done = {}
        for jobs, beside in zip(groups, besides):
            done.update(zip(jobs, finish_beside(beside)))

        # ---- the three older paths, solved in a further process ---------
        for path, (fields, counts) in done[older_job].items():
            emit(path, **fields)
            record(path, counts, OLDER_PATH_KERNELS[path])

        # ---- serve: the two pools against lockstep on 512 instances -----
        fields, pool_counts = done[serve_job]
        emit("serve", **fields)
        for name, counts in pool_counts.items():
            record(f"serve/{name}", counts, names64)
        record("serve/lockstep", {**dict.fromkeys(names64, 0),
                                  **fields["lockstep"]["launches"]}, names64)
        for name in ("solve_pool", "solve_pool_resident"):
            cmp = fields[name]["against_lockstep"]
            assert cmp["same_status"] >= 0.99 * SERVE_BATCH, \
                f"{name}: status as lockstep on {cmp['same_status']} only"
            assert cmp["max_rel_objective_diff"] <= 1e-6, \
                f"{name}: objective {cmp['max_rel_objective_diff']} " \
                "from lockstep"

        # ---- residue: the round-5 residue instances in native f64 ------
        residue_fields, finite = done[("residue", None)]
        emit("residue", **residue_fields)
        assert finite

        # ---- parallel_solves: full solves in the parallel mode -----------
        fields = done[paths_job]
        emit("parallel_solves", T=prob.T, K=K, **fields)
        assert fields["seed1"]["lane0_on_golden"], \
            f"parallel: seed 1 off its golden objective: {fields['seed1']}"
        assert fields["batch"]["finite"] and fields["batch"]["lane0_on_golden"]
        assert fields["batch"]["solved"] >= 0.95 * PARALLEL_BATCH, \
            f"parallel: {fields['batch']['solved']}/{PARALLEL_BATCH} solved"
        record("parallel_solves/batch",
               {**dict.fromkeys(names64, 0), **fields["batch"]["launches"]},
               ("forward_metrics_f64", "forward_trial_f64"))

        # ---- the campaign's batches -------------------------------------
        for name in CAMPAIGN_LINES:
            for search in ("backtracking", "hybrid"):
                if (name, search) not in done:
                    continue
                fields, finite, counts = done[(name, search)]
                certificates = fields.pop("off_file_certificates", None)
                if search == "hybrid":
                    emit("campaign", search=search, K=K, **fields)
                else:
                    emit("campaign", **fields)
                names = campaign_kernels(name, search)
                campaign_gates(name, fields, finite, counts, names)
                suffix = "_hybrid" if search == "hybrid" else ""
                record(f"campaign/{name}{suffix}", counts, names)
                for k, v in counts.items():
                    campaign_launches[k] = campaign_launches.get(k, 0) + v
                if search == "backtracking":
                    campaign_solved[name] = fields["solved"]
                if certificates is not None:
                    # ---- SLSQP on the rows off the JAX results file ----
                    emit("campaign_certificates", model=name,
                         rtol=OFF_FILE_RTOL, rows=certificates)
                    assert all(r["held"] for r in certificates), \
                        f"campaign/{name}: a certificate failed"

        # ---- distributions: the campaign's tables read back --------------
        dist = {}
        for stem in plot_distributions.PROBLEMS:
            name = plot_distributions.CAMPAIGN[stem]
            summ = plot_distributions.summary(stem, ours=TABLE_DIR)
            dist[stem] = dict(summ, campaign_solved=campaign_solved[name])
            ours = summ["ipddp2tpu_torch"]
            assert (ours["solved"], ours["total"]) == (
                campaign_solved[name], CAMPAIGN_SEEDS), \
                f"distributions/{stem}: {ours} against the campaign's " \
                f"{campaign_solved[name]}"
        emit("distributions", tables=str(TABLE_DIR.relative_to(
            OUT_DIR.parent)), problems=dist)

        # ---- independent_check: SLSQP on the port's optima --------------
        fields, counts = done[check_job]
        diffs = independent_check_gates(fields)
        emit("independent_check", runs=[" ".join(r) for r in CHECK_RUNS],
             ours_against_results_file=diffs, tolerance=CHECK_RTOL,
             **fields)
        record("independent_check", counts,
               ("backward_sweep_f64", "backward_sweep_bk_f64"))

        # ---- residue_levers: base and bk on the residue instances -------
        fields, counts = done[levers_job]
        by_seed = {seed: sum(lane["converged"] for lane in
                             residue_fields["f64"]["lanes"]
                             if lane["seed"] == seed)
                   for seed in LEVER_SEEDS}
        emit("residue_levers", levers=list(LEVERS), **fields,
             residue_phase_f64_solved=by_seed)
        for key, f in fields.items():
            assert f["finite"], f"residue_levers {key}: non-finite iterates"
        for seed in LEVER_SEEDS:
            record(f"residue_levers/{seed}/bk", counts[f"{seed}/bk"],
                   (bk64,))
            record(f"residue_levers/{seed}/base", counts[f"{seed}/base"],
                   ("backward_sweep_f64",))

        # ---- profile_iteration: one iteration's pieces, B = 1 ------------
        fields, counts = done[profile_job]
        emit("profile_iteration", batch=1, T=prob.T, **fields)
        assert all(fields["finite"].values()), fields["finite"]
        record("profile_iteration", counts, ("backward_sweep_f64",))

        # ---- trajectories: plot_trajectories' five seed-1 solves --------
        fields, counts = done[traj_job]
        emit("trajectories", **fields)
        trajectories_gates(fields, counts)

        # ---- the levers the card had not run --------------------------
        fields, counts = {}, {}
        for job in untried_jobs:
            fields.update(done[job][0])
            counts.update(done[job][1])
        base = done[levers_job][0][f"{UNTRIED_SEED}/base"]
        untried = untried_levers_gates(fields, counts, base)
        emit("residue_levers_untried", levers=list(UNTRIED_LEVERS),
             beside_base=untried, **fields)
        flop_count = done[flops_job]
    finally:
        for beside in besides:
            stop_beside(beside)
    by_name[bk64]["launches"] = campaign_launches[bk64]
    emit("campaign_launches", launches={k: v for k, v in
                                        campaign_launches.items() if v})

    # ---- turns: mixed against pure f64 in turns on the same batch --------
    if a.turns:
        emit("turns", batch=a.batch, **mixed_against_pure(
            (prob, bounds, x1, u0, theta), hyb64, mix_opts, mixed_kw))

    # ---- phases: split of mid-solve f64 iterations -----------------------
    split, differing = phase_split(prob, theta, bounds, mid, opts64, hyb64,
                                   iters=5)
    emit("phases", ms_per_iteration=split, batch=a.batch, K=K,
         stepping_lanes_where_hybrid_and_backtracking_differ=differing)

    # ---- flops: the count of one iteration over the phases' time --------
    # (the count is of the plain versions at the initialized state with the
    # speculative search; the time of a mid-solve iteration with the hybrid
    # one: a division as the JAX package's MFU section made, nothing more)
    it_ms = sum(split[k] for k in ("derivatives", "costate", "contraction",
                                   "backward", "forward_hybrid"))
    rate = flop_count["per_instance_iteration"] * a.batch / (it_ms / 1e3)
    emit("flops", **flop_count, batch=a.batch, iteration_ms=it_ms,
         achieved_flops_per_s=rate,
         share_of_fp64_peak=rate / PEAK_FLOPS[torch.float64])
    assert not flop_count["uncounted"], flop_count["uncounted"]

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
