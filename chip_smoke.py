#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on an NVIDIA H100, end to end.

    python3 chip_smoke.py [--batch 2048] [--max-iterations 1000] [--ptxas]

Needs one CUDA device of compute capability 9.0 and `nvcc`; with no device it
exits non-zero at the first phase. It imports `torch` and `ipddp2tpu_torch`
only. Phases, each printing one JSON line:

  1. device    the card, its capability and its power limit;
  2. build     compiles the backward-sweep kernel from the sources in this
               checkout (all `nvcc` processes started together);
  3. kernels   holds `backward_sweep_cuda` (float and double instantiation)
               against its plain PyTorch version `sweep_plain` on a mid-solve
               concar state at the main path's shapes and on a tiny nc=0
               problem, with some lanes perturbed to fail the inertia test;
               times the kernel and the plain version and computes the
               kernel's lower bound on this card;
  3b. graphs   the rollout replayed from a CUDA graph equals the eager one;
  4. solve_f64 `solve_batch` on concar at its published size (T=100), B
               instances (lane 0 = the reference's seed-1 instance), float64,
               tolerance 1e-7, through the CUDA kernel; checks lane 0 against
               the golden result and that >= 95 % of the lanes converge;
  5. solve_f32 30 iterations of the same batch in float32 through the float
               kernel; checks finite states and a fallen primal infeasibility;
  6. phases    a timed split of a few mid-solve iterations into the solver's
               phases (derivatives, costate, contraction, backward, forward).

Any failed assertion or exception ends the run with a non-zero exit code and
without the last line. The last three lines are the kernels' JSON object,
the card's name and power limit, and the result object.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from ipddp2tpu_torch import Options, Problem, solve_batch
from ipddp2tpu_torch.backward import (backward_pass, costate_scan,
                                      sweep_plain)
from ipddp2tpu_torch.derivatives import (contract_dynamics_hessian,
                                         evaluate_derivatives,
                                         relax_constraints)
from ipddp2tpu_torch import graphs
from ipddp2tpu_torch.forward import forward_pass, rollout
from ipddp2tpu_torch.models import concar
from ipddp2tpu_torch.ops import backward_cuda
from ipddp2tpu_torch.ops.backward_cuda import backward_sweep_cuda
from ipddp2tpu_torch.problem import Bounds
from ipddp2tpu_torch.solve import (SolverState, _nominal_trial, initialize,
                                   iteration)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): device
# memory rate, and the vector (non-tensor-core) rates the sweep can use.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
# kernel-vs-plain tolerances on the gains, relative to each tensor's scale:
# both sides do the same arithmetic in another order (and the kernel with
# fused multiply-adds), so they differ by rounding amplified by the KKT
# systems' conditioning
TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
GAIN_NAMES = ("alpha", "beta", "psi", "omega", "chi_l", "zeta_l", "chi_u",
              "zeta_u")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
                   terminal_cost=terminal)


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


def borderline(args, dims, rtol):
    """Lanes whose plain residual lies within 10x of the gate: their `fail`
    flips between rtol/10 and rtol*10."""
    lo = sweep_plain(*args, **dims, rtol=rtol / 10.0)[2]
    hi = sweep_plain(*args, **dims, rtol=rtol * 10.0)[2]
    return lo != hi


def check_kernel(name, args, dims, rtol, time_reps):
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
    assert int(ok.sum()) > 0 and int(fp.sum()) > 0, \
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
        fields["ms"] = cuda_ms(
            lambda: backward_sweep_cuda(*args, **dims, rtol=rtol), time_reps)
        fields["plain_ms"] = cuda_ms(
            lambda: sweep_plain(*args, **dims, rtol=rtol), 1)
        nbytes = sum(a.numel() * a.element_size() for a in args)
        nbytes += sum(g.numel() * g.element_size() for g in gk)
        nbytes += dLk.numel() * dLk.element_size() + 2 * fk.numel()
        B, T = args[11].shape[0], args[11].shape[1]
        flops = B * sweep_flops(T, dims["nx"], dims["nu"], dims["nc"],
                                dims["refine"])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        fields.update(bytes=nbytes, flops=flops,
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
    return fields


def cast_state(s, dtype):
    return SolverState(*(a.to(dtype) if a.is_floating_point() else a
                         for a in s))


def phase_split(problem, theta, bounds, s, options, iters):
    """Host-clock split of `iters` iterations from state `s`, synchronizing
    after each phase (so the phases do not overlap as they may in a solve)."""
    names = ("derivatives", "costate", "contraction", "backward", "forward")
    acc = dict.fromkeys(names, 0.0)

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
        timed("forward", lambda: forward_pass(
            problem, theta, bounds, bw.gains, _nominal_trial(s), bw.dL, s.mu,
            s.theta_curr, s.L_curr, s.min_primal_1, s.filter_pts, options))
        s = iteration(problem, bounds, s, theta, options)
    return {k: v / iters * 1e3 for k, v in acc.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--max-iterations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register / memory report")
    a = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
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
    emit("device", kind=kind, capability=list(cap), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    assert cap == (9, 0), f"built for sm_90a, found capability {cap}"

    # ---- 2. build --------------------------------------------------------
    prob = concar.problem()
    tiny = tiny_problem()
    dims_c = dict(nx=prob.nx, nu=prob.nu, nc=prob.nc)
    dims_t = dict(nx=tiny.nx, nu=tiny.nu, nc=tiny.nc)
    t0 = time.perf_counter()
    libs = backward_cuda.build(
        [tuple(dims_c.values()), tuple(dims_t.values())], verbose=a.ptxas)
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs])

    # ---- 3. kernels ------------------------------------------------------
    opts64 = Options(optimality_tolerance=1e-7,
                     max_iterations=a.max_iterations, backward_kernel="cuda")
    rtol, refine = opts64.kkt_residual_rtol, max(opts64.refine_steps, 1)
    theta, bounds, x1, u0 = concar_batch(a.batch, torch.float64, dev, a.seed)
    plain = Options(optimality_tolerance=1e-7, backward_kernel="torch")
    t0 = time.perf_counter()
    mid = initialize(prob, theta, bounds, x1, u0, plain)
    for _ in range(10):                 # a mid-solve state: non-uniform duals
        mid = iteration(prob, bounds, mid, theta, plain)
    torch.cuda.synchronize()
    emit("mid_state", plain_iterations=10, seconds=time.perf_counter() - t0)

    kernels = []
    rows = (("backward_sweep_f32", torch.float32,
             "ipddp2tpu/ops/backward_pallas.py:308"),
            ("backward_sweep_f64", torch.float64,
             "ipddp2tpu/ops/backward_pallas_df64.py:418"))
    for kname, dtype, replaces in rows:
        th = concar.Theta(theta.obstacles.to(dtype))
        args = perturb(sweep_inputs(prob, th, cast_state(mid, dtype)),
                       prob.nu)
        main_fields = check_kernel(kname, args, dict(dims_c, refine=refine),
                                   rtol, time_reps=10)
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
             tiny_nc0=tiny_fields)
        kernels.append(dict(
            name=kname, route="cuda",
            source="ipddp2tpu_torch/ops/csrc/backward_sweep.cu",
            replaces=replaces, launches=0,
            max_abs_err=max(main_fields["max_abs_err"],
                            tiny_fields["max_abs_err"]),
            max_rel_err=max(main_fields["max_rel_err"],
                            tiny_fields["max_rel_err"]),
            ms=main_fields["ms"], plain_ms=main_fields["plain_ms"],
            bound_ms=main_fields["bound_ms"],
            bound_by=main_fields["bound_by"], library_ms=None))

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
    diff = max(float((a - b).abs().nan_to_num(posinf=0.0).max())
               for a, b in zip(trials["eager"], trials["graph"]))
    emit("graphs", rollout_eager_ms=timings["eager"],
         rollout_graph_ms=timings["graph"], max_abs_diff=diff)
    assert diff == 0.0, "graph replay differs from the eager rollout"

    # ---- 4. solve_f64: the main path ------------------------------------
    backward_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_batch(prob, bounds, x1, u0, theta=theta, options=opts64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(backward_cuda.launch_counts)
    kernels[1]["launches"] = counts["backward_sweep_f64"]
    assert counts["backward_sweep_f64"] > 0, "main path missed the f64 kernel"
    iters = sol.iterations.to(torch.float64)
    solved = int(sol.converged.sum())
    obj0, it0 = float(sol.objective[0]), int(sol.iterations[0])
    emit("solve_f64", batch=a.batch, T=prob.T, solved=solved,
         median_iterations=float(iters.median()),
         max_iterations=int(iters.max()), seconds=wall,
         ocps_per_second=solved / wall,
         sweep_launches=counts["backward_sweep_f64"],
         sweep_share=counts["backward_sweep_f64"] * kernels[1]["ms"] * 1e-3
         / wall,
         lane0=dict(objective=obj0, iterations=it0,
                    converged=bool(sol.converged[0])),
         status_counts={str(k): int((sol.status == k).sum())
                        for k in sol.status.unique().tolist()})
    assert all(bool(torch.isfinite(t).all()) for t in (sol.x, sol.u))
    # the repo's golden rule (tests/test_benchmarks.py:_check)
    assert bool(sol.converged[0]), "seed-1 lane did not converge"
    assert math.isclose(obj0, concar.SEED1_GOLDEN_OBJECTIVE, rel_tol=1e-6), \
        obj0
    g_it = concar.SEED1_GOLDEN_ITERATIONS
    assert abs(it0 - g_it) <= max(3, int(0.1 * g_it) + 1), it0
    assert solved >= 0.95 * a.batch, f"only {solved}/{a.batch} converged"

    # ---- 5. solve_f32 ----------------------------------------------------
    th32, b32, x32, u32 = concar_batch(a.batch, torch.float32, dev, a.seed)
    opts32 = Options(optimality_tolerance=1e-7, max_iterations=30,
                     backward_kernel="cuda")
    s0 = initialize(prob, th32, b32, x32, u32, opts32)
    p0 = s0.c_raw.abs().flatten(1).amax(dim=1)
    backward_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    sol32 = solve_batch(prob, b32, x32, u32, theta=th32, options=opts32)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    counts = dict(backward_cuda.launch_counts)
    kernels[0]["launches"] = counts["backward_sweep_f32"]
    assert counts["backward_sweep_f32"] > 0, "f32 path missed the f32 kernel"
    finite = all(bool(torch.isfinite(t).all())
                 for t in (sol32.x, sol32.u, sol32.phi, sol32.zl, sol32.zu))
    emit("solve_f32", batch=a.batch, iterations=30, seconds=wall32,
         finite=finite, sweep_launches=counts["backward_sweep_f32"],
         primal_inf_initial_median=float(p0.median()),
         primal_inf_final_median=float(sol32.primal_inf.median()))
    assert finite and sol32.x.dtype == torch.float32
    assert float(sol32.primal_inf.median()) < float(p0.median())

    # ---- 6. phase split of mid-solve f64 iterations ----------------------
    split = phase_split(prob, theta, bounds, mid, opts64, iters=5)
    emit("phases", ms_per_iteration=split, batch=a.batch)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
