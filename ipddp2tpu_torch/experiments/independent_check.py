"""Independent-solver cross-check (PyTorch port).

Counterpart of `experiments/independent_check.py`. The reference verifies
IPDDP2 by solving the same randomized instances with IPOPT and ProxDDP and
comparing objectives (reference: experiments/ipopt/concar.jl:36-50,
experiments/proxddp/concar.py:14-32). This script lowers each instance to a
plain single-shooting NLP

    min_u  J(x(u), u)   s.t.  c_t(x_t, u_t) = 0,  lo <= u_t <= hi

(states eliminated by rollout) and solves it with scipy's SLSQP, a solver
that shares no code with the port, from the same initial controls.

Two certificates per instance:
  1. cold-start agreement: SLSQP's converged objective matches ours (same
     basin => tight match; a different local optimum is reported, not
     failed);
  2. warm-start stationarity: SLSQP started AT our solution terminates
     without improving it by more than the barrier gap.

The batch is solved by the port's `solve_batch` on `--device` (the GPU by
default): tolerance 1e-7, 1000 iterations, inertia "auto". The NLP's
callables run on CPU tensors in float64, because SLSQP runs on the host;
that is the checker, as the JAX script evaluates them on its CPU backend.
On the contact problems cold-start SLSQP on a 900-2100-variable dense NLP
is slow and often fails, so cold starts default off for them.

The instances are `run_benchmarks.instances`: the committed rows of
`experiments/params` first, so that each "ours" objective can be set
beside its row in `experiments/results/<file>`; `--key` seeds the rows
drawn past them.

Usage:
    python3 -m ipddp2tpu_torch.experiments.independent_check
        [--problems concar ...] [--seeds 3] [--maxiter 400]
        [--warm-maxiter 50] [--key 1] [--cold-all] [--warm-only]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from scipy.optimize import minimize
from torch.utils import _pytree

from ..batch import solve_batch
from ..derivatives import evaluate_constraints, evaluate_objective
from ..options import Options
from ..problem import Bounds
from ..solve import resolve_device
from . import run_benchmarks

# problems where the dense single-shooting NLP is small enough for a
# cold-start SLSQP solve in reasonable time (T*nu <= ~1000 variables)
COLD_DEFAULT = {"double_integrator", "concar", "concar_quad"}
ALL_PROBLEMS = ["double_integrator", "concar", "concar_quad",
                "cartpole_friction", "acrobot_contact", "pushing_1_obs"]
# the file stem of each problem -> its name in `run_benchmarks.MODELS`
CAMPAIGN_NAME = {stem: name for name, (_, stem)
                 in run_benchmarks.MODELS.items()}


def make_nlp(problem, theta, x1):
    """Single-shooting NLP callables over flat controls `[T*nu]` of one
    instance (`theta` unbatched or None, `x1` [nx]), on the tensors' device
    and type: (objective, its gradient, the constraints `[T*nc]`, their
    dense Jacobian `[T*nc, T*nu]`). The gradient is one reverse pass, the
    Jacobian one forward pass vectorized over the T*nu tangents."""
    T, nu = problem.T, problem.nu
    th = None if theta is None else _pytree.tree_map(lambda a: a[None],
                                                     theta)

    def states(u_flat):
        # the model's dynamics on the one instance, stage by stage, with
        # `t` as `forward.rollout` passes it; then a batch of one
        u = u_flat.reshape(T, nu)
        xs = [x1]
        for t in range(T):
            xs.append(problem.dynamics(xs[-1], u[t], t, theta))
        return torch.stack(xs)[None], u[None]

    def obj(u_flat):
        x, u = states(u_flat)
        return evaluate_objective(problem, th, x, u)[0]

    def cons(u_flat):
        x, u = states(u_flat)
        return evaluate_constraints(problem, th, x, u).reshape(-1)

    return obj, torch.func.grad(obj), cons, torch.func.jacfwd(cons)


def _host(fn):
    """`fn` of a float64 CPU tensor as a function of a numpy vector."""
    return lambda v: fn(torch.as_tensor(np.asarray(v, dtype=np.float64)))


def check_instance(name, problem, bounds, theta, x1, u0, ours, maxiter,
                   cold_start=True, warm_maxiter=50, tol=1e-7):
    """The two certificates of one instance (`bounds` [T, nu], `theta`
    unbatched or None, `x1` [nx], `u0` and `ours` [T, nu]; any device),
    checked in float64 on the CPU. Prints the JAX script's line and returns
    (basin, held): basin (same, SLSQP's cold objective) or None."""
    cpu = lambda a: a.detach().to("cpu", torch.float64)
    theta = None if theta is None else _pytree.tree_map(cpu, theta)
    obj, grad, cons, cjac = (_host(f) for f in make_nlp(problem, theta,
                                                         cpu(x1)))
    lo = np.broadcast_to(cpu(bounds.lower).numpy(), (problem.T, problem.nu))
    hi = np.broadcast_to(cpu(bounds.upper).numpy(), (problem.T, problem.nu))
    box = list(zip(np.clip(lo.ravel(), -1e20, 1e20),
                   np.clip(hi.ravel(), -1e20, 1e20)))
    eq = ({"type": "eq", "fun": lambda v: cons(v).numpy(),
           "jac": lambda v: cjac(v).numpy()},) if problem.nc else ()
    kw = dict(jac=lambda v: grad(v).numpy(), bounds=box, constraints=eq,
              method="SLSQP", options={"maxiter": maxiter, "ftol": 1e-10})

    ours_u = cpu(ours).numpy().ravel()
    ours_obj = float(obj(ours_u))

    t0 = time.time()
    warm = minimize(lambda v: float(obj(v)), ours_u,
                    **{**kw, "options": {"maxiter": warm_maxiter,
                                         "ftol": 1e-10}})
    warm_s = time.time() - t0
    improvement = ours_obj - warm.fun

    # A mu-barrier solution sits O(mu * #finite-bounds) above the true NLP
    # optimum (active controls rest ~mu/z inside their bounds); the final
    # barrier is mu = tol/10, so that's the honest stationarity slack.
    n_fin = int(np.isfinite(lo).sum() + np.isfinite(hi).sum())
    gap = 10.0 * (tol / 10.0) * max(n_fin, 1) + 1e-8

    basin = None
    if cold_start:
        t0 = time.time()
        cold = minimize(lambda v: float(obj(v)), cpu(u0).numpy().ravel(),
                        **kw)
        cold_s = time.time() - t0
        same = abs(cold.fun - ours_obj) <= 1e-4 * max(1.0, abs(ours_obj))
        basin = (bool(same), float(cold.fun))
        cold_txt = (f"slsqp(cold)={cold.fun:.8e} "
                    f"[{'same basin' if same else 'different local opt'}; "
                    f"{cold.nit} its, {cold_s:.0f}s]  ")
    else:
        cold_txt = "(cold start skipped: dense NLP too large)  "

    held = improvement <= gap
    print(f"  {name}: ours={ours_obj:.8e}  {cold_txt}"
          f"warm-start improvement={improvement:.2e} "
          f"(barrier gap {gap:.0e}; {warm.nit} its, {warm_s:.0f}s)"
          f"{'' if held else '  ** STATIONARITY VIOLATED **'}", flush=True)
    return basin, held


def instances(name, seeds, key=1, device=None):
    """(problem, bounds [b], thetas [b] | None, x1s [b], u0s [b]) of a
    problem (a file stem of ALL_PROBLEMS): `run_benchmarks.instances`, the
    double integrator's one instance once."""
    campaign = CAMPAIGN_NAME[name]
    mod, _ = run_benchmarks.MODELS[campaign]
    n = 1 if name == "double_integrator" else seeds
    th, b, x1, u0 = run_benchmarks.instances(campaign, n, device=device,
                                             key=key)
    return mod.problem(), b, th, x1, u0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problems", nargs="*", default=ALL_PROBLEMS)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=400)
    ap.add_argument("--warm-maxiter", type=int, default=50)
    ap.add_argument("--key", type=int, default=1,
                    help="seed of the generator of the instances past the "
                         "committed ones")
    ap.add_argument("--cold-all", action="store_true",
                    help="force cold-start SLSQP on the contact problems too")
    ap.add_argument("--warm-only", action="store_true",
                    help="skip every cold start (the warm-start certificate "
                         "only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    options = Options(optimality_tolerance=1e-7, max_iterations=1000)
    agree = cold_total = certs = total = 0

    for name in args.problems:
        if name not in ALL_PROBLEMS:
            print(f"unknown problem {name}", file=sys.stderr)
            continue
        problem, bounds, thetas, x1s, u0s = instances(
            name, args.seeds, key=args.key, device=device)
        n = int(x1s.shape[0])
        sol = solve_batch(problem, bounds, x1s, u0s, theta=thetas,
                          options=options, device=device)
        cold = not args.warm_only and (args.cold_all
                                       or name in COLD_DEFAULT)
        lane = lambda tree, i: _pytree.tree_map(lambda a: a[i], tree)
        ours_objs, cold_objs = [], []
        for i in range(n):
            if not bool(sol.converged[i]):
                print(f"  {name} seed {i + 1}: ours unconverged, skipped",
                      flush=True)
                continue
            basin, held = check_instance(
                f"{name} seed {i + 1}", problem,
                Bounds(bounds.lower[i], bounds.upper[i]),
                None if thetas is None else lane(thetas, i),
                x1s[i], u0s[i], sol.u[i], args.maxiter,
                cold_start=cold, warm_maxiter=args.warm_maxiter)
            certs += int(held)
            total += 1
            if basin is not None:
                agree += int(basin[0])
                cold_total += 1
                ours_objs.append(float(sol.objective[i]))
                cold_objs.append(basin[1])
        # distribution-level comparison: objective medians side by side
        if ours_objs:
            mo, mc = float(np.median(ours_objs)), float(np.median(cold_objs))
            print(f"  {name}: median objective ours {mo:.6e} vs "
                  f"slsqp(cold) {mc:.6e} over {len(ours_objs)} instances "
                  f"(ratio {mo / mc:.4f})", flush=True)

    print(f"\n{certs}/{total} stationarity certificates held; "
          f"{agree}/{cold_total} cold-start basin agreements", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
