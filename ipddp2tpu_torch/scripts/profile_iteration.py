"""Time the pieces of one solver iteration (PyTorch port).

Counterpart of `scripts/profile_iteration.py`. On concar's seed-1 iterate
(the initialized state, B = 1, T = 100, float64, tolerance 1e-7) it times
each piece alone, in the JAX script's order: the derivative bundle, the
costate scan, the dynamics-Hessian contraction, the sequential backward
pass (the sweep kernel on a GPU), the parallel backward pass
(`parallel/priccati.py`), one rollout and the full forward pass
(backtracking line search). Each piece runs once to warm up, then `--reps`
times between two CUDA events (on the CPU: the host clock), the device
synchronized before and after. Prints `name  ms` lines; exits 1 if a
piece's output is not finite.

Usage:
    python3 -m ipddp2tpu_torch.scripts.profile_iteration [--reps 20]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..backward import backward_pass, costate_scan
from ..derivatives import (contract_dynamics_hessian, evaluate_derivatives,
                           relax_constraints)
from ..forward import forward_pass, rollout
from ..models import concar
from ..options import Options
from ..parallel.priccati import backward_pass_parallel
from ..solve import (_nominal_trial, initialize, resolve_device,
                     resolve_options)

PIECES = ("derivatives", "costate scan", "hessian contraction",
          "backward (sequential)", "backward (parallel)",
          "rollout (one trial)", "forward pass (full LS)")


def timed(fn, reps, device):
    """(ms per call of `fn` over `reps` calls after one warm-up, the last
    output)."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1e3, out


def _finite(out):
    """Whether every float output is finite, but the slacks `il` / `iu` of
    a trial, which hold +inf at infinite bounds."""
    leaves, _ = torch.utils._pytree.tree_flatten_with_path(out)
    return all(bool(torch.isfinite(a).all()) for path, a in leaves
               if isinstance(a, torch.Tensor) and a.is_floating_point()
               and torch.utils._pytree.keystr(path)[-3:] not in (".il",
                                                                 ".iu"))


def profile(device, reps=20):
    """{piece: (ms, every output finite)} in PIECES' order."""
    prob = concar.problem()
    options = resolve_options(Options(optimality_tolerance=1e-7), prob,
                              device)
    theta, f_lim, tau_lim, x1 = concar.seed1_instance(device=device)
    theta = concar.Theta(theta.obstacles[None])
    bounds = concar.bounds([f_lim], [tau_lim], device=device)
    s = initialize(prob, theta, bounds, x1[None],
                   concar.initial_controls(device=device)[None], options,
                   device=device)
    out = {}

    def piece(name, fn):
        ms, res = timed(fn, reps, device)
        out[name] = (ms, _finite(res))
        return res

    deriv = piece(PIECES[0], lambda: evaluate_derivatives(
        prob, theta, s.x, s.u, s.phi))
    lam = piece(PIECES[1], lambda: costate_scan(deriv, s.phi))
    second = piece(PIECES[2], lambda: contract_dynamics_hessian(
        prob, theta, s.x, s.u, lam[:, 1:])) + deriv.cH_phi
    nominal = (relax_constraints(prob, s.c_raw, s.mu), s.il, s.iu, s.phi,
               s.zl, s.zu)
    bw = piece(PIECES[3], lambda: backward_pass(
        prob, deriv, nominal, s.mu, s.reg_last, options, lam=lam,
        second=second))
    piece(PIECES[4], lambda: backward_pass_parallel(
        prob, deriv, nominal, s.mu, s.reg_last, options, lam=lam,
        second=second))
    piece(PIECES[5], lambda: rollout(
        prob, theta, bounds, bw.gains, s.x, s.u, s.phi, s.zl, s.zu,
        torch.ones_like(s.mu)))
    piece(PIECES[6], lambda: forward_pass(
        prob, theta, bounds, bw.gains, _nominal_trial(s), bw.dL, s.mu,
        s.theta_curr, s.L_curr, s.min_primal_1, s.filter_pts, options))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = profile(device, args.reps)
    for name, (ms, _) in out.items():
        print(f"{name:28s} {ms:8.2f} ms", flush=True)
    bad = [name for name, (_, finite) in out.items() if not finite]
    if bad:
        print(f"profile_iteration: non-finite output of {bad}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
