"""Which lever solves the bench-residue instances? (PyTorch port)

Counterpart of `scripts/residue_levers.py`. The instances that survived the
JAX package's full rescue ladder in its round-5 autopsy share one
signature: primal_inf ~1e-14, cs_inf pinned at the mu floor 1e-8 (< tol),
dual_inf plateaued at 2e-7..5e-6: a dual-stationarity plateau at the
barrier floor, not a globalization failure. This script takes those exact
instances (the port's data file `models/concar_residue_r5.json`: seeds
1002 and 1004 of the JAX generator, the JAX script's rows) and A/Bs
candidate levers on a from-scratch f64 solve (`chunked.solve_chunked`,
chunks of 50, on `--device`):

    base     the rescue configuration (sequential search, ldl, refine 1)
    refine3  refine_steps=3 (more iterative refinement on the graded KKT)
    eigh     exact-inertia oracle (the plain sweep: eigh has no kernel)
    bk       reference-faithful Bunch-Kaufman (the bk sweep kernel on a GPU)
    resets   ls_failure_resets=3
    qn       quasi_newton (different H conditioning at the floor)

Usage:
    python3 -m ipddp2tpu_torch.scripts.residue_levers [--seed 1002]
        [--levers base,refine3] [--max-iter 1000] [--device cuda|cpu]
        [--instances N]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..chunked import solve_chunked
from ..experiments.run_benchmarks import median
from ..models import concar
from ..options import Options
from ..solve import resolve_device

LEVERS = {
    "base": {},
    "refine3": {"refine_steps": 3},
    "eigh": {"inertia_method": "eigh"},
    "bk": {"inertia_method": "bk"},
    "resets": {"ls_failure_resets": 3},
    "qn": {"quasi_newton": True},
}
CHUNK = 50


def instances(seed, device=None, limit=None):
    """(indices, theta, bounds, x1, u0) of one seed's residue instances
    (the first `limit` of them if given)."""
    seeds, index, theta, f_lim, tau_lim, x1 = concar.residue_instances(
        device)
    pick = [j for j, s in enumerate(seeds) if s == seed][:limit]
    if not pick:
        raise ValueError(f"no residue instances of seed {seed}; expected "
                         f"one of {sorted(set(seeds))}")
    sel = torch.tensor(pick, device=x1.device)
    n = len(pick)
    u0 = concar.initial_controls(device=device).expand(n, concar.T,
                                                       concar.NU)
    return ([index[j] for j in pick],
            concar.Theta(obstacles=theta.obstacles[sel]),
            concar.bounds(f_lim[sel], tau_lim[sel], device=device),
            x1[sel], u0)


def solve_lever(lever, data, max_iter, device):
    """One lever's from-scratch solve of `instances` (`data`): (solution,
    wall seconds)."""
    _, theta, bounds, x1, u0 = data
    opts = Options(optimality_tolerance=1e-7, max_iterations=max_iter,
                   auto_tune=False, **LEVERS[lever])
    t0 = time.time()
    sol = solve_chunked(concar.problem(), bounds, x1, u0, theta=theta,
                        options=opts, chunk=CHUNK, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sol, time.time() - t0


def report(lever, idx, sol, wall):
    """The JAX script's lines for one lever: solved count, then each
    unsolved instance."""
    conv = sol.converged.cpu()
    lines = [f"[{lever}] solved {int(conv.sum())}/{len(idx)} in {wall:.0f}s "
             f"(median k {median(sol.iterations.cpu()):.0f})"]
    for i in torch.nonzero(~conv)[:, 0].tolist():
        lines.append(f"   inst {idx[i]}: status {int(sol.status[i])}"
                     f" k={int(sol.iterations[i])}"
                     f" dual={float(sol.dual_inf[i]):.2e}"
                     f" cs={float(sol.cs_inf[i]):.2e}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1002)
    ap.add_argument("--levers", default="base,refine3,eigh,bk,resets")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--instances", type=int, default=None,
                    help="only the first N instances of the seed")
    args = ap.parse_args(argv)
    levers = args.levers.split(",")
    unknown = [lv for lv in levers if lv not in LEVERS]
    if unknown:
        ap.error(f"unknown lever(s) {unknown}; expected {list(LEVERS)}")
    device = resolve_device(args.device)
    data = instances(args.seed, device, args.instances)
    for lever in levers:
        sol, wall = solve_lever(lever, data, args.max_iter, device)
        print("\n".join(report(lever, data[0], sol, wall)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
