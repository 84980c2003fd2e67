"""The benchmark campaigns (PyTorch port).

Counterpart of `experiments/run_benchmarks.py`. The JAX script draws each
model's instances with `jax.random` (seed 1 first) and writes them to
`experiments/params/`; this script solves THOSE committed instances (100 a
model), read by each model's `from_params`, and past them as many more as
`--seeds` asks, drawn by the model's `random_instances` from
`torch.Generator().manual_seed(--key)` (the JAX generator's ranges, not its
numbers). It solves them in one `solve_batch` per model under the JAX
script's options (float64, `max_iterations=1000`, tolerance `--tol`,
`inertia_method=--inertia`), writes the instances to
`<out>/params/<file>` in the JAX layout (`repr(float)`, read back bit for
bit by `from_params`) and the per-seed table in the JAX results format

     seed  iterations  status     objective           primal

to `<out>/<file>` (never into `experiments/`), and prints a comparison with
the JAX campaign's table `experiments/results/<file>`: instances solved,
median and largest iterations, objectives within 1e-4 (on the rows that
table has).

Usage:
    python3 -m ipddp2tpu_torch.experiments.run_benchmarks [problem ...]
        [--seeds N] [--key K] [--tol 1e-7] [--inertia auto|ldl|eigh|bk]
        [--search backtracking|hybrid] [--device cuda|cpu]
        [--out DIR] [--suffix S]

Problems: concar concar_quad cartpole acrobot pushing double_integrator
quadrotor cartpole_swingup (default: all). The default device is the GPU;
without one the script stops (pass `--device cpu`).
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import torch

from .. import convert
from ..batch import solve_batch
from ..models import (acrobot, cartpole, cartpole_swingup, concar,
                      concar_quad, double_integrator, pushing, quadrotor)
from ..options import Options
from ..problem import Bounds
from ..solve import resolve_device

# name -> (model, the stem of its files in experiments/params and results)
MODELS = {
    "concar": (concar, "concar"),
    "concar_quad": (concar_quad, "concar_quad"),
    "cartpole": (cartpole, "cartpole_friction"),
    "acrobot": (acrobot, "acrobot_contact"),
    "pushing": (pushing, "pushing_1_obs"),
    "double_integrator": (double_integrator, "double_integrator"),
    "quadrotor": (quadrotor, "quadrotor"),
    "cartpole_swingup": (cartpole_swingup, "cartpole_swingup"),
}
CONTACT = ("acrobot", "cartpole", "pushing")
RESULTS = Path(__file__).resolve().parents[2] / "experiments" / "results"
SEEDS = 100
SPECULATIVE = 8                  # the hybrid search's step sizes
HEADER = (" seed  iterations  status     objective           primal"
          "        \n")


def options(tol=1e-7, inertia="auto", search="backtracking") -> Options:
    """The JAX script's options; "hybrid" adds the hybrid line search
    (K = 8 speculative step sizes, then backtracking)."""
    hybrid = (dict(ls_speculative=SPECULATIVE, ls_spec_continue=True)
              if search == "hybrid" else {})
    return Options(optimality_tolerance=tol, max_iterations=1000,
                   inertia_method=inertia, **hybrid)


def golden_row(name, mod):
    """The instance of the repo's golden anchor in the params layout of
    `mod.from_params`: the reference's seed 1 (concar_quad: concar's) or,
    for quadrotor and the swing-up, the default instance."""
    if name in ("concar", "concar_quad"):
        th, f_lim, tau_lim, x1 = mod.seed1_instance()
        return [f_lim, tau_lim, *th.obstacles.flatten().tolist(),
                *x1.tolist()]
    if name == "quadrotor":
        return [*mod.GOAL, 0.0, 0.0, 0.0]
    if name == "cartpole_swingup":
        return [0.0, 0.0]
    th = mod.SEED1_THETA
    if name == "acrobot":
        return [th["m1"], mod.I1, th["l1"], mod.LC1, th["m2"], mod.I2,
                th["l2"], mod.LC2]
    if name == "cartpole":
        return [th["mc"], th["mp"], th["l"], *th["friction"]]
    return [th["zx"], th["zy"], th["c"], th["mu_fric"], *th["obstacle"]]


def golden_of(name, mod):
    """(objective, iterations) of the model's golden anchor."""
    if name in ("quadrotor", "cartpole_swingup"):
        return mod.ANCHOR_OBJECTIVE, mod.ANCHOR_ITERATIONS
    if name == "double_integrator":
        return mod.GOLDEN_OBJECTIVE, mod.GOLDEN_ITERATIONS
    return mod.SEED1_GOLDEN_OBJECTIVE, mod.SEED1_GOLDEN_ITERATIONS


def params_of(name, drawn):
    """The rows (float64 `[B, columns]`, the layout of
    `experiments/params/<file>` that `from_params` reads) of instances drawn
    by the model's `random_instances`."""
    mod, _ = MODELS[name]
    if name in ("concar", "concar_quad"):
        th, f_lim, tau_lim, x1 = drawn
        return torch.cat([f_lim[:, None], tau_lim[:, None],
                          th.obstacles.flatten(1), x1], dim=1)
    if name == "quadrotor":
        th, x1 = drawn
        return torch.cat([th.goal, x1[:, :3]], dim=1)
    if name == "cartpole_swingup":
        return drawn[:, :2]
    th = drawn
    if name == "acrobot":
        fixed = lambda v: torch.full_like(th.m1, v)
        return torch.stack([th.m1, fixed(mod.I1), th.l1, fixed(mod.LC1),
                            th.m2, fixed(mod.I2), th.l2, fixed(mod.LC2)],
                           dim=1)
    if name == "cartpole":
        return torch.cat([torch.stack([th.mc, th.mp, th.l], dim=1),
                          th.friction], dim=1)
    return torch.cat([torch.stack([th.zx, th.zy, th.c, th.mu_fric], dim=1),
                      th.obstacle], dim=1)


def instance_rows(name, seeds=SEEDS, key=1):
    """The params rows of a model's first `seeds` instances, float64
    `[seeds, columns]`: the committed rows of `experiments/params` (seed 1
    first, the JAX campaign's instances bit for bit), then, past them, rows
    drawn by the model's `random_instances` from
    `torch.Generator().manual_seed(key)`."""
    mod, _ = MODELS[name]
    rows = torch.as_tensor(convert.params_rows(mod.PARAMS))[:seeds]
    extra = seeds - rows.shape[0]
    if extra > 0:
        gen = torch.Generator().manual_seed(key)
        rows = torch.cat([rows, params_of(
            name, mod.random_instances(extra, gen))])
    return rows


def instances(name, seeds=SEEDS, dtype=torch.float64, device=None,
              golden=False, key=1):
    """(theta, bounds, x1, u0) of the campaign's first `seeds` instances
    (`instance_rows`); with `golden`, one more lane: the golden anchor's
    instance. The double integrator has one instance, which every lane
    holds."""
    mod, _ = MODELS[name]
    if name == "double_integrator":
        n = seeds + int(golden)
        b = mod.bounds(dtype, device)
        x1 = mod.initial_state(dtype, device)
        u0 = mod.initial_controls(dtype, device)
        return (None, Bounds(*(v.expand((n,) + v.shape) for v in b)),
                x1.expand(n, *x1.shape), u0.expand(n, *u0.shape))
    rows = instance_rows(name, seeds, key)
    if golden:
        rows = torch.cat([rows, torch.tensor([golden_row(name, mod)],
                                             dtype=torch.float64)])
    return mod.from_params(rows, dtype, device)


def solve(name, opts, seeds=SEEDS, device=None, golden=False, key=1):
    """One model's campaign batch through `solve_batch`."""
    th, b, x, u = instances(name, seeds, device=device, golden=golden,
                            key=key)
    return solve_batch(MODELS[name][0].problem(), b, x, u, theta=th,
                       options=opts, device=device)


def write_params(path, rows):
    """Params rows to `path`, one instance a line, each value as
    `repr(float)` (the JAX script's `write_params`)."""
    path.write_text("".join(" ".join(repr(float(v)) for v in row) + "\n"
                            for row in rows.tolist()))


def results_table(sol, n) -> str:
    """The first `n` lanes in the JAX script's results format."""
    lines = [HEADER]
    for i in range(n):
        ok = bool(sol.converged[i]) and int(sol.status[i]) == 0
        lines.append(f" {i + 1:2d}     {int(sol.iterations[i]):5d}      "
                     f"{str(ok).lower():5s}    "
                     f"{float(sol.objective[i]):.8e}    "
                     f"{float(sol.primal_inf[i]):.8e} \n")
    return "".join(lines)


def reference_results(stem, n=None):
    """The JAX campaign's per-seed table `experiments/results/<stem>.txt`:
    converged, iterations, objective, each `[n]`."""
    rows = [line.split() for line in
            (RESULTS / f"{stem}.txt").read_text().splitlines()[1:]
            if line.strip()][:n]
    conv = torch.tensor([r[2] == "true" for r in rows])
    iters = torch.tensor([int(r[1]) for r in rows], dtype=torch.float64)
    obj = torch.tensor([float(r[3]) for r in rows], dtype=torch.float64)
    return conv, iters, obj


def median(t):
    """The median as numpy takes it (the mean of the two middle values)."""
    v = t.to(torch.float64).sort().values
    n = v.numel()
    return float(v[n // 2]) if n % 2 else float(0.5 * (v[n // 2 - 1]
                                                       + v[n // 2]))


def on_golden(name, objective, iterations, converged, golden):
    """tests/test_benchmarks.py's rule: objective to 1e-6, iterations
    within max(3, 10 % + 1); pushing: converged, objective within 10 %."""
    g_obj, g_it = golden
    if name == "pushing":
        return converged and math.isclose(objective, g_obj, rel_tol=0.1)
    return (converged and math.isclose(objective, g_obj, rel_tol=1e-6)
            and abs(iterations - g_it) <= max(3, int(0.1 * g_it) + 1))


def compare(name, sol, n):
    """What a campaign solve did on its first `n` lanes, beside the JAX
    campaign's results file (on the rows it has), and (if the batch has one
    more lane) its golden lane."""
    mod, stem = MODELS[name]
    conv, iters, obj = (sol.converged[:n].cpu(), sol.iterations[:n].cpu(),
                        sol.objective[:n].cpu())
    r_conv, r_iters, r_obj = reference_results(stem, n)
    m = r_conv.shape[0]
    match = conv[:m] & r_conv & ((obj[:m] - r_obj).abs()
                                 <= 1e-4 * r_obj.abs())
    med, r_med = median(iters), median(r_iters)
    fields = dict(
        model=name, instances=n, solved=int(conv.sum()),
        reference_solved=int(r_conv.sum()),
        median_iterations=med, reference_median_iterations=r_med,
        median_within_10_percent_or_3=abs(med - r_med) <= max(
            0.1 * r_med, 3.0),
        max_iterations=int(iters.max()),
        reference_max_iterations=int(r_iters.max()),
        objectives_matching_reference_to_1e_4=int(match.sum()),
        seed1=dict(iterations=int(iters[0]), objective=float(obj[0]),
                   converged=bool(conv[0]),
                   reference_iterations=int(r_iters[0]),
                   reference_objective=float(r_obj[0])),
        status_counts={str(k): int((sol.status[:n] == k).sum())
                       for k in sol.status[:n].unique().tolist()},
        # each unconverged instance: seed row, status, iterations, and
        # whether the JAX campaign converged it (None past its rows)
        unsolved=[[i, int(sol.status[i]), int(iters[i]),
                   bool(r_conv[i]) if i < m else None]
                  for i in torch.nonzero(~conv)[:, 0].tolist()])
    if sol.converged.shape[0] > n:
        g = (float(sol.objective[n]), int(sol.iterations[n]),
             bool(sol.converged[n]))
        golden = golden_of(name, mod)
        fields["golden"] = dict(
            iterations=g[1], objective=g[0], converged=g[2],
            golden_iterations=golden[1], golden_objective=golden[0],
            on_golden=on_golden(name, *g, golden))
    return fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("problems", nargs="*", default=list(MODELS))
    ap.add_argument("--seeds", type=int, default=SEEDS)
    ap.add_argument("--key", type=int, default=1,
                    help="seed of the generator of the instances past the "
                         "committed ones")
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--inertia", default="auto",
                    choices=["auto", "ldl", "eigh", "bk"])
    ap.add_argument("--search", default="backtracking",
                    choices=["backtracking", "hybrid"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="run_benchmarks_out",
                    help="directory of the results tables")
    ap.add_argument("--suffix", default="",
                    help="suffix of the results file names")
    args = ap.parse_args(argv)
    unknown = [p for p in args.problems if p not in MODELS]
    if unknown:
        ap.error(f"unknown problem(s) {unknown}; expected {list(MODELS)}")
    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    opts = options(args.tol, args.inertia, args.search)
    for name in args.problems:
        stem = MODELS[name][1]
        # the JAX script solves the double integrator's one instance once
        seeds = 1 if name == "double_integrator" else args.seeds
        if name != "double_integrator":
            (out / "params").mkdir(exist_ok=True)
            write_params(out / "params" / f"{stem}.txt",
                         instance_rows(name, seeds, args.key))
        t0 = time.perf_counter()
        sol = solve(name, opts, seeds, device, key=args.key)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sol.converged.shape[0]
        path = out / f"{stem}{args.suffix}.txt"
        path.write_text(results_table(sol, n))
        f = compare(name, sol, n)
        print(f"{name}: {f['solved']}/{n} solved (JAX {f['reference_solved']}"
              f"), median iterations {f['median_iterations']:.1f} (JAX "
              f"{f['reference_median_iterations']:.1f}), largest "
              f"{f['max_iterations']} (JAX {f['reference_max_iterations']}),"
              f" objectives within 1e-4: "
              f"{f['objectives_matching_reference_to_1e_4']}, "
              f"{wall:.1f} s on {device} -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
