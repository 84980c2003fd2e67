"""Distributions of iterations and objectives over a campaign's seeds
(PyTorch port).

Counterpart of `experiments/plot_distributions.py`. For each problem it
reads the per-seed tables of several solvers on the same 100 instances:

    ipddp2tpu_torch   `<ours>/<problem>.txt`, written by
                      `python3 -m ipddp2tpu_torch.experiments.run_benchmarks
                      --out <ours>` (run here on `--device` where the table
                      is absent)
    ipddp2tpu (JAX)   the committed `experiments/results/<problem>.txt`
    IPDDP2 (ref), IPOPT, ProxDDP
                      the reference's tables under `--ref DIR` (default
                      the `REF` environment variable), where they exist

The data half, `summary(problem, ours, ref)`, needs no matplotlib: per
source, the seeds solved of the total and the quartiles (25 %, median,
75 %) of the iterations and of the objective over the solved seeds. The
drawing half, `plot`, writes the JAX script's boxplots to
`<out>/dist_<problem>.png`, importing matplotlib when it is called;
`--no-draw` prints the summaries only.

Usage:
    python3 -m ipddp2tpu_torch.experiments.plot_distributions [problem ...]
        [--ours run_benchmarks_out] [--ref DIR] [--device cuda|cpu]
        [--out plots_out] [--no-draw]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from pathlib import Path

import numpy as np

from ..solve import resolve_device
from . import run_benchmarks
from .plot_trajectories import OUT, pyplot

PROBLEMS = ["concar", "concar_quad", "cartpole_friction", "acrobot_contact",
            "pushing_1_obs"]
OURS = "run_benchmarks_out"
# the reference's solvers: label -> its results directory under REF
REFERENCE = {"IPDDP2 (ref)": "ipddp2", "IPOPT": "ipopt",
             "ProxDDP": "proxddp"}
# results file stem -> `run_benchmarks`' name of the problem
CAMPAIGN = {stem: name for name, (_, stem) in run_benchmarks.MODELS.items()}


def read_rows(path):
    """[iterations, success, objective] per seed from any of the three
    result formats (whitespace table with or without header)."""
    rows = []
    with open(path) as io:
        for line in io:
            m = re.split(r"\s+", line.strip())
            if len(m) < 5 or not m[0].isdigit():
                continue
            rows.append((int(m[1]), m[2] == "true", float(m[3])))
    return rows


def sources(problem, ours=OURS, ref=None):
    """label -> path of each table of `problem` that exists."""
    out = {}
    candidates = [("ipddp2tpu_torch", Path(ours) / f"{problem}.txt"),
                  ("ipddp2tpu (JAX)",
                   run_benchmarks.RESULTS / f"{problem}.txt")]
    if ref:
        candidates += [(label, Path(ref) / "experiments" / sub / "results"
                        / f"{problem}.txt")
                       for label, sub in REFERENCE.items()]
    for label, path in candidates:
        if path.exists():
            out[label] = path
    return out


def _quartiles(values):
    if not values:
        return None
    return tuple(float(q) for q in np.percentile(values, [25, 50, 75]))


def summary(problem, ours=OURS, ref=None):
    """label -> dict(solved, total, iterations, objective) of each source
    of `problem`: iterations and objective as (25 %, median, 75 %) over the
    solved seeds (None if none solved)."""
    out = {}
    for label, path in sources(problem, ours, ref).items():
        rows = read_rows(path)
        solved = [r for r in rows if r[1]]
        out[label] = dict(
            solved=len(solved), total=len(rows),
            iterations=_quartiles([r[0] for r in solved]),
            objective=_quartiles([r[2] for r in solved]))
    return out


def plot(problem, ours=OURS, ref=None, out=OUT) -> Path:
    """The JAX script's boxplots of `problem` into
    `<out>/dist_<problem>.png`."""
    plt = pyplot()
    data = {label: read_rows(path)
            for label, path in sources(problem, ours, ref).items()}
    fig, axes = plt.subplots(1, 2, figsize=(10, 4.2))
    names = list(data)
    for ax, field, label in ((axes[0], 0, "iterations"),
                             (axes[1], 2, "objective")):
        vals = [[r[field] for r in data[n] if r[1]] for n in names]
        ax.boxplot(vals, tick_labels=[
            f"{n}\n({sum(r[1] for r in data[n])}/{len(data[n])})"
            for n in names], showfliers=True)
        ax.set_ylabel(label)
        if field == 2 and problem.startswith("pushing"):
            ax.set_yscale("log")
    fig.suptitle(f"{problem}: converged-seed distributions "
                 "(x-labels: solved/total)")
    fig.tight_layout()
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"dist_{problem}.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("problems", nargs="*", default=PROBLEMS)
    ap.add_argument("--ours", default=OURS,
                    help="directory of run_benchmarks' results tables")
    ap.add_argument("--ref", default=os.environ.get("REF"),
                    help="the reference's checkout (default: $REF)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where a missing table of ours is solved")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--no-draw", action="store_true",
                    help="print the summaries only")
    args = ap.parse_args(argv)
    unknown = [p for p in args.problems if p not in CAMPAIGN]
    if unknown:
        ap.error(f"unknown problem(s) {unknown}; expected {PROBLEMS}")
    device = resolve_device(args.device)
    if not args.no_draw:
        pyplot()
    for problem in args.problems:
        if not (Path(args.ours) / f"{problem}.txt").exists():
            run_benchmarks.main([CAMPAIGN[problem], "--device", device.type,
                                 "--out", args.ours])
        for label, s in summary(problem, args.ours, args.ref).items():
            med = lambda q: "-" if q is None else f"{q[1]:.6g}"
            print(f"{problem} {label}: {s['solved']}/{s['total']} solved, "
                  f"median iterations {med(s['iterations'])}, median "
                  f"objective {med(s['objective'])}", flush=True)
        if not args.no_draw:
            print("wrote", plot(problem, args.ours, args.ref, args.out),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
