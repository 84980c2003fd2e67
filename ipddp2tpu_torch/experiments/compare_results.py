"""Compare per-seed result tables against the reference's medians
(PyTorch port).

The port's own copy of `experiments/compare_results.py` (the analog of the
reference's result parser, experiments/utils.jl): it reads the tables that
`ipddp2tpu_torch.experiments.run_benchmarks` writes (JAX results format)
and sets each problem's solved count, median iterations and median
objective beside the reference's.

Usage:
    python3 -m ipddp2tpu_torch.experiments.compare_results [results_dir]

The default directory is `run_benchmarks_out` (`run_benchmarks`'s).
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

# Reference medians from its committed per-seed files (BASELINE.md).
REFERENCE = {
    "concar": dict(success=100, total=100, med_iters=148, med_obj=2.228),
    "concar_quad": dict(success=100, total=100, med_iters=98, med_obj=1.903),
    "cartpole_friction": dict(success=100, total=100, med_iters=66,
                              med_obj=0.920),
    "acrobot_contact": dict(success=100, total=100, med_iters=180,
                            med_obj=1.059),
    "pushing_1_obs": dict(success=98, total=100, med_iters=392,
                          med_obj=0.0329),
    "double_integrator": dict(success=1, total=1, med_iters=31,
                              med_obj=1.26574863),
}

ROW = re.compile(r"^\s*(\d+)\s+(\d+)\s+(true|false)\s+([\d.eE+-]+)"
                 r"\s+([\d.eE+-]+)")


def parse(path):
    """The rows of a results table: (seed, iterations, converged,
    objective, primal) each."""
    rows = []
    with open(path) as fh:
        for line in fh:
            m = ROW.match(line)
            if m:
                rows.append((int(m.group(1)), int(m.group(2)),
                             m.group(3) == "true", float(m.group(4)),
                             float(m.group(5))))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    results_dir = argv[0] if argv else "run_benchmarks_out"
    print(f"{'problem':20s} {'success':>12s} {'med iters':>16s} "
          f"{'med objective':>22s}")
    for name, ref in REFERENCE.items():
        path = os.path.join(results_dir, f"{name}.txt")
        if not os.path.exists(path):
            print(f"{name:20s} {'(no results file)':>12s}")
            continue
        rows = parse(path)
        conv = [r for r in rows if r[2]]
        med_it = np.median([r[1] for r in rows]) if rows else float("nan")
        med_obj = (np.median([r[3] for r in conv]) if conv
                   else float("nan"))
        d_it = 100.0 * (med_it - ref["med_iters"]) / ref["med_iters"]
        print(f"{name:20s} {len(conv):3d}/{len(rows):<3d} vs "
              f"{ref['success']}/{ref['total']:<4d}"
              f" {med_it:6.0f} vs {ref['med_iters']:<4d} ({d_it:+5.1f}%)"
              f" {med_obj:10.4f} vs {ref['med_obj']:<10.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
