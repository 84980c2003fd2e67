"""Compile `independent_check` logs into a markdown table (PyTorch port).

The port's own copy of `experiments/slsqp_table.py`: it parses the
per-instance lines that `ipddp2tpu_torch.experiments.independent_check`
prints (the JAX script's layout) and prints the cross-solver comparison
table (the reference's IPOPT-vs-IPDDP2 protocol,
experiments/ipopt/concar.jl, with scipy's SLSQP as the independent solver).

Usage:
    python3 -m ipddp2tpu_torch.experiments.slsqp_table LOG [LOG ...]
"""

from __future__ import annotations

import re
import sys

ROW = re.compile(
    r"(\w+) seed (\d+): ours=([\d.e+-]+)\s+slsqp\(cold\)=([\d.e+-]+) "
    r"\[(same basin|different local opt); (\d+) its, (\d+)s\]\s+"
    r"warm-start improvement=([\d.e+-]+)")
# contact problems run warm-start-only (cold dense NLP too large)
ROW_WARM = re.compile(
    r"(\w+) seed (\d+): ours=([\d.e+-]+)\s+"
    r"\(cold start skipped[^)]*\)\s+warm-start improvement=([\d.e+-]+)")
VIOLATED = "STATIONARITY VIOLATED"


def parse_line(line, source=""):
    """One per-instance line as a dict (problem, seed, ours, cold, same,
    improve, violated: the line's own verdict on its barrier gap, shard:
    `source`), or None."""
    m = ROW.search(line)
    if m:
        return {"problem": m.group(1), "seed": int(m.group(2)),
                "ours": float(m.group(3)), "cold": float(m.group(4)),
                "same": m.group(5) == "same basin",
                "its": int(m.group(6)), "wall_s": int(m.group(7)),
                "improve": float(m.group(8)), "violated": VIOLATED in line,
                "shard": source}
    m = ROW_WARM.search(line)
    if m:
        return {"problem": m.group(1), "seed": int(m.group(2)),
                "ours": float(m.group(3)), "cold": None, "same": None,
                "improve": float(m.group(4)), "violated": VIOLATED in line,
                "shard": source}
    return None


def parse(paths):
    """Every per-instance line of the logs `paths`."""
    rows = []
    for p in paths:
        with open(p) as fh:
            rows += [r for r in (parse_line(line, p) for line in fh) if r]
    return rows


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    rows = parse(paths)
    if not rows:
        print("no instances parsed")
        return 0
    print("| problem | shard/seed | ours | SLSQP cold | basin | "
          "ours better? | stationarity held |")
    print("|---|---|---|---|---|---|---|")
    held = same = better = ncold = 0
    for r in rows:
        h = r["improve"] <= 1e-4 + 1e-8
        held += h
        tag = r["shard"].split("shard")[-1].split(".")[0]
        if r["cold"] is None:
            print(f"| {r['problem']} | {tag}/{r['seed']} | {r['ours']:.6e} | "
                  f"(warm-only) | — | — | {'yes' if h else 'NO'} |")
            continue
        ncold += 1
        same += r["same"]
        better += r["ours"] <= r["cold"] + 1e-6
        print(f"| {r['problem']} | {tag}/{r['seed']} | {r['ours']:.6e} | "
              f"{r['cold']:.6e} | {'same' if r['same'] else 'different'} | "
              f"{'yes' if r['ours'] <= r['cold'] + 1e-6 else 'no'} | "
              f"{'yes' if h else 'NO'} |")
    n = len(rows)
    print(f"\n{n} instances ({ncold} cold): {held}/{n} stationarity "
          f"certificates held, {same}/{ncold} same basin, "
          f"ours <= SLSQP on {better}/{ncold}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
