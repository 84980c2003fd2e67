"""The control of a cell's correctness check: the program itself, run in
float32, the nearest precision below the float64 that the configurations
state, on the cell's traffic at the cell's batch, and judged as a run is.
Its readings set the upper end of each limit; the benchmark's own runs do
not run it.

    python3 benchmark/control.py --workload <name> --seeds 101 102 103

For every seed: set-up as a run (float32 inputs), one solve of the cell's
first batch with the cell's options, then the judge against the float64
reference on the float64 instances. Prints one JSON line a seed with the
readings, the verdict and the seconds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import harness  # noqa: E402
from devicetrace import IterationLog  # noqa: E402


def control_run(workload, seed, device, traffic_changes=None, options=None,
                dtype=torch.float32):
    """One seed of the control: (correct, checks, batch record).
    `workload` is a cell's name, or a (configuration, mix) pair of names;
    `options` maps the cell's options to others and `dtype` replaces
    float32, for the tests."""
    t0 = time.perf_counter()
    kw = dict(dtype=dtype, traffic_changes=traffic_changes)
    ctx = (harness.context(workload, seed, 0.0, False, device, **kw)
           if isinstance(workload, str) else
           harness.context_for(*workload, seed, 0.0, False, device, **kw))
    ctx.driver.setup(ctx)
    if options is not None:
        ctx.options = options(ctx.options)
    problem, bounds, x1, u0, theta = ctx.inputs
    log = IterationLog()
    t1 = time.perf_counter()
    sol = ctx.solve(problem, bounds, x1, u0, theta=theta,
                    options=ctx.options, device=ctx.device, trace=log)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    record = {"index": 0, "seconds": time.perf_counter() - t1, "log": log,
              "solution": sol}
    correct, checks, _ = harness.judged(ctx, [record])
    return correct, checks, {
        "lanes": int(sol.converged.shape[0]),
        "lockstep_iterations": len(log),
        "converged": int(sol.converged.sum()),
        "status_counts": {str(k): int((sol.status == k).sum())
                          for k in sol.status.unique().tolist()},
        "solve_s": record["seconds"],
        "run_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        correct, checks, rec = control_run(args.workload, seed, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": "float32", "correct": correct,
                          "checks": checks, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
