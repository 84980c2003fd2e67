"""The benchmark of ipddp2tpu_torch: one cell of `BENCHMARK.json` for one
seed, from set-up to the result line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by name:

    configs/<config>.json       sizes, options, instance ranges, limits
    instances/<config>.py       draw(cfg, n, generator): the instances
    reference/<config>.py       the configuration's equations, plain torch
    traffic/<mix>.json          the mix: batch size, line search
    drivers/<driver>.py         setup(ctx), window(ctx): the loop of a mix
    metrics/<metric>.py         read(run) -> number or None

A run: set-up (the program imported, the instances drawn, a warm-up at the
cell's shapes), the window (whole batches, timed by the host's clock, a
slice of it profiled with `--trace 1`), then, with the window closed and
its peak memory read, every returned instance judged against the plain
reference (`judge.py`), the metrics read, and the result printed.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import devicetrace
import judge

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ipddp2tpu")


def load(kind, name):
    """The module `<kind>/<name>.py` of the benchmark."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench, workload):
    """(the cell's entry, its configuration, its traffic mix)."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    return entry, cfg, load_json("traffic", entry["traffic"])


def forbidden_modules():
    """The JAX side's top-level modules that this process holds, compared
    by whole top-level name (`ipddp2tpu_torch` is not `ipddp2tpu`)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info():
    """The card's name, power limit and SM clocks as nvidia-smi reads them."""
    keys = ("name", "power.limit", "clocks.sm", "clocks.max.sm")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"nvidia_smi": f"not read: {e}"}
    return dict(zip(keys, (v.strip() for v in out.split(","))))


def context(workload, seed, seconds, trace, device, **kw):
    """Everything a run of a cell needs before set-up (see `context_for`)."""
    entry, cfg, traffic = cell(benchmark(), workload)
    return context_for(cfg, traffic, seed, seconds, trace, device,
                       workload=workload, entry=entry, **kw)


def context_for(cfg, traffic, seed, seconds, trace, device, workload=None,
                entry=None, dtype=None, solve=None, traffic_changes=None):
    """Everything a run needs before set-up, from a configuration and a mix
    (dicts, or names of their files). `dtype` (default: the
    configuration's), `solve` (default: `solve_batch`) and
    `traffic_changes` are for the control and the tests."""
    cfg = load_json("configs", cfg) if isinstance(cfg, str) else cfg
    traffic = dict(load_json("traffic", traffic)
                   if isinstance(traffic, str) else traffic)
    traffic.update(traffic_changes or {})
    if solve is None:
        from ipddp2tpu_torch.batch import solve_batch as solve
    model = importlib.import_module(
        f"ipddp2tpu_torch.models.{cfg['port_model']}")
    return SimpleNamespace(
        workload=workload, entry=entry, cfg=cfg, traffic=traffic,
        seed=seed, seconds=seconds, trace=trace,
        device=torch.device(device), solve=solve, model=model,
        dtype=dtype or getattr(torch, cfg["dtype"]),
        instances=load("instances", cfg["name"]),
        reference=load("reference", cfg["name"]),
        driver=load("drivers", traffic["driver"]))


def judged(ctx, records):
    """Every returned instance against the reference: (correct, checks,
    per-lane readings of each batch)."""
    per_lane = []
    for r in records:
        inst = judge.map_instances(ctx.batches_in[r["index"]],
                                   lambda a: a.to(ctx.device))
        sol = {k: getattr(r["solution"], k)
               for k in ("x", "u", "phi", "zl", "zu", "lam", "objective",
                         "status", "converged", "mu")}
        per_lane.append(judge.judge(ctx.reference, ctx.cfg, inst, sol))
    correct, checks = judge.verdict(judge.readings(per_lane), ctx.cfg)
    return correct, checks, per_lane


def traced(log):
    """The device slice's summary, with the idle gaps named from the host
    slice; None if no device slice was profiled."""
    got = {kind: devicetrace.summarize(
        devicetrace.profiled_events(d["prof"]), d["iterations"])
        for kind, d in log.done.items() if kind != "warmup"}
    if "device" not in got:
        return None
    summary = got["device"]
    if "host" in got:
        summary["idle_gaps"] = got["host"]["idle_gaps"]
    return summary


def iteration_ms(log):
    """10th, 50th and 90th percentiles of the host's milliseconds between
    consecutive lockstep iterations of a batch."""
    gaps = [1e3 * (b - a) for a, b in zip(log.times, log.times[1:])]
    if len(gaps) < 2:
        return []
    return [float(q) for q in torch.tensor(gaps, dtype=torch.float64)
            .quantile(torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64))]


def run_cell(ctx, t_start):
    """Set-up, window, judgement; returns the run's record."""
    ctx.driver.setup(ctx)
    ctx.setup_s = time.perf_counter() - t_start
    records = ctx.driver.window(ctx)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    summary = traced(records[0]["log"]) if ctx.trace else None
    batches = []
    profiled = False
    for r in records:
        sol, log = r["solution"], r["log"]
        clean_s, clean_n = (0.0, 0) if profiled else log.before_profiling()
        profiled = profiled or bool(log.slices)
        solved = sol.converged & (sol.status == 0)
        batches.append({
            "batch": r["index"], "lanes": int(sol.converged.shape[0]),
            "seconds": r["seconds"], "lockstep_iterations": len(log),
            "stepped": log.stepped_total(),
            "max_iterations": int(sol.iterations.max()),
            "iterations_sum": int(sol.iterations.sum()),
            "iterations_quantiles": [
                float(q) for q in sol.iterations.double().quantile(
                    torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                 device=sol.iterations.device))],
            "solved": int(solved.sum()),
            "iteration_ms_quantiles": iteration_ms(log),
            "unprofiled_s": clean_s, "unprofiled_iterations": clean_n})
    ctx.inputs = None
    if cuda:
        torch.cuda.empty_cache()
    correct, checks, per_lane = judged(ctx, records)
    agreement = claims(records, per_lane)
    attempted = sum(b["lanes"] for b in batches)
    solved = sum(b["solved"] for b in batches)
    run = SimpleNamespace(
        cfg=ctx.cfg, traffic=ctx.traffic, setup_s=ctx.setup_s,
        options=ctx.options, window_s=ctx.window_s, batches=batches,
        attempted=attempted, solved=solved, trace=summary)
    return SimpleNamespace(correct=correct, checks=checks, run=run,
                           attempted=attempted, failed=attempted - solved,
                           memory_peak_bytes=peak, trace=summary,
                           agreement=agreement)


def claims(records, per_lane):
    """How the reference's optimality error of the solved lanes compares
    with the program's own (the largest of its primal, dual and
    complementarity errors): the largest of each and the extremes of
    their ratio."""
    ref, own = [], []
    for r, p in zip(records, per_lane):
        sol = r["solution"]
        err = torch.stack([sol.primal_inf, sol.dual_inf, sol.cs_inf],
                          dim=1).amax(dim=1).double().cpu()
        own.append(err[p["solved"]])
        ref.append(p["kkt"][p["solved"]])
    ref, own = torch.cat(ref), torch.cat(own)
    if ref.numel() == 0:
        return {}
    ratio = ref / own.clamp(min=1e-300)
    return {"kkt_max": float(ref.max()), "program_kkt_max": float(own.max()),
            "ratio_min": float(ratio.min()), "ratio_max": float(ratio.max())}


def metrics_of(bench, workload, run, per_layer):
    """{name: {value, unit}} of the cell's end-to-end metrics, or with
    `per_layer` of its per-layer ones; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for m in bench["per_layer" if per_layer else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    bench = benchmark()
    entry, _, _ = cell(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"benchmark: {entry['chips']} CUDA device(s) needed, {found} "
              "found; no result", file=sys.stderr)
        return 2
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda:0")
    print(json.dumps({"card": card_info(),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    out = run_cell(ctx, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}, which the port's "
              "benchmark may not load; no result", file=sys.stderr)
        return 3
    for b in out.run.batches:
        print(json.dumps(b), flush=True)
    print(json.dumps({"optimality_error": out.agreement}), flush=True)
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed,
              "metrics": metrics_of(bench, args.workload, out.run,
                                    bool(args.trace)),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": 1,
                         "memory_peak_bytes": out.memory_peak_bytes}}
    if args.trace:
        tr = out.trace or {"busy_s": 0.0, "window_s": 0.0,
                           "device_ops": [], "idle_gaps": []}
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = out.checks
    for name, c in out.checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} against the limit "
              f"{c['limit']!r}: {verdict}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
