"""Where the backward-sweep kernel spends its cycles.

    python3 -m ipddp2tpu_torch.ops.profile_sweep [--batch 2048] [--dtype f64]

Builds the kernel, runs it on random well-conditioned concar-sized inputs on
the GPU, and prints one JSON line: the kernel's time per launch (CUDA
events), and the share of clock cycles that lane 0 of each block spent in
each section of the stage loop (assemble, factor, solve, gains, value), as
the kernel's `prof` counters report them.
"""

import argparse
import json
import subprocess

import torch

from .backward_cuda import backward_sweep_cuda

SECTIONS = ("assemble", "factor", "solve", "gains", "value")


def random_inputs(B, T, nx, nu, nc, dtype, device, seed=0):
    """Inputs with SPD control Hessians and positive slacks and duals."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nz = nx + nu
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    u = lambda *s: torch.rand(s, generator=g, dtype=torch.float64)
    eye = torch.eye
    G = 0.3 * r(B, T, nu, nu)
    args = [
        eye(nx) + 0.05 * r(B, T, nx, nx), 0.1 * r(B, T, nx, nu),
        r(B, T, nx), r(B, T, nu),
        eye(nx) + 0 * r(B, T, nx, nx), 0.01 * r(B, T, nu, nx),
        G @ G.transpose(-1, -2) + eye(nu),
        r(B, T, nc, nx), r(B, T, nc, nu), 0 * r(B, T, nz, nz),
        0.1 * r(B, T, nc), 0.5 + u(B, T, nu), 0.5 + u(B, T, nu),
        r(B, T, nc), 0.1 + u(B, T, nu), 0.1 + u(B, T, nu),
        r(B, nx), eye(nx) + 0 * r(B, nx, nx),
        torch.full((B,), 0.1), torch.zeros(B), torch.zeros(B)]
    return [a.to(device=device, dtype=dtype).contiguous() for a in args]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    dtype = {"f32": torch.float32, "f64": torch.float64}[a.dtype]
    dev = torch.device("cuda")
    dims = dict(nx=4, nu=10, nc=4, refine=1, rtol=1e-6)
    args = random_inputs(a.batch, a.horizon, 4, 10, 4, dtype, dev)
    run = lambda prof=None: backward_sweep_cuda(*args, **dims, profile=prof)
    out = run()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(a.reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    prof = torch.zeros(len(SECTIONS), dtype=torch.int64, device=dev)
    run(prof)
    torch.cuda.synchronize()
    cycles = prof.tolist()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(dict(
        card=smi, batch=a.batch, horizon=a.horizon, dtype=a.dtype,
        ms_per_launch=start.elapsed_time(stop) / a.reps,
        lanes_failing=int(out[2].sum()),
        cycle_share={k: c / max(sum(cycles), 1)
                     for k, c in zip(SECTIONS, cycles)},
        cycles_per_stage_per_block={
            k: c / (a.horizon * ((a.batch + 31) // 32))
            for k, c in zip(SECTIONS, cycles)})))


if __name__ == "__main__":
    main()
