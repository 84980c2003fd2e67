"""Where the backward-sweep kernel spends its cycles.

    python3 -m ipddp2tpu_torch.ops.profile_sweep [--batch 2048] [--dtype f64]
        [--zeros 0.7] [--define SWEEP_UNROLL=1 ...]

Builds the kernel, runs it on random well-conditioned concar-sized inputs on
the GPU, and prints one JSON line per variant and round: the kernel's time
per launch (CUDA events), its launch geometry, and the clock cycles that the
first warp of each block spent in each section of the stage loop (assemble,
factor, solve, gains, value), as the kernel's `prof` counters report them.
`--zeros F` makes a share F of the entries of fu, cu and the off-diagonal of
luu structural zeros and all but two controls unbounded, as concar's
matrices are. Each `--define` names a variant of the source (`-D` flags,
comma separated) that is built beside the usual library and timed in turns
with it, twice, inside this one process: times of two calls on two machines
do not compare.

`crafted_inputs` makes the small batch on which a pivot search can go wrong
(exact ties, a NaN diagonal, an exact zero pivot); the CPU tests run the
plain sweep on it and `chip_smoke.py` the kernel.
"""

import argparse
import json
import subprocess

import torch

from .backward_cuda import (backward_sweep_cuda, launch_geometry,
                            use_variant)

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


CRAFTED_LANES = ("plain", "tie", "nan_diagonal", "zero_pivot",
                 "zero_pivot_delta_c", "zero_row_regularized")


def crafted_inputs(nx, nu, nc, dtype, device, T=4, seed=0):
    """Six lanes, named by `CRAFTED_LANES`, on which a pivot search spread
    over lanes can go wrong. Returns the sweep's 21 arguments.

    tie: the control Hessian block of K is exactly diag(3, 5, 5, 2, 2, ..)
      plus nothing (fu = 0, no duals): the two largest diagonal entries are
      equal and the first must be taken.
    nan_diagonal: a NaN on the diagonal of luu at stage 1: the lane fails,
      not as singular.
    zero_pivot: the last control's row of K is exactly zero (reg = 0), so
      the last pivot is an exact zero: `fail` and `singular`;
      zero_pivot_delta_c the same with delta_c = 1e-8, which only touches
      the constraint block; zero_row_regularized the same with reg = 1e-3,
      which makes the pivot 1e-3 and the lane pass.
    """
    args = random_inputs(len(CRAFTED_LANES), T, nx, nu, nc, torch.float64,
                         "cpu", seed=seed)
    fu, luu, cu, zl, zu = args[1], args[6], args[8], args[14], args[15]
    reg, dc = args[19], args[20]
    lane = {name: i for i, name in enumerate(CRAFTED_LANES)}
    if nu >= 2:
        i = lane["tie"]
        fu[i], zl[i], zu[i] = 0.0, 0.0, 0.0
        luu[i] = torch.diag(torch.tensor(
            ([3.0, 5.0, 5.0] + [2.0] * nu)[:nu], dtype=torch.float64))
    luu[lane["nan_diagonal"], min(1, T - 1), 0, 0] = float("nan")
    for name in ("zero_pivot", "zero_pivot_delta_c", "zero_row_regularized"):
        i = lane[name]
        luu[i, :, nu - 1, :] = 0.0
        luu[i, :, :, nu - 1] = 0.0
        fu[i, :, :, nu - 1] = 0.0
        cu[i, :, :, nu - 1] = 0.0
        zl[i, :, nu - 1] = 0.0
        zu[i, :, nu - 1] = 0.0
    dc[lane["zero_pivot_delta_c"]] = 1e-8
    reg[lane["zero_row_regularized"]] = 1e-3
    return [a.to(device=device, dtype=dtype).contiguous() for a in args]


def with_zeros(args, share, nu, seed=1):
    """A share of the entries of fu, cu and the off-diagonal of luu set to
    structural zeros (the same pattern at every stage and lane), and every
    control but the first two without bounds."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    args = [a.clone() for a in args]
    for i in (1, 8):
        mask = torch.rand(args[i].shape[2:], generator=g) < share
        args[i][:, :, mask.to(args[i].device)] = 0
    mask = torch.rand(nu, nu, generator=g) < share
    mask = (mask | mask.T) & ~torch.eye(nu, dtype=torch.bool)
    args[6][:, :, mask.to(args[6].device)] = 0
    args[11][:, :, 2:] = float("inf")
    args[12][:, :, 2:] = float("inf")
    return args


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--zeros", type=float, default=0.0)
    ap.add_argument("--define", action="append", default=[])
    a = ap.parse_args()
    dtype = {"f32": torch.float32, "f64": torch.float64}[a.dtype]
    dev = torch.device("cuda")
    shape = dict(nx=4, nu=10, nc=4)
    dims = dict(shape, refine=1, rtol=1e-6)
    args = random_inputs(a.batch, a.horizon, 4, 10, 4, dtype, dev)
    if a.zeros:
        args = with_zeros(args, a.zeros, shape["nu"])
    run = lambda prof=None: backward_sweep_cuda(*args, **dims, profile=prof)
    geo = launch_geometry(**shape)
    blocks = -(-a.batch // geo.instances_per_block)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    variants = [()] + [tuple(d.split(",")) for d in a.define]
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rnd in range(2 if a.define else 1):
        for defines in variants:
            use_variant(**shape, defines=defines)
            for _ in range(3):           # warm-up: clocks, first launch
                out = run()
            torch.cuda.synchronize()
            start.record()
            for _ in range(a.reps):
                run()
            stop.record()
            torch.cuda.synchronize()
            prof = torch.zeros(len(SECTIONS), dtype=torch.int64, device=dev)
            run(prof)
            torch.cuda.synchronize()
            cycles = prof.tolist()
            print(json.dumps(dict(
                card=smi, variant=list(defines), round=rnd, batch=a.batch,
                horizon=a.horizon, dtype=a.dtype, zeros=a.zeros,
                ms_per_launch=start.elapsed_time(stop) / a.reps,
                lanes_failing=int(out[2].sum()),
                lanes_per_instance=geo.lanes,
                instances_per_block=geo.instances_per_block, blocks=blocks,
                smem_bytes_per_block=geo.smem_bytes[dtype],
                cycle_share={k: c / max(sum(cycles), 1)
                             for k, c in zip(SECTIONS, cycles)},
                cycles_per_stage_per_block={
                    k: c / (a.horizon * blocks)
                    for k, c in zip(SECTIONS, cycles)})), flush=True)


if __name__ == "__main__":
    main()
