"""Where the backward-sweep kernel spends its cycles.

    python3 -m ipddp2tpu_torch.ops.profile_sweep [--batch 2048] [--dtype f64]
        [--inertia ldl|bk] [--model concar|acrobot|pushing|cartpole]
        [--zeros 0.7] [--define SWEEP_UNROLL=1 ...] [--warps 1,2,4]

Builds the kernel, runs it on the GPU, and prints one JSON line per variant
and round: the kernel's time per launch (CUDA events), its launch geometry,
and the clock cycles that the first warp of each block spent in each
section of the stage loop (assemble, factor, solve, gains, value), as the
kernel's `prof` counters report them. `--inertia` names the instantiation
(LDL^T or Bunch-Kaufman). `--model concar` (the default) takes random
well-conditioned inputs at concar's dimensions, and `--zeros F` makes a
share F of the entries of fu, cu and the off-diagonal of luu structural
zeros and all but two controls unbounded, as concar's matrices are; a
contact model takes its dimensions and its 100 campaign instances after 10
iterations of the solver, as `chip_smoke.py` holds the kernels on them
(`model_inputs`). Each `--define` names a variant of the source (`-D`
flags, comma separated) and each `--warps` value a number of warps an
instance (m > 32); variants are built beside the usual library and timed
in turns with it, twice, inside this one process: times of two calls on
two machines do not compare. `--define SWEEP_PROF_FINE=1` builds the
Bunch-Kaufman or wide kernel with its counters on the steps of the
factorization instead (column search, rook trips, interchanges,
multipliers, trailing update; the other sections uncounted, every counter
read costing its own clocks).

`crafted_inputs` makes the small batch on which a pivot search can go wrong
(exact ties, a NaN diagonal, an exact zero pivot), `crafted_bk_inputs` two
lanes for the Bunch-Kaufman search (a rook chain of several trips, a tie in
the column search); the CPU tests run the plain sweep on them and
`chip_smoke.py` the kernels.
"""

import argparse
import importlib
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


CRAFTED_BK_LANES = ("rook_chain", "column_tie")


def crafted_bk_inputs(nx, nu, nc, dtype, device, T=4, seed=0):
    """Two lanes, named by `CRAFTED_BK_LANES`, for the Bunch-Kaufman pivot
    search; both pass at every stage. Returns the sweep's 21 arguments.

    With fu = 0, no duals and no second-order term the stage's KKT matrix
    is exactly [[luu, cu^T], [cu, 0]]. cu is the first nc unit rows, so the
    inertia is right whenever luu is positive definite on the last nu - nc
    controls (the identity there); the first controls are free to be
    indefinite (needs nc >= 3 and nu > nc).

    rook_chain: luu's first min(nc, 5) controls a tridiagonal chain,
      diagonal 1.1 * 4^i, off-diagonal 2 * 4^i: column 0's arg-max is row
      1, whose arg-max is row 2, and so on; the search walks every row of
      the chain before a 1x1 pivot ends it.
    column_tie: |luu[1, 0]| == |luu[2, 0]| (-1 and 1) above alpha |luu[0,
      0]|: the column search must take row 1, the lower index.
    """
    assert nc >= 3 and nu > nc, (nu, nc)
    args = random_inputs(len(CRAFTED_BK_LANES), T, nx, nu, nc,
                         torch.float64, "cpu", seed=seed)
    fu, luu, cu, zl, zu = args[1], args[6], args[8], args[14], args[15]
    fu.zero_()
    zl.zero_()
    zu.zero_()
    cu.zero_()
    cu[:, :, torch.arange(nc), torch.arange(nc)] = 1.0
    eye = torch.eye(nu, dtype=torch.float64)
    chain = eye.clone()
    n = min(nc, 5)
    for i in range(n):
        chain[i, i] = 1.1 * 4.0 ** i
        if i + 1 < n:
            chain[i, i + 1] = chain[i + 1, i] = 2.0 * 4.0 ** i
    tie = eye.clone()
    tie[0, 0] = 0.1
    tie[1, 0], tie[0, 1] = -1.0, -1.0
    tie[2, 0], tie[0, 2] = 1.0, 1.0
    tie[1, 1] = tie[2, 2] = 5.0
    luu[0] = chain
    luu[1] = tie
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


def sweep_inputs(problem, theta, s):
    """The 21 tensors one backward sweep reads, as the solver's iteration
    prepares them from a state; reg is the one the state last passed with."""
    from ..backward import costate_scan
    from ..derivatives import (contract_dynamics_hessian,
                               evaluate_derivatives, relax_constraints)
    deriv = evaluate_derivatives(problem, theta, s.x, s.u, s.phi)
    c_rel = relax_constraints(problem, s.c_raw, s.mu)
    lam = costate_scan(deriv, s.phi)
    sec = deriv.cH_phi + contract_dynamics_hessian(
        problem, theta, s.x, s.u, lam[:, 1:])
    reg = torch.zeros_like(s.mu) if s.reg_last is None else s.reg_last
    return [deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
            deriv.luu, deriv.cx, deriv.cu, sec, c_rel, s.il, s.iu, s.phi,
            s.zl, s.zu, deriv.lTx, deriv.lTxx, s.mu, reg,
            torch.zeros_like(s.mu)]


def perturb(args, nu):
    """Vary (reg, delta_c) over the lanes and make every 16th lane's control
    Hessian indefinite, so that the inertia test fails there."""
    args = [a.contiguous().clone() for a in args]
    B = args[18].shape[0]
    lane = torch.arange(B, device=args[0].device)
    args[6][lane % 16 == 3] -= 50.0 * torch.eye(
        nu, dtype=args[6].dtype, device=args[6].device)
    args[19] = torch.where(lane % 4 == 1, 8.0 * args[19] + 1e-3, args[19])
    args[20] = torch.where(lane % 8 == 2, 1e-8, 0.0).to(args[18].dtype)
    return args


def mid_state(problem, theta, bounds, x1, u0, iters, device=None):
    """A mid-solve state (non-uniform duals) after `iters` iterations of
    the default options (on the card unless `device` says otherwise)."""
    from ..options import Options
    from ..solve import initialize, iteration
    opts = Options(optimality_tolerance=1e-7)
    s = initialize(problem, theta, bounds, x1, u0, opts, device=device)
    for _ in range(iters):
        s = iteration(problem, bounds, s, theta, opts, device=device)
    return s


# the models whose campaign states `model_inputs` makes
MODELS = ("acrobot", "pushing", "cartpole")


def model_mid_state(name, device, iterations=10):
    """(problem, theta, state) of a model's campaign instances (every row
    of its `experiments/params` file) after `iterations` iterations, in
    float64."""
    from .. import convert
    mod = importlib.import_module(f"ipddp2tpu_torch.models.{name}")
    problem = mod.problem()
    theta, bounds, x1, u0 = mod.from_params(
        convert.params_rows(mod.PARAMS), torch.float64, device)
    return problem, theta, mid_state(problem, theta, bounds, x1, u0,
                                     iterations, device)


def model_inputs(problem, theta, state, dtype, regularize=False):
    """The sweep's 21 arguments on a mid-solve state in `dtype`, perturbed
    (`perturb`); with `regularize` a quarter of the lanes are regularized
    well into the right inertia besides, so that the LDL^T sweep passes
    lanes of a contact model too (whose KKT matrices are indefinite)."""
    from ..mixed import _cast_state
    args = perturb(sweep_inputs(problem, _cast_state(theta, dtype),
                                _cast_state(state, dtype)), problem.nu)
    if regularize:
        lane = torch.arange(args[19].shape[0], device=args[19].device)
        args[19] = torch.where(lane % 4 == 1, args[19] + 1.0, args[19])
    return args


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="lanes (default 2048; a model's 100 instances, "
                         "repeated or cut to this many)")
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    ap.add_argument("--inertia", choices=("ldl", "bk"), default="ldl")
    ap.add_argument("--model", choices=("concar",) + MODELS,
                    default="concar")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--zeros", type=float, default=0.0)
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--warps", default="",
                    help="comma-separated warps an instance to time (m > 32)")
    a = ap.parse_args()
    dtype = {"f32": torch.float32, "f64": torch.float64}[a.dtype]
    dev = torch.device("cuda")
    if a.model == "concar":
        shape = dict(nx=4, nu=10, nc=4)
        batch = a.batch or 2048
        args = random_inputs(batch, a.horizon, 4, 10, 4, dtype, dev)
        if a.zeros:
            args = with_zeros(args, a.zeros, shape["nu"])
        horizon = a.horizon
    else:
        problem, theta, state = model_mid_state(a.model, dev)
        shape = dict(nx=problem.nx, nu=problem.nu, nc=problem.nc)
        args = model_inputs(problem, theta, state, dtype,
                            regularize=a.inertia == "ldl")
        batch = a.batch or args[18].shape[0]
        rep = -(-batch // args[18].shape[0])
        args = [torch.cat([x] * rep)[:batch].contiguous() for x in args]
        horizon = problem.T
    dims = dict(shape, refine=1, rtol=1e-6, inertia=a.inertia, atol=1e-12)
    run = lambda prof=None: backward_sweep_cuda(*args, **dims, profile=prof)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    variants = ([((), None)] + [(tuple(d.split(",")), None) for d in a.define]
                + [((), int(w)) for w in a.warps.split(",") if w])
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rnd in range(2 if len(variants) > 1 else 1):
        for defines, warps in variants:
            use_variant(**shape, defines=defines, inertia=a.inertia,
                        warps=warps)
            geo = launch_geometry(**shape, inertia=a.inertia, warps=warps)
            blocks = -(-batch // geo.instances_per_block)
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
                card=smi, model=a.model, inertia=a.inertia,
                variant=list(defines), warps=geo.lanes // 32, round=rnd,
                batch=batch, horizon=horizon, dtype=a.dtype, zeros=a.zeros,
                ms_per_launch=start.elapsed_time(stop) / a.reps,
                lanes_failing=int(out[2].sum()),
                lanes_per_instance=geo.lanes,
                instances_per_block=geo.instances_per_block, blocks=blocks,
                smem_bytes_per_block=geo.smem_bytes[dtype],
                cycle_share={k: c / max(sum(cycles), 1)
                             for k, c in zip(SECTIONS, cycles)},
                cycles_per_stage_per_block={
                    k: c / (horizon * blocks)
                    for k, c in zip(SECTIONS, cycles)})), flush=True)


if __name__ == "__main__":
    main()
