"""Derivative bundle evaluation (PyTorch port, batch-first).

Counterpart of `ipddp2tpu/derivatives.py`: `torch.func.jacfwd` / `grad`
composition of the user's stage functions, mapped with `torch.func.vmap`
over time and over problem instances. One call evaluates every
Jacobian/Hessian the backward pass needs for a whole batch of trajectories.

Working variable: z = concat(x, u), so each stage's second-order data is one
dense [nz, nz] block that the backward pass slices.

The dynamics second-order term `lam . d2f` needs the costate, which the
affine costate recursion delivers before the sweep; it is contracted here,
vectorized over (B, T), as the Hessian of the scalar z -> <lam, f(z)>
(`contract_dynamics_hessian`), and the full [nx, nz, nz] tensor is only built
on request. The constraint contraction uses the nominal equality duals phi
(reference: src/derivatives.jl:19-29).

The transformed closures are built once per `Problem` (an `lru_cache` keyed
on the frozen dataclass), not once per iteration.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch
from torch.func import grad, jacfwd, vmap

from .problem import Problem

Tensor = torch.Tensor


class DerivativeBundle(NamedTuple):
    """All stagewise derivatives for a batch of trajectories."""

    fx: Tensor          # [B, T, nx, nx]
    fu: Tensor          # [B, T, nx, nu]
    fH: Optional[Tensor]   # [B, T, nx, nz, nz] dynamics Hessians (on request)
    lx: Tensor          # [B, T, nx]
    lu: Tensor          # [B, T, nu]
    lxx: Tensor         # [B, T, nx, nx]
    lux: Tensor         # [B, T, nu, nx]
    luu: Tensor         # [B, T, nu, nu]
    cx: Tensor          # [B, T, nc, nx]
    cu: Tensor          # [B, T, nc, nu]
    cH_phi: Optional[Tensor]  # [B, T, nz, nz] phi-contracted constraint Hessians
    lTx: Tensor         # [B, nx]     terminal cost gradient
    lTxx: Tensor        # [B, nx, nx] terminal cost Hessian


def _as_dtype(out, dtype):
    """Outputs in the dtype of the inputs. Forward-mode tangents of 0-dim
    tensors scaled by Python floats (`0.1 * x[1]`) come out as float64
    whatever the primal's dtype, so a float32 solve would otherwise pick up
    float64 Jacobians from such a model."""
    if isinstance(out, tuple):
        return tuple(_as_dtype(o, dtype) for o in out)
    return out.to(dtype)


def _over_batch_time(fn, n_stage_args: int):
    """Map fn(*stage_args, t, theta) over time (inner) and instances (outer).
    Stage args carry [B, T, ...]; t is [T]; theta leaves carry [B, ...]."""
    inner = vmap(fn, in_dims=(0,) * n_stage_args + (0, None))

    def call(*args):
        *stage_args, ts, theta = args
        th_dim = None if theta is None else 0
        outer = vmap(inner, in_dims=(0,) * n_stage_args + (None, th_dim))
        return _as_dtype(outer(*stage_args, ts, theta), stage_args[0].dtype)

    return call


@lru_cache(maxsize=64)
def _closures(problem: Problem):
    """All `torch.func` closures of one problem, built once."""
    nx = problem.nx

    def zf(fn):
        return lambda z, t, theta: fn(z[:nx], z[nx:], t, theta)

    f = zf(problem.dynamics)
    l = zf(problem.stage_cost)
    c = zf(problem.eval_constraints)

    f_jac = jacfwd(f)
    l_grad = grad(l)
    l_hess = jacfwd(l_grad)
    c_jac = jacfwd(c)
    cphi = lambda z, t, theta, phi_t: (phi_t * c(z, t, theta)).sum()
    cphi_hess = jacfwd(grad(cphi))
    f_hess = jacfwd(f_jac)
    lamf = lambda z, t, theta, lam_n: (lam_n * f(z, t, theta)).sum()
    lamf_hess = jacfwd(grad(lamf))

    def first_order(z, t, theta):
        return f_jac(z, t, theta), l_grad(z, t, theta), l_hess(z, t, theta)

    lT = problem.terminal_cost
    lT_grad = grad(lT)

    def terminal(xT, theta):
        return lT_grad(xT, theta), jacfwd(lT_grad)(xT, theta)

    def step(x, u, t, theta):
        """dynamics(x [B,nx], u [B,nu], t scalar, theta) mapped over
        instances: one stage of a rollout."""
        th_dim = None if theta is None else 0
        return vmap(problem.dynamics, in_dims=(0, 0, None, th_dim))(
            x, u, t, theta)

    def over_batch(fn):
        def call(xT, theta):
            return _as_dtype(
                vmap(fn, in_dims=(0, None if theta is None else 0))(
                    xT, theta), xT.dtype)
        return call

    return dict(
        first_order=_over_batch_time(first_order, 1),
        c_jac=_over_batch_time(c_jac, 1),
        cphi_hess=_over_batch_time(
            lambda z, phi_t, t, theta: cphi_hess(z, t, theta, phi_t), 2),
        f_hess=_over_batch_time(f_hess, 1),
        lamf_hess=_over_batch_time(
            lambda z, lam_n, t, theta: lamf_hess(z, t, theta, lam_n), 2),
        stage_cost=_over_batch_time(problem.stage_cost, 2),
        constraints=_over_batch_time(problem.eval_constraints, 2),
        dynamics=step,
        terminal=over_batch(terminal),
        terminal_cost=over_batch(lT),
    )


def batched_dynamics(problem: Problem):
    """The instance-mapped dynamics step of `problem` (cached)."""
    return _closures(problem)["dynamics"]


def _stages(problem: Problem, x: Tensor, u: Tensor):
    T = problem.T
    z = torch.cat([x[:, :T], u], dim=-1)                 # [B, T, nz]
    ts = torch.arange(T, device=x.device)
    return z, ts


def evaluate_derivatives(
    problem: Problem,
    theta,
    x: Tensor,          # [B, T+1, nx] nominal states
    u: Tensor,          # [B, T, nu]  nominal controls
    phi: Tensor,        # [B, T, nc]  nominal equality duals (for cH contraction)
    *,
    quasi_newton: bool = False,
    with_dynamics_hessian: bool = False,
) -> DerivativeBundle:
    nx, nu, nc, T = problem.nx, problem.nu, problem.nc, problem.T
    nz = nx + nu
    B = x.shape[0]
    fns = _closures(problem)
    z, ts = _stages(problem, x, u)

    fj, lg, lH = fns["first_order"](z, ts, theta)
    cH_phi = None
    if nc > 0:
        cj = fns["c_jac"](z, ts, theta)
        cx, cu = cj[..., :nx], cj[..., nx:]
        if not quasi_newton:
            cH_phi = fns["cphi_hess"](z, phi, ts, theta)
    else:
        cx = z.new_zeros((B, T, 0, nx))
        cu = z.new_zeros((B, T, 0, nu))
        if not quasi_newton:
            cH_phi = z.new_zeros((B, T, nz, nz))

    fH = None
    if with_dynamics_hessian and not quasi_newton:
        # full [nx, nz, nz] tensor: only for tests/diagnostics — the solver
        # pre-contracts with the costate instead (contract_dynamics_hessian)
        fH = fns["f_hess"](z, ts, theta)

    lTx, lTxx = fns["terminal"](x[:, T], theta)

    return DerivativeBundle(
        fx=fj[..., :nx], fu=fj[..., nx:], fH=fH,
        lx=lg[..., :nx], lu=lg[..., nx:],
        lxx=lH[..., :nx, :nx], lux=lH[..., nx:, :nx], luu=lH[..., nx:, nx:],
        cx=cx, cu=cu, cH_phi=cH_phi, lTx=lTx, lTxx=lTxx,
    )


def contract_dynamics_hessian(problem: Problem, theta, x: Tensor, u: Tensor,
                              lam_next: Tensor) -> Tensor:
    """lam_{t+1} . d2f(z_t) as [B, T, nz, nz] — the Hessian of the scalar
    z -> <lam, f(z)> per stage, never materializing the full [nx, nz, nz]
    tensor (reference: src/dynamics.jl:29-31 builds the same contraction
    symbolically)."""
    z, ts = _stages(problem, x, u)
    return _closures(problem)["lamf_hess"](z, lam_next, ts, theta)


def evaluate_objective(problem: Problem, theta, x: Tensor, u: Tensor) -> Tensor:
    """Total objective J = sum_t l(x_t, u_t, t) + lT(x_T), [B]
    (reference: src/objectives.jl:37-46)."""
    T = problem.T
    fns = _closures(problem)
    ts = torch.arange(T, device=x.device)
    stage_vals = fns["stage_cost"](x[:, :T], u, ts, theta)       # [B, T]
    return stage_vals.sum(dim=1) + fns["terminal_cost"](x[:, T], theta)


def evaluate_constraints(problem: Problem, theta, x: Tensor,
                         u: Tensor) -> Tensor:
    """Raw (un-relaxed) stagewise equality constraints, [B, T, nc]. The
    mu-relaxation of complementarity rows is applied by the caller via
    `relax_constraints`, so the stored values stay mu-independent."""
    T = problem.T
    if problem.nc == 0:
        return x.new_zeros((x.shape[0], T, 0))
    ts = torch.arange(T, device=x.device)
    return _closures(problem)["constraints"](x[:, :T], u, ts, theta)


def relax_constraints(problem: Problem, c_raw: Tensor, mu) -> Tensor:
    """Apply c[i] -= mu on complementarity rows; mu is [B]
    (reference: src/data/methods.jl:27-29)."""
    if not problem.compl_indices:
        return c_raw
    mask = problem.compl_mask(c_raw.dtype, c_raw.device)
    return c_raw - torch.as_tensor(mu, dtype=c_raw.dtype,
                                   device=c_raw.device).reshape(-1, 1, 1) * mask
