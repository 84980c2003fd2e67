"""The port's backward pass against the full Newton-KKT system.

Port of tests/test_newton_equivalence.py onto
`ipddp2tpu_torch.backward.backward_pass`: IPDDP2's backward recursion is the
block elimination of the full primal-dual Newton system of the barrier
subproblem, so the gains, propagated through the linearized dynamics, must
reproduce the dense solve of that system assembled in numpy over all stages.
This needs no reference implementation and pins every sign and second-order
term of the plain sweep, which is what the GPU run holds the CUDA kernel
against. The problem's matrices are made with numpy from the seed; float64;
tolerance atol 1e-8 as in the JAX package's test."""

import numpy as np
import pytest
import torch

from ipddp2tpu_torch.backward import backward_pass
from ipddp2tpu_torch.derivatives import evaluate_derivatives
from ipddp2tpu_torch.options import Options
from ipddp2tpu_torch.problem import Problem

NX, NU, NC, T = 2, 3, 2, 4


def make_problem(seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a)
    A = t(0.3 * rng.standard_normal((NX, NX)))
    Bm = t(0.3 * rng.standard_normal((NX, NU)))
    W = t(rng.standard_normal((NC, NU)))
    V = t(rng.standard_normal((NC, NX)))
    # bilinear tensors: constraint and dynamics curvature are not zero
    G = t(0.3 * rng.standard_normal((NC, NU, NU)))
    Hx = t(0.3 * rng.standard_normal((NC, NX, NU)))
    Dxx = t(0.2 * rng.standard_normal((NX, NX, NX)))
    b = t(0.5 * rng.standard_normal((NC,)))

    def dynamics(x, u, t, theta):
        return A @ x + Bm @ u + 0.5 * torch.einsum("ijk,j,k->i", Dxx, x, x)

    def stage_cost(x, u, t, theta):
        return (2.0 * torch.dot(u, u) + 0.5 * torch.dot(x, x)
                + 0.2 * torch.dot(x, x) * u[0])

    def terminal_cost(x, theta):
        return 3.0 * torch.dot(x, x)

    def constraints(x, u, t, theta):
        return (W @ u + V @ x + b
                + 0.5 * torch.einsum("ijk,j,k->i", G, u, u)
                + torch.einsum("ijk,j,k->i", Hx, x, u))

    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints)


def make_state(seed, prob):
    """A strictly interior primal-dual point with a feasible rollout."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(0.3 * rng.standard_normal((T, NU)))
    xs = [torch.as_tensor(0.3 * rng.standard_normal((NX,)))]
    for t in range(T):
        xs.append(prob.dynamics(xs[t], u[t], t, None))
    x = torch.stack(xs)
    phi = torch.as_tensor(0.5 * rng.standard_normal((T, NC)))
    zl = torch.as_tensor(0.5 + rng.uniform(size=(T, NU)))
    zu = torch.as_tensor(0.5 + rng.uniform(size=(T, NU)))
    il = torch.as_tensor(0.5 + rng.uniform(size=(T, NU)))
    iu = torch.ones((T, NU), dtype=torch.float64)
    return x, u, phi, zl, zu, il, iu


def full_newton_step(deriv, c, il, iu, phi, zl, zu, mu):
    """Assemble and solve the full barrier-subproblem Newton system over the
    variables (du_t, dphi_t, dzl_t, dzu_t | dx_t | lam_t), all numpy."""
    nvar = T * (NU + NC + 2 * NU) + T * NX + T * NX
    iu_of = lambda t: t * NU
    iphi_of = lambda t: T * NU + t * NC
    izl_of = lambda t: T * (NU + NC) + t * NU
    izu_of = lambda t: T * (NU + NC + NU) + t * NU
    ix_of = lambda t: T * (NU + NC + 2 * NU) + (t - 1) * NX  # t = 1..T
    ilam_of = lambda t: T * (NU + NC + 2 * NU) + T * NX + (t - 1) * NX

    # The recursion contracts the second-order terms with the costate it
    # recomputes from the current iterate, so that costate is data here.
    lam_new = np.zeros((T + 1, NX))
    lam_new[T] = deriv["lTx"]
    for t in range(T - 1, -1, -1):
        lam_new[t] = (deriv["lx"][t] + deriv["cx"][t].T @ phi[t]
                      + deriv["fx"][t].T @ lam_new[t + 1])

    K = np.zeros((nvar, nvar))
    r = np.zeros(nvar)
    row = 0
    for t in range(T):
        fx, fu = deriv["fx"][t], deriv["fu"][t]
        cx, cu = deriv["cx"][t], deriv["cu"][t]
        fHl = np.einsum("i,ijk->jk", lam_new[t + 1], deriv["fH"][t])
        cH = deriv["cH_phi"][t]
        Hxx = deriv["lxx"][t] + fHl[:NX, :NX] + cH[:NX, :NX]
        Hux = deriv["lux"][t] + fHl[NX:, :NX] + cH[NX:, :NX]
        Huu = deriv["luu"][t] + fHl[NX:, NX:] + cH[NX:, NX:]

        # u-stationarity
        rows = slice(row, row + NU)
        K[rows, iu_of(t):iu_of(t) + NU] += Huu
        if t >= 1:
            K[rows, ix_of(t):ix_of(t) + NX] += Hux
        K[rows, iphi_of(t):iphi_of(t) + NC] += cu.T
        K[rows, ilam_of(t + 1):ilam_of(t + 1) + NX] += fu.T
        K[rows, izl_of(t):izl_of(t) + NU] -= np.eye(NU)
        K[rows, izu_of(t):izu_of(t) + NU] += np.eye(NU)
        r[rows] = -(deriv["lu"][t] + cu.T @ phi[t] - zl[t] + zu[t])
        row += NU
        # x-stationarity for t >= 1
        if t >= 1:
            rows = slice(row, row + NX)
            K[rows, iu_of(t):iu_of(t) + NU] += Hux.T
            K[rows, ix_of(t):ix_of(t) + NX] += Hxx
            K[rows, iphi_of(t):iphi_of(t) + NC] += cx.T
            K[rows, ilam_of(t + 1):ilam_of(t + 1) + NX] += fx.T
            K[rows, ilam_of(t):ilam_of(t) + NX] -= np.eye(NX)
            r[rows] = -(deriv["lx"][t] + cx.T @ phi[t])
            row += NX
        # constraints: cu du + cx dx = -c
        rows = slice(row, row + NC)
        K[rows, iu_of(t):iu_of(t) + NU] += cu
        if t >= 1:
            K[rows, ix_of(t):ix_of(t) + NX] += cx
        r[rows] = -c[t]
        row += NC
        # dynamics: fx dx + fu du - dx_{t+1} = 0
        rows = slice(row, row + NX)
        K[rows, iu_of(t):iu_of(t) + NU] += fu
        if t >= 1:
            K[rows, ix_of(t):ix_of(t) + NX] += fx
        K[rows, ix_of(t + 1):ix_of(t + 1) + NX] -= np.eye(NX)
        row += NX
        # complementarity
        rows = slice(row, row + NU)
        K[rows, iu_of(t):iu_of(t) + NU] += np.diag(zl[t])
        K[rows, izl_of(t):izl_of(t) + NU] += np.diag(il[t])
        r[rows] = mu - il[t] * zl[t]
        row += NU
        rows = slice(row, row + NU)
        K[rows, iu_of(t):iu_of(t) + NU] -= np.diag(zu[t])
        K[rows, izu_of(t):izu_of(t) + NU] += np.diag(iu[t])
        r[rows] = mu - iu[t] * zu[t]
        row += NU
    # terminal x-stationarity: lTxx dx_T - lam_T = -lTx
    rows = slice(row, row + NX)
    K[rows, ix_of(T):ix_of(T) + NX] += deriv["lTxx"]
    K[rows, ilam_of(T):ilam_of(T) + NX] -= np.eye(NX)
    r[rows] = -deriv["lTx"]
    row += NX
    assert row == nvar

    sol = np.linalg.solve(K, r)
    cut = np.cumsum([T * NU, T * NC, T * NU, T * NU, T * NX])
    du, dphi, dzl, dzu, dx = np.split(sol[:cut[-1]], cut[:-1])
    dx = np.concatenate([np.zeros((1, NX)), dx.reshape(T, NX)])
    return (du.reshape(T, NU), dphi.reshape(T, NC), dzl.reshape(T, NU),
            dzu.reshape(T, NU), dx)


@pytest.mark.parametrize("problem_seed,state_seed", [(0, 1), (7, 3)])
def test_gains_solve_full_newton_system(problem_seed, state_seed):
    prob = make_problem(problem_seed)
    x, u, phi, zl, zu, il, iu = make_state(state_seed, prob)
    mu = 0.1
    c = torch.stack([prob.constraints(x[t], u[t], t, None)
                     for t in range(T)])

    one = lambda a: a[None]                  # a batch of one instance
    deriv = evaluate_derivatives(prob, None, one(x), one(u), one(phi),
                                 with_dynamics_hessian=True)
    bw = backward_pass(
        prob, deriv, tuple(one(a) for a in (c, il, iu, phi, zl, zu)),
        torch.full((1,), mu, dtype=torch.float64),
        torch.zeros(1, dtype=torch.float64), Options(refine_steps=2))
    assert int(bw.status[0]) == 0
    assert float(bw.reg[0]) == 0.0, "test problem must not need regularization"

    d = {k: getattr(deriv, k)[0].numpy()
         for k in ("fx", "fu", "cx", "cu", "fH", "cH_phi", "lx", "lu", "lxx",
                   "lux", "luu", "lTx", "lTxx")}
    n = lambda a: a.numpy()
    du_ref, dphi_ref, dzl_ref, dzu_ref, dx_ref = full_newton_step(
        d, n(c), n(il), n(iu), n(phi), n(zl), n(zu), mu)

    # propagate the affine update rule through the linearized dynamics
    g = [a[0].numpy() for a in bw.gains]
    alpha, beta, psi, omega, chi_l, zeta_l, chi_u, zeta_u = g
    dx = np.zeros(NX)
    for t in range(T):
        du = alpha[t] + beta[t] @ dx
        for name, got, ref in (
                ("du", du, du_ref), ("dphi", psi[t] + omega[t] @ dx, dphi_ref),
                ("dzl", chi_l[t] + zeta_l[t] @ dx, dzl_ref),
                ("dzu", chi_u[t] + zeta_u[t] @ dx, dzu_ref)):
            np.testing.assert_allclose(got, ref[t], atol=1e-8,
                                       err_msg=f"{name} t={t}")
        dx = d["fx"][t] @ dx + d["fu"][t] @ du
        np.testing.assert_allclose(dx, dx_ref[t + 1], atol=1e-8,
                                   err_msg=f"dx t={t + 1}")
