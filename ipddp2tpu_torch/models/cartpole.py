"""Contact-implicit cartpole with joint friction.

Counterpart of `ipddp2tpu/models/cartpole.py`, the reference's
cartpole_friction benchmark (reference: experiments/ipddp2/
cartpole_friction.jl, model experiments/models/cartpole.jl): a cartpole
whose slider and hinge have Coulomb friction, discretized with an implicit
variational midpoint integrator. The next configuration q+ sits in the
control vector, the dynamics is the trivial shift x' = [q, q+], and the
integrator residual plus the friction complementarity system are stagewise
equalities with slack-smoothed complementarity (the sc slacks are pushed to
zero by a sum(sc) objective term).

    x = [q-, q] in R^4,  q = (cart position, pole angle)
    u = [F, q+, beta1(2), beta2(2), eta1(2), eta2(2), psi(2), s(2), sc(6)]
        in R^21
    nc = 14 equality rows, N = 101, dt = 0.05

theta = Theta(mc, mp, l, friction [2]) (reference:
experiments/ipddp2/cartpole_friction.jl:37-42). `contact=True`: the KKT size
m = nu + nc = 35 takes the Bunch-Kaufman sweep (the LDL^T kernel serves
m <= 32).

Golden seed-1 anchor: 60 iterations, objective 9.29397628e-01
(reference: experiments/ipddp2/results/cartpole_friction.txt:2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..problem import Bounds, Problem, uniform_bounds

NQ, NF, NCONTACT = 2, 1, 2
NX = 2 * NQ
NU = NF + NQ + 6 * NCONTACT + 6        # 21
NC = 2 * NQ + 4 * NCONTACT + 2         # 14
DT = 0.05
T = 100
GRAVITY = 9.81
FORCE_LIMIT = 10.0
Q_GOAL = (0.0, math.pi)
PARAMS = "cartpole_friction.txt"  # experiments/params: mc mp l friction(2)


class Theta(NamedTuple):
    mc: torch.Tensor          # cart mass
    mp: torch.Tensor          # pole point mass
    l: torch.Tensor           # pole length
    friction: torch.Tensor    # [2] slider / hinge friction coefficients


def _mv2(M, v):
    (a, b), (c, d) = M
    return torch.stack([a * v[0] + b * v[1], c * v[0] + d * v[1]])


def mass_matrix(theta: Theta, q):
    """(reference: experiments/models/cartpole.jl M_func), rows as pairs."""
    c = theta.mp * theta.l * torch.cos(q[1])
    return ((theta.mc + theta.mp, c), (c, theta.mp * theta.l ** 2))


def bias(theta: Theta, q, qd):
    """C(q, qd) qd - g(q) (reference: experiments/models/cartpole.jl C_func)"""
    coriolis0 = -theta.mp * qd[1] * theta.l * torch.sin(q[1]) * qd[1]
    gravity1 = -theta.mp * GRAVITY * theta.l * torch.sin(q[1])
    return torch.stack([coriolis0 - 0.0, 0.0 - gravity1])


def integrator_residual(theta: Theta, q_prev, q, q_next, force, lam):
    """Implicit variational midpoint residual
    (reference: experiments/models/cartpole.jl manipulator_fd)."""
    qm_minus = 0.5 * (q_prev + q)
    qm_plus = 0.5 * (q + q_next)
    qd_minus = (q - q_prev) / DT
    qd_plus = (q_next - q) / DT
    momentum = (_mv2(mass_matrix(theta, qm_plus), qd_plus)
                - _mv2(mass_matrix(theta, qm_minus), qd_minus))
    c_mid = 0.5 * (bias(theta, qm_plus, qd_plus)
                   + bias(theta, qm_minus, qd_minus))
    b_force = torch.stack([force, torch.zeros_like(force)])  # cart only
    return momentum + DT * (c_mid - b_force - lam)   # contact Jacobian = I


def dynamics(x, u, t, theta):
    """Trivial shift x' = [q, q+]
    (reference: experiments/ipddp2/cartpole_friction.jl:52)."""
    return torch.cat([x[NQ:], u[NF:NF + NQ]])


def stage_cost(x, u, t, theta):
    force = u[0]
    sc = u[15:21]
    return 0.01 * DT * force ** 2 + torch.sum(sc)


def terminal_cost(x, theta):
    q_prev, q = x[:NQ], x[NQ:]
    qd = (q - q_prev) / DT
    dq = q - torch.tensor(Q_GOAL, dtype=x.dtype, device=x.device)
    return 200.0 * torch.dot(qd, qd) + 700.0 * torch.dot(dq, dq)


def constraints(x, u, t, theta: Theta):
    """Friction-complementarity contact system, 14 rows
    (reference: experiments/models/cartpole.jl implicit_contact_dynamics_slack)."""
    q_prev, q = x[:NQ], x[NQ:]
    force, q_next = u[0], u[1:3]
    beta1, beta2 = u[3:5], u[5:7]
    eta1, eta2 = u[7:9], u[9:11]
    psi, s, sc = u[11:13], u[13:15], u[15:21]
    qd_plus = (q_next - q) / DT
    lam = torch.stack([beta1[0] - beta1[1], beta2[0] - beta2[1]])
    gamma1 = theta.friction[0] * (theta.mp + theta.mc) * GRAVITY
    gamma2 = theta.friction[1] * theta.mp * GRAVITY * theta.l
    return torch.cat([
        integrator_residual(theta, q_prev, q, q_next, force, lam),
        torch.stack([qd_plus[0], -qd_plus[0]]) + psi[0] - eta1,
        torch.stack([qd_plus[1], -qd_plus[1]]) + psi[1] - eta2,
        torch.stack([gamma1 - torch.sum(beta1) - s[0],
                     gamma2 - torch.sum(beta2) - s[1],
                     psi[0] * s[0] - sc[0],
                     psi[1] * s[1] - sc[1]]),
        beta1 * eta1 - sc[2:4],
        beta2 * eta2 - sc[4:6],
    ])


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints, contact=True,
                   device_model="cartpole")


def bounds(dtype=torch.float64, device=None) -> Bounds:
    """|F| <= 10, q+ free, all contact variables and slacks >= 0
    (reference: experiments/ipddp2/cartpole_friction.jl:86-90)."""
    inf = float("inf")
    lo = torch.tensor([-FORCE_LIMIT] + [-inf] * NQ
                      + [0.0] * (6 * NCONTACT + 6), dtype=dtype,
                      device=device)
    hi = torch.tensor([FORCE_LIMIT] + [inf] * (NU - NF), dtype=dtype,
                      device=device)
    return uniform_bounds(T, lo, hi)


def initial_state(dtype=torch.float64, device=None):
    return torch.zeros((NX,), dtype=dtype, device=device)


def initial_controls(dtype=torch.float64, device=None):
    u0 = torch.tensor([0.0] * (NF + NQ) + [0.01] * (6 * NCONTACT + 6),
                      dtype=dtype, device=device)
    return u0.expand(T, NU)


def from_params(rows, dtype=torch.float64, device=None):
    """Instances from rows of `experiments/params/cartpole_friction.txt`
    ([B, 5]: mc mp l friction(2); `experiments/run_benchmarks.py`'s
    layout). Returns (Theta, Bounds [B,T,NU], x1 [B,NX], u0 [B,T,NU])."""
    rows = torch.as_tensor(rows, dtype=torch.float64)
    B = rows.shape[0]
    to = lambda a: a.to(dtype=dtype, device=device)
    b = bounds(dtype, device)
    return (Theta(mc=to(rows[:, 0]), mp=to(rows[:, 1]), l=to(rows[:, 2]),
                  friction=to(rows[:, 3:5].contiguous())),
            Bounds(*(v.expand((B,) + v.shape) for v in b)),
            torch.zeros((B, NX), dtype=dtype, device=device),
            initial_controls(dtype, device).expand(B, T, NU))


# Reference seed-1 parameters (reference:
# experiments/ipddp2/params/cartpole_friction.txt line 1).
SEED1_THETA = dict(mc=0.9146732708938586, mp=0.18492414895571863,
                   l=0.5198826683691469,
                   friction=(0.11282647403425017, 0.14149290036628315))
SEED1_GOLDEN_OBJECTIVE = 9.29397628e-01
SEED1_GOLDEN_ITERATIONS = 60


def seed1_instance(dtype=torch.float64, device=None):
    return Theta(**{k: torch.tensor(v, dtype=dtype, device=device)
                    for k, v in SEED1_THETA.items()})
