"""Acrobot with elbow joint-limit contact.

Counterpart of `ipddp2tpu/models/acrobot.py`, the reference's
acrobot_contact benchmark (reference: experiments/ipddp2/acrobot_contact.jl,
model experiments/models/acrobot.jl): an underactuated double pendulum
(elbow torque only) whose elbow has hard limits at +-pi/2, treated as
unilateral contacts. Contact-implicit encoding: q+ lives in the control
vector, the dynamics is the trivial shift, and the variational midpoint
residual + joint-limit complementarity (lam . s = sc with gap s = phi(q+))
are stagewise equalities.

    x = [q-, q] in R^4,  q = (shoulder angle, elbow angle)
    u = [tau, q+, lam(2), s(2), sc(2)] in R^9
    nc = 6 equality rows, N = 101, dt = 0.05

theta = Theta(m1, l1, m2, l2), randomized; I1 = I2 = 0.333 and
lc1 = lc2 = 0.5 fixed (reference: experiments/ipddp2/acrobot_contact.jl:
39-48). `contact=True`: `inertia_method="auto"` takes rook Bunch-Kaufman.

Golden seed-1 anchor: 157 iterations, objective 1.33119481e+00
(reference: experiments/ipddp2/results/acrobot_contact.txt:2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..problem import Bounds, Problem, uniform_bounds

NQ, NTAU, NCONTACT = 2, 1, 2
NX = 2 * NQ
NU = NTAU + NQ + 3 * NCONTACT          # 9
NC = NQ + 2 * NCONTACT                 # 6
DT = 0.05
T = 100
GRAVITY = 9.81
TORQUE_LIMIT = 8.0
Q_GOAL = (math.pi, 0.0)
I1 = 0.333
I2 = 0.333
LC1 = 0.5
LC2 = 0.5
PARAMS = "acrobot_contact.txt"   # experiments/params: m1 I1 l1 lc1 m2 I2 l2 lc2


class Theta(NamedTuple):
    m1: torch.Tensor
    l1: torch.Tensor
    m2: torch.Tensor
    l2: torch.Tensor


def _mv2(M, v):
    """[[a, b], [c, d]] (rows as pairs) times a 2-vector."""
    (a, b), (c, d) = M
    return torch.stack([a * v[0] + b * v[1], c * v[0] + d * v[1]])


def mass_matrix(theta: Theta, q):
    """(reference: experiments/models/acrobot.jl M_func), rows as pairs."""
    a = (I1 + I2 + theta.m2 * theta.l1 ** 2
         + 2.0 * theta.m2 * theta.l1 * LC2 * torch.cos(q[1]))
    b = I2 + theta.m2 * theta.l1 * LC2 * torch.cos(q[1])
    return (a, b), (b, torch.full_like(b, I2))


def bias(theta: Theta, q, qd):
    """C~(q, qd) qd - tau_g(q) (reference: experiments/models/acrobot.jl
    C_func, tau_g_func, C~_func)."""
    h = theta.m2 * theta.l1 * LC2 * torch.sin(q[1])
    coriolis0 = -2.0 * h * qd[1] * qd[0] - h * qd[1] * qd[1]
    coriolis1 = h * qd[0] * qd[0]
    g1 = (-theta.m1 * GRAVITY * LC1 * torch.sin(q[0])
          - theta.m2 * GRAVITY * (theta.l1 * torch.sin(q[0])
                                  + LC2 * torch.sin(q[0] + q[1])))
    g2 = -theta.m2 * GRAVITY * LC2 * torch.sin(q[0] + q[1])
    return torch.stack([coriolis0 - g1, coriolis1 - g2])


def joint_limit_gap(q):
    """phi(q) >= 0: elbow limits at +-pi/2
    (reference: experiments/models/acrobot.jl phi_func)."""
    return torch.stack([0.5 * math.pi - q[1], q[1] + 0.5 * math.pi])


def integrator_residual(theta: Theta, q_prev, q, q_next, tau, lam):
    """Variational midpoint residual with joint damping 0.5 * qd+
    (reference: experiments/models/acrobot.jl manipulator_fd)."""
    qm_minus = 0.5 * (q_prev + q)
    qm_plus = 0.5 * (q + q_next)
    qd_minus = (q - q_prev) / DT
    qd_plus = (q_next - q) / DT
    momentum = (_mv2(mass_matrix(theta, qm_plus), qd_plus)
                - _mv2(mass_matrix(theta, qm_minus), qd_minus))
    c_mid = 0.5 * (bias(theta, qm_plus, qd_plus)
                   + bias(theta, qm_minus, qd_minus))
    zero = torch.zeros_like(tau)
    b_tau = torch.stack([zero, tau])            # elbow actuation only
    # contact Jacobian P = [0 -1; 0 1]; P^T lam = [0, lam2 - lam1]
    p_lam = torch.stack([zero, lam[1] - lam[0]])
    return momentum + DT * (c_mid - b_tau - p_lam + 0.5 * qd_plus)


def dynamics(x, u, t, theta):
    return torch.cat([x[NQ:], u[NTAU:NTAU + NQ]])


def stage_cost(x, u, t, theta):
    tau = u[0]
    sc = u[7:9]
    return 0.01 * DT * tau ** 2 + 2.0 * torch.sum(sc)


def terminal_cost(x, theta):
    q_prev, q = x[:NQ], x[NQ:]
    qd = (q - q_prev) / DT
    dq = q - torch.tensor(Q_GOAL, dtype=x.dtype, device=x.device)
    return 200.0 * torch.dot(qd, qd) + 700.0 * torch.dot(dq, dq)


def constraints(x, u, t, theta: Theta):
    """Integrator residual + joint-limit complementarity, 6 rows
    (reference: experiments/models/acrobot.jl implicit_contact_dynamics_slack)."""
    q_prev, q = x[:NQ], x[NQ:]
    tau = u[0]
    q_next = u[1:3]
    lam = u[3:5]
    s = u[5:7]
    sc = u[7:9]
    return torch.cat([
        integrator_residual(theta, q_prev, q, q_next, tau, lam),
        s - joint_limit_gap(q_next),
        lam * s - sc,
    ])


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints, contact=True,
                   device_model="acrobot")


def bounds(dtype=torch.float64, device=None) -> Bounds:
    inf = float("inf")
    lo = torch.tensor([-TORQUE_LIMIT] + [-inf] * NQ + [0.0] * (3 * NCONTACT),
                      dtype=dtype, device=device)
    hi = torch.tensor([TORQUE_LIMIT] + [inf] * (NU - NTAU), dtype=dtype,
                      device=device)
    return uniform_bounds(T, lo, hi)


def initial_state(dtype=torch.float64, device=None):
    return torch.zeros((NX,), dtype=dtype, device=device)


def initial_controls(dtype=torch.float64, device=None):
    u0 = torch.tensor([0.0] * (NTAU + NQ) + [0.01] * (3 * NCONTACT),
                      dtype=dtype, device=device)
    return u0.expand(T, NU)


def from_params(rows, dtype=torch.float64, device=None):
    """Instances from rows of `experiments/params/acrobot_contact.txt`
    ([B, 8]: m1 I1 l1 lc1 m2 I2 l2 lc2, the fixed I and lc included;
    `experiments/run_benchmarks.py`'s layout). Returns
    (Theta of [B] tensors, Bounds [B,T,NU], x1 [B,NX], u0 [B,T,NU])."""
    rows = torch.as_tensor(rows, dtype=torch.float64)
    B = rows.shape[0]
    col = lambda i: rows[:, i].to(dtype=dtype, device=device)
    b = bounds(dtype, device)
    return (Theta(m1=col(0), l1=col(2), m2=col(4), l2=col(6)),
            Bounds(*(v.expand((B,) + v.shape) for v in b)),
            torch.zeros((B, NX), dtype=dtype, device=device),
            initial_controls(dtype, device).expand(B, T, NU))


def instance_from_draws(u):
    """The instances of unit uniforms `u` [B, 4] (the draws of m1, l1, m2,
    l2 in that order), as the JAX package's `random_instance` maps its
    draws (reference: experiments/ipddp2/acrobot_contact.jl:39-48): each
    parameter 0.9 + 0.2 u. Returns Theta of [B] tensors."""
    r = lambda i: 0.9 + 0.2 * u[:, i]
    return Theta(m1=r(0), l1=r(1), m2=r(2), l2=r(3))


def random_instances(batch: int, generator: torch.Generator,
                     dtype=torch.float64, device=None):
    """`batch` random instances with the ranges of the JAX package's
    `random_instance`: float64 draws on the generator's device, mapped by
    `instance_from_draws` and moved to `device`. Returns Theta of [B]
    tensors.
    The port does not reimplement JAX's PRNG: the instances have the JAX
    generator's ranges, not its numbers."""
    u = torch.rand((batch, 4), generator=generator, dtype=torch.float64,
                   device=generator.device)
    th = instance_from_draws(u)
    return Theta(*(a.to(dtype=dtype, device=device) for a in th))


# Reference seed-1 parameters (reference:
# experiments/ipddp2/params/acrobot_contact.txt line 1).
SEED1_THETA = dict(m1=0.9146732708938586, l1=0.9698482979114372,
                   m2=1.0397653367382937, l2=1.0256529480685004)
SEED1_GOLDEN_OBJECTIVE = 1.33119481e00
SEED1_GOLDEN_ITERATIONS = 157


def seed1_instance(dtype=torch.float64, device=None):
    return Theta(**{k: torch.tensor(v, dtype=dtype, device=device)
                    for k, v in SEED1_THETA.items()})
