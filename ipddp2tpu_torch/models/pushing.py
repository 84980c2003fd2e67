"""Planar pushing with friction cone, sticking/sliding modes and an obstacle.

Counterpart of `ipddp2tpu/models/pushing.py`, the reference's pushing_1_obs
benchmark (reference: experiments/ipddp2/pushing_1_obs.jl): a pusher moves a
rectangular slider on a plane under an ellipsoidal limit-surface model; the
friction-cone and mode-complementarity conditions plus an obstacle clearance
are stagewise equalities with slack-encoded inequalities.

    x = [px, py, theta, phi]                          nx = 4
    u = [fn, ft, vphi+, vphi-, g+, g-, sc1, sc2, qphi, so+, so-]   nu = 11
    nc = 6 equality rows, N = 101, dt = 0.04

theta = Theta(zx, zy, c, mu_fric, obstacle [3]) (reference:
experiments/ipddp2/pushing_1_obs.jl:39-60). `contact=True`.

Golden seed-1 anchor: 483 iterations, objective 3.22554840e-02 (reference:
experiments/ipddp2/results/pushing_1_obs.txt:2); the JAX package converges
to a nearby local optimum (objective within 10 %).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..problem import Bounds, Problem, uniform_bounds

NX, NU, NC = 4, 11, 6
DT = 0.04
T = 100
FORCE_LIMIT = 0.3
VEL_LIMIT = 3.0
R_PUSH = 0.01
PHI_LIMIT = 0.9
X_GOAL = (0.3, 0.4, 1.5 * math.pi, 0.0)
PARAMS = "pushing_1_obs.txt"  # experiments/params: zx zy c mu_fric obstacle(3)


class Theta(NamedTuple):
    zx: torch.Tensor          # block x-dimension
    zy: torch.Tensor          # block y-dimension
    c: torch.Tensor           # ellipsoidal limit-surface approximation ratio
    mu_fric: torch.Tensor     # pusher-slider friction coefficient
    obstacle: torch.Tensor    # [3] x, y, r


def dynamics(x, u, t, theta: Theta):
    """Ellipsoidal limit-surface quasi-static model, forward Euler
    (reference: experiments/ipddp2/pushing_1_obs.jl:71-98)."""
    th, phi = x[2], x[3]
    # L .* (Jc(phi)^T [fn, ft]) with L = [1, 1, c^-2]
    s2 = theta.zx / 2 * (torch.tan(phi) * u[0] - u[1]) / theta.c ** 2
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    rates = torch.stack([cos_t * u[0] - sin_t * u[1],
                         sin_t * u[0] + cos_t * u[1], s2, u[2] - u[3]])
    return x + DT * rates


def stage_cost(x, u, t, theta):
    """1e-2 |f|^2 + 2 (sc1 + sc2) + 2 so-
    (reference: experiments/ipddp2/pushing_1_obs.jl:103)."""
    return (1e-2 * (u[0] ** 2 + u[1] ** 2)
            + 2.0 * (u[6] + u[7]) + 2.0 * u[10])


def terminal_cost(x, theta):
    d = x - torch.tensor(X_GOAL, dtype=x.dtype, device=x.device)
    return 20.0 * torch.dot(d, d)


def constraints(x, u, t, theta: Theta):
    """Friction cone + mode complementarity + phi bound + obstacle
    (reference: experiments/ipddp2/pushing_1_obs.jl:108-122)."""
    r_total = torch.maximum(theta.zx, theta.zy) + R_PUSH
    xy_diff = x[:2] - theta.obstacle[:2]
    obs = ((theta.obstacle[2] + r_total) ** 2
           - torch.dot(xy_diff, xy_diff) + u[9] - u[10])
    return torch.stack([
        theta.mu_fric * u[0] - u[1] - u[4],
        theta.mu_fric * u[0] + u[1] - u[5],
        u[4] * u[2] - u[6],
        u[5] * u[3] - u[7],
        x[3] - u[8],
        obs,
    ])


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints, contact=True,
                   device_model="pushing")


def bounds(dtype=torch.float64, device=None) -> Bounds:
    """(reference: experiments/ipddp2/pushing_1_obs.jl:127-129)"""
    inf = float("inf")
    lo = torch.tensor([0.0, -FORCE_LIMIT, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                       -PHI_LIMIT, 0.0, 0.0], dtype=dtype, device=device)
    hi = torch.tensor([FORCE_LIMIT, FORCE_LIMIT, VEL_LIMIT, VEL_LIMIT,
                       inf, inf, inf, inf, PHI_LIMIT, inf, inf],
                      dtype=dtype, device=device)
    return uniform_bounds(T, lo, hi)


def initial_state(dtype=torch.float64, device=None):
    return torch.zeros((NX,), dtype=dtype, device=device)


def initial_controls(dtype=torch.float64, device=None):
    return torch.full((T, NU), 0.01, dtype=dtype, device=device)


def from_params(rows, dtype=torch.float64, device=None):
    """Instances from rows of `experiments/params/pushing_1_obs.txt`
    ([B, 7]: zx zy c mu_fric obstacle(3); `experiments/run_benchmarks.py`'s
    layout). Returns (Theta, Bounds [B,T,NU], x1 [B,NX], u0 [B,T,NU])."""
    rows = torch.as_tensor(rows, dtype=torch.float64)
    B = rows.shape[0]
    to = lambda a: a.to(dtype=dtype, device=device)
    b = bounds(dtype, device)
    return (Theta(zx=to(rows[:, 0]), zy=to(rows[:, 1]), c=to(rows[:, 2]),
                  mu_fric=to(rows[:, 3]),
                  obstacle=to(rows[:, 4:7].contiguous())),
            Bounds(*(v.expand((B,) + v.shape) for v in b)),
            torch.zeros((B, NX), dtype=dtype, device=device),
            initial_controls(dtype, device).expand(B, T, NU))


# Reference seed-1 parameters (reference:
# experiments/ipddp2/params/pushing_1_obs.txt line 1: zx zy c mu_fric obs).
SEED1_THETA = dict(zx=0.07, zy=0.12, c=0.03711,
                   mu_fric=0.24149290036628315,
                   obstacle=(0.18492414895571863, 0.21988266836914686,
                             0.05256529480685004))
SEED1_GOLDEN_OBJECTIVE = 3.22554840e-02
SEED1_GOLDEN_ITERATIONS = 483


def seed1_instance(dtype=torch.float64, device=None):
    return Theta(**{k: torch.tensor(v, dtype=dtype, device=device)
                    for k, v in SEED1_THETA.items()})
