"""Double integrator with absolute-work objective.

Counterpart of `ipddp2tpu/models/double_integrator.py` (reference:
experiments/ipddp2/double_integrator.jl): a block moving on a line,
forward-Euler dynamics, |force * velocity| work objective encoded with two
slack controls and one stagewise equality, plus control bounds.

    x = [position, velocity]          nx = 2
    u = [force, s_plus, s_minus]      nu = 3
    x' = x + dt * [v, force]
    l(x, u) = dt * (s_plus + s_minus)
    lT(x)   = 500 * |x - x_goal|^2
    c(x, u) = s_plus - s_minus - force * v = 0
    -10 <= force <= 10,  s_plus >= 0,  s_minus >= 0

Golden anchor (deterministic): objective 1.26574863e+00 in 31 iterations at
tol 1e-7 (reference: experiments/ipddp2/results/double_integrator.txt:2).
"""

from __future__ import annotations

import torch

from ..problem import Bounds, Problem, uniform_bounds

NX, NU, NC = 2, 3, 1
DT = 0.01
T = 100                 # reference horizon N = 101
X_GOAL = (1.0, 0.0)
FORCE_LIMIT = 10.0


def dynamics(x, u, t, theta):
    return x + DT * torch.stack([x[1], u[0]])


def stage_cost(x, u, t, theta):
    return DT * (u[1] + u[2])


def terminal_cost(x, theta):
    d = x - torch.tensor(X_GOAL, dtype=x.dtype, device=x.device)
    return 500.0 * torch.dot(d, d)


def constraints(x, u, t, theta):
    return torch.stack([u[1] - u[2] - u[0] * x[1]])


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints)


def bounds(dtype=torch.float64, device=None) -> Bounds:
    lo = torch.tensor([-FORCE_LIMIT, 0.0, 0.0], dtype=dtype, device=device)
    hi = torch.tensor([FORCE_LIMIT, float("inf"), float("inf")], dtype=dtype,
                      device=device)
    return uniform_bounds(T, lo, hi)


def initial_state(dtype=torch.float64, device=None):
    return torch.zeros((NX,), dtype=dtype, device=device)


def initial_controls(dtype=torch.float64, device=None):
    return torch.full((T, NU), 0.01, dtype=dtype, device=device)


GOLDEN_OBJECTIVE = 1.26574863e00
GOLDEN_ITERATIONS = 31
