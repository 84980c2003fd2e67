"""Plain reference of concar_quad: the configuration's equations, written
once more from the upstream experiment (concar_quad.jl: RK2 unicycle,
four obstacle clearances as equalities with slacks s- and s+, the quadratic
penalty 1000 |s-|^2) for rows of instances and stages at once.

x = [px, py, heading, speed]; u = [accel, steer, s-_1..4, s+_1..4].
Every function takes rows [N, ...] and a dict `th` of per-row parameters
(`obstacles` [N, 4, 3]: x, y, radius). It imports torch alone.
"""

import math

import torch

DT = 0.05
R_CAR = 0.02
X_GOAL = (1.0, 1.0, math.pi / 4, 0.0)
COMPL_ROWS = ()


def _velocity(x, u):
    return torch.stack([x[:, 3] * torch.cos(x[:, 2]),
                        x[:, 3] * torch.sin(x[:, 2]), u[:, 1], u[:, 0]],
                       dim=1)


def dynamics(x, u, th):
    """Explicit midpoint step of the unicycle."""
    mid = x + 0.5 * DT * _velocity(x, u)
    return x + DT * _velocity(mid, u)


def stage_cost(x, u, th):
    s_minus = u[:, 2:6]
    return (DT * (5.0 * u[:, 0] ** 2 + u[:, 1] ** 2)
            + 1000.0 * (s_minus ** 2).sum(dim=1))


def terminal_cost(x, th):
    goal = torch.tensor(X_GOAL, dtype=x.dtype, device=x.device)
    return 200.0 * ((x - goal) ** 2).sum(dim=1)


def constraints(x, u, th):
    obs = th["obstacles"]
    d2 = ((x[:, None, :2] - obs[:, :, :2]) ** 2).sum(dim=2)
    return (obs[:, :, 2] + R_CAR) ** 2 - d2 - u[:, 2:6] + u[:, 6:10]
