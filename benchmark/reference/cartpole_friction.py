"""Plain reference of cartpole_friction: the configuration's equations,
written once more from the upstream experiment (cartpole_friction.jl, model
cartpole.jl): the state is the last two configurations, the next one is a
control, the implicit variational midpoint integrator and the friction
complementarity system are 14 stage equalities, slack-smoothed.

x = [q-, q], q = (cart position, pole angle);
u = [F, q+, beta1(2), beta2(2), eta1(2), eta2(2), psi(2), s(2), sc(6)].
Every function takes rows [N, ...] and a dict `th` of per-row parameters
(mc, mp, l [N], friction [N, 2]). It imports torch alone.
"""

import math

import torch

DT = 0.05
GRAVITY = 9.81
Q_GOAL = (0.0, math.pi)
COMPL_ROWS = ()


def _momentum(th, q, qd):
    """M(q) qd, M = [[mc + mp, mp l cos q1], [mp l cos q1, mp l^2]]."""
    mc, mp, l = th["mc"], th["mp"], th["l"]
    off = mp * l * torch.cos(q[:, 1])
    return torch.stack([(mc + mp) * qd[:, 0] + off * qd[:, 1],
                        off * qd[:, 0] + mp * l ** 2 * qd[:, 1]], dim=1)


def _bias(th, q, qd):
    """C(q, qd) qd - g(q)."""
    mp, l = th["mp"], th["l"]
    s = torch.sin(q[:, 1])
    return torch.stack([-mp * l * s * qd[:, 1] ** 2, mp * GRAVITY * l * s],
                       dim=1)


def dynamics(x, u, th):
    return torch.cat([x[:, 2:4], u[:, 1:3]], dim=1)


def stage_cost(x, u, th):
    return 0.01 * DT * u[:, 0] ** 2 + u[:, 15:21].sum(dim=1)


def terminal_cost(x, th):
    qd = (x[:, 2:4] - x[:, 0:2]) / DT
    goal = torch.tensor(Q_GOAL, dtype=x.dtype, device=x.device)
    return (200.0 * (qd ** 2).sum(dim=1)
            + 700.0 * ((x[:, 2:4] - goal) ** 2).sum(dim=1))


def constraints(x, u, th):
    q_prev, q, q_next = x[:, 0:2], x[:, 2:4], u[:, 1:3]
    force = u[:, 0]
    beta1, beta2, eta1, eta2 = u[:, 3:5], u[:, 5:7], u[:, 7:9], u[:, 9:11]
    psi, s, sc = u[:, 11:13], u[:, 13:15], u[:, 15:21]
    qd_minus, qd_plus = (q - q_prev) / DT, (q_next - q) / DT
    q_minus, q_plus = 0.5 * (q_prev + q), 0.5 * (q + q_next)
    contact = torch.stack([beta1[:, 0] - beta1[:, 1],
                           beta2[:, 0] - beta2[:, 1]], dim=1)
    applied = torch.stack([force, torch.zeros_like(force)], dim=1)
    integrator = (_momentum(th, q_plus, qd_plus)
                  - _momentum(th, q_minus, qd_minus)
                  + DT * (0.5 * (_bias(th, q_plus, qd_plus)
                                 + _bias(th, q_minus, qd_minus))
                          - applied - contact))
    slide = torch.stack([qd_plus[:, 0], -qd_plus[:, 0]], dim=1)
    hinge = torch.stack([qd_plus[:, 1], -qd_plus[:, 1]], dim=1)
    cap1 = th["friction"][:, 0] * (th["mp"] + th["mc"]) * GRAVITY
    cap2 = th["friction"][:, 1] * th["mp"] * GRAVITY * th["l"]
    return torch.cat([
        integrator,
        slide + psi[:, 0:1] - eta1,
        hinge + psi[:, 1:2] - eta2,
        torch.stack([cap1 - beta1.sum(dim=1) - s[:, 0],
                     cap2 - beta2.sum(dim=1) - s[:, 1],
                     psi[:, 0] * s[:, 0] - sc[:, 0],
                     psi[:, 1] * s[:, 1] - sc[:, 1]], dim=1),
        beta1 * eta1 - sc[:, 2:4],
        beta2 * eta2 - sc[:, 4:6],
    ], dim=1)
