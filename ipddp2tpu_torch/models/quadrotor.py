"""Quadrotor point-to-point flight with rotor-thrust bounds.

Counterpart of `ipddp2tpu/models/quadrotor.py` (BASELINE.json config
"Batched concar/quadrotor"): a 12-state quadrotor (position, ZYX Euler
angles, linear and angular velocity) flying to hover at a target, four
nonnegative, upper-bounded rotor thrusts, no equality constraints.

    x = [p(3), rpy(3), v(3), w(3)], u = 4 rotor thrusts
    explicit RK2, dt = 0.05, T = 100

theta = Theta(goal [3]); the JAX package's regression anchor is the default
instance (goal (1, 1, 1), x1 = 0): 24 iterations, objective
0.0029196425180430595 at tolerance 1e-7.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..problem import Bounds, Problem, uniform_bounds
from . import uniform_in

NX, NU, NC = 12, 4, 0
ANCHOR_OBJECTIVE = 0.0029196425180430595
ANCHOR_ITERATIONS = 24
DT = 0.05
T = 100
MASS, GRAVITY, ARM = 1.0, 9.81, 0.2
INERTIA = (0.01, 0.01, 0.02)
KAPPA_YAW = 0.05            # rotor drag-torque / thrust ratio
THRUST_MAX = 2.0 * MASS * GRAVITY / NU * 2.0
GOAL = (1.0, 1.0, 1.0)
PARAMS = "quadrotor.txt"    # experiments/params: goal (3), x1[:3]


class Theta(NamedTuple):
    goal: torch.Tensor      # [3] target position; [B, 3] batched


def _rates(x, u):
    """The continuous-time rates. No tensor is made from Python numbers
    here: the rollout that calls this is replayed from a CUDA graph, and a
    capture refuses host-to-device copies."""
    v, w = x[6:9], x[9:12]
    phi, th, psi = x[3], x[4], x[5]
    cph, sph = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(th), torch.sin(th)
    cps, sps = torch.cos(psi), torch.sin(psi)

    thrust = torch.sum(u)
    # body-z axis in the world frame (ZYX Euler)
    bz = torch.stack([cph * sth * cps + sph * sps,
                      cph * sth * sps - sph * cps,
                      cph * cth])
    acc = thrust / MASS * bz
    acc = torch.stack([acc[0], acc[1], acc[2] - GRAVITY])
    # torques from the rotor layout (+ configuration)
    tau = (ARM * (u[1] - u[3]), ARM * (u[2] - u[0]),
           KAPPA_YAW * (u[0] - u[1] + u[2] - u[3]))
    i0, i1, i2 = INERTIA
    iw = (i0 * w[0], i1 * w[1], i2 * w[2])
    # (tau - w x (I w)) / I
    wdot = torch.stack([(tau[0] - (w[1] * iw[2] - w[2] * iw[1])) / i0,
                        (tau[1] - (w[2] * iw[0] - w[0] * iw[2])) / i1,
                        (tau[2] - (w[0] * iw[1] - w[1] * iw[0])) / i2])
    # Euler-angle kinematics (ZYX): rpy_dot = E w
    tth = torch.tan(th)
    rpy_dot = torch.stack([
        w[0] + sph * tth * w[1] + cph * tth * w[2],
        cph * w[1] - sph * w[2],
        sph / cth * w[1] + cph / cth * w[2]])
    return torch.cat([v, rpy_dot, acc, wdot])


def dynamics(x, u, t, theta):
    k1 = _rates(x, u)
    k2 = _rates(x + 0.5 * DT * k1, u)
    return x + DT * k2


def stage_cost(x, u, t, theta):
    du = u - MASS * GRAVITY / NU
    return DT * (0.1 * torch.dot(du, du) + 0.1 * torch.dot(x[9:12], x[9:12]))


def terminal_cost(x, theta):
    goal = (theta.goal if theta is not None
            else torch.tensor(GOAL, dtype=x.dtype, device=x.device))
    dp = x[:3] - goal
    return (200.0 * torch.dot(dp, dp) + 50.0 * torch.dot(x[6:9], x[6:9])
            + 50.0 * torch.dot(x[3:6], x[3:6])
            + 50.0 * torch.dot(x[9:12], x[9:12]))


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   device_model="quadrotor")


def bounds(dtype=torch.float64, device=None) -> Bounds:
    return uniform_bounds(
        T, torch.zeros((NU,), dtype=dtype, device=device),
        torch.full((NU,), THRUST_MAX, dtype=dtype, device=device))


def initial_state(dtype=torch.float64, device=None):
    return torch.zeros((NX,), dtype=dtype, device=device)


def initial_controls(dtype=torch.float64, device=None):
    return torch.full((T, NU), MASS * GRAVITY / NU, dtype=dtype,
                      device=device)


def default_instance(dtype=torch.float64, device=None):
    """The anchor's instance: (Theta(goal [3]), x1 [NX])."""
    return (Theta(goal=torch.tensor(GOAL, dtype=dtype, device=device)),
            initial_state(dtype, device))


def instance_from_draws(u_goal, u_x1):
    """The instances of unit uniforms `u_goal` [B, 3] and `u_x1` [B, 3], as
    the JAX package's `random_instance` maps its draws: the goal is GOAL +
    0.5 U(-1, 1), the initial position 0.2 U(-1, 1), the rest of x1 zero.
    Returns (Theta(goal [B, 3]), x1 [B, NX])."""
    goal = (torch.tensor(GOAL, dtype=u_goal.dtype, device=u_goal.device)
            + 0.5 * uniform_in(u_goal, -1.0, 1.0))
    x1 = u_x1.new_zeros((u_x1.shape[0], NX))
    x1[:, :3] = 0.2 * uniform_in(u_x1, -1.0, 1.0)
    return Theta(goal=goal), x1


def random_instances(batch: int, generator: torch.Generator,
                     dtype=torch.float64, device=None):
    """`batch` random instances with the ranges of the JAX package's
    `random_instance`: float64 draws on the generator's device, mapped by
    `instance_from_draws` and moved to `device`. Returns (Theta(goal
    [B, 3]), x1 [B, NX]).
    The port does not reimplement JAX's PRNG: the instances have the JAX
    generator's ranges, not its numbers."""
    rand = lambda: torch.rand((batch, 3), generator=generator,
                              dtype=torch.float64, device=generator.device)
    th, x1 = instance_from_draws(rand(), rand())
    to = lambda a: a.to(dtype=dtype, device=device)
    return Theta(goal=to(th.goal)), to(x1)


def from_params(rows, dtype=torch.float64, device=None):
    """Instances from rows of `experiments/params/quadrotor.txt` ([B, 6]:
    goal, x1[:3]; `experiments/run_benchmarks.py`'s layout). Returns
    (Theta [B,3], Bounds [B,T,NU], x1 [B,NX], u0 [B,T,NU])."""
    rows = torch.as_tensor(rows, dtype=torch.float64)
    B = rows.shape[0]
    x1 = torch.zeros((B, NX), dtype=torch.float64)
    x1[:, :3] = rows[:, 3:6]
    to = lambda a: a.to(dtype=dtype, device=device)
    b = bounds(dtype, device)
    return (Theta(goal=to(rows[:, :3].contiguous())),
            Bounds(*(v.expand((B,) + v.shape) for v in b)), to(x1),
            initial_controls(dtype, device).expand(B, T, NU))
