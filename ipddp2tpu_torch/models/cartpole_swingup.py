"""Classic cartpole swing-up with control bounds only (no stagewise
constraints).

Counterpart of `ipddp2tpu/models/cartpole_swingup.py` (BASELINE.json config
"Cartpole swing-up, N=100, control bounds only"): the solver's nc = 0 path,
where each stage's KKT system is the barrier-regularized control Hessian.

    x = [p, theta, pdot, thetadot], u = [force]
    explicit RK2, dt = 0.05, T = 100

No parameters (theta None). The JAX package's regression anchor is the
default instance (x1 = 0): 112 iterations, objective 0.17506381040839103 at
tolerance 1e-7.
"""

from __future__ import annotations

import math

import torch

from ..problem import Bounds, Problem, uniform_bounds
from . import uniform_in

NX, NU, NC = 4, 1, 0
ANCHOR_OBJECTIVE = 0.17506381040839103
ANCHOR_ITERATIONS = 112
DT = 0.05
T = 100
MC, MP, L, GRAVITY = 1.0, 0.2, 0.5, 9.81
FORCE_LIMIT = 10.0
PARAMS = "cartpole_swingup.txt"     # experiments/params: x1[0], x1[1]


def _accel(x, u):
    th, pdot, thdot = x[1], x[2], x[3]
    s, c = torch.sin(th), torch.cos(th)
    f = u[0]
    denom = MC + MP * s ** 2
    pddot = (f + MP * s * (L * thdot ** 2 + GRAVITY * c)) / denom
    thddot = (-f * c - MP * L * thdot ** 2 * c * s
              - (MC + MP) * GRAVITY * s) / (L * denom)
    return torch.stack([pdot, thdot, pddot, thddot])


def dynamics(x, u, t, theta):
    k1 = _accel(x, u)
    k2 = _accel(x + 0.5 * DT * k1, u)
    return x + DT * k2


def stage_cost(x, u, t, theta):
    return DT * (0.01 * u[0] ** 2 + 0.1 * x[0] ** 2)


def terminal_cost(x, theta):
    goal = torch.tensor([0.0, math.pi, 0.0, 0.0], dtype=x.dtype,
                        device=x.device)
    d = x - goal
    return 500.0 * torch.dot(d, d)


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   device_model="cartpole_swingup")


def bounds(dtype=torch.float64, device=None) -> Bounds:
    return uniform_bounds(
        T, torch.full((NU,), -FORCE_LIMIT, dtype=dtype, device=device),
        torch.full((NU,), FORCE_LIMIT, dtype=dtype, device=device))


def initial_state(dtype=torch.float64, device=None):
    return torch.zeros((NX,), dtype=dtype, device=device)


def initial_controls(dtype=torch.float64, device=None):
    return torch.full((T, NU), 0.01, dtype=dtype, device=device)


def instance_from_draws(u):
    """The initial states of unit uniforms `u` [B, 2], as the JAX package's
    `random_instance` maps its draws: cart position 0.5 U(-1, 1), pole
    angle 0.3 U(-1, 1), velocities zero. Returns x1 [B, NX]."""
    x1 = u.new_zeros((u.shape[0], NX))
    x1[:, 0] = 0.5 * uniform_in(u[:, 0], -1.0, 1.0)
    x1[:, 1] = 0.3 * uniform_in(u[:, 1], -1.0, 1.0)
    return x1


def random_instances(batch: int, generator: torch.Generator,
                     dtype=torch.float64, device=None):
    """`batch` random initial states with the ranges of the JAX package's
    `random_instance`: float64 draws on the generator's device, mapped by
    `instance_from_draws` and moved to `device`. Returns x1 [B, NX].
    The port does not reimplement JAX's PRNG: the instances have the JAX
    generator's ranges, not its numbers."""
    u = torch.rand((batch, 2), generator=generator, dtype=torch.float64,
                   device=generator.device)
    return instance_from_draws(u).to(dtype=dtype, device=device)


def from_params(rows, dtype=torch.float64, device=None):
    """Instances from rows of `experiments/params/cartpole_swingup.txt`
    ([B, 2]: the initial cart position and pole angle;
    `experiments/run_benchmarks.py`'s layout). Returns (None,
    Bounds [B,T,NU], x1 [B,NX], u0 [B,T,NU])."""
    rows = torch.as_tensor(rows, dtype=torch.float64)
    B = rows.shape[0]
    x1 = torch.zeros((B, NX), dtype=torch.float64)
    x1[:, :2] = rows[:, :2]
    b = bounds(dtype, device)
    return (None, Bounds(*(v.expand((B,) + v.shape) for v in b)),
            x1.to(dtype=dtype, device=device),
            initial_controls(dtype, device).expand(B, T, NU))
