"""Constrained car: obstacle avoidance with slack-encoded inequalities.

Counterpart of `ipddp2tpu/models/concar.py` (reference:
experiments/ipddp2/concar.jl): a unicycle-like car (RK2-integrated) must
reach a goal while avoiding four circular obstacles. Each obstacle's
clearance inequality is encoded with a pair of nonnegative slacks s-, s+ and
a stagewise equality

    (r_obs + r_car)^2 - |xy - xy_obs|^2 - s-_i + s+_i = 0

with an L1 penalty 50 * sum(s-) on the violation slacks.

    x = [px, py, heading, speed]               nx = 4
    u = [accel, steer, s-_1..4, s+_1..4]       nu = 10
    nc = 4 equality rows, N = 101, dt = 0.05

The stage functions act on one instance's 1-D tensors and trace under
`torch.func`; they keep the dtype of their inputs.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple

import torch

from ..problem import Bounds, Problem

NX, NU, NC = 4, 10, 4
NUM_OBSTACLES = 4
NUM_CONTROL = 2       # physical controls; the rest are slacks
DT = 0.05
T = 100               # reference horizon N = 101
R_CAR = 0.02
X_GOAL = (1.0, 1.0, math.pi / 4, 0.0)


class Theta(NamedTuple):
    obstacles: torch.Tensor    # [4, 3] rows (x, y, r); [B, 4, 3] batched


def _g(x, u):
    """Continuous-time unicycle dynamics (reference: experiments/ipddp2/concar.jl:55-57)."""
    return torch.stack([x[3] * torch.cos(x[2]), x[3] * torch.sin(x[2]),
                        u[1], u[0]])


def dynamics(x, u, t, theta):
    """RK2 / explicit midpoint (reference: experiments/ipddp2/concar.jl:59-63)."""
    k1 = _g(x, u)
    k2 = _g(x + DT * 0.5 * k1, u)
    return x + DT * k2


def stage_cost(x, u, t, theta):
    s_minus = u[NUM_CONTROL:NUM_CONTROL + NUM_OBSTACLES]
    effort = DT * (5.0 * u[0] ** 2 + 1.0 * u[1] ** 2)
    return effort + 50.0 * torch.sum(s_minus)


def terminal_cost(x, theta):
    d = x - torch.tensor(X_GOAL, dtype=x.dtype, device=x.device)
    return 200.0 * torch.dot(d, d)


def constraints(x, u, t, theta: Theta):
    obs = theta.obstacles
    d2 = torch.sum((x[:2][None, :] - obs[:, :2]) ** 2, dim=1)   # [4]
    s_minus = u[NUM_CONTROL:NUM_CONTROL + NUM_OBSTACLES]
    s_plus = u[NUM_CONTROL + NUM_OBSTACLES:]
    return (obs[:, 2] + R_CAR) ** 2 - d2 - s_minus + s_plus


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints, device_model="concar")


def bounds(f_lim, tau_lim, dtype=torch.float64, device=None) -> Bounds:
    """Control limits + nonnegative slacks; `f_lim`/`tau_lim` are scalars or
    `[B]` tensors (reference: experiments/ipddp2/concar.jl:104-111).
    Returns `[..., T, NU]` bounds."""
    f_lim = torch.as_tensor(f_lim, dtype=dtype, device=device)
    tau_lim = torch.as_tensor(tau_lim, dtype=dtype, device=device)
    zeros = f_lim.new_zeros(f_lim.shape + (2 * NUM_OBSTACLES,))
    infs = torch.full_like(zeros, float("inf"))
    lo = torch.cat([-f_lim[..., None], -tau_lim[..., None], zeros], dim=-1)
    hi = torch.cat([f_lim[..., None], tau_lim[..., None], infs], dim=-1)
    bcast = lambda b: b[..., None, :].expand(b.shape[:-1] + (T, NU))
    return Bounds(lower=bcast(lo), upper=bcast(hi))


def initial_controls(dtype=torch.float64, device=None):
    u0 = torch.cat([torch.zeros((2,), dtype=dtype, device=device),
                    torch.full((2 * NUM_OBSTACLES,), 1e-2, dtype=dtype,
                               device=device)])
    return u0.expand(T, NU)


def random_instances(batch: int, generator: torch.Generator,
                     dtype=torch.float64, device=None):
    """`batch` random instances with the parameter ranges of the reference
    generator (reference: experiments/ipddp2/concar.jl:31-47; the numbers are
    the generator's own, not the reference's). The draws are made on the
    generator's device and moved to `device`. Returns
    (Theta [B,4,3], f_lim [B], tau_lim [B], x1 [B,4])."""
    gdev = generator.device
    rand = lambda *shape: torch.rand(shape, generator=generator,
                                     dtype=torch.float64, device=gdev)
    f_lim = 1.5 + rand(batch)
    tau_lim = 3.0 + 2.0 * rand(batch)
    centers = torch.tensor([[0.25, 0.25], [0.75, 0.75],
                            [0.25, 0.75], [0.75, 0.25]],
                           dtype=torch.float64, device=gdev)
    xy = centers + (rand(batch, 4, 2) - 0.5) * 0.2
    r = 0.05 + rand(batch, 4) * 0.15
    x1 = torch.zeros((batch, NX), dtype=torch.float64, device=gdev)
    x1[:, 2] = math.pi / 8 + rand(batch) * math.pi / 4
    to = lambda a: a.to(dtype=dtype, device=device)
    theta = Theta(obstacles=to(torch.cat([xy, r[..., None]], dim=-1)))
    return theta, to(f_lim), to(tau_lim), to(x1)


# Seed-1 instance parameters of the reference benchmark, for exact golden
# comparison (reference: experiments/ipddp2/params/concar.txt line 1; golden
# result experiments/ipddp2/results/concar.txt:2 = 99 iterations,
# objective 4.46466505e+00).
SEED1_F_LIM = 1.5733663544692928
SEED1_TAU_LIM = 3.698482979114372
SEED1_OBSTACLES = (
    (0.2897653367382937, 0.2756529480685003, 0.1872393505494247),
    (0.6885616232491751, 0.8040360695771332, 0.16707788955127795),
    (0.28405279166889874, 0.6835424212941854, 0.13566311740135806),
    (0.7405617174566697, 0.21046509438357436, 0.0502025416887084),
)
SEED1_X1 = (0.0, 0.0, 0.5464318017788816, 0.0)
SEED1_GOLDEN_OBJECTIVE = 4.46466505e00
SEED1_GOLDEN_ITERATIONS = 99


def seed1_instance(dtype=torch.float64, device=None):
    """The unbatched seed-1 instance: (Theta [4,3], f_lim, tau_lim, x1 [4])."""
    theta = Theta(obstacles=torch.tensor(SEED1_OBSTACLES, dtype=dtype,
                                         device=device))
    x1 = torch.tensor(SEED1_X1, dtype=dtype, device=device)
    return theta, SEED1_F_LIM, SEED1_TAU_LIM, x1


RESIDUE_R5 = Path(__file__).with_name("concar_residue_r5.json")


def residue_instances(device=None, dtype=torch.float64):
    """The 24 instances of the round-5 residue (`concar_residue_r5.json`:
    seeds 1002 and 1004 of the JAX package's generator, stored exactly as
    `float.hex`). Returns (seeds [24], indices [24], Theta [24,4,3], f_lim
    [24], tau_lim [24], x1 [24,4]); seeds and indices are Python lists."""
    rows = json.loads(RESIDUE_R5.read_text())["instances"]
    num = lambda v: ([num(a) for a in v] if isinstance(v, list)
                     else float.fromhex(v))
    col = lambda key: torch.tensor([num(r[key]) for r in rows],
                                   dtype=torch.float64).to(device, dtype)
    return ([r["seed"] for r in rows], [r["index"] for r in rows],
            Theta(obstacles=col("obstacles")), col("f_lim"), col("tau_lim"),
            col("x1"))
