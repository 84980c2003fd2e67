"""Constrained car with quadratic slack penalty.

Counterpart of `ipddp2tpu/models/concar_quad.py`: identical to `concar`
except that the violation-slack penalty is quadratic, 1000 * |s-|^2 instead
of the L1 penalty 50 * sum(s-) (reference:
experiments/ipddp2/concar_quad.jl:75, the only difference from concar.jl).
Same instance distribution and parameter layout, so the reference's seed-1
parameters are shared with concar; golden seed-1 result: 85 iterations,
objective 1.93358805e+00 (reference:
experiments/ipddp2/results/concar_quad.txt:2).
"""

from __future__ import annotations

import torch

from ..problem import Problem
from . import concar
from .concar import (NC, NU, NUM_CONTROL, NUM_OBSTACLES, NX, T, Theta,  # noqa: F401
                     bounds, constraints, dynamics, from_params,
                     initial_controls, random_instances, seed1_instance,
                     terminal_cost)

PARAMS = "concar_quad.txt"          # experiments/params, concar's layout
SEED1_GOLDEN_OBJECTIVE = 1.93358805e00
SEED1_GOLDEN_ITERATIONS = 85


def stage_cost(x, u, t, theta):
    s_minus = u[NUM_CONTROL:NUM_CONTROL + NUM_OBSTACLES]
    effort = concar.DT * (5.0 * u[0] ** 2 + 1.0 * u[1] ** 2)
    return effort + 1000.0 * torch.dot(s_minus, s_minus)


def problem() -> Problem:
    return Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                   stage_cost=stage_cost, terminal_cost=terminal_cost,
                   constraints=constraints, device_model="concar_quad")
