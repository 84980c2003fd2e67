"""The port's smooth benchmark models (`concar_quad`, `quadrotor`,
`cartpole_swingup`: the LDL^T path) against the JAX package's: stage,
terminal and constraint values and the whole derivative bundle on random
trajectories and duals, bounds and first guesses, and the reader of the
campaign's instance data (`experiments/params`) against the JAX generator
that wrote it.

Tolerances: values rtol 1e-12 (the same formulas, other libm), the
derivative bundle rtol 1e-10 (AD in other association orders), the params
and bounds bit for bit. The slow golden solves (T = 100, eager CPU torch)
follow tests/test_benchmarks.py::_check: converged, objective to 1e-6,
iterations within max(3, 10 % + 1) of the anchor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipddp2tpu.models import cartpole_swingup as jsw
from ipddp2tpu.models import concar_quad as jcq
from ipddp2tpu.models import quadrotor as jqr

import ipddp2tpu_torch as P
from ipddp2tpu_torch.models import cartpole_swingup as psw
from ipddp2tpu_torch.models import concar_quad as pcq
from ipddp2tpu_torch.models import quadrotor as pqr

from torch_port_helpers import (check_model_against_jax, check_params_reader,
                                params_instances, tnp)

MODELS = {"concar_quad": (jcq, pcq), "quadrotor": (jqr, pqr),
          "cartpole_swingup": (jsw, psw)}


def _thetas(name, B=3):
    jm, pm = MODELS[name]
    th = params_instances(jm, name)[0]
    if name == "concar_quad":
        return (jcq.Theta(jnp.asarray(th.obstacles[:B])),
                pcq.Theta(torch.tensor(th.obstacles[:B])))
    if name == "quadrotor":
        return (jqr.Theta(jnp.asarray(th.goal[:B])),
                pqr.Theta(torch.tensor(th.goal[:B])))
    return None, None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    jm, pm = MODELS[name]
    jth, pth = _thetas(name)
    check_model_against_jax(jm, pm, jth, pth, seed=3)
    jb = jm.bounds() if name != "concar_quad" else jm.bounds(1.7, 3.2)
    pb = pm.bounds() if name != "concar_quad" else pm.bounds(1.7, 3.2)
    np.testing.assert_array_equal(tnp(pb.lower), np.asarray(jb.lower))
    np.testing.assert_array_equal(tnp(pb.upper), np.asarray(jb.upper))
    np.testing.assert_array_equal(tnp(pm.initial_controls()),
                                  np.asarray(jm.initial_controls()))
    assert pm.problem().contact is False and pm.problem().nc == jm.NC
    if name == "concar_quad":
        assert (pm.SEED1_GOLDEN_OBJECTIVE, pm.SEED1_GOLDEN_ITERATIONS) == \
            (jm.SEED1_GOLDEN_OBJECTIVE, jm.SEED1_GOLDEN_ITERATIONS)
    else:
        assert (pm.ANCHOR_OBJECTIVE, pm.ANCHOR_ITERATIONS) == \
            (jm.ANCHOR_OBJECTIVE, jm.ANCHOR_ITERATIONS)
        np.testing.assert_array_equal(tnp(pm.initial_state()),
                                      np.asarray(jm.initial_state()))


def test_params_reader_matches_jax_generator():
    for name, (jm, pm) in MODELS.items():
        check_params_reader(jm, pm, name)


def _check(sol, golden_obj, golden_iters):
    """tests/test_benchmarks.py::_check on lane 0."""
    assert bool(sol.converged[0]), f"status={int(sol.status[0])}"
    np.testing.assert_allclose(float(sol.objective[0]), golden_obj, rtol=1e-6)
    iters = int(sol.iterations[0])
    assert abs(iters - golden_iters) <= max(3, int(0.1 * golden_iters) + 1), \
        f"iterations {iters} vs golden {golden_iters}"


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MODELS))
def test_golden_solve(name):
    """Seed 1 of concar_quad (85 / 1.93358805), the quadrotor and swing-up
    anchors (the default instances), full horizon on the CPU."""
    _, pm = MODELS[name]
    opts = P.Options(optimality_tolerance=1e-7)
    if name == "concar_quad":
        theta, f_lim, tau_lim, x1 = pm.seed1_instance()
        sol = P.solve(pm.problem(), pm.bounds(f_lim, tau_lim), x1[None],
                      pm.initial_controls()[None],
                      theta=pm.Theta(theta.obstacles[None]), options=opts,
                      device="cpu")
        _check(sol, pm.SEED1_GOLDEN_OBJECTIVE, pm.SEED1_GOLDEN_ITERATIONS)
        return
    theta = None
    if name == "quadrotor":
        th, _ = pm.default_instance()
        theta = pm.Theta(th.goal[None])
    sol = P.solve(pm.problem(), pm.bounds(), pm.initial_state()[None],
                  pm.initial_controls()[None], theta=theta, options=opts,
                  device="cpu")
    _check(sol, pm.ANCHOR_OBJECTIVE, pm.ANCHOR_ITERATIONS)
