"""The port's contact models (`acrobot`, `cartpole`, `pushing`:
`contact=True`, so `inertia_method="auto"` takes rook Bunch-Kaufman)
against the JAX package's: stage, terminal and constraint values and the
whole derivative bundle on random trajectories and duals, bounds and first
guesses, the reader of the campaign's instance data (`experiments/params`)
against the JAX generator that wrote it, and five iterations of a
short-horizon acrobot solve through the bk path.

Tolerances: values rtol 1e-12, the derivative bundle rtol 1e-10 (AD in
other association orders), params and bounds bit for bit; the iterates
after 5 iterations to 1e-8 (as tests/test_torch_solve.py). The slow golden solves (T = 100, eager CPU
torch) follow tests/test_benchmarks.py: acrobot and cartpole by `_check`
(objective to 1e-6, iterations within max(3, 10 % + 1)); pushing converged
with its objective within 10 % of the reference's (a nearby local optimum,
as the JAX package)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
from ipddp2tpu.batch import solve_batch as j_solve_batch
from ipddp2tpu.models import acrobot as jac
from ipddp2tpu.models import cartpole as jcp
from ipddp2tpu.models import pushing as jpu

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.models import acrobot as pac
from ipddp2tpu_torch.models import cartpole as pcp
from ipddp2tpu_torch.models import pushing as ppu

from torch_port_helpers import (T_SHORT, check_model_against_jax,
                                check_params_reader, params_instances,
                                short_pair, tnp)

MODELS = {"acrobot": (jac, pac), "cartpole": (jcp, pcp),
          "pushing": (jpu, ppu)}


def _thetas(name, B):
    """Instances 0..B-1 of the campaign's theta in both packages."""
    jm, pm = MODELS[name]
    th = params_instances(jm, name)[0]
    cut = lambda a: a[:B]
    return (jm.Theta(*(jnp.asarray(cut(a)) for a in th)),
            pm.Theta(*(torch.tensor(cut(a)) for a in th)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    jm, pm = MODELS[name]
    check_model_against_jax(jm, pm, *_thetas(name, 3), seed=4)
    jb, pb = jm.bounds(), pm.bounds()
    np.testing.assert_array_equal(tnp(pb.lower), np.asarray(jb.lower))
    np.testing.assert_array_equal(tnp(pb.upper), np.asarray(jb.upper))
    np.testing.assert_array_equal(tnp(pm.initial_controls()),
                                  np.asarray(jm.initial_controls()))
    assert pm.problem().contact and jm.problem().contact
    assert (pm.SEED1_GOLDEN_OBJECTIVE, pm.SEED1_GOLDEN_ITERATIONS) == \
        (jm.SEED1_GOLDEN_OBJECTIVE, jm.SEED1_GOLDEN_ITERATIONS)
    for a, b in zip(pm.seed1_instance(), jm.seed1_instance()):
        np.testing.assert_array_equal(tnp(a), np.asarray(b))


def test_params_reader_matches_jax_generator():
    for name, (jm, pm) in MODELS.items():
        check_params_reader(jm, pm, name)


def test_acrobot_short_solve_matches_jax():
    """Five iterations at T = 16 on four campaign instances, default
    options: `auto` resolves to bk in both packages."""
    B, T = 4, T_SHORT
    jp, pp = short_pair(jac, pac, T)
    jth, pth = _thetas("acrobot", B)
    jb, pb = jac.bounds(), pac.bounds()
    cut = lambda a: a[:T]
    ref = j_solve_batch(
        jp, J.Bounds(*(jnp.broadcast_to(cut(a), (B, T, jac.NU)) for a in jb)),
        jnp.zeros((B, jac.NX)),
        jnp.broadcast_to(cut(jac.initial_controls()), (B, T, jac.NU)),
        theta=jth, options=J.Options(
            max_iterations=5, optimality_tolerance=1e-7,
            backward_kernel="xla", forward_kernel="xla"))
    out = P.solve_batch(
        pp, P.Bounds(*(cut(a).expand(B, T, pac.NU) for a in pb)),
        torch.zeros((B, pac.NX), dtype=torch.float64),
        cut(pac.initial_controls()).expand(B, T, pac.NU), theta=pth,
        options=P.Options(max_iterations=5, optimality_tolerance=1e-7),
        device="cpu")
    np.testing.assert_array_equal(tnp(out.iterations),
                                  np.asarray(ref.iterations))
    for name in ("x", "u", "phi", "zl", "zu"):
        a, b = tnp(getattr(out, name)), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8, err_msg=name)
    np.testing.assert_allclose(tnp(out.objective), np.asarray(ref.objective),
                               rtol=1e-8)


def _solve_seed1(pm):
    theta = pm.seed1_instance()
    batched = type(theta)(*(a[None] for a in theta))
    return P.solve(pm.problem(), pm.bounds(), pm.initial_state()[None],
                   pm.initial_controls()[None], theta=batched,
                   options=P.Options(optimality_tolerance=1e-7), device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["acrobot", "cartpole"])
def test_golden_solve(name):
    """acrobot 157 / 1.33119481, cartpole 60 / 0.929397628 (seed 1),
    tests/test_benchmarks.py::_check."""
    _, pm = MODELS[name]
    sol = _solve_seed1(pm)
    assert bool(sol.converged[0]), f"status={int(sol.status[0])}"
    np.testing.assert_allclose(float(sol.objective[0]),
                               pm.SEED1_GOLDEN_OBJECTIVE, rtol=1e-6)
    iters, golden = int(sol.iterations[0]), pm.SEED1_GOLDEN_ITERATIONS
    assert abs(iters - golden) <= max(3, int(0.1 * golden) + 1), \
        f"iterations {iters} vs golden {golden}"


@pytest.mark.slow
def test_pushing_seed1_converges():
    """tests/test_benchmarks.py::test_pushing_seed1: converged, objective
    within 10 % of the reference's, primal error below 1e-7."""
    sol = _solve_seed1(ppu)
    assert bool(sol.converged[0]), f"status={int(sol.status[0])}"
    np.testing.assert_allclose(float(sol.objective[0]),
                               ppu.SEED1_GOLDEN_OBJECTIVE, rtol=0.1)
    assert float(sol.primal_inf[0]) < 1e-7
