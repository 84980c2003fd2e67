"""Port models against the JAX models: values at random points.

Tolerance: rtol 1e-12 in float64 — the same formulas in the same order, so
only the libm of the two frameworks differs; float32 in gives float32 out
(the property tests/test_model_dtypes.py pins on the JAX side)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jconcar, jdi, pconcar, pdi, tnp)

MODELS = {"concar": (jconcar, pconcar), "double_integrator": (jdi, pdi)}
FUNCS = ("dynamics", "stage_cost", "terminal_cost", "constraints")


def _point(name, seed, dtype):
    jm, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(jm.NX).astype(dtype)
    u = rng.standard_normal(jm.NU).astype(dtype)
    obs = rng.uniform(size=(4, 3)).astype(dtype)
    return x, u, obs


def _call(mod, fn, x, u, theta):
    if fn == "terminal_cost":
        return mod.terminal_cost(x, theta)
    return getattr(mod, fn)(x, u, 3, theta)


@pytest.mark.parametrize("fn", FUNCS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_values_match_jax(name, fn):
    jm, pm = MODELS[name]
    for seed in range(5):
        x, u, obs = _point(name, seed, np.float64)
        jth = jconcar.Theta(jnp.asarray(obs)) if name == "concar" else None
        pth = pconcar.Theta(torch.as_tensor(obs)) if name == "concar" else None
        ref = np.asarray(_call(jm, fn, jnp.asarray(x), jnp.asarray(u), jth))
        out = tnp(_call(pm, fn, torch.as_tensor(x), torch.as_tensor(u), pth))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_in_float32_out(name):
    _, pm = MODELS[name]
    x, u, obs = _point(name, 0, np.float32)
    pth = pconcar.Theta(torch.as_tensor(obs)) if name == "concar" else None
    for fn in FUNCS:
        out = _call(pm, fn, torch.as_tensor(x), torch.as_tensor(u), pth)
        assert out.dtype == torch.float32, fn


def test_concar_bounds_and_guess_match_jax():
    f_lim, tau_lim = np.array([1.6, 2.2]), np.array([3.5, 4.5])
    jb = jconcar.bounds(jnp.asarray(f_lim), jnp.asarray(tau_lim))
    pb = pconcar.bounds(torch.as_tensor(f_lim), torch.as_tensor(tau_lim))
    np.testing.assert_array_equal(tnp(pb.lower), np.asarray(jb.lower))
    np.testing.assert_array_equal(tnp(pb.upper), np.asarray(jb.upper))
    np.testing.assert_array_equal(tnp(pconcar.initial_controls()),
                                  np.asarray(jconcar.initial_controls()))
    assert tnp(pb.num_bounds).tolist() == [int(jb.num_bounds) // 2] * 2


def test_double_integrator_bounds_and_guess_match_jax():
    jb, pb = jdi.bounds(), pdi.bounds()
    np.testing.assert_array_equal(tnp(pb.lower), np.asarray(jb.lower))
    np.testing.assert_array_equal(tnp(pb.upper), np.asarray(jb.upper))
    np.testing.assert_array_equal(tnp(pdi.initial_controls()),
                                  np.asarray(jdi.initial_controls()))
    assert (pdi.GOLDEN_OBJECTIVE, pdi.GOLDEN_ITERATIONS) == \
        (jdi.GOLDEN_OBJECTIVE, jdi.GOLDEN_ITERATIONS)


def test_concar_seed1_and_random_instances():
    jth, jf, jtau, jx1 = jconcar.seed1_instance()
    pth, pf, ptau, px1 = pconcar.seed1_instance()
    np.testing.assert_array_equal(tnp(pth.obstacles), np.asarray(jth.obstacles))
    np.testing.assert_array_equal(tnp(px1), np.asarray(jx1))
    assert (pf, ptau) == (jf, jtau)
    assert (pconcar.SEED1_GOLDEN_OBJECTIVE, pconcar.SEED1_GOLDEN_ITERATIONS) \
        == (jconcar.SEED1_GOLDEN_OBJECTIVE, jconcar.SEED1_GOLDEN_ITERATIONS)
    # the random generator's ranges (not its numbers) are the reference's
    g = torch.Generator().manual_seed(3)
    th, f, tau, x1 = pconcar.random_instances(64, g)
    assert th.obstacles.shape == (64, 4, 3) and x1.shape == (64, 4)
    assert bool(((f >= 1.5) & (f <= 2.5)).all())
    assert bool(((tau >= 3.0) & (tau <= 5.0)).all())
    r = th.obstacles[..., 2]
    assert bool(((r >= 0.05) & (r <= 0.2)).all())
    assert bool(((x1[:, 2] >= np.pi / 8) & (x1[:, 2] <= 3 * np.pi / 8)).all())
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(pconcar.random_instances(64, g2)[0].obstacles,
                       th.obstacles)
