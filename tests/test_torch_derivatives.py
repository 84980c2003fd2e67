"""Port derivatives against the JAX package on randomized trajectories and
duals: every `DerivativeBundle` field, the costate-contracted dynamics
Hessian, objective and constraints.

Tolerance: rtol 1e-10 (atol 1e-12) in float64 — both sides differentiate the
same formulas by forward/reverse-mode AD, in other association orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu.derivatives as jd
from ipddp2tpu_torch import derivatives as pd
from ipddp2tpu_torch.derivatives import DerivativeBundle

from torch_port_helpers import (concar_instances, jconcar, pconcar,
                                short_concar, tiny_inputs, tiny_problems, tnp)

B, T = 3, 8
RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(scope="module")
def concar_case():
    jp, pp = short_concar(T)
    inst = concar_instances(0, B, T)
    rng = np.random.default_rng(1)
    x = 0.5 * rng.standard_normal((B, T + 1, 4))
    u = 0.5 * rng.standard_normal((B, T, 10))
    phi = rng.standard_normal((B, T, 4))
    lam = rng.standard_normal((B, T, 4))
    jth = jconcar.Theta(jnp.asarray(inst["obstacles"]))
    pth = pconcar.Theta(torch.as_tensor(inst["obstacles"]))
    jx, ju, jphi = map(jnp.asarray, (x, u, phi))
    # compiled once each: eager dispatch of the vmapped derivatives is slow
    batched = lambda f: jax.jit(jax.vmap(f))
    ref = dict(
        deriv=batched(lambda th, a, b, c: jd.evaluate_derivatives(
            jp, th, a, b, c, with_dynamics_hessian=True))(jth, jx, ju, jphi),
        contract=batched(lambda th, a, b, l: jd.contract_dynamics_hessian(
            jp, th, a, b, l))(jth, jx, ju, jnp.asarray(lam)),
        objective=batched(lambda th, a, b: jd.evaluate_objective(
            jp, th, a, b))(jth, jx, ju),
        constraints=batched(lambda th, a, b: jd.evaluate_constraints(
            jp, th, a, b))(jth, jx, ju))
    tx, tu, tphi = map(torch.as_tensor, (x, u, phi))
    out = dict(
        deriv=pd.evaluate_derivatives(pp, pth, tx, tu, tphi,
                                      with_dynamics_hessian=True),
        contract=pd.contract_dynamics_hessian(pp, pth, tx, tu,
                                              torch.as_tensor(lam)),
        objective=pd.evaluate_objective(pp, pth, tx, tu),
        constraints=pd.evaluate_constraints(pp, pth, tx, tu),
        lam=torch.as_tensor(lam))
    return ref, out


@pytest.mark.parametrize("field", DerivativeBundle._fields)
def test_bundle_field_matches_jax(concar_case, field):
    ref, out = concar_case
    a, b = getattr(out["deriv"], field), getattr(ref["deriv"], field)
    assert a.dtype == torch.float64
    np.testing.assert_allclose(tnp(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("what", ["contract", "objective", "constraints"])
def test_scalar_fields_match_jax(concar_case, what):
    ref, out = concar_case
    np.testing.assert_allclose(tnp(out[what]), np.asarray(ref[what]),
                               rtol=RTOL, atol=ATOL)


def test_contraction_equals_full_hessian_contracted(concar_case):
    """lam . d2f computed directly equals the full tensor contracted."""
    _, out = concar_case
    full = torch.einsum("bti,btijk->btjk", out["lam"], out["deriv"].fH)
    np.testing.assert_allclose(tnp(out["contract"]), tnp(full),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nc", [2, 0])
def test_tiny_problem_bundle_matches_jax(nc):
    jp, pp = tiny_problems(nc)()
    inp = tiny_inputs(0, 4, nc)
    ref = jax.vmap(lambda a, b, c: jd.evaluate_derivatives(jp, None, a, b, c))(
        *(jnp.asarray(inp[k]) for k in ("x", "u", "phi")))
    out = pd.evaluate_derivatives(
        pp, None, *(torch.as_tensor(inp[k]) for k in ("x", "u", "phi")))
    for field in DerivativeBundle._fields:
        a, b = getattr(out, field), getattr(ref, field)
        if b is None:
            assert a is None
            continue
        assert tuple(a.shape) == tuple(b.shape), field
        np.testing.assert_allclose(tnp(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=field)


def test_float32_bundle_stays_float32():
    """A float32 state gives float32 derivatives (forward-mode tangents of
    0-dim tensors scaled by Python floats come out float64 in torch)."""
    _, pp = tiny_problems(2)()
    inp = tiny_inputs(0, 2, 2, np.float32)
    out = pd.evaluate_derivatives(
        pp, None, *(torch.as_tensor(inp[k]) for k in ("x", "u", "phi")))
    assert all(a.dtype == torch.float32 for a in out if a is not None)
    lam = torch.as_tensor(inp["x"][:, 1:])
    sec = pd.contract_dynamics_hessian(pp, None, torch.as_tensor(inp["x"]),
                                       torch.as_tensor(inp["u"]), lam)
    assert sec.dtype == torch.float32


def test_relax_constraints_matches_jax():
    import dataclasses
    jp, pp = tiny_problems(2)()
    jp = dataclasses.replace(jp, compl_indices=(1,))
    pp = dataclasses.replace(pp, compl_indices=(1,))
    c = np.random.default_rng(0).standard_normal((4, 6, 2))
    mu = np.array([0.1, 0.2, 0.3, 0.4])
    ref = jax.vmap(lambda a, m: jd.relax_constraints(jp, a, m))(
        jnp.asarray(c), jnp.asarray(mu))
    out = pd.relax_constraints(pp, torch.as_tensor(c), torch.as_tensor(mu))
    np.testing.assert_allclose(tnp(out), np.asarray(ref), rtol=0, atol=0)
