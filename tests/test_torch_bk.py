"""Port rook Bunch-Kaufman (`ipddp2tpu_torch/ops/bk.py`) against the JAX
package's `ops/bk.py` on the matrices of tests/test_bk.py: plain symmetric,
graded indefinite (a Sigma-like 1e0..1e8 scaling) and near-singular, at
m = 3, 10, 35, twenty of each, as one batch per kind.

Tolerances: the permutation, `info` and the inertia counts are integers and
must be equal. L, d and e are the same eliminations in the same order but
not bit-identical (XLA fuses multiply-adds), so they agree to 1e-10 of each
matrix's largest factor entry; the solve (two triangular solves in another
library) to 1e-10 relative on the plain and graded matrices, and on the
near-singular ones through its residual."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipddp2tpu.ops import bk as jbk
from ipddp2tpu_torch.ops import bk as pbk

from torch_port_helpers import tnp

KINDS = ("plain", "indef_graded", "near_singular")
SIZES = (3, 10, 35)


def _random_sym(key, m, kind):
    """tests/test_bk.py::_random_sym."""
    A = jax.random.normal(key, (m, m), dtype=jnp.float64)
    A = 0.5 * (A + A.T)
    if kind == "indef_graded":
        s = 10.0 ** jnp.linspace(0, 8, m)
        A = A * jnp.outer(jnp.sqrt(s), jnp.sqrt(s))
    elif kind == "near_singular":
        w, V = jnp.linalg.eigh(A)
        w = w.at[0].set(1e-14)
        A = (V * w) @ V.T
        A = 0.5 * (A + A.T)
    return A


def _batch(kind, m):
    base = {"plain": 0, "indef_graded": 1, "near_singular": 2}[kind]
    keys = jax.random.split(jax.random.PRNGKey(1000 * base + m), 20)
    return np.stack([np.asarray(_random_sym(k, m, kind)) for k in keys])


_factor = jax.jit(jax.vmap(jbk.bk_factor_rook))
_inertia = jax.jit(jax.vmap(lambda f: jbk.bk_inertia(f, atol=1e-12)))
_solve = jax.jit(jax.vmap(jbk.bk_solve))


@pytest.mark.parametrize("kind", KINDS)
def test_factors_and_inertia_match_jax(kind):
    for m in SIZES:
        A = _batch(kind, m)
        ref = _factor(jnp.asarray(A))
        out = pbk.bk_factor_rook(torch.as_tensor(A))
        np.testing.assert_array_equal(tnp(out.perm), np.asarray(ref.perm))
        np.testing.assert_array_equal(tnp(out.info), np.asarray(ref.info))
        for name in ("L", "d", "e"):
            a, b = tnp(getattr(out, name)), np.asarray(getattr(ref, name))
            assert np.isfinite(a).all() and np.isfinite(b).all()
            assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), \
                (kind, m, name)
        for a, b in zip(pbk.bk_inertia(out, atol=1e-12), _inertia(ref)):
            np.testing.assert_array_equal(tnp(a), np.asarray(b))
        counts = sum(tnp(c) for c in pbk.bk_inertia(out, atol=1e-12))
        assert (counts == m).all()


def test_solve_matches_jax():
    rng = np.random.default_rng(7)
    for kind in KINDS:
        A = _batch(kind, 20 if kind != "near_singular" else 10)
        m = A.shape[-1]
        rhs = rng.standard_normal((len(A), m, 5))
        ref = np.asarray(_solve(_factor(jnp.asarray(A)), jnp.asarray(rhs)))
        X = tnp(pbk.bk_solve(pbk.bk_factor_rook(torch.as_tensor(A)),
                             torch.as_tensor(rhs)))
        if kind == "near_singular":
            # ill-conditioned (a 1e-14 eigenvalue): both solves are
            # backward stable, not close to each other
            for sol in (X, ref):
                r = A @ sol - rhs
                scale = np.abs(A).max() * np.abs(sol).max() + np.abs(rhs).max()
                assert np.abs(r).max() <= 1e-10 * scale
        else:
            np.testing.assert_allclose(X, ref, rtol=1e-10,
                                       atol=1e-10 * np.abs(ref).max())


def test_zero_pivot_sets_info_like_jax():
    A = np.zeros((3, 4, 4))
    A[1] = np.diag([2.0, 0.0, 0.0, 1.0])   # a zero column after one step
    A[2] = np.diag([1.0, -1.0, 3.0, 2.0])
    ref = _factor(jnp.asarray(A))
    out = pbk.bk_factor_rook(torch.as_tensor(A))
    np.testing.assert_array_equal(tnp(out.info), np.asarray(ref.info))
    assert tnp(out.info).tolist()[0] > 0 and tnp(out.info).tolist()[2] == 0
    # a batch with leading dimensions keeps them
    out2 = pbk.bk_factor_rook(torch.as_tensor(A).reshape(3, 1, 4, 4))
    assert out2.L.shape == (3, 1, 4, 4) and out2.info.shape == (3, 1)
    np.testing.assert_array_equal(tnp(out2.info)[:, 0], tnp(out.info))
