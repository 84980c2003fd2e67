"""Port LDL^T (pivoted factor, solve, refinement, residual gate) against the
JAX package's `ops/ldlt.py` on indefinite KKT matrices.

Tolerances: the pivot permutation and the inertia counts are integers and
must be equal; factors and solutions agree to rtol 1e-10 (same elimination
order, other summation order inside the triangular solves)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipddp2tpu.ops import ldlt as jl
from ipddp2tpu_torch.ops import ldlt as pl_

from torch_port_helpers import tnp

NU, NC, N = 5, 3, 12
M = NU + NC

# the JAX references, compiled once for the module's shape
_j_factor = jax.jit(jax.vmap(jl.ldlt_factor_pivoted))
_j_solve = jax.jit(jax.vmap(jl.ldlt_solve))


@functools.partial(jax.jit, static_argnames="refine")
def _j_refined(K, b, refine):
    f = jax.vmap(jl.ldlt_factor_pivoted)(K)
    return f, jax.vmap(lambda f, a, r: jl.ldlt_solve_refined(
        f, a, r, refine_steps=refine, check_residual=True))(f, K, b)


def kkt_batch(seed, definite=True):
    """Random KKT matrices [[H, A^T], [A, -dc I]]; with `definite` H is SPD
    (inertia (nu, nc, 0)), else H is indefinite."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N, NU, NU))
    H = G @ G.transpose(0, 2, 1) + 0.1 * np.eye(NU)
    if not definite:
        H = H - 3.0 * np.eye(NU)
    A = rng.standard_normal((N, NC, NU))
    K = np.zeros((N, M, M))
    K[:, :NU, :NU] = H
    K[:, :NU, NU:] = A.transpose(0, 2, 1)
    K[:, NU:, :NU] = A
    K[:, NU:, NU:] = -1e-8 * np.eye(NC)
    return K, rng.standard_normal((N, M, 4))


@pytest.mark.parametrize("definite", [True, False])
def test_factor_matches_jax(definite):
    K, _ = kkt_batch(0, definite)
    ref = _j_factor(jnp.asarray(K))
    out = pl_.ldlt_factor_pivoted(torch.as_tensor(K))
    np.testing.assert_array_equal(tnp(out.perm), np.asarray(ref.perm))
    np.testing.assert_array_equal(tnp(out.n_pos), np.asarray(ref.n_pos))
    np.testing.assert_array_equal(tnp(out.n_zero), np.asarray(ref.n_zero))
    np.testing.assert_array_equal(tnp(out.ok), np.asarray(ref.ok))
    low = np.tril(np.ones((M, M), bool))
    np.testing.assert_allclose(tnp(out.ld)[:, low], np.asarray(ref.ld)[:, low],
                               rtol=1e-10, atol=1e-12)
    if definite:
        assert tnp(out.n_pos).tolist() == [NU] * N
    else:
        assert (tnp(out.n_pos) != NU).any()
    # Sylvester: pivot signs = eigenvalue signs
    w = np.linalg.eigvalsh(K)
    np.testing.assert_array_equal(tnp(out.n_pos), (w > 0).sum(axis=1))


def test_pivot_tie_takes_first_index():
    K = np.diag([2.0, -2.0, 2.0, 1.0])[None]
    ref = jl.ldlt_factor_pivoted(jnp.asarray(K[0]))
    out = pl_.ldlt_factor_pivoted(torch.as_tensor(K))
    assert tnp(out.perm)[0].tolist() == np.asarray(ref.perm).tolist() \
        == [0, 1, 2, 3]


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_refined_solve_matches_jax(refine):
    K, b = kkt_batch(1)
    _, (rx, rok) = _j_refined(jnp.asarray(K), jnp.asarray(b), refine)
    pf = pl_.ldlt_factor_pivoted(torch.as_tensor(K))
    x, ok = pl_.ldlt_solve_refined(pf, torch.as_tensor(K), torch.as_tensor(b),
                                   refine_steps=refine, check_residual=True)
    np.testing.assert_allclose(tnp(x), np.asarray(rx), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(tnp(ok), np.asarray(rok))
    assert tnp(ok).all()
    np.testing.assert_allclose(K @ tnp(x), b, rtol=1e-9, atol=1e-9)


def test_plain_solve_vector_and_matrix_rhs():
    K, b = kkt_batch(2)
    pf = pl_.ldlt_factor_pivoted(torch.as_tensor(K))
    xm = pl_.ldlt_solve(pf, torch.as_tensor(b))
    xv = pl_.ldlt_solve(pf, torch.as_tensor(b[..., 0]))
    np.testing.assert_allclose(tnp(xv), tnp(xm)[..., 0], rtol=1e-13)
    ref = _j_solve(_j_factor(jnp.asarray(K)), jnp.asarray(b))
    np.testing.assert_allclose(tnp(xm), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_residual_gate_fires_on_singular_matrix():
    """A singular KKT (one constraint row all zero, delta_c = 0): an exactly
    zero pivot -> not ok, n_zero = 1, and the residual gate rejects the
    solve (the guarded divide leaves that row's residual at its right-hand
    side) — in both packages."""
    K, b = kkt_batch(3)
    K[:, NU, :] = 0.0
    K[:, :, NU] = 0.0
    jf, (_, rok) = _j_refined(jnp.asarray(K), jnp.asarray(b), 1)
    pf = pl_.ldlt_factor_pivoted(torch.as_tensor(K))
    _, ok = pl_.ldlt_solve_refined(pf, torch.as_tensor(K), torch.as_tensor(b),
                                   refine_steps=1, check_residual=True)
    assert not tnp(pf.ok).any() and not tnp(ok).any()
    assert tnp(pf.n_zero).tolist() == [1] * N
    np.testing.assert_array_equal(tnp(pf.n_zero), np.asarray(jf.n_zero))
    np.testing.assert_array_equal(tnp(ok), np.asarray(rok))


def test_empty_matrix():
    f = pl_.ldlt_factor_pivoted(torch.zeros((3, 0, 0), dtype=torch.float64))
    assert f.ok.all() and f.n_pos.tolist() == [0, 0, 0]
