"""The port's inertia oracles against the JAX package: the eigh oracle and
the unpivoted `kkt_factor_and_inertia` (`ops/ldlt.py`), the backward sweep
under `inertia_method="bk"` and `"eigh"` (`backward.sweep_plain`) against
JAX's `_run_pass` on a short-horizon acrobot state with randomized
trajectories and duals, and how the sweep is routed to a kernel.

Tolerances: inertia counts, `ok`, `fail` and `singular` are exact.
Eigenvalues agree to 1e-12 of the largest (two LAPACK-class eigensolvers),
the unpivoted factor to 1e-12 (same eliminations), solves to 1e-9. The
sweeps' gains, on the lanes that pass: bk to rtol 1e-10 (the same
eliminations and pivots; the stage arithmetic and the triangular solves in
another order, amplified through 16 stages, measured 2e-13); eigh to rtol
1e-6 (the two eigensolvers return other eigenvector bases, and an eigh
solve loses componentwise accuracy on these graded KKT systems, the JAX
package's own finding: measured 3e-8)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
import ipddp2tpu.backward as jb
import ipddp2tpu.derivatives as jd
from ipddp2tpu.models import acrobot as jac
from ipddp2tpu.ops import ldlt as jl

import ipddp2tpu_torch as P
from ipddp2tpu_torch import backward as pb
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.models import acrobot as pac
from ipddp2tpu_torch.ops import backward_cuda
from ipddp2tpu_torch.ops import ldlt as pl_

from torch_port_helpers import T_SHORT, tnp

B = 4


def _kkt(seed, n=12, nu=5, nc=3, definite=True):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, nu, nu))
    H = G @ G.transpose(0, 2, 1) + 0.1 * np.eye(nu)
    if not definite:
        H = H - 3.0 * np.eye(nu)
    A = rng.standard_normal((n, nc, nu))
    K = np.zeros((n, nu + nc, nu + nc))
    K[:, :nu, :nu] = H
    K[:, :nu, nu:] = A.transpose(0, 2, 1)
    K[:, nu:, :nu] = A
    K[:, nu:, nu:] = -1e-2 * np.eye(nc)
    return K, rng.standard_normal((n, nu + nc, 3))


def test_eigh_and_kkt_factor_match_jax():
    for definite in (True, False):
        K, rhs = _kkt(3, definite=definite)
        K[0, -1, -1] = 0.0               # one with an exactly-zero pivot
        K[0, -1, :] = K[0, :, -1] = 0.0
        ref = jax.vmap(lambda k: jl.eigh_factor_and_inertia(k, atol=1e-12))(
            jnp.asarray(K))
        out = pl_.eigh_factor_and_inertia(torch.as_tensor(K), atol=1e-12)
        for name in ("ok", "n_pos", "n_zero"):
            np.testing.assert_array_equal(tnp(getattr(out, name)),
                                          np.asarray(getattr(ref, name)))
        w = np.asarray(ref.w)
        np.testing.assert_allclose(tnp(out.w), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())
        sol = jax.vmap(jl.eigh_solve)(ref, jnp.asarray(rhs))
        x = pl_.eigh_solve(out, torch.as_tensor(rhs))
        np.testing.assert_allclose(tnp(x)[1:], np.asarray(sol)[1:],
                                   rtol=1e-9, atol=1e-9)
        # unpivoted LDL^T behind kkt_factor_and_inertia
        refl = jax.vmap(lambda k: jl.kkt_factor_and_inertia(k, atol=1e-12))(
            jnp.asarray(K))
        outl = pl_.kkt_factor_and_inertia(torch.as_tensor(K), atol=1e-12)
        for name in ("ok", "n_pos", "n_zero"):
            np.testing.assert_array_equal(tnp(getattr(outl, name)),
                                          np.asarray(getattr(refl, name)))
        low = np.tril(np.ones(K.shape[1:], bool))
        a, b = tnp(outl.ld)[:, low], np.asarray(refl.ld)[:, low]
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=1e-12)


@functools.cache
def _acrobot():
    """Acrobot at T = 16 in both packages (the same stage functions)."""
    jp = J.Problem(T=T_SHORT, nx=jac.NX, nu=jac.NU, nc=jac.NC,
                   dynamics=jac.dynamics, stage_cost=jac.stage_cost,
                   terminal_cost=jac.terminal_cost,
                   constraints=jac.constraints, contact=True)
    pp = P.Problem(T=T_SHORT, nx=pac.NX, nu=pac.NU, nc=pac.NC,
                   dynamics=pac.dynamics, stage_cost=pac.stage_cost,
                   terminal_cost=pac.terminal_cost,
                   constraints=pac.constraints, contact=True,
                   device_model="acrobot")
    return jp, pp


def _acrobot_inputs(seed):
    """Randomized trajectories, duals and slacks (order bugs hide at uniform
    duals); il / iu infinite where acrobot has no bound."""
    rng = np.random.default_rng(seed)
    T, nx, nu, nc = T_SHORT, jac.NX, jac.NU, jac.NC
    lo = np.asarray(jac.bounds().lower)[0]
    hi = np.asarray(jac.bounds().upper)[0]
    shp = lambda *d: (B,) + d
    il = np.where(np.isfinite(lo), 0.2 + rng.uniform(size=shp(T, nu)),
                  np.inf)
    iu = np.where(np.isfinite(hi), 0.2 + rng.uniform(size=shp(T, nu)),
                  np.inf)
    return dict(
        theta=np.stack([0.9 + 0.2 * rng.uniform(size=B) for _ in range(4)]),
        x=0.3 * rng.standard_normal(shp(T + 1, nx)),
        u=0.3 * rng.standard_normal(shp(T, nu)),
        phi=rng.standard_normal(shp(T, nc)),
        c=0.1 * rng.standard_normal(shp(T, nc)),
        il=il, iu=iu,
        zl=np.where(np.isfinite(lo), 0.05 + rng.uniform(size=shp(T, nu)), 0.0),
        zu=np.where(np.isfinite(hi), 0.05 + rng.uniform(size=shp(T, nu)), 0.0))


@functools.partial(jax.jit, static_argnames=("jp", "method"))
def _jax_sweep(jp, theta, x, u, phi, nominal, mu, reg, dc, method):
    th = jac.Theta(*theta)
    deriv = jax.vmap(lambda t, a, b, c: jd.evaluate_derivatives(
        jp, t, a, b, c))(th, x, u, phi)
    lam = jax.vmap(lambda d, p: jb.costate_scan(d, p, mode="seq"))(deriv, phi)
    second = deriv.cH_phi + jax.vmap(
        lambda t, a, b, l: jd.contract_dynamics_hessian(jp, t, a, b, l))(
            th, x, u, lam[:, 1:])
    opts = J.Options(inertia_method=method)
    out = jax.vmap(lambda d, n, s, m, r, c: jb._run_pass(
        jp, d, n, m, r, c, opts, second=s))(deriv, nominal, second, mu, reg,
                                            dc)
    return deriv, second, out


@pytest.mark.parametrize("method", ["bk", "eigh"])
def test_sweep_plain_matches_jax_run_pass(method):
    jp, pp = _acrobot()
    inp = _acrobot_inputs(5)
    nominal = tuple(jnp.asarray(inp[k])
                    for k in ("c", "il", "iu", "phi", "zl", "zu"))
    mu = np.full(B, 0.1)
    # lane 0's control Hessian pushed indefinite (wrong inertia there)
    reg = np.array([-50.0, 1e-3, 0.5, 20.0])
    dc = np.array([0.0, 1e-8, 0.0, 1e-8])
    deriv, second, ref = _jax_sweep(
        jp, tuple(jnp.asarray(t) for t in inp["theta"]),
        jnp.asarray(inp["x"]), jnp.asarray(inp["u"]), jnp.asarray(inp["phi"]),
        nominal, jnp.asarray(mu), jnp.asarray(reg), jnp.asarray(dc),
        method=method)
    d = convert.deriv_from_numpy(deriv)
    n = tuple(torch.as_tensor(np.array(a)) for a in nominal)
    gains, dL, fail, sing = pb._run_pass(
        pp, d, n, torch.as_tensor(mu), torch.as_tensor(reg),
        torch.as_tensor(dc), P.Options(inertia_method=method),
        second=torch.as_tensor(np.array(second)))
    rgains, rdL, rfail, rsing = ref
    np.testing.assert_array_equal(tnp(fail), np.asarray(rfail))
    np.testing.assert_array_equal(tnp(sing), np.asarray(rsing))
    ok = ~np.asarray(rfail)
    assert ok.any() and not ok.all(), np.asarray(rfail)
    rtol = {"bk": 1e-10, "eigh": 1e-6}[method]
    for a, b, name in zip(gains, rgains, pb.Gains._fields):
        b = np.asarray(b)[ok]
        np.testing.assert_allclose(tnp(a)[ok], b, rtol=rtol,
                                   atol=rtol * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_allclose(tnp(dL)[ok], np.asarray(rdL)[ok], rtol=rtol)


def test_routing_of_the_sweep():
    """ldl and bk take their kernel on a GPU, eigh never; the kernel route
    raises for CPU tensors and for eigh; auto resolves to bk on the contact
    models."""
    gpu, cpu = types.SimpleNamespace(is_cuda=True), torch.zeros(1)
    use = lambda **kw: pb._use_cuda_kernel(P.Options(**kw), gpu)
    assert use(inertia_method="bk") and use(inertia_method="ldl")
    assert use(inertia_method="auto")
    assert not use(inertia_method="eigh")
    assert not use(inertia_method="bk", backward_kernel="torch")
    assert not pb._use_cuda_kernel(P.Options(inertia_method="bk"), cpu)
    with pytest.raises(ValueError, match="eigh"):
        use(inertia_method="eigh", backward_kernel="cuda")

    jp, pp = _acrobot()
    inp = _acrobot_inputs(6)
    th = pac.Theta(*(torch.as_tensor(t) for t in inp["theta"]))
    d = P.derivatives.evaluate_derivatives(
        pp, th, *(torch.as_tensor(inp[k]) for k in ("x", "u", "phi")))
    n = tuple(torch.as_tensor(inp[k])
              for k in ("c", "il", "iu", "phi", "zl", "zu"))
    mu = torch.full((B,), 0.1, dtype=torch.float64)
    for method, err in (("bk", RuntimeError), ("eigh", ValueError)):
        with pytest.raises(err):
            pb.sweep_attempts(pp, d, n, None, mu, P.Options(
                inertia_method=method, backward_kernel="cuda"))
    # on the CPU "auto" takes the plain sweep of the method asked for
    attempt = pb.sweep_attempts(pp, d, n, None, mu,
                                P.Options(inertia_method="bk"))
    assert attempt(torch.zeros_like(mu), torch.zeros_like(mu))[2].shape \
        == (B,)

    from ipddp2tpu_torch.models import (cartpole, cartpole_swingup,
                                        concar_quad, pushing, quadrotor)
    from ipddp2tpu_torch.solve import resolve_options
    for mod, want in ((pac, "bk"), (cartpole, "bk"), (pushing, "bk"),
                      (concar_quad, "ldl"), (quadrotor, "ldl"),
                      (cartpole_swingup, "ldl")):
        assert resolve_options(P.Options(), mod.problem()) \
            .inertia_method == want


def test_bk_launch_geometry():
    """A warp an instance for acrobot (m = 15), pushing (17) and cartpole
    (35), four of them a block, their shared memory (the source's
    `LayBK<T>`) within the card's 227 KB. The LDL^T kernel takes cartpole's
    m = 35 as a warp an instance too (the source's `LayW<T>`: two of them a
    block in double); both refuse m = 65, also for a build."""
    geo = backward_cuda.launch_geometry
    for nx, nu, nc in ((4, 9, 6), (4, 11, 6), (4, 21, 14)):
        g = geo(nx, nu, nc, inertia="bk")
        m, nk = nu + nc, nx + 1
        assert (g.lanes, g.instances_per_block, g.threads) == (32, 4, 128)
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            a = 16 // size
            up = lambda v: -(-v // a) * a
            nz = nx + nu
            stage = sum(up(v) for v in (
                nx * nx, nx * nu, nx, nu, nx * nx, nu * nx, nu * nu,
                nc * nx, nc * nu, nz * nz, nc, nu, nu, nc, nu, nu))
            rest = (m * (m + 1) + 4 * m * nk + 2 * nx * nx + 2 * nx
                    + 7 * m)
            assert g.smem_bytes[dtype] == 4 * up(2 * stage + rest) * size
        assert g.smem_bytes[torch.float64] <= 232448
    # cartpole: 46,128 bytes an instance in double (35 x 36 of them A)
    assert geo(4, 21, 14, inertia="bk").smem_bytes[torch.float64] \
        == 4 * 46128
    # the LDL^T sweep at cartpole's m = 35: K, its working copy and L
    # [35][36] each, rhs and X [35][5], C, Vxx, Vx, Vx', the pivot order
    g = geo(4, 21, 14)
    assert (g.lanes, g.instances_per_block, g.threads) == (32, 2, 64)
    assert g.smem_bytes == {torch.float32: 2 * 31072,
                            torch.float64: 2 * 61808}
    for inertia in ("ldl", "bk"):
        with pytest.raises(ValueError, match="65 > 64"):
            geo(4, 21, 44, inertia=inertia)
        with pytest.raises(ValueError, match="65 > 64"):
            backward_cuda.start_build(4, 21, 44, inertia=inertia)
    with pytest.raises(ValueError, match="no kernel"):
        geo(4, 9, 6, inertia="eigh")
    assert geo(4, 9, 6).lanes == 16            # acrobot's ldl group
