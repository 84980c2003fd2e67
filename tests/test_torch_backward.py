"""The module that holds the backward-sweep kernel, against the JAX package.

On the CPU the port's sweep is its plain version (`backward._run_pass` /
`sweep_plain`); the CUDA kernel itself is held against that plain version on
the GPU by a phase of `chip_smoke.py`. Here the plain version is compared
with the JAX scan sweep AND with the JAX Pallas kernel in interpret mode, on
randomized trajectories and duals.

Tolerance: rtol 1e-9 / atol 1e-11 in float64, as tests/test_backward_pallas.py
holds the Pallas kernel to its scan (same arithmetic, other summation order,
amplified by the KKT conditioning); float32 at rtol 2e-3 / atol 2e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
import ipddp2tpu.backward as jb
import ipddp2tpu.derivatives as jd
from ipddp2tpu.ops.backward_pallas import backward_sweep_pallas

import ipddp2tpu_torch as P
from ipddp2tpu_torch import backward as pb
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.ops.backward_cuda import backward_sweep_cuda

from torch_port_helpers import tiny_inputs, tiny_problems, tnp

B = 4
GAINS = pb.Gains._fields


@functools.cache
def _problems(nc, bad_cost=False):
    """One pair of problems of each kind for the whole module, so that the
    JAX side compiles once per kind and shape."""
    return tiny_problems(nc)(bad_cost=bad_cost)


@functools.partial(jax.jit, static_argnames=("jp", "force_fail_lane",
                                             "kernel"))
def _jax_sweep(jp, x, u, phi, nominal, mu, reg, dc, force_fail_lane,
               kernel):
    deriv = jax.vmap(lambda a, b, c: jd.evaluate_derivatives(
        jp, None, a, b, c))(x, u, phi)
    if force_fail_lane is not None:
        luu = deriv.luu.at[force_fail_lane].add(
            -5.0 * jnp.eye(jp.nu, dtype=deriv.luu.dtype))
        deriv = deriv._replace(luu=luu)
    lam = jax.vmap(lambda d, p: jb.costate_scan(d, p, mode="seq"))(deriv, phi)
    second = deriv.cH_phi + jax.vmap(
        lambda a, b, l: jd.contract_dynamics_hessian(jp, None, a, b, l))(
            x, u, lam[:, 1:])
    dt = x.dtype
    mu, reg, dc = (jnp.asarray(v, dt) for v in (mu, reg, dc))
    opts = J.Options()
    if kernel:
        gains, dL, fail, sing = backward_sweep_pallas(
            deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
            deriv.luu, deriv.cx, deriv.cu, second, *nominal,
            deriv.lTx, deriv.lTxx, mu, reg, dc, nx=jp.nx, nu=jp.nu,
            nc=jp.nc, refine=1, rtol=opts.kkt_residual_rtol, interpret=True)
    else:
        gains, dL, fail, sing = jax.vmap(
            lambda d, n, s, m, r, c: jb._run_pass(jp, d, n, m, r, c, opts,
                                                  second=s))(
            deriv, nominal, second, mu, reg, dc)
    return deriv, second, lam, (tuple(gains), dL, fail, sing)


def _jax_side(jp, inp, mu, reg, dc, force_fail_lane=None, kernel=False):
    """JAX deriv/nominal/second for the tiny inputs, and one sweep at fixed
    (mu, reg, dc) by the scan (or the interpret-mode Pallas kernel),
    compiled as one function."""
    x, u, phi = (jnp.asarray(inp[k]) for k in ("x", "u", "phi"))
    nominal = tuple(jnp.asarray(inp[k])
                    for k in ("c", "il", "iu", "phi", "zl", "zu"))
    deriv, second, lam, out = _jax_sweep(
        jp, x, u, phi, nominal, np.asarray(mu), np.asarray(reg),
        np.asarray(dc), force_fail_lane=force_fail_lane, kernel=kernel)
    return deriv, nominal, second, lam, out


def _torch_side(pp, deriv, nominal, second, mu, reg, dc, dtype):
    d = convert.deriv_from_numpy(deriv, dtype)
    n = tuple(torch.as_tensor(np.asarray(a)).to(dtype) for a in nominal)
    s = torch.as_tensor(np.asarray(second)).to(dtype)
    t = lambda v: torch.as_tensor(np.asarray(v)).to(dtype)
    return d, n, s, pb._run_pass(pp, d, n, t(mu), t(reg), t(dc), P.Options(),
                                 second=s)


def _scalars(seed):
    rng = np.random.default_rng(seed)
    return (np.full(B, 0.1), rng.choice([0.0, 1e-3, 0.5], size=B),
            rng.choice([0.0, 1e-8], size=B))


def _compare(out, ref, rtol, atol):
    gains, dL, fail, sing = out
    rg, rdL, rfail, rsing = ref
    np.testing.assert_array_equal(tnp(fail), np.asarray(rfail))
    np.testing.assert_array_equal(tnp(sing), np.asarray(rsing))
    for a, b, name in zip(gains, rg, GAINS):
        np.testing.assert_allclose(tnp(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tnp(dL), np.asarray(rdL), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "pallas"])
@pytest.mark.parametrize("nc", [2, 0])
def test_run_pass_matches_jax(nc, kernel):
    jp, pp = _problems(nc)
    inp = tiny_inputs(0, B, nc)
    mu, reg, dc = _scalars(0)
    deriv, nominal, second, _, ref = _jax_side(jp, inp, mu, reg, dc,
                                               kernel=kernel)
    *_, out = _torch_side(pp, deriv, nominal, second, mu, reg, dc,
                          torch.float64)
    assert not np.asarray(ref[2]).all()
    _compare(out, ref, 1e-9, 1e-11)


@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "pallas"])
def test_forced_failure_lane_matches_jax(kernel):
    """Lane 2's control Hessian is made indefinite: wrong inertia there, and
    only there, on both sides; the other lanes' gains are untouched."""
    jp, pp = _problems(2)
    inp = tiny_inputs(1, B, 2)
    mu, reg, dc = np.full(B, 0.1), np.full(B, 0.5), np.zeros(B)
    deriv, nominal, second, _, ref = _jax_side(
        jp, inp, mu, reg, dc, force_fail_lane=2, kernel=kernel)
    *_, out = _torch_side(pp, deriv, nominal, second, mu, reg, dc,
                          torch.float64)
    assert tnp(out[2]).tolist() == [False, False, True, False]
    _compare(out, ref, 1e-9, 1e-11)


def test_run_pass_float32_matches_jax():
    jp, pp = _problems(2)
    inp = tiny_inputs(2, B, 2, np.float32)
    mu, reg, dc = np.full(B, 0.1), np.full(B, 0.5), np.zeros(B)
    deriv, nominal, second, _, ref = _jax_side(jp, inp, mu, reg, dc)
    assert ref[0][0].dtype == jnp.float32
    *_, out = _torch_side(pp, deriv, nominal, second, mu, reg, dc,
                          torch.float32)
    assert out[0].alpha.dtype == torch.float32
    _compare(out, ref, 2e-3, 2e-4)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """`backward_sweep_cuda` takes the plain version for CPU tensors (and
    only for those), checks its arguments, and counts no launch."""
    from ipddp2tpu_torch.ops import backward_cuda
    jp, pp = _problems(2)
    inp = tiny_inputs(3, B, 2)
    mu, reg, dc = _scalars(3)
    deriv, nominal, second, _, _ = _jax_side(jp, inp, mu, reg, dc)
    d, n, s, ref = _torch_side(pp, deriv, nominal, second, mu, reg, dc,
                               torch.float64)
    t = lambda v: torch.as_tensor(v)
    args = [d.fx, d.fu, d.lx, d.lu, d.lxx, d.lux, d.luu, d.cx, d.cu, s, *n,
            d.lTx, d.lTxx, t(mu), t(reg), t(dc)]
    kw = dict(nx=2, nu=3, nc=2, refine=1, rtol=1e-6)
    backward_cuda.reset_launch_counts()
    gains, dL, fail, sing = backward_sweep_cuda(*args, **kw)
    assert sum(backward_cuda.launch_counts.values()) == 0
    for a, b in zip(gains, ref[0]):
        assert torch.equal(a, b)
    assert torch.equal(dL, ref[1]) and torch.equal(fail, ref[2])
    with pytest.raises(ValueError, match="shape"):
        backward_sweep_cuda(*args, **dict(kw, nu=4))
    bad = list(args)
    bad[18] = bad[18].to(torch.float32)
    with pytest.raises(ValueError, match="float32"):
        backward_sweep_cuda(*bad, **kw)


def test_cuda_kernel_option_raises_off_gpu():
    """backward_kernel="cuda" never gives way to the plain version."""
    jp, pp = _problems(2)
    inp = tiny_inputs(3, B, 2)
    mu, reg, dc = _scalars(3)
    deriv, nominal, second, _, _ = _jax_side(jp, inp, mu, reg, dc)
    d, n, s, _ = _torch_side(pp, deriv, nominal, second, mu, reg, dc,
                             torch.float64)
    with pytest.raises(RuntimeError, match="GPU"):
        pb.backward_pass(pp, d, n, torch.as_tensor(mu),
                         torch.zeros(B, dtype=torch.float64),
                         P.Options(backward_kernel="cuda"), second=s)


def test_costate_scan_matches_jax_seq():
    """Same recursion in the same order: rtol 1e-13."""
    jp, pp = _problems(2)
    inp = tiny_inputs(4, B, 2)
    deriv, _, _, lam, _ = _jax_side(jp, inp, *_scalars(4))
    out = pb.costate_scan(convert.deriv_from_numpy(deriv),
                          torch.as_tensor(inp["phi"]))
    np.testing.assert_allclose(tnp(out), np.asarray(lam), rtol=1e-13,
                               atol=1e-15)


@functools.cache
def _jax_ladder(jp):
    """The JAX ladder on the tiny inputs, compiled once for both reg_last
    values (a runtime argument)."""
    def one(x, u, phi, nom, reg_last):
        deriv = jd.evaluate_derivatives(jp, None, x, u, phi)
        lam = jb.costate_scan(deriv, phi, mode="seq")
        second = deriv.cH_phi + jd.contract_dynamics_hessian(
            jp, None, x, u, lam[1:])
        res = jb.backward_pass(jp, deriv, nom, jnp.asarray(0.1), reg_last,
                               J.Options(backward_kernel="xla"), lam=lam,
                               second=second)
        return deriv, second, res

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))


@pytest.mark.parametrize("reg_last", [0.0, 0.3])
def test_backward_pass_ladder_matches_jax(reg_last):
    """Indefinite stage cost: the ladder takes several bumps, and lanes need
    different numbers of them. Same final reg, delta_c and status per lane;
    gains at rtol 1e-8 (as the JAX ladder-parity test)."""
    jp, pp = _problems(2, bad_cost=True)
    inp = tiny_inputs(1, B, 2)
    # spread the lanes over the ladder: scale the duals lane by lane
    scale = np.array([1.0, 30.0, 1e3, 3e4])[:, None, None]
    inp["zl"] = inp["zl"] * scale
    inp["zu"] = inp["zu"] * scale
    x, u, phi = (jnp.asarray(inp[k]) for k in ("x", "u", "phi"))
    nominal = tuple(jnp.asarray(inp[k])
                    for k in ("c", "il", "iu", "phi", "zl", "zu"))

    deriv, second, ref = _jax_ladder(jp)(x, u, phi, nominal,
                                         jnp.asarray(reg_last))
    d = convert.deriv_from_numpy(deriv)
    n = tuple(torch.as_tensor(np.asarray(a)) for a in nominal)
    out = pb.backward_pass(
        pp, d, n, torch.full((B,), 0.1, dtype=torch.float64),
        torch.full((B,), reg_last, dtype=torch.float64), P.Options(),
        second=torch.as_tensor(np.asarray(second)))
    regs = np.asarray(ref.reg)
    assert (regs > 0).any() and len(np.unique(regs)) > 1, regs
    np.testing.assert_allclose(tnp(out.reg), regs, rtol=1e-14)
    np.testing.assert_allclose(tnp(out.delta_c), np.asarray(ref.delta_c),
                               rtol=1e-14)
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    np.testing.assert_allclose(tnp(out.lam), np.asarray(ref.lam), rtol=1e-12)
    for a, b, name in zip(out.gains, ref.gains, GAINS):
        np.testing.assert_allclose(tnp(a), np.asarray(b), rtol=1e-8,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_allclose(tnp(out.dL), np.asarray(ref.dL), rtol=1e-8,
                               atol=1e-10)


def test_ladder_gives_up_above_reg_max():
    """A lane whose ladder runs out (reg_max small) ends with status 1 and
    the last reg it tried; the lanes that pass are not disturbed."""
    jp, pp = _problems(2, bad_cost=True)
    inp = tiny_inputs(1, B, 2)
    opts_j = J.Options(backward_kernel="xla", reg_max=1e-3)
    x, u, phi = (jnp.asarray(inp[k]) for k in ("x", "u", "phi"))
    nominal = tuple(jnp.asarray(inp[k])
                    for k in ("c", "il", "iu", "phi", "zl", "zu"))

    def one(x, u, phi, nom):
        deriv = jd.evaluate_derivatives(jp, None, x, u, phi,
                                        with_dynamics_hessian=True)
        return deriv, jb.backward_pass(jp, deriv, nom, jnp.asarray(0.1),
                                       jnp.asarray(0.0), opts_j)

    deriv, ref = jax.jit(jax.vmap(one))(x, u, phi, nominal)
    out = pb.backward_pass(
        pp, convert.deriv_from_numpy(deriv),
        tuple(torch.as_tensor(np.asarray(a)) for a in nominal),
        torch.full((B,), 0.1, dtype=torch.float64),
        torch.zeros(B, dtype=torch.float64), P.Options(reg_max=1e-3))
    assert (np.asarray(ref.status) == 1).any()
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    np.testing.assert_allclose(tnp(out.reg), np.asarray(ref.reg), rtol=1e-14)


def _ladder_case(reg_last, force_fail_lane=None):
    """The indefinite-cost tiny problem with the lanes spread over the
    ladder, in the port's types: (problem, deriv, nominal, second, mu,
    reg_last)."""
    jp, pp = _problems(2, bad_cost=True)
    inp = tiny_inputs(1, B, 2)
    scale = np.array([1.0, 30.0, 1e3, 3e4])[:, None, None]
    inp["zl"], inp["zu"] = inp["zl"] * scale, inp["zu"] * scale
    mu = np.full(B, 0.1)
    deriv, nominal, second, _, _ = _jax_side(jp, inp, mu, np.zeros(B),
                                             np.zeros(B))
    d = convert.deriv_from_numpy(deriv)
    if force_fail_lane is not None:
        # no reg below reg_max = 1e3 repairs this lane
        luu = d.luu.clone()
        luu[force_fail_lane] -= 1e6 * torch.eye(3, dtype=torch.float64)
        d = d._replace(luu=luu)
    n = tuple(torch.as_tensor(np.asarray(a)) for a in nominal)
    return (pp, d, n, torch.as_tensor(np.asarray(second)),
            torch.as_tensor(mu), torch.full((B,), reg_last,
                                            dtype=torch.float64))


@pytest.mark.parametrize("case", [(0.0, None), (0.3, None), (0.0, 2)],
                         ids=["fresh", "reg_last", "forced_failure"])
def test_prepare_once_equals_per_attempt(case, monkeypatch):
    """The ladder through the kernel's wrapper (inputs prepared once per
    backward pass, one `sweep_prepared` per attempt; on CPU tensors the
    wrapper takes the plain version) gives bit-identical results to the
    ladder over `_run_pass`."""
    from ipddp2tpu_torch.ops import backward_cuda
    reg_last, lane = case
    pp, d, n, s, mu, rl = _ladder_case(reg_last, lane)
    opts = P.Options(reg_max=1e3) if lane is not None else P.Options()
    ref = pb.backward_pass(pp, d, n, mu, rl, opts, second=s)

    calls = {"prepare": 0, "attempt": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pb, "_use_cuda_kernel", lambda options, t: True)
    monkeypatch.setattr(pb, "prepare_sweep",
                        counted("prepare", backward_cuda.prepare_sweep))
    monkeypatch.setattr(pb, "sweep_prepared",
                        counted("attempt", backward_cuda.sweep_prepared))
    backward_cuda.reset_launch_counts()
    out = pb.backward_pass(pp, d, n, mu, rl, opts, second=s)
    assert calls["prepare"] == 1 and calls["attempt"] > 1, calls
    assert sum(backward_cuda.launch_counts.values()) == 0
    assert float(out.reg.max()) > 0
    if lane is not None:
        assert int(out.status[lane]) == 1 and int(out.status.sum()) == 1
    for a, b in zip(out.gains, ref.gains):
        assert torch.equal(a, b)
    for name in ("dL", "status", "reg", "delta_c", "lam"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


def test_prepared_inputs_serve_every_attempt():
    """`backward_sweep_cuda` is `prepare_sweep` + `sweep_prepared`; one
    prepared set takes any (reg, delta_c), also from strided inputs."""
    from ipddp2tpu_torch.ops import backward_cuda
    pp, d, n, s, mu, _ = _ladder_case(0.0)
    wide = lambda t: torch.cat([t, t], dim=-1)[..., :t.shape[-1]]
    fixed = [d.fx, d.fu, d.lx, d.lu, d.lxx, d.lux, d.luu, d.cx, d.cu, s, *n,
             d.lTx, d.lTxx, mu]
    kw = dict(nx=2, nu=3, nc=2)
    prepared = backward_cuda.prepare_sweep(*[wide(t) for t in fixed[:-1]],
                                           mu, **kw)
    for reg, dc in ((0.0, 0.0), (0.5, 0.0), (10.0, 1e-8)):
        reg_t, dc_t = (torch.full((B,), v, dtype=torch.float64)
                       for v in (reg, dc))
        one = backward_cuda.sweep_prepared(prepared, reg_t, dc_t, refine=1,
                                           rtol=1e-6)
        ref = backward_sweep_cuda(*fixed, reg_t, dc_t, **kw, refine=1,
                                  rtol=1e-6)
        for a, b in zip(one[0] + one[1:], ref[0] + ref[1:]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="reg"):
        backward_cuda.sweep_prepared(prepared, torch.zeros(B + 1), dc_t,
                                     refine=1, rtol=1e-6)


@pytest.mark.parametrize("dims,lanes,per_block,f32,f64", [
    ((4, 10, 4), 16, 8, 54912, 108416),      # concar: two instances a warp
    ((2, 3, 1), 4, 32, None, None),          # double integrator
    ((2, 3, 0), 4, 32, 30208, 55296),        # the tiny problem, nc = 0
    ((2, 1, 0), 1, 128, None, None),         # one lane an instance
    ((6, 20, 12), 32, 4, None, None),        # a whole warp an instance
])
def test_launch_geometry(dims, lanes, per_block, f32, f64):
    """G is the smallest power of two >= nu + nc, a block is 4 warps, and
    the shared memory follows the source's layout (every run of the two
    stage buffers padded to 16 bytes)."""
    from ipddp2tpu_torch.ops.backward_cuda import launch_geometry
    from ipddp2tpu_torch.ops.build import SMEM_LIMIT
    geo = launch_geometry(*dims)
    assert geo.lanes == lanes and geo.lanes >= dims[1] + dims[2]
    assert geo.instances_per_block == per_block
    assert geo.threads == lanes * per_block == 128
    assert 2 * geo.smem_bytes[torch.float32] >= geo.smem_bytes[torch.float64]
    assert geo.smem_bytes[torch.float64] <= SMEM_LIMIT
    if f32 is not None:
        assert geo.smem_bytes == {torch.float32: f32, torch.float64: f64}
    if dims == (4, 10, 4):
        # 2 x 526 stage values + K 14x15 + L 14x17 + rhs, X 2x70 + C, Vxx
        # 2x16 + Vx 2x4 + pivot order 14 = 1694 doubles an instance
        assert f64 == 8 * 1694 * 8


def test_launch_geometry_refuses_what_does_not_fit():
    from ipddp2tpu_torch.ops.backward_cuda import launch_geometry
    with pytest.raises(ValueError, match="nu \\+ nc = 65 > 64"):
        launch_geometry(4, 21, 44)
    with pytest.raises(ValueError, match="227 KB"):
        launch_geometry(60, 20, 12)
    # fewer warps a block before giving up
    assert launch_geometry(20, 20, 12).threads < 128
    with pytest.raises(ValueError, match="bad dimensions"):
        launch_geometry(2, 0, 0)


def test_crafted_lanes_through_the_plain_sweep():
    """The lanes on which a pivot search can go wrong, as the GPU run hands
    them to the kernel: a tie passes like an untouched lane, a NaN diagonal
    fails without `singular`, an exact zero pivot fails as `singular` with
    and without delta_c, and passes once reg fills the zero row."""
    from ipddp2tpu_torch.ops.ldlt import ldlt_factor_pivoted
    from ipddp2tpu_torch.ops.profile_sweep import (CRAFTED_LANES,
                                                   crafted_inputs)
    lane = {n: i for i, n in enumerate(CRAFTED_LANES)}
    for dims in ((4, 10, 4), (2, 3, 1), (2, 3, 0)):
        for dtype in (torch.float64, torch.float32):
            args = crafted_inputs(*dims, dtype, "cpu")
            gains, dL, fail, sing = pb.sweep_plain(
                *args, nx=dims[0], nu=dims[1], nc=dims[2], refine=1,
                rtol=1e-6)
            assert fail.tolist() == [False, False, True, True, True, False]
            assert sing.tolist() == [False, False, False, True, True, False]
            ok = ~fail
            assert all(bool(torch.isfinite(g[ok]).all()) for g in gains)
    # the tie lane's first KKT matrix: entries 1 and 2 tie, 1 is taken
    args = crafted_inputs(4, 10, 4, torch.float64, "cpu")
    i = lane["tie"]
    K = torch.zeros(14, 14, dtype=torch.float64)
    K[:10, :10] = args[6][i, -1]
    K[10:, :10], K[:10, 10:] = args[8][i, -1], args[8][i, -1].T
    assert K[1, 1] == K[2, 2] == K.diagonal().abs().max()
    assert int(ldlt_factor_pivoted(K).perm[0]) == 1
    # NaN wins the pivot search like in an argmax and fails the lane
    K[5, 5] = float("nan")
    f = ldlt_factor_pivoted(K)
    assert int(f.perm[0]) == 5 and not bool(f.ok)
