"""The module that holds the backward-sweep kernel, against the JAX package.

On the CPU the port's sweep is its plain version (`backward._run_pass` /
`sweep_plain`); the CUDA kernel itself is held against that plain version on
the GPU by a phase of `chip_smoke.py`. Here the plain version is compared
with the JAX scan sweep AND with the JAX Pallas kernel in interpret mode, on
randomized trajectories and duals.

Tolerance: rtol 1e-9 / atol 1e-11 in float64, as tests/test_backward_pallas.py
holds the Pallas kernel to its scan (same arithmetic, other summation order,
amplified by the KKT conditioning); float32 at rtol 2e-3 / atol 2e-4."""

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


def _jax_side(jp, inp, mu, reg, dc, force_fail_lane=None, kernel=False):
    """JAX deriv/nominal/second for the tiny inputs, and one sweep at fixed
    (mu, reg, dc) by the scan (or the interpret-mode Pallas kernel)."""
    x, u, phi = (jnp.asarray(inp[k]) for k in ("x", "u", "phi"))
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
    nominal = tuple(jnp.asarray(inp[k])
                    for k in ("c", "il", "iu", "phi", "zl", "zu"))
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
    return deriv, nominal, second, lam, (tuple(gains), dL, fail, sing)


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
    jp, pp = tiny_problems(nc)()
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
    jp, pp = tiny_problems(2)()
    inp = tiny_inputs(1, B, 2)
    mu, reg, dc = np.full(B, 0.1), np.full(B, 0.5), np.zeros(B)
    deriv, nominal, second, _, ref = _jax_side(
        jp, inp, mu, reg, dc, force_fail_lane=2, kernel=kernel)
    *_, out = _torch_side(pp, deriv, nominal, second, mu, reg, dc,
                          torch.float64)
    assert tnp(out[2]).tolist() == [False, False, True, False]
    _compare(out, ref, 1e-9, 1e-11)


def test_run_pass_float32_matches_jax():
    jp, pp = tiny_problems(2)()
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
    jp, pp = tiny_problems(2)()
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
    jp, pp = tiny_problems(2)()
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
    jp, pp = tiny_problems(2)()
    inp = tiny_inputs(4, B, 2)
    deriv, _, _, lam, _ = _jax_side(jp, inp, *_scalars(4))
    out = pb.costate_scan(convert.deriv_from_numpy(deriv),
                          torch.as_tensor(inp["phi"]))
    np.testing.assert_allclose(tnp(out), np.asarray(lam), rtol=1e-13,
                               atol=1e-15)


@pytest.mark.parametrize("reg_last", [0.0, 0.3])
def test_backward_pass_ladder_matches_jax(reg_last):
    """Indefinite stage cost: the ladder takes several bumps, and lanes need
    different numbers of them. Same final reg, delta_c and status per lane;
    gains at rtol 1e-8 (as the JAX ladder-parity test)."""
    jp, pp = tiny_problems(2)(bad_cost=True)
    inp = tiny_inputs(1, B, 2)
    # spread the lanes over the ladder: scale the duals lane by lane
    scale = np.array([1.0, 30.0, 1e3, 3e4])[:, None, None]
    inp["zl"] = inp["zl"] * scale
    inp["zu"] = inp["zu"] * scale
    x, u, phi = (jnp.asarray(inp[k]) for k in ("x", "u", "phi"))
    nominal = tuple(jnp.asarray(inp[k])
                    for k in ("c", "il", "iu", "phi", "zl", "zu"))

    def one(x, u, phi, nom):
        deriv = jd.evaluate_derivatives(jp, None, x, u, phi)
        lam = jb.costate_scan(deriv, phi, mode="seq")
        second = deriv.cH_phi + jd.contract_dynamics_hessian(
            jp, None, x, u, lam[1:])
        res = jb.backward_pass(jp, deriv, nom, jnp.asarray(0.1),
                               jnp.asarray(reg_last),
                               J.Options(backward_kernel="xla"), lam=lam,
                               second=second)
        return deriv, second, res

    deriv, second, ref = jax.vmap(one)(x, u, phi, nominal)
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
    jp, pp = tiny_problems(2)(bad_cost=True)
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

    deriv, ref = jax.vmap(one)(x, u, phi, nominal)
    out = pb.backward_pass(
        pp, convert.deriv_from_numpy(deriv),
        tuple(torch.as_tensor(np.asarray(a)) for a in nominal),
        torch.full((B,), 0.1, dtype=torch.float64),
        torch.zeros(B, dtype=torch.float64), P.Options(reg_max=1e-3))
    assert (np.asarray(ref.status) == 1).any()
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    np.testing.assert_allclose(tnp(out.reg), np.asarray(ref.reg), rtol=1e-14)
