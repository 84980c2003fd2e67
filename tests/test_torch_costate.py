"""The costate scan's two orders against the JAX package's `costate_scan`.

The JAX package resolves `mode="auto"` to the associative affine scan on
the CPU (the sequential one on its accelerator), and so does the port (the
sequential one on a GPU); its associative scan pairs the stages as
`jax.lax.associative_scan` does. Tolerance: 1e-13 relative in float64 for
the scan itself (the same products in the same association; only the
summation inside a 4x4 product may differ); a short default solve follows
the JAX package's default solve to 1e-12 (reached on the CPU: 8.5e-14
absolute on costates of size 330, 1.1e-16 on states), where the sequential
order left 1e-8."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
import ipddp2tpu.backward as jb
import ipddp2tpu.derivatives as jd
from ipddp2tpu.batch import solve_batch as j_solve_batch

import ipddp2tpu_torch as P
from ipddp2tpu_torch import backward as pb
from ipddp2tpu_torch.batch import solve_batch

from torch_port_helpers import (concar_instances, jax_concar_args,
                                short_concar, tnp, torch_concar_args)

B, NX, NC = 4, 4, 3
HORIZONS = (1, 2, 13, 16)


def _bundles(seed, T):
    """Random costate inputs: fx near the identity, so that products over T
    stages stay of order one."""
    rng = np.random.default_rng(seed)
    return dict(
        fx=np.eye(NX) + 0.3 * rng.standard_normal((B, T, NX, NX)),
        lx=rng.standard_normal((B, T, NX)),
        cx=rng.standard_normal((B, T, NC, NX)),
        phi=rng.standard_normal((B, T, NC)),
        lTx=rng.standard_normal((B, NX)))


def _jax_bundle(d):
    return jd.DerivativeBundle(
        fx=d["fx"], fu=None, fH=None, lx=d["lx"], lu=None, lxx=None,
        lux=None, luu=None, cx=d["cx"], cu=None, cH_phi=None, lTx=d["lTx"],
        lTxx=None)


def _torch_bundle(d):
    t = lambda k: torch.as_tensor(d[k])
    return pb.DerivativeBundle(
        fx=t("fx"), fu=None, fH=None, lx=t("lx"), lu=None, lxx=None,
        lux=None, luu=None, cx=t("cx"), cu=None, cH_phi=None, lTx=t("lTx"),
        lTxx=None)


@functools.partial(jax.jit, static_argnames="mode")
def _jax_costate(fx, lx, cx, phi, lTx, mode):
    d = dict(fx=fx, lx=lx, cx=cx, lTx=lTx)
    return jax.vmap(lambda b, p: jb.costate_scan(b, p, mode=mode))(
        _jax_bundle(d), phi)


@pytest.mark.parametrize("mode", ["assoc", "seq"])
def test_costate_orders_match_jax(mode):
    """Both orders on random vmapped bundles, even and odd horizons (the
    scan's recursion takes another branch on each), T = 1 included."""
    for T in HORIZONS:
        d = _bundles(T, T)
        ref = np.asarray(_jax_costate(*(jnp.asarray(d[k]) for k in
                                        ("fx", "lx", "cx", "phi", "lTx")),
                                      mode=mode))
        out = pb.costate_scan(_torch_bundle(d), torch.as_tensor(d["phi"]),
                              mode=mode)
        assert out.shape == (B, T + 1, NX)
        np.testing.assert_allclose(tnp(out), ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max())


def test_auto_resolves_to_assoc():
    """"auto" is the associative order bit for bit on the CPU (the JAX
    package's rule there) and the sequential one on a GPU (as the JAX
    package's on its accelerator); the two orders differ by reassociation
    only; an unknown order is refused."""
    assert pb.costate_mode("auto") == "assoc"
    assert pb.costate_mode("auto", torch.device("cpu")) == "assoc"
    assert pb.costate_mode("auto", torch.device("cuda")) == "seq"
    assert pb.costate_mode("assoc", "cuda") == "assoc"
    d = _bundles(5, 16)
    bundle, phi = _torch_bundle(d), torch.as_tensor(d["phi"])
    auto = pb.costate_scan(bundle, phi)
    assert torch.equal(auto, pb.costate_scan(bundle, phi, mode="assoc"))
    seq = pb.costate_scan(bundle, phi, mode="seq")
    assert not torch.equal(auto, seq)
    torch.testing.assert_close(auto, seq, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="mode"):
        pb.costate_scan(bundle, phi, mode="parallel")


@pytest.fixture(scope="module")
def default_pair():
    """Five iterations of concar at T = 16 with default options in both
    packages: the JAX package on the CPU takes its associative order, the
    port its "auto" = "assoc"."""
    jp, pp = short_concar()
    inst = concar_instances(11, 3)
    bounds, x1, u0, theta = jax_concar_args(inst)
    ref = j_solve_batch(jp, bounds, x1, u0, theta=theta, options=J.Options(
        max_iterations=5, optimality_tolerance=1e-7, backward_kernel="xla",
        forward_kernel="xla"))
    pbnd, px1, pu0, pth = torch_concar_args(inst)
    out = solve_batch(pp, pbnd, px1, pu0, theta=pth,
                      options=P.Options(max_iterations=5,
                                        optimality_tolerance=1e-7),
                      device="cpu")
    return ref, out


def test_default_solve_follows_jax_default(default_pair):
    """Iterates after 5 iterations within 1e-12 (the sequential order's
    comparisons need 1e-8), counters equal."""
    ref, out = default_pair
    for field in ("x", "u", "phi", "zl", "zu", "lam"):
        np.testing.assert_allclose(tnp(getattr(out, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-12, atol=1e-12, err_msg=field)
    np.testing.assert_array_equal(tnp(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))


def test_lane_independent_of_its_batch():
    """A lane solved alone equals the same lane inside a batch of 8, bit for
    bit in every field of the solver's state: acrobot at T = 16 (the bk
    path), its first 8 campaign instances, 5 iterations in float64, lanes 0
    and 5 alone. The batched solve keeps
    its lanes independent on the CPU; on a GPU, library products and
    reductions pick their algorithm by the batch's shape and round
    differently (`chip_smoke.py --lane-independence`)."""
    import dataclasses

    from ipddp2tpu_torch import convert
    from ipddp2tpu_torch.models import acrobot
    from ipddp2tpu_torch.problem import Bounds

    T = 16
    prob = dataclasses.replace(acrobot.problem(), T=T)
    th, b, x, u = acrobot.from_params(
        convert.params_rows(acrobot.PARAMS)[:8])
    b, u = Bounds(b.lower[:, :T], b.upper[:, :T]), u[:, :T]
    opts = P.Options(optimality_tolerance=1e-7, max_iterations=5)
    _, batch = P.solve(prob, b, x, u, theta=th, options=opts,
                       return_state=True, device="cpu")
    assert batch.k.tolist() == [5] * 8
    for i in (0, 5):
        lane = lambda t: t[i:i + 1]
        _, alone = P.solve(prob, Bounds(lane(b.lower), lane(b.upper)),
                           lane(x), lane(u),
                           theta=type(th)(*(lane(t) for t in th)),
                           options=opts, return_state=True, device="cpu")
        for name, a, c in zip(alone._fields, alone, batch):
            assert torch.equal(a[0], c[i]), (i, name)
