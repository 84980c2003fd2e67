"""The port as a whole against the JAX package: `initialize` field by field,
iterate parity after a few iterations, the golden anchors, frozen lanes.

Tolerances: `initialize` is the same arithmetic (rtol 1e-12). Iterates after
5 iterations agree to 1e-8 (both packages take the associative costate
order on the CPU; tests/test_torch_costate.py holds the same comparison to
1e-12). Whole solves are held to the
golden rule of tests/test_benchmarks.py (`_check`), never to equal iteration
counts against JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
from ipddp2tpu.batch import solve_batch as j_solve_batch
from ipddp2tpu.solve import initialize as j_initialize

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.batch import batch_stats, solve_batch
from ipddp2tpu_torch.solve import (SolverState, _augment_filter, cs_error,
                                   initialize, iteration, run)

from torch_port_helpers import (concar_instances, jax_concar_args, jconcar,
                                pconcar, pdi, short_concar, tnp,
                                torch_concar_args)

B = 3
OPTS = dict(optimality_tolerance=1e-7)


@functools.cache
def _j_init():
    """The JAX package's `initialize` on short concar, compiled once for the
    module (every caller has B lanes)."""
    jp = short_concar()[0]
    return jax.jit(jax.vmap(lambda b, x, u, th: j_initialize(
        jp, th, b, x, u, J.Options(**OPTS))))


@pytest.fixture(scope="module")
def init_pair():
    jp, pp = short_concar()
    inst = concar_instances(11, B)
    bounds, x1, u0, theta = jax_concar_args(inst)
    ref = _j_init()(bounds, x1, u0, theta)
    pb, px1, pu0, pth = torch_concar_args(inst)
    out = initialize(pp, pth, pb, px1, pu0, P.Options(**OPTS), device="cpu")
    return ref, out


@pytest.mark.parametrize("field", SolverState._fields)
def test_initialize_field_matches_jax(init_pair, field):
    ref, out = init_pair
    a, b = tnp(getattr(out, field)), np.asarray(getattr(ref, field))
    assert a.shape == b.shape
    if b.dtype.kind in "ib":
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_array_equal(a[~np.isfinite(b)], b[~np.isfinite(b)])
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=1e-14)


def test_state_round_trips_through_numpy(init_pair):
    _, out = init_pair
    back = convert.state_from_numpy(
        SolverState(**convert.state_to_numpy(out)))
    for a, b in zip(back, out):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_upper_only_bound_is_projected_like_jax():
    """The mirrored upper-only projection (a bound with no lower side)."""
    jp, pp = short_concar()
    inst = concar_instances(12, B)
    inst["lower"][:, :, 1] = -np.inf            # steer: upper bound only
    inst["u0"][:, :, 1] = 10.0                  # guess above the bound
    bounds, x1, u0, theta = jax_concar_args(inst)
    ref = _j_init()(bounds, x1, u0, theta)
    pb, px1, pu0, pth = torch_concar_args(inst)
    out = initialize(pp, pth, pb, px1, pu0, P.Options(**OPTS), device="cpu")
    np.testing.assert_allclose(tnp(out.u), np.asarray(ref.u), rtol=1e-13)
    assert (tnp(out.u)[:, :, 1] < inst["upper"][:, :, 1]).all()
    np.testing.assert_array_equal(tnp(out.zl), np.asarray(ref.zl))


@pytest.mark.parametrize("field", ["x", "u", "phi", "zl", "zu"])
def test_iterates_match_jax_after_5_iterations(field, iterate_pair):
    ref, out = iterate_pair
    np.testing.assert_allclose(tnp(getattr(out, field)),
                               np.asarray(getattr(ref, field)),
                               rtol=1e-8, atol=1e-8)


def test_counters_after_5_iterations(iterate_pair):
    ref, out = iterate_pair
    np.testing.assert_array_equal(tnp(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    assert tnp(out.status).tolist() == [8] * B      # the k_limit status
    np.testing.assert_allclose(tnp(out.mu), np.asarray(ref.mu), rtol=1e-12)


@pytest.fixture(scope="module")
def iterate_pair():
    jp, pp = short_concar()
    inst = concar_instances(11, B)
    bounds, x1, u0, theta = jax_concar_args(inst)
    ref = j_solve_batch(jp, bounds, x1, u0, theta=theta, options=J.Options(
        max_iterations=5, backward_kernel="xla", forward_kernel="xla",
        **OPTS))
    pb, px1, pu0, pth = torch_concar_args(inst)
    out = solve_batch(pp, pb, px1, pu0, theta=pth,
                      options=P.Options(max_iterations=5, **OPTS),
                      device="cpu")
    return ref, out


HYBRID = dict(ls_speculative=4, ls_spec_continue=True)


@pytest.fixture(scope="module")
def hybrid_iterate_pair():
    """Five iterations with the hybrid line search in both packages (the
    plain rollout route there and here)."""
    jp, pp = short_concar()
    inst = concar_instances(11, B)
    bounds, x1, u0, theta = jax_concar_args(inst)
    ref = j_solve_batch(jp, bounds, x1, u0, theta=theta, options=J.Options(
        max_iterations=5, backward_kernel="xla", forward_kernel="xla",
        **HYBRID, **OPTS))
    pb, px1, pu0, pth = torch_concar_args(inst)
    out = solve_batch(pp, pb, px1, pu0, theta=pth,
                      options=P.Options(max_iterations=5, **HYBRID, **OPTS),
                      device="cpu")
    return ref, out


@pytest.mark.parametrize("field", ["x", "u", "phi", "zl", "zu"])
def test_hybrid_iterates_match_jax_after_5_iterations(field,
                                                      hybrid_iterate_pair):
    ref, out = hybrid_iterate_pair
    np.testing.assert_allclose(tnp(getattr(out, field)),
                               np.asarray(getattr(ref, field)),
                               rtol=1e-8, atol=1e-8)


def test_hybrid_counters_after_5_iterations(hybrid_iterate_pair,
                                            iterate_pair):
    ref, out = hybrid_iterate_pair
    np.testing.assert_array_equal(tnp(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    np.testing.assert_allclose(tnp(out.mu), np.asarray(ref.mu), rtol=1e-12)
    # and the hybrid search walks where the port's backtracking walks
    np.testing.assert_allclose(tnp(out.x), tnp(iterate_pair[1].x),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("options", [
    dict(ls_speculative=4, ls_spec_continue=True),
    dict(ls_speculative=8),
], ids=["hybrid", "speculative"])
def test_short_double_integrator_converges_like_backtracking(options):
    """T=16 double integrator: the hybrid and the speculative search land
    on the objective of the port's backtracking solve."""
    import dataclasses
    prob = dataclasses.replace(pdi.problem(), T=16)
    bounds = P.Bounds(*(b[:16] for b in pdi.bounds()))
    x1 = pdi.initial_state()[None]
    u0 = pdi.initial_controls()[None, :16]
    solve_ = lambda **kw: P.solve(prob, bounds, x1, u0,
                                  options=P.Options(**OPTS, **kw),
                                  device="cpu")
    base, other = solve_(), solve_(**options)
    assert bool(base.converged.all()) and bool(other.converged.all())
    np.testing.assert_allclose(tnp(other.objective), tnp(base.objective),
                               rtol=1e-6)


def _check(sol, lane, golden_obj, golden_iters, *, obj_rtol=1e-6,
           iter_tol=0.1):
    """The golden rule of tests/test_benchmarks.py."""
    assert bool(sol.converged[lane]), f"status={int(sol.status[lane])}"
    np.testing.assert_allclose(float(sol.objective[lane]), golden_obj,
                               rtol=obj_rtol)
    iters = int(sol.iterations[lane])
    assert abs(iters - golden_iters) <= max(3, int(iter_tol * golden_iters) + 1), \
        f"iterations {iters} vs golden {golden_iters}"


@pytest.fixture(scope="module")
def di_solution():
    """Two lanes: the reference double integrator, and a twin that starts
    elsewhere and so converges at another iteration; the earlier of the two
    must then stay frozen."""
    prob = pdi.problem()
    x1 = torch.stack([pdi.initial_state(),
                      torch.tensor([0.9, 0.0], dtype=torch.float64)])
    u0 = pdi.initial_controls().expand(2, pdi.T, pdi.NU)
    opts = P.Options(**OPTS)
    sol, state = P.solve(prob, pdi.bounds(), x1, u0, options=opts,
                         return_state=True, device="cpu")
    return prob, x1, u0, opts, sol, state


def test_double_integrator_golden(di_solution):
    *_, sol, _ = di_solution
    _check(sol, 0, pdi.GOLDEN_OBJECTIVE, pdi.GOLDEN_ITERATIONS)
    assert int(sol.iterations[0]) == pdi.GOLDEN_ITERATIONS


def test_converged_lane_stays_frozen(di_solution):
    """One lane converges earlier than the other; solving it alone gives,
    bit for bit, the state it holds in the batch after the other lane's
    extra iterations."""
    prob, x1, u0, opts, sol, state = di_solution
    k = tnp(sol.iterations)
    assert bool(sol.converged.all()) and k[0] != k[1], k
    e = int(np.argmin(k))
    _, alone = P.solve(prob, pdi.bounds(), x1[e:e + 1], u0[e:e + 1],
                       options=opts, return_state=True, device="cpu")
    for name, a, b in zip(SolverState._fields, alone, state):
        assert torch.equal(a[0], b[e]), name
    # resuming `run` on a finished batch changes nothing
    again = run(prob, pdi.bounds(), state, None, opts, device="cpu")
    for a, b in zip(again, state):
        assert torch.equal(a, b)


def test_batch_stats(di_solution):
    *_, sol, _ = di_solution
    st = batch_stats(sol)
    assert st.num_instances == 2 and int(st.num_converged) == 2
    assert int(st.num_failed) == 0
    assert int(st.max_iterations) == int(sol.iterations.max())
    assert float(st.median_iterations) == float(np.median(tnp(sol.iterations)))


def test_k_limit_resume_continues_the_same_trajectory():
    jp, pp = short_concar()
    pb, px1, pu0, pth = torch_concar_args(concar_instances(11, B))
    opts = P.Options(**OPTS)
    s0 = initialize(pp, pth, pb, px1, pu0, opts, device="cpu")
    a = run(pp, pb, s0, pth, opts, k_limit=4, device="cpu")
    assert tnp(a.status).tolist() == [8] * B and tnp(a.k).tolist() == [4] * B
    a = run(pp, pb, a._replace(status=torch.zeros_like(a.status)), pth, opts,
            k_limit=7, device="cpu")
    b = run(pp, pb, s0, pth, opts, k_limit=7, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    one = iteration(pp, pb, s0, pth, opts, device="cpu")
    assert tnp(one.k).max() <= 1


def test_filter_ring_min_merge_matches_jax():
    """Ring index 1 + (n-1) mod (cap-1) per lane, merged by min."""
    from ipddp2tpu.solve import _augment_filter as j_augment
    cap = 4
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((B, cap, 2))
    pts[0, 2] = np.inf
    n = np.array([2, 4, 9], dtype=np.int32)          # slots 2, 1, 3
    th, L = rng.uniform(size=B), rng.standard_normal(B)
    ref_p, ref_n = jax.vmap(lambda p, k, a, b: j_augment(
        p, k, a, b, J.Options()))(jnp.asarray(pts), jnp.asarray(n),
                                  jnp.asarray(th), jnp.asarray(L))
    out_p, out_n = _augment_filter(torch.as_tensor(pts), torch.as_tensor(n),
                                   torch.as_tensor(th), torch.as_tensor(L),
                                   P.Options())
    np.testing.assert_allclose(tnp(out_p), np.asarray(ref_p), rtol=1e-15)
    assert out_n.dtype == torch.int32
    np.testing.assert_array_equal(tnp(out_n), np.asarray(ref_n))


def test_cs_error_with_zero_mu_has_no_nan():
    """Unbounded sides hold inf slacks and zero duals: inf * 0 stays masked."""
    from ipddp2tpu.solve import cs_error as j_cs
    inst = concar_instances(13, B)
    jb_, _, ju0, _ = jax_concar_args(inst)
    pb, _, pu0, _ = torch_concar_args(inst)
    il, iu = pu0 - pb.lower, pb.upper - pu0
    zl, zu = pb.mask_lower.to(il.dtype), pb.mask_upper.to(il.dtype)
    for mu in (0.0, 0.3):
        out = cs_error(pb, il, iu, zl, zu,
                       mu if mu == 0.0 else torch.full((B,), mu, dtype=il.dtype),
                       P.Options())
        ref = jax.vmap(lambda b, u: j_cs(
            b, u - b.lower, b.upper - u, jnp.isfinite(b.lower) * 1.0,
            jnp.isfinite(b.upper) * 1.0, mu, J.Options()))(jb_, ju0)
        assert bool(torch.isfinite(out).all())
        np.testing.assert_allclose(tnp(out), np.asarray(ref), rtol=1e-13)


@pytest.mark.parametrize("kwargs,err", [
    (dict(ls_speculative=-1), ValueError),
    (dict(backward_mode="timeshard"), RuntimeError),  # no time mesh
    (dict(inertia_method="bk", backward_kernel="cuda"), RuntimeError),
    (dict(inertia_method="eigh", backward_kernel="cuda"), ValueError),
    (dict(forward_kernel="pallas"), ValueError),
    (dict(backward_kernel="pallas"), ValueError),
    (dict(forward_kernel="cuda"), RuntimeError),      # no GPU asked for
    (dict(forward_kernel="cuda", ls_speculative=4), RuntimeError),
])
def test_unported_options_are_refused_not_downgraded(kwargs, err):
    prob = pdi.problem()
    with pytest.raises(err):
        P.solve(prob, pdi.bounds(), pdi.initial_state()[None],
                pdi.initial_controls()[None], options=P.Options(**kwargs),
                device="cpu")


def test_options_match_jax_defaults():
    import dataclasses
    a = {f.name: f.default for f in dataclasses.fields(J.Options)}
    b = {f.name: f.default for f in dataclasses.fields(P.Options)}
    assert a == b


@pytest.mark.slow
def test_concar_seed1_golden():
    """Full-horizon concar seed 1 (T=100) in eager CPU torch: minutes, hence
    slow. 99 iterations / 4.46466505 under the golden rule."""
    prob = pconcar.problem()
    theta, f_lim, tau_lim, x1 = pconcar.seed1_instance()
    sol = P.solve(prob, pconcar.bounds(f_lim, tau_lim), x1[None],
                  pconcar.initial_controls()[None],
                  theta=pconcar.Theta(theta.obstacles[None]),
                  options=P.Options(**OPTS), device="cpu")
    _check(sol, 0, pconcar.SEED1_GOLDEN_OBJECTIVE,
           pconcar.SEED1_GOLDEN_ITERATIONS)
