"""Port speculative and hybrid line search, and the plain versions of the
forward kernels, against the JAX package from the same mid-solve state.

One case per module: short-horizon concar (T=16), six lanes, two taken right
after initialization (they backtrack below 2^-K: none of the K candidates is
accepted) and four from eight iterations in (full steps, 2^-1, 2^-2, one
counted rejection), with gains from the JAX backward pass. The JAX reference
for the kernels' measures is `rollout` + `barrier_lagrangian` +
`fraction_to_boundary_ok` under `vmap` over (lane, gamma), the inner
`try_step` of `_forward_pass_speculative_xla`.

Tolerances: decisions (status, step size, counters, flags) are discrete and
must be equal. Measures agree to rtol 1e-10 in float64 (the plain versions sum
theta, L and J stage by stage, JAX over whole arrays) and 1e-4 in float32;
trial arrays to rtol 1e-11 against the JAX rollout at the same step sizes,
and 1e-9 where a whole line search stands in between. The Pallas kernels run
in interpret mode in float32 on a smaller case and agree to 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
import ipddp2tpu.backward as jb
import ipddp2tpu.derivatives as jd
import ipddp2tpu.forward as jf
from ipddp2tpu.ops.forward_pallas import (forward_metrics_pallas,
                                          forward_trial_pallas)
from ipddp2tpu.solve import _nominal_trial as j_nominal_trial
from ipddp2tpu.solve import initialize as j_initialize
from ipddp2tpu.solve import run as j_run

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch import forward as pf
from ipddp2tpu_torch.ops import forward_cuda as fc
from ipddp2tpu_torch.solve import _nominal_trial

from torch_port_helpers import (concar_instances, jax_concar_args,
                                short_concar, tiny_inputs, tiny_problems,
                                tnp, torch_concar_args)

B, K = 6, 4
OPTS = dict(optimality_tolerance=1e-7)
DECISIONS = ("status", "step_size", "num_ls", "armijo_passed", "switching")
MEASURES = ("theta_next", "L_next", "objective")
TRIAL_ORDER = ("x", "u", "phi", "zl", "zu", "il", "iu", "c_raw")


def _jax_mid_state(jp, inst, jo, ks, split):
    """Lanes [:split] after ks[0] iterations, the rest after ks[1]. One
    compiled solve serves both iteration limits (a runtime argument)."""
    bounds, x1, u0, theta = jax_concar_args(inst)

    def one(b, x, u, th, k):
        s = j_initialize(jp, th, b, x, u, jo)
        return j_run(jp, b, s, th, jo, k_limit=k)

    mid = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    s0, s1 = (mid(bounds, x1, u0, theta, k) for k in ks)
    state = jax.tree.map(
        lambda a, b: jnp.concatenate([a[:split], b[split:]], axis=0), s0, s1)
    return bounds, theta, state


def _jax_gains(jp, jo, th, s):
    deriv = jd.evaluate_derivatives(jp, th, s.x, s.u, s.phi)
    c_rel = jd.relax_constraints(jp, s.c_raw, s.mu)
    return jb.backward_pass(jp, deriv,
                            (c_rel, s.il, s.iu, s.phi, s.zl, s.zu),
                            s.mu, s.reg_last, jo)


@pytest.fixture(scope="module")
def case():
    jp, pp = short_concar()
    inst = concar_instances(7, B)
    jo = J.Options(backward_kernel="xla", forward_kernel="xla", **OPTS)
    bounds, theta, state = _jax_mid_state(jp, inst, jo, (0, 8), 2)
    gammas = 0.5 ** jnp.arange(K, dtype=jnp.float64)
    spec_o = dataclasses.replace(jo, ls_speculative=K)
    hyb_o = dataclasses.replace(jo, ls_speculative=K, ls_spec_continue=True)
    hyb2_o = dataclasses.replace(hyb_o, ls_speculative=2)

    def per_lane(b, th, s):
        bw = _jax_gains(jp, jo, th, s)
        nominal = j_nominal_trial(s)
        tau = jnp.maximum(jo.tau_min, 1.0 - s.mu)

        def try_step(gamma):
            trial = jf.rollout(jp, th, b, bw.gains, s.x, s.u, s.phi, s.zl,
                               s.zu, gamma)
            finite = jnp.all(jnp.array([jnp.all(jnp.isfinite(a)) for a in (
                trial.x, trial.u, trial.phi, trial.zl, trial.zu,
                trial.c_raw)]))
            ftb = jf.fraction_to_boundary_ok(trial, s.il, s.iu, s.zl, s.zu,
                                             tau)
            c_rel = jd.relax_constraints(jp, trial.c_raw, s.mu)
            L, Jv = jf.barrier_lagrangian(jp, th, b, trial.x, trial.u, c_rel,
                                          trial.phi, trial.il, trial.iu, s.mu)
            return trial, jnp.sum(jnp.abs(c_rel)), L, Jv, finite, ftb

        ls_args = (jp, th, b, bw.gains, nominal, bw.dL, s.mu, s.theta_curr,
                   s.L_curr, s.min_primal_1, s.filter_pts)
        return dict(
            gains=bw.gains, dL=bw.dL, cands=jax.vmap(try_step)(gammas),
            spec=jf.forward_pass_speculative(*ls_args, spec_o),
            hybrid=jf.forward_pass_hybrid(*ls_args, hyb_o),
            hybrid2=jf.forward_pass_hybrid(*ls_args, hyb2_o),
            backtrack=jf.forward_pass(*ls_args, jo))

    ref = jax.jit(jax.vmap(per_lane))(bounds, theta, state)

    pb, _, _, pth = torch_concar_args(inst)
    ps = convert.state_from_numpy(state)
    pg = convert.gains_from_numpy(ref["gains"])
    pdL = torch.as_tensor(np.array(ref["dL"]))
    return dict(pp=pp, pb=pb, pth=pth, ps=ps, pg=pg, pdL=pdL, ref=ref,
                jax=(jp, bounds, theta, state))


def _kernel_args(c, dtype=torch.float64):
    """Arguments of the forward kernels' wrappers up to `tau`."""
    s = c["ps"]
    cast = lambda a: a.to(dtype)
    tau = torch.clamp(1.0 - s.mu, min=P.Options().tau_min)
    return (c["pp"], type(c["pth"])(*(cast(a) for a in c["pth"])),
            cast(c["pb"].lower), cast(c["pb"].upper),
            tuple(cast(g) for g in c["pg"]), cast(s.x), cast(s.u),
            cast(s.phi), cast(s.zl), cast(s.zu), cast(s.il), cast(s.iu),
            cast(s.mu), cast(tau))


def _ls_args(c):
    s = c["ps"]
    return (c["pp"], c["pth"], c["pb"], c["pg"], _nominal_trial(s), c["pdL"],
            s.mu, s.theta_curr, s.L_curr, s.min_primal_1, s.filter_pts)


def _assert_trial_field(a, b, rtol):
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=rtol * 1e-2)


def test_case_covers_full_step_short_step_and_none_of_k(case):
    """A full step, a step in 2^-1..2^-3, and a lane where none of the K
    candidates is accepted (its backtracking step is below 2^-(K-1))."""
    bt, spec = case["ref"]["backtrack"], case["ref"]["spec"]
    idx = -np.log2(np.asarray(bt.step_size))
    assert (np.asarray(bt.status) == 0).all()
    assert (idx == 0).any() and ((idx >= 1) & (idx <= 3)).any(), idx
    assert (idx >= K).any(), idx
    np.testing.assert_array_equal(np.asarray(spec.status) == 7, idx >= K)
    assert (np.asarray(bt.num_ls) > 0).any()


# ---- the plain versions of the kernels against the JAX reference ---------

@pytest.fixture(scope="module")
def plain_metrics(case):
    gammas = 0.5 ** torch.arange(K, dtype=torch.float64)
    return fc.forward_metrics_cuda(*_kernel_args(case), gammas)


@pytest.mark.parametrize("i,name", list(enumerate(
    ("theta", "L", "J", "finite", "ftb"))))
def test_metrics_plain_matches_jax(case, plain_metrics, i, name):
    a, b = tnp(plain_metrics[i]), np.asarray(case["ref"]["cands"][1 + i])
    assert a.shape == (B, K)
    if b.dtype == bool:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_metrics_case_has_both_flag_values(case):
    ftb = np.asarray(case["ref"]["cands"][5])
    assert ftb.any() and not ftb.all()


@pytest.mark.parametrize("i,name", list(enumerate(("theta", "L", "J"))))
def test_metrics_plain_float32(case, i, name):
    """The float32 walk against the float64 reference, where the lane is
    finite and inside the boundary (elsewhere log of a negative slack)."""
    gammas = 0.5 ** torch.arange(K, dtype=torch.float32)
    out = fc.forward_metrics_plain(*_kernel_args(case, torch.float32), gammas)
    assert out[i].dtype == torch.float32
    ok = np.asarray(case["ref"]["cands"][5]) & np.asarray(
        case["ref"]["cands"][4])
    b = np.asarray(case["ref"]["cands"][1 + i])
    np.testing.assert_allclose(tnp(out[i])[ok], b[ok], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def plain_trial(case):
    gammas = 0.5 ** torch.arange(K, dtype=torch.float64)
    return fc.forward_trial_cuda(*_kernel_args(case),
                                 gammas[torch.arange(B) % K])


@pytest.mark.parametrize("i,name", list(enumerate(TRIAL_ORDER)))
def test_trial_plain_matches_jax_rollout(case, plain_trial, i, name):
    """Lane b at gamma = 2^-(b mod K) against the JAX rollout there."""
    trials = case["ref"]["cands"][0]
    b = np.asarray(getattr(trials, name))[np.arange(B), np.arange(B) % K]
    _assert_trial_field(tnp(plain_trial[i]), b, 1e-11)


def test_wrappers_refuse_wrong_shapes(case):
    args = list(_kernel_args(case))
    gammas = 0.5 ** torch.arange(K, dtype=torch.float64)
    args[7] = args[7][:, :-1]                       # phibar one stage short
    with pytest.raises(ValueError, match="phibar"):
        fc.forward_metrics_cuda(*args, gammas)
    args = list(_kernel_args(case))
    with pytest.raises(ValueError, match="gamma"):
        fc.forward_trial_cuda(*args, gammas)        # [K], not [B]
    with pytest.raises(ValueError, match="float32"):
        fc.forward_metrics_cuda(*args, gammas.to(torch.float32))
    assert sum(fc.launch_counts.values()) == 0      # no launch on the CPU


# ---- the Pallas kernels in interpret mode, float32 -----------------------

@pytest.fixture(scope="module")
def pallas_case(case):
    """The case's state and gains in float32, K=2 candidates, through the
    Pallas kernels in interpret mode and through the port's plain
    versions."""
    Kk = 2
    jp, bounds, theta, state = case["jax"]
    f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    s = f32(state)
    tau = jnp.maximum(J.Options().tau_min, 1.0 - s.mu)
    args = (jp, f32(theta), f32(bounds.lower), f32(bounds.upper),
            tuple(f32(case["ref"]["gains"])), s.x, s.u, s.phi, s.zl, s.zu,
            s.il, s.iu, s.mu, tau)
    gammas = 0.5 ** jnp.arange(Kk, dtype=jnp.float32)
    gamma_b = gammas[jnp.arange(B) % Kk]
    metrics = forward_metrics_pallas(*args, gammas, dd_mode=False,
                                     interpret=True)
    trial = forward_trial_pallas(*args, gamma_b, dd_mode=False,
                                 interpret=True)
    t32 = lambda a: torch.as_tensor(np.array(a))
    pargs = (case["pp"], type(case["pth"])(t32(args[1].obstacles)),
             t32(args[2]), t32(args[3]), tuple(t32(g) for g in args[4]),
             *(t32(a) for a in args[5:]))
    return dict(metrics=metrics, trial=trial,
                p_metrics=fc.forward_metrics_cuda(*pargs, t32(gammas)),
                p_trial=fc.forward_trial_cuda(*pargs, t32(gamma_b)))


@pytest.mark.parametrize("i,name", list(enumerate(
    ("theta", "L", "J", "finite", "ftb"))))
def test_metrics_plain_matches_pallas_interpret(pallas_case, i, name):
    a = tnp(pallas_case["p_metrics"][i])
    b = np.asarray(pallas_case["metrics"][i])
    if b.dtype == bool:
        np.testing.assert_array_equal(a, b)
    else:
        assert a.dtype == np.float32
        ok = np.asarray(pallas_case["metrics"][3])
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("i,name", list(enumerate(TRIAL_ORDER)))
def test_trial_plain_matches_pallas_interpret(pallas_case, i, name):
    a, b = tnp(pallas_case["p_trial"][i]), np.asarray(pallas_case["trial"][i])
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-5)


# ---- the line searches against the JAX functions of the same names -------

@pytest.fixture(scope="module")
def port_results(case):
    """Every (search, route) of the port on the case. The kernel route runs
    on CPU tensors, where the wrappers take the kernels' plain versions."""
    args = _ls_args(case)
    opt = lambda **kw: P.Options(forward_kernel="torch", **OPTS, **kw)
    out = {}
    for route in ("plain", "kernel"):
        out["spec", route] = pf.forward_pass_speculative(
            *args, opt(ls_speculative=K), route=route)
        out["hybrid", route] = pf.forward_pass_hybrid(
            *args, opt(ls_speculative=K, ls_spec_continue=True), route=route)
        out["hybrid2", route] = pf.forward_pass_hybrid(
            *args, opt(ls_speculative=2, ls_spec_continue=True), route=route)
        out["backtrack", route] = pf.forward_pass(*args, opt(), route=route)
    return out


SEARCHES = ("spec", "hybrid", "hybrid2")
ROUTES = ("plain", "kernel")


@pytest.mark.parametrize("field", DECISIONS)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("search", SEARCHES)
def test_decision_matches_jax(case, port_results, search, route, field):
    np.testing.assert_array_equal(
        tnp(getattr(port_results[search, route], field)),
        np.asarray(getattr(case["ref"][search], field)))


@pytest.mark.parametrize("field", MEASURES)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("search", SEARCHES)
def test_measures_match_jax(case, port_results, search, route, field):
    np.testing.assert_allclose(
        tnp(getattr(port_results[search, route], field)),
        np.asarray(getattr(case["ref"][search], field)),
        rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("field", pf.Trial._fields)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("search", SEARCHES)
def test_trial_matches_jax(case, port_results, search, route, field):
    _assert_trial_field(
        tnp(getattr(port_results[search, route].trial, field)),
        np.asarray(getattr(case["ref"][search].trial, field)), 1e-9)


def test_speculative_lane_without_accept_keeps_the_full_step(port_results):
    for route in ROUTES:
        r = port_results["spec", route]
        lost = r.status == 7
        assert bool(lost.any())
        assert bool((r.step_size[lost] == 1.0).all())


@pytest.mark.parametrize("field", ("step_size", "status", "num_ls",
                                   "armijo_passed", "switching"))
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("search", ("hybrid", "hybrid2"))
def test_hybrid_decides_as_backtracking(port_results, search, route, field):
    """Inside the port: the hybrid search picks the step, the status and the
    count that pure backtracking picks."""
    assert torch.equal(getattr(port_results[search, route], field),
                       getattr(port_results["backtrack", route], field))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("search", ("hybrid", "hybrid2"))
def test_hybrid_trial_equals_backtracking_trial(port_results, search, route):
    a, b = port_results[search, route], port_results["backtrack", route]
    for name in pf.Trial._fields:
        x, y = tnp(getattr(a.trial, name)), tnp(getattr(b.trial, name))
        _assert_trial_field(x, y, 1e-12)
    for name in MEASURES:
        np.testing.assert_allclose(tnp(getattr(a, name)),
                                   tnp(getattr(b, name)), rtol=1e-12)


@pytest.mark.parametrize("search", ("hybrid", "backtrack"))
def test_skipped_lane_runs_no_trial_and_changes_no_other(case, port_results,
                                                         search):
    """`skip` marks lanes whose result the solver throws away (converged,
    barrier update): lane 0, which backtracks below 2^-K, then runs no
    trial, and every other lane's result is what it was."""
    skip = torch.zeros(B, dtype=torch.bool)
    skip[0] = True
    opt = P.Options(forward_kernel="torch", **OPTS)
    if search == "hybrid":
        out = pf.forward_pass_hybrid(
            *_ls_args(case), dataclasses.replace(
                opt, ls_speculative=K, ls_spec_continue=True), skip=skip)
        assert float(out.step_size[0]) == 0.5 ** K      # where it started
    else:
        out = pf.forward_pass(*_ls_args(case), opt, skip=skip)
        assert float(out.step_size[0]) == 1.0
    ref = port_results[search, "plain"]
    assert int(out.status[0]) == 7 and int(ref.status[0]) == 0
    for name in DECISIONS + MEASURES:
        assert torch.equal(getattr(out, name)[1:], getattr(ref, name)[1:])
    for a, b in zip(out.trial, ref.trial):
        assert torch.equal(a[1:], b[1:])


def test_routes_agree_inside_the_port(port_results):
    for search in SEARCHES + ("backtrack",):
        a, b = port_results[search, "plain"], port_results[search, "kernel"]
        for name in DECISIONS:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---- a complementarity row, and no constraints at all --------------------

@pytest.mark.parametrize("nc,compl", [(2, (1,)), (0, ())],
                         ids=["compl_row", "nc0"])
def test_plain_versions_match_rollout_route_on_tiny_problems(nc, compl):
    """The stage-by-stage walk against `rollout` + the whole-array measures
    on the nx=2, nu=3, T=6 problem, with mu-relaxed row 1 / without rows;
    some upper bounds infinite."""
    _, pp = tiny_problems(nc)()
    pp = dataclasses.replace(pp, compl_indices=compl)
    Bt, Kt = 5, 3
    inp = {k: torch.as_tensor(v) for k, v in tiny_inputs(3, Bt, nc).items()}
    rng = np.random.default_rng(4)
    rnd = lambda *s: torch.as_tensor(0.1 * rng.standard_normal((Bt, 6) + s))
    gains = pf.Gains(rnd(3), rnd(3, 2), rnd(nc), rnd(nc, 2), rnd(3),
                     rnd(3, 2), rnd(3), rnd(3, 2))
    lo = inp["u"] - inp["il"]
    hi = inp["u"] + inp["iu"]
    hi[:, :, 2] = float("inf")
    bounds = P.Bounds(lo, hi)
    il, iu = inp["u"] - lo, hi - inp["u"]
    mu = torch.full((Bt,), 0.3, dtype=torch.float64)
    tau = torch.full((Bt,), 0.99, dtype=torch.float64)
    gammas = 0.5 ** torch.arange(Kt, dtype=torch.float64)
    args = (pp, None, lo, hi, tuple(gains), inp["x"], inp["u"], inp["phi"],
            inp["zl"], inp["zu"], il, iu, mu, tau)
    metrics = fc.forward_metrics_plain(*args, gammas)
    nominal = pf.Trial(x=inp["x"], u=inp["u"], c_raw=inp["c"], il=il, iu=iu,
                       phi=inp["phi"], zl=inp["zl"], zu=inp["zu"])
    for k in range(Kt):
        g = gammas[k].expand(Bt)
        trial = pf.rollout(pp, None, bounds, gains, inp["x"], inp["u"],
                           inp["phi"], inp["zl"], inp["zu"], g)
        out = fc.forward_trial_plain(*args, g)
        for name, a in zip(TRIAL_ORDER, out):
            _assert_trial_field(tnp(a), tnp(getattr(trial, name)), 1e-12)
        want = pf._measures(pp, None, bounds, trial, nominal, mu, tau)
        for a, b in zip(metrics, want):
            if b.dtype == torch.bool:
                assert torch.equal(a[:, k], b)
            else:
                np.testing.assert_allclose(tnp(a[:, k]), tnp(b), rtol=1e-12)
    assert bool(metrics[3].all())


# ---- options --------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(ls_speculative=8), dict(ls_speculative=8, ls_spec_continue=True),
    dict(forward_kernel="cuda"), dict(forward_kernel="torch"),
    dict(forward_kernel="xla"), dict(forward_kernel="auto"),
])
def test_options_accepted_now(kwargs):
    assert P.Options(**kwargs).validate() is not None


@pytest.mark.parametrize("kwargs,err", [
    (dict(forward_kernel="pallas"), ValueError),
    (dict(forward_kernel="pallas_df64"), ValueError),
    (dict(ls_speculative=-1), ValueError),
    (dict(backward_mode="parallel"), NotImplementedError),
])
def test_options_still_refused(kwargs, err):
    with pytest.raises(err):
        P.Options(**kwargs).validate()


def test_forward_route_by_options_problem_and_device():
    _, pp = short_concar()
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    no_model = dataclasses.replace(pp, device_model=None)
    hyb = dict(ls_speculative=4, ls_spec_continue=True)
    assert pf.forward_route(pp, P.Options(**hyb), cpu) == "plain"
    assert pf.forward_route(pp, P.Options(**hyb), gpu) == "kernel"
    assert pf.forward_route(no_model, P.Options(**hyb), gpu) == "plain"
    # pure backtracking under "auto" keeps the graph-replayed rollout
    assert pf.forward_route(pp, P.Options(), gpu) == "plain"
    assert pf.forward_route(pp, P.Options(forward_kernel="cuda"),
                            gpu) == "kernel"
    assert pf.forward_route(pp, P.Options(forward_kernel="torch", **hyb),
                            gpu) == "plain"
    with pytest.raises(RuntimeError, match="GPU"):
        pf.forward_route(pp, P.Options(forward_kernel="cuda"), cpu)
    with pytest.raises(ValueError, match="device functions"):
        pf.forward_route(no_model, P.Options(forward_kernel="cuda"), gpu)
