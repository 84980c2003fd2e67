"""Port forward pass (rollout Trial, backtracking line search) against the
JAX package from the same gains.

The lanes come from two JAX mid-solve states of short-horizon concar (one
right after initialization, one after several iterations), so that within
one batch some lanes backtrack several times and some accept at gamma = 1.

Tolerance: the accepted step size, the counters and the flags are discrete
and must be equal; trial arrays agree to rtol 1e-9 (a T-step closed-loop
rollout of the same formulas, libm and summation order differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
import ipddp2tpu.backward as jb
import ipddp2tpu.derivatives as jd
import ipddp2tpu.forward as jf
from ipddp2tpu.solve import _nominal_trial as j_nominal_trial
from ipddp2tpu.solve import initialize as j_initialize
from ipddp2tpu.solve import run as j_run

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch import forward as pf

from torch_port_helpers import (concar_instances, jax_concar_args,
                                short_concar, tnp, torch_concar_args)

B = 4
OPTS = dict(optimality_tolerance=1e-7)


@pytest.fixture(scope="module")
def case():
    jp, pp = short_concar()
    inst = concar_instances(5, B)
    bounds, x1, u0, theta = jax_concar_args(inst)
    jo = J.Options(backward_kernel="xla", forward_kernel="xla", **OPTS)

    def one(b, x, u, th, k):
        s = j_initialize(jp, th, b, x, u, jo)
        return j_run(jp, b, s, th, jo, k_limit=k)

    # one compiled solve serves both iteration limits (a runtime argument)
    mid = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    s0, s1 = mid(bounds, x1, u0, theta, 0), mid(bounds, x1, u0, theta, 6)
    # lanes 0,1 from the start, lanes 2,3 from six iterations in
    state = jax.tree.map(
        lambda a, b: jnp.concatenate([a[:2], b[2:]], axis=0), s0, s1)

    def fwd(b, th, s):
        deriv = jd.evaluate_derivatives(jp, th, s.x, s.u, s.phi)
        c_rel = jd.relax_constraints(jp, s.c_raw, s.mu)
        nominal = (c_rel, s.il, s.iu, s.phi, s.zl, s.zu)
        bw = jb.backward_pass(jp, deriv, nominal, s.mu, s.reg_last, jo)
        trial1 = jf.rollout(jp, th, b, bw.gains, s.x, s.u, s.phi, s.zl, s.zu,
                            jnp.asarray(0.25))
        fw = jf.forward_pass(jp, th, b, bw.gains, j_nominal_trial(s),
                             bw.dL, s.mu, s.theta_curr, s.L_curr,
                             s.min_primal_1, s.filter_pts, jo)
        return bw.gains, bw.dL, trial1, fw

    gains, dL, trial_q, fw = jax.jit(jax.vmap(fwd))(bounds, theta, state)

    pb_, _, _, pth = torch_concar_args(inst)
    ps = convert.state_from_numpy(state)
    pg = convert.gains_from_numpy(gains)
    pdL = torch.as_tensor(np.array(dL))
    return dict(pp=pp, pb=pb_, pth=pth, ps=ps, pg=pg, pdL=pdL,
                trial_q=trial_q, fw=fw)


def test_rollout_trial_matches_jax(case):
    c, s = case, case["ps"]
    out = pf.rollout(c["pp"], c["pth"], c["pb"], c["pg"], s.x, s.u, s.phi,
                     s.zl, s.zu, torch.full((B,), 0.25, dtype=torch.float64))
    for name in pf.Trial._fields:
        a, b = tnp(getattr(out, name)), np.asarray(getattr(c["trial_q"], name))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=1e-11,
                                   err_msg=name)


@pytest.fixture(scope="module")
def port_forward(case):
    c, s = case, case["ps"]
    from ipddp2tpu_torch.solve import _nominal_trial
    return pf.forward_pass(
        c["pp"], c["pth"], c["pb"], c["pg"], _nominal_trial(s), c["pdL"],
        s.mu, s.theta_curr, s.L_curr, s.min_primal_1, s.filter_pts,
        P.Options(**OPTS))


def test_lanes_cover_full_step_and_backtracking(case):
    steps = np.asarray(case["fw"].step_size)
    assert (steps == 1.0).any() and (steps <= 0.25).any(), steps
    assert (np.asarray(case["fw"].status) == 0).all()


@pytest.mark.parametrize("field", ["step_size", "num_ls", "status",
                                   "armijo_passed", "switching"])
def test_line_search_decision_matches_jax(case, port_forward, field):
    np.testing.assert_array_equal(tnp(getattr(port_forward, field)),
                                  np.asarray(getattr(case["fw"], field)))


@pytest.mark.parametrize("field", ["theta_next", "L_next", "objective"])
def test_accepted_measures_match_jax(case, port_forward, field):
    np.testing.assert_allclose(tnp(getattr(port_forward, field)),
                               np.asarray(getattr(case["fw"], field)),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("field", pf.Trial._fields)
def test_accepted_trial_matches_jax(case, port_forward, field):
    a = tnp(getattr(port_forward.trial, field))
    b = np.asarray(getattr(case["fw"].trial, field))
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=1e-11)


def test_failed_lane_keeps_last_trial_and_status_7(case):
    """With a filter that blocks everything on lane 1, that lane halves down
    to machine eps and fails with status 7 while the others accept as
    before; its counter counts only the filter rejections."""
    c, s = case, case["ps"]
    from ipddp2tpu_torch.solve import _nominal_trial
    fpts = s.filter_pts.clone()
    fpts[1, 1, 0] = -float("inf")
    fpts[1, 1, 1] = -float("inf")
    out = pf.forward_pass(
        c["pp"], c["pth"], c["pb"], c["pg"], _nominal_trial(s), c["pdL"],
        s.mu, s.theta_curr, s.L_curr, s.min_primal_1, fpts,
        P.Options(**OPTS))
    ref = case["fw"]
    assert tnp(out.status).tolist() == [0, 7, 0, 0]
    assert float(out.step_size[1]) < torch.finfo(torch.float64).eps
    keep = [0, 2, 3]
    np.testing.assert_array_equal(tnp(out.step_size)[keep],
                                  np.asarray(ref.step_size)[keep])
    np.testing.assert_array_equal(tnp(out.num_ls)[keep],
                                  np.asarray(ref.num_ls)[keep])
    assert int(out.num_ls[1]) > 10
    assert bool(torch.isfinite(out.trial.x[1]).all())
