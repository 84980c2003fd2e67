"""Solver modes the reference checks and the port's other tests did not:
quasi-Newton, the line-search failure resets, and the KKT property of the
returned point, each against the JAX package on the same inputs.

- quasi-Newton (`quasi_newton=True`, the JAX package's
  `tests/test_modes.py::test_quasi_newton`): five iterations of concar at
  T = 16 on three instances from a state with randomized duals, in the
  sequential and the parallel backward mode (which drops the second-order
  terms in `parallel/priccati.py` too). x, u, phi, zl and zu to 1e-10
  relative to each tensor's scale; k and status equal.
- Line-search resets (`ls_failure_resets`): a large `ls_min_step` rejects
  every step shorter than 0.3, so from concar's state after four default
  iterations the searches of some lanes fail. Three masked iterations
  (as `run` masks them) leave one lane out of resets (status 7 from the
  failed search), one lane with its filter reset twice and status 0, and
  two that never failed. ls_resets, filter_n, the filter points, status,
  k, x and u against JAX; with `ls_failure_resets=0` the same lanes fail
  where JAX's fail.
- KKT property (`tests/test_property_kkt.py`): three random smooth OCPs
  (numpy draws, seeds 0-2) carried per lane in theta, solved in one port
  solve; the returned point checked with that test's independent
  residuals through `torch.func` on the problem's own callables, and its
  objectives set beside a JAX solve of the same three to 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
from ipddp2tpu.batch import solve_batch as j_solve_batch
from ipddp2tpu.solve import SolverState as JState
from ipddp2tpu.solve import iteration as j_iteration
from ipddp2tpu.solve import run as j_run

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.solve import initialize as p_initialize
from ipddp2tpu_torch.solve import iteration as p_iteration
from ipddp2tpu_torch.solve import run as p_run
from ipddp2tpu_torch.solve import select_state

from torch_port_helpers import (concar_instances, jax_concar_args,
                                short_concar, tnp, torch_concar_args)

XLA = dict(backward_kernel="xla", forward_kernel="xla")


def _close(a, b, rtol, what):
    a, b = tnp(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _concar_setup(seed, batch):
    jp, pp = short_concar()
    inst = concar_instances(seed, batch)
    return jp, pp, jax_concar_args(inst), torch_concar_args(inst)


def _initial_state(pp, pargs):
    """The initial state of both packages (the port's `initialize`; the
    JAX package's is held to it by tests/test_torch_solve.py), as numpy
    arrays in the JAX package's `SolverState`."""
    pb, px, pu, pth = pargs
    s = p_initialize(pp, pth, pb, px, pu, P.Options(), device="cpu")
    return JState(**convert.state_to_numpy(s))


def _jax_run(jp, jargs, state, options, k_limit=None):
    jb, _, _, jth = jargs
    return jax.jit(jax.vmap(
        lambda b, s, th: j_run(jp, b, s, th, options, k_limit=k_limit),
        in_axes=(J.Bounds(0, 0), 0, 0)))(jb, state, jth)


# ---- quasi-Newton -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["scan", "parallel"])
def test_quasi_newton_matches_jax(mode):
    """Five quasi-Newton iterations from a state with randomized duals (phi
    of order one, zl / zu positive on the bounded directions only), the
    same state in both packages."""
    jp, pp, jargs, pargs = _concar_setup(11, 3)
    jo = J.Options(max_iterations=5, optimality_tolerance=1e-7,
                   quasi_newton=True, backward_mode=mode, **XLA)
    s0 = _initial_state(pp, pargs)
    rng = np.random.default_rng(5)
    lo, hi = np.asarray(jargs[0].lower), np.asarray(jargs[0].upper)
    s0 = s0._replace(
        phi=rng.standard_normal(s0.phi.shape),
        zl=np.where(np.isfinite(lo), 0.1 + rng.uniform(size=lo.shape), 0.0),
        zu=np.where(np.isfinite(hi), 0.1 + rng.uniform(size=hi.shape), 0.0))
    ref = _jax_run(jp, jargs, jax.tree.map(jnp.asarray, s0), jo)
    pb, _, _, pth = pargs
    out = p_run(pp, pb, convert.state_from_numpy(s0), pth,
                P.Options(max_iterations=5, optimality_tolerance=1e-7,
                          quasi_newton=True, backward_mode=mode),
                device="cpu")
    for name in ("x", "u", "phi", "zl", "zu"):
        _close(getattr(out, name), getattr(ref, name), 1e-10, name)
    np.testing.assert_array_equal(tnp(out.k), np.asarray(ref.k))
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    assert (tnp(out.k) == 5).all()


# ---- line-search failure resets ---------------------------------------------

RESET_START = 4          # default iterations before the large minimum step
RESET_MIN_STEP = 0.3     # rejects the step sizes 0.25 and below
RESET_STEPS = 3          # masked iterations with it


def _masked_steps(step, select, s, n):
    """`n` iterations masked per lane as `run` masks them (a lane steps
    while its status is 0 and it has not converged)."""
    for _ in range(n):
        active = (s.status == 0) & ~s.converged
        s = select(active, step(s), s)
    return s


def _jax_select(active, new, old):
    return jax.tree.map(
        lambda a, b: jnp.where(active.reshape((-1,) + (1,) * (a.ndim - 1)),
                               a, b), new, old)


@functools.lru_cache(maxsize=None)
def _reset_start():
    """Concar's state (seed 11, four lanes) after RESET_START default
    iterations (the port's; tests/test_torch_costate.py holds its default
    iterations to the JAX package's to 1e-12), status cleared of the
    limit's 8, as numpy arrays in the JAX package's `SolverState`."""
    _, pp, _, (pb, px, pu, pth) = _concar_setup(11, 4)
    opts = P.Options(optimality_tolerance=1e-7)
    s = p_initialize(pp, pth, pb, px, pu, opts, device="cpu")
    s = p_run(pp, pb, s, pth, opts, k_limit=RESET_START, device="cpu")
    s = s._replace(status=torch.zeros_like(s.status))
    return JState(**convert.state_to_numpy(s))


def _both_reset_runs(resets):
    jp, pp, jargs, pargs = _concar_setup(11, 4)
    jb, _, _, jth = jargs
    jo = J.Options(optimality_tolerance=1e-7, ls_min_step=RESET_MIN_STEP,
                   ls_failure_resets=resets, **XLA)
    jstep = jax.jit(jax.vmap(lambda b, s, th: j_iteration(jp, b, s, th, jo),
                             in_axes=(J.Bounds(0, 0), 0, 0)))
    s0 = _reset_start()
    ref = _masked_steps(lambda s: jstep(jb, s, jth), _jax_select,
                        jax.tree.map(jnp.asarray, s0), RESET_STEPS)
    pb, _, _, pth = pargs
    po = P.Options(optimality_tolerance=1e-7, ls_min_step=RESET_MIN_STEP,
                   ls_failure_resets=resets)
    out = _masked_steps(
        lambda s: p_iteration(pp, pb, s, pth, po, device="cpu"),
        select_state, convert.state_from_numpy(s0), RESET_STEPS)
    for name in ("ls_resets", "filter_n", "status", "k", "converged"):
        np.testing.assert_array_equal(tnp(getattr(out, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    fp, rp = tnp(out.filter_pts), np.asarray(ref.filter_pts)
    np.testing.assert_array_equal(np.isfinite(fp), np.isfinite(rp))
    live = np.isfinite(rp)
    np.testing.assert_allclose(fp[live], rp[live], rtol=1e-10, atol=1e-12)
    for name in ("x", "u"):
        _close(getattr(out, name), getattr(ref, name), 1e-10, name)
    return out


def test_ls_failure_resets_match_jax():
    """With two resets: lane 0 fails three times (out of resets, status 7),
    lane 1 fails twice (its filter reset twice, status 0), lanes 2 and 3
    never fail. Without resets the first failure ends a lane: lanes 0 and 1
    end with status 7 there as in JAX, having taken no further step."""
    out = _both_reset_runs(2)
    assert tnp(out.status).tolist() == [7, 0, 0, 0]
    assert tnp(out.ls_resets).tolist() == [2, 2, 0, 0]
    assert (tnp(out.filter_n)[:2] == 1).all()
    assert (tnp(out.k)[2:] > RESET_START).all()
    bare = _both_reset_runs(0)
    assert tnp(bare.status).tolist() == [7, 7, 0, 0]
    assert tnp(bare.ls_resets).tolist() == [0, 0, 0, 0]
    # what differs between the two runs is the reset branch alone
    assert torch.equal(bare.x[2:], out.x[2:])


# ---- the KKT property on random smooth OCPs ---------------------------------

NX, NU, NC, T = 3, 4, 2, 40
KKT_SEEDS = (0, 1, 2)
KKT_TOL = 1e-7


def _random_theta(seed):
    """tests/test_property_kkt.py's draws (its shapes and scales) from
    numpy: A, B, W, V, goal, cnl."""
    rng = np.random.default_rng(seed)
    return (np.eye(NX) + 0.1 * rng.standard_normal((NX, NX)),
            0.2 * rng.standard_normal((NX, NU)),
            rng.standard_normal((NC, NU)),
            0.5 * rng.standard_normal((NC, NX)),
            rng.standard_normal(NX),
            0.3 * rng.standard_normal(NC))


def _kkt_problem(pkg, m):
    """The JAX test's OCP with its matrices read from theta (`m`: the
    array module, jax.numpy or torch)."""

    def dynamics(x, u, t, th):
        A, B = th[0], th[1]
        return A @ x + B @ u + 0.05 * m.sin(x)

    def stage_cost(x, u, t, th):
        return 0.05 * (u * u).sum() + 0.01 * (x * x).sum()

    def terminal_cost(x, th):
        d = x - th[4]
        return 10.0 * (d * d).sum()

    def constraints(x, u, t, th):
        return th[2] @ u + th[3] @ m.tanh(x) + th[5] * u[0] * u[1]

    return pkg.Problem(T=T, nx=NX, nu=NU, nc=NC, dynamics=dynamics,
                       stage_cost=stage_cost, terminal_cost=terminal_cost,
                       constraints=constraints)


def test_kkt_certificate_on_random_ocps():
    """One port solve of the three problems (B = 3): every lane converged;
    at t = 0, T/2, T-1 the dynamics to 1e-10, the equality constraints to
    1e-6, u-stationarity to 1e-5, complementarity to 1e-5 and the bounds
    strictly; the objectives within 1e-6 of the JAX package's."""
    draws = [_random_theta(s) for s in KKT_SEEDS]
    thetas = [np.stack([d[i] for d in draws]) for i in range(6)]
    B = len(KKT_SEEDS)
    lower, upper = -2.0 * np.ones((B, T, NU)), 2.0 * np.ones((B, T, NU))
    u0 = 0.01 * np.ones((B, T, NU))

    jprob = _kkt_problem(J, jnp)
    jopts = J.Options(optimality_tolerance=KKT_TOL, max_iterations=400,
                      **XLA)
    ref = jax.jit(lambda th: j_solve_batch(
        jprob, J.Bounds(jnp.asarray(lower), jnp.asarray(upper)),
        jnp.zeros((B, NX)), jnp.asarray(u0), theta=th, options=jopts))(
            tuple(jnp.asarray(a) for a in thetas))

    pprob = _kkt_problem(P, torch)
    pth = tuple(torch.as_tensor(a) for a in thetas)
    sol = P.solve(pprob, convert.bounds_from_numpy(lower, upper),
                  torch.zeros(B, NX, dtype=torch.float64),
                  torch.as_tensor(u0), theta=pth,
                  options=P.Options(optimality_tolerance=KKT_TOL,
                                    max_iterations=400), device="cpu")
    assert bool(sol.converged.all()), tnp(sol.status)
    assert bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(tnp(sol.objective), np.asarray(ref.objective),
                               rtol=1e-6)

    for i in range(B):
        th = tuple(a[i] for a in pth)
        x, u, phi = sol.x[i], sol.u[i], sol.phi[i]
        zl, zu, lam = sol.zl[i], sol.zu[i], sol.lam[i]
        for t in (0, T // 2, T - 1):
            xt, ut = x[t], u[t]
            np.testing.assert_allclose(
                tnp(pprob.dynamics(xt, ut, t, th)), tnp(x[t + 1]),
                atol=1e-10)
            c = pprob.constraints(xt, ut, t, th)
            assert float(c.abs().max()) < 1e-6, (i, t)
            lu = torch.func.grad(
                lambda uu: pprob.stage_cost(xt, uu, t, th))(ut)
            cu = torch.func.jacfwd(
                lambda uu: pprob.constraints(xt, uu, t, th))(ut)
            fu = torch.func.jacfwd(
                lambda uu: pprob.dynamics(xt, uu, t, th))(ut)
            r = lu + cu.T @ phi[t] + fu.T @ lam[t + 1] - zl[t] + zu[t]
            assert float(r.abs().max()) < 1e-5, (i, t, float(r.abs().max()))
            il, iu = ut + 2.0, 2.0 - ut
            assert float((il * zl[t]).abs().max()) < 1e-5, (i, t)
            assert float((iu * zu[t]).abs().max()) < 1e-5, (i, t)
            assert float(il.min()) > 0 and float(iu.min()) > 0, (i, t)
