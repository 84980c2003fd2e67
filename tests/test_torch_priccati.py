"""The time-parallel backward pass (`ipddp2tpu_torch/parallel/priccati.py`,
`backward_mode="parallel"`) against the JAX package's.

Both packages get the same derivative bundle, costates and second-order
terms (made by the JAX package from numpy inputs drawn from a seed), so the
comparisons hold the port's stage blocks, combine, value scan, gain
recovery and ladder to the JAX package's alone. Tolerances: the stage
elements and suffix values to 1e-10 of each tensor's scale (the same
products and solves, other summation orders); the ladder's reg, delta_c and
status, and the gains, to 1e-9; five parallel-mode iterations of a short
concar solve to 1e-8 in x and u (tests/test_torch_solve.py's rule); the
double-integrator golden as tests/test_priccati.py holds it (31 +- 3
iterations, objective to rtol 1e-6)."""

import dataclasses
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
from ipddp2tpu.models import cartpole_swingup as jcs
from ipddp2tpu.parallel import priccati as jpr

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.batch import solve_batch
from ipddp2tpu_torch.models import cartpole_swingup as pcs
from ipddp2tpu_torch.models import double_integrator as pdi
from ipddp2tpu_torch.parallel import priccati as ppr

from torch_port_helpers import (T_SHORT, concar_instances, jax_concar_args,
                                short_concar, short_pair, tnp,
                                torch_concar_args)

T = T_SHORT


def _state(problem, seed, B, lower=None, upper=None):
    """A randomized iterate (non-uniform duals, a perturbed trajectory) of
    `problem` as numpy arrays: x, u, phi, il, iu, zl, zu, c, mu."""
    rng = np.random.default_rng(seed)
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    il = 0.5 + rng.uniform(size=(B, T, nu))
    iu = 0.5 + rng.uniform(size=(B, T, nu))
    if lower is not None:              # unbounded directions: slack +inf
        il = np.where(np.isfinite(lower), il, np.inf)
        iu = np.where(np.isfinite(upper), iu, np.inf)
    return dict(
        x=0.3 * rng.standard_normal((B, T + 1, nx)),
        u=0.3 * rng.standard_normal((B, T, nu)),
        phi=0.5 * rng.standard_normal((B, T, nc)),
        il=il, iu=iu,
        zl=np.where(np.isfinite(il), 0.1 + rng.uniform(size=(B, T, nu)), 0.0),
        zu=np.where(np.isfinite(iu), 0.1 + rng.uniform(size=(B, T, nu)), 0.0),
        c=0.1 * rng.standard_normal((B, T, nc)),
        mu=0.05 + 0.1 * rng.uniform(size=B))


@functools.partial(jax.jit, static_argnames="jp")
def _jax_terms(jp, theta, x, u, phi):
    """The JAX package's bundle, costates (the associative order, its CPU
    default) and second-order terms, vmapped over the batch."""
    deriv = jax.vmap(lambda th, a, b, c: jd.evaluate_derivatives(
        jp, th, a, b, c, with_dynamics_hessian=True))(theta, x, u, phi)
    lam = jax.vmap(jb.costate_scan)(deriv, phi)
    second = deriv.cH_phi + jnp.einsum("bti,btijk->btjk", lam[:, 1:],
                                       deriv.fH)
    return deriv, lam, second


def _torch_terms(terms):
    deriv, lam, second = terms
    return (convert.deriv_from_numpy(deriv), torch.as_tensor(np.array(lam)),
            torch.as_tensor(np.array(second)))


def _nominal(st):
    return tuple(st[k] for k in ("c", "il", "iu", "phi", "zl", "zu"))


@functools.partial(jax.jit, static_argnames="jp")
def _jax_scan(jp, deriv, nominal, mu, second, reg, dc):
    def one(d, nom, m, sec, r, c):
        el = jpr._stage_blocks(jp, d, nom, m, sec, r, c, J.Options())
        return el, jpr.parallel_value_scan(jp, el, d.lTx, d.lTxx)
    return jax.vmap(one)(deriv, nominal, mu, second, reg, dc)


def _close(out, ref, rtol, name=""):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape, name
    if ref.size == 0:
        return
    np.testing.assert_allclose(tnp(out), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=name)


def test_stage_blocks_and_value_scan_match_jax():
    """concar at T=16, four instances on randomized duals and trajectories
    (the stage maps differ, so a composition-order error shows), three of
    them regularized (reg, delta_c or both > 0): every stage element and
    both suffix values."""
    jp, pp = short_concar()
    inst = concar_instances(3, 4)
    _, _, _, jth = jax_concar_args(inst)
    st = _state(pp, 5, 4)
    terms = _jax_terms(jp, jth, st["x"], st["u"], st["phi"])
    reg = np.array([0.0, 1e-3, 0.0, 1e-1])
    dc = np.array([0.0, 1e-6, 1e-8, 0.0])
    (el, (Vx, Vxx)) = _jax_scan(jp, terms[0], _nominal(st), st["mu"],
                                terms[2], reg, dc)
    deriv, _, second = _torch_terms(terms)
    nominal = tuple(torch.as_tensor(a) for a in _nominal(st))
    t = lambda a: torch.as_tensor(a)
    pel = ppr._stage_blocks(pp, deriv, nominal, t(st["mu"]), second, t(reg),
                            t(dc), P.Options())
    for name, a, b in zip(ppr.ValueElement._fields, pel, el):
        _close(a, b, 1e-10, name)
    pVx, pVxx = ppr.parallel_value_scan(pp, pel, deriv.lTx, deriv.lTxx)
    _close(pVx, Vx, 1e-10, "Vx")
    _close(pVxx, Vxx, 1e-10, "Vxx")


@functools.partial(jax.jit, static_argnames="jp")
def _jax_parallel_pass(jp, deriv, nominal, mu, reg_last, lam, second):
    return jax.vmap(lambda d, nom, m, r, l, s: jpr.backward_pass_parallel(
        jp, d, nom, m, r, J.Options(), lam=l, second=s))(
            deriv, nominal, mu, reg_last, lam, second)


def _check_pass(jp, pp, st, terms, reg_last):
    ref = _jax_parallel_pass(jp, terms[0], _nominal(st), st["mu"], reg_last,
                             terms[1], terms[2])
    deriv, lam, second = _torch_terms(terms)
    out = ppr.backward_pass_parallel(
        pp, deriv, tuple(torch.as_tensor(a) for a in _nominal(st)),
        torch.as_tensor(st["mu"]), torch.as_tensor(reg_last), P.Options(),
        lam=lam, second=second)
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))
    for name in ("reg", "delta_c", "dL"):
        np.testing.assert_allclose(tnp(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, err_msg=name)
    for name, a, b in zip(ppr.Gains._fields, out.gains, ref.gains):
        _close(a, b, 1e-9, name)
    return out


def test_backward_pass_parallel_ladder_matches_jax():
    """Four concar lanes: lane 1 with an indefinite stage (the ladder
    bumps reg), lane 2 with an indefinite early stage and an exactly
    singular late one (cu = 0 there: the latest-in-time failing stage is
    singular, so delta_c latches on the first restart), lane 3 the other
    way round (delta_c latches only once a larger reg has cleared the
    late stage), from a previous reg on lanes 2 and 3: reg, delta_c,
    status, dL and every gain."""
    jp, pp = short_concar()
    inst = concar_instances(7, 4)
    _, _, _, jth = jax_concar_args(inst)
    st = _state(pp, 9, 4)
    deriv, lam, second = _jax_terms(jp, jth, st["x"], st["u"], st["phi"])
    luu, cu = np.array(deriv.luu), np.array(deriv.cu)
    luu[1, 6] -= 40.0 * np.eye(pp.nu)
    luu[2, 2] -= 40.0 * np.eye(pp.nu)
    cu[2, 12] = 0.0
    luu[3, 12] -= 40.0 * np.eye(pp.nu)
    cu[3, 2] = 0.0
    deriv = deriv._replace(luu=jnp.asarray(luu), cu=jnp.asarray(cu))
    out = _check_pass(jp, pp, st, (deriv, lam, second),
                      np.array([0.0, 0.0, 1e-3, 1e-2]))
    delta_c = tnp(out.delta_c)
    assert (tnp(out.reg)[1:] > 0).all() and tnp(out.reg)[0] == 0
    assert delta_c[0] == delta_c[1] == 0 and (delta_c[2:] > 0).all()


def test_backward_pass_parallel_without_constraints_matches_jax():
    """nc = 0 (the cartpole swing-up, bound-only controls): one parallel
    backward pass on a randomized state."""
    jp, pp = short_pair(jcs, pcs, T)
    b = pcs.bounds()
    st = _state(pp, 13, 2, tnp(b.lower[:T]), tnp(b.upper[:T]))
    terms = _jax_terms(jp, None, st["x"], st["u"], st["phi"])
    _check_pass(jp, pp, st, terms, np.zeros(2))


def test_parallel_mode_solve_follows_jax():
    """Five iterations of a short concar batch with
    backward_mode="parallel" in both packages: x and u to 1e-8, counters
    equal."""
    jp, pp = short_concar()
    inst = concar_instances(11, 3)
    ref = j_solve_batch(jp, *jax_concar_args(inst)[:3],
                        theta=jax_concar_args(inst)[3],
                        options=J.Options(max_iterations=5,
                                          optimality_tolerance=1e-7,
                                          backward_mode="parallel"))
    pbnd, px1, pu0, pth = torch_concar_args(inst)
    out = solve_batch(pp, pbnd, px1, pu0, theta=pth,
                      options=P.Options(max_iterations=5,
                                        optimality_tolerance=1e-7,
                                        backward_mode="parallel"),
                      device="cpu")
    for field in ("x", "u"):
        np.testing.assert_allclose(tnp(getattr(out, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-8, atol=1e-8, err_msg=field)
    np.testing.assert_array_equal(tnp(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(tnp(out.status), np.asarray(ref.status))


def test_parallel_mode_double_integrator_golden():
    """The double integrator through backward_mode="parallel" reaches the
    golden result (tests/test_priccati.py's rule); "timeshard" without an
    active time mesh is refused, and so is an unknown mode."""
    sol = P.solve(pdi.problem(), pdi.bounds(), pdi.initial_state()[None],
                  pdi.initial_controls()[None],
                  options=P.Options(optimality_tolerance=1e-7,
                                    backward_mode="parallel"),
                  device="cpu")
    assert bool(sol.converged[0]), int(sol.status[0])
    np.testing.assert_allclose(float(sol.objective[0]), pdi.GOLDEN_OBJECTIVE,
                               rtol=1e-6)
    assert abs(int(sol.iterations[0]) - pdi.GOLDEN_ITERATIONS) <= 3
    with pytest.raises(RuntimeError, match="time mesh"):
        P.solve(pdi.problem(), pdi.bounds(), pdi.initial_state()[None],
                pdi.initial_controls()[None],
                options=P.Options(max_iterations=1,
                                  backward_mode="timeshard"),
                device="cpu")
    with pytest.raises(ValueError, match="backward_mode"):
        P.Options(backward_mode="sequential").validate()
