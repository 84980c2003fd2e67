"""The reference-style facade (`ipddp2tpu_torch/solver.py`) against the JAX
package's (`ipddp2tpu/solver.py`): construction from per-stage lists, the
ragged lifts, `solve` and `get_trajectory`.

Both packages lower the same lists to the same uniform problem; the port
solves it with its plain PyTorch path on the CPU. Tolerances: the double
integrator's golden rule (31 iterations, 1.26574863 at rtol 1e-6, as
tests/test_facade.py); the two packages' solutions of one lifted problem
within rtol 1e-8 (objective) and 1e-7 (trajectories)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J

import ipddp2tpu_torch as P
from ipddp2tpu_torch.solver import _lower_stagewise

from torch_port_helpers import tnp

DT = 0.01


def _di_lists(pkg, lib, T, dt=DT, goal=(1.0, 0.0)):
    """The double integrator of tests/test_facade.py in package `pkg` with
    array library `lib` (jnp or torch)."""
    vec = (lambda *v: jnp.array(v)) if lib is jnp else \
        (lambda *v: torch.stack(v))
    g = lib.asarray(goal) if lib is jnp else torch.tensor(
        goal, dtype=torch.float64)
    dyn = pkg.Dynamics(lambda x, u: x + dt * vec(x[1], u[0]), 2, 3)
    stage = pkg.Objective(lambda x, u: dt * (u[1] + u[2]), 2, 3)
    term = pkg.Objective(lambda x, u: 500.0 * ((x - g) ** 2).sum(), 2, 0)
    con = pkg.Constraint(lambda x, u: vec(u[1] - u[2] - u[0] * x[1]), 2, 3)
    bound = pkg.Bound(np.array([-10.0, 0.0, 0.0]),
                      np.array([10.0, np.inf, np.inf]))
    return ([dyn] * T, [stage] * T + [term],
            [con] * T + [pkg.Constraint(2, 0)], [bound] * T + [pkg.Bound(0)])


def test_facade_double_integrator_matches_jax():
    """The golden facade solve in both packages: 31 iterations and
    1.26574863 in the port, its trajectories on the JAX facade's."""
    T = 100
    u_init = [np.full(3, 0.01) for _ in range(T)] + [np.zeros(0)]
    opts = dict(optimality_tolerance=1e-7)
    ref = J.Solver(*_di_lists(J, jnp, T), options=J.Options(**opts))
    ref_sol = ref.solve(np.zeros(2), u_init)
    solver = P.Solver(*_di_lists(P, torch, T), options=P.Options(**opts),
                      device="cpu")
    sol = solver.solve(np.zeros(2), u_init)
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.objective), 1.26574863, rtol=1e-6)
    assert int(sol.iterations) == 31
    np.testing.assert_allclose(float(sol.objective), float(ref_sol.objective),
                               rtol=1e-8)
    x, u = P.get_trajectory(solver)
    assert x.shape == (T + 1, 2) and u.shape == (T, 3)
    np.testing.assert_allclose(tnp(x), np.asarray(ref_sol.x), atol=1e-7)
    np.testing.assert_allclose(tnp(u), np.asarray(ref_sol.u), atol=1e-7)
    assert P.current_trajectory(solver)[1] is u
    assert solver.wall_time > 0


def test_uniform_lists_lower_to_a_direct_call():
    """Fresh per-stage wrappers of one user callable dedupe to one direct
    call (one evaluation per stage, whatever the stage index); distinct
    callables are each evaluated once and the stage's one is selected, by
    the Python stage of a rollout and by a tensor stage under vmap."""
    calls = []

    def counted(tag, fn):
        def f(x, u):
            calls.append(tag)
            return fn(x, u)
        return f

    T = 8
    dyn, objs, cons, bounds = _di_lists(P, torch, T)
    objs = [P.Objective(counted("cost", objs[0].f), 2, 3)] * T + objs[T:]
    solver = P.Solver(dyn, objs, cons, bounds, device="cpu")
    x = torch.tensor([0.5, -1.0], dtype=torch.float64)
    u = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    for t in (3, torch.tensor(3)):
        calls.clear()
        solver.problem.stage_cost(x, u, t, None)
        assert calls == ["cost"]

    a = counted("a", lambda x, u: x + u[:2])
    b = counted("b", lambda x, u: x - u[:2])
    fn = _lower_stagewise([a, a, b, a], keys=["a", "a", "b", "a"])
    calls.clear()
    assert torch.equal(fn(x, u, 2, None), x - u[:2]) and calls == ["b"]
    ts = torch.arange(4)
    out = torch.func.vmap(fn, in_dims=(None, None, 0, None))(x, u, ts, None)
    assert torch.equal(out, torch.stack([x + u[:2], x + u[:2], x - u[:2],
                                         x + u[:2]]))


def _ragged_controls(pkg, lib, T):
    """tests/test_ragged.py's ragged-control double integrator: 3 controls
    and a constraint in the first half, 1 control without in the second."""
    vec = (lambda *v: jnp.array(v)) if lib is jnp else \
        (lambda *v: torch.stack(v))
    g = jnp.array([1.0, 0.0]) if lib is jnp else torch.tensor(
        [1.0, 0.0], dtype=torch.float64)
    f3 = lambda x, u: x + DT * vec(x[1], u[0])
    f1 = lambda x, u: x + DT * vec(x[1], u[0])
    dyn = [pkg.Dynamics(f3, 2, 3)] * (T // 2) \
        + [pkg.Dynamics(f1, 2, 1)] * (T - T // 2)
    stage3 = pkg.Objective(lambda x, u: DT * (u[1] + u[2]), 2, 3)
    stage1 = pkg.Objective(lambda x, u: DT * u[0] ** 2, 2, 1)
    term = pkg.Objective(lambda x, u: 500.0 * ((x - g) ** 2).sum(), 2, 0)
    objs = [stage3] * (T // 2) + [stage1] * (T - T // 2) + [term]
    con3 = pkg.Constraint(lambda x, u: vec(u[1] - u[2] - u[0] * x[1]), 2, 3)
    cons = [con3] * (T // 2) + [pkg.Constraint(2, 1)] * (T - T // 2) \
        + [pkg.Constraint(2, 0)]
    b3 = pkg.Bound(np.array([-10.0, 0.0, 0.0]),
                   np.array([10.0, np.inf, np.inf]))
    b1 = pkg.Bound(np.array([-10.0]), np.array([10.0]))
    bounds = [b3] * (T // 2) + [b1] * (T - T // 2) + [pkg.Bound(0)]
    u_init = ([np.full(3, 0.01)] * (T // 2)
              + [np.full(1, 0.01)] * (T - T // 2) + [np.zeros(0)])
    return (dyn, objs, cons, bounds), u_init


def test_ragged_controls_match_jax():
    """Ragged controls and constraints lifted by padding: the same lifted
    problem in both packages, KKT-certified, padded controls at 0."""
    T = 16
    opts = dict(optimality_tolerance=1e-7, max_iterations=400)
    lists, u_init = _ragged_controls(J, jnp, T)
    ref = J.Solver(*lists, options=J.Options(**opts)).solve(np.zeros(2),
                                                            u_init)
    lists, u_init = _ragged_controls(P, torch, T)
    solver = P.Solver(*lists, options=P.Options(**opts), device="cpu")
    assert (solver.problem.nu, solver.problem.nc) == (3, 1)
    sol = solver.solve(np.zeros(2), u_init)
    assert bool(sol.converged) and bool(ref.converged)
    assert float(sol.primal_inf) < 1e-7
    assert float(sol.u[T // 2:, 1:].abs().max()) < 1e-6
    np.testing.assert_allclose(float(sol.objective), float(ref.objective),
                               rtol=1e-8)
    np.testing.assert_allclose(tnp(sol.x), np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(tnp(sol.u), np.asarray(ref.u), atol=1e-7)


def _ragged_states(pkg, lib, T, T1, dt=0.05):
    """tests/test_ragged.py's ragged-state problem: a scalar integrator that
    hands off to a double integrator at stage T1."""
    if lib is jnp:
        arr = lambda *v: jnp.array(v)
        zero = lambda x: 0.0
        g = jnp.array([1.0, 0.0])
    else:
        arr = lambda *v: torch.stack(v)
        zero = torch.zeros_like
        g = torch.tensor([1.0, 0.0], dtype=torch.float64)
    f1 = lambda x, u: x + dt * u
    fh = lambda x, u: arr(x[0] + dt * u[0], zero(x[0]))
    f2 = lambda x, u: arr(x[0] + dt * x[1], x[1] + dt * u[0])
    dyn = ([pkg.Dynamics(f1, 1, 1)] * (T1 - 1) + [pkg.Dynamics(fh, 1, 1)]
           + [pkg.Dynamics(f2, 2, 1)] * (T - T1))
    stage = pkg.Objective(lambda x, u: dt * (u * u).sum(), 1, 1)
    stage2 = pkg.Objective(lambda x, u: dt * (u * u).sum(), 2, 1)
    term = pkg.Objective(lambda x, u: 300.0 * ((x - g) ** 2).sum(), 2, 0)
    objs = [stage] * T1 + [stage2] * (T - T1) + [term]
    b = pkg.Bound(np.array([-5.0]), np.array([5.0]))
    # the hand-padded uniform formulation of the same problem
    g1 = lambda x, u: arr(x[0] + dt * u[0], zero(x[0]))
    uniform = ([pkg.Dynamics(g1, 2, 1)] * T1
               + [pkg.Dynamics(f2, 2, 1)] * (T - T1))
    return ((dyn, objs, None, [b] * T + [pkg.Bound(0)]),
            (uniform, [stage2] * T + [term], None,
             [b] * T + [pkg.Bound(0)]))


def test_ragged_states_match_jax():
    """Ragged state dims lifted by zero slots: the port's ragged solve equals
    its hand-padded uniform one (objective, iterations) and the JAX
    facade's; `get_trajectory` trims the states to each stage's dims."""
    T, T1 = 16, 8
    opts = dict(optimality_tolerance=1e-7)
    u_init = [np.full(1, 0.01)] * T + [np.zeros(0)]
    ragged, _ = _ragged_states(J, jnp, T, T1)
    ref = J.Solver(*ragged, options=J.Options(**opts)).solve(np.zeros(1),
                                                             u_init)
    ragged, uniform = _ragged_states(P, torch, T, T1)
    solver = P.Solver(*ragged, options=P.Options(**opts), device="cpu")
    sol = solver.solve(np.zeros(1), u_init)
    sol_u = P.Solver(*uniform, options=P.Options(**opts),
                     device="cpu").solve(np.zeros(2), u_init)
    assert bool(sol.converged) and bool(sol_u.converged)
    np.testing.assert_allclose(float(sol.objective), float(sol_u.objective),
                               rtol=1e-9)
    assert int(sol.iterations) == int(sol_u.iterations)
    np.testing.assert_allclose(float(sol.objective), float(ref.objective),
                               rtol=1e-8)
    x, u = P.get_trajectory(solver)
    assert isinstance(x, list) and len(x) == T + 1
    assert x[0].shape == (1,) and x[T1 - 1].shape == (1,)
    assert x[T1].shape == (2,) and x[-1].shape == (2,) and u.shape == (T, 1)
    with pytest.raises(AssertionError, match="solve"):
        P.get_trajectory(P.Solver(*ragged, device="cpu"))
