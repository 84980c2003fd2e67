"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages: the JAX
package gets them as jax arrays, the port through `ipddp2tpu_torch.convert`.
Everything runs on the CPU; the port then uses its plain PyTorch versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import ipddp2tpu as J
from ipddp2tpu.models import concar as jconcar
from ipddp2tpu.models import double_integrator as jdi

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.models import concar as pconcar
from ipddp2tpu_torch.models import double_integrator as pdi

# tiny tensors: threads only cost when several test workers share the cores
torch.set_num_threads(1)

T_SHORT = 16


def tnp(t):
    """torch -> numpy."""
    return t.detach().cpu().numpy()


def short_concar(T=T_SHORT):
    """Short-horizon concar (same stage functions) in both packages."""
    jp = J.Problem(T=T, nx=jconcar.NX, nu=jconcar.NU, nc=jconcar.NC,
                   dynamics=jconcar.dynamics, stage_cost=jconcar.stage_cost,
                   terminal_cost=jconcar.terminal_cost,
                   constraints=jconcar.constraints)
    pp = P.Problem(T=T, nx=pconcar.NX, nu=pconcar.NU, nc=pconcar.NC,
                   dynamics=pconcar.dynamics, stage_cost=pconcar.stage_cost,
                   terminal_cost=pconcar.terminal_cost,
                   constraints=pconcar.constraints, device_model="concar")
    return jp, pp


def concar_instances(seed, batch, T=T_SHORT, dtype=np.float64):
    """Random concar instances with the reference generator's ranges, as
    numpy arrays: dict(obstacles [B,4,3], lower/upper [B,T,nu], x1 [B,4],
    u0 [B,T,nu])."""
    rng = np.random.default_rng(seed)
    f_lim = 1.5 + rng.uniform(size=batch)
    tau_lim = 3.0 + 2.0 * rng.uniform(size=batch)
    centers = np.array([[0.25, 0.25], [0.75, 0.75], [0.25, 0.75],
                        [0.75, 0.25]])
    xy = centers + (rng.uniform(size=(batch, 4, 2)) - 0.5) * 0.2
    r = 0.05 + rng.uniform(size=(batch, 4)) * 0.15
    x1 = np.zeros((batch, 4))
    x1[:, 2] = np.pi / 8 + rng.uniform(size=batch) * np.pi / 4
    lo = np.zeros((batch, 10))
    hi = np.full((batch, 10), np.inf)
    lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1] = -f_lim, -tau_lim, f_lim, tau_lim
    u0 = np.concatenate([np.zeros(2), np.full(8, 1e-2)])
    bc = lambda a: np.broadcast_to(a[:, None, :], (batch, T, 10)).copy()
    return dict(
        obstacles=np.concatenate([xy, r[..., None]], axis=-1).astype(dtype),
        lower=bc(lo).astype(dtype), upper=bc(hi).astype(dtype),
        x1=x1.astype(dtype),
        u0=np.broadcast_to(u0, (batch, T, 10)).astype(dtype))


def jax_concar_args(inst):
    """(bounds, x1, u0, theta) of the JAX package for `concar_instances`."""
    return (J.Bounds(jnp.asarray(inst["lower"]), jnp.asarray(inst["upper"])),
            jnp.asarray(inst["x1"]), jnp.asarray(inst["u0"]),
            jconcar.Theta(jnp.asarray(inst["obstacles"])))


def torch_concar_args(inst, dtype=torch.float64):
    """The same four for the port."""
    return (convert.bounds_from_numpy(inst["lower"], inst["upper"], dtype),
            torch.as_tensor(inst["x1"]).to(dtype),
            torch.as_tensor(inst["u0"]).to(dtype),
            convert.theta_from_numpy((inst["obstacles"],), dtype,
                                     cls=pconcar.Theta))


def tiny_problems(nc=2):
    """The nx=2, nu=3, T=6 problem of tests/test_backward_pallas.py in both
    packages; `bad_cost` swaps in its indefinite stage cost."""
    nx, nu, T = 2, 3, 6

    def make(np_, stack, pkg, bad_cost):
        def dynamics(x, u, t, theta):
            return stack([
                x[0] + 0.1 * x[1] + 0.05 * u[0] + 0.01 * np_.sin(u[1]),
                x[1] + 0.1 * u[0] - 0.02 * x[0] * u[2]])

        def cost(x, u, t, theta):
            return (np_.sum(x ** 2) + 0.1 * np_.sum(u ** 2)
                    + 0.01 * x[0] * u[1] + 0.001 * u[0] ** 3)

        def bad(x, u, t, theta):
            return (np_.sum(x ** 2) - 0.8 * np_.sum(u ** 2)
                    + 0.01 * x[0] * u[1])

        def terminal(x, theta):
            return 2.0 * np_.sum(x ** 2) + 0.1 * x[0] * x[1]

        def constraints(x, u, t, theta):
            return stack([u[0] + u[1] + 0.1 * x[0] ** 2,
                          u[2] - 0.5 * u[0] * u[1]])[:nc]

        return pkg.Problem(T=T, nx=nx, nu=nu, nc=nc, dynamics=dynamics,
                           stage_cost=bad if bad_cost else cost,
                           terminal_cost=terminal,
                           constraints=constraints if nc else None)

    def both(bad_cost=False):
        return (make(jnp, jnp.stack, J, bad_cost),
                make(torch, torch.stack, P, bad_cost))

    return both


def tiny_inputs(seed, batch, nc, dtype=np.float64):
    """Randomized trajectories AND duals for the tiny problem (order bugs
    hide at uniform duals)."""
    rng = np.random.default_rng(seed)
    T, nx, nu = 6, 2, 3
    shp = lambda *d: (batch,) + d
    return dict(
        x=(0.5 * rng.standard_normal(shp(T + 1, nx))).astype(dtype),
        u=(0.5 * rng.standard_normal(shp(T, nu))).astype(dtype),
        phi=rng.standard_normal(shp(T, nc)).astype(dtype),
        il=(0.5 + rng.uniform(size=shp(T, nu))).astype(dtype),
        iu=(0.5 + rng.uniform(size=shp(T, nu))).astype(dtype),
        zl=(0.1 + rng.uniform(size=shp(T, nu))).astype(dtype),
        zu=(0.1 + rng.uniform(size=shp(T, nu))).astype(dtype),
        c=rng.standard_normal(shp(T, nc)).astype(dtype))


def short_pair(jm, pm, T=T_SHORT):
    """A model of both packages (`jm`, `pm`: a module of `ipddp2tpu.models`
    and its port) at horizon T, the stage functions unchanged."""
    import dataclasses
    return (dataclasses.replace(jm.problem(), T=T),
            dataclasses.replace(pm.problem(), T=T))


def _first(tree):
    return jax.tree.map(lambda a: a[0], tree)


def check_model_against_jax(jm, pm, jtheta, ptheta, seed, B=3, T=4,
                            rtol=1e-12, d_rtol=1e-10):
    """A model's stage, terminal and constraint functions at random points
    (instance 0's theta) and its whole derivative bundle on random
    trajectories and duals of B instances, against the JAX model. `jtheta`,
    `ptheta` carry the batch axis (or are None). Values agree to `rtol`
    (the same formulas, other libm), the bundle to `d_rtol` (AD in other
    association orders), both with an absolute floor of that times the
    largest entry."""
    import ipddp2tpu.derivatives as jd
    from ipddp2tpu_torch import derivatives as pd
    jp, pp = short_pair(jm, pm, T)
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((B, T + 1, jm.NX))
    u = 0.3 * rng.standard_normal((B, T, jm.NU))
    phi = rng.standard_normal((B, T, jm.NC))
    j0 = None if jtheta is None else _first(jtheta)
    p0 = None if ptheta is None else pytree_first(ptheta)

    def close(a, b, tol, what):
        a, b = tnp(a), np.asarray(b)
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * max(np.abs(b).max(), 1e-300),
                                   err_msg=what)

    for t in range(T):
        jx, ju = jnp.asarray(x[0, t]), jnp.asarray(u[0, t])
        px, pu = torch.as_tensor(x[0, t]), torch.as_tensor(u[0, t])
        close(pm.dynamics(px, pu, t, p0), jm.dynamics(jx, ju, t, j0), rtol,
              "dynamics")
        close(pm.stage_cost(px, pu, t, p0), jm.stage_cost(jx, ju, t, j0),
              rtol, "stage_cost")
        if jm.NC:
            close(pm.constraints(px, pu, t, p0),
                  jm.constraints(jx, ju, t, j0), rtol, "constraints")
    close(pm.terminal_cost(torch.as_tensor(x[0, T]), p0),
          jm.terminal_cost(jnp.asarray(x[0, T]), j0), rtol, "terminal_cost")

    ref = jax.jit(jax.vmap(lambda th, a, b, c: jd.evaluate_derivatives(
        jp, th, a, b, c, with_dynamics_hessian=True)))(
            jtheta, jnp.asarray(x), jnp.asarray(u), jnp.asarray(phi))
    out = pd.evaluate_derivatives(pp, ptheta, torch.as_tensor(x),
                                  torch.as_tensor(u), torch.as_tensor(phi),
                                  with_dynamics_hessian=True)
    for name in out._fields:
        a, b = getattr(out, name), getattr(ref, name)
        if b is None or np.asarray(b).size == 0:
            assert a is None or a.numel() == 0, name
            continue
        close(a, b, d_rtol, name)


def pytree_first(tree):
    """Instance 0 of a port theta (a NamedTuple of batched tensors)."""
    from torch.utils import _pytree
    return _pytree.tree_map(lambda a: a[0], tree)


def params_instances(jm, name, n=100):
    """The JAX generator's instances of the campaign
    (`experiments/run_benchmarks.py`: `jax.random.split(PRNGKey(1), n)`), as
    numpy pytrees: (theta, lower, upper, x1)."""
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    if name in ("concar", "concar_quad"):
        th, f_lim, tau_lim, x1 = jax.vmap(jm.random_instance)(keys)
        b = jm.bounds(f_lim, tau_lim)
    elif name == "quadrotor":
        th, x1 = jax.vmap(jm.random_instance)(keys)
        b = jm.bounds()
    elif name == "cartpole_swingup":
        th, x1 = None, jax.vmap(jm.random_instance)(keys)
        b = jm.bounds()
    else:
        th = jax.vmap(jm.random_instance)(keys)
        x1 = jnp.broadcast_to(jm.initial_state(), (n, jm.NX))
        b = jm.bounds()
    lower = np.broadcast_to(np.asarray(b.lower), (n, jm.T, jm.NU))
    upper = np.broadcast_to(np.asarray(b.upper), (n, jm.T, jm.NU))
    return (None if th is None else jax.tree.map(np.asarray, th), lower,
            upper, np.asarray(x1))


def check_params_reader(jm, pm, name):
    """The port's reader of `experiments/params/<PARAMS>` against the JAX
    generator that wrote the file: every value bit for bit."""
    from torch.utils import _pytree
    th, lower, upper, x1 = params_instances(jm, name)
    pth, pb, px1, pu0 = pm.from_params(convert.params_rows(pm.PARAMS))
    if th is None:
        assert pth is None
    else:
        got = [tnp(a) for a in _pytree.tree_leaves(pth)]
        want = jax.tree.leaves(th)
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(tnp(pb.lower), lower, err_msg=name)
    np.testing.assert_array_equal(tnp(pb.upper), upper, err_msg=name)
    np.testing.assert_array_equal(tnp(px1), x1, err_msg=name)
    np.testing.assert_array_equal(
        tnp(pu0), np.broadcast_to(np.asarray(jm.initial_controls()),
                                  (len(x1), jm.T, jm.NU)), err_msg=name)
