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
                   constraints=pconcar.constraints)
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
