"""Optimal control problem specification (PyTorch port).

Same problem class and conventions as the JAX package (`ipddp2tpu/problem.py`,
reference: README.md:5-15, src/data/problem.jl):

    minimize_{x,u}   sum_{t=0}^{T-1} l(x_t, u_t, t)  +  l_T(x_T)
    subject to       x_0 = x1
                     x_{t+1} = f(x_t, u_t, t)      t = 0..T-1
                     c(x_t, u_t, t) = 0            t = 0..T-1
                     lower_t <= u_t <= upper_t     t = 0..T-1   (+-inf allowed)

with `T` control stages of uniform (nx, nu, nc) and an explicit terminal cost.

`Problem` is a frozen, hashable dataclass of functions and dims. The user
callables are written for ONE instance and ONE stage, on 1-D tensors,

    dynamics(x, u, t, theta)      -> x_next  [nx]
    stage_cost(x, u, t, theta)    -> scalar
    terminal_cost(x, theta)       -> scalar
    constraints(x, u, t, theta)   -> [nc]

and must trace under `torch.func` (build vectors with `torch.stack`, no
in-place ops, no `.item()`); the port maps them over (batch, time) with
`torch.func.vmap`. All runtime data is batch-first: every tensor the solver
handles carries a leading `B` axis, and B = 1 is the single instance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static problem structure (hashable: a cache key for built closures)."""

    T: int                              # number of control stages (= reference horizon - 1)
    nx: int
    nu: int
    nc: int
    dynamics: Callable                  # f(x, u, t, theta) -> [nx]
    stage_cost: Callable                # l(x, u, t, theta) -> scalar
    terminal_cost: Callable             # lT(x, theta) -> scalar
    constraints: Optional[Callable] = None   # c(x, u, t, theta) -> [nc]
    compl_indices: tuple = ()           # constraint rows relaxed by mu
    contact: bool = False               # declares contact structure; steers
                                        # inertia_method="auto" to "bk"

    def __post_init__(self):
        if self.nc > 0 and self.constraints is None:
            raise ValueError("nc > 0 requires a constraints function")
        if any((i < 0 or i >= self.nc) for i in self.compl_indices):
            raise ValueError("compl_indices out of range")

    @property
    def horizon(self) -> int:
        """Reference-convention horizon N (= T + 1)."""
        return self.T + 1

    def eval_constraints(self, x, u, t, theta):
        if self.nc == 0:
            return x.new_zeros((0,))
        return self.constraints(x, u, t, theta)

    def compl_mask(self, dtype, device=None):
        """[nc] vector with 1.0 at mu-relaxed complementarity rows."""
        m = torch.zeros((self.nc,), dtype=dtype, device=device)
        if self.compl_indices:
            m[list(self.compl_indices)] = 1.0
        return m


class Bounds(NamedTuple):
    """Runtime control bounds, `[B, T, nu]` each, +-inf marks an absent bound
    (reference: src/bounds.jl:1-26 keeps index lists; here isfinite masks)."""

    lower: Tensor
    upper: Tensor

    @property
    def mask_lower(self):
        return torch.isfinite(self.lower)

    @property
    def mask_upper(self):
        return torch.isfinite(self.upper)

    @property
    def num_bounds(self):
        """Count of finite bounds per instance, `[B]`."""
        n = self.mask_lower.to(torch.int64) + self.mask_upper.to(torch.int64)
        return n.flatten(1).sum(dim=1)


def unbounded(T: int, nu: int, dtype=torch.float64, device=None) -> Bounds:
    inf = float("inf")
    return Bounds(
        lower=torch.full((T, nu), -inf, dtype=dtype, device=device),
        upper=torch.full((T, nu), inf, dtype=dtype, device=device),
    )


def uniform_bounds(T: int, lower, upper) -> Bounds:
    """Broadcast a single-stage bound pair `[..., nu]` to all T stages
    `[..., T, nu]`."""
    lower = torch.as_tensor(lower)
    upper = torch.as_tensor(upper)
    bc = lambda b: b.unsqueeze(-2).expand(b.shape[:-1] + (T, b.shape[-1]))
    return Bounds(lower=bc(lower), upper=bc(upper))


def batch_bounds(bounds: Bounds, batch: int) -> Bounds:
    """`[T, nu]` bounds shared by all instances -> batch-first `[B, T, nu]`;
    bounds that already carry the batch axis pass through."""
    if bounds.lower.dim() == 3:
        return bounds
    bc = lambda b: b.unsqueeze(0).expand((batch,) + b.shape)
    return Bounds(lower=bc(bounds.lower), upper=bc(bounds.upper))


# Solver status codes — identical numbering to the reference
# (reference: src/data/solver.jl:5-7).
STATUS_OK = 0                     # converged / running
STATUS_BACKWARD_FAILED = 1        # no PD iteration matrix within reg ladder
STATUS_FRACTION_BOUNDARY = 2      # (transient) fraction-to-boundary violated
STATUS_FILTER_BLOCKED = 3         # (transient) trial blocked by filter
STATUS_ARMIJO_FAILED = 4          # (transient) Armijo decrease failed
STATUS_SUFFICIENT_PROGRESS = 5    # (transient) theta/L progress failed
STATUS_SOC_FAILED = 6             # reserved (reference never sets it)
STATUS_LINE_SEARCH_FAILED = 7     # step size underflowed machine eps
STATUS_MAX_ITERATIONS = 8
STATUS_STALLED = 9                # host-side stall freeze of the chunked
                                  # solve loop (not ported yet)

STATUS_MESSAGES = {
    STATUS_OK: "Optimal solution found",
    STATUS_BACKWARD_FAILED: "Backward pass failure: unable to find positive definite iteration matrix",
    STATUS_LINE_SEARCH_FAILED: "Line search failed to find a suitable iterate",
    STATUS_MAX_ITERATIONS: "Maximum solver iterations reached",
    STATUS_STALLED: "Stalled: frozen by the chunked solve loop (no progress)",
}
