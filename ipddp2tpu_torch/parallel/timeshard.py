"""Time-axis sharding: the suffix value scan distributed over a device mesh
(PyTorch port, `torch.distributed`).

Counterpart of `ipddp2tpu/parallel/timeshard.py`. For horizons far beyond
one device's sweet spot, the associative value recursion
(`priccati.parallel_value_scan`) shards over time: each rank scans its
contiguous block of T/D stages, the D block totals (5 small tensors a lane,
a few KB) are exchanged with one all-gather over the mesh's axis, every
rank folds the totals of the blocks on the terminal side of its own into
an exclusive prefix in O(D) combines, applies it to its local prefixes, and
one more all-gather of the blocks gives every rank the full result.

Depth: O(T/D + log D) combines against O(log T) on one device and O(T) for
the sequential recursion; bytes exchanged a pass: D (3 nx^2 + 2 nx) values
a lane for the totals, T (nx^2 + nx) for the blocks.

The mesh is a 1-D `torch.distributed.device_mesh.DeviceMesh` (dim name
"sp"), the counterpart of the JAX package's `Mesh`. Every rank holds the
full `[B, T, ...]` elements, as every process does under `jit` there, and
returns the full `(Vx, Vxx)`.

Where the exchange runs follows the backend of the mesh's group, stated,
not probed: NCCL moves the tensors on the rank's GPU; gloo has no CUDA
all-gather, so with gloo the exchange goes through host copies of the
totals and blocks (a few KB; the scan itself stays on the device the
elements are on).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from ..backward import _associative_scan
from ..problem import Problem
from .priccati import ValueElement, _terminal_first, combine

Tensor = torch.Tensor


def _identity_element(B: int, nx: int, dtype, device) -> ValueElement:
    """Neutral element of `combine`, one a lane: V composes through
    unchanged."""
    z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=device)
    return ValueElement(
        A=torch.eye(nx, dtype=dtype, device=device).expand(B, nx, nx),
        b=z(nx), C=z(nx, nx), eta=z(nx), J=z(nx, nx))


def _block_scan(seq: ValueElement) -> ValueElement:
    """Inclusive associative scan of one local block (reverse-time order,
    along dim 1)."""
    return ValueElement(*_associative_scan(combine, seq))


def _all_gather(t: Tensor, group) -> list:
    """`t` from every rank of `group`, in rank order, on `t`'s device. With
    NCCL on that device; with gloo through host copies."""
    host = dist.get_backend(group) == "gloo"
    src = t.cpu() if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if host else parts


def _pack(fields) -> Tensor:
    """Flatten tensors `[B, ...]` into one `[B, n]`."""
    return torch.cat([f.reshape(f.shape[0], -1) for f in fields], dim=1)


def _unpack(flat: Tensor, like) -> list:
    out, at = [], 0
    for f in like:
        n = f[0].numel()
        out.append(flat[:, at:at + n].reshape(f.shape))
        at += n
    return out


def value_scan_timesharded(problem: Problem, elements: ValueElement, lTx,
                           lTxx, mesh, axis: str = "sp"):
    """Suffix value functions with the time axis sharded over `mesh[axis]`.

    Same contract as `priccati.parallel_value_scan`: `elements` are the
    `[B, T, ...]` stage maps of the current iterate; returns (Vx [B, T, nx],
    Vxx [B, T, nx, nx]) with entry t = V_{t+1}, on every rank. The axis
    size must divide T."""
    T, nx = problem.T, problem.nx
    group = mesh.get_group(axis)
    D = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    assert T % D == 0, "the time-mesh axis size must divide the horizon T"
    n = T // D
    seq = _terminal_first(elements, lTx, lTxx)
    local = ValueElement(*(e[:, idx * n:(idx + 1) * n] for e in seq))
    B, dtype, device = lTx.shape[0], lTx.dtype, lTx.device

    # 1. local inclusive scan over this rank's block of stages
    local_scan = _block_scan(local)
    # 2. exchange the block totals (each block's last prefix)
    total = [e[:, -1] for e in local_scan]
    totals = [_unpack(t, total) for t in _all_gather(_pack(total), group)]
    # 3. exclusive prefix of the terminal-side totals for this block: the
    #    totals of blocks 0..idx-1 composed (block 0 holds the terminal
    #    element), computed on every rank in O(D) combines
    prefix = _identity_element(B, nx, dtype, device)
    for d in range(idx):
        prefix = combine(prefix, totals[d])
    # 4. fold the boundary prefix into every local prefix
    out = combine(tuple(p[:, None].expand(e.shape)
                        for p, e in zip(prefix, local_scan)), local_scan)
    # 5. every rank gets every block
    blocks = _all_gather(_pack((out.eta.reshape(B * n, nx),
                                out.J.reshape(B * n, nx * nx))), group)
    eta = torch.cat([b[:, :nx].reshape(B, n, nx) for b in blocks], dim=1)
    J = torch.cat([b[:, nx:].reshape(B, n, nx, nx) for b in blocks], dim=1)
    return torch.flip(-eta, dims=(1,)), torch.flip(J, dims=(1,))


# ---------------------------------------------------------------------------
# End-to-end wiring: backward_mode="timeshard"
#
# `Options` is a frozen, hashable configuration and holds no mesh, so the
# active time mesh reaches `solve._body` through this context:
# `solve_timesharded` sets it for the duration of the solve.
# ---------------------------------------------------------------------------

_ACTIVE_TIME_MESH: list = []


def active_time_mesh():
    """The (mesh, axis) installed by `use_time_mesh`, or raise."""
    if not _ACTIVE_TIME_MESH:
        raise RuntimeError(
            'backward_mode="timeshard" needs an active time mesh; call the '
            "solve through `solve_timesharded(...)` or wrap it in "
            "`use_time_mesh(mesh, axis)`")
    return _ACTIVE_TIME_MESH[-1]


@contextlib.contextmanager
def use_time_mesh(mesh, axis: str = "sp"):
    _ACTIVE_TIME_MESH.append((mesh, axis))
    try:
        yield
    finally:
        _ACTIVE_TIME_MESH.pop()


def solve_timesharded(problem: Problem, bounds, x1, u_init, theta=None,
                      options=None, mesh=None, axis: str = "sp",
                      device=None):
    """`solve` with the backward pass's value scan sharded over the mesh's
    time axis: the long-horizon regime, where one solve spans devices and
    the O(T/D + log D)-depth blockwise scan replaces the sequential
    recursion. Every rank calls it with the same instance(s) and gets the
    same solution. `mesh` defaults to a 1-D mesh over the world (after
    `multihost.initialize_distributed`); the axis size must divide T."""
    from ..options import Options
    from ..solve import resolve_device, solve
    from .mesh import make_mesh

    device = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    options = dataclasses.replace(options or Options(),
                                  backward_mode="timeshard", auto_tune=False)
    with use_time_mesh(mesh, axis):
        return solve(problem, bounds, x1, u_init, theta=theta,
                     options=options, device=device)
