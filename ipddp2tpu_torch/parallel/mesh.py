"""Instance batches sharded over ranks (PyTorch port, `torch.distributed`).

Counterpart of `ipddp2tpu/parallel/mesh.py`. Instances are embarrassingly
parallel: the batch is laid out over the mesh's data-parallel axis "dp",
each rank solves its contiguous shard with `batch.solve_batch`, and
collectives carry only the convergence bookkeeping (`all_reduce` with SUM
and MAX of counts and error maxima); no other traffic exists. One rank
drives one device; the mesh is a 1-D
`torch.distributed.device_mesh.DeviceMesh` over the world, made after
`multihost.initialize_distributed`.

Where the bookkeeping moves follows the backend of the mesh's group,
stated, not probed: with NCCL on the rank's GPU, with gloo (which has no
CUDA collectives) on host copies of a few numbers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..batch import BatchStats, solve_batch
from ..options import Options
from ..problem import Bounds, Problem
from ..solve import Solution, resolve_device, tree_map

Tensor = torch.Tensor


def make_mesh(devices=None, axis: str = "dp") -> DeviceMesh:
    """A 1-D mesh over every rank of the world (or over the global ranks
    `devices`), on the device type of the default group's backend: "cuda"
    for NCCL, "cpu" for gloo."""
    ranks = list(range(dist.get_world_size())) if devices is None \
        else list(devices)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis,))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def sharded_batch_stats(sol: Solution, mesh: DeviceMesh,
                        axis: str = "dp") -> BatchStats:
    """The batch's convergence bookkeeping over every shard, the same on
    every rank: the only collectives of the sharded solve. The median is
    the mean of the shards' medians (the JAX package's `pmean` of them:
    bookkeeping only, never used for control flow); gloo has no AVG, so the
    sum over the axis is divided by its size."""
    group = mesh.get_group(axis)
    host = dist.get_backend(group) == "gloo"
    its = sol.iterations
    as64 = lambda *ts: torch.stack([torch.as_tensor(t).to(torch.float64)
                                    for t in ts])
    sums = as64(its.new_tensor(its.shape[0]), sol.converged.sum(),
                (sol.status != 0).sum(),
                its.to(torch.float64).quantile(0.5))
    maxes = as64(its.max(), sol.primal_inf.max(), sol.dual_inf.max())
    out = []
    for t, op in ((sums, dist.ReduceOp.SUM), (maxes, dist.ReduceOp.MAX)):
        t = t.cpu() if host else t
        dist.all_reduce(t, op=op, group=group)
        out.append(t.to(its.device))
    sums, maxes = out
    return BatchStats(
        num_instances=int(sums[0]),
        num_converged=sums[1].to(torch.int64),
        num_failed=sums[2].to(torch.int64),
        max_iterations=maxes[0].to(its.dtype),
        median_iterations=sums[3] / _axis_size(mesh, axis),
        max_primal_inf=maxes[1].to(sol.primal_inf.dtype),
        max_dual_inf=maxes[2].to(sol.dual_inf.dtype))


def _shard(tree, rank: int, per: int):
    """Rows rank*per .. (rank+1)*per of every tensor leaf."""
    return tree_map(lambda a: a[rank * per:(rank + 1) * per], tree)


def solve_shard(problem: Problem, bounds: Bounds, x1: Tensor,
                u_init: Tensor, theta, options: Optional[Options],
                mesh: DeviceMesh, axis: str = "dp", device=None):
    """Solve this rank's shard (every argument holds only its rows) and
    gather the bookkeeping over the axis. Returns (Solution of the shard,
    BatchStats of the whole batch)."""
    sol = solve_batch(problem, bounds, x1, u_init, theta=theta,
                      options=options, device=device)
    return sol, sharded_batch_stats(sol, mesh, axis)


def solve_sharded(problem: Problem, bounds: Bounds, x1: Tensor,
                  u_init: Tensor, theta=None,
                  options: Optional[Options] = None,
                  mesh: Optional[DeviceMesh] = None, axis: str = "dp",
                  device=None):
    """Solve a batch of instances sharded over the mesh's `axis`.

    Every rank passes the global batch (bounds `[B, T, nu]` or shared
    `[T, nu]`); it solves its contiguous rows on `device` (default: the
    GPU; raises without one) and returns that shard's `Solution` and the
    replicated `BatchStats`. The axis size must divide the batch size."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    D, B = _axis_size(mesh, axis), x1.shape[0]
    assert B % D == 0, "the mesh axis size must divide the batch size"
    rank, per = mesh.get_local_rank(axis), B // D
    if bounds.lower.dim() == 3:
        bounds = _shard(bounds, rank, per)
    return solve_shard(problem, bounds, _shard(x1, rank, per),
                       _shard(u_init, rank, per), _shard(theta, rank, per),
                       options, mesh, axis, device)
