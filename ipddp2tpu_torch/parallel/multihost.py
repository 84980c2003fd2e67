"""Multi-process entry: host-sharded instance generation over a global mesh
(PyTorch port, `torch.distributed`).

Counterpart of `ipddp2tpu/parallel/multihost.py`. Every process runs the
same program, one process a device (`torchrun --nproc-per-node N` on one
host, or one launch per host): `initialize_distributed` joins it to the
process group, the mesh spans every rank, and each rank generates ONLY its
own shard of the instance batch (generation is by global index, so the set
of instances is independent of the process count). The solve is
`mesh.solve_shard`; instances are independent and the only traffic between
ranks is the convergence bookkeeping.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..options import Options
from ..problem import Problem
from ..solve import resolve_device
from .mesh import _axis_size, make_mesh, solve_shard


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> None:
    """Join this process to the process group; a no-op for a world of one.

    Unset arguments come from the environment `torchrun` sets
    (`WORLD_SIZE`, `RANK`, `init_method="env://"`). The backend is the
    caller's, or follows the device it names (default: the GPU, which
    raises without one): "nccl" for CUDA, on the GPU `LOCAL_RANK` names,
    "gloo" for the CPU. Nothing is probed."""
    world_size = int(os.environ.get("WORLD_SIZE", 1)) \
        if world_size is None else world_size
    if world_size <= 1:
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def global_mesh(axis: str = "dp"):
    """1-D mesh over every rank of every process."""
    return make_mesh(axis=axis)


def _stack(items):
    """Stack the leaves of equally shaped trees (tuples, NamedTuples,
    tensors, None) along a new leading axis."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    parts = [_stack(list(leaves)) for leaves in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def host_sharded_instances(gen: Callable[[int], tuple], n_global: int,
                           mesh, axis: str = "dp"):
    """This rank's shard of a global batch, generating only its own
    instances: `gen(global_index)` gives one instance's tree (e.g.
    (bounds, x1, u0, theta), leaves without a batch axis); the rank calls
    it for its contiguous global indices and stacks the results. Generation
    cost and host memory are 1/D of the batch's."""
    D = _axis_size(mesh, axis)
    assert n_global % D == 0, \
        "the mesh axis size must divide the global batch size"
    per = n_global // D
    rank = mesh.get_local_rank(axis)
    return _stack([gen(g) for g in range(rank * per, (rank + 1) * per)])


def solve_global(problem: Problem, gen: Callable[[int], tuple],
                 n_global: int, options: Optional[Options] = None,
                 mesh=None, axis: str = "dp", device=None):
    """Host-sharded generation and the sharded solve over the global mesh.

    `gen(i) -> (bounds, x1, u_init, theta)` for global instance i (theta may
    be None, but then for every i). Returns (Solution of this rank's shard,
    BatchStats of the whole batch)."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else global_mesh(axis)
    bounds, x1, u0, theta = host_sharded_instances(gen, n_global, mesh,
                                                   axis)
    return solve_shard(problem, bounds, x1, u0, theta, options, mesh, axis,
                       device)
