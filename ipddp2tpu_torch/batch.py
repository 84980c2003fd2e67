"""Instance batching: the data-parallel axis of the port.

Counterpart of `ipddp2tpu/batch.py`. The JAX package batches the solver by
`vmap`; the port's solver is written batch-first, so `solve_batch` is a thin
call into `solve`, after `autotune.tune` as in the JAX package. Converged or
failed instances freeze their slice of the carried state while the rest keep
iterating; per-instance status codes replace the reference's per-seed result
rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .autotune import tune
from .options import Options
from .problem import Bounds, Problem
from .solve import Solution, resolve_device, solve

Tensor = torch.Tensor


class BatchStats(NamedTuple):
    """Aggregate convergence bookkeeping for a batch of instances."""

    num_instances: int
    num_converged: Tensor
    num_failed: Tensor          # status != 0 (line search / backward failures)
    max_iterations: Tensor      # slowest instance
    median_iterations: Tensor
    max_primal_inf: Tensor
    max_dual_inf: Tensor


def solve_batch(problem: Problem, bounds: Bounds, x1: Tensor, u_init: Tensor,
                theta=None, options: Optional[Options] = None,
                device=None, trace=None) -> Solution:
    """Solve a batch of instances of one problem family.

    All tensor arguments carry a leading batch axis (bounds included —
    instances may have different control limits, as in the randomized concar
    benchmark). `theta` is a pytree whose leaves carry the batch axis, or
    None. Runs on `device`; the default is the GPU, and without one this
    raises (pass `device="cpu"` for the plain path). `trace`: see
    `solve.run`.
    """
    device = resolve_device(device)
    options = tune(options or Options(), x1.shape[0], u_init.dtype, device)
    return solve(problem, bounds, x1, u_init, theta=theta, options=options,
                 device=device, trace=trace)


def batch_stats(sol: Solution) -> BatchStats:
    """Summarize a batched Solution."""
    its = sol.iterations
    return BatchStats(
        num_instances=sol.converged.shape[0],
        num_converged=sol.converged.sum(),
        num_failed=(sol.status != 0).sum(),
        max_iterations=its.max(),
        # the mean of the two middle values, as numpy's and JAX's median
        median_iterations=its.to(torch.float64).quantile(0.5),
        max_primal_inf=sol.primal_inf.max(),
        max_dual_inf=sol.dual_inf.max(),
    )
