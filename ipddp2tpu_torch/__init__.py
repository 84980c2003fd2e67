"""ipddp2tpu_torch — the PyTorch/CUDA port of `ipddp2tpu` for NVIDIA Hopper.

The JAX package `ipddp2tpu` is the reference; this package does the same in
PyTorch, batch-first (every tensor carries a leading instance axis `B`), with
the TPU kernels rewritten by hand as CUDA kernels. It imports `torch`, never
`jax`, and nothing of the JAX package.

So far the port covers the batched solve with the backtracking, the
speculative and the hybrid line search, and the chunked and mixed-precision
solves on top of it:

    Problem, Bounds, Options, solve, solve_batch      — functional core
    solve_chunked, run_chunked                        — chunked loop: limits
                                                        per lane, stall
                                                        freeze, compaction
    solve_mixed, solve_mixed_chunked, promote_state   — f32 bulk phase, f64
                                                        endgame, restart
                                                        rescue
    autotune.tune                                     — mode table (empty)
    models.concar, models.double_integrator           — benchmark problems
    ops.backward_cuda.backward_sweep_cuda             — the backward-sweep
                                                        kernel (f32 and f64)
    ops.forward_cuda.forward_metrics_cuda,
    ops.forward_cuda.forward_trial_cuda               — the line search's
                                                        rollout kernels
    ops.probe_chain                                   — chain probes of the
                                                        card's arithmetic

Entry points take an explicit `device`, default `"cuda"`, and raise when no
GPU is present; pass `device="cpu"` to run the plain PyTorch path.
"""

from .options import Options
from .problem import Bounds, Problem, uniform_bounds, unbounded
from .solve import Solution, SolverState, solve
from .batch import solve_batch
from .chunked import run_chunked, solve_chunked
from .mixed import promote_state, solve_mixed, solve_mixed_chunked

__version__ = "0.1.0"

__all__ = [
    "Options", "Problem", "Bounds", "uniform_bounds", "unbounded",
    "Solution", "SolverState", "solve", "solve_batch",
    "solve_chunked", "run_chunked",
    "solve_mixed", "solve_mixed_chunked", "promote_state",
]
