"""ipddp2tpu_torch — the PyTorch/CUDA port of `ipddp2tpu` for NVIDIA Hopper.

The JAX package `ipddp2tpu` is the reference; this package does the same in
PyTorch, batch-first (every tensor carries a leading instance axis `B`), with
the TPU kernels rewritten by hand as CUDA kernels. It imports `torch`, never
`jax`, and nothing of the JAX package.

So far the port covers the batched solve with the backtracking line search:

    Problem, Bounds, Options, solve, solve_batch      — functional core
    models.concar, models.double_integrator           — benchmark problems
    ops.backward_cuda.backward_sweep_cuda             — the backward-sweep
                                                        kernel (f32 and f64)

Entry points take an explicit `device`, default `"cuda"`, and raise when no
GPU is present; pass `device="cpu"` to run the plain PyTorch path.
"""

from .options import Options
from .problem import Bounds, Problem, uniform_bounds, unbounded
from .solve import Solution, SolverState, solve
from .batch import solve_batch

__version__ = "0.1.0"

__all__ = [
    "Options", "Problem", "Bounds", "uniform_bounds", "unbounded",
    "Solution", "SolverState", "solve", "solve_batch",
]
