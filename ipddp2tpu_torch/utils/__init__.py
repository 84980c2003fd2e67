"""Reporting, checkpoints and profiling (counterpart of `ipddp2tpu/utils`).

Exports what the JAX package's `utils` exports; `profiling` is imported by
name, as there."""

from .printing import exit_message, iteration_logger, solver_banner
from .checkpoint import load_state, save_state

__all__ = ["solver_banner", "iteration_logger", "exit_message",
           "save_state", "load_state"]
