"""Console reporting (the reference's L5 layer, src/print.jl:1-46).

Counterpart of `ipddp2tpu/utils/printing.py`, with the same banner layout,
the same columns (wall and per-iteration ms included) and the same exit
messages. The JAX package prints its rows from inside the jitted loop through
`jax.debug.callback`; the port's loop runs on the host (`solve.run`), so the
rows are printed from there when `options.verbose`, rate-limited by
`print_frequency` as in the reference (src/options.jl:7, src/print.jl:13-29).
Each row's values ride on the host read that `run` makes once per iteration
anyway (whether any lane is still active), so printing adds no host
synchronization, and nothing is read for it when not verbose. The wall and
per-iteration columns are stamped when that read returns, that is when the
device has finished the iteration.

Rows are for one instance, as in the JAX package, where the facade and
`solve` print a single problem. A batch (B > 1) prints the rows of its
first instance, lane 0, for as long as lane 0 iterates; the other lanes are
not reported.
"""

from __future__ import annotations

import math
import time

import torch

from ..problem import STATUS_MESSAGES

_BANNER = r"""
 ipddp2tpu_torch — interior-point DDP (IPDDP2, arXiv:2504.08278), PyTorch / CUDA
 stagewise equality constraints + control bounds | barrier + filter line search
"""

_HEADER = (" iter   objective     pr_inf    du_inf    cs_inf   lg(mu) "
           " lg(reg)   step    #ls  wall(ms)  iter(ms)")

# host-side timing state for the wall / per-iteration columns; reset by
# solver_banner() at the start of each verbose solve
_CLOCK = {"start": None, "last": None, "last_k": 0}

# the state fields of a row, in the order of its columns
ROW_FIELDS = ("k", "objective", "primal_inf", "dual_inf", "cs_inf", "mu",
              "reg_last", "step_size", "num_ls")


def solver_banner():
    print(_BANNER)
    print(_HEADER)
    _CLOCK["start"] = _CLOCK["last"] = time.perf_counter()
    _CLOCK["last_k"] = 0


def _row(k, objective, pr, du, cs, mu, reg, step, num_ls):
    now = time.perf_counter()
    if _CLOCK["start"] is None:          # logger used without the banner
        _CLOCK["start"] = _CLOCK["last"] = now
        _CLOCK["last_k"] = int(k)
    wall_ms = (now - _CLOCK["start"]) * 1e3
    dk = max(1, int(k) - _CLOCK["last_k"])
    iter_ms = (now - _CLOCK["last"]) * 1e3 / dk
    _CLOCK["last"], _CLOCK["last_k"] = now, int(k)

    lg = lambda v: math.log10(v) if v > 0 else float("-inf")
    print(f" {int(k):4d}  {float(objective): .4e}  {float(pr):.2e}  "
          f"{float(du):.2e}  {float(cs):.2e}  {lg(float(mu)):6.2f}  "
          f"{lg(float(reg)):6.2f}  {float(step):.1e}  {int(num_ls):3d}  "
          f"{wall_ms:8.1f}  {iter_ms:8.1f}")


def row_values(state, stepped) -> torch.Tensor:
    """Lane 0's row values as one float64 tensor on the state's device, the
    flag `stepped` (lane 0 ran the last iteration) in front: what `run`
    reads beside its own per-iteration flag."""
    vals = [stepped[0]] + [getattr(state, f)[0] for f in ROW_FIELDS]
    return torch.stack([v.to(torch.float64) for v in vals])


def iteration_logger(values, options):
    """Print one table row from the host values of `row_values`, when lane 0
    ran the iteration and its counter is a multiple of `print_frequency`
    (the JAX package's rule, applied to the state after the iteration)."""
    stepped, k, *rest = values
    if stepped and int(k) % options.print_frequency == 0:
        _row(k, *rest)


def exit_message(status: int, converged: bool) -> str:
    """(reference: src/print.jl:31-46)"""
    if converged:
        return STATUS_MESSAGES[0]
    return STATUS_MESSAGES.get(status, f"Terminated with status {status}")
