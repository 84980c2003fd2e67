"""Checkpoint / resume.

Counterpart of `ipddp2tpu/utils/checkpoint.py`, in its `.npz` layout: one
array per `SolverState` field under the field's name (the two packages'
states have the same fields). So a state saved by either package resumes in
the port: `run` continues from any loaded state, which doubles as the
warm-start API. The JAX package's single-instance state has no batch axis
and its vmapped state has one in front; `load_state` gives the port's
batch-first state either way (B = 1 for the former).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..solve import SolverState, resolve_device


def save_state(path: str, state: SolverState) -> None:
    """Every field as a numpy array (floats in the state's type, counters
    int32, `converged` bool): the round trip through `load_state` is exact."""
    np.savez(path, **convert.state_to_numpy(state))


def load_state(path: str, device=None) -> SolverState:
    """The state saved at `path`, on `device` (default: the GPU, which
    raises without one; pass `device="cpu"` for the CPU), floats in the
    type they were saved in."""
    device = resolve_device(device)
    with np.load(path) as data:
        fields = {f: data[f] for f in SolverState._fields}
    dtype = torch.from_numpy(fields["x"][:0]).dtype
    return convert.state_from_numpy(SolverState(**fields), dtype=dtype,
                                    device=device,
                                    batched=fields["x"].ndim == 3)
