"""Carrying values across from the JAX package.

The two packages never import each other. What crosses between them crosses
as numpy arrays: these functions turn the JAX package's values (given as
numpy arrays, or as tuples / NamedTuples of them) into the port's types, as
tensors of a stated dtype on a stated device, and back. The parity tests use
them so that both packages compute on the same data.

The JAX package's single-instance values have no batch axis and its `vmap`ped
values carry one in front, which is the port's batch-first layout: pass
`batched=False` to add the leading axis of a single instance.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .backward import Gains
from .derivatives import DerivativeBundle
from .problem import Bounds
from .solve import SolverState

# the instance data of the JAX package's 100-seed campaigns
# (`experiments/run_benchmarks.py` writes one row per seed)
PARAMS_DIR = Path(__file__).resolve().parents[1] / "experiments" / "params"

_INT_FIELDS = ("filter_n", "k", "j", "ls_resets", "num_ls", "status")
_BOOL_FIELDS = ("converged",)


def _tensor(a, dtype, device, batched=True):
    t = torch.as_tensor(np.array(a)).to(dtype=dtype, device=device)
    return t if batched else t[None]


def _fields(cls, value, dtype, device, batched):
    """NamedTuple (or plain tuple in field order) of arrays -> `cls` of
    tensors; None fields stay None."""
    return cls(*(None if a is None else _tensor(a, dtype, device, batched)
                 for a in value))


def bounds_from_numpy(lower, upper, dtype=torch.float64, device="cpu",
                      batched=True) -> Bounds:
    return Bounds(_tensor(lower, dtype, device, batched),
                  _tensor(upper, dtype, device, batched))


def theta_from_numpy(theta, dtype=torch.float64, device="cpu", batched=True,
                     cls=None):
    """A parameter pytree (None, an array, or a tuple / NamedTuple of arrays)
    -> the same structure of tensors; `cls` rebuilds a NamedTuple of the
    port's own (e.g. `models.concar.Theta`)."""
    if theta is None:
        return None
    if isinstance(theta, tuple):
        leaves = [_tensor(a, dtype, device, batched) for a in theta]
        return cls(*leaves) if cls is not None else tuple(leaves)
    return _tensor(theta, dtype, device, batched)


def deriv_from_numpy(deriv, dtype=torch.float64, device="cpu",
                     batched=True) -> DerivativeBundle:
    """Every `DerivativeBundle` field, in the JAX package's field order."""
    return _fields(DerivativeBundle, deriv, dtype, device, batched)


def gains_from_numpy(gains, dtype=torch.float64, device="cpu",
                     batched=True) -> Gains:
    return _fields(Gains, gains, dtype, device, batched)


def state_from_numpy(state, dtype=torch.float64, device="cpu",
                     batched=True) -> SolverState:
    """Every `SolverState` field (the JAX package's `solve.SolverState`, same
    field names): floats in `dtype`, counters int32, flags bool."""
    out = {}
    for name in SolverState._fields:
        a = getattr(state, name)
        if name in _INT_FIELDS:
            out[name] = _tensor(a, torch.int32, device, batched)
        elif name in _BOOL_FIELDS:
            out[name] = _tensor(a, torch.bool, device, batched)
        else:
            out[name] = _tensor(a, dtype, device, batched)
    return SolverState(**out)


def state_to_numpy(state: SolverState, batched=True) -> dict:
    """The inverse of `state_from_numpy`: a dict of numpy arrays by field
    name (`batched=False` drops the leading axis of a single instance)."""
    out = {}
    for name, t in zip(SolverState._fields, state):
        a = t.detach().cpu().numpy()
        out[name] = a if batched else a[0]
    return out


def params_rows(name: str, rows=None, directory=None) -> np.ndarray:
    """Rows of `experiments/params/<name>` (whitespace-separated floats, one
    instance a line, written with `repr(float)` so that they read back bit
    for bit) as a float64 array `[n, columns]`; `rows` selects lines (0 =
    seed 1). A model's `from_params` turns them into
    (theta, bounds, x1, u0)."""
    path = Path(directory or PARAMS_DIR) / name
    data = np.array([[float(v) for v in line.split()]
                     for line in path.read_text().splitlines()
                     if line.strip()], dtype=np.float64)
    return data if rows is None else data[np.asarray(rows)]
