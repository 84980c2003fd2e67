"""Measured-crossover dispatch: pick the tuned execution mode automatically.

Counterpart of `ipddp2tpu/autotune.py`. The mechanism is the same: a table
of (dtype, batch range) -> mode overrides, filled into only those knobs of
`Options` still at their defaults (an explicit setting always wins), and
only when `options.auto_tune` is on.

The JAX package's table holds TPU measurements (the parallel backward pass
winning at small f32 batches, speculative K=4 or 8 winning at large ones),
and none of them carries over to the H100. So the table here starts empty:
a row is added only with a crossover measured on the card, and until then
`tune` returns its input. It acts only on a CUDA device; the CPU is the
test and verification backend and keeps the reference path's semantics.
"""

from __future__ import annotations

import dataclasses

import torch

from .options import Options

# (dtype name, min_batch_inclusive, max_batch_exclusive or None) ->
# overrides. No crossover has been measured on the H100 yet.
TUNE_TABLE = ()


def tune(options: Options, batch_size: int, dtype, device) -> Options:
    """Return `options` with mode knobs tuned for (batch, dtype, device).

    Only knobs still at their `Options` defaults are touched, and only on a
    CUDA device with `options.auto_tune` enabled."""
    if not options.auto_tune or torch.device(device).type != "cuda":
        return options
    name = str(dtype).removeprefix("torch.")
    row = next((o for (dt, lo, hi, o) in TUNE_TABLE
                if dt == name and lo <= batch_size
                and (hi is None or batch_size < hi)), None)
    if row is None:
        return options
    defaults = {f.name: f.default for f in dataclasses.fields(Options)}
    updates = {k: v for k, v in row.items()
               if getattr(options, k) == defaults[k]}
    return dataclasses.replace(options, **updates) if updates else options
