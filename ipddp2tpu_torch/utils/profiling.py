"""Profiling hooks (counterpart of `ipddp2tpu/utils/profiling.py`).

The reference hand-rolls wall / solver / function-evaluation timers
(reference: src/solve.jl:19,41-43,86-87). The JAX package's equivalents are
`jax.profiler` traces and host-side block timers; the port's are
`torch.profiler` traces (host operators and, on a GPU, the CUDA kernels with
their device times, the hand-written ones included) and the same timers.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device trace of the enclosed block and write it
    under `log_dir` as a Chrome trace (`trace.json`, viewable in Perfetto or
    chrome://tracing); the profile itself is yielded for reading it in
    Python (`key_averages()`):

        with profiling.trace("/tmp/ipddp2-trace") as prof:
            sol = solve(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class BlockTimer:
    """Host-side timer that waits for the device at exit: the CUDA work
    queued in the block is asynchronous, so the caller passes the tensors it
    needs finished, and their devices are synchronized before the clock
    stops."""

    def __init__(self):
        self.seconds = 0.0

    @contextlib.contextmanager
    def __call__(self, *tensors_to_block_on):
        t0 = time.time()
        yield
        for device in {t.device for t in tensors_to_block_on}:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.seconds += time.time() - t0
