"""CUDA-graph replay of fixed-shape tensor functions.

The solver runs eagerly, and its long chains of small operations (a T-step
rollout is thousands of launches on `[B, ...]` tensors a few kilobytes wide)
cost the host far more than the device. Where such a chain has no host
synchronization and fixed shapes, it is captured once into a CUDA graph and
replayed: the role `jit` plays for the same loops in the JAX package.

`Graphed(fn)` wraps a function of tensors (positional, any of them possibly
None) that returns a tuple of tensors. CPU tensors call `fn` directly. CUDA
tensors are copied into static input buffers, the graph is replayed, and
copies of the static outputs are returned; one graph is kept per signature
(shapes, dtypes, device). Set `ENABLED = False` to run everything eagerly.
"""

from __future__ import annotations

import torch

ENABLED = True


class Graphed:
    def __init__(self, fn, warmup: int = 2):
        self.fn = fn
        self.warmup = warmup
        self._graphs = {}

    @staticmethod
    def _signature(args):
        return tuple(None if a is None
                     else (tuple(a.shape), a.dtype, a.device) for a in args)

    def _capture(self, args):
        static_in = [None if a is None else a.detach().clone() for a in args]
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):      # lazy initializations happen here
            for _ in range(self.warmup):
                self.fn(*static_in)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self.fn(*static_in)
        return graph, static_in, static_out

    def __call__(self, *args):
        first = next(a for a in args if a is not None)
        if not (ENABLED and first.is_cuda):
            return self.fn(*args)
        key = self._signature(args)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(args)
        graph, static_in, static_out = entry
        for dst, src in zip(static_in, args):
            if dst is not None:
                dst.copy_(src)
        graph.replay()
        return tuple(o.clone() for o in static_out)
