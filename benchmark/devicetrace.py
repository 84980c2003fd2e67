"""The solver loop's iterations as the benchmark sees them, and the device
trace of a slice of them.

`IterationLog` is the list that `solve.run(trace=...)` appends to once per
lockstep iteration, with the lanes that stepped in it (no host
synchronization: the tensors stay on the device). It keeps those masks, a
host timestamp per iteration, and, when asked, starts `torch.profiler` at
one iteration and stops it at another, synchronizing the device at both
ends so that the slice holds exactly those iterations' work.

`summarize` reduces the profiler's events to what the per-layer metrics
read: the device's kernels, copies and fills, the union of their intervals
(busy time), the slice's length, and the breakdown of device time by kernel
and of idle time by what the host was running.
"""

import bisect
import time

import torch

class IterationLog(list):
    """`trace=` list of `solve.run`: one entry (the stepped lanes [B]) per
    lockstep iteration. `slices` maps a kind to (a, b): iterations a+1 ..
    b run under the profiler (a >= 1). "warmup" is profiled and thrown
    away (a process's first profiling session has been seen to return
    kernels of zero length at wrong times); "device" records the device's
    operations; "host" records the host's operators too, which slows the
    host several times over, so it serves only to name what the host does
    in the device's idle gaps."""

    def __init__(self, slices=None):
        super().__init__()
        self.t0 = time.perf_counter()   # reset by the caller at its start
        self.times = []
        self.slices = dict(slices or {})
        self.done = {}              # kind -> {prof, iterations}
        self._open = None

    def append(self, item):
        t = time.perf_counter()
        super().append(item[0])
        self.times.append(t)
        if self._open is not None and len(self) == self._open["b"]:
            self.close()
        for kind, (a, b) in self.slices.items():
            if len(self) == a and self._open is None:
                self._start(kind, a, b)

    def _start(self, kind, a, b):
        cuda = torch.cuda.is_available()
        acts = ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        if kind == "host" or not cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if cuda:
            torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._open = {"prof": prof, "kind": kind, "a": a, "b": b}

    def close(self):
        """Stop the profiler if it still runs (at the slice's end, or a
        batch that ended inside it)."""
        o, self._open = self._open, None
        if o is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        o["prof"].stop()
        self.done[o["kind"]] = {"prof": o["prof"],
                                "iterations": len(self) - o["a"]}

    def before_profiling(self):
        """(host seconds, lockstep iterations) of the batch up to the start
        of its first profiled slice, or of the whole batch without one."""
        starts = [a for a, _ in self.slices.values() if a <= len(self)]
        n = min(starts) if starts else len(self)
        return (self.times[n - 1] - self.t0 if n else 0.0), n

    def stepped_total(self):
        """Lane-iterations that stepped, over the whole batch."""
        if not self:
            return 0
        return int(torch.stack(list(self)).sum())


def profiled_events(prof):
    """The profiler's events as (kind, name, start s, end s): kind "kernel",
    "copy" (a copy or a fill on the device) or "host" (an operator on the
    host; CUDA runtime calls are left out). Read from the profiler's own
    event list: its Chrome export has been seen to carry zero times for
    every device operation of all but a process's last profiling
    session."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            copy = name.startswith(("Memcpy", "Memset"))
            kind = "copy" if copy else "kernel"
        elif name.startswith("cu"):
            continue
        else:
            kind = "host"
        out.append((kind, name, start, end))
    return out


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start, end):
    """(gap start, gap end) of [start, end] not covered by intervals."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return [g for g in gaps if g[1] > g[0]]


def _top_level(ops):
    """The host operators not nested in another, sorted by start."""
    out, end = [], float("-inf")
    for s, e, name in sorted(ops):
        if s >= end:
            out.append((s, e, name))
            end = e
    return out


def host_label(top, t):
    """The outermost host operator running at time t, if any."""
    i = bisect.bisect_right([s for s, _, _ in top], t) - 1
    if i >= 0 and top[i][1] >= t:
        return top[i][2]
    return "(host, between operators)"


def summarize(events, iterations, top=10):
    """What the per-layer metrics read from one profiled slice
    (`profiled_events`). The traced window runs from the start of the first
    device operation to the end of the last: the slice begins and ends
    with the device synchronized, so that is the slice less the launch of
    its first operation. Everything is in seconds."""
    device = [(s, e, name, kind) for kind, name, s, e in events
              if kind != "host"]
    ops = [(s, e, name) for kind, name, s, e in events if kind == "host"]
    spans = [(s, e) for s, e, _, _ in device]
    t0 = min((s for s, _ in spans), default=0.0)
    t1 = max((e for _, e in spans), default=0.0)
    by_kernel = {}
    for s, e, name, _ in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
    tops = _top_level(ops)
    by_host = {}
    for s, e in idle_gaps(spans, t0, t1):
        label = host_label(tops, 0.5 * (s + e))
        by_host[label] = by_host.get(label, 0.0) + (e - s)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv:
                                                -kv[1])[:top]]
    return {"iterations": iterations, "window_s": t1 - t0,
            "busy_s": union_length(spans),
            "kernels": [(name, e - s) for s, e, name, kind in device
                        if kind == "kernel"],
            "device_ops": rank(by_kernel), "idle_gaps": rank(by_host)}


def kernel_time(summary, *names):
    """(launches, device seconds) of the kernels whose name holds any of
    `names`."""
    hits = [d for n, d in summary["kernels"] if any(k in n for k in names)]
    return len(hits), sum(hits)
