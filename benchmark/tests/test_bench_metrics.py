"""The metric arithmetic on synthetic records: the window over whole
batches, the union of device intervals, occupancy from the solver's trace
list, and the readers over a synthetic trace."""

import time
from types import SimpleNamespace

import pytest
import torch

import devicetrace
import harness
from ipddp2tpu_torch.solve import Solution

BENCH = harness.benchmark()
CELL = "concar_quad.b4096.hybrid"


def read(name, run):
    return harness.load("metrics", name).read(run)


def fake_solution(B, converged=True):
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.float64)
    i = torch.full((B,), 7, dtype=torch.int32)
    return Solution(x=z(3, 1), u=z(2, 1), phi=z(2, 0), zl=z(2, 1),
                    zu=z(2, 1), lam=z(3, 1), objective=z(), iterations=i,
                    status=torch.zeros(B, dtype=torch.int32),
                    converged=torch.full((B,), converged), primal_inf=z(),
                    dual_inf=z(), cs_inf=z(), mu=z())


def test_window_holds_whole_batches():
    """A batch is submitted only while the window so far plus the longest
    batch so far fits: 0.2 s batches in a 0.5 s window make two. Each
    batch holds the cell's instances in another lane order, the same for a
    seed in every run."""
    def solve(*args, trace=None, **kw):
        time.sleep(0.2)
        trace.append((torch.ones(4, dtype=torch.bool), None, None))
        return fake_solution(4)
    ctx = harness.context(CELL, 3, 0.5, False, "cpu", solve=solve,
                          traffic_changes=dict(batch=4))
    ctx.driver.setup(ctx)
    records = ctx.driver.window(ctx)
    assert len(records) == 2 and len(ctx.batches_in) == 2
    assert all(0.2 <= r["seconds"] < 0.3 for r in records)
    assert ctx.window_s >= sum(r["seconds"] for r in records)
    heading = [b["x1"][:, 2] for b in ctx.batches_in]
    assert torch.equal(heading[0].sort().values, heading[1].sort().values)
    assert not torch.equal(heading[0], heading[1])
    again = harness.context(CELL, 3, 0.01, False, "cpu", solve=solve,
                            traffic_changes=dict(batch=4))
    again.driver.setup(again)
    assert len(again.driver.window(again)) == 1   # at least one batch
    assert torch.equal(again.batches_in[0]["x1"], ctx.batches_in[0]["x1"])


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert devicetrace.union_length(iv) == pytest.approx(3.0)
    assert devicetrace.idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                                    (4.0, 5.0)]
    assert devicetrace.union_length([]) == 0.0


def test_iterations_before_profiling():
    log = devicetrace.IterationLog({"device": (3, 5)})
    log.t0 = 0.0
    log.times = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    list.extend(log, [None] * 6)
    assert log.before_profiling() == (3.0, 3)
    plain = devicetrace.IterationLog()
    plain.t0, plain.times = 0.0, [0.5, 1.5]
    list.extend(plain, [None] * 2)
    assert plain.before_profiling() == (1.5, 2)


def test_occupancy_from_the_trace_list():
    log = devicetrace.IterationLog()
    for stepped in ([1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 1]):
        log.append((torch.tensor(stepped, dtype=torch.bool), None, None))
    assert len(log) == 3 and log.stepped_total() == 7
    run = SimpleNamespace(batches=[{"lanes": 4, "lockstep_iterations": 3,
                                    "stepped": 7}])
    assert read("lane_occupancy_pct", run) == pytest.approx(100 * 7 / 12)


def test_rate_lockstep_and_means():
    batches = [{"lanes": 100, "lockstep_iterations": 50, "solved": 98,
                "iterations_sum": 3000, "unprofiled_iterations": 30,
                "unprofiled_s": 3.0},
               {"lanes": 100, "lockstep_iterations": 40, "solved": 100,
                "iterations_sum": 2000, "unprofiled_iterations": 40,
                "unprofiled_s": 4.0}]
    run = SimpleNamespace(batches=batches, window_s=10.0, setup_s=4.5,
                          solved=198, attempted=200)
    assert read("solved_per_s", run) == pytest.approx(19.8)
    assert read("setup_s", run) == 4.5
    assert read("iterations_mean", run) == pytest.approx(25.0)
    # 7 s over the 70 iterations before any profiling
    assert read("lockstep_iter_ms", run) == pytest.approx(100.0)


def synthetic_trace():
    """Events of a 2-iteration slice (microseconds here, seconds in the
    events): two sweeps, a metrics and a trial kernel, a copy, host
    operators around them."""
    k = lambda name, ts, dur, kind="kernel": (kind, name, ts * 1e-6,
                                              (ts + dur) * 1e-6)
    return [k("aten::mm", 0, 150, "host"), k("aten::add", 400, 50, "host"),
            k("void backward_sweep_kernel<double>(SweepArgs)", 100, 200),
            k("void backward_sweep_kernel<double>(SweepArgs)", 500, 200),
            k("void forward_metrics_kernel<double, 4>(FwdArgs)", 700, 100),
            k("void forward_trial_kernel<double>(FwdArgs)", 800, 100),
            k("Memcpy HtoD", 850, 100, "copy"),
            k("aten::sum", 950, 100, "host")]


def test_trace_readers():
    tr = devicetrace.summarize(synthetic_trace(), iterations=2)
    assert tr["window_s"] == pytest.approx(850e-6)   # 100 .. 950
    assert tr["busy_s"] == pytest.approx(650e-6)     # 100-300, 500-950
    assert len(tr["kernels"]) == 4
    assert tr["device_ops"][0][0].startswith("void backward_sweep")
    assert tr["device_ops"][0][1] == pytest.approx(400e-6)
    # the one gap, 300-500, has its midpoint in aten::add
    assert tr["idle_gaps"] == [["aten::add", pytest.approx(200e-6)]]
    assert devicetrace.host_label([(0.0, 1.0, "a")], 2.0) == \
        "(host, between operators)"
    _, cfg, traffic = harness.cell(BENCH, CELL)
    run = SimpleNamespace(trace=tr, cfg=cfg, traffic=traffic,
                          options=SimpleNamespace(ls_speculative=8),
                          batches=[{"lanes": 4096}])
    assert read("launches_per_iter", run) == 2.0
    assert read("sweep_ms_per_iter", run) == pytest.approx(0.2)
    assert read("device_idle_pct", run) == pytest.approx(100 * 200 / 850)
    import roofline
    sweep = 100 * 2 * roofline.sweep_bound_s(cfg, 4096) / 400e-6
    assert read("sweep_roofline", run) == pytest.approx(sweep)
    fwd = 100 * (roofline.metrics_bound_s(cfg, 4096, 8)
                 + roofline.trial_bound_s(cfg, 4096)) / 200e-6
    assert read("forward_roofline", run) == pytest.approx(fwd)


def test_readers_find_nothing_without_a_trace():
    run = SimpleNamespace(trace=None)
    for name in ("launches_per_iter", "sweep_ms_per_iter", "sweep_roofline",
                 "forward_roofline", "device_idle_pct"):
        assert read(name, run) is None
    tr = devicetrace.summarize([], iterations=3)
    _, cfg, traffic = harness.cell(BENCH, CELL)
    run = SimpleNamespace(trace=tr, cfg=cfg, traffic=traffic,
                          options=SimpleNamespace(ls_speculative=8),
                          batches=[{"lanes": 8}])
    assert read("sweep_roofline", run) is None
    assert read("forward_roofline", run) is None
