"""The roofline formulas against the counts the repository's kernel checks
recorded (`chip_smoke.py`, PERF.md's table of kernels)."""

import pytest

import harness
import roofline


def test_cartpole_ldlt_sweep_counts():
    """chip_smoke.py's recorded counts for the m = 35 LDL^T sweep, f64,
    B = 100: 171,059,400 bytes and 870,250,000 operations."""
    assert roofline.sweep_bytes(100, 100, 4, 21, 14, "float64") == 171059400
    assert 100 * roofline.sweep_flops(100, 4, 21, 14, refine=1) == 870250000


@pytest.mark.parametrize("name, ms", [("K2", 0.3405), ("K3", 0.1215),
                                      ("K4", 0.1419)])
def test_main_path_bounds(name, ms):
    """The bounds of PERF.md's table at B = 2048, T = 100, K = 8, concar's
    dimensions, f64."""
    _, cfg, _ = harness.cell(harness.benchmark(),
                             "concar_quad.b4096.hybrid")
    got = {"K2": roofline.sweep_bound_s(cfg, 2048),
           "K3": roofline.metrics_bound_s(cfg, 2048, 8),
           "K4": roofline.trial_bound_s(cfg, 2048)}[name]
    assert got * 1e3 == pytest.approx(ms, abs=5e-5)


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 0.0, "float64") == (1.0, "bytes")
    assert roofline.bound_s(0, 67e12, "float32") == (1.0, "operations")
