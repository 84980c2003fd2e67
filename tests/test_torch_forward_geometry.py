"""The forward-metrics kernel's launch geometry (`metrics_geometry`): lanes
per candidate, chunks of candidates, instances and shared memory per block,
computed in Python as the CUDA source lays them out (the library checks the
two against each other on the card), and what it refuses. Pure arithmetic:
no kernel is built and nothing runs on a device."""

import pytest
import torch

from ipddp2tpu_torch.ops.build import SMEM_LIMIT
from ipddp2tpu_torch.ops.forward_cuda import (MetricsGeometry,
                                              metrics_geometry)

CONCAR = dict(nx=4, nu=10, nc=4, theta_dim=12)
DOUBLE_INTEGRATOR = dict(nx=2, nu=3, nc=1, theta_dim=0)
TINY_NC0 = dict(nx=2, nu=3, nc=0, theta_dim=0)


def _geo(dims, K, dtype):
    return metrics_geometry(dims["nx"], dims["nu"], dims["nc"], K, dtype,
                            dims["theta_dim"])


# concar: 248 values a stage buffer (every run 16-byte aligned in double),
# two buffers and 12 values of theta an instance, four instances a block
@pytest.mark.parametrize("K,lanes,chunks", [
    (1, 32, 1), (3, 8, 1), (8, 4, 1), (13, 2, 1), (40, 1, 2)])
@pytest.mark.parametrize("dtype,smem", [(torch.float64, 16256),
                                        (torch.float32, 8128)])
def test_concar_geometry(K, lanes, chunks, dtype, smem):
    assert _geo(CONCAR, K, dtype) == MetricsGeometry(
        lanes=lanes, chunks=chunks, instances_per_block=4, threads=128,
        smem_bytes=smem)


@pytest.mark.parametrize("dims,dtype,smem", [
    (DOUBLE_INTEGRATOR, torch.float64, 3456),
    (DOUBLE_INTEGRATOR, torch.float32, 1792),
    (TINY_NC0, torch.float64, 3200),
    (TINY_NC0, torch.float32, 1792)],
    ids=["di-f64", "di-f32", "nc0-f64", "nc0-f32"])
def test_small_models_geometry(dims, dtype, smem):
    geo = _geo(dims, 8, dtype)
    assert (geo.lanes, geo.chunks, geo.instances_per_block,
            geo.smem_bytes) == (4, 1, 4, smem)


@pytest.mark.parametrize("dims", [CONCAR, DOUBLE_INTEGRATOR, TINY_NC0],
                         ids=["concar", "di", "nc0"])
def test_every_k_covers_its_candidates_in_whole_warps(dims):
    for dtype in (torch.float32, torch.float64):
        for K in range(1, 70):
            geo = _geo(dims, K, dtype)
            per_chunk = 32 // geo.lanes
            assert geo.lanes & (geo.lanes - 1) == 0 and geo.lanes <= 32
            # the largest power of two with K candidates in one warp ...
            assert geo.lanes * min(K, 32) <= 32 < 2 * geo.lanes * K
            # ... and as many passes as K needs, no more
            assert (geo.chunks - 1) * per_chunk < K <= geo.chunks * per_chunk
            assert geo.threads == 32 * geo.instances_per_block
            assert geo.smem_bytes <= SMEM_LIMIT


def test_wide_models_take_fewer_warps_a_block():
    # 2 * (3 nu + nc) * (nx + 2) values dominate: fewer instances a block
    # once four no longer fit the card's 227 KB, a refusal once one does not
    sizes = {}
    for nx in (4, 16, 32, 48, 64, 96):
        try:
            geo = metrics_geometry(nx, 60, 20, 8, torch.float64)
        except ValueError:
            sizes[nx] = 0
        else:
            assert geo.smem_bytes <= SMEM_LIMIT
            sizes[nx] = geo.instances_per_block
    assert sizes == {4: 4, 16: 2, 32: 2, 48: 1, 64: 1, 96: 0}


@pytest.mark.parametrize("args,exc", [
    ((4, 10, 4, 0, torch.float64), ValueError),
    ((4, 10, 4, -3, torch.float32), ValueError),
    ((4, 10, 4, 8, torch.float16), TypeError),
    ((800, 10, 4, 8, torch.float64), ValueError)],
    ids=["K=0", "K<0", "float16", "no-room"])
def test_refusals(args, exc):
    with pytest.raises(exc):
        metrics_geometry(*args)


@pytest.mark.parametrize("has_geo", [True, False],
                         ids=["with-geometry", "without-geometry"])
def test_parent_metrics_takes_this_trees_arguments(has_geo):
    """`chip_smoke.py --parent` launches another checkout's metrics kernels
    through this tree's wrapper: a library with `forward_metrics_geometry`
    gets the geometry, an older one the arguments without it."""
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    calls = []

    def kernel(sfx):
        def fn(*args):
            calls.append((sfx, args))
            return 0
        return fn

    lib = SimpleNamespace(forward_metrics_f32=kernel("f32"),
                          forward_metrics_f64=kernel("f64"))
    if has_geo:
        lib.forward_metrics_geometry = kernel("geometry")
    metrics = chip_smoke.parent_metrics(lib)
    for sfx in ("f32", "f64"):
        assert len(getattr(lib, f"forward_metrics_{sfx}").argtypes) == (
            6 if has_geo else 5)
        assert metrics[sfx]("ptrs", 2048, 100, 8, "geo", "stream") == 0
    sent = ("ptrs", 2048, 100, 8) + ("geo",) * has_geo + ("stream",)
    assert calls == [("f32", sent), ("f64", sent)]
