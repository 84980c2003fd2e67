"""The port's mode table (`ipddp2tpu_torch/autotune.py`): the mechanism of the
JAX package's `tune` with an empty table (every JAX row is a TPU
measurement), and f32 products kept in f32 on a GPU."""

import torch

import ipddp2tpu_torch as P
from ipddp2tpu_torch import autotune
from ipddp2tpu_torch.autotune import TUNE_TABLE, tune
from ipddp2tpu_torch.solve import resolve_device

GPU = torch.device("cuda")      # naming a device needs no GPU


def test_the_table_is_empty():
    assert TUNE_TABLE == ()
    o = P.Options()
    for dtype in (torch.float32, torch.float64):
        for batch in (1, 64, 2048):
            assert tune(o, batch, dtype, GPU) is o


def test_a_row_fills_only_default_knobs(monkeypatch):
    """A row patched in acts on a GPU: it fills the knobs still at their
    defaults, an explicit setting wins, and rows of another dtype or batch
    range do not apply."""
    monkeypatch.setattr(autotune, "TUNE_TABLE", (
        ("float64", 64, None, {"ls_speculative": 8,
                               "ls_spec_continue": True}),
        ("float32", 1, 32, {"ls_speculative": 4}),
    ))
    t = tune(P.Options(), 256, torch.float64, GPU)
    assert (t.ls_speculative, t.ls_spec_continue) == (8, True)
    t = tune(P.Options(ls_speculative=16), 256, torch.float64, "cuda")
    assert (t.ls_speculative, t.ls_spec_continue) == (16, True)
    assert tune(P.Options(), 8, torch.float32, GPU).ls_speculative == 4
    for batch, dtype in ((32, torch.float64), (32, torch.float32)):
        o = P.Options()
        assert tune(o, batch, dtype, GPU) is o


def test_cpu_and_opt_out_are_no_ops(monkeypatch):
    monkeypatch.setattr(autotune, "TUNE_TABLE", (
        ("float64", 1, None, {"ls_speculative": 8}),))
    o = P.Options()
    assert tune(o, 8, torch.float64, "cpu") is o
    assert tune(o, 8, torch.float64, torch.device("cpu")) is o
    o2 = P.Options(auto_tune=False)
    assert tune(o2, 8, torch.float64, GPU) is o2


def test_a_cuda_device_keeps_float32_products_in_float32(monkeypatch):
    """Every entry point resolves its device through `resolve_device`; on a
    GPU that turns TF32 off (reduced-precision products stall the f32
    phase). Run here with the GPU's presence faked: no tensor is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    precision = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert resolve_device(None) == GPU
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(precision)
