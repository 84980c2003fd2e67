"""The benchmark's own tests (`python -m pytest benchmark/tests -p
no:cacheprovider`). Tests marked `gpu` need a CUDA device and skip without
one; on the H100 they run with `-m gpu`."""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark runs on the H100)")
    return torch.device("cuda:0")
