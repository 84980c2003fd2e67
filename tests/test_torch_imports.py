"""The port stands alone: it imports `torch`, never `jax`, nothing of the JAX
package, and no package of finished kernels; and its entry points default to
the GPU and raise without one."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "ipddp2tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {
    "jax", "jaxlib", "flax", "optax", "ipddp2tpu",
    # packages of finished kernels
    "flash_attn", "xformers", "apex", "cupy", "cutlass", "transformer_engine",
    "bitsandbytes", "vllm", "flashinfer", "kornia", "pytorch3d",
}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


def test_port_files_are_found():
    names = {p.name for p in FILES}
    assert {"solve.py", "backward.py", "backward_cuda.py", "convert.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_forbidden_import(path):
    bad = [(name, line) for name, line in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_kernel_source_is_in_the_package():
    from ipddp2tpu_torch.ops import backward_cuda
    assert backward_cuda.SOURCE.exists()
    src = backward_cuda.SOURCE.read_text()
    assert "backward_sweep_f32" in src and "backward_sweep_f64" in src
    for lib in ("cusolver", "cublas", "torch/extension.h"):
        assert lib not in src


def test_default_device_raises_without_a_gpu():
    from ipddp2tpu_torch import Options, solve, solve_batch
    from ipddp2tpu_torch.models import double_integrator as di
    from ipddp2tpu_torch.solve import initialize
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    args = (di.problem(), di.bounds(), di.initial_state()[None],
            di.initial_controls()[None])
    for entry in (solve, solve_batch):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(*args, options=Options(max_iterations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize(args[0], None, *args[1:], Options())
