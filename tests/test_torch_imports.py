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
            "forward_cuda.py", "probe_chain.py", "build.py", "chunked.py",
            "autotune.py", "mixed.py", "chip_smoke.py", "bk.py", "ldlt.py",
            "concar_quad.py", "quadrotor.py", "cartpole_swingup.py",
            "acrobot.py", "cartpole.py", "pushing.py", "solver.py",
            "serve.py", "printing.py", "checkpoint.py",
            "profiling.py"} <= names


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


CSRC = ROOT / "ipddp2tpu_torch" / "ops" / "csrc"
CUDA_SOURCES = sorted(CSRC.rglob("*.cu")) + sorted(CSRC.rglob("*.cuh"))


def test_every_kernel_has_its_source():
    from ipddp2tpu_torch.ops import forward_cuda, probe_chain
    fwd = forward_cuda.SOURCE.read_text()
    for name in forward_cuda.launch_counts:
        assert name in fwd, name
    probe = probe_chain.SOURCE.read_text()
    for name in probe_chain.launch_counts:
        assert name in probe, name
    for model in ("concar", "double_integrator", "tiny_nc0", "concar_quad",
                  "quadrotor", "cartpole_swingup", "acrobot", "cartpole",
                  "pushing"):
        assert (forward_cuda.MODELS / f"{model}.cuh").exists()
    # the Bunch-Kaufman instantiation of the sweep is a define of its source
    from ipddp2tpu_torch.ops import backward_cuda
    assert "SWEEP_BK" in backward_cuda.SOURCE.read_text()
    assert (CSRC / "backward_sweep_bk.cuh").exists()
    # the LDL^T sweep for 32 < m <= 64 is chosen by the size in that source
    assert "backward_sweep_wide.cuh" in backward_cuda.SOURCE.read_text()
    assert (CSRC / "backward_sweep_wide.cuh").exists()
    assert {"backward_sweep_bk_f32", "backward_sweep_bk_f64"} \
        <= set(backward_cuda.launch_counts)


@pytest.mark.parametrize("path", CUDA_SOURCES,
                         ids=[str(p.relative_to(CSRC)) for p in CUDA_SOURCES])
def test_cuda_source_calls_no_library(path):
    src = path.read_text()
    for lib in ("cusolver", "cublas", "cudnn", "torch/extension.h",
                "use_fast_math"):
        assert lib not in src, (path.name, lib)


def test_importing_the_kernel_modules_builds_nothing():
    """The wrappers' modules import on a machine without `nvcc`; no build
    directory appears and no library is loaded until a kernel is asked for."""
    from ipddp2tpu_torch.ops import build, forward_cuda, probe_chain
    assert not forward_cuda._libs and not probe_chain._libs
    if not torch.cuda.is_available():
        assert not build.BUILD_DIR.exists()


def test_models_name_their_device_functions():
    import importlib
    from ipddp2tpu_torch import models
    from ipddp2tpu_torch.ops import forward_cuda
    for name in models.__all__:
        prob = importlib.import_module(f"ipddp2tpu_torch.models.{name}") \
            .problem()
        header = forward_cuda._model_header(prob)
        text = header.read_text()
        if name == "concar_quad":       # concar's functions, another cost
            assert '#include "concar.cuh"' in text
            text = (forward_cuda.MODELS / "concar.cuh").read_text()
        assert f"NX_ = {prob.nx}, NU_ = {prob.nu}, NC_ = {prob.nc}" in text


def test_default_device_raises_without_a_gpu():
    from ipddp2tpu_torch import (Options, solve, solve_batch, solve_chunked,
                                 solve_mixed, solve_mixed_chunked)
    from ipddp2tpu_torch.models import double_integrator as di
    from ipddp2tpu_torch.solve import initialize
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    args = (di.problem(), di.bounds(), di.initial_state()[None],
            di.initial_controls()[None])
    for entry in (solve, solve_batch, solve_chunked, solve_mixed,
                  solve_mixed_chunked):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(*args, options=Options(max_iterations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize(args[0], None, *args[1:], Options())
    from ipddp2tpu_torch import (Bound, Constraint, Dynamics, Objective,
                                 Solver, solve_pool)
    from ipddp2tpu_torch.serve import solve_pool_resident
    from ipddp2tpu_torch.utils import load_state
    for entry in (solve_pool, solve_pool_resident):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(*args, options=Options(max_iterations=1), slots=1)
    f = lambda x, u: x + u
    solver = Solver([Dynamics(f, 1, 1)] * 2,
                    [Objective(lambda x, u: (u * u).sum(), 1, 1)] * 2
                    + [Objective(lambda x, u: (x * x).sum(), 1, 0)],
                    [Constraint(1, 1)] * 2 + [Constraint(1, 0)],
                    [Bound(1)] * 2 + [Bound(0)])
    with pytest.raises(RuntimeError, match="CUDA"):
        solver.solve(torch.ones(1), torch.zeros(2, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_state("no_such_file.npz")
