"""A run loads neither JAX nor the JAX package, compared by whole top-level
module names, and the reference side imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import harness

BENCH_DIR = Path(harness.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "ipddp2tpu"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("ipddp2tpu_torch", "ipddp2tpu_torch.solve", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ipddp2tpu.solve", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["ipddp2tpu", "jaxlib"]


def imports_of(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_sources_import_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not imports_of(path) & FORBIDDEN, path


def test_reference_side_imports_nothing_of_the_program():
    files = [*(BENCH_DIR / "reference").glob("*.py"),
             *(BENCH_DIR / "instances").glob("*.py"),
             BENCH_DIR / "judge.py", BENCH_DIR / "roofline.py"]
    for path in files:
        assert imports_of(path) <= {"math", "torch"}, path


def test_a_run_loads_no_jax():
    """Set-up and a window of one short batch on the CPU, in a fresh
    process: no JAX module is loaded."""
    code = f"""
import sys, time, dataclasses
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(BENCH_DIR.parent)!r}]
import harness
ctx = harness.context("concar_quad.b4096.hybrid", 1, 0.0, False, "cpu",
                      traffic_changes=dict(batch=1))
ctx.driver.setup(ctx)
ctx.options = dataclasses.replace(ctx.options, max_iterations=1)
ctx.driver.window(ctx)
print(harness.forbidden_modules(),
      sorted(m for m in sys.modules if m.startswith("ipddp2tpu_torch"))[:1])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert out.strip().splitlines()[-1] == "[] ['ipddp2tpu_torch']"
