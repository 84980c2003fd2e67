"""The port's campaign script (`ipddp2tpu_torch/experiments/run_benchmarks.py`)
against the JAX campaign's committed results (`experiments/results/`).

The script solves the committed instances (`experiments/params/`) on the
CPU and writes the JAX results format; the tables it writes must have the
JAX files' header and column layout, read back through the repo's own
parser (`experiments/compare_results.py`), each instance's status equal to
the JAX file's and its objective within 1e-6. Iteration counts over whole
solves are reported by the script, never asserted equal."""

import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ipddp2tpu_torch.experiments import run_benchmarks as rb

ROOT = Path(__file__).resolve().parents[1]


def _parser():
    spec = importlib.util.spec_from_file_location(
        "compare_results", ROOT / "experiments" / "compare_results.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.parse


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The script's run on the double integrator and the first two
    quadrotor instances, on the CPU."""
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("results")
    assert rb.main(["double_integrator", "quadrotor", "--seeds", "2",
                    "--device", "cpu", "--out", str(out)]) == 0
    return out


def _columns(line):
    return [m.start() for m in re.finditer(r"\S+", line)]


@pytest.mark.parametrize("stem", ["double_integrator", "quadrotor"])
def test_campaign_writes_the_jax_results_format(written, stem):
    """Header equal, every row's columns where the JAX file has them, and
    the rows read back by experiments/compare_results.py: status equal,
    objective within 1e-6 of the JAX campaign's."""
    mine = (written / f"{stem}.txt").read_text().splitlines()
    ref = (ROOT / "experiments" / "results" / f"{stem}.txt").read_text() \
        .splitlines()
    assert mine[0] == ref[0]
    for a, b in zip(mine[1:], ref[1:]):
        assert _columns(a) == _columns(b), (a, b)
    parse = _parser()
    got, want = parse(written / f"{stem}.txt"), parse(
        ROOT / "experiments" / "results" / f"{stem}.txt")
    assert len(got) == len(mine) - 1
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        np.testing.assert_allclose(g[3], w[3], rtol=1e-6)


def test_compare_puts_a_campaign_beside_the_jax_table():
    """`compare` on a batch that reproduces concar's JAX table, with the
    golden anchor as lane 100 (the layout of `chip_smoke.py`'s campaign):
    every count, the median as numpy takes it, the anchor's rule; an
    unknown problem stops the script."""
    conv, iters, obj = rb.reference_results("concar")
    n = conv.shape[0]
    sol = types.SimpleNamespace(
        converged=torch.cat([conv, torch.tensor([True])]),
        iterations=torch.cat([iters, torch.tensor([99.0])]).to(torch.int32),
        objective=torch.cat([obj, torch.tensor([4.46466505])]),
        status=torch.zeros(n + 1, dtype=torch.int32))
    f = rb.compare("concar", sol, n)
    assert (f["solved"], f["reference_solved"]) == (n, int(conv.sum()))
    assert f["objectives_matching_reference_to_1e_4"] == int(conv.sum())
    assert f["median_iterations"] == float(np.median(iters.numpy()))
    assert f["unsolved"] == [] and f["golden"]["on_golden"]
    with pytest.raises(SystemExit):
        rb.main(["nonsense", "--device", "cpu"])
