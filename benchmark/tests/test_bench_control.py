"""The control (the program in float32, `control.py`) comes out not
correct where the program in float64 is correct, on the same instances and
iterations. On the CPU: each configuration at B = 2 for two iterations; on
the card (`-m gpu`): every cell at B = 64 to the end of its solve."""

import dataclasses

import pytest
import torch

import control
import harness

SMALL = dict(batch=2)
TRAJECTORY = ("objective_gap", "dynamics_residual")
CPU_CELLS = [("concar_quad", "b4096.hybrid"),
             ("cartpole_friction", "b1024.hybrid")]


@pytest.mark.parametrize("config, mix", CPU_CELLS)
def test_control_on_the_cpu(config, mix):
    """Also the configuration the benchmark holds no cell of yet (its
    program path hangs on the card: PERF.md, Open questions). Two
    iterations converge no lane, so only the numbers of the returned
    trajectory are compared here."""
    two = lambda o: dataclasses.replace(o, max_iterations=2)
    _, checks64, _ = control.control_run((config, mix), 7, "cpu", SMALL,
                                         two, dtype=torch.float64)
    _, checks32, _ = control.control_run((config, mix), 7, "cpu", SMALL,
                                         two)
    within = lambda checks: all(checks[k]["value"] <= checks[k]["limit"]
                                for k in TRAJECTORY if k in checks)
    assert within(checks64), checks64
    assert not within(checks32), checks32


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.benchmark()["workloads"]])
def test_control_on_the_card(cuda, workload):
    small = dict(SMALL, batch=64)
    ok64, checks64, _ = control.control_run(workload, 7, cuda, small,
                                            dtype=torch.float64)
    ok32, checks32, _ = control.control_run(workload, 7, cuda, small)
    assert ok64, checks64
    assert not ok32, checks32
