"""The port's independent check (`experiments/independent_check.py`'s
counterpart) and the two scripts `residue_levers` and `profile_iteration`.

The single-shooting NLP of the port (`make_nlp`: objective, gradient,
constraints, dense Jacobian) is held against the JAX script's on short
concar and short acrobot (T = 16) to 1e-12 relative. `check_instance` runs
both certificates on the short double integrator from the port's solution,
and the line it prints is read by the JAX `slsqp_table.py`'s regexes and by
the port's copy alike. The two scripts run on the CPU at a small size."""

import contextlib
import importlib.util
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipddp2tpu.models import acrobot as jacrobot
from ipddp2tpu.models import concar as jconcar
from ipddp2tpu.models import double_integrator as jdi
from ipddp2tpu_torch import Options, solve_batch
from ipddp2tpu_torch.experiments import independent_check as ic
from ipddp2tpu_torch.experiments import slsqp_table
from ipddp2tpu_torch.models import acrobot as pacrobot
from ipddp2tpu_torch.models import concar as pconcar
from ipddp2tpu_torch.models import double_integrator as pdi
from ipddp2tpu_torch.problem import Bounds
from ipddp2tpu_torch.scripts import profile_iteration, residue_levers
from torch_port_helpers import T_SHORT, short_concar, short_pair, tnp

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name):
    """A script of the JAX side's `experiments/`, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _short(model):
    """(JAX problem, port problem, JAX theta, port theta, x1 [nx]) of a
    model's seed-1 instance at T = 16."""
    if model == "concar":
        jp, pp = short_concar()
        jth, _, _, jx1 = jconcar.seed1_instance()
        pth = pconcar.seed1_instance()[0]
        return jp, pp, jth, pth, np.array(jx1)
    jp, pp = short_pair(jacrobot, pacrobot)
    return (jp, pp, jacrobot.seed1_instance(), pacrobot.seed1_instance(),
            np.array(jacrobot.initial_state()))


@pytest.mark.parametrize("model", ["concar", "acrobot"])
def test_nlp_against_the_jax_script(model):
    """Objective, gradient, constraints and Jacobian of the port's NLP at
    three control sequences against the JAX script's `make_nlp`: 1e-12
    relative (of each output's largest entry)."""
    jp, pp, jth, pth, x1 = _short(model)
    jfns = _jax_script("independent_check").make_nlp(jp, jth, jnp.asarray(x1))
    pfns = ic.make_nlp(pp, pth, torch.as_tensor(x1))
    rng = np.random.default_rng(5)
    for _ in range(3):
        u = 0.05 + 0.3 * rng.standard_normal(T_SHORT * pp.nu)
        for name, jf, pf in zip(("objective", "gradient", "constraints",
                                 "jacobian"), jfns, pfns):
            want = np.asarray(jf(jnp.asarray(u)))
            got = tnp(pf(torch.as_tensor(u)))
            assert got.shape == want.shape, name
            np.testing.assert_allclose(
                got, want, rtol=1e-12,
                atol=1e-12 * max(np.abs(want).max(), 1e-300), err_msg=name)


def test_check_instance_on_the_short_double_integrator():
    """The port's solution of the double integrator at T = 16 holds both
    certificates (warm start stationary within the barrier gap; the cold
    start in the same basin), and the line `check_instance` prints is read
    by the JAX `slsqp_table.py` regexes and by the port's copy alike."""
    torch.set_num_threads(1)
    _, pp = short_pair(jdi, pdi)
    b = pdi.bounds()
    bounds = Bounds(b.lower[:T_SHORT], b.upper[:T_SHORT])
    x1 = pdi.initial_state()
    u0 = pdi.initial_controls()[:T_SHORT]
    sol = solve_batch(pp, Bounds(bounds.lower[None], bounds.upper[None]),
                      x1[None], u0[None],
                      options=Options(optimality_tolerance=1e-7,
                                      max_iterations=1000), device="cpu")
    assert bool(sol.converged[0])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        basin, held = ic.check_instance("double_integrator seed 1", pp,
                                        bounds, None, x1, u0, sol.u[0], 400)
    line = out.getvalue()
    assert held and basin[0], line
    mine = slsqp_table.parse_line(line)
    jax_table = _jax_script("slsqp_table")
    m = jax_table.ROW.search(line)
    assert m and mine is not None and not mine["violated"]
    assert (m.group(1), int(m.group(2))) == ("double_integrator", 1)
    assert (mine["problem"], mine["seed"], mine["same"]) == \
        ("double_integrator", 1, True)
    for got, group in ((mine["ours"], 3), (mine["cold"], 4),
                       (mine["improve"], 8)):
        assert got == float(m.group(group))
    np.testing.assert_allclose(mine["ours"], float(sol.objective[0]),
                               rtol=1e-7)
    warm_only = line.replace(line[line.index("slsqp(cold)"):
                                  line.index("warm-start")],
                             "(cold start skipped: dense NLP too large)  ")
    assert jax_table.ROW_WARM.search(warm_only)
    assert slsqp_table.parse_line(warm_only)["cold"] is None


def test_residue_levers_smoke(capsys):
    """`residue_levers.main` on the CPU: 2 instances of seed 1002, 3
    iterations, levers base and bk: the JAX script's lines, the residue
    indices of that seed."""
    torch.set_num_threads(1)
    assert residue_levers.main(["--device", "cpu", "--instances", "2",
                                "--max-iter", "3", "--levers",
                                "base,bk"]) == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [ln for ln in lines if ln.startswith("[")]
    assert [h.split("]")[0] for h in heads] == ["[base", "[bk"]
    assert all("/2 in " in h and "(median k" in h for h in heads)
    insts = {ln.split(":")[0].split()[-1] for ln in lines
             if ln.startswith("   inst ")}
    assert insts <= {"3", "20"}
    with pytest.raises(SystemExit):
        residue_levers.main(["--device", "cpu", "--levers", "nonsense"])


def test_profile_iteration_smoke(capsys):
    """`profile_iteration.main --device cpu --reps 1`: one `name  ms` line a
    piece in the JAX script's order; 0 (every piece's output finite)."""
    torch.set_num_threads(1)
    assert profile_iteration.main(["--device", "cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:28].strip() for ln in lines] == list(
        profile_iteration.PIECES)
    assert all(float(ln.split()[-2]) > 0 for ln in lines)
