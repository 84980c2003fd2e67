"""The port's utilities (`ipddp2tpu_torch/utils`) against the JAX package's:
the verbose iteration table, the profiling hooks, and checkpoints in the
JAX package's `.npz` layout, resumed across the packages and within the
port bit for bit.

A short double integrator (T = 20, the reference's stage functions) keeps
the solves small. Tolerances: a state saved by the JAX package resumes in
the port to the JAX package's own resume within rtol 1e-8 (objective) and
1e-7 (trajectories); a state saved by the port resumes bit for bit."""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipddp2tpu as J
from ipddp2tpu.models import double_integrator as jdi
from ipddp2tpu.solve import initialize as j_initialize
from ipddp2tpu.solve import run as j_run
from ipddp2tpu.utils import load_state as j_load_state
from ipddp2tpu.utils import save_state as j_save_state

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.solve import SolverState, initialize, run
from ipddp2tpu_torch.utils import (exit_message, load_state, profiling,
                                   save_state, solver_banner)

from torch_port_helpers import pdi, tnp

T = 20
ROW = re.compile(r"^\s+\d+\s+[\d.e+-]+\s")


def _problems():
    jp = J.Problem(T=T, nx=2, nu=3, nc=1, dynamics=jdi.dynamics,
                   stage_cost=jdi.stage_cost,
                   terminal_cost=jdi.terminal_cost,
                   constraints=jdi.constraints)
    pp = P.Problem(T=T, nx=2, nu=3, nc=1, dynamics=pdi.dynamics,
                   stage_cost=pdi.stage_cost,
                   terminal_cost=pdi.terminal_cost,
                   constraints=pdi.constraints)
    return jp, pp


def _inputs(B):
    """B starting states (lane 0 the reference's), bounds and guesses as
    numpy arrays."""
    x1 = np.zeros((B, 2))
    x1[:, 0] = 0.1 * np.arange(B)
    lo = np.broadcast_to([-10.0, 0.0, 0.0], (B, T, 3)).copy()
    hi = np.broadcast_to([10.0, np.inf, np.inf], (B, T, 3)).copy()
    return x1, lo, hi, np.full((B, T, 3), 0.01)


def _verbose_rows(capsys, B):
    _, pp = _problems()
    x1, lo, hi, u0 = _inputs(B)
    solver_banner()
    sol = P.solve(pp, convert.bounds_from_numpy(lo, hi), torch.as_tensor(x1),
                  torch.as_tensor(u0),
                  options=P.Options(optimality_tolerance=1e-7, verbose=True,
                                    print_frequency=5), device="cpu")
    print(exit_message(int(sol.status[0]), bool(sol.converged[0])))
    out = capsys.readouterr().out
    return out, sol, [line for line in out.splitlines() if ROW.match(line)]


def test_verbose_iteration_table(capsys):
    """Banner, header with the wall / iter ms columns, rate-limited rows
    with positive timings, the exit message (tests/test_printing.py); a
    batch prints lane 0's rows, the same as lane 0 alone."""
    out, sol, rows = _verbose_rows(capsys, 1)
    assert "ipddp2tpu_torch" in out
    header = [line for line in out.splitlines() if "objective" in line]
    assert header and "wall(ms)" in header[0] and "iter(ms)" in header[0]
    assert len(rows) >= 3
    assert {int(r.split()[0]) % 5 for r in rows} == {0}
    for r in rows:
        cols = r.split()
        assert float(cols[-2]) > 0 and float(cols[-1]) > 0
    assert "Optimal solution found" in out
    _, _, rows2 = _verbose_rows(capsys, 2)
    assert [r.split()[:-2] for r in rows2] == [r.split()[:-2] for r in rows]
    assert exit_message(7, False).startswith("Line search failed")


def test_profiling_trace_and_block_timer(tmp_path, monkeypatch):
    """`trace` writes a Chrome trace of the block under its directory and
    yields the profile; `BlockTimer` adds up its blocks' wall time and
    synchronizes each CUDA device of the tensors it is given once."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timer = profiling.BlockTimer()
    gpu = types.SimpleNamespace(device=torch.device("cuda", 1))
    with timer(torch.ones(3), gpu, gpu):
        sum(range(10000))
    first = timer.seconds
    assert first > 0 and synced == [torch.device("cuda", 1)]
    with timer():
        pass
    assert timer.seconds >= first and len(synced) == 1


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """tests/test_modes.py's interrupt / save / load / resume, across the
    packages: a vmapped JAX state after 10 iterations, saved by the JAX
    package, loaded by the port and run to the end, against the JAX
    package's own resume of the same file. A single-instance file (no batch
    axis) loads as a batch of one."""
    jp, pp = _problems()
    x1, lo, hi, u0 = _inputs(2)
    jbounds = J.Bounds(jnp.asarray(lo), jnp.asarray(hi))
    short, full = (dict(optimality_tolerance=1e-7, max_iterations=m)
                   for m in (10, 500))

    @jax.jit
    def first_part(b, x, u):
        s = jax.vmap(lambda bb, xx, uu: j_initialize(
            jp, None, bb, xx, uu, J.Options(**short)))(b, x, u)
        return jax.vmap(lambda bb, ss: j_run(jp, bb, ss, None,
                                             J.Options(**short)))(b, s)

    state = first_part(jbounds, jnp.asarray(x1), jnp.asarray(u0))
    assert np.asarray(state.k).tolist() == [10, 10]
    path = str(tmp_path / "ckpt.npz")
    j_save_state(path, state)
    ref = j_load_state(path)
    ref = jax.jit(jax.vmap(lambda bb, ss: j_run(
        jp, bb, ss._replace(status=jnp.int32(0)), None,
        J.Options(**full))))(jbounds, ref)

    loaded = load_state(path, device="cpu")
    assert loaded.x.shape == (2, T + 1, 2) and loaded.k.dtype == torch.int32
    resumed = run(pp, convert.bounds_from_numpy(lo, hi),
                  loaded._replace(status=torch.zeros_like(loaded.status)),
                  None, P.Options(**full), device="cpu")
    assert bool(resumed.converged.all()) and bool(np.all(ref.converged))
    np.testing.assert_allclose(tnp(resumed.objective),
                               np.asarray(ref.objective), rtol=1e-8)
    np.testing.assert_allclose(tnp(resumed.x), np.asarray(ref.x), atol=1e-7)

    one = str(tmp_path / "one.npz")
    with np.load(path) as data:
        np.savez(one, **{f: data[f][0] for f in data.files})
    single = load_state(one, device="cpu")
    for a, b in zip(single, loaded):
        assert a.shape == b[:1].shape and torch.equal(a, b[:1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_checkpoint_round_trip_bit_for_bit(tmp_path, dtype):
    """A port state saved and loaded is the same state, every field and
    type; resumed, it ends bit for bit where the uninterrupted run ends."""
    _, pp = _problems()
    x1, lo, hi, u0 = _inputs(2)
    bounds = convert.bounds_from_numpy(lo, hi, dtype)
    opts = P.Options(optimality_tolerance=1e-7 if dtype == torch.float64
                     else 3e-4, max_iterations=60)
    s0 = initialize(pp, None, bounds, torch.as_tensor(x1, dtype=dtype),
                    torch.as_tensor(u0, dtype=dtype), opts, device="cpu")
    part = run(pp, bounds, s0, None, opts, k_limit=6, device="cpu")
    path = str(tmp_path / "port.npz")
    save_state(path, part)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(SolverState._fields)
    back = load_state(path, device="cpu")
    for f, a, b in zip(SolverState._fields, back, part):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    resumed = run(pp, bounds,
                  back._replace(status=torch.zeros_like(back.status)), None,
                  opts, device="cpu")
    whole = run(pp, bounds, s0, None, opts, device="cpu")
    for f, a, b in zip(SolverState._fields, resumed, whole):
        assert torch.equal(a, b), f
