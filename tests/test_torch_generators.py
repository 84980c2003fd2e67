"""The port's instance generators and the campaign script's instances past
the committed rows.

Each of the five models' maps from draws to instances
(`instance_from_draws`) is held against the JAX package's `random_instance`
on JAX's own draws, made here by the same `jax.random.split` / `uniform` /
`randint` calls: to 1e-15 relative. The port's draws come from a seeded
`torch.Generator` (the JAX generator's ranges, not its numbers).
`run_benchmarks.instances(name, n)` gives n instances, the committed rows
of `experiments/params` first, bit for bit, and `main` writes the params
file it solved, which reads back bit for bit."""

import importlib.util
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipddp2tpu.models import acrobot as jacrobot
from ipddp2tpu.models import cartpole as jcartpole
from ipddp2tpu.models import cartpole_swingup as jswingup
from ipddp2tpu.models import pushing as jpushing
from ipddp2tpu.models import quadrotor as jquadrotor
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.experiments import compare_results
from ipddp2tpu_torch.experiments import run_benchmarks as rb
from ipddp2tpu_torch.models import (acrobot, cartpole, cartpole_swingup,
                                    concar, pushing, quadrotor)
from torch_port_helpers import tnp

ROOT = Path(__file__).resolve().parents[1]
F64 = jnp.float64
KEYS = 4


def _jax_parser():
    """`experiments/compare_results.py`'s parser (the JAX side's)."""
    spec = importlib.util.spec_from_file_location(
        "compare_results", ROOT / "experiments" / "compare_results.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.parse


def _uniforms(key, n):
    """`n` scalar unit uniforms from `jax.random.split(key, n)`."""
    return jnp.stack([jax.random.uniform(k, dtype=F64)
                      for k in jax.random.split(key, n)])


def _acrobot_draws(key):
    return (_uniforms(key, 4),)


def _cartpole_draws(key):
    ks = jax.random.split(key, 4)
    return (jnp.concatenate([
        jnp.stack([jax.random.uniform(k, dtype=F64) for k in ks[:3]]),
        jax.random.uniform(ks[3], (2,), dtype=F64)]),)


def _pushing_draws(key):
    ks = jax.random.split(key, 3)
    return (jax.random.randint(ks[0], (), 0, len(jpushing.BLOCK_PARAMS)),
            jax.random.uniform(ks[1], (3,), dtype=F64),
            jax.random.uniform(ks[2], dtype=F64))


def _quadrotor_draws(key):
    k1, k2 = jax.random.split(key)
    return (jax.random.uniform(k1, (3,), dtype=F64),
            jax.random.uniform(k2, (3,), dtype=F64))


def _swingup_draws(key):
    return (_uniforms(key, 2),)


# (JAX module, port module, JAX's draws of one key in the port map's order)
MAPS = (("acrobot", jacrobot, acrobot, _acrobot_draws),
        ("cartpole", jcartpole, cartpole, _cartpole_draws),
        ("pushing", jpushing, pushing, _pushing_draws),
        ("quadrotor", jquadrotor, quadrotor, _quadrotor_draws),
        ("cartpole_swingup", jswingup, cartpole_swingup, _swingup_draws))


def test_maps_equal_jax_random_instance_on_its_draws():
    """Every leaf of each model's instance from JAX's draws against JAX's
    `random_instance` of the same keys: to 1e-15 relative."""
    keys = jax.random.split(jax.random.PRNGKey(7), KEYS)
    for name, jm, pm, draws in MAPS:
        ref = jax.jit(jax.vmap(jm.random_instance))(keys)
        drawn = jax.jit(jax.vmap(draws))(keys)
        out = pm.instance_from_draws(*(torch.as_tensor(np.array(d))
                                       for d in drawn))
        ref_leaves = jax.tree.leaves(ref)
        out_leaves = torch.utils._pytree.tree_leaves(out)
        assert len(out_leaves) == len(ref_leaves), name
        for a, b in zip(out_leaves, ref_leaves):
            b = np.asarray(b)
            assert a.dtype == torch.float64 and a.shape == b.shape, name
            np.testing.assert_allclose(tnp(a), b, rtol=1e-15, atol=0,
                                       err_msg=name)


def _ranges(name, drawn):
    """(value, low, high) of each drawn quantity of a model, by the JAX
    generator's ranges."""
    if name == "acrobot":
        return [(v, 0.9, 1.1) for v in drawn]
    if name == "cartpole":
        return [(drawn.mc, 0.9, 1.1), (drawn.mp, 0.15, 0.25),
                (drawn.l, 0.45, 0.55), (drawn.friction, 0.05, 0.15)]
    if name == "pushing":
        return [(drawn.mu_fric, 0.15, 0.25),
                (drawn.obstacle[:, 0], 0.05, 0.35),
                (drawn.obstacle[:, 1], 0.15, 0.25),
                (drawn.obstacle[:, 2], 0.04, 0.06)]
    if name == "quadrotor":
        th, x1 = drawn
        return [(th.goal, 0.5, 1.5), (x1[:, :3], -0.2, 0.2),
                (x1[:, 3:], 0.0, 0.0)]
    if name == "cartpole_swingup":
        return [(drawn[:, 0], -0.5, 0.5), (drawn[:, 1], -0.3, 0.3),
                (drawn[:, 2:], 0.0, 0.0)]
    th, f_lim, tau_lim, x1 = drawn
    return [(f_lim, 1.5, 2.5), (tau_lim, 3.0, 5.0),
            (th.obstacles[..., 2], 0.05, 0.2),
            (x1[:, 2], math.pi / 8, 3 * math.pi / 8)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_draws_in_range_and_deterministic(dtype):
    """Each model's `random_instances` (and concar's): the same seed gives
    the same instances bit for bit, another seed others; every quantity in
    the JAX generator's range, in the asked type; pushing's blocks rows of
    BLOCK_PARAMS."""
    B = 512
    leaves = lambda tree: torch.utils._pytree.tree_leaves(tree)
    for name, pm in (("acrobot", acrobot), ("cartpole", cartpole),
                     ("pushing", pushing), ("quadrotor", quadrotor),
                     ("cartpole_swingup", cartpole_swingup),
                     ("concar", concar)):
        draw = lambda seed: pm.random_instances(
            B, torch.Generator().manual_seed(seed), dtype=dtype)
        a, b, c = draw(3), draw(3), draw(4)
        assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
        assert not all(torch.equal(x, y)
                       for x, y in zip(leaves(a), leaves(c))), name
        assert all(x.dtype == dtype and x.shape[0] == B
                   for x in leaves(a)), name
        for value, lo, hi in _ranges(name, a):
            assert float(value.min()) >= lo - 1e-7 and \
                float(value.max()) <= hi + 1e-7, (name, lo, hi)
        if name == "pushing":
            blocks = torch.tensor(pushing.BLOCK_PARAMS, dtype=dtype)
            got = torch.stack([a.zx, a.zy, a.c], dim=1)
            assert bool((got[:, None] == blocks[None]).all(-1).any(-1).all())
            assert len({tuple(r) for r in got.tolist()}) == len(blocks)


def test_instances_past_the_committed_rows(tmp_path, monkeypatch):
    """`instances("quadrotor", 103)`: 103 lanes, rows 1-100 the committed
    instances bit for bit, rows 101-103 drawn from the seeded generator
    (`--key`); n lanes of every model; and `main` writes the params file
    of what it solved (read back bit for bit by `from_params`) and a
    results table that the JAX parser and the port's read alike."""
    n = 103
    th, b, x1, u0 = rb.instances("quadrotor", n)
    assert x1.shape[0] == n and th.goal.shape[0] == n
    ref = quadrotor.from_params(convert.params_rows(quadrotor.PARAMS))
    assert torch.equal(th.goal[:100], ref[0].goal)
    assert torch.equal(x1[:100], ref[2])
    dth, dx1 = quadrotor.random_instances(3, torch.Generator().manual_seed(1))
    assert torch.equal(th.goal[100:], dth.goal)
    assert torch.equal(x1[100:], dx1)
    other = rb.instances("quadrotor", n, key=2)[0].goal
    assert torch.equal(other[:100], th.goal[:100])
    assert not torch.equal(other[100:], th.goal[100:])
    for name in rb.MODELS:
        lanes = rb.instances(name, 101)[2].shape[0]
        assert lanes == 101, (name, lanes)

    solved = {}

    def fake_solve_batch(problem, bounds, x1, u0, theta, options, device):
        solved["x1"], solved["goal"] = x1, theta.goal
        m = x1.shape[0]
        return types.SimpleNamespace(
            converged=torch.ones(m, dtype=torch.bool),
            status=torch.zeros(m, dtype=torch.int32),
            iterations=torch.full((m,), 27, dtype=torch.int32),
            objective=torch.linspace(1e-3, 4e-3, m, dtype=torch.float64),
            primal_inf=torch.zeros(m, dtype=torch.float64))

    monkeypatch.setattr(rb, "solve_batch", fake_solve_batch)
    assert rb.main(["quadrotor", "--seeds", str(n), "--device", "cpu",
                    "--out", str(tmp_path)]) == 0
    rows = convert.params_rows("quadrotor.txt", directory=tmp_path / "params")
    back = quadrotor.from_params(rows)
    assert torch.equal(back[0].goal, solved["goal"])
    assert torch.equal(back[2], solved["x1"])
    assert torch.equal(back[0].goal, th.goal)
    table = tmp_path / "quadrotor.txt"
    mine = compare_results.parse(table)
    assert len(mine) == n and mine == _jax_parser()(table)
    assert compare_results.main([str(tmp_path)]) == 0
