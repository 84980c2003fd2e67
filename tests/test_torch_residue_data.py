"""The round-5 residue instances the port carries
(`ipddp2tpu_torch/models/concar_residue_r5.json`) are, bit for bit, the
instances the JAX package's generator makes: `index` of
`jax.random.split(jax.random.PRNGKey(seed), 2048)` through
`concar.random_instance` with x64 on, as `scripts/residue_levers.py` and
`bench.py` make them."""

import json

import jax
import numpy as np
import torch

from ipddp2tpu.models import concar as jconcar

from ipddp2tpu_torch.models import concar as pconcar

# scripts/residue_levers.py:RESIDUE
RESIDUE = {
    1002: [3, 20, 199, 453, 572, 668, 937, 1579, 1620],
    1004: [47, 427, 432, 484, 548, 743, 789, 1099, 1134, 1198, 1573,
           1625, 1719, 1910, 1929],
}


def test_data_file_equals_the_generator_bit_for_bit():
    rows = json.loads(pconcar.RESIDUE_R5.read_text())["instances"]
    assert [(r["seed"], r["index"]) for r in rows] == [
        (s, i) for s, idx in RESIDUE.items() for i in idx]
    for seed, idx in RESIDUE.items():
        keys = jax.random.split(jax.random.PRNGKey(seed), 2048)
        theta, f_lim, tau_lim, x1 = jax.vmap(jconcar.random_instance)(keys)
        assert theta.obstacles.dtype == np.float64
        ref = {"obstacles": np.asarray(theta.obstacles),
               "f_lim": np.asarray(f_lim), "tau_lim": np.asarray(tau_lim),
               "x1": np.asarray(x1)}
        for r in (r for r in rows if r["seed"] == seed):
            for key, a in ref.items():
                stored = np.vectorize(float.fromhex)(np.asarray(r[key]))
                np.testing.assert_array_equal(stored, a[r["index"]],
                                              err_msg=f"{seed}/{key}")


def test_loader_gives_the_instances_in_the_asked_type():
    seeds, idx, theta, f_lim, tau_lim, x1 = pconcar.residue_instances("cpu")
    assert seeds == [1002] * 9 + [1004] * 15
    assert idx == RESIDUE[1002] + RESIDUE[1004]
    assert theta.obstacles.shape == (24, 4, 3) and x1.shape == (24, 4)
    assert f_lim.dtype == torch.float64
    rows = json.loads(pconcar.RESIDUE_R5.read_text())["instances"]
    assert float(tau_lim[5]) == float.fromhex(rows[5]["tau_lim"])
    *_, t32, f32, _, x32 = pconcar.residue_instances("cpu", torch.float32)
    assert t32.obstacles.dtype == f32.dtype == x32.dtype == torch.float32
    assert torch.equal(x32, x1.to(torch.float32))
