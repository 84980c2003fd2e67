"""Plain versions of the two chain probes (`ops/probe_chain.py`).

The multiply chain is held against `x0 * c**T` computed in numpy float64
(T roundings of half an ulp each: rtol 1e-13 at T=100), the dynamics chain
against T steps of `ipddp2tpu.models.concar.dynamics` under `vmap` (the same
formulas through another libm: 1e-12). The kernels themselves run on the
card only, where `chip_smoke.py` holds them against these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipddp2tpu.models import concar as jconcar

from ipddp2tpu_torch.ops import probe_chain as pc

from torch_port_helpers import tnp

B, T = 8, 100
C = 1.0000001


def test_mul_chain_plain_matches_closed_form():
    rng = np.random.default_rng(2)
    x0 = rng.uniform(0.5, 1.0, (8, B))
    out = pc.mul_chain_cuda(torch.as_tensor(x0), C, T)     # CPU: plain
    assert out.dtype == torch.float64 and out.shape == (8, B)
    np.testing.assert_allclose(tnp(out), x0 * C ** T, rtol=1e-13)


def test_mul_chain_plain_float32_stays_float32():
    rng = np.random.default_rng(2)
    x0 = rng.uniform(0.5, 1.0, (8, B)).astype(np.float32)
    out = pc.mul_chain_plain(torch.as_tensor(x0), C, T)
    assert out.dtype == torch.float32
    c32 = float(np.float32(C))
    np.testing.assert_allclose(tnp(out), x0 * c32 ** T, rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_dynamics_chain_plain_matches_jax(dtype, tol):
    rng = np.random.default_rng(2)
    x0 = np.stack([rng.uniform(0, 1, B), rng.uniform(0, 1, B),
                   rng.uniform(0.3, 0.9, B), rng.uniform(0.1, 0.5, B)],
                  axis=1)
    us = rng.uniform(-0.5, 0.5, (B, T, 10))
    step = jax.vmap(lambda x, u: jconcar.dynamics(x, u, 0, None))
    xr = jnp.asarray(x0)
    for t in range(T):
        xr = step(xr, jnp.asarray(us[:, t]))
    out = pc.dynamics_chain_cuda(torch.as_tensor(x0.astype(dtype)),
                                 torch.as_tensor(us.astype(dtype)))
    assert out.dtype == getattr(torch, np.dtype(dtype).name)
    np.testing.assert_allclose(tnp(out), np.asarray(xr), rtol=tol, atol=tol)


def test_probe_wrappers_check_their_inputs_and_count_no_cpu_launch():
    x0 = torch.zeros((B, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        pc.dynamics_chain_cuda(x0, torch.zeros((B, T, 9),
                                               dtype=torch.float64))
    with pytest.raises(ValueError):
        pc.dynamics_chain_cuda(x0, torch.zeros((B, T, 10),
                                               dtype=torch.float32))
    assert sum(pc.launch_counts.values()) == 0
