"""Plain versions of the two chain probes (`ops/probe_chain.py`).

The multiply chain is held against `x0 * c**T` computed in numpy float64
(T roundings of half an ulp each: rtol 1e-13 at T=100), the dynamics chain
against T steps of `ipddp2tpu.models.concar.dynamics` under `vmap` (the same
formulas through another libm: 1e-12). The kernels themselves run on the
card only, where `chip_smoke.py` holds them against these plain versions.
What surrounds the dynamics chain's kernel is checked here: its launch
geometry (`chain_geometry`: every instance and step covered once, the bulk
copies' 16-byte rule, the shared memory) and a walk of its schedule, which
must land on the plain version bit for bit."""

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


def _schedule(geo, B, T, size):
    """The dynamics chain kernel's walk as `chain_geometry` lays it out:
    per block, its live instances, and per window in order its first step,
    the steps it computes, the steps its bulk copy brings, the copy's source
    offset in u and its target offset in the block's shared memory (bytes)."""
    step_bytes = 10 * size
    for block in range(geo.blocks):
        lanes = [lane for lane in range(geo.instances_per_block)
                 if block * geo.instances_per_block + lane < B]
        for w in range(geo.windows):
            t0 = w * geo.window
            n = min(geo.window, T - t0)
            n_copy = min(geo.window, geo.row_steps - t0)
            slot = w % pc.SLOTS
            yield block, lanes, t0, n, n_copy, [
                ((block * geo.instances_per_block + lane) * geo.row_steps
                 + t0) * step_bytes for lane in lanes], [
                (slot * geo.instances_per_block + lane) * geo.window
                * step_bytes for lane in lanes]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_chain_geometry_covers_every_step_once_in_aligned_windows(dtype):
    size = torch.finfo(dtype).bits // 8
    for Bn in (1, 2048, 2049):
        for Tn in (1, 100, 101):
            geo = pc.chain_geometry(Bn, Tn, dtype)
            assert geo.smem_bytes <= 227 * 1024
            assert geo.smem_bytes == (pc.SLOTS * geo.instances_per_block
                                      * geo.window * 10 * size)
            if Bn == 2048:
                assert geo.blocks >= 64
            assert geo.row_steps >= Tn and geo.row_steps * 10 * size % 16 == 0
            seen = np.zeros((geo.blocks * geo.instances_per_block, Tn), int)
            for block, lanes, t0, n, n_copy, src, dst in _schedule(
                    geo, Bn, Tn, size):
                assert 0 < n <= n_copy <= geo.window
                assert t0 + n_copy <= geo.row_steps
                assert n_copy * 10 * size % 16 == 0
                assert all(o % 16 == 0 for o in src + dst)
                for lane in lanes:
                    seen[block * geo.instances_per_block + lane,
                         t0:t0 + n] += 1
            assert (seen[:Bn] == 1).all() and (seen[Bn:] == 0).all()


def test_dynamics_chain_schedule_walk_equals_plain_bit_for_bit():
    from ipddp2tpu_torch.derivatives import batched_dynamics
    from ipddp2tpu_torch.models import concar
    step = batched_dynamics(concar.problem())
    Bn, Tn = 33, 101
    rng = np.random.default_rng(5)
    x0 = np.stack([rng.uniform(0, 1, Bn), rng.uniform(0, 1, Bn),
                   rng.uniform(0.3, 0.9, Bn), rng.uniform(0.1, 0.5, Bn)],
                  axis=1)
    us = rng.uniform(-0.5, 0.5, (Bn, Tn, 10))
    for dtype in (torch.float64, torch.float32):
        xt = torch.as_tensor(x0).to(dtype)
        ut = torch.as_tensor(us).to(dtype)
        geo = pc.chain_geometry(Bn, Tn, dtype)
        x = xt.clone()
        # every lane of a block steps window by window; the step is taken
        # on the whole batch (the plain version's shapes, so the same
        # vector paths) and kept on the block's lanes only
        for block, lanes, t0, n, _, _, _ in _schedule(
                geo, Bn, Tn, torch.finfo(dtype).bits // 8):
            rows = [block * geo.instances_per_block + lane for lane in lanes]
            for t in range(t0, t0 + n):
                x[rows] = step(x, ut[:, t], t, None)[rows]
        ref = pc.dynamics_chain_plain(xt, ut)
        assert torch.equal(x, ref), dtype
