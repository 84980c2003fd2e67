"""The serving pools (`ipddp2tpu_torch/serve.py`) against standalone solves
and the JAX package.

Four short concar instances (T = 16, 15 to 17 iterations each) through two
slots in chunks of 8 iterations, so that slots are refilled, chunk-capped
slots resume and a retired slot idles for a chunk. Tolerances as tests/test_serve.py
holds the JAX pools: each instance's iterations equal to its standalone
solve's and its objective within rtol 1e-8 (the standalone solves are the
lanes of one lockstep batch: a lane's iterates do not depend on its batch,
tests/test_torch_solve.py::test_converged_lane_stays_frozen); against the
JAX package's solve of the same instances the objective within rtol 1e-6
and the same convergence (whole solves of two packages, never equal
iteration counts)."""

import jax
import numpy as np
import pytest
import torch

import ipddp2tpu as J

import ipddp2tpu_torch as P
from ipddp2tpu_torch.serve import solve_pool, solve_pool_resident

from torch_port_helpers import (concar_instances, jax_concar_args,
                                short_concar, tnp, torch_concar_args)

N, SLOTS, CHUNK = 4, 2, 8
OPTS = dict(optimality_tolerance=1e-6, max_iterations=600)


@pytest.fixture(scope="module")
def pools():
    jp, pp = short_concar()
    inst = concar_instances(9, N)
    args = torch_concar_args(inst)
    kw = dict(theta=args[3], options=P.Options(**OPTS), slots=SLOTS,
              chunk=CHUNK, device="cpu")
    pool = solve_pool(pp, *args[:3], **kw)
    resident = solve_pool_resident(pp, *args[:3], **kw)
    alone = P.solve(pp, *args[:3], theta=args[3], options=P.Options(**OPTS),
                    device="cpu")
    jb, jx1, ju0, jth = jax_concar_args(inst)
    ref = jax.jit(jax.vmap(lambda b, x, u, th: J.solve(
        jp, b, x, u, theta=th, options=J.Options(**OPTS))))(jb, jx1, ju0,
                                                             jth)
    return pool, resident, alone, ref


def test_pool_matches_standalone_and_jax(pools):
    pool, _, alone, ref = pools
    sol = pool.solutions
    assert sol.converged.shape == (N,) and bool(sol.converged.all())
    assert torch.equal(sol.iterations, alone.iterations)
    np.testing.assert_allclose(tnp(sol.objective), tnp(alone.objective),
                               rtol=1e-8)
    np.testing.assert_allclose(tnp(sol.x), tnp(alone.x), atol=1e-10)
    np.testing.assert_array_equal(tnp(sol.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(tnp(sol.objective), np.asarray(ref.objective),
                               rtol=1e-6)


def test_resident_pool_equals_pool(pools):
    """The same seat and chunk schedule: per instance the same status,
    iterations and (to rounding) objective and trajectory."""
    pool, resident, _, _ = pools
    a, b = pool.solutions, resident.solutions
    assert resident.chunks == pool.chunks
    for f in ("status", "iterations", "converged"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(tnp(b.objective), tnp(a.objective),
                               rtol=1e-12)
    np.testing.assert_allclose(tnp(b.x), tnp(a.x), atol=1e-12)


def _schedule(iterations, slots, chunk, max_iterations):
    """The chunks and occupancies the JAX package's two pools compute for
    instances needing `iterations` accepted steps each, every one of them
    converging: a slot seats the queue's next instance when its own
    converges, which `run` sees in the iteration after the last step, so
    within a chunk only if that step lies below the chunk's limit."""
    queue = list(iterations)
    seat = [queue.pop(0) for _ in range(slots)]
    k = [0] * slots
    live = [True] * slots
    chunks = useful = live_slot_iters = 0
    while any(live):
        chunks += 1
        live_slot_iters += sum(live) * chunk
        for s in range(slots):
            if not live[s]:
                continue
            limit = min(k[s] + chunk, max_iterations)
            step = min(seat[s], limit) - k[s]
            useful += step
            k[s] += step
            if seat[s] < limit:
                if queue:
                    seat[s], k[s] = queue.pop(0), 0
                else:
                    live[s] = False
    return (chunks, useful / live_slot_iters,
            useful / (chunks * slots * chunk))


def test_occupancy_as_jax_computes_it(pools):
    """`solve_pool`: useful iterations over the live slots' chunks;
    `solve_pool_resident`: over every slot of every chunk, retired slots
    included, so it is the smaller one once a slot has retired."""
    pool, resident, _, _ = pools
    its = pool.solutions.iterations.tolist()
    chunks, occ_pool, occ_resident = _schedule(
        its, SLOTS, CHUNK, OPTS["max_iterations"])
    assert pool.chunks == resident.chunks == chunks
    assert pool.occupancy == pytest.approx(occ_pool, rel=1e-12)
    assert resident.occupancy == pytest.approx(occ_resident, rel=1e-12)
    assert resident.occupancy < pool.occupancy <= 1.0
    with pytest.raises(AssertionError, match="slots"):
        pp = short_concar()[1]
        args = torch_concar_args(concar_instances(9, 1))
        solve_pool(pp, *args[:3], theta=args[3], slots=2, device="cpu")
