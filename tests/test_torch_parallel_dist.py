"""The port's multi-process layer (`ipddp2tpu_torch/parallel/`: `timeshard`,
`mesh`, `multihost`) in two gloo ranks on the CPU, against the JAX package
on a 2-device CPU mesh (`tests/conftest.py` gives 8) and against the port's
own single-process results.

One module-scoped spawn of two processes (`tests/torch_dist_worker.py`)
joins them through a `FileStore` file in a temporary directory (no TCP
port) and runs `value_scan_timesharded` (T = 64, two instances),
`solve_timesharded` (the double integrator at T = 64, 3 iterations),
`solve_sharded` and `solve_global` (concar at T = 16, 4 instances, 3
iterations); each rank writes what it got to a `.npz` file.

Tolerances: the value scan as tests/test_timeshard.py holds it (rtol 1e-9,
atol 1e-11); the time-sharded solve against the single-process parallel
mode as there (rtol 1e-8, atol 1e-10); the sharded solve against JAX's
`solve_sharded` to 1e-8 (iterate parity at small k), and bit for bit
against the port's `solve_batch` on the same lanes (the CPU keeps lanes
independent of their batch)."""

import dataclasses
import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import ipddp2tpu as J
import ipddp2tpu.derivatives as jd
from ipddp2tpu.backward import costate_scan as j_costate_scan
from ipddp2tpu.models import concar as jconcar
from ipddp2tpu.parallel import mesh as jmesh
from ipddp2tpu.parallel import priccati as jpr
from ipddp2tpu.parallel import timeshard as jts

import ipddp2tpu_torch as P
from ipddp2tpu_torch.batch import batch_stats, solve_batch
from ipddp2tpu_torch.parallel import priccati as ppr
from ipddp2tpu_torch.parallel.multihost import initialize_distributed

import torch_dist_worker as W
from torch_port_helpers import short_concar, tiny_problems, tnp

WORLD = 2
SCAN_T, SCAN_B = 64, 2


@functools.partial(jax.jit, static_argnames="jp")
def _jax_elements(jp, x, u, phi, nominal, mu):
    """Stage elements of a randomized iterate, vmapped over the batch."""
    def one(x_, u_, phi_, nom, m):
        d = jd.evaluate_derivatives(jp, None, x_, u_, phi_)
        lam = j_costate_scan(d, phi_)
        second = d.cH_phi + jd.contract_dynamics_hessian(jp, None, x_, u_,
                                                         lam[1:])
        el = jpr._stage_blocks(jp, d, nom, m, second, jnp.zeros(()),
                               jnp.zeros(()), J.Options())
        return el, d.lTx, d.lTxx
    return jax.vmap(one)(x, u, phi, nominal, mu)


def _scan_inputs():
    jp = dataclasses.replace(tiny_problems(2)()[0], T=SCAN_T)
    rng = np.random.default_rng(0)
    B, T, nx, nu, nc = SCAN_B, SCAN_T, jp.nx, jp.nu, jp.nc
    x = 0.5 * rng.standard_normal((B, T + 1, nx))
    u = 0.5 * rng.standard_normal((B, T, nu))
    phi = rng.standard_normal((B, T, nc))
    nominal = (0.1 * rng.standard_normal((B, T, nc)),
               0.5 + rng.uniform(size=(B, T, nu)),
               0.5 + rng.uniform(size=(B, T, nu)), phi,
               0.1 + rng.uniform(size=(B, T, nu)),
               0.1 + rng.uniform(size=(B, T, nu)))
    return jp, _jax_elements(jp, x, u, phi, nominal, np.full(B, 0.01))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks on the CPU; returns (their outputs, the scan's
    inputs)."""
    work = tmp_path_factory.mktemp("dist")
    jp, (el, lTx, lTxx) = _scan_inputs()
    np.savez(work / "elements.npz", lTx=np.asarray(lTx),
             lTxx=np.asarray(lTxx),
             **{k: np.asarray(v) for k, v in el._asdict().items()})
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run,
                         args=(r, WORLD, str(work / "store"), str(work)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive), "a rank did not end within 300 s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return ([dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)],
            (jp, el, lTx, lTxx))


def test_value_scan_timesharded_matches_jax(ranks):
    """Both ranks return the full suffix values, equal to the JAX
    package's time-sharded scan on a 2-device mesh and to the port's
    single-process scan."""
    outs, (jp, el, lTx, lTxx) = ranks
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    for i in range(SCAN_B):
        one = jax.tree.map(lambda a: a[i], el)
        Vx, Vxx = jts.value_scan_timesharded(jp, one, lTx[i], lTxx[i], mesh)
        for out in outs:
            for got, ref in ((out["Vx"][i], Vx), (out["Vxx"][i], Vxx)):
                np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-9,
                                           atol=1e-11)
    pel = ppr.ValueElement(*(torch.as_tensor(np.asarray(a)) for a in el))
    pp = dataclasses.replace(tiny_problems(2)()[1], T=SCAN_T)
    Vx, Vxx = ppr.parallel_value_scan(pp, pel,
                                      torch.as_tensor(np.asarray(lTx)),
                                      torch.as_tensor(np.asarray(lTxx)))
    np.testing.assert_allclose(outs[0]["Vx"], tnp(Vx), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(outs[0]["Vxx"], tnp(Vxx), rtol=1e-9,
                               atol=1e-11)


def test_solve_timesharded_follows_parallel_mode(ranks):
    """`solve_timesharded` over two ranks follows the single-process
    parallel mode's iterates (and both ranks hold the same solution)."""
    outs, _ = ranks
    prob, bounds, x1, u0 = W.di_long()
    ref = P.solve(prob, bounds, x1, u0,
                  options=dataclasses.replace(W.options(),
                                              backward_mode="parallel"),
                  device="cpu")
    for out in outs:
        np.testing.assert_allclose(out["ts_u"], tnp(ref.u), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(out["ts_x"], tnp(ref.x), rtol=1e-8,
                                   atol=1e-10)


def _global_batch():
    return W.stack_instances([W.concar_instance(i)
                              for i in range(W.CONCAR_B)])


def test_solve_sharded_matches_jax_and_solve_batch(ranks):
    """Each rank's shard equals `solve_batch` on the same lanes bit for
    bit and JAX's `solve_sharded` (2-device mesh) to 1e-8; the replicated
    stats equal JAX's sharded stats (the median as the mean of the shard
    medians) and `batch_stats` of the union for every other field."""
    outs, _ = ranks
    bounds, x1, u0, theta = _global_batch()
    ref = solve_batch(W.short_concar(), bounds, x1, u0, theta=theta,
                      options=W.options(), device="cpu")
    jp, _ = short_concar(W.CONCAR_T)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))
    jsol, jstats = jmesh.solve_sharded(
        jp, J.Bounds(jnp.asarray(tnp(bounds.lower)),
                     jnp.asarray(tnp(bounds.upper))),
        jnp.asarray(tnp(x1)), jnp.asarray(tnp(u0)),
        theta=jconcar.Theta(jnp.asarray(tnp(theta.obstacles))),
        options=J.Options(optimality_tolerance=1e-7,
                          max_iterations=W.SOLVE_ITERATIONS), mesh=mesh)
    per = W.CONCAR_B // WORLD
    for r, out in enumerate(outs):
        rows = slice(r * per, (r + 1) * per)
        for f in ("x", "u", "iterations", "status", "converged"):
            np.testing.assert_array_equal(out[f"sh_{f}"],
                                          tnp(getattr(ref, f)[rows]))
        for f in ("x", "u"):
            np.testing.assert_allclose(out[f"sh_{f}"],
                                       np.asarray(getattr(jsol, f))[rows],
                                       rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(out["sh_stats"],
                                   [float(v) for v in jstats], rtol=1e-12)
    union = batch_stats(ref)
    stats = outs[0]["sh_stats"]
    for k, name in enumerate(union._fields):
        if name != "median_iterations":
            np.testing.assert_allclose(stats[k], float(union[k]), rtol=1e-12,
                                       err_msg=name)


def test_solve_global_generates_only_its_own_lanes(ranks):
    """`solve_global`: rank r calls the generator for its own global
    indices only, and its shard and the stats equal `solve_sharded`'s."""
    outs, _ = ranks
    per = W.CONCAR_B // WORLD
    for r, out in enumerate(outs):
        assert out["generated"].tolist() == list(range(r * per,
                                                       (r + 1) * per))
        for f in ("x", "u", "iterations", "status", "converged", "stats"):
            np.testing.assert_array_equal(out[f"gl_{f}"], out[f"sh_{f}"])


def test_initialize_distributed_world_of_one_is_a_no_op():
    """A world of one joins no process group; the default device is the
    GPU, which raises here without one."""
    initialize_distributed(world_size=1)
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_distributed(world_size=2, rank=0,
                                   init_method="file:///nonexistent")
