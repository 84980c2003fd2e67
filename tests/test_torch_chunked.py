"""The port's chunked loop (`ipddp2tpu_torch/chunked.py`): the same steps as
the one-call solve, parity with the JAX package's `run_chunked`, `run`'s
limit per lane, lanes of different progress in one batch, and the stall
rule.

Tolerances: a chunked solve resumes `run` on the state it left, so against
the port's own one-call solve it is bit for bit. Against the JAX package,
iterates after 6 iterations agree to 1e-8 (the costate orders differ, see
tests/test_torch_solve.py). The stall rule is exact host arithmetic."""

import jax
import numpy as np
import torch

import ipddp2tpu as J
from ipddp2tpu.chunked import run_chunked as j_run_chunked
from ipddp2tpu.solve import initialize as j_initialize

import ipddp2tpu_torch as P
from ipddp2tpu_torch.chunked import run_chunked, solve_chunked, stall_step
from ipddp2tpu_torch.solve import SolverState, initialize, run

from torch_port_helpers import (concar_instances, jax_concar_args, pdi,
                                short_concar, tnp, torch_concar_args)

OPTS = dict(optimality_tolerance=1e-7)


def test_solve_chunked_equals_solve_bit_for_bit():
    """chunk=7 on the double integrator: every field of the final state as
    the one-call solve leaves it (the JAX package's test_chunked_matches_
    single, held to equality)."""
    prob, opts = pdi.problem(), P.Options(**OPTS)
    args = (prob, pdi.bounds(), pdi.initial_state()[None],
            pdi.initial_controls()[None])
    _, one = P.solve(*args, options=opts, return_state=True, device="cpu")
    sol, chunked = solve_chunked(*args, options=opts, chunk=7,
                                 return_state=True, device="cpu")
    assert bool(sol.converged[0])
    assert int(sol.iterations[0]) == pdi.GOLDEN_ITERATIONS
    for name, a, b in zip(SolverState._fields, one, chunked):
        assert torch.equal(a, b), name


def test_run_chunked_matches_jax():
    """Short concar (T=16, B=4), chunks of 2 up to 6 iterations: x and u
    against the JAX package's `run_chunked` to 1e-8, counters exactly."""
    jp, pp = short_concar()
    inst = concar_instances(11, 4)
    jb, jx1, ju0, jth = jax_concar_args(inst)
    jopts = J.Options(max_iterations=6, backward_kernel="xla",
                      forward_kernel="xla", **OPTS)
    s0 = jax.jit(jax.vmap(lambda b, x, u, th: j_initialize(
        jp, th, b, x, u, jopts)))(jb, jx1, ju0, jth)
    ref = j_run_chunked(jp, jb, s0, jth, jopts, chunk=2, batched=True)
    pb, px1, pu0, pth = torch_concar_args(inst)
    opts = P.Options(max_iterations=6, **OPTS)
    out = run_chunked(pp, pb, initialize(pp, pth, pb, px1, pu0, opts,
                                         device="cpu"),
                      pth, opts, chunk=2, device="cpu")
    for field in ("x", "u"):
        np.testing.assert_allclose(tnp(getattr(out, field)),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-8, atol=1e-8)
    for field in ("k", "status", "converged"):
        np.testing.assert_array_equal(tnp(getattr(out, field)),
                                      np.asarray(getattr(ref, field)))
    assert tnp(out.status).tolist() == [8] * 4


def test_run_with_a_limit_per_lane():
    """`run(k_limit=[2, 4, 3])`: every lane stops at its own limit with
    status 8, and lane 1 holds the state a common limit of 4 gives it."""
    _, pp = short_concar()
    pb, px1, pu0, pth = torch_concar_args(concar_instances(11, 3))
    opts = P.Options(**OPTS)
    s0 = initialize(pp, pth, pb, px1, pu0, opts, device="cpu")
    limits = torch.tensor([2, 4, 3], dtype=torch.int32)
    out = run(pp, pb, s0, pth, opts, k_limit=limits, device="cpu")
    assert tnp(out.k).tolist() == [2, 4, 3]
    assert tnp(out.status).tolist() == [8, 8, 8]
    common = run(pp, pb, s0, pth, opts, k_limit=4, device="cpu")
    for name, a, b in zip(SolverState._fields, out, common):
        assert torch.equal(a[1], b[1]), name


def test_run_chunked_heterogeneous_progress():
    """A lane already at the iteration cap (status 8) must not hold the
    others back: they converge, it keeps its k and status 8 (the JAX
    package's test_run_chunked_heterogeneous_progress)."""
    prob, n = pdi.problem(), 3
    opts = P.Options(max_iterations=200, **OPTS)
    bounds = P.Bounds(*(b.expand(n, pdi.T, pdi.NU) for b in pdi.bounds()))
    state = initialize(prob, None, bounds,
                       pdi.initial_state().expand(n, pdi.NX),
                       pdi.initial_controls().expand(n, pdi.T, pdi.NU), opts,
                       device="cpu")
    state = state._replace(
        k=torch.tensor([opts.max_iterations, 0, 0], dtype=torch.int32),
        status=torch.tensor([8, 0, 0], dtype=torch.int32))
    out = run_chunked(prob, bounds, state, None, opts, chunk=7, device="cpu")
    assert tnp(out.converged).tolist() == [False, True, True]
    assert int(out.status[0]) == 8 and int(out.k[0]) == opts.max_iterations
    np.testing.assert_allclose(tnp(out.objective[1:]), pdi.GOLDEN_OBJECTIVE,
                               rtol=1e-6)


def test_stall_rule_on_crafted_sequences():
    """Four lanes over five chunk boundaries, window 20: lane 0 improves its
    error by 2x each chunk, lane 1 by less than 1.2x (stalled once 20
    iterations pass without a 1.2x gain), lane 2 lowers mu only, lane 3 is not
    running. The first boundary only sets the baseline (error +inf)."""
    errs = [[1.0, 1.0, 1.0, 1.0], [0.5, 0.9, 1.0, 1.0],
            [0.25, 0.85, 1.0, 1.0], [0.125, 0.8, 1.0, 1.0],
            [0.0625, 0.78, 1.0, 1.0]]
    mus = [[0.1] * 4, [0.1, 0.1, 0.05, 0.1], [0.1, 0.1, 0.02, 0.1],
           [0.1, 0.1, 0.01, 0.1], [0.1, 0.1, 0.005, 0.1]]
    running = torch.tensor([True, True, True, False])
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    baseline, stalled_at = None, []
    for step, (err, mu) in enumerate(zip(errs, mus)):
        k = torch.full((4,), 10 * step, dtype=torch.int64)
        baseline, stalled = stall_step(baseline, f64(err), f64(mu), k,
                                       running, 20)
        stalled_at.append(stalled.tolist())
        if step == 0:
            assert torch.isinf(baseline.err).all()
            assert baseline.k.tolist() == [0.0] * 4
    # lane 1: improved at k=10 (inf -> 0.9), then 0.85, 0.8, 0.78 are each
    # within 1.2x of 0.9: no improvement after k=10, stalled from k=30
    assert [s[1] for s in stalled_at] == [False, False, False, True, True]
    assert not any(s[0] or s[2] or s[3] for s in stalled_at)
    assert baseline.k.tolist() == [40.0, 10.0, 40.0, 10.0]
    np.testing.assert_array_equal(baseline.err.numpy(),
                                  [0.0625, 0.9, 1.0, 1.0])
