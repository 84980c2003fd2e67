"""The port's mixed-precision solve (`ipddp2tpu_torch/mixed.py`) against the
JAX package's `mixed.py`: the promotion of an f32 state, the two-phase
solve, and the chunked solve's failure paths (an f32 phase that every lane
fails, the endgame denied, the restart rescue) with its `info` dict.

Tolerances: `promote_state` is the same arithmetic on the same f32 state
cast to f64 (every field to 1e-12). Whole solves are held to converging
and to JAX's objective at 1e-6 (the converged points of two packages that
sum in different orders), never to equal iteration counts; statuses and
the rescue's lane indices are exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ipddp2tpu as J
from ipddp2tpu.mixed import promote_state as j_promote
from ipddp2tpu.mixed import solve_mixed as j_solve_mixed
from ipddp2tpu.mixed import solve_mixed_chunked as j_solve_mixed_chunked
from ipddp2tpu.models import double_integrator as jdi
from ipddp2tpu.solve import SolverState as JSolverState

import ipddp2tpu_torch as P
from ipddp2tpu_torch import convert
from ipddp2tpu_torch.solve import SolverState, initialize, run

from torch_port_helpers import (concar_instances, jax_concar_args, pdi,
                                short_concar, tnp, torch_concar_args)

B = 4
OPTS = dict(optimality_tolerance=1e-7, max_iterations=300)
XLA = dict(backward_kernel="xla", forward_kernel="xla")


def test_promote_state_matches_jax():
    """An f32 state after 4 port iterations on short concar, handed to both
    packages as numpy arrays and promoted there."""
    jp, pp = short_concar()
    inst = concar_instances(11, B)
    pb, px1, pu0, pth = torch_concar_args(inst, dtype=torch.float32)
    opts = P.Options(**OPTS)
    s32 = run(pp, pb, initialize(pp, pth, pb, px1, pu0, opts, device="cpu"),
              pth, opts, k_limit=4, device="cpu")
    s32 = s32._replace(status=torch.zeros_like(s32.status))
    np32 = convert.state_to_numpy(s32)
    pb64, _, _, pth64 = torch_concar_args(inst)
    out = P.promote_state(pp, pb64,
                          convert.state_from_numpy(SolverState(**np32),
                                                   torch.float32),
                          pth64, opts, device="cpu")
    jb, _, _, jth = jax_concar_args(inst)
    ref = jax.jit(jax.vmap(lambda s, b, th: j_promote(
        jp, b, s, th, J.Options(**OPTS))))(JSolverState(**np32), jb, jth)
    for name in SolverState._fields:
        a, b = tnp(getattr(out, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        if b.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b), name)
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12,
                                       atol=1e-15, err_msg=name)
    assert out.x.dtype == torch.float64
    assert not bool(out.converged.any()) and not bool(out.status.any())
    assert tnp(out.filter_n).tolist() == [1] * B


def test_solve_mixed_short_double_integrator():
    """T=16 double integrator, one lane: f32 to 3e-4, then f64 to 1e-7."""
    prob = dataclasses.replace(pdi.problem(), T=16)
    bounds = P.Bounds(*(b[:16] for b in pdi.bounds()))
    sol = P.solve_mixed(prob, bounds, pdi.initial_state()[None],
                        pdi.initial_controls()[None, :16],
                        options=P.Options(**OPTS), device="cpu")
    jprob = dataclasses.replace(jdi.problem(), T=16)
    jb = J.Bounds(*(b[:16] for b in jdi.bounds()))
    ref = jax.jit(lambda: j_solve_mixed(
        jprob, jb, jdi.initial_state(), jdi.initial_controls()[:16],
        options=J.Options(**OPTS, **XLA)))()
    assert bool(ref.converged) and bool(sol.converged[0]), int(sol.status[0])
    assert float(sol.dual_inf[0]) < 1e-7
    np.testing.assert_allclose(float(sol.objective[0]), float(ref.objective),
                               rtol=1e-6)


PHASE1_FAILS = dict(chunk=5, phase1_max_iterations=3,
                    phase2_max_iterations=40, return_info=True)


@pytest.fixture(scope="module")
def mixed_chunked_pairs():
    """solve_mixed_chunked on short concar (T=16, B=4) with an f32 phase of
    3 iterations, which every lane fails, in both packages: with the
    endgame denied (rescue_failed=False) and with the restart rescue (a
    batch of 64 lanes: the failed 4 and their repeats)."""
    jp, pp = short_concar()
    inst = concar_instances(11, B)
    jb, jx1, ju0, jth = jax_concar_args(inst)
    pb, px1, pu0, pth = torch_concar_args(inst)
    out = {}
    for rescue in (False, "restart"):
        ref = j_solve_mixed_chunked(
            jp, jb, jx1, ju0, theta=jth, options=J.Options(**OPTS, **XLA),
            rescue_failed=rescue, batched=True, **PHASE1_FAILS)
        port = P.solve_mixed_chunked(
            pp, pb, px1, pu0, theta=pth, options=P.Options(**OPTS),
            rescue_failed=rescue, device="cpu", **PHASE1_FAILS)
        out[rescue] = ref, port
    return out


def test_denied_endgame_keeps_the_f32_status(mixed_chunked_pairs):
    (ref, rinfo), (sol, info) = mixed_chunked_pairs[False]
    assert set(info) == set(rinfo) == {"p1", "p2", "rescue"}
    assert info["rescue"] is None and rinfo["rescue"] is None
    for phase in ("p1", "p2"):
        assert set(info[phase]) == set(rinfo[phase])
        assert not info[phase]["converged"].any()
        for key in ("status", "k", "converged"):
            np.testing.assert_array_equal(info[phase][key].numpy(),
                                          rinfo[phase][key])
    assert tnp(sol.status).tolist() == [8] * B
    np.testing.assert_array_equal(tnp(sol.status), np.asarray(ref.status))
    np.testing.assert_array_equal(tnp(sol.iterations),
                                  np.asarray(ref.iterations))


def test_restart_rescue_matches_jax(mixed_chunked_pairs):
    (ref, rinfo), (sol, info) = mixed_chunked_pairs["restart"]
    assert set(info) == set(rinfo)
    assert set(info["rescue"]) == set(rinfo["rescue"])
    np.testing.assert_array_equal(info["rescue"]["indices"].numpy(),
                                  rinfo["rescue"]["indices"])
    np.testing.assert_array_equal(
        info["rescue"]["indices"].numpy(),
        np.nonzero(~info["p2"]["converged"].numpy())[0])
    assert info["rescue"]["converged"].all()
    assert bool(sol.converged.all()) and np.asarray(ref.converged).all()
    assert float(sol.dual_inf.max()) < 1e-7
    np.testing.assert_allclose(tnp(sol.objective), np.asarray(ref.objective),
                               rtol=1e-6)


def test_rescue_host_final_is_not_ported():
    """The host-CPU native-f64 wave exists for the TPU's double-single f64;
    the argument is refused, not ignored."""
    _, pp = short_concar()
    pb, px1, pu0, pth = torch_concar_args(concar_instances(11, 1))
    with pytest.raises(TypeError, match="rescue_host_final"):
        P.solve_mixed_chunked(pp, pb, px1, pu0, theta=pth,
                              rescue_host_final=True, device="cpu")
