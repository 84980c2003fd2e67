"""What the port's chunked loop does at chunk boundaries that must not change
any lane's result: batch compaction against the lockstep batch, and the
adaptive K of the hybrid line search (`adapt_ls`) against a static K.

Short concar (T=16, B=8; instances converge at 17-21 iterations). Every
lane's arithmetic is its own, so a lane solved inside a compacted batch, or
with another K of the same hybrid search, takes the same steps: converged
flags and iteration counts equal, objectives to 1e-10, iterates to 1e-12
(a batch of another width may round a product differently)."""

import numpy as np
import torch

import ipddp2tpu_torch as P
from ipddp2tpu_torch import chunked
from ipddp2tpu_torch.solve import initialize

from torch_port_helpers import (concar_instances, short_concar, tnp,
                                torch_concar_args)

B = 8


def _record_runs(monkeypatch):
    """Every `run` the chunked loop calls: (lanes, K)."""
    calls, inner = [], chunked.run

    def run(problem, bounds, state, theta, options, **kw):
        calls.append((state.k.shape[0], options.ls_speculative))
        return inner(problem, bounds, state, theta, options, **kw)

    monkeypatch.setattr(chunked, "run", run)
    return calls


def test_compaction_matches_lockstep(monkeypatch):
    _, pp = short_concar()
    pb, px1, pu0, pth = torch_concar_args(concar_instances(11, B))
    opts = P.Options(optimality_tolerance=1e-7, max_iterations=200)
    solve = lambda **kw: P.solve_chunked(pp, pb, px1, pu0, theta=pth,
                                         options=opts, chunk=3, device="cpu",
                                         **kw)
    full = solve()
    calls = _record_runs(monkeypatch)
    comp = solve(compact_sizes=(4, 2))
    assert {n for n, _ in calls} == {8, 4, 2}, calls     # both rungs ran
    assert bool(full.converged.all())
    np.testing.assert_array_equal(tnp(comp.converged), tnp(full.converged))
    np.testing.assert_array_equal(tnp(comp.iterations), tnp(full.iterations))
    assert len(set(tnp(full.iterations).tolist())) > 1
    np.testing.assert_allclose(tnp(comp.objective), tnp(full.objective),
                               rtol=1e-10)
    np.testing.assert_allclose(tnp(comp.x), tnp(full.x), rtol=0, atol=1e-12)


def test_adaptive_k_takes_the_steps_of_static_k(monkeypatch):
    """Hybrid search from K=8 with adapt_ls=(2, 4, 8). The state's last
    line-search counts are set so that the first boundary picks K=2 (the
    counts of this short problem stay 0 afterwards, so K stays there): the
    largest acceptable step is then found by the sequential continuation
    where the static search finds it among its 8 candidates."""
    _, pp = short_concar()
    pb, px1, pu0, pth = torch_concar_args(concar_instances(11, B))
    opts = P.Options(optimality_tolerance=1e-7, max_iterations=200,
                     ls_speculative=8, ls_spec_continue=True)
    s0 = initialize(pp, pth, pb, px1, pu0, opts, device="cpu")
    static = chunked.run_chunked(pp, pb, s0, pth, opts, chunk=3,
                                 device="cpu")
    calls = _record_runs(monkeypatch)
    num_ls = torch.zeros(B, dtype=torch.int32)
    num_ls[0] = 1
    adapt = chunked.run_chunked(pp, pb, s0._replace(num_ls=num_ls), pth,
                                opts, chunk=3, adapt_ls=(2, 4, 8),
                                device="cpu")
    assert {k for _, k in calls} == {2}, calls
    assert bool(static.converged.all())
    np.testing.assert_array_equal(tnp(adapt.converged), tnp(static.converged))
    np.testing.assert_array_equal(tnp(adapt.k), tnp(static.k))
    for field in ("x", "u", "step_size"):
        np.testing.assert_allclose(tnp(getattr(adapt, field)),
                                   tnp(getattr(static, field)),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(tnp(adapt.objective), tnp(static.objective),
                               rtol=1e-10)
