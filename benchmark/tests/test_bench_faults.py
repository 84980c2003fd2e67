"""The judgement sees a broken timed path: the rest of a run (set-up,
window, judge) driven with the program's answers broken underneath, for
each fault a cell can have on one chip. A clean answer is correct; a state
the solver returned unchanged, half the batch answered with the other
half's solutions, half the batch returned at its start with a failure
status, and one control altered where it was produced are not.

On the CPU the concar cell at B = 2 (a real solve of about three minutes);
on the card (`-m gpu`) every cell at B = 64."""

import dataclasses
import time

import pytest
import torch

import harness

SEED = 2024


def solved(workload, device, batch):
    """The program's real answer for the cell's first batch, and its
    initial iterate."""
    ctx = harness.context(workload, SEED, 0.0, False, device,
                          traffic_changes=dict(batch=batch))
    ctx.driver.setup(ctx)
    problem, bounds, x1, u0, theta = ctx.inputs
    args = (problem, bounds, x1, u0)
    sol = ctx.solve(*args, theta=theta, options=ctx.options,
                    device=ctx.device)
    start = ctx.solve(*args, theta=theta, options=dataclasses.replace(
        ctx.options, max_iterations=0), device=ctx.device)
    return sol, start


def unchanged(sol, start):
    """Every lane's iterate as it started, its flags as the solve ended."""
    return sol._replace(**{k: getattr(start, k) for k in (
        "x", "u", "phi", "zl", "zu", "lam", "objective")})


def half_left_out(sol, start):
    """The second half of the lanes answered with the first half's."""
    h = sol.x.shape[0] // 2
    return type(sol)(*(torch.cat([a[:h], a[:h]])[:a.shape[0]]
                       for a in sol))


def half_given_up(sol, start):
    """The second half of the lanes returned as they started, not
    converged, with the status of an iteration limit: a trajectory that is
    consistent, and no solution."""
    h = sol.x.shape[0] // 2
    mixed = type(sol)(*(torch.cat([a[:h], b[h:]])
                        for a, b in zip(sol, start)))
    return mixed._replace(
        converged=torch.cat([sol.converged[:h],
                             torch.zeros_like(sol.converged[h:])]),
        status=torch.cat([sol.status[:h],
                          torch.full_like(sol.status[h:], 8)]))


def altered(sol, start):
    """One control of one lane moved by 1e-3 where it was produced."""
    u = sol.u.clone()
    u[0, u.shape[1] // 2, 0] += 1e-3
    return sol._replace(u=u)


def correct_with(workload, device, batch, answer):
    def solve(*args, trace=None, **kw):
        trace.append((torch.ones(batch, dtype=torch.bool,
                                 device=answer.x.device), None, None))
        return answer
    ctx = harness.context(workload, SEED, 0.0, False, device, solve=solve,
                          traffic_changes=dict(batch=batch))
    out = harness.run_cell(ctx, time.perf_counter())
    return out.correct, out.checks


def check_cell(workload, device, batch):
    sol, start = solved(workload, device, batch)
    assert bool(sol.converged.any()), "no lane converged: nothing to judge"
    ok, checks = correct_with(workload, device, batch, sol)
    assert ok, checks
    for fault in (unchanged, half_left_out, half_given_up, altered):
        ok, checks = correct_with(workload, device, batch, fault(sol, start))
        assert not ok, (fault.__name__, checks)


def test_faults_on_the_cpu():
    check_cell("concar_quad.b4096.hybrid", "cpu", 2)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.benchmark()["workloads"]])
def test_faults_on_the_card(cuda, workload):
    check_cell(workload, cuda, 64)
