"""The plain references: the configuration's equations agree with the
program's model files, and the judge's residuals read what was planted in
a hand-built trajectory."""

import pytest
import torch

import harness
import judge

CONFIGS = ["concar_quad", "cartpole_friction"]


def setup(name, B=2, seed=0):
    ctx = harness.context_for(name, "b1024.hybrid", seed, 0.0, False, "cpu")
    gen = torch.Generator().manual_seed(seed)
    inst = ctx.instances.draw(ctx.cfg, B, gen)
    return ctx, inst


def port_theta(ctx, inst, b):
    return ctx.model.Theta(**{k: v[b] for k, v in inst["theta"].items()})


def interior_controls(ctx, inst, gen):
    """Controls strictly inside the bounds, [B, T, nu]."""
    B, T, nu = inst["x1"].shape[0], ctx.cfg["T"], ctx.cfg["nu"]
    lo = inst["lower"][:, None].expand(B, T, nu)
    hi = inst["upper"][:, None].expand(B, T, nu)
    r = torch.rand((B, T, nu), generator=gen, dtype=torch.float64)
    span = torch.where(torch.isfinite(hi - lo), hi - lo,
                       torch.full_like(r, 0.2))
    base = torch.where(torch.isfinite(lo), lo, -0.1 * torch.ones_like(r))
    return base + (0.05 + 0.9 * r) * span


def rollout(ref, x1, u, th):
    xs = [x1]
    for t in range(u.shape[1]):
        xs.append(ref.dynamics(xs[-1], u[:, t], th))
    return torch.stack(xs, dim=1)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_program_model(name):
    ctx, inst = setup(name)
    ref, mod = ctx.reference, ctx.model
    gen = torch.Generator().manual_seed(5)
    u = interior_controls(ctx, inst, gen)[:, 7]
    x = torch.rand((2, ctx.cfg["nx"]), generator=gen, dtype=torch.float64)
    for b in range(2):
        th, one = port_theta(ctx, inst, b), {k: v[b:b + 1] for k, v in
                                             inst["theta"].items()}
        for mine, theirs in (
                (ref.dynamics(x[b:b + 1], u[b:b + 1], one)[0],
                 mod.dynamics(x[b], u[b], 7, th)),
                (ref.stage_cost(x[b:b + 1], u[b:b + 1], one)[0],
                 mod.stage_cost(x[b], u[b], 7, th)),
                (ref.terminal_cost(x[b:b + 1], one)[0],
                 mod.terminal_cost(x[b], th)),
                (ref.constraints(x[b:b + 1], u[b:b + 1], one)[0],
                 mod.constraints(x[b], u[b], 7, th))):
            torch.testing.assert_close(mine, theirs, rtol=1e-13, atol=1e-13)


def own_derivatives(ref, x, u, th, b, t):
    """fx, fu, lx, lu, cx, cu of one lane and stage, by
    torch.autograd.functional.jacobian on the single row."""
    one = {k: v[b:b + 1] for k, v in th.items()}
    jac = torch.autograd.functional.jacobian
    xs, us = x[b, t], u[b, t]
    out = []
    for fn in (ref.dynamics, ref.stage_cost, ref.constraints):
        f = lambda xx, uu: fn(xx[None], uu[None], one)[0]
        out += list(jac(f, (xs, us)))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_judge_reads_what_was_planted(name):
    ctx, inst = setup(name)
    ref, cfg = ctx.reference, ctx.cfg
    gen = torch.Generator().manual_seed(9)
    u = interior_controls(ctx, inst, gen)
    th = inst["theta"]
    x = rollout(ref, inst["x1"], u, th)
    B, T, nx = x.shape[0], cfg["T"], cfg["nx"]
    nu, nc = cfg["nu"], cfg["nc"]
    phi = 0.1 * torch.rand((B, T, nc), generator=gen, dtype=torch.float64)
    zl = torch.rand((B, T, nu), generator=gen, dtype=torch.float64)
    zu = torch.rand((B, T, nu), generator=gen, dtype=torch.float64)
    zl = torch.where(torch.isfinite(inst["lower"])[:, None], zl, 0.0)
    zu = torch.where(torch.isfinite(inst["upper"])[:, None], zu, 0.0)
    # costate by the backward recursion, with Jacobians of our own
    lam = torch.zeros((B, T + 1, nx), dtype=torch.float64)
    r_u = torch.zeros((B, T, nu), dtype=torch.float64)
    for b in range(B):
        xT = x[b, T].clone()
        lam[b, T] = torch.autograd.functional.jacobian(
            lambda xx: ref.terminal_cost(xx[None],
                                         {k: v[b:b + 1] for k, v in
                                          th.items()})[0], xT)
        for t in reversed(range(T)):
            fx, fu, lx, lu, cx, cu = own_derivatives(ref, x, u, th, b, t)
            lam[b, t] = lx + cx.T @ phi[b, t] + fx.T @ lam[b, t + 1]
            r_u[b, t] = (lu + cu.T @ phi[b, t] - zl[b, t] + zu[b, t]
                         + fu.T @ lam[b, t + 1])
    J = (ref.stage_cost(x[:, :T].reshape(B * T, nx), u.reshape(B * T, nu),
                        {k: v.repeat_interleave(T, 0) for k, v in th.items()})
         .reshape(B, T).sum(1) + ref.terminal_cost(x[:, T], th))
    sol = {"x": x, "u": u, "phi": phi, "zl": zl, "zu": zu, "lam": lam,
           "objective": J, "status": torch.zeros(B, dtype=torch.int32),
           "converged": torch.ones(B, dtype=torch.bool),
           "mu": torch.zeros(B, dtype=torch.float64)}
    got = judge.judge_block(ref, cfg, inst, sol)
    assert float(got["dynamics_residual"].max()) <= 1e-15
    assert float(got["objective_gap"].max()) <= 1e-15
    # the expected optimality error, from our own derivatives
    lo = inst["lower"][:, None].expand(B, T, nu)
    hi = inst["upper"][:, None].expand(B, T, nu)
    ml, mh = torch.isfinite(lo), torch.isfinite(hi)
    n = (ml.sum((1, 2)) + mh.sum((1, 2))).double()
    zsum = zl.sum((1, 2)) + zu.sum((1, 2))
    s_d = torch.clamp((phi.abs().sum((1, 2)) + zsum) / (n + nc),
                      min=100.0) / 100.0
    s_c = torch.clamp(zsum / n, min=100.0) / 100.0
    c = ref.constraints(x[:, :T].reshape(B * T, nx), u.reshape(B * T, nu),
                        {k: v.repeat_interleave(T, 0) for k, v in th.items()})
    cs = torch.maximum(
        torch.where(ml, (u - lo) * zl, 0.0).abs().amax((1, 2)),
        torch.where(mh, (hi - u) * zu, 0.0).abs().amax((1, 2)))
    want = torch.stack([c.reshape(B, -1).abs().amax(1),
                        r_u.abs().amax((1, 2)) / s_d, cs / s_c], 1).amax(1)
    torch.testing.assert_close(got["kkt"], want, rtol=1e-12, atol=1e-14)
    assert bool(got["solved"].all()) and not bool(got["unanswered"].any())

    # planted: a state off its dynamics, a stale objective, a costate off
    # its equation, a control outside its bounds, a lane with no answer
    x2 = x.clone()
    x2[1, 40, 0] += 1e-3
    obj2 = J.clone()
    obj2[0] += 1e-6
    lam2 = lam.clone()
    lam2[0, 30, 1] += 1e-2
    u2 = u.clone()
    u2[1, 3, 0] = inst["upper"][1, 0] + 1.0
    planted = judge.judge_block(ref, cfg, inst, dict(
        sol, x=x2, objective=obj2, lam=lam2, u=u2,
        converged=torch.tensor([True, False]),
        status=torch.tensor([0, 0], dtype=torch.int32)))
    scale = max(1.0, float(x2[1, 41].abs().max()))
    assert float(planted["dynamics_residual"][1]) >= 0.999e-3 / max(
        scale, float(x2[1, 40].abs().max()))
    assert float(planted["objective_gap"][0]) == pytest.approx(
        1e-6 / max(1.0, abs(float(J[0]))), rel=1e-6)
    assert float(planted["kkt"][0]) >= 1e-2 / float(s_d[0]) * 0.999
    assert float(planted["kkt"][1]) == float("inf")
    assert planted["unanswered"].tolist() == [False, True]
