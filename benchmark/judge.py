"""What decides `correct`: the solutions a run returned, held against a
plain reference of the configuration's equations.

For every instance of every batch the window solved, in float64 and in
blocks of lanes:

- `kkt`, on every lane: the optimality error as the configuration
  measures it (the reference's, with its s_max scaling and its quirk of
  one stage's constraint count), from the returned states, controls,
  multipliers and bound duals and the reference's own derivatives: primal
  |c|, stationarity in u, complementarity with mu = 0; and beside them
  stationarity in x, the costate equation, scaled as the dual error. A
  lane not strictly inside its control bounds, or with a negative dual of
  a finite bound, reads inf. Its limit is the configuration's tolerance,
  with room for the recomputation's rounding.
- `objective_gap`, on every lane: |reported objective - the reference's
  objective of the returned trajectory| / max(1, |that objective|).
- `dynamics_residual`, on every lane: the largest |x_{t+1} - f(x_t, u_t)|
  over the stages, and |x_0 - x1|, each over max(1, |x|).
- `failed`: lanes that came back with a failure status, not converged.
  The configuration states that every instance converges.
- `unanswered`: lanes that came back neither converged nor with a failure
  status, or converged with one.

Derivatives are taken by autograd of the reference's row functions: the
rows are independent, so the gradient of a column's sum is that column's
Jacobian row by row. Nothing here imports the program.
"""

import torch


def _jacobians(fn, x, u, th):
    """Value [N, m] of a row function and its Jacobians [N, m, nx] and
    [N, m, nu] (a scalar function gives m = 1)."""
    x = x.detach().requires_grad_(True)
    u = u.detach().requires_grad_(True)
    with torch.enable_grad():
        out = fn(x, u, th)
        out = out[:, None] if out.dim() == 1 else out
        jx, ju = [], []
        for i in range(out.shape[1]):
            gx, gu = torch.autograd.grad(out[:, i].sum(), (x, u),
                                         retain_graph=True, allow_unused=True)
            jx.append(torch.zeros_like(x) if gx is None else gx)
            ju.append(torch.zeros_like(u) if gu is None else gu)
    return out.detach(), torch.stack(jx, dim=1), torch.stack(ju, dim=1)


def _terminal_gradient(ref, x, th):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        val = ref.terminal_cost(x, th)
        (g,) = torch.autograd.grad(val.sum(), (x,))
    return val.detach(), g


def _amax(a):
    """Per-lane max of |a| over every axis but the first; 0 for no entries."""
    if a[0].numel() == 0:
        return a.new_zeros(a.shape[0])
    return a.abs().flatten(1).amax(dim=1)


def judge_block(ref, cfg, inst, sol):
    """Per-lane readings of one block of lanes: dict of [b] float64 tensors
    `kkt`, `objective_gap`, `dynamics_residual`, and [b] bools `solved`
    (converged with status 0), `failed` and `unanswered`."""
    f64 = lambda a: a.to(torch.float64)
    x, u = f64(sol["x"]), f64(sol["u"])
    phi, zl, zu, lam = (f64(sol[k]) for k in ("phi", "zl", "zu", "lam"))
    b, T1, nx = x.shape
    T, nu, nc = T1 - 1, u.shape[2], phi.shape[2]
    th = {k: f64(v) for k, v in inst["theta"].items()}
    rows = lambda a: a.reshape((b * T,) + a.shape[2:])
    th_rows = {k: v.repeat_interleave(T, dim=0) for k, v in th.items()}
    lo = f64(inst["lower"])[:, None, :].expand(b, T, nu)
    hi = f64(inst["upper"])[:, None, :].expand(b, T, nu)

    xs, us = rows(x[:, :T]), rows(u)
    f, fx, fu = _jacobians(ref.dynamics, xs, us, th_rows)
    l, lx, lu = _jacobians(ref.stage_cost, xs, us, th_rows)
    if nc:
        c, cx, cu = _jacobians(ref.constraints, xs, us, th_rows)
    else:
        c, cx, cu = (xs.new_zeros(b * T, 0), xs.new_zeros(b * T, 0, nx),
                     xs.new_zeros(b * T, 0, nu))
    lT, lTx = _terminal_gradient(ref, x[:, T], th)
    shape = lambda a: a.reshape((b, T) + a.shape[1:])
    f, fx, fu, c, cx, cu = map(shape, (f, fx, fu, c, cx, cu))
    l, lx, lu = shape(l)[..., 0], shape(lx)[:, :, 0], shape(lu)[:, :, 0]

    # the trajectory and the reported objective
    scale = lambda a: torch.clamp(a.abs().amax(dim=-1), min=1.0)
    dyn = torch.maximum(
        ((x[:, 1:] - f).abs().amax(dim=-1) / scale(x[:, 1:])).amax(dim=1),
        (x[:, 0] - f64(inst["x1"])).abs().amax(dim=-1) / scale(x[:, 0]))
    J = l.sum(dim=1) + lT
    obj_gap = (f64(sol["objective"]) - J).abs() / torch.clamp(J.abs(),
                                                             min=1.0)

    # the optimality error, as the configuration measures it
    mu = f64(sol["mu"])
    if ref.COMPL_ROWS:
        rel = torch.zeros(nc, dtype=c.dtype, device=c.device)
        rel[list(ref.COMPL_ROWS)] = 1.0
        c = c - mu[:, None, None] * rel
    ml, mh = torch.isfinite(lo), torch.isfinite(hi)
    n_bounds = (ml.flatten(1).sum(dim=1) + mh.flatten(1).sum(dim=1)).to(
        torch.float64)
    s_max = cfg["s_max"]
    z_sum = zl.flatten(1).sum(dim=1) + zu.flatten(1).sum(dim=1)
    s_d = torch.clamp((phi.abs().flatten(1).sum(dim=1) + z_sum)
                      / torch.clamp(n_bounds + nc, min=1.0),
                      min=s_max) / s_max
    s_c = torch.clamp(z_sum / torch.clamp(n_bounds, min=1.0),
                      min=s_max) / s_max
    lam_next = lam[:, 1:]
    r_u = (lu + torch.einsum("btcu,btc->btu", cu, phi) - zl + zu
           + torch.einsum("btxu,btx->btu", fu, lam_next))
    r_x = lam[:, :T] - (lx + torch.einsum("btcx,btc->btx", cx, phi)
                        + torch.einsum("btxy,btx->bty", fx, lam_next))
    r_T = lam[:, T] - lTx
    il = torch.where(ml, u - lo, torch.zeros_like(u))
    iu = torch.where(mh, hi - u, torch.zeros_like(u))
    cs = torch.maximum(_amax(torch.where(ml, il * zl, torch.zeros_like(u))),
                       _amax(torch.where(mh, iu * zu, torch.zeros_like(u))))
    kkt = torch.stack([_amax(c), _amax(r_u) / s_d,
                       torch.maximum(_amax(r_x), _amax(r_T)) / s_d,
                       cs / s_c], dim=1).amax(dim=1)
    outside = ((ml & ((il <= 0) | (zl < 0)))
               | (mh & ((iu <= 0) | (zu < 0)))).flatten(1).any(dim=1)
    kkt = torch.where(outside, torch.full_like(kkt, float("inf")), kkt)

    status, converged = sol["status"], sol["converged"].to(torch.bool)
    nan_inf = lambda a: torch.nan_to_num(a, nan=float("inf"),
                                         posinf=float("inf"))
    return {"kkt": nan_inf(kkt), "objective_gap": nan_inf(obj_gap),
            "dynamics_residual": nan_inf(dyn),
            "solved": converged & (status == 0),
            "failed": ~converged & (status != 0),
            "unanswered": (converged & (status != 0))
            | (~converged & (status == 0))}


def map_instances(inst, fn):
    """An instance dict (theta's leaves, x1, lower, upper) with `fn`
    applied to every tensor."""
    return {"theta": {k: fn(v) for k, v in inst["theta"].items()},
            "x1": fn(inst["x1"]), "lower": fn(inst["lower"]),
            "upper": fn(inst["upper"])}


def judge(ref, cfg, inst, sol, block=1024):
    """`judge_block` over the lanes of one batch, `block` lanes at a time;
    the readings come back on the CPU."""
    B = sol["x"].shape[0]
    parts = []
    for s in range(0, B, block):
        cut = lambda a: a[s:s + block]
        out = judge_block(ref, cfg, map_instances(inst, cut),
                          {k: cut(v) for k, v in sol.items()})
        parts.append({k: v.cpu() for k, v in out.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def readings(per_lane):
    """The numbers compared, over the lanes of every judged batch: the
    largest `kkt`, `objective_gap` and `dynamics_residual`, the counts of
    failed and of unanswered lanes."""
    cat = lambda k: torch.cat([p[k] for p in per_lane])
    top = lambda a: float(a.max()) if a.numel() else 0.0
    return {"kkt": top(cat("kkt")),
            "objective_gap": top(cat("objective_gap")),
            "dynamics_residual": top(cat("dynamics_residual")),
            "failed": int(cat("failed").sum()),
            "unanswered": int(cat("unanswered").sum())}


def verdict(values, cfg):
    """(correct, checks): each number the configuration compares, beside its
    limit, and whether every one is within it."""
    checks = {name: {"value": values[name], "limit": cfg["limits"][name]}
              for name in cfg["checks"]}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
