"""Outer loop: Fiacco-McCormick barrier iteration with filter globalization
(PyTorch port, batch-first).

Counterpart of `ipddp2tpu/solve.py` (reference: src/solve.jl:1-199): a host
loop over one iteration

    derivatives -> backward pass -> KKT error norms -> {converged | barrier
    update (skip forward) | forward pass + nominal update + filter update}

carrying a single `SolverState` whose every field has a leading instance axis
`B`. The JAX package gets its batching from `vmap` of `while_loop`; here the
loop is on the host with a per-lane `active` mask: the body runs on every
lane, and only the active lanes take its result, so converged or failed
instances keep their slice of the state bit for bit while the rest keep
iterating. Inside the body both branches are computed and selected per lane,
as the JAX body does.

Error norms follow the reference exactly, including the IPOPT s_max scaling
and its quirk of counting only a single stage's equality-constraint dimension
in the dual-error scaling denominator (reference: src/solve.jl:130,145).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .backward import backward_pass, costate_scan
from .derivatives import (DerivativeBundle, batched_dynamics,
                          contract_dynamics_hessian, evaluate_constraints,
                          evaluate_derivatives, relax_constraints)
from .forward import (Trial, barrier_lagrangian, forward_pass,
                      forward_pass_hybrid, forward_pass_speculative,
                      forward_route)
from .options import Options
from .problem import Bounds, Problem, batch_bounds

Tensor = torch.Tensor


class SolverState(NamedTuple):
    """Everything carried across outer iterations (the nominal iterate plus
    per-lane bookkeeping — reference: src/data/problem.jl:1-37,
    src/data/solver.jl:8-33)."""

    # nominal trajectories
    x: Tensor        # [B, T+1, nx]
    u: Tensor        # [B, T, nu]
    c_raw: Tensor    # [B, T, nc] un-relaxed constraints at the nominal iterate
    il: Tensor       # [B, T, nu]
    iu: Tensor       # [B, T, nu]
    phi: Tensor      # [B, T, nc]
    zl: Tensor       # [B, T, nu]
    zu: Tensor       # [B, T, nu]
    lam: Tensor      # [B, T+1, nx]
    # barrier / regularization, [B]
    mu: Tensor
    reg_last: Tensor
    # performance measures of the accepted iterate, [B]
    objective: Tensor
    theta_curr: Tensor       # constraint violation 1-norm (primal_1_curr)
    L_curr: Tensor           # barrier Lagrangian (barrier_lagrangian_curr)
    max_primal_1: Tensor
    min_primal_1: Tensor
    # KKT errors (of the last evaluated iterate), [B]
    primal_inf: Tensor
    dual_inf: Tensor
    cs_inf: Tensor
    # filter (fixed-capacity ring: empty slots +inf)
    filter_pts: Tensor       # [B, CAP, 2]
    filter_n: Tensor         # [B] int32
    # counters and flags, [B]
    k: Tensor                # int32 overall iteration counter (accepted steps)
    j: Tensor                # int32 outer/barrier iteration counter
    ls_resets: Tensor        # int32 filter resets consumed after LS failures
    num_ls: Tensor           # int32 last line-search trial count
    step_size: Tensor
    status: Tensor           # int32
    converged: Tensor        # bool


class Solution(NamedTuple):
    x: Tensor
    u: Tensor
    phi: Tensor
    zl: Tensor
    zu: Tensor
    lam: Tensor
    objective: Tensor
    iterations: Tensor
    status: Tensor
    converged: Tensor
    primal_inf: Tensor
    dual_inf: Tensor
    cs_inf: Tensor
    mu: Tensor


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. The default is the GPU, and with
    no GPU present that raises: the port never carries on on the CPU unless
    the caller asked for it with `device="cpu"`."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ipddp2tpu_torch runs on a CUDA device by default and none "
                'is available; pass device="cpu" to run the plain PyTorch '
                "path on the CPU")
        # f32 products stay f32: reduced-precision matmul stalls the solver
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return device


def tree_map(fn, tree, *rest):
    """`fn` applied leaf by leaf to the tensors of one or more (possibly
    nested) tuples / NamedTuples of the same structure (a state, bounds,
    theta); None and other leaves of `tree` stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        parts = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _to_device(tree, device):
    """Move every tensor leaf of a (possibly nested) tuple / None."""
    return tree_map(lambda a: a.to(device), tree)


def _lane(mask: Tensor, like: Tensor) -> Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def select_state(pred: Tensor, a: SolverState, b: SolverState) -> SolverState:
    """Per-lane select of whole states; `torch.where` of two tensors of one
    dtype keeps that dtype (int32 counters, bool flags included)."""
    return SolverState(*(torch.where(_lane(pred, x), x, y)
                         for x, y in zip(a, b)))


def _nominal_trial(s: SolverState) -> Trial:
    return Trial(x=s.x, u=s.u, c_raw=s.c_raw, il=s.il, iu=s.iu,
                 phi=s.phi, zl=s.zl, zu=s.zu)


def _reset_filter(filter_pts: Tensor, max_primal_1: Tensor) -> Tensor:
    """Filter <- {(theta_max, -inf)} per lane (reference: src/solve.jl:101-105)."""
    pts = torch.full_like(filter_pts, float("inf"))
    pts[:, 0, 0] = max_primal_1
    pts[:, 0, 1] = float("-inf")
    return pts


def _augment_filter(filter_pts, filter_n, theta_curr, L_curr,
                    options: Options):
    """Filter <- Filter + {((1-g_t) theta, L - g_L theta)}
    (reference: src/solve.jl:95-99).

    On ring overflow the occupied slot is merged by componentwise min — a
    conservative envelope that blocks a superset of what the evicted point
    blocked. Empty slots hold +inf, so below capacity the min is an exact
    insert. One batched scatter-min over the lanes."""
    cap = filter_pts.shape[1]
    # slots 1..cap-1 form the ring; slot 0 holds the theta_max sentinel
    idx = 1 + torch.remainder(filter_n - 1, cap - 1).to(torch.int64)
    pt = torch.stack([(1.0 - options.gamma_theta) * theta_curr,
                      L_curr - options.gamma_L * theta_curr], dim=-1)
    index = idx[:, None, None].expand(-1, 1, 2)
    merged = filter_pts.scatter_reduce(1, index, pt[:, None, :], "amin",
                                       include_self=True)
    return merged, filter_n + 1


def resolve_options(options: Options, problem: Problem,
                    device=None) -> Options:
    """Resolve problem-dependent "auto" knobs to concrete values and refuse
    what the port does not implement yet, or what cannot run on `device`
    (`forward_kernel="cuda"` off the GPU or for a problem without device
    functions). `inertia_method="auto"` -> "bk" (rook Bunch-Kaufman,
    `ops/bk.py`) on problems with mu-relaxed complementarity rows or
    declared contact structure (`Problem.contact`), else "ldl". Idempotent."""
    options.validate()
    if device is not None:
        forward_route(problem, options, device)
    if options.inertia_method != "auto":
        return options
    is_contact = bool(problem.compl_indices) or problem.contact
    return dataclasses.replace(
        options, inertia_method="bk" if is_contact else "ldl").validate()


def initialize(problem: Problem, theta, bounds: Bounds, x1, u_init,
               options: Options, device=None) -> SolverState:
    """Interior projection of the control guess, nominal rollout, dual init
    (reference: src/solver.jl:54-105, src/solve.jl:14-36). `x1` is [B, nx],
    `u_init` [B, T, nu], bounds [B, T, nu] (or [T, nu], shared)."""
    device = resolve_device(device)
    options = resolve_options(options, problem, device)
    x1, u_init = x1.to(device), u_init.to(device)
    theta = _to_device(theta, device)
    B = x1.shape[0]
    bounds = batch_bounds(_to_device(bounds, device), B)
    T, nx, nc = problem.T, problem.nx, problem.nc
    lo, hi = bounds.lower, bounds.upper
    ml, mu_mask = bounds.mask_lower, bounds.mask_upper
    dtype = u_init.dtype
    k1, k2 = options.kappa_1, options.kappa_2

    # two-sided interior projection (reference: src/solver.jl:85-92)
    span = hi - lo
    lo_proj = lo + torch.minimum(k1 * torch.clamp(lo.abs(), min=1.0), k2 * span)
    hi_proj = hi - torch.minimum(k1 * torch.clamp(hi.abs(), min=1.0), k2 * span)
    u_two = torch.minimum(torch.maximum(u_init, lo_proj), hi_proj)
    # one-sided projections (reference: src/solver.jl:71-84; the upper-only
    # branch there is buggy — the clear intent, mirrored, as in the JAX
    # package)
    u_lo = torch.maximum(u_init, lo + k1 * torch.clamp(lo, min=1.0))
    u_hi = torch.minimum(u_init, hi - k1 * torch.clamp(hi, min=1.0))

    u = torch.where(ml & mu_mask, u_two,
                    torch.where(ml, u_lo, torch.where(mu_mask, u_hi, u_init)))

    step = batched_dynamics(problem)
    x_t = x1
    xs = [x_t]
    for t in range(T):
        x_t = step(x_t, u[:, t], t, theta)
        xs.append(x_t)
    x = torch.stack(xs, dim=1)

    new = lambda *shape, **kw: torch.zeros(
        (B,) + shape, device=device, **({"dtype": dtype} | kw))
    il = u - lo
    iu = hi - u
    phi = new(T, nc)
    zl = ml.to(dtype)
    zu = mu_mask.to(dtype)
    lam = new(T + 1, nx)

    mu = torch.full((B,), options.mu_init, dtype=dtype, device=device)
    c_raw = evaluate_constraints(problem, theta, x, u)
    c_rel = relax_constraints(problem, c_raw, mu)
    theta_curr = c_rel.abs().sum(dim=(1, 2))
    L_curr, J = barrier_lagrangian(problem, theta, bounds, x, u, c_rel,
                                   phi, il, iu, mu)

    max_primal_1 = 1e4 * torch.clamp(theta_curr, min=1.0)
    min_primal_1 = 1e-4 * torch.clamp(theta_curr, min=1.0)
    filter_pts = _reset_filter(new(options.filter_capacity, 2), max_primal_1)

    izero = lambda: new(dtype=torch.int32)
    return SolverState(
        x=x, u=u, c_raw=c_raw, il=il, iu=iu, phi=phi, zl=zl, zu=zu, lam=lam,
        mu=mu, reg_last=new(),
        objective=J, theta_curr=theta_curr, L_curr=L_curr,
        max_primal_1=max_primal_1, min_primal_1=min_primal_1,
        primal_inf=new(), dual_inf=new(), cs_inf=new(),
        filter_pts=filter_pts, filter_n=izero() + 1,
        k=izero(), j=izero(), ls_resets=izero(), num_ls=izero(),
        step_size=new(), status=izero(),
        converged=new(dtype=torch.bool),
    )


def dual_error(problem: Problem, deriv: DerivativeBundle, bounds: Bounds,
               phi, zl, zu, lam, options: Options):
    """Stationarity in u with IPOPT s_max scaling, [B] (reference:
    src/solve.jl:117-147)."""
    r = (deriv.lu
         + torch.einsum("btcu,btc->btu", deriv.cu, phi)
         - zl + zu
         + torch.einsum("btxu,btx->btu", deriv.fu, lam[:, 1:]))
    dual_inf = (r.abs().flatten(1).amax(dim=1) if r[0].numel()
                else zl.new_zeros((zl.shape[0],)))
    z_norm = zl.sum(dim=(1, 2)) + zu.sum(dim=(1, 2))
    phi_norm = phi.abs().sum(dim=(1, 2))
    num_ineq = bounds.num_bounds
    # Reference quirk mirrored: the equality-count term uses a single stage's
    # constraint dimension, not the total (reference: src/solve.jl:130).
    num_constr = problem.nc
    scaling = torch.clamp(
        (phi_norm + z_norm)
        / torch.clamp(num_ineq + num_constr, min=1).to(zl.dtype),
        min=options.s_max) / options.s_max
    return dual_inf / scaling


def cs_error(bounds: Bounds, il, iu, zl, zu, mu, options: Options):
    """Complementary-slackness error |il.zl - mu|, |iu.zu - mu| over finite
    bounds, s_max-scaled, [B]; mu is [B] or a float (reference:
    src/solve.jl:149-180). The inner select keeps inf * 0 out of the masked
    entries."""
    ml, mu_mask = bounds.mask_lower, bounds.mask_upper
    if isinstance(mu, torch.Tensor):
        mu = mu[:, None, None]
    zero = torch.zeros_like(il)
    rl = torch.where(ml, torch.where(ml, il, zero) * zl - mu, zero)
    ru = torch.where(mu_mask, torch.where(mu_mask, iu, zero) * zu - mu, zero)
    B = il.shape[0]
    amax = lambda a: (a.abs().flatten(1).amax(dim=1) if a[0].numel()
                      else il.new_zeros((B,)))
    cs = torch.maximum(amax(rl), amax(ru))
    z_norm = zl.sum(dim=(1, 2)) + zu.sum(dim=(1, 2))
    num_ineq = bounds.num_bounds
    scaling = torch.clamp(
        z_norm / torch.clamp(num_ineq, min=1).to(il.dtype),
        min=options.s_max) / options.s_max
    return cs / scaling


def _solution(state: SolverState) -> Solution:
    return Solution(
        x=state.x, u=state.u, phi=state.phi, zl=state.zl, zu=state.zu,
        lam=state.lam, objective=state.objective, iterations=state.k,
        status=state.status, converged=state.converged,
        primal_inf=state.primal_inf, dual_inf=state.dual_inf,
        cs_inf=state.cs_inf, mu=state.mu)


def solve(problem: Problem, bounds: Bounds, x1, u_init,
          theta=None, options: Optional[Options] = None,
          return_state: bool = False, device=None, trace=None):
    """Solve a batch of OCPs: `x1` [B, nx], `u_init` [B, T, nu], bounds
    `[B, T, nu]` (or `[T, nu]`, shared), theta leaves `[B, ...]`. B = 1 is
    the single instance. Runs on `device` (default: the GPU; raises without
    one). `trace`, if given, is a list that `run` appends to.

    Equivalent entry point to the reference `solve!(solver, x1, u_init)`
    (reference: src/solve.jl:1-93).
    """
    options = options or Options()
    device = resolve_device(device)
    theta = _to_device(theta, device)
    bounds = batch_bounds(_to_device(bounds, device), x1.shape[0])
    state = initialize(problem, theta, bounds, x1, u_init, options,
                       device=device)
    state = run(problem, bounds, state, theta, options, device=device,
                trace=trace)
    sol = _solution(state)
    return (sol, state) if return_state else sol


def iteration(problem: Problem, bounds: Bounds, s: SolverState, theta,
              options: Options, device=None) -> SolverState:
    """One outer iteration on every lane: derivatives -> backward -> errors
    -> {converged | barrier update | forward + accept}. The building block
    of `run`, which masks it per lane."""
    device = resolve_device(device)
    options = resolve_options(options, problem, device)
    s, theta = _to_device(s, device), _to_device(theta, device)
    bounds = batch_bounds(_to_device(bounds, device), s.x.shape[0])
    return _body(problem, bounds, theta, options, s)


def run(problem: Problem, bounds: Bounds, state: SolverState, theta,
        options: Options, k_limit=None, device=None,
        trace=None) -> SolverState:
    """The main iteration loop on an initialized state.

    `k_limit` (default options.max_iterations) bounds the iteration counter
    for this call, as an int for every lane or as an int tensor `[B]`, one
    limit per lane, clipped to options.max_iterations: a lane runs while its
    k is below its limit, and a lane that stops there unconverged gets
    status 8. Resuming `run` on the returned state with a higher limit
    continues the identical trajectory (the chunked loop's hook).

    With `options.verbose`, a table row of lane 0 is printed after every
    iteration whose counter is a multiple of `options.print_frequency`
    (`utils.printing`); its values come with the loop's one host read per
    iteration.

    `trace`, if given, is a list to which every iteration appends
    (stepped [B] bool, step_size [B], num_ls [B]): which lanes accepted a
    step in that iteration, at which step size and after how many counted
    line-search trials. The tensors stay on the device; appending them
    costs no host synchronization."""
    device = resolve_device(device)
    options = resolve_options(options, problem, device)
    state, theta = _to_device(state, device), _to_device(theta, device)
    bounds = batch_bounds(_to_device(bounds, device), state.x.shape[0])
    if k_limit is None:
        k_limit = options.max_iterations
    if isinstance(k_limit, torch.Tensor):
        k_limit = torch.clamp(k_limit.to(device=device, dtype=torch.int32),
                              max=options.max_iterations)
    else:
        k_limit = min(int(k_limit), options.max_iterations)

    if options.verbose:
        from .utils.printing import iteration_logger, row_values
    stepped = None                  # the lanes the last iteration ran
    while True:
        active = ((state.k < k_limit) & (state.status == 0)
                  & ~state.converged)
        if options.verbose and stepped is not None:
            # lane 0's row of the last iteration rides on the loop's read
            host = torch.cat([active.any().reshape(1).to(torch.float64),
                              row_values(state, stepped)]).tolist()
            iteration_logger(host[1:], options)
            go = bool(host[0])
        else:
            go = bool(active.any())           # host sync, once per iteration
        if not go:
            break
        new = _body(problem, bounds, theta, options, state)
        if trace is not None:
            trace.append((active & (new.k > state.k), new.step_size,
                          new.num_ls))
        state = select_state(active, new, state)
        stepped = active

    hit_limit = (~state.converged & (state.status == 0)
                 & (state.k >= k_limit))
    return state._replace(status=torch.where(
        hit_limit, torch.full_like(state.status, 8), state.status))


def _body(problem: Problem, bounds: Bounds, theta, options: Options,
          s: SolverState) -> SolverState:
    tol = options.optimality_tolerance
    num_bounds = bounds.num_bounds
    deriv = evaluate_derivatives(
        problem, theta, s.x, s.u, s.phi,
        quasi_newton=options.quasi_newton)
    c_rel = relax_constraints(problem, s.c_raw, s.mu)
    nominal = (c_rel, s.il, s.iu, s.phi, s.zl, s.zu)
    # costate first, then pre-contract the dynamics Hessians vectorized over
    # (B, T) — the backward sweep never sees the full [nx, nz, nz] tensor
    lam = costate_scan(deriv, s.phi)
    if options.quasi_newton:
        second = None
    else:
        second = deriv.cH_phi + contract_dynamics_hessian(
            problem, theta, s.x, s.u, lam[:, 1:])
    bw = backward_pass(problem, deriv, nominal, s.mu, s.reg_last,
                       options, lam=lam, second=second)
    s = s._replace(lam=bw.lam, reg_last=bw.reg)

    d_inf = dual_error(problem, deriv, bounds,
                       s.phi, s.zl, s.zu, s.lam, options)
    p_inf = (c_rel.abs().flatten(1).amax(dim=1) if c_rel[0].numel()
             else torch.zeros_like(s.mu))
    cs0 = cs_error(bounds, s.il, s.iu, s.zl, s.zu, 0.0, options)
    cs_mu = cs_error(bounds, s.il, s.iu, s.zl, s.zu, s.mu, options)
    opt_err_0 = torch.maximum(torch.maximum(d_inf, cs0), p_inf)
    opt_err_mu = torch.maximum(torch.maximum(d_inf, cs_mu), p_inf)
    s = s._replace(primal_inf=p_inf, dual_inf=d_inf, cs_inf=cs0)

    converged = opt_err_0 < tol
    backward_failed = bw.status != 0
    barrier_branch = ((opt_err_mu <= options.kappa_eps * s.mu)
                      & (num_bounds > 0) & (s.mu > tol / 10.0))

    def do_barrier(s: SolverState):
        # mu <- max(tol/10, min(kappa_mu mu, mu^theta_mu)); reset filter;
        # refresh merit measures; skip the forward pass
        # (reference: src/solve.jl:61-73).
        mu_new = torch.clamp(
            torch.minimum(options.kappa_mu * s.mu, s.mu ** options.theta_mu),
            min=tol / 10.0)
        c_rel_new = relax_constraints(problem, s.c_raw, mu_new)
        L_new, J = barrier_lagrangian(
            problem, theta, bounds, s.x, s.u, c_rel_new,
            s.phi, s.il, s.iu, mu_new)
        theta_new = c_rel_new.abs().sum(dim=(1, 2))
        return s._replace(
            mu=mu_new,
            filter_pts=_reset_filter(s.filter_pts, s.max_primal_1),
            filter_n=torch.ones_like(s.filter_n),
            L_curr=L_new, theta_curr=theta_new, objective=J,
            j=s.j + 1)

    # lanes whose forward result the selects below throw away: they run no
    # backtracking trial. (At a converged point, or at the optimum of a
    # barrier subproblem, the step is zero and the line search would halve
    # down to machine eps on rounding noise, with every lane rolled out
    # again for each of its trials.)
    unused = converged | backward_failed | barrier_branch

    def do_forward(s: SolverState):
        ls_args = (problem, theta, bounds, bw.gains, _nominal_trial(s),
                   bw.dL, s.mu, s.theta_curr, s.L_curr, s.min_primal_1,
                   s.filter_pts, options)
        if options.ls_speculative == 0:
            fw = forward_pass(*ls_args, skip=unused)
        elif options.ls_spec_continue:
            fw = forward_pass_hybrid(*ls_args, skip=unused)
        else:
            fw = forward_pass_speculative(*ls_args)

        def accept(s: SolverState):
            t = fw.trial
            aug = (~fw.armijo_passed) & (~fw.switching)
            fpts_aug, fn_aug = _augment_filter(
                s.filter_pts, s.filter_n, s.theta_curr, s.L_curr, options)
            fpts = torch.where(_lane(aug, fpts_aug), fpts_aug, s.filter_pts)
            fn = torch.where(aug, fn_aug, s.filter_n)
            return s._replace(
                x=t.x, u=t.u, c_raw=t.c_raw, il=t.il, iu=t.iu,
                phi=t.phi, zl=t.zl, zu=t.zu,
                objective=fw.objective,
                L_curr=fw.L_next, theta_curr=fw.theta_next,
                filter_pts=fpts, filter_n=fn,
                k=s.k + 1, num_ls=fw.num_ls, step_size=fw.step_size)

        def reject(s: SolverState):
            failed = s._replace(status=fw.status)
            if options.ls_failure_resets > 0:
                # robustness extension: a saturated filter can block every
                # step near convergence; resetting it and retrying is
                # bounded by ls_failure_resets
                can_reset = s.ls_resets < options.ls_failure_resets
                return select_state(
                    can_reset,
                    s._replace(
                        filter_pts=_reset_filter(s.filter_pts,
                                                 s.max_primal_1),
                        filter_n=torch.ones_like(s.filter_n),
                        ls_resets=s.ls_resets + 1),
                    failed)
            return failed

        return select_state(fw.status == 0, accept(s), reject(s))

    s_active = select_state(barrier_branch, do_barrier(s), do_forward(s))
    return select_state(
        backward_failed,
        s._replace(status=torch.ones_like(s.status)),
        select_state(converged,
                     s._replace(converged=torch.ones_like(s.converged)),
                     s_active))
