"""Forward pass: feedback rollout + fraction-to-boundary + filter line search
(PyTorch port, batch-first).

Counterpart of `ipddp2tpu/forward.py` (reference: src/forward_pass.jl:1-153).
The rollout applies the affine update rule from the backward pass

    u  = u_bar  + gamma*alpha + beta  (x - x_bar)
    phi= phi_bar+ gamma*psi   + omega (x - x_bar)
    zl = zl_bar + gamma*chi_l + zeta_l(x - x_bar)
    zu = zu_bar + gamma*chi_u + zeta_u(x - x_bar)
    x' = f(x, u)

as a T-step host loop over `[B, ...]` tensors with the model's dynamics under
`vmap` (on a GPU: captured once as a CUDA graph and replayed), or as one
launch of the forward-trial kernel. The backtracking gamma <- gamma/2 line
search is a host loop with
per-lane masks applying, in order, the same acceptance gauntlet as the
reference:

  1. finiteness of the rollout (reference: src/forward_pass.jl:18-24),
  2. fraction-to-boundary on (il, iu, zl, zu) vs tau = max(tau_min, 1 - mu)
     (reference: src/forward_pass.jl:26-27,59-85),
  3. filter acceptability on (theta, L) (reference: src/forward_pass.jl:36-37),
  4. switching + Armijo, else sufficient-progress (reference:
     src/forward_pass.jl:40-49).

Lanes that accepted keep their trial while the others go on halving; a lane
that never accepts ends with the last trial it tried and status 7.

The speculative search (`forward_pass_speculative`) evaluates the K largest
step sizes 2^-0..2^-(K-1) of every lane at once and takes the first that the
same gauntlet accepts; the hybrid search (`forward_pass_hybrid`) then goes on
backtracking from 2^-K for the lanes where none was accepted, so it picks
the step that pure backtracking picks. Both have two routes. The plain route
rolls the K candidates out as a `[B*K]` batch of `rollout`. The kernel route
(`ops/forward_cuda.py`) takes the measures of all candidates from one launch
of the forward-metrics kernel, decides, and rolls the chosen step of every
lane out with one launch of the forward-trial kernel, which also serves the
backtracking trials. One function, `acceptance`, decides for every route.

The filter is a fixed-capacity ring buffer of (theta_f, L_f) pairs per lane —
empty slots hold +inf so they can never block.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from .backward import Gains
from .derivatives import (batched_dynamics, evaluate_constraints,
                          evaluate_objective, relax_constraints)
from .graphs import Graphed
from .ops.forward_cuda import forward_metrics_cuda, forward_trial_cuda
from .options import Options
from .problem import Bounds, Problem

Tensor = torch.Tensor


class Trial(NamedTuple):
    """A candidate iterate produced by one rollout."""

    x: Tensor       # [B, T+1, nx]
    u: Tensor       # [B, T, nu]
    c_raw: Tensor   # [B, T, nc] un-relaxed constraint values
    il: Tensor      # [B, T, nu]
    iu: Tensor      # [B, T, nu]
    phi: Tensor     # [B, T, nc]
    zl: Tensor      # [B, T, nu]
    zu: Tensor      # [B, T, nu]


class ForwardResult(NamedTuple):
    trial: Trial
    theta_next: Tensor   # [B] constraint violation 1-norm of accepted iterate
    L_next: Tensor       # [B] barrier Lagrangian of accepted iterate
    objective: Tensor    # [B] objective of accepted iterate
    step_size: Tensor    # [B]
    num_ls: Tensor       # [B] int32 line-search counter (reference: data.l)
    status: Tensor       # [B] int32: 0 accepted, 7 line search failed
    armijo_passed: Tensor
    switching: Tensor


def _lane(mask: Tensor, like: Tensor) -> Tensor:
    """[B] mask broadcast against a [B, ...] tensor."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _rollout_tensors(problem: Problem):
    """The rollout of `problem` as a function of flat tensors
    (theta leaves..., lower, upper, 8 gains, x, u, phi, zl, zu, gamma) ->
    the 8 Trial tensors; what `graphs.Graphed` captures."""
    T, nu, nc = problem.T, problem.nu, problem.nc
    step = batched_dynamics(problem)

    def fn(theta, lower, upper, alpha, beta, psi, omega, chi_l, zeta_l,
           chi_u, zeta_u, nominal_x, nominal_u, nominal_phi, nominal_zl,
           nominal_zu, gamma):
        g = gamma[:, None, None]
        # the four update laws share (x - x_bar): their feedback matrices
        # are stacked and applied as one product per stage
        # rows: u (nu) | phi (nc) | zl (nu) | zu (nu)
        ff = torch.cat([nominal_u, nominal_phi, nominal_zl, nominal_zu],
                       dim=-1) \
            + g * torch.cat([alpha, psi, chi_l, chi_u], dim=-1)
        fb = torch.cat([beta, omega, zeta_l, zeta_u], dim=-2)  # [B,T,R,nx]

        x_t = nominal_x[:, 0]
        xs, rows = [x_t], []
        for t in range(T):
            dx = x_t - nominal_x[:, t]
            row = ff[:, t] + (fb[:, t] @ dx[..., None])[..., 0]
            x_t = step(x_t, row[:, :nu], t, theta)
            xs.append(x_t)
            rows.append(row)
        x = torch.stack(xs, dim=1)
        rows = torch.stack(rows, dim=1)
        u, phi, zl, zu = torch.split(rows, [nu, nc, nu, nu], dim=-1)
        c_raw = evaluate_constraints(problem, theta, x, u)
        return (x, u, c_raw, u - lower, upper - u, phi, zl, zu)

    return fn


@lru_cache(maxsize=64)
def _rollout_graphed(problem: Problem, theta_spec):
    """Per problem (and structure of theta): the rollout on flattened theta
    leaves, replayed from a CUDA graph for CUDA tensors."""
    fn = _rollout_tensors(problem)
    n_leaves = 0 if theta_spec is None else theta_spec.num_leaves

    def flat(*args):
        leaves, rest = args[:n_leaves], args[n_leaves:]
        theta = (None if theta_spec is None
                 else pytree.tree_unflatten(list(leaves), theta_spec))
        return fn(theta, *rest)

    return Graphed(flat)


def forward_route(problem: Problem, options: Options, device) -> str:
    """"kernel" or "plain" for this problem, these options and the device
    the tensors lie on. `forward_kernel="cuda"` raises where the kernels
    cannot run; "auto" takes them for the speculative and hybrid search on
    a GPU when the problem names its device functions, and keeps the
    graph-replayed plain rollout for pure backtracking."""
    mode = options.forward_kernel
    if mode == "cuda":
        if device.type != "cuda":
            raise RuntimeError(
                'forward_kernel="cuda" needs tensors on a GPU, got '
                f'{device}; pass forward_kernel="torch" for the plain '
                "forward pass")
        if problem.device_model is None:
            raise ValueError(
                'forward_kernel="cuda": the problem names no device '
                "functions (Problem.device_model)")
        return "kernel"
    if (mode == "auto" and device.type == "cuda"
            and problem.device_model is not None
            and options.ls_speculative > 0):
        return "kernel"
    return "plain"


def rollout(problem: Problem, theta, bounds: Bounds, gains: Gains,
            nominal_x, nominal_u, nominal_phi, nominal_zl, nominal_zu,
            gamma, route: str = "plain") -> Trial:
    """Closed-loop rollout of the affine update rule at per-lane step size
    gamma `[B]`.

    Plain route: a T-step host loop with the dynamics under `vmap`. It has
    no host synchronization, so on a GPU the whole chain of launches is
    captured once into a CUDA graph and replayed. Kernel route: one launch
    of the forward-trial kernel, with the nominal slacks recomputed from the
    bounds (the trial does not depend on them)."""
    if route == "kernel":
        lo, hi = bounds.lower, bounds.upper
        zero = torch.zeros_like(gamma)
        x, u, phi, zl, zu, il, iu, c_raw = forward_trial_cuda(
            problem, theta, lo, hi, tuple(gains), nominal_x, nominal_u,
            nominal_phi, nominal_zl, nominal_zu, nominal_u - lo,
            hi - nominal_u, zero, zero, gamma)
        return Trial(x=x, u=u, c_raw=c_raw, il=il, iu=iu, phi=phi, zl=zl,
                     zu=zu)
    if theta is None:
        leaves, spec = [], None
    else:
        leaves, spec = pytree.tree_flatten(theta)
    out = _rollout_graphed(problem, spec)(
        *leaves, bounds.lower, bounds.upper, *gains, nominal_x, nominal_u,
        nominal_phi, nominal_zl, nominal_zu, gamma)
    return Trial(*out)


def fraction_to_boundary_ok(trial: Trial, nominal_il, nominal_iu,
                            nominal_zl, nominal_zu, tau) -> Tensor:
    """Per-lane check (1 - tau) * nominal <= current on il, iu, zl, zu
    (reference: src/forward_pass.jl:59-85). Entries at infinite bounds hold
    +inf (slacks) or 0 (duals) on both sides and pass vacuously."""
    s = (1.0 - tau)[:, None, None]

    def ok(nom, cur):
        return ~(s * nom > cur).flatten(1).any(dim=1)

    return (ok(nominal_il, trial.il) & ok(nominal_iu, trial.iu)
            & ok(nominal_zl, trial.zl) & ok(nominal_zu, trial.zu))


def barrier_lagrangian(problem: Problem, theta, bounds: Bounds,
                       trial_x, trial_u, c_rel, phi, il, iu, mu):
    """L = J + sum <c, phi> - mu * (sum log il + sum log iu) over finite bounds
    (reference: src/data/methods.jl:34-67). Returns (L [B], J [B])."""
    J = evaluate_objective(problem, theta, trial_x, trial_u)
    ml = bounds.mask_lower
    mu_mask = bounds.mask_upper
    one = torch.ones_like(il)
    zero = torch.zeros_like(il)
    log_l = torch.where(ml, torch.log(torch.where(ml, il, one)),
                        zero).sum(dim=(1, 2))
    log_u = torch.where(mu_mask, torch.log(torch.where(mu_mask, iu, one)),
                        zero).sum(dim=(1, 2))
    L = J + (c_rel * phi).sum(dim=(1, 2)) - mu * (log_l + log_u)
    return L, J


def filter_blocks(filter_pts: Tensor, theta, L) -> Tensor:
    """True where (theta, L), `[B, K]` candidates, is dominated by any
    filter point of its lane (reference: src/forward_pass.jl:36).
    filter_pts: [B, CAP, 2], empty slots +inf."""
    return ((theta[:, :, None] >= filter_pts[:, None, :, 0])
            & (L[:, :, None] >= filter_pts[:, None, :, 1])).any(dim=-1)


def _all_finite(a: Tensor) -> Tensor:
    return torch.isfinite(a).flatten(1).all(dim=1)


def _measures(problem: Problem, theta, bounds: Bounds, trial: Trial,
              nominal: Trial, mu, tau):
    """(theta, L, J, finite, ftb_ok), each [B], of a rolled-out trial: what
    the forward-metrics kernel computes without writing the trial."""
    finite = (_all_finite(trial.x) & _all_finite(trial.u)
              & _all_finite(trial.phi) & _all_finite(trial.zl)
              & _all_finite(trial.zu) & _all_finite(trial.c_raw))
    frac_ok = fraction_to_boundary_ok(
        trial, nominal.il, nominal.iu, nominal.zl, nominal.zu, tau)
    c_rel = relax_constraints(problem, trial.c_raw, mu)
    th = c_rel.abs().sum(dim=(1, 2))
    L, J = barrier_lagrangian(problem, theta, bounds, trial.x, trial.u,
                              c_rel, trial.phi, trial.il, trial.iu, mu)
    return th, L, J, finite, frac_ok


def acceptance(th, L, finite, ftb, gamma, dL, theta_prev, L_prev,
               min_primal_1, filter_pts, options: Options):
    """Step acceptance for `[B, K]` candidates (reference:
    src/forward_pass.jl:36-49): filter, switching + Armijo, else sufficient
    progress. `th`, `L`, `finite`, `ftb` are `[B, K]`, `gamma` broadcasts
    against them (`[K]` shared, or `[B, 1]` per lane), the rest is `[B]`.
    Returns (accept, counted, armijo, switching), each `[B, K]`. Every line
    search of the package decides here."""
    eps = torch.finfo(th.dtype).eps
    col = lambda a: a[:, None]
    blocked = filter_blocks(filter_pts, th, L)
    switching = col(dL < 0.0) & (
        torch.clamp(-gamma * col(dL), min=0.0) ** options.s_L
        * gamma ** (1.0 - options.s_L)
        > col(options.delta * theta_prev ** options.s_theta)
    )
    armijo = (L - col(L_prev) - col(10.0 * eps * L_prev.abs())
              <= options.eta_L * gamma * col(dL))
    suff = ((th <= col((1.0 - options.gamma_theta) * theta_prev))
            | (L <= col(L_prev - options.gamma_L * theta_prev)))
    use_armijo = (th <= col(min_primal_1)) & switching
    decrease_ok = torch.where(use_armijo, armijo, suff)

    accept = finite & ftb & ~blocked & decrease_ok
    # The reference increments the line-search counter only on
    # filter/acceptance failures, not rollout or boundary failures
    # (reference: src/forward_pass.jl:37,49).
    counted = finite & ftb & ~accept
    return accept, counted, armijo, switching


def forward_pass(problem: Problem, theta, bounds: Bounds, gains: Gains,
                 nominal: Trial, dL, mu, theta_prev, L_prev,
                 min_primal_1, filter_pts, options: Options,
                 gamma0=None, skip=None, num_ls0=None,
                 route=None) -> ForwardResult:
    """Backtracking line search (reference: src/forward_pass.jl:1-57).

    `gamma0`/`skip`/`num_ls0` are the hooks of the hybrid continuation
    (`forward_pass_hybrid`): start backtracking at `gamma0` (a float)
    instead of 1,
    run zero trials where `skip` is True (the speculative pass already
    accepted), and seed the trial counter. `route` ("kernel" or "plain")
    overrides the choice `forward_route` makes from the options."""
    dtype, device = nominal.u.dtype, nominal.u.device
    B = nominal.u.shape[0]
    eps = torch.finfo(dtype).eps
    min_step = max(eps, options.ls_min_step)
    tau = torch.clamp(1.0 - mu, min=options.tau_min)
    route = route or forward_route(problem, options, device)

    def try_step(gamma):
        trial = rollout(problem, theta, bounds, gains, nominal.x, nominal.u,
                        nominal.phi, nominal.zl, nominal.zu, gamma,
                        route=route)
        th, L, J, finite, frac_ok = _measures(problem, theta, bounds, trial,
                                              nominal, mu, tau)
        one = lambda a: a[:, None]
        accept, counted, armijo, switching = (a[:, 0] for a in acceptance(
            one(th), one(L), one(finite), one(frac_ok), one(gamma), dL,
            theta_prev, L_prev, min_primal_1, filter_pts, options))
        return trial, th, L, J, accept, counted, armijo, switching

    zeros = torch.zeros((B,), dtype=dtype, device=device)
    false = torch.zeros((B,), dtype=torch.bool, device=device)
    # a fill, not a copy from the host: no synchronization
    gamma = torch.full_like(zeros, 1.0 if gamma0 is None else float(gamma0))
    num_ls = (torch.zeros((B,), dtype=torch.int32, device=device)
              if num_ls0 is None
              else torch.as_tensor(num_ls0, dtype=torch.int32,
                                   device=device).expand(B).clone())
    do_skip = (false if skip is None
               else torch.as_tensor(skip, dtype=torch.bool,
                                    device=device).expand(B))
    done = false
    trial = Trial(*(torch.zeros_like(a) for a in nominal))
    th, L, J = zeros, zeros, zeros
    armijo, switching = false, false

    while True:
        active = ~do_skip & ~done & (gamma >= min_step)
        if not bool(active.any()):                 # host sync, once per trial
            break
        # every lane is rolled out at its own gamma; only the active lanes
        # take the result
        new = try_step(gamma)
        n_trial, n_th, n_L, n_J, accept, counted, n_armijo, n_switching = new
        trial = Trial(*(torch.where(_lane(active, a), a, b)
                        for a, b in zip(n_trial, trial)))
        th = torch.where(active, n_th, th)
        L = torch.where(active, n_L, L)
        J = torch.where(active, n_J, J)
        armijo = torch.where(active, n_armijo, armijo)
        switching = torch.where(active, n_switching, switching)
        num_ls = num_ls + (active & counted).to(torch.int32)
        done = torch.where(active, accept, done)
        gamma = torch.where(active & ~accept, gamma * 0.5, gamma)

    status = torch.where(done, 0, 7).to(torch.int32)
    return ForwardResult(trial=trial, theta_next=th, L_next=L, objective=J,
                         step_size=gamma, num_ls=num_ls, status=status,
                         armijo_passed=armijo, switching=switching)


@lru_cache(maxsize=32)
def _candidate_steps(K: int, dtype, device) -> Tensor:
    """2^-0 .. 2^-(K-1), descending: exact powers of two, like the halved
    steps of the backtracking loop (a device `pow` may be an ulp off, so
    they are built on the host). Made once per (K, dtype, device) and
    shared: a copy to the device per call would synchronize; nobody writes
    to it."""
    return torch.tensor([0.5 ** i for i in range(K)], dtype=dtype,
                        device=device)


def forward_pass_speculative(problem: Problem, theta, bounds: Bounds,
                             gains: Gains, nominal: Trial, dL, mu,
                             theta_prev, L_prev, min_primal_1, filter_pts,
                             options: Options, route=None) -> ForwardResult:
    """Speculative line search: evaluate the step sizes gamma = 2^-i,
    i < ls_speculative, of every lane at once and take the largest one the
    acceptance gauntlet of `forward_pass` accepts. A lane where none passes
    ends with status 7, the trial at step 1, and all its counted trials in
    `num_ls` (so that the hybrid continuation counts on from there)."""
    K = options.ls_speculative
    dtype, device = nominal.u.dtype, nominal.u.device
    B = nominal.u.shape[0]
    tau = torch.clamp(1.0 - mu, min=options.tau_min)
    gammas = _candidate_steps(K, dtype, device)
    route = route or forward_route(problem, options, device)
    kernel_args = (problem, theta, bounds.lower, bounds.upper, tuple(gains),
                   nominal.x, nominal.u, nominal.phi, nominal.zl, nominal.zu,
                   nominal.il, nominal.iu, mu, tau)

    if route == "kernel":
        th, L, J, finite, ftb = forward_metrics_cuda(*kernel_args, gammas)
    else:
        # the K candidates of a lane are K lanes of one plain rollout
        rep = lambda a: a.repeat_interleave(K, dim=0)
        bounds_k = Bounds(rep(bounds.lower), rep(bounds.upper))
        nominal_k = Trial(*(rep(a) for a in nominal))
        theta_k = None if theta is None else pytree.tree_map(rep, theta)
        trials = rollout(problem, theta_k, bounds_k,
                         Gains(*(rep(g) for g in gains)), nominal_k.x,
                         nominal_k.u, nominal_k.phi, nominal_k.zl,
                         nominal_k.zu, gammas.repeat(B))
        th, L, J, finite, ftb = (a.reshape(B, K) for a in _measures(
            problem, theta_k, bounds_k, trials, nominal_k, rep(mu),
            rep(tau)))

    accept, counted, armijo, switching = acceptance(
        th, L, finite, ftb, gammas, dL, theta_prev, L_prev, min_primal_1,
        filter_pts, options)
    found = accept.any(dim=1)
    # first (largest) accepted step; 0, the full step, where none was
    idx = accept.to(torch.int8).argmax(dim=1)
    before = torch.arange(K, device=device)[None, :] < idx[:, None]
    num_ls = torch.where(found, (counted & before).sum(dim=1),
                         counted.sum(dim=1)).to(torch.int32)
    gamma_sel = gammas[idx]

    if route == "kernel":
        x, u, phi, zl, zu, il, iu, c_raw = forward_trial_cuda(
            *kernel_args, gamma_sel)
        trial = Trial(x=x, u=u, c_raw=c_raw, il=il, iu=iu, phi=phi, zl=zl,
                      zu=zu)
    else:
        lanes = torch.arange(B, device=device)
        trial = Trial(*(a.reshape((B, K) + a.shape[1:])[lanes, idx]
                        for a in trials))
    take = lambda a: a.gather(1, idx[:, None])[:, 0]
    return ForwardResult(
        trial=trial, theta_next=take(th), L_next=take(L), objective=take(J),
        step_size=gamma_sel, num_ls=num_ls,
        status=torch.where(found, 0, 7).to(torch.int32),
        armijo_passed=take(armijo), switching=take(switching))


def forward_pass_hybrid(problem: Problem, theta, bounds: Bounds,
                        gains: Gains, nominal: Trial, dL, mu,
                        theta_prev, L_prev, min_primal_1, filter_pts,
                        options: Options, route=None,
                        skip=None) -> ForwardResult:
    """Hybrid line search: the K = ls_speculative largest candidates at
    once, then backtracking goes on from 2^-K for the lanes where none was
    acceptable (and that `skip`, a `[B]` mask of lanes whose result the
    caller does not use, leaves in).

    It accepts what pure backtracking (`forward_pass`) accepts: the largest
    acceptable gamma of the same 2^-i sequence under the same tests; only
    the schedule of the evaluations differs. The continuation runs no trial
    (one host synchronization) unless some lane backtracks below 2^-K."""
    spec = forward_pass_speculative(problem, theta, bounds, gains, nominal,
                                    dL, mu, theta_prev, L_prev, min_primal_1,
                                    filter_pts, options, route=route)
    found = spec.status == 0
    seq = forward_pass(problem, theta, bounds, gains, nominal, dL, mu,
                       theta_prev, L_prev, min_primal_1, filter_pts, options,
                       gamma0=0.5 ** options.ls_speculative,
                       skip=found if skip is None else found | skip,
                       num_ls0=spec.num_ls, route=route)
    pick = lambda a, b: torch.where(_lane(found, a), a, b)
    merged = [pick(a, b) for a, b in zip(spec[1:], seq[1:])]
    return ForwardResult(
        Trial(*(pick(a, b) for a, b in zip(spec.trial, seq.trial))), *merged)
