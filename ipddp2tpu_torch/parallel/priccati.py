"""Time-parallel backward pass: the associative-scan Riccati recursion
(PyTorch port, batch-first).

Counterpart of `ipddp2tpu/parallel/priccati.py`. The sequential backward
pass walks the horizon one stage at a time (reference:
src/backward_pass.jl:58); this one re-derives it as an associative scan
(the temporal parallelization of LQT by Särkkä & García-Fernández). Given
the current iterate, every condensed stage defines a linear-fractional map
on the quadratic value function V(dx) = 1/2 dx' J dx - eta' dx. With the
stage's local primal-dual block (controls and equality duals, the barrier
Sigma terms and the second-order contractions folded in)

    S = [ H_loc + reg I   cu'    ]     F = [fu  0]      G = [ M  ]
        [ cu             -d_c I  ]                          [ cx ]

the stage element is the 5-tuple

    A   = fx - F S^{-1} G          (closed-loop transition)
    b   = -F S^{-1} r              (feedforward offset),   r = [r_u; c]
    C   = F S^{-1} F'              (control-induced value curvature)
    J   = Q - G' S^{-1} G          (cost-to-go curvature seed)
    eta = -(r_x - G' S^{-1} r)     (cost-to-go gradient seed)

and value propagation composes by the parallel-LQT rule, which is
associative: the suffix value functions of all stages come out of
O(log T) levels of batched combines (`backward._associative_scan`, the
pairing of `jax.lax.associative_scan`). The gains are then recovered by one
batched KKT solve per stage against the scanned V_{t+1}, the same systems
the sequential pass factors, with the pivoted LDL^T of `ops/ldlt.py`,
refinement and the residual gate; the inertia check (n_pos == nu per
stage) becomes a batched post-check and a failing attempt bumps the
regularization through the same ladder as the sequential pass
(`backward.regularization_ladder`).

As in the JAX package, this pass always takes the pivoted LDL^T for the
gains (whatever `inertia_method` says) and reaches no kernel: it is
batched tensor code, `torch.linalg.solve_ex` where the JAX package calls
`jnp.linalg.solve`. In exact arithmetic it reproduces the sequential pass
gain for gain; the compositions can lose accuracy on ill-conditioned
stages, so the mode is opt-in (`Options(backward_mode="parallel")`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..backward import (BackwardResult, Gains, _associative_scan, _mv,
                        costate_scan, regularization_ladder,
                        second_order_terms)
from ..derivatives import DerivativeBundle
from ..ops.ldlt import ldlt_factor_pivoted, ldlt_solve_refined
from ..options import Options
from ..problem import Problem

Tensor = torch.Tensor


class ValueElement(NamedTuple):
    A: Tensor     # [B, T, nx, nx]
    b: Tensor     # [B, T, nx]
    C: Tensor     # [B, T, nx, nx]
    eta: Tensor   # [B, T, nx]
    J: Tensor     # [B, T, nx, nx]


def _t(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _solve(A: Tensor, B: Tensor) -> Tensor:
    """A^{-1} B for batched A, as `jnp.linalg.solve` computes it (LU with
    partial pivoting): a singular A gives non-finite values, which the
    gains' finiteness check turns into a failed attempt, and no error (nor
    a host synchronization to look for one)."""
    return torch.linalg.solve_ex(A, B)[0]


def combine(a, b) -> ValueElement:
    """Associative composition of value elements (any leading axes).

    Elements are stored in reverse time order (scan index 0 = the terminal
    element, index k = stage T-k), so the first operand `a` is the
    terminal-side accumulation (subscript j) and `b` the earlier-in-time
    stage applied to it (subscript i): Lemma 10 of Särkkä &
    García-Fernández (2021). The two systems against (I + C_i J_j) and its
    transpose are solved once each, for all their right-hand sides."""
    Aj, bj, Cj, etaj, Jj = a
    Ai, bi, Ci, etai, Ji = b
    nx = Ai.shape[-1]
    eye = torch.eye(nx, dtype=Ai.dtype, device=Ai.device)
    M = eye + Ci @ Jj
    X = _solve(
        M, torch.cat([Ai, bi[..., None] + Ci @ etaj[..., None], Ci], dim=-1))
    Y = _solve(
        _t(M), torch.cat([etaj[..., None] - Jj @ bi[..., None], Jj @ Ai],
                         dim=-1))
    A = Aj @ X[..., :nx]
    b_ = (Aj @ X[..., nx:nx + 1])[..., 0] + bj
    C = Aj @ X[..., nx + 1:] @ _t(Aj) + Cj
    eta = (_t(Ai) @ Y[..., :1])[..., 0] + etai
    J = _t(Ai) @ Y[..., 1:] + Ji
    # C and J are symmetric in exact arithmetic; like the sequential Vxx
    # recursion, compositions amplify roundoff asymmetry geometrically
    # unless it is projected out each step.
    return ValueElement(A, b_, 0.5 * (C + _t(C)), eta, 0.5 * (J + _t(J)))


def _stage_blocks(problem: Problem, deriv: DerivativeBundle, nominal,
                  mu: Tensor, second, reg: Tensor, delta_c: Tensor,
                  options: Options) -> ValueElement:
    """The stage elements `[B, T, ...]`: the condensation of the sequential
    sweep WITHOUT the fu' Vxx' fu coupling, which arises through
    composition. `second` is the pre-contracted lam . d2f + phi . d2c
    `[B, T, nz, nz]` (unused in quasi-Newton mode); mu, reg, delta_c are
    `[B]`."""
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    c_rel, il, iu, phi, zl, zu = nominal
    B, T = il.shape[0], il.shape[1]
    lane = lambda v: v[:, None, None, None]
    mu_ = mu[:, None, None]
    sl = 1.0 / il
    su = 1.0 / iu
    sig = zl * sl + zu * su

    Q, Mx = deriv.lxx, deriv.lux
    R = deriv.luu + torch.diag_embed(sig)
    if not options.quasi_newton:
        Q = Q + second[..., :nx, :nx]
        Mx = Mx + second[..., nx:, :nx]
        R = R + second[..., nx:, nx:]
    R = R + lane(reg) * torch.eye(nu, dtype=R.dtype, device=R.device)

    r_u = deriv.lu + _mv(deriv.cu, phi) - mu_ * sl + mu_ * su
    r_x = deriv.lx + _mv(deriv.cx, phi)

    m = nu + nc
    S = R.new_zeros((B, T, m, m))
    S[..., :nu, :nu] = R
    if nc > 0:
        S[..., :nu, nu:] = _t(deriv.cu)
        S[..., nu:, :nu] = deriv.cu
        S[..., nu:, nu:] = -lane(delta_c) * torch.eye(
            nc, dtype=R.dtype, device=R.device)
    F = torch.cat([deriv.fu, R.new_zeros((B, T, nx, nc))], dim=-1)
    G = torch.cat([Mx, deriv.cx], dim=-2)                     # [B,T,m,nx]
    r = torch.cat([r_u, c_rel], dim=-1)                       # [B,T,m]

    X = _solve(S, torch.cat([G, _t(F), r[..., None]], dim=-1))
    SiG, SiF, Sir = X[..., :nx], X[..., nx:2 * nx], X[..., 2 * nx:]
    return ValueElement(
        A=deriv.fx - F @ SiG,
        b=-(F @ Sir)[..., 0],
        C=F @ SiF,
        eta=-(r_x - (_t(G) @ Sir)[..., 0]),
        J=Q - _t(G) @ SiG)


def parallel_value_scan(problem: Problem, elements: ValueElement, lTx,
                        lTxx):
    """Suffix value functions V_{t+1} for every stage by the associative
    scan. Returns (Vx [B, T, nx], Vxx [B, T, nx, nx]), entry t the value at
    stage t+1 (what the stage-t KKT needs): V_T = terminal at t = T-1."""
    seq = _terminal_first(elements, lTx, lTxx)
    acc = ValueElement(*_associative_scan(combine, seq))
    # acc[k] composes stages T-k..T-1 with the terminal: V_{T-k}
    return (torch.flip(-acc.eta, dims=(1,)), torch.flip(acc.J, dims=(1,)))


def _terminal_first(elements: ValueElement, lTx, lTxx) -> ValueElement:
    """The scan's sequence: reverse time, the terminal element in front,
    the earliest stage's element dropped (its composition gives V_0, which
    nothing reads)."""
    term = ValueElement(A=torch.zeros_like(elements.A[:, 0]),
                        b=torch.zeros_like(elements.b[:, 0]),
                        C=torch.zeros_like(elements.C[:, 0]),
                        eta=-lTx, J=lTxx)
    return ValueElement(*(
        torch.cat([t[:, None], torch.flip(e, dims=(1,))[:, :-1]], dim=1)
        for t, e in zip(term, elements)))


def backward_pass_parallel(problem: Problem, deriv: DerivativeBundle,
                           nominal, mu: Tensor, reg_last: Tensor,
                           options: Options, *, lam=None, second=None,
                           value_scan=None) -> BackwardResult:
    """Drop-in time-parallel replacement for `backward.backward_pass`.

    O(log T) depth: costates -> stage elements (batched local solves) ->
    associative value scan -> one batched KKT factor and solve over all
    `[B, T]` stages for the gains, inside the same regularization ladder as
    the sequential pass. `value_scan` swaps the suffix-value evaluator
    (same contract as `parallel_value_scan`, the default):
    `timeshard.value_scan_timesharded` plugs in here for
    `backward_mode="timeshard"`."""
    nx, nu = problem.nx, problem.nu
    c_rel, il, iu, phi, zl, zu = nominal
    if lam is None:
        lam = costate_scan(deriv, phi)
    if second is None:
        second = second_order_terms(deriv, lam, options)
    vscan = value_scan or parallel_value_scan
    mu_ = mu[:, None, None]
    sl = 1.0 / il
    su = 1.0 / iu
    sig_l = zl * sl
    sig_u = zu * su
    base_Qu = deriv.lu + _mv(deriv.cu, phi)

    def attempt(reg, delta_c):
        elems = _stage_blocks(problem, deriv, nominal, mu, second, reg,
                              delta_c, options)
        Vx_n, Vxx_n = vscan(problem, elems, deriv.lTx, deriv.lTxx)
        fu, fx, cu = deriv.fu, deriv.fx, deriv.cu
        Qu = base_Qu + _mv(fu, Vx_n) - mu_ * sl + mu_ * su
        fuV = _t(fu) @ Vxx_n
        H = deriv.luu + torch.diag_embed(sig_l + sig_u) + fuV @ fu
        Bm = deriv.lux + fuV @ fx
        if not options.quasi_newton:
            Bm = Bm + second[..., nx:, :nx]
            H = H + second[..., nx:, nx:]
        H = H + reg[:, None, None, None] * torch.eye(
            nu, dtype=H.dtype, device=H.device)
        nc = problem.nc
        m = nu + nc
        K = H.new_zeros(H.shape[:2] + (m, m))
        K[..., :nu, :nu] = H
        if nc > 0:
            K[..., :nu, nu:] = _t(cu)
            K[..., nu:, :nu] = cu
            K[..., nu:, nu:] = -delta_c[:, None, None, None] * torch.eye(
                nc, dtype=H.dtype, device=H.device)
        rhs = torch.cat(
            [torch.cat([-Qu[..., None], -Bm], dim=-1),
             torch.cat([-c_rel[..., None], -deriv.cx], dim=-1)], dim=-2)
        factors = ldlt_factor_pivoted(K)
        X, solve_ok = ldlt_solve_refined(
            factors, K, rhs, refine_steps=options.refine_steps,
            check_residual=True, residual_rtol=options.kkt_residual_rtol)
        ok = factors.ok & (factors.n_pos == nu) & solve_ok        # [B, T]
        singular = factors.n_zero > 0
        alpha, beta = X[..., :nu, 0], X[..., :nu, 1:]
        psi, omega = X[..., nu:, 0], X[..., nu:, 1:]
        gains = Gains(alpha, beta, psi, omega,
                      mu_ * sl - zl - sig_l * alpha,
                      -sig_l[..., None] * beta,
                      mu_ * su - zu + sig_u * alpha,
                      sig_u[..., None] * beta)
        dL = ((Qu * alpha).sum(dim=-1)
              + (c_rel * psi).sum(dim=-1)).sum(dim=1)
        fail = ~ok.all(dim=1)
        # the reference latches delta_c from the first failing stage of its
        # reverse sweep (reference: src/inertia_correction.jl:263-273):
        # here the latest-in-time failing stage
        first = torch.argmax(torch.flip(~ok, dims=(1,)).to(torch.uint8),
                             dim=1, keepdim=True)
        singular_first = (torch.flip(singular, dims=(1,)).gather(1, first)
                          [:, 0] & fail)
        return gains, dL, fail, singular_first

    reg, delta_c, gains, dL, fail = regularization_ladder(
        attempt, mu, reg_last, options, il.dtype)
    return BackwardResult(gains=gains, lam=lam, dL=dL,
                          status=fail.to(torch.int32), reg=reg,
                          delta_c=delta_c)
