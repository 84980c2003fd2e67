"""Backward pass: Riccati-like recursion of per-stage primal-dual KKT solves
(PyTorch port, batch-first).

Counterpart of `ipddp2tpu/backward.py` (reference:
src/backward_pass.jl:1-195). Per stage, in reverse time, the sweep assembles
the condensed primal-dual KKT system

    K = [ H_hat + reg*I   cu^T      ]     rhs = -[ Qu_hat   B  ]
        [ cu             -delta_c*I ]            [ c        cx ]

with
    Sigma_L = zl / il,  Sigma_U = zu / iu
    Qu_hat  = lu + cu^T phi + fu^T Vx' - mu/il + mu/iu
    C       = lxx + fx^T Vxx' fx  (+ lam' . fxx + phi . cxx)
    H_hat   = luu + diag(Sigma_L + Sigma_U) + fu^T Vxx' fu (+ lam' . fuu + phi . cuu)
    B       = lux + fu^T Vxx' fx  (+ lam' . fux + phi . cux)

solves for the affine update rule [alpha beta; psi omega], derives the
bound-dual gains in closed form

    chi_l = mu/il - zl - Sigma_L alpha      zeta_l = -Sigma_L . beta
    chi_u = mu/iu - zu + Sigma_U alpha      zeta_u =  Sigma_U . beta

and propagates the value function

    Vxx = C + beta^T B + omega^T cx
    Vx  = lx + cx^T phi + beta^T Qu_hat + omega^T c + fx^T Vx'

(reference: src/backward_pass.jl:62-189). The inertia-correction escape hatch
— restart the whole sweep with a larger primal regularization whenever a
stage's KKT matrix has wrong inertia, and switch on the dual regularization
delta_c = options.delta_c * mu^kappa_c when it is singular — is a host loop
over the IPOPT-style ladder with per-lane masks (reference:
src/backward_pass.jl:55,191, src/inertia_correction.jl:257-276): every
attempt runs the whole batch, and only the lanes that were still failing
take the new attempt's result.

One sweep at fixed (mu, reg, delta_c) is `_run_pass`, the plain PyTorch
version, or — on a GPU — the hand-written kernel of `ops.backward_cuda`,
which computes the same function in one launch. Its inputs are prepared once
per backward pass (`prepare_sweep`) and every attempt of the ladder is one
launch on them (`sweep_prepared`): only reg and delta_c change in between.

The stage's KKT solve follows `options.inertia_method` as the JAX package's
scan branches on it (ipddp2tpu/backward.py:215-249): "ldl" (and an
unresolved "auto") the pivoted LDL^T with refinement and residual gate;
"bk" rook Bunch-Kaufman (`ops/bk.py`: ok = info == 0, singular = info > 0,
no gate); "eigh" the eigendecomposition oracle (no gate). The ldl and bk
solves each have an instantiation of the sweep kernel; eigh runs the plain
sweep only, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .derivatives import DerivativeBundle
from .ops.backward_cuda import prepare_sweep, sweep_prepared
from .ops.bk import bk_factor_rook, bk_inertia, bk_solve
from .ops.ldlt import (eigh_factor_and_inertia, eigh_solve,
                       ldlt_factor_pivoted, ldlt_solve_refined)
from .options import Options
from .problem import Problem

Tensor = torch.Tensor


class Gains(NamedTuple):
    """Affine update rule parameters, stacked over time (reference:
    src/data/update_rule.jl:68-84)."""

    alpha: Tensor    # [B, T, nu]      feedforward control
    beta: Tensor     # [B, T, nu, nx]  feedback control
    psi: Tensor      # [B, T, nc]      feedforward equality dual
    omega: Tensor    # [B, T, nc, nx]  feedback equality dual
    chi_l: Tensor    # [B, T, nu]      feedforward lower-bound dual
    zeta_l: Tensor   # [B, T, nu, nx]  feedback lower-bound dual
    chi_u: Tensor    # [B, T, nu]
    zeta_u: Tensor   # [B, T, nu, nx]


class BackwardResult(NamedTuple):
    gains: Gains
    lam: Tensor         # [B, T+1, nx] costates (nominal dynamics duals)
    dL: Tensor          # [B] expected Lagrangian change per unit step
    status: Tensor      # [B] int32: 0 ok, 1 backward failed
    reg: Tensor         # [B] regularization used by the accepted pass
    delta_c: Tensor     # [B] dual regularization used


def _mv(A: Tensor, v: Tensor) -> Tensor:
    """Batched A^T v: A [B, k, n], v [B, k] -> [B, n]."""
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


def _costate_seq(fx: Tensor, r_x: Tensor, lam_T: Tensor) -> Tensor:
    """Reverse host loop lam_t = r_t + fx_t' lam_{t+1}: [B, T+1, nx]."""
    lam = lam_T
    out = [lam]
    for t in range(r_x.shape[1] - 1, -1, -1):
        lam = r_x[:, t] + _mv(fx[:, t], lam)
        out.append(lam)
    out.reverse()
    return torch.stack(out, dim=1)


def _affine_comb(a, b):
    """The JAX package's `comb`: `a` the lower scan index (terminal side,
    the inner map), `b` the outer one; (M, v) composes as v -> M v + c."""
    Ma, va = a
    Mb, vb = b
    return Mb @ Ma, (Mb @ va[..., None])[..., 0] + vb


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (len(even) is
    len(odd) or one more)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems):
    """Inclusive scan of `_affine_comb` along dim 1 of the pair `elems`,
    by the recursion `jax.lax.associative_scan` runs
    (jax/_src/lax/control_flow/loops.py): combine the pairs [0:-1:2] with
    [1::2], scan the reduced sequence, combine its results but the last
    with elems[2::2] (all of them when the length is odd), put elems[0] in
    front and interleave. Every level is one batched product over
    [B, ., nx, nx], so the pairs are associated exactly as there."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _affine_comb(tuple(e[:, 0:-1:2] for e in elems),
                           tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _affine_comb(tuple(e[:, :-1] for e in odd),
                            tuple(e[:, 2::2] for e in elems))
    else:
        even = _affine_comb(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


COSTATE_MODES = ("auto", "seq", "assoc")


def costate_mode(mode: str, device=None) -> str:
    """The order "auto" resolves to on `device`. The JAX package takes
    "seq" on its accelerator (a TPU) and "assoc" on the CPU
    (ipddp2tpu/backward.py:138-139). The port does the same with its
    accelerator: "seq" on a GPU, "assoc" on the CPU, where both packages
    then walk the same iterate path.

    On the GPU the associative order is not the default because of
    pushing's 100-instance campaign (float64, tolerance 1e-7): in that
    order on an NVIDIA H100 80GB HBM3 (700 W) four instances of its batch
    end with a failed line search (94 of 100 solved; the campaign's gate is
    95), in the sequential one one does (97). From the state where each of
    the four fails, the next step fails again with the plain sweep, with
    the kernel, in either order, and on the CPU, and the four solved as a
    batch of their own converge: the card's rounding picks the path, not a
    fault of one component (PERF.md, ROADMAP.md)."""
    if mode not in COSTATE_MODES:
        raise ValueError(f"costate_scan: mode {mode!r} not in "
                         f"{COSTATE_MODES}")
    if mode != "auto":
        return mode
    on_gpu = device is not None and torch.device(device).type == "cuda"
    return "seq" if on_gpu else "assoc"


def costate_scan(deriv: DerivativeBundle, phi: Tensor,
                 mode: str = "auto") -> Tensor:
    """Costate refresh lam_t = r_x + fx' lam_{t+1} (reference:
    src/backward_pass.jl:183,189), evaluated BEFORE the backward sweep so
    the dynamics Hessians can be pre-contracted outside the sequential
    sweep. Returns [B, T+1, nx].

    Two evaluation orders, as in the JAX package's `costate_scan`, with
    identical math up to reassociation (which moves iterate paths, and so
    iteration counts):
      * "seq": a reverse host loop of batched [nx,nx] x [nx] products;
      * "assoc": the affine associative scan of the JAX package, composing
        (fx_t', r_t) from the terminal side in O(log T) levels of batched
        [nx,nx] products (plain `torch.matmul`: the JAX package runs it
        outside any kernel too).
    "auto" is "seq" on a GPU and "assoc" on the CPU (`costate_mode`)."""
    mode = costate_mode(mode, deriv.fx.device)
    r_x = deriv.lx + torch.einsum("btcx,btc->btx", deriv.cx, phi)
    lam_T = deriv.lTx
    if mode == "seq":
        return _costate_seq(deriv.fx, r_x, lam_T)
    Ms = torch.flip(deriv.fx.transpose(-1, -2), dims=(1,))
    vs = torch.flip(r_x, dims=(1,))
    Mc, vc = _associative_scan((Ms, vs))
    lam = torch.flip((Mc @ lam_T[:, None, :, None])[..., 0] + vc, dims=(1,))
    return torch.cat([lam, lam_T[:, None]], dim=1)


def stage_solve_method(options: Options) -> str:
    """The stage solve `options.inertia_method` names: "bk", "eigh", or
    "ldl" (which an unresolved "auto" takes, as in the JAX package)."""
    method = options.inertia_method
    return method if method in ("bk", "eigh") else "ldl"


def _run_pass(problem: Problem, deriv: DerivativeBundle, nominal,
              mu: Tensor, reg: Tensor, delta_c: Tensor, options: Options,
              second=None):
    """One full backward sweep at fixed per-instance (mu, reg, delta_c), all
    `[B]`: the plain PyTorch version of the CUDA sweep kernel.

    `second` is the pre-contracted second-order term per stage
    (lam . d2f + phi . d2c, [B, T, nz, nz]) or None in quasi-Newton mode.
    Returns (Gains, dL [B], fail [B] bool, singular_at_first_failure [B]).
    """
    c_rel, il, iu, phi, zl, zu = nominal  # each [B, T, ...]
    gains_t, dL, fail, singular = sweep_plain(
        deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
        deriv.luu, deriv.cx, deriv.cu, second, c_rel, il, iu, phi, zl, zu,
        deriv.lTx, deriv.lTxx, mu, reg, delta_c,
        nx=problem.nx, nu=problem.nu, nc=problem.nc,
        refine=max(options.refine_steps, 1),
        rtol=options.kkt_residual_rtol, inertia=stage_solve_method(options),
        atol=options.inertia_atol)
    return Gains(*gains_t), dL, fail, singular


def sweep_plain(fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                c_rel, il, iu, phi, zl, zu, lTx, lTxx, mu, reg, delta_c,
                *, nx, nu, nc, refine, rtol, inertia="ldl", atol=1e-12):
    """The sweep on flat arguments — the signature of
    `ops.backward_cuda.backward_sweep_cuda`, whose plain version this is
    (`sec` may be None). `inertia` is the stage solve ("ldl", "bk",
    "eigh"); ldl reads `refine` and `rtol`, bk and eigh `atol`. Returns
    (gains tuple, dL, fail, singular)."""
    B, T = il.shape[0], il.shape[1]
    m = nu + nc
    dtype, device = il.dtype, il.device
    mu_ = mu[:, None]

    Vx, Vxx = lTx, lTxx
    dL = torch.zeros((B,), dtype=dtype, device=device)
    fail = torch.zeros((B,), dtype=torch.bool, device=device)
    singular = torch.zeros((B,), dtype=torch.bool, device=device)
    outs = []

    for t in range(T - 1, -1, -1):
        fx_t, fu_t = fx[:, t], fu[:, t]
        lx_t, lu_t = lx[:, t], lu[:, t]
        cx_t, cu_t = cx[:, t], cu[:, t]
        c_t, phi_t = c_rel[:, t], phi[:, t]
        zl_t, zu_t = zl[:, t], zu[:, t]

        sl = 1.0 / il[:, t]          # 0 where il = +inf (unbounded below)
        su = 1.0 / iu[:, t]
        sig_l = zl_t * sl
        sig_u = zu_t * su

        Qu = lu_t + _mv(cu_t, phi_t) + _mv(fu_t, Vx) - mu_ * sl + mu_ * su

        fuV = fu_t.transpose(-1, -2) @ Vxx             # [B, nu, nx]
        fxV = fx_t.transpose(-1, -2) @ Vxx             # [B, nx, nx]
        C = lxx[:, t] + fxV @ fx_t
        H = luu[:, t] + torch.diag_embed(sig_l + sig_u) + fuV @ fu_t
        Bm = lux[:, t] + fuV @ fx_t

        if sec is not None:
            sec_t = sec[:, t]
            C = C + sec_t[:, :nx, :nx]
            Bm = Bm + sec_t[:, nx:, :nx]
            H = H + sec_t[:, nx:, nx:]
        H = H + torch.diag_embed(reg[:, None].expand(B, nu))

        K = torch.zeros((B, m, m), dtype=dtype, device=device)
        K[:, :nu, :nu] = H
        if nc > 0:
            K[:, :nu, nu:] = cu_t.transpose(-1, -2)
            K[:, nu:, :nu] = cu_t
            K[:, nu:, nu:] = -torch.diag_embed(delta_c[:, None].expand(B, nc))

        rhs = torch.cat(
            [torch.cat([-Qu[:, :, None], -Bm], dim=2),
             torch.cat([-c_t[:, :, None], -cx_t], dim=2)], dim=1)   # [B, m, nx+1]

        if inertia == "eigh":
            factors = eigh_factor_and_inertia(K, atol=atol)
            X = eigh_solve(factors, rhs)
            stage_ok = factors.ok & (factors.n_pos == nu)
            stage_singular = factors.n_zero > 0
        elif inertia == "bk":
            # Reference-faithful rook Bunch-Kaufman (reference:
            # src/inertia_correction.jl:257-276): plain substitution, no
            # refinement or residual gate; singular = info > 0; the ladder
            # on np != nu or info != 0.
            bkf = bk_factor_rook(K)
            n_pos = bk_inertia(bkf, atol=atol)[0]
            X = bk_solve(bkf, rhs)
            stage_ok = (bkf.info == 0) & (n_pos == nu)
            stage_singular = bkf.info > 0
        else:
            # Diagonal-pivoted LDL^T: pivot signs give the exact inertia when
            # the factorization is sound; soundness is certified a
            # posteriori by the refined solve's backward-stability residual.
            # A breakdown is answered exactly like wrong inertia — bump reg
            # and restart (reference escape hatch:
            # src/inertia_correction.jl:266-273).
            factors = ldlt_factor_pivoted(K)
            X, solve_ok = ldlt_solve_refined(
                factors, K, rhs, refine_steps=refine,
                check_residual=True, residual_rtol=rtol)
            stage_ok = factors.ok & (factors.n_pos == nu) & solve_ok
            stage_singular = factors.n_zero > 0
        alpha, beta = X[:, :nu, 0], X[:, :nu, 1:]
        psi, omega = X[:, nu:, 0], X[:, nu:, 1:]

        chi_l = mu_ * sl - zl_t - sig_l * alpha
        zeta_l = -sig_l[:, :, None] * beta
        chi_u = mu_ * su - zu_t + sig_u * alpha
        zeta_u = sig_u[:, :, None] * beta

        Vxx = C + beta.transpose(-1, -2) @ Bm + omega.transpose(-1, -2) @ cx_t
        # Exact-arithmetic Vxx is symmetric; without explicit symmetrization,
        # roundoff asymmetry is amplified geometrically by the recursion
        # (~1.5x/stage on contact benchmarks in the JAX package's history).
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        Vx = (lx_t + _mv(cx_t, phi_t) + _mv(beta, Qu) + _mv(omega, c_t)
              + _mv(fx_t, Vx))

        dL = dL + (Qu * alpha).sum(dim=1) + (c_t * psi).sum(dim=1)

        first_fail = ~fail & ~stage_ok
        singular = singular | (first_fail & stage_singular)
        fail = fail | ~stage_ok

        outs.append((alpha, beta, psi, omega, chi_l, zeta_l, chi_u, zeta_u))

    outs.reverse()
    gains = tuple(torch.stack(field, dim=1) for field in zip(*outs))
    return gains, dL, fail, singular


def _use_cuda_kernel(options: Options, ref: Tensor) -> bool:
    """Whether the sweep takes a kernel: "ldl" and "bk" have one each
    (under "auto" on CUDA tensors, always under "cuda"); "eigh" has none,
    as in the JAX package, and "cuda" with it raises."""
    mode = options.backward_kernel
    if stage_solve_method(options) == "eigh":
        if mode == "cuda":
            raise ValueError(
                'backward_kernel="cuda" with inertia_method="eigh": the '
                "eigh oracle has no kernel; pass backward_kernel=\"auto\" "
                'or "torch"')
        return False
    return mode == "cuda" or (mode == "auto" and ref.is_cuda)


def sweep_attempts(problem: Problem, deriv: DerivativeBundle, nominal,
                   second, mu: Tensor, options: Options):
    """The backward sweep of one backward pass as a function
    `attempt(reg, delta_c)` of the per-instance regularization: the CUDA
    kernel of the stage solve (ldl or bk) on a GPU (or whenever
    `backward_kernel="cuda"`, which raises for CPU tensors), else the plain
    version `_run_pass`. For the kernel, the inputs that no attempt changes
    are checked and packed here, once."""
    if options.quasi_newton:
        second = None
    use_kernel = _use_cuda_kernel(options, mu)
    if options.backward_kernel == "cuda" and not mu.is_cuda:
        raise RuntimeError(
            'backward_kernel="cuda" needs tensors on a GPU, got '
            f"{mu.device}; pass backward_kernel=\"torch\" for the plain "
            "sweep")
    if not use_kernel:
        return lambda reg, delta_c: _run_pass(
            problem, deriv, nominal, mu, reg, delta_c, options,
            second=second)
    c_rel, il, iu, phi, zl, zu = nominal
    B, T, nz = mu.shape[0], problem.T, problem.nx + problem.nu
    sec = second if second is not None else mu.new_zeros((B, T, nz, nz))
    prepared = prepare_sweep(
        deriv.fx, deriv.fu, deriv.lx, deriv.lu, deriv.lxx, deriv.lux,
        deriv.luu, deriv.cx, deriv.cu, sec, c_rel, il, iu, phi, zl, zu,
        deriv.lTx, deriv.lTxx, mu,
        nx=problem.nx, nu=problem.nu, nc=problem.nc,
        inertia=stage_solve_method(options))

    def attempt(reg, delta_c):
        gains_t, dL, fail, singular = sweep_prepared(
            prepared, reg, delta_c, refine=max(options.refine_steps, 1),
            rtol=options.kkt_residual_rtol, atol=options.inertia_atol)
        return Gains(*gains_t), dL, fail, singular

    return attempt


def backward_pass(problem: Problem, deriv: DerivativeBundle, nominal,
                  mu: Tensor, reg_last: Tensor, options: Options, *,
                  lam=None, second=None) -> BackwardResult:
    """Full backward pass with the inertia-correction restart ladder.

    `nominal` = (c_relaxed [B,T,nc], il [B,T,nu], iu, phi [B,T,nc], zl, zu)
    — the accepted-iterate quantities the recursion reads (reference:
    src/backward_pass.jl:48-49); `mu`, `reg_last` are `[B]`. `lam`/`second`
    (costates and pre-contracted second-order terms) are computed here if
    not supplied by the caller.
    """
    dtype = nominal[1].dtype
    zero = torch.zeros_like(mu)

    if lam is None:
        lam = costate_scan(deriv, nominal[3])
    if second is None and not options.quasi_newton:
        # cH_phi precomputed with nominal phi; dynamics part needs lam
        second = deriv.cH_phi
        if deriv.fH is not None:
            second = second + torch.einsum("bti,btijk->btjk", lam[:, 1:],
                                           deriv.fH)

    # what no attempt changes is checked and packed once, before the ladder
    attempt = sweep_attempts(problem, deriv, nominal, second, mu, options)

    def next_reg(reg):
        # IPOPT-style ladder (reference: src/inertia_correction.jl:268-273).
        fresh = reg_last == 0.0
        first = torch.where(
            fresh, torch.full_like(reg, options.reg_1),
            torch.clamp(options.kappa_w_minus * reg_last,
                        min=options.reg_min))
        bumped = torch.where(fresh, options.kappa_w_plus_bar * reg,
                             options.kappa_w_plus * reg)
        return torch.where(reg == 0.0, first, bumped)

    # Clamp reg_max to the working dtype's finite max (the reference default
    # 1e40 overflows to inf in f32, which would make the guard vacuous).
    reg_max = min(options.reg_max, torch.finfo(dtype).max)
    dc_on = options.delta_c * mu ** options.kappa_c

    # The initial attempt always runs with reg = 0, delta_c = 0
    # (reference: src/backward_pass.jl:52-53).
    reg, delta_c = zero, zero
    gains, dL, fail, singular = attempt(reg, delta_c)

    for _ in range(options.max_backward_restarts):
        # A lane goes on while it fails and the reg its NEXT attempt would
        # use stays within reg_max — the reference never factorizes above it
        # (reference: src/backward_pass.jl:55). Lanes that passed keep the
        # reg they passed with.
        reg_next = next_reg(reg)
        active = fail & (reg_next <= reg_max)
        if not bool(active.any()):            # host sync, once per attempt
            break
        # The failed attempt determined the new (reg, delta_c)
        # (reference: src/inertia_correction.jl:263-273).
        reg = torch.where(active, reg_next, reg)
        delta_c = torch.where(active & singular, dc_on, delta_c)
        new_gains, new_dL, new_fail, new_singular = attempt(reg, delta_c)

        def merge(new, old):
            mask = active.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(mask, new, old)

        gains = Gains(*(merge(n, o) for n, o in zip(new_gains, gains)))
        dL = merge(new_dL, dL)
        fail = merge(new_fail, fail)
        singular = merge(new_singular, singular)

    status = fail.to(torch.int32)
    return BackwardResult(gains=gains, lam=lam, dL=dL, status=status,
                          reg=reg, delta_c=delta_c)
