"""Symmetric-indefinite LDL^T factorization with inertia extraction.

Counterpart of `ipddp2tpu/ops/ldlt.py`, batched over leading dimensions
(`A: [..., m, m]`): the stand-in for the reference's LAPACK Bunch-Kaufman
path (reference: src/inertia_correction.jl:257-276). The KKT matrices are
tiny (m = nu + nc) but there are batch x time of them.

  * LDL^T with symmetric maximum-|diagonal| (greedy 1x1) pivoting, ties
    broken towards the first index. The permutation is a congruence, so the
    pivot signs give the exact inertia (Sylvester) whenever the
    factorization is sound.
  * A breakdown (zero pivot, non-finite fill, or a large residual in the
    refined solve) is reported as a failure; the caller treats it like wrong
    inertia and answers with a regularization bump, the reference's escape
    hatch for LAPACK info > 0.
  * Accuracy of the solve is restored with iterative refinement sweeps, and
    certified a posteriori by a backward-stability residual gate.

This is the plain PyTorch version of the factor-and-solve that the CUDA
sweep kernel (`ops/csrc/backward_sweep.cu`) carries out per thread.

Beside it stand the unpivoted LDL^T (`ldlt_factor`, behind
`kkt_factor_and_inertia`) and the eigendecomposition oracle
(`inertia_method="eigh"`: `eigh_factor_and_inertia`, `eigh_solve`), which no
kernel computes: the JAX package runs eigh only as XLA's, and the port only
as `torch.linalg.eigh`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class LDLTFactors(NamedTuple):
    ld: Tensor     # [..., m, m]: strict lower triangle = L (unit diagonal
                   # implied), diagonal = D. Upper triangle is garbage.
    ok: Tensor     # [...] bool: finite and no exactly-zero pivot
    n_pos: Tensor  # [...] int32: count of positive pivots (Sylvester inertia)
    n_zero: Tensor # [...] int32: count of exactly-zero pivots
    perm: Optional[Tensor] = None  # [..., m] int64 pivot order;
                                   # factorization is of A[perm][:, perm]


def ldlt_factor(A: Tensor, *, atol: float = 0.0) -> LDLTFactors:
    """Unpivoted LDL^T of symmetric `A` (the lower triangle is used). By
    Sylvester's law the pivot signs are the inertia of A whenever the
    factorization exists; breakdown shows as exactly-zero pivots or
    non-finite fill. `atol` is the zero-pivot tolerance (an exact zero by
    default, the analog of LAPACK's info > 0)."""
    m = A.shape[-1]
    batch = A.shape[:-2]
    if m == 0:
        z = torch.zeros(batch, dtype=torch.int32, device=A.device)
        return LDLTFactors(A, torch.ones(batch, dtype=torch.bool,
                                         device=A.device), z, z)
    idx = torch.arange(m, device=A.device)
    M = A.clone()
    for j in range(m):
        dj = M[..., j, j]
        below = idx > j
        # guard the divide so a zero pivot never poisons the update via 0*inf
        denom = torch.where(dj == 0, torch.ones_like(dj), dj)
        l = torch.where(below, M[..., :, j] / denom[..., None],
                        torch.zeros_like(dj)[..., None])
        M = M - dj[..., None, None] * l[..., :, None] * l[..., None, :]
        M[..., :, j] = torch.where(below, l, M[..., :, j])
        M[..., j, j] = dj
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    n_zero = (d.abs() <= atol).sum(dim=-1).to(torch.int32)
    n_pos = (d > atol).sum(dim=-1).to(torch.int32)
    return LDLTFactors(ld=M, ok=finite & (n_zero == 0), n_pos=n_pos,
                       n_zero=n_zero)


def ldlt_factor_pivoted(A: Tensor, *, atol: float = 0.0) -> LDLTFactors:
    """LDL^T with symmetric maximum-|diagonal| pivoting (first occurrence on
    ties). A saddle point with an all-zero remaining diagonal surfaces as a
    zero pivot; the caller treats it like a singular factorization."""
    m = A.shape[-1]
    batch = A.shape[:-2]
    idx = torch.arange(m, device=A.device)
    perm = idx.expand(batch + (m,)).clone()
    if m == 0:
        z = torch.zeros(batch, dtype=torch.int32, device=A.device)
        return LDLTFactors(A, torch.ones(batch, dtype=torch.bool,
                                         device=A.device), z, z, perm)

    M = A.clone()
    neg_inf = A.new_full((), float("-inf"))
    for j in range(m):
        d = torch.diagonal(M, dim1=-2, dim2=-1)
        cand = torch.where(idx >= j, d.abs(), neg_inf)
        p = torch.argmax(cand, dim=-1, keepdim=True)         # first maximum
        # symmetric swap j <-> p
        swap = idx.expand(batch + (m,)).clone()
        swap[..., j:j + 1] = p
        swap.scatter_(-1, p, torch.full_like(p, j))
        M = torch.gather(M, -2, swap[..., :, None].expand(M.shape))
        M = torch.gather(M, -1, swap[..., None, :].expand(M.shape))
        perm = torch.gather(perm, -1, swap)

        dj = M[..., j, j]
        below = idx > j
        # Guard the divide so a zero pivot never produces inf/nan that could
        # poison the rank-1 update through 0 * inf.
        denom = torch.where(dj == 0, torch.ones_like(dj), dj)
        l = torch.where(below, M[..., :, j] / denom[..., None],
                        torch.zeros_like(dj)[..., None])
        M = M - dj[..., None, None] * l[..., :, None] * l[..., None, :]
        # l[j] = 0, so column j and the (j, j) entry were untouched by the
        # update; overwrite the subdiagonal of column j with L and restore D.
        M[..., :, j] = torch.where(below, l, M[..., :, j])
        M[..., j, j] = dj

    d = torch.diagonal(M, dim1=-2, dim2=-1)
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    n_zero = (d.abs() <= atol).sum(dim=-1).to(torch.int32)
    n_pos = (d > atol).sum(dim=-1).to(torch.int32)
    return LDLTFactors(ld=M, ok=finite & (n_zero == 0), n_pos=n_pos,
                       n_zero=n_zero, perm=perm)


def ldlt_solve(factors: LDLTFactors, b: Tensor) -> Tensor:
    """Solve A X = b given P A P^T = L D L^T. b: [..., m] or [..., m, k]."""
    ld = factors.ld
    m = ld.shape[-1]
    if m == 0:
        return b
    squeeze = b.dim() == ld.dim() - 1
    if squeeze:
        b = b[..., None]
    L = torch.tril(ld, -1)
    d = torch.diagonal(ld, dim1=-2, dim2=-1)
    if factors.perm is not None:
        pidx = factors.perm[..., None].expand(b.shape)
        b = torch.gather(b, -2, pidx)
    y = torch.linalg.solve_triangular(L, b, upper=False, unitriangular=True)
    y = y / d[..., None]
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True,
                                      unitriangular=True)
    if factors.perm is not None:
        x = torch.zeros_like(x).scatter(-2, pidx, x)
    return x[..., 0] if squeeze else x


def _fro(a: Tensor) -> Tensor:
    return torch.sqrt((a * a).sum(dim=(-2, -1)))


def ldlt_solve_refined(
    factors: LDLTFactors, A: Tensor, b: Tensor, *, refine_steps: int = 1,
    check_residual: bool = False, residual_rtol: float = 1e-6,
):
    """Solve with iterative refinement: x += A_fact^{-1} (b - A x); b is
    [..., m, k]. With `check_residual`, also returns a bool certifying
    backward stability of the final solution
    (||A x - b||_F <= rtol * (||A||_F ||x||_F + ||b||_F), x finite); False
    means the factorization broke down and the caller must regularize and
    retry."""
    x = ldlt_solve(factors, b)
    for _ in range(max(refine_steps, 1 if check_residual else 0)):
        r = b - A @ x
        x = x + ldlt_solve(factors, r)
    if not check_residual:
        return x
    r = b - A @ x
    scale = _fro(A) * _fro(x) + _fro(b)
    ok = _fro(r) <= residual_rtol * scale
    ok = ok & torch.isfinite(x).all(dim=-1).all(dim=-1)
    return x, ok


def kkt_factor_and_inertia(K: Tensor, *, atol: float = 1e-12) -> LDLTFactors:
    """Factor a KKT matrix and report its inertia: the caller checks
    n_pos == nu and nonsingularity, like `np == num_controls` and
    `info == 0` after the reference's `sytrf_rook!` + `inertia!`
    (reference: src/inertia_correction.jl:257-266)."""
    return ldlt_factor(K, atol=atol)


class EighFactors(NamedTuple):
    """Eigendecomposition-backed factorization: exact inertia, a pivot-free
    solve (the oracle path, `inertia_method="eigh"`)."""

    w: Tensor       # [..., m] eigenvalues
    v: Tensor       # [..., m, m] eigenvectors
    ok: Tensor
    n_pos: Tensor
    n_zero: Tensor


def eigh_factor_and_inertia(K: Tensor, *, atol: float = 1e-12) -> EighFactors:
    """Eigenvalues of the symmetric part of `K` (as the JAX package's eigh,
    which symmetrizes its input) and their sign counts at `atol`."""
    m = K.shape[-1]
    batch = K.shape[:-2]
    if m == 0:
        z = torch.zeros(batch, dtype=torch.int32, device=K.device)
        return EighFactors(K.new_zeros(batch + (0,)), K,
                           torch.ones(batch, dtype=torch.bool,
                                      device=K.device), z, z)
    w, v = torch.linalg.eigh(0.5 * (K + K.transpose(-1, -2)))
    n_pos = (w > atol).sum(dim=-1).to(torch.int32)
    n_zero = (w.abs() <= atol).sum(dim=-1).to(torch.int32)
    ok = torch.isfinite(w).all(dim=-1) & (n_zero == 0)
    return EighFactors(w=w, v=v, ok=ok, n_pos=n_pos, n_zero=n_zero)


def eigh_solve(factors: EighFactors, b: Tensor) -> Tensor:
    """X = V diag(1/w) V^T b (an exactly-zero eigenvalue divides by 1);
    b: [..., m] or [..., m, k]."""
    if factors.w.shape[-1] == 0:
        return b
    squeeze = b.dim() == factors.v.dim() - 1
    if squeeze:
        b = b[..., None]
    w = torch.where(factors.w == 0, torch.ones_like(factors.w), factors.w)
    v = factors.v
    x = v @ ((v.transpose(-1, -2) @ b) / w[..., None])
    return x[..., 0] if squeeze else x
