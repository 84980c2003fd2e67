"""Bunch-Kaufman rook factorization with LAPACK-faithful inertia counting.

Counterpart of `ipddp2tpu/ops/bk.py`, batched over leading dimensions
(`A: [..., m, m]`). The reference's inertia correction factors each stage
KKT matrix with LAPACK's `sytrf_rook` and counts the eigenvalue signs of the
block-diagonal D with a tolerance-aware rule over 1x1 and 2x2 blocks
(reference: src/inertia_correction.jl:54-205, :257-276);
`inertia_method="bk"` (the resolution of "auto" on contact problems) runs
this algorithm: rook-pivoted Bunch-Kaufman with the reference's counting
rules and ladder semantics (np == num_controls AND info == 0; delta_c on
info > 0).

The decision structure is the JAX package's, step for step: alpha =
(1+sqrt(17))/8, the rook loop, `info` for the first zero column, masked
full-matrix updates, the 'L' variant (first row down), plain substitution
without refinement or residual gate.

Batched: every lane (a leading index) has its own column index k, as under
the JAX package's vmapped `while_loop`. Nothing here synchronizes with the
host on a GPU: the loop over the columns and the rook search run to fixed
trip counts with masks, so the factorization can be captured in a CUDA
graph. (On the CPU the column loop stops when every lane is done, which
changes nothing.) The rook search follows its chain of rows by doubling a
table of each row's arg-max, rather than one row per trip: the chain of a
column visits distinct rows of the active block (for a symmetric active
block the rook values increase strictly), so it ends within m - k steps.

This is the plain PyTorch version of the stage solve that the bk
instantiation of the sweep kernel (`ops/csrc/backward_sweep.cu`,
`-DSWEEP_BK`) carries out per warp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

_ALPHA = (1.0 + 17.0 ** 0.5) / 8.0


class BKFactors(NamedTuple):
    L: Tensor       # [..., m, m] unit-lower factor
    d: Tensor       # [..., m] D diagonal
    e: Tensor       # [..., m] D subdiagonal (e[k] != 0 marks a 2x2 block at k)
    perm: Tensor    # [..., m] int64: A_perm = A[perm][:, perm]
    info: Tensor    # [...] int32: 0 ok, k+1 if the k-th pivot is exactly zero


def _take(v: Tensor, i: Tensor) -> Tensor:
    """v[n, i[n]] for v [N, m], i [N]."""
    return v.gather(1, i[:, None])[:, 0]


def _row(A: Tensor, i: Tensor) -> Tensor:
    return A.gather(1, i[:, None, None].expand(-1, 1, A.shape[-1]))[:, 0]


def _col(A: Tensor, j: Tensor) -> Tensor:
    return A.gather(2, j[:, None, None].expand(-1, A.shape[-1], 1))[..., 0]


def _sym_swap(A: Tensor, perm: Tensor, i: Tensor, j: Tensor):
    """Symmetric row+column interchange of i[n] and j[n] in every lane
    (identity where i == j), and the same interchange of perm."""
    N, m = perm.shape
    sw = torch.arange(m, device=A.device).expand(N, m).clone()
    sw.scatter_(1, i[:, None], j[:, None])
    sw.scatter_(1, j[:, None], i[:, None])
    A = A.gather(1, sw[:, :, None].expand(N, m, m))
    A = A.gather(2, sw[:, None, :].expand(N, m, m))
    return A, perm.gather(1, sw)


def _rook(A: Tensor, k: Tensor, imax: Tensor, colmax: Tensor, steps: int):
    """LAPACK dsytrf_rook's pivot search from row `imax` of column k:
    (kp, p, kstep) per lane. The chain r_0 = imax, r_{t+1} = arg-max of row
    r_t over the active block is laid out `steps` long by doubling the
    table of each row's arg-max; the search ends at the first t where
    |a_rr| >= alpha rowmax (1x1 pivot) or the previous row is the arg-max
    or rowmax <= the previous rowmax (2x2 pivot)."""
    N, m, _ = A.shape
    idx = torch.arange(m, device=A.device)
    neg_inf = A.new_full((), float("-inf"))
    active = (idx[None, None, :] >= k[:, None, None]) \
        & (idx[None, :, None] != idx[None, None, :])
    absA = A.abs()
    rowv = torch.where(active, absA, neg_inf)
    nxt = torch.argmax(rowv, dim=-1)                       # [N, m] jmax
    rowmax = rowv.gather(2, nxt[..., None])[..., 0]        # [N, m]
    take1_tab = torch.diagonal(absA, dim1=-2, dim2=-1) >= _ALPHA * rowmax

    chain = imax[:, None]                                  # r_0 .. r_{w-1}
    hop = nxt
    while chain.shape[1] < steps:
        chain = torch.cat([chain, hop.gather(1, chain)], dim=1)
        hop = hop.gather(1, hop)
    prev = torch.cat([k[:, None], chain[:, :-1]], dim=1)   # p at step t
    cmax = torch.cat([colmax[:, None],
                      rowmax.gather(1, chain[:, :-1])], dim=1)
    rmax = rowmax.gather(1, chain)
    take1 = take1_tab.gather(1, chain)
    take2 = ~take1 & ((prev == nxt.gather(1, chain)) | (rmax <= cmax))
    t = torch.argmax((take1 | take2).to(torch.int8), dim=1)
    kp = _take(chain, t)
    p = _take(prev, t)
    kstep = torch.where(_take(take1, t), 1, 2)
    return kp, p, kstep


def bk_factor_rook(A: Tensor) -> BKFactors:
    """Rook-pivoted Bunch-Kaufman factorization of symmetric `[..., m, m]`."""
    m = A.shape[-1]
    batch = A.shape[:-2]
    A = A.reshape((-1, m, m))
    N, dtype, device = A.shape[0], A.dtype, A.device
    idx = torch.arange(m, device=device)
    zero = A.new_zeros(())
    one = A.new_ones(())
    neg_inf = A.new_full((), float("-inf"))

    A = 0.5 * (A + A.transpose(-1, -2))
    perm = idx.expand(N, m).clone()
    d = A.new_zeros((N, m))
    e = A.new_zeros((N, m))
    k = torch.zeros((N,), dtype=torch.int64, device=device)
    info = torch.zeros((N,), dtype=torch.int32, device=device)

    for s in range(m):                  # every step takes one or two columns
        live = k < m
        if A.device.type == "cpu" and not bool(live.any()):
            break
        kc = torch.clamp(k, max=m - 1)
        absakk = _take(torch.diagonal(A, dim1=-2, dim2=-1), kc).abs()
        colv = torch.where(idx[None, :] > kc[:, None], _col(A, kc).abs(),
                           neg_inf)
        imax = torch.argmax(colv, dim=1)
        colmax = torch.where(kc < m - 1, _take(colv, imax), neg_inf)

        zero_col = torch.maximum(absakk, torch.maximum(colmax, zero)) == 0.0
        plain_1x1 = absakk >= _ALPHA * colmax
        kp_r, p_r, kstep_r = _rook(A, kc, torch.maximum(imax, kc), colmax,
                                   max(m - s, 1))
        easy = zero_col | plain_1x1
        kp = torch.where(easy, kc, kp_r)
        p = torch.where(easy, kc, p_r)
        kstep = torch.where(easy, 1, kstep_r)
        info = torch.where(live & zero_col & (info == 0),
                           (kc + 1).to(torch.int32), info)

        # interchanges: for kstep=2, first bring p to k, then kp to k+1
        # (lanes that are done swap nothing)
        do2 = kstep == 2
        A, perm = _sym_swap(A, perm, kc, torch.where(live & do2, p, kc))
        tgt = torch.clamp(torch.where(do2, kc + 1, kc), max=m - 1)
        A, perm = _sym_swap(A, perm, tgt, torch.where(live, kp, tgt))

        # 1x1 pivot
        dk = _take(torch.diagonal(A, dim1=-2, dim2=-1), kc)
        safe = torch.where(dk == 0.0, one, dk)
        below = idx[None, :] > kc[:, None]                     # [N, m]
        l = torch.where(below, _col(A, kc) / safe[:, None], zero)
        w = torch.where(dk == 0.0, zero, one)
        A1 = A - ((w * dk)[:, None, None]
                  * (l[:, :, None] * l[:, None, :]))
        at_k = idx[None, :] == kc[:, None]                     # [N, m]
        A1 = torch.where(at_k[:, None, :] & below[:, :, None],
                         l[:, :, None], A1)
        A1 = torch.where(at_k[:, :, None] & below[:, None, :],
                         l[:, None, :], A1)
        d1 = torch.where(at_k, dk[:, None], d)

        # 2x2 pivot
        k1 = torch.clamp(kc + 1, max=m - 1)
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        colk, colk1 = _col(A, kc), _col(A, k1)
        a11 = _take(diag, kc)
        a21 = _take(colk, k1)
        a22 = _take(diag, k1)
        det = a11 * a22 - a21 * a21
        safe_det = torch.where(det == 0.0, one, det)
        mask = idx[None, :] > (kc + 1)[:, None]
        w1 = torch.where(mask, colk, zero)
        w2 = torch.where(mask, colk1, zero)
        l1 = (w1 * a22[:, None] - w2 * a21[:, None]) / safe_det[:, None]
        l2 = (w2 * a11[:, None] - w1 * a21[:, None]) / safe_det[:, None]
        A2 = (A - l1[:, :, None] * w1[:, None, :]) \
            - l2[:, :, None] * w2[:, None, :]
        at_k1 = idx[None, :] == (kc + 1)[:, None]
        for at, lv in ((at_k, l1), (at_k1, l2)):
            A2 = torch.where(at[:, None, :] & mask[:, :, None],
                             lv[:, :, None], A2)
            A2 = torch.where(at[:, :, None] & mask[:, None, :],
                             lv[:, None, :], A2)
        d2 = torch.where(at_k, a11[:, None],
                         torch.where(at_k1, a22[:, None], d))
        e2 = torch.where(at_k, a21[:, None], e)

        sel = (live & do2)[:, None]
        keep = ~live[:, None]
        A = torch.where(keep[:, :, None], A,
                        torch.where(sel[:, :, None], A2, A1))
        d = torch.where(keep, d, torch.where(sel, d2, d1))
        e = torch.where(keep | ~sel, e, e2)
        k = torch.where(live, k + kstep, k)

    L = torch.tril(A, -1)
    if m > 1:
        # the subdiagonal slot of each 2x2 block belongs to D
        sub = torch.diagonal(L, offset=-1, dim1=-2, dim2=-1)
        sub_kept = torch.where(e[:, : m - 1] != 0.0, zero, sub)
        L = (L - torch.diag_embed(sub, offset=-1)) \
            + torch.diag_embed(sub_kept, offset=-1)
    L = L + torch.eye(m, dtype=dtype, device=device)
    return BKFactors(L=L.reshape(batch + (m, m)), d=d.reshape(batch + (m,)),
                     e=e.reshape(batch + (m,)),
                     perm=perm.reshape(batch + (m,)),
                     info=info.reshape(batch))


def bk_inertia(f: BKFactors, atol: float = 1e-12):
    """(np, nn, nz), each `[...]` int64, with the reference's exact counting
    rules (reference: src/inertia_correction.jl:96-205, real symmetric case,
    atol-only tolerance as called at :262)."""
    d, e = f.d, f.e
    tol = atol
    is2 = e != 0.0                       # start of a 2x2 block
    second = torch.cat([torch.zeros_like(is2[..., :1]), is2[..., :-1]], -1)
    is1 = ~(is2 | second)

    count = lambda mask: mask.sum(dim=-1)
    np1 = count(is1 & (d > tol))
    nn1 = count(is1 & (d < -tol))
    nz1 = count(is1 & ~((d > tol) | (d < -tol)))

    # 2x2 blocks, vectorized over start positions
    d2 = torch.cat([d[..., 1:], torch.zeros_like(d[..., :1])], -1)
    abs_dii, abs_dxx = d.abs(), d2.abs()
    s1b = 2.0 * torch.maximum(torch.maximum(abs_dii, e.abs()), abs_dxx)
    safe = torch.where(s1b == 0.0, torch.ones_like(s1b), s1b)
    det_lo = torch.where(abs_dii >= abs_dxx,
                         (d / safe) * d2 - (e / safe) * e,
                         d * (d2 / safe) - (e / safe) * e)
    smin = det_lo.abs()                  # c = 1 for real matrices
    trace = d + d2

    both_zero = 0.5 * s1b <= tol         # (c/2) s1_block <= tol
    pair = ~both_zero & ((smin > tol) | (trace == 0.0))
    one_zero = ~both_zero & ~pair

    np2 = count(is2 & (pair | (one_zero & (trace >= 0.0))))
    nn2 = count(is2 & (pair | (one_zero & (trace < 0.0))))
    nz2 = 2 * count(is2 & both_zero) + count(is2 & one_zero)
    return np1 + np2, nn1 + nn2, nz1 + nz2


def bk_solve(f: BKFactors, rhs: Tensor) -> Tensor:
    """X = A^{-1} rhs (`rhs: [..., m, k]`) from the factorization: plain
    substitution, the reference's ldiv! — no refinement."""
    pidx = f.perm[..., None].expand(rhs.shape)
    b = torch.gather(rhs, -2, pidx)
    y = torch.linalg.solve_triangular(f.L, b, upper=False,
                                      unitriangular=True)
    # block-diagonal solve
    d, e = f.d, f.e
    is2 = e != 0.0
    second = torch.cat([torch.zeros_like(is2[..., :1]), is2[..., :-1]], -1)
    shift_up = lambda v, fill: torch.cat([v[..., 1:], fill], -1)
    shift_dn = lambda v, fill: torch.cat([fill, v[..., :-1]], -1)
    zeros1, ones1 = torch.zeros_like(d[..., :1]), torch.ones_like(d[..., :1])
    d2 = shift_up(d, zeros1)
    det = d * d2 - e * e
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    safe_d = torch.where(d == 0.0, torch.ones_like(d), d)
    y_next = torch.cat([y[..., 1:, :], torch.zeros_like(y[..., :1, :])], -2)
    y_prev = torch.cat([torch.zeros_like(y[..., :1, :]), y[..., :-1, :]], -2)
    d_prev = shift_dn(d, zeros1)
    e_prev = shift_dn(e, zeros1)
    det_prev = shift_dn(safe_det, ones1)
    z_1x1 = y / safe_d[..., None]
    z_first = (d2[..., None] * y - e[..., None] * y_next) \
        / safe_det[..., None]
    z_second = (d_prev[..., None] * y - e_prev[..., None] * y_prev) \
        / det_prev[..., None]
    z = torch.where(is2[..., None], z_first,
                    torch.where(second[..., None], z_second, z_1x1))
    x = torch.linalg.solve_triangular(f.L.transpose(-1, -2), z, upper=True,
                                      unitriangular=True)
    return torch.zeros_like(x).scatter(-2, pidx, x)
