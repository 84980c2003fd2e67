// The Bunch-Kaufman instantiation of the backward sweep (-DSWEEP_BK=1),
// included by backward_sweep.cu, which holds the stage layout, the copies
// and the interface this kernel shares with the LDL^T one.
//
// Replaces no Pallas kernel: in the JAX package the contact models'
// inertia path (`inertia_method="bk"`, ipddp2tpu/ops/bk.py::bk_factor_rook,
// bk_inertia, bk_solve) runs inside the vmapped lax.scan sweep, which XLA
// compiles into one fused loop (the scan branch ipddp2tpu/backward.py:
// 219-241; the Pallas sweep refuses bk). Eager PyTorch has no such compiler:
// rook Bunch-Kaufman walks the m = nu + nc columns one at a time, each with a
// data-dependent rook search, 1x1 / 2x2 branches and symmetric swaps, which
// is some 10^5 small launches a sweep. This kernel is that sweep in one
// launch. Its plain version is
// `ipddp2tpu_torch.backward.sweep_plain(..., inertia="bk")`.
//
// What it computes per instance, in reverse time, at fixed (mu, reg,
// delta_c): the stage's KKT matrix K and right-hand sides as the LDL^T
// kernel forms them; A = (K + K^T) / 2; the rook-pivoted factorization
// P A P^T = L D L^T with 1x1 and 2x2 pivots, alpha = (1 + sqrt(17)) / 8,
// `info` = the first zero column + 1; the reference's count of positive
// eigenvalues of D at `atol` over 1x1 and 2x2 blocks; plain substitution (no
// refinement, no residual gate); stage ok = (info == 0) and (n_pos == nu),
// singular = info > 0; then the gains and the value recursion exactly as the
// LDL^T kernel (Vxx symmetrized).
//
// What bounds it on this card: latency, as the LDL^T sweep. The work is a
// chain of T dependent factorizations per instance whose every step
// depends on the data (which column, 1x1 or 2x2, how long the rook chain
// is); bytes and FP64 operations are a small share of its time. The design
// is simple and right first:
//  * One warp owns an instance (m = 35 for the cartpole does not fit the
//    LDL^T kernel's group of at most 32 lanes). The working matrix lives in
//    shared memory [m][m + 1] (9.8 KB in double at m = 35), the rows dealt
//    over the 32 lanes (lane r takes rows r, r + 32, ..).
//  * Pivot search (the column's arg-max and each trip of the rook chain):
//    every lane scans its rows in order, then a xor butterfly of (|a|,
//    index) pairs with jnp.argmax's rule (a NaN first, the lowest index on
//    ties, masked entries as -inf), so every lane holds the same pivot and
//    the control flow stays uniform over the warp.
//  * Interchanges swap rows, then columns, of the full matrix, lanes over
//    the entries; eliminations update the full matrix (as the JAX package's
//    masked updates do), each lane its rows, from multipliers put in shared
//    memory first. `__syncwarp` between the phases is the only barrier.
//  * Substitution for the nx + 1 right-hand sides at once: forward and
//    backward one column of L per step, lanes over (row, right-hand side).
// A block is 4 warps where its double shared memory fits 227 KB, else 2,
// else 1 (`launch_geometry(..., inertia="bk")` in the wrapper).
//
// Compile-time parameters as backward_sweep.cu (NX, NU, NC, IPB), plus
// SWEEP_BK=1. The `refine` argument is ignored and the tolerance argument is
// the inertia tolerance atol (Options.inertia_atol).

#pragma once

#include <limits.h>

constexpr double BK_ALPHA = 0.6403882032022076;   // (1 + sqrt(17)) / 8

template <typename T>
struct LayBK {
    static constexpr int A0 = 2 * Lay<T>::IN_LEN;   // working matrix [M][MP]
    static constexpr int RS = A0 + M * MP;          // rhs [M][NK]
    static constexpr int YS = RS + M * NK;          // forward substitution
    static constexpr int ZS = YS + M * NK;          // D^-1, backward subst.
    static constexpr int XS = ZS + M * NK;          // solution, original order
    static constexpr int CS = XS + M * NK;          // C, then unsymmetrized Vxx
    static constexpr int VXX = CS + NX * NX;        // value Hessian carry
    static constexpr int VX = VXX + NX * NX;        // value gradient carry
    static constexpr int VXN = VX + NX;             // next value gradient
    static constexpr int DV = VXN + NX;             // D diagonal [M]
    static constexpr int EV = DV + M;               // D subdiagonal [M]
    static constexpr int PM = EV + M;               // permutation [M]
    static constexpr int WS = PM + M;               // multipliers [4][M]
    static constexpr int INST = up<T>(WS + 4 * M);  // values per instance
};

// (o, oi) before (b, bi) under jnp.argmax's order: a NaN before any number
// (the lower index between two NaNs), else the larger value, the lower
// index on ties
template <typename T>
__device__ __forceinline__ bool bk_before(T o, int oi, T b, int bi) {
    const bool onan = o != o, bnan = b != b;
    return (onan || bnan) ? (onan && (!bnan || oi < bi))
                          : (o > b || (o == b && oi < bi));
}

// arg-max over the warp; every lane ends with the same pair
template <typename T>
__device__ __forceinline__ void bk_warp_argmax(T& v, int& i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_xor_sync(FULL, v, off);
        const int oi = __shfl_xor_sync(FULL, i, off);
        if (bk_before(ov, oi, v, i)) { v = ov; i = oi; }
    }
}

// jnp.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T bk_max(T a, T b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// symmetric interchange of rows and columns i, j (rows first, as the JAX
// package's _sym_swap) and of the permutation
template <typename T>
__device__ __forceinline__ void bk_swap(T* __restrict__ A, T* __restrict__ pm,
                                        const int i, const int j,
                                        const int r) {
    for (int c = r; c < M; c += 32) {
        const T t = A[i * MP + c];
        A[i * MP + c] = A[j * MP + c];
        A[j * MP + c] = t;
    }
    __syncwarp();
    for (int q = r; q < M; q += 32) {
        const T t = A[q * MP + i];
        A[q * MP + i] = A[q * MP + j];
        A[q * MP + j] = t;
    }
    if (r == 0) {
        const T t = pm[i];
        pm[i] = pm[j];
        pm[j] = t;
    }
    __syncwarp();
}

// L(i, j), i > j, from the factored matrix: the strict lower part, except
// the subdiagonal slot of a 2x2 block, which belongs to D
template <typename T>
__device__ __forceinline__ T bk_l(const T* __restrict__ A,
                                  const T* __restrict__ ev, const int i,
                                  const int j) {
    return (i == j + 1 && ev[j] != T(0)) ? T(0) : A[i * MP + j];
}

template <typename T>
__global__ void __launch_bounds__(NT)
backward_sweep_bk_kernel(const SweepArgs a, const int B, const int Tn,
                         const int /* refine: unused */, const T atol) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using S = Lay<T>;
    using L = LayBK<T>;
    const T NEG_INF = -INFINITY;
    const int r = threadIdx.x % 32;           // lane
    const int grp = threadIdx.x / 32;         // instance (warp) of the block
    const int b_raw = blockIdx.x * IPB + grp;
    const bool valid = b_raw < B;             // a ragged last block repeats
    const int b = valid ? b_raw : B - 1;      // the last instance, stores none
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + (size_t)grp * L::INST;

    T* __restrict__ Am = sm + L::A0;
    T* __restrict__ rs = sm + L::RS;
    T* __restrict__ ys = sm + L::YS;
    T* __restrict__ zs = sm + L::ZS;
    T* __restrict__ xs = sm + L::XS;
    T* __restrict__ cs = sm + L::CS;
    T* __restrict__ vxx = sm + L::VXX;
    T* __restrict__ vx = sm + L::VX;
    T* __restrict__ vxn = sm + L::VXN;
    T* __restrict__ dv = sm + L::DV;
    T* __restrict__ ev = sm + L::EV;
    T* __restrict__ pm = sm + L::PM;
    T* __restrict__ ws = sm + L::WS;

    T* __restrict__ alpha = (T*)a.alpha;   T* __restrict__ beta = (T*)a.beta;
    T* __restrict__ psi = (T*)a.psi;       T* __restrict__ omega = (T*)a.omega;
    T* __restrict__ chi_l = (T*)a.chi_l;   T* __restrict__ zeta_l = (T*)a.zeta_l;
    T* __restrict__ chi_u = (T*)a.chi_u;   T* __restrict__ zeta_u = (T*)a.zeta_u;

    const T mu = ((const T*)a.mu)[b];
    const T reg = ((const T*)a.reg)[b];
    const T dc = ((const T*)a.dc)[b];

    const size_t s_last = (size_t)b * Tn + (Tn - 1);
    copy_stage<T>(sm, a, s_last, r);
    cp_async_commit();
    for (int i = r; i < NX; i += 32) vx[i] = ((const T*)a.lTx)[b * NX + i];
    for (int i = r; i < NX * NX; i += 32)
        vxx[i] = ((const T*)a.lTxx)[(size_t)b * NX * NX + i];

    T dL = T(0);                     // held by the lane of the last task
    bool fail = false, singular = false;

#pragma unroll 1
    for (int t = Tn - 1; t >= 0; --t) {
        const size_t s = (size_t)b * Tn + t;
        long long tick = (a.prof != nullptr) ? clock64() : 0;
        const int cur = (Tn - 1 - t) & 1;
        T* __restrict__ in = sm + cur * S::IN_LEN;
        __syncwarp();
        if (t > 0) copy_stage<T>(sm + (cur ^ 1) * S::IN_LEN, a, s - 1, r);
        cp_async_commit();
        cp_async_wait_but_one();
        __syncwarp();

        const T* fx_t = in + S::FX;    const T* fu_t = in + S::FU;
        const T* lx_t = in + S::LX;    const T* lu_t = in + S::LU;
        const T* lxx_t = in + S::LXX;  const T* lux_t = in + S::LUX;
        const T* luu_t = in + S::LUU;  const T* cx_t = in + S::CX;
        const T* cu_t = in + S::CU;    const T* sec_t = in + S::SEC;
        const T* c_t = in + S::CC;     const T* il_t = in + S::IL;
        const T* iu_t = in + S::IU;    const T* phi_t = in + S::PHI;
        const T* zl_t = in + S::ZL;    const T* zu_t = in + S::ZU;

        // ---- assembly: row i of K and of the rhs by lane i % 32 ----
#pragma unroll 1
        for (int row = r; row < M; row += 32) {
            T* krow = Am + row * MP;
            T* rrow = rs + row * NK;
            if (row < NU) {
                const int i = row;
                T fui[NX], fuv[NX];
#pragma unroll
                for (int k = 0; k < NX; ++k) fui[k] = fu_t[k * NU + i];
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fui[k] * vxx[k * NX + j];
                    fuv[j] = acc;
                }
                const T sl = T(1) / il_t[i];     // exactly 0 where il = +inf
                const T su = T(1) / iu_t[i];
                T qu = lu_t[i];
#pragma unroll
                for (int c = 0; c < NC; ++c) qu += cu_t[c * NU + i] * phi_t[c];
#pragma unroll
                for (int k = 0; k < NX; ++k) qu += fui[k] * vx[k];
                qu = qu - mu * sl + mu * su;
                rrow[0] = -qu;
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fuv[k] * fx_t[k * NX + j];
                    rrow[1 + j] = -(lux_t[i * NX + j] + acc
                                    + sec_t[(NX + i) * NZ + j]);
                }
#pragma unroll 1
                for (int j = 0; j < NU; ++j) {
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fuv[k] * fu_t[k * NU + j];
                    T h = luu_t[i * NU + j] + acc + sec_t[(NX + i) * NZ + NX + j];
                    if (i == j) h = h + (zl_t[i] * sl + zu_t[i] * su) + reg;
                    krow[j] = h;
                }
#pragma unroll 1
                for (int c = 0; c < NC; ++c) krow[NU + c] = cu_t[c * NU + i];
            } else {
                const int c = row - NU;
#pragma unroll 1
                for (int j = 0; j < NU; ++j) krow[j] = cu_t[c * NU + j];
#pragma unroll 1
                for (int c2 = 0; c2 < NC; ++c2)
                    krow[NU + c2] = (c2 == c) ? -dc : T(0);
                rrow[0] = -c_t[c];
#pragma unroll
                for (int j = 0; j < NX; ++j) rrow[1 + j] = -cx_t[c * NX + j];
            }
        }
        // C = lxx + sec_xx + fx^T Vxx' fx, row ri on lane 31 - ri % 32
        for (int ri = 31 - r; ri < NX; ri += 32) {
            T fxv[NX];
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k)
                    acc += fx_t[k * NX + ri] * vxx[k * NX + j];
                fxv[j] = acc;
            }
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fxv[k] * fx_t[k * NX + j];
                cs[ri * NX + j] = lxx_t[ri * NX + j] + acc + sec_t[ri * NZ + j];
            }
        }
        for (int q = r; q < M; q += 32) {
            dv[q] = T(0);
            ev[q] = T(0);
            pm[q] = T(q);
        }
        __syncwarp();
        // A = (K + K^T) / 2, as bk_factor_rook symmetrizes its input
#pragma unroll 1
        for (int q = r; q < M * M; q += 32) {
            const int i = q / M, j = q - i * M;
            if (i < j) {
                const T v = T(0.5) * (Am[i * MP + j] + Am[j * MP + i]);
                Am[i * MP + j] = v;
                Am[j * MP + i] = v;
            }
        }
        __syncwarp();

        PROF(0)
        // ---- rook-pivoted Bunch-Kaufman, the warp on shared memory ----
        int k = 0, info = 0;
#pragma unroll 1
        while (k < M) {
            T cv = NEG_INF;
            int ci = INT_MAX;
            for (int i = r; i < M; i += 32) {
                const T v = (i > k) ? fabs(Am[i * MP + k]) : NEG_INF;
                if (bk_before(v, i, cv, ci)) { cv = v; ci = i; }
            }
            bk_warp_argmax(cv, ci);
            const T absakk = fabs(Am[k * MP + k]);
            const T colmax = (k < M - 1) ? cv : NEG_INF;
            const bool zero_col = bk_max(absakk, bk_max(colmax, T(0))) == T(0);
            const bool plain1 = absakk >= T(BK_ALPHA) * colmax;
            int kp = k, p = k, kstep = 1;
            if (!(zero_col || plain1)) {
                // the rook chain: its rows are distinct (ops/bk.py), so M
                // trips bound it; if none ends it, take its first row as a
                // 2x2 pivot, as the plain version's table does
                int im = ci > k ? ci : k, pp = k;
                T cm = colmax;
                kp = im; p = k; kstep = 2;
#pragma unroll 1
                for (int it = 0; it < M; ++it) {
                    T rv = NEG_INF;
                    int rj = INT_MAX;
                    for (int j = r; j < M; j += 32) {
                        const T v = (j >= k && j != im) ? fabs(Am[im * MP + j])
                                                        : NEG_INF;
                        if (bk_before(v, j, rv, rj)) { rv = v; rj = j; }
                    }
                    bk_warp_argmax(rv, rj);
                    const T aii = fabs(Am[im * MP + im]);
                    const bool take1 = aii >= T(BK_ALPHA) * rv;
                    const bool take2 = !take1 && (pp == rj || rv <= cm);
                    if (take1 || take2) {
                        kp = im; p = pp; kstep = take1 ? 1 : 2;
                        break;
                    }
                    pp = im; cm = rv; im = rj;
                }
            }
            if (zero_col && info == 0) info = k + 1;
            const bool do2 = kstep == 2;
            if (do2 && p != k) bk_swap(Am, pm, k, p, r);
            const int tgt = do2 ? k + 1 : k;
            if (kp != tgt && tgt < M) bk_swap(Am, pm, tgt, kp, r);

            if (!do2) {
                const T dk = Am[k * MP + k];
                const T safe = (dk == T(0)) ? T(1) : dk;
                const T wdk = ((dk == T(0)) ? T(0) : T(1)) * dk;
                for (int i = r; i < M; i += 32)
                    ws[i] = (i > k) ? Am[i * MP + k] / safe : T(0);
                __syncwarp();
#pragma unroll 1
                for (int i = r; i < M; i += 32) {
                    const T li = ws[i];
                    T* arow = Am + i * MP;
#pragma unroll 5
                    for (int j = 0; j < M; ++j)
                        arow[j] = arow[j] - wdk * (li * ws[j]);
                }
                __syncwarp();
                for (int i = r; i < M; i += 32) {
                    if (i > k) {
                        Am[i * MP + k] = ws[i];
                        Am[k * MP + i] = ws[i];
                    }
                }
                if (r == 0) dv[k] = dk;
            } else {
                const int k1 = (k + 1 < M) ? k + 1 : M - 1;
                const T a11 = Am[k * MP + k];
                const T a21 = Am[k1 * MP + k];
                const T a22 = Am[k1 * MP + k1];
                const T det = a11 * a22 - a21 * a21;
                const T sdet = (det == T(0)) ? T(1) : det;
                for (int i = r; i < M; i += 32) {
                    const bool below = i > k + 1;
                    const T w1 = below ? Am[i * MP + k] : T(0);
                    const T w2 = below ? Am[i * MP + k1] : T(0);
                    ws[i] = (w1 * a22 - w2 * a21) / sdet;           // l1
                    ws[M + i] = (w2 * a11 - w1 * a21) / sdet;       // l2
                    ws[2 * M + i] = w1;
                    ws[3 * M + i] = w2;
                }
                __syncwarp();
#pragma unroll 1
                for (int i = r; i < M; i += 32) {
                    const T l1 = ws[i], l2 = ws[M + i];
                    T* arow = Am + i * MP;
#pragma unroll 5
                    for (int j = 0; j < M; ++j)
                        arow[j] = (arow[j] - l1 * ws[2 * M + j])
                                  - l2 * ws[3 * M + j];
                }
                __syncwarp();
                for (int i = r; i < M; i += 32) {
                    if (i > k + 1) {
                        Am[i * MP + k] = ws[i];
                        Am[k * MP + i] = ws[i];
                        Am[i * MP + k1] = ws[M + i];
                        Am[k1 * MP + i] = ws[M + i];
                    }
                }
                if (r == 0) {
                    dv[k] = a11;
                    if (k + 1 < M) dv[k + 1] = a22;
                    ev[k] = a21;
                }
            }
            __syncwarp();
            k += kstep;
        }

        // ---- inertia: positive eigenvalues of D at atol (1x1, 2x2) ----
        int npos_part = 0;
        for (int q = r; q < M; q += 32) {
            const T d = dv[q], e = ev[q];
            const bool is2 = e != T(0);
            const bool second = q > 0 && ev[q - 1] != T(0);
            if (!(is2 || second)) npos_part += (d > atol) ? 1 : 0;
            if (is2) {
                const T d2 = (q + 1 < M) ? dv[q + 1] : T(0);
                const T adi = fabs(d), adx = fabs(d2);
                const T s1b = T(2) * bk_max(bk_max(adi, fabs(e)), adx);
                const T sf = (s1b == T(0)) ? T(1) : s1b;
                const T det_lo = (adi >= adx)
                    ? (d / sf) * d2 - (e / sf) * e
                    : d * (d2 / sf) - (e / sf) * e;
                const T smin = fabs(det_lo);
                const T trace = d + d2;
                const bool both_zero = T(0.5) * s1b <= atol;
                const bool pair = !both_zero && (smin > atol || trace == T(0));
                const bool one_zero = !both_zero && !pair;
                npos_part += (pair || (one_zero && trace >= T(0))) ? 1 : 0;
            }
        }
        const int n_pos = __reduce_add_sync(FULL, npos_part);

        PROF(1)
        // ---- plain substitution for all right-hand sides ----
        for (int q = r; q < M * NK; q += 32) {
            const int i = q / NK, c = q - i * NK;
            ys[q] = rs[(int)pm[i] * NK + c];
        }
        __syncwarp();
#pragma unroll 1
        for (int j = 0; j < M - 1; ++j) {          // y <- L^-1 y
            for (int q = r; q < (M - 1 - j) * NK; q += 32) {
                const int i = j + 1 + q / NK, c = q % NK;
                ys[i * NK + c] -= bk_l(Am, ev, i, j) * ys[j * NK + c];
            }
            __syncwarp();
        }
        for (int q = r; q < M * NK; q += 32) {     // z <- D^-1 y
            const int i = q / NK;
            const T d = dv[i], e = ev[i], y = ys[q];
            T z;
            if (e != T(0)) {
                const T d2 = (i + 1 < M) ? dv[i + 1] : T(0);
                const T det = d * d2 - e * e;
                const T yn = (i + 1 < M) ? ys[q + NK] : T(0);
                z = (d2 * y - e * yn) / ((det == T(0)) ? T(1) : det);
            } else if (i > 0 && ev[i - 1] != T(0)) {
                const T dp = dv[i - 1], ep = ev[i - 1];
                const T det = dp * d - ep * ep;
                z = (dp * y - ep * ys[q - NK]) / ((det == T(0)) ? T(1) : det);
            } else {
                z = y / ((d == T(0)) ? T(1) : d);
            }
            zs[q] = z;
        }
        __syncwarp();
#pragma unroll 1
        for (int j = M - 1; j > 0; --j) {          // x <- L^-T z
            for (int q = r; q < j * NK; q += 32) {
                const int i = q / NK, c = q - i * NK;
                zs[q] -= bk_l(Am, ev, j, i) * zs[j * NK + c];
            }
            __syncwarp();
        }
        for (int q = r; q < M * NK; q += 32) {     // undo the permutation
            const int i = q / NK, c = q - i * NK;
            xs[(int)pm[i] * NK + c] = zs[q];
        }
        __syncwarp();

        PROF(2)
        // ---- gains ----
        for (int row = r; row < M; row += 32) {
            if (!valid) break;
            const T* x = xs + row * NK;
            if (row < NU) {
                const int i = row;
                const T sl = T(1) / il_t[i];
                const T su = T(1) / iu_t[i];
                const T sig_l = zl_t[i] * sl;
                const T sig_u = zu_t[i] * su;
                alpha[s * NU + i] = x[0];
                chi_l[s * NU + i] = mu * sl - zl_t[i] - sig_l * x[0];
                chi_u[s * NU + i] = mu * su - zu_t[i] + sig_u * x[0];
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    const T be = x[1 + j];
                    beta[(s * NU + i) * NX + j] = be;
                    zeta_l[(s * NU + i) * NX + j] = -sig_l * be;
                    zeta_u[(s * NU + i) * NX + j] = sig_u * be;
                }
            } else {
                const int c = row - NU;
                psi[s * NC + c] = x[0];
#pragma unroll
                for (int j = 0; j < NX; ++j)
                    omega[(s * NC + c) * NX + j] = x[1 + j];
            }
        }

        PROF(3)
        // ---- value recursion, as the LDL^T kernel (rs: -Qu, -B, -c, -cx;
        // xs: the gains) ----
        constexpr int NV = NX * NX + NX + 1;
        for (int task = r; task < NV; task += 32) {
            if (task < NX * NX) {
                const int i = task / NX, j = task - i * NX;
                T g = T(0);
#pragma unroll 5
                for (int q = 0; q < M; ++q)
                    g += xs[q * NK + 1 + i] * rs[q * NK + 1 + j];
                cs[task] -= g;
            } else if (task < NX * NX + NX) {
                const int i = task - NX * NX;
                T v = lx_t[i];
#pragma unroll
                for (int c = 0; c < NC; ++c) v += cx_t[c * NX + i] * phi_t[c];
                T gq = T(0);
#pragma unroll 5
                for (int q = 0; q < M; ++q)
                    gq += xs[q * NK + 1 + i] * rs[q * NK];
                v -= gq;
#pragma unroll
                for (int k2 = 0; k2 < NX; ++k2) v += fx_t[k2 * NX + i] * vx[k2];
                vxn[i] = v;
            } else {
                T dq = T(0);
#pragma unroll 5
                for (int q = 0; q < M; ++q) dq += rs[q * NK] * xs[q * NK];
                dL -= dq;
            }
        }
        __syncwarp();
        for (int task = r; task < NX * NX; task += 32) {
            const int i = task / NX, j = task - i * NX;
            const int lo = i < j ? i : j, hi = i < j ? j : i;
            vxx[task] = (i == j) ? cs[task]
                : T(0.5) * (cs[lo * NX + hi] + cs[hi * NX + lo]);
        }
        for (int i = r; i < NX; i += 32) vx[i] = vxn[i];

        PROF(4)
        const bool stage_ok = (info == 0) && (n_pos == NU);
        if (!fail && !stage_ok && info > 0) singular = true;
        fail = fail || !stage_ok;
    }

    if (valid && r == (NX * NX + NX) % 32) ((T*)a.dL)[b] = dL;
    if (valid && r == 0) {
        a.fail[b] = fail ? 1 : 0;
        a.singular[b] = singular ? 1 : 0;
    }
}
