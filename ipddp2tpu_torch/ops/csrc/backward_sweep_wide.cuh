// The LDL^T sweep for KKT sizes 32 < m <= 64, included by backward_sweep.cu
// when NU + NC > 32 (no define: the size decides). It is the same kernel as
// the m <= 32 one there (K1 / K2: the same pivoted LDL^T, inertia count,
// iterative refinement and residual gate, the same arithmetic step for
// step), laid out as the Bunch-Kaufman instantiation lays out its warp:
//
//  * One warp owns an instance (a group of at most 32 lanes cannot hold m
//    rows; cartpole's KKT matrix has m = 35). Lane r owns rows r and r + 32.
//  * The working matrix lives in shared memory [m][m + 1] beside the KKT
//    matrix the residuals read (the m <= 32 kernel keeps its working row in
//    registers; two rows of up to 64 values a lane would not fit). Each
//    lane keeps the diagonal entries of its rows, their right-hand sides,
//    solutions and residuals in registers.
//  * Pivot search: each lane takes the better of its two rows by the rule
//    of the m <= 32 kernel (the larger |d|, the lower index on ties, a NaN
//    before any number, the first NaN), then the xor butterfly over the 32
//    lanes. Pivoting stays implicit: L goes to shared memory [step][row],
//    the pivot order beside it.
//  * Elimination of a pivot: every lane reads the pivot row from shared
//    memory (one address for all lanes, a broadcast) and updates the rows
//    of its own that are still live; a row that is gone is never read
//    again, and the pivot row itself is not written in its step. The
//    right-hand sides ride along as in the m <= 32 kernel, the pivot row's
//    values broadcast by shuffles. `__syncwarp` closes every step.
//  * Substitution, refinement, the gate's sums, the gains and the value
//    recursion as there, each lane for its two rows; the sums over the
//    rows are warp-wide butterflies.
//
// What bounds it: latency, as the m <= 32 kernel, with a longer chain (m
// steps, each a shared-memory update of m values on at most two rows a
// lane). A block is 4 warps where its double shared memory fits 227 KB,
// else 2, else 1 (`launch_geometry` in the wrapper). The plain version is
// `ipddp2tpu_torch.backward.sweep_plain(..., inertia="ldl")`.

#pragma once

static_assert(M > 32 && M <= 64, "the wide LDL^T sweep takes 32 < m <= 64");

constexpr int WP = M + 1;        // row stride of the L mirror [step][row]

template <typename T>
struct LayW {
    static constexpr int K0 = 2 * Lay<T>::IN_LEN;   // KKT matrix [M][MP]
    static constexpr int W0 = K0 + M * MP;          // working copy [M][MP]
    static constexpr int LS = W0 + M * MP;          // L mirror [M steps][WP]
    static constexpr int RS = LS + M * WP;          // right-hand sides [M][NK]
    static constexpr int XS = RS + M * NK;          // solution [M][NK]
    static constexpr int CS = XS + M * NK;          // C, then unsymmetrized Vxx
    static constexpr int VXX = CS + NX * NX;        // value Hessian carry
    static constexpr int VX = VXX + NX * NX;        // value gradient carry
    static constexpr int VXN = VX + NX;             // next value gradient
    static constexpr int PV = VXN + NX;             // pivot row of each step
    static constexpr int INST = up<T>(PV + M);      // values per instance
};

// (o, oi) before (b, bi) under the pivot rule of the m <= 32 kernel
template <typename T>
__device__ __forceinline__ bool wide_before(T o, int oi, T b, int bi) {
    const bool onan = o != o, bnan = b != b;
    return (onan || bnan) ? (onan && (!bnan || oi < bi))
                          : (o > b || (o == b && oi < bi));
}

template <typename T>
__global__ void __launch_bounds__(NT)
backward_sweep_wide_kernel(const SweepArgs a, const int B, const int Tn,
                           const int refine, const T rtol) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using S = Lay<T>;
    using L = LayW<T>;
    const int r = threadIdx.x % 32;           // lane; owns rows r, r + 32
    const int grp = threadIdx.x / 32;         // instance (warp) of the block
    const int b_raw = blockIdx.x * IPB + grp;
    const bool valid = b_raw < B;             // a ragged last block repeats
    const int b = valid ? b_raw : B - 1;      // the last instance, stores none
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + (size_t)grp * L::INST;
    int row[2];
    bool row_ok[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        row[q] = r + 32 * q;
        row_ok[q] = row[q] < M;
    }

    T* __restrict__ k0s = sm + L::K0;
    T* __restrict__ ws = sm + L::W0;
    T* __restrict__ ls = sm + L::LS;
    T* __restrict__ rs = sm + L::RS;
    T* __restrict__ xs = sm + L::XS;
    T* __restrict__ cs = sm + L::CS;
    T* __restrict__ vxx = sm + L::VXX;
    T* __restrict__ vx = sm + L::VX;
    T* __restrict__ vxn = sm + L::VXN;
    T* __restrict__ pv = sm + L::PV;

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

        // ---- assembly: rows r and r + 32 of K (twice: K and the working
        // copy) and of the rhs, as the m <= 32 kernel forms a row ----
        T rhs[2][NK], diag[2];
        T ssa_part = T(0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            diag[q] = T(0);
#pragma unroll
            for (int c = 0; c < NK; ++c) rhs[q][c] = T(0);
            if (!row_ok[q]) continue;
            T* krow = k0s + row[q] * MP;
            T* wrow = ws + row[q] * MP;
            if (row[q] < NU) {
                const int i = row[q];
                T fui[NX], fuv[NX];      // column i of fu; row i of fu^T Vxx'
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
                rhs[q][0] = -qu;
#pragma unroll
                for (int j = 0; j < NX; ++j) {   // B = lux + fuV fx + sec_ux
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fuv[k] * fx_t[k * NX + j];
                    rhs[q][1 + j] = -(lux_t[i * NX + j] + acc
                                      + sec_t[(NX + i) * NZ + j]);
                }
#pragma unroll 1
                for (int j = 0; j < NU; ++j) {   // H = luu + fuV fu + sec_uu
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fuv[k] * fu_t[k * NU + j];
                    T h = luu_t[i * NU + j] + acc + sec_t[(NX + i) * NZ + NX + j];
                    if (i == j) {
                        h = h + (zl_t[i] * sl + zu_t[i] * su) + reg;
                        diag[q] = h;
                    }
                    krow[j] = h;
                    wrow[j] = h;
                    ssa_part += h * h;
                }
#pragma unroll 1
                for (int c = 0; c < NC; ++c) {
                    const T v = cu_t[c * NU + i];
                    krow[NU + c] = v;
                    wrow[NU + c] = v;
                    ssa_part += v * v;
                }
            } else {
                const int c = row[q] - NU;
#pragma unroll 1
                for (int j = 0; j < NU; ++j) {
                    const T v = cu_t[c * NU + j];
                    krow[j] = v;
                    wrow[j] = v;
                    ssa_part += v * v;
                }
#pragma unroll 1
                for (int c2 = 0; c2 < NC; ++c2) {
                    const T v = (c2 == c) ? -dc : T(0);
                    krow[NU + c2] = v;
                    wrow[NU + c2] = v;
                    ssa_part += v * v;
                }
                diag[q] = -dc;
                rhs[q][0] = -c_t[c];
#pragma unroll
                for (int j = 0; j < NX; ++j) rhs[q][1 + j] = -cx_t[c * NX + j];
            }
#pragma unroll
            for (int c = 0; c < NK; ++c) rs[row[q] * NK + c] = rhs[q][c];
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
        __syncwarp();                    // the working copy is complete

        PROF(0)
        // ---- LDL^T with implicit max-|diagonal| pivoting, rows over lanes ----
        bool live[2];
        int my_step[2];
        T my_d[2], y0[2][NK];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            live[q] = row_ok[q];
            my_step[q] = M;              // never reached by a row that is none
            my_d[q] = T(1);
#pragma unroll
            for (int c = 0; c < NK; ++c) y0[q][c] = rhs[q][c];
        }
        int n_pos = 0, n_zero = 0;
        bool d_finite = true;
#pragma unroll 1
        for (int j = 0; j < M; ++j) {
            // arg-max of |diagonal| over the live rows: this lane's better
            // row, then the butterfly; rows that are gone carry -1
            T bav = live[0] ? fabs(diag[0]) : T(-1);
            int bidx = row[0];
            {
                const T v1 = live[1] ? fabs(diag[1]) : T(-1);
                if (wide_before(v1, row[1], bav, bidx)) {
                    bav = v1;
                    bidx = row[1];
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const T oav = __shfl_xor_sync(FULL, bav, off);
                const int oidx = __shfl_xor_sync(FULL, bidx, off);
                if (wide_before(oav, oidx, bav, bidx)) {
                    bav = oav;
                    bidx = oidx;
                }
            }
            const int p = bidx;
            const int pl = p & 31;               // the pivot row's lane
            const bool pq = p >= 32;             // and its slot there
            const T dj = __shfl_sync(FULL, pq ? diag[1] : diag[0], pl);
            const T safe = (dj == T(0)) ? T(1) : dj;   // zero-pivot guard
            if (r == 0) pv[j] = T(p);
            n_pos += (dj > T(0));
            n_zero += (dj == T(0));
            d_finite = d_finite && finite_(dj);
            T yb[NK];
#pragma unroll
            for (int c = 0; c < NK; ++c)
                yb[c] = __shfl_sync(FULL, pq ? y0[1][c] : y0[0][c], pl);
            const T* __restrict__ prow = ws + p * MP;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if (row[q] == p) {
                    live[q] = false;
                    my_step[q] = j;
                    my_d[q] = safe;
                }
                if (!row_ok[q]) continue;
                T* __restrict__ wrow = ws + row[q] * MP;
                // this row's entry of the pivot column; only a live row with
                // a numerator other than 0 divides (see the m <= 32 kernel)
                const T wp = wrow[p];
                const bool divide = live[q] && wp != T(0);
                const T l = divide ? wp / safe : T(0);
                ls[j * WP + row[q]] = l;
#pragma unroll
                for (int c = 0; c < NK; ++c) y0[q][c] -= l * yb[c];
                if (!live[q]) continue;
                // Schur update W(i, k) -= L(i, j) dj L(k, j) from the pivot's
                // row; nothing where the pivot is an exact zero
                const T lu = (dj == T(0)) ? T(0) : l;
#pragma unroll 5
                for (int k = 0; k < M; ++k) wrow[k] -= lu * prow[k];
                diag[q] -= lu * wp;
            }
            __syncwarp();                // the rows are updated before the
                                         // next step reads its pivot row
        }

        PROF(1)
        // ---- solve, refine, gate: all right-hand sides together ----
        T x[2][NK];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int c = 0; c < NK; ++c) x[q][c] = T(0);
        T ssr_part = T(0), ssx_part = T(0), ssb_part = T(0);
        bool x_finite = true;
#pragma unroll 1
        for (int pass = 0; pass <= refine + 1; ++pass) {
            T res[2][NK];
            if (pass == 0) {             // forward substitution done above
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                    for (int c = 0; c < NK; ++c) res[q][c] = y0[q][c];
            } else {
                __syncwarp();            // the last residual has been read
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    if (!row_ok[q]) continue;
#pragma unroll
                    for (int c = 0; c < NK; ++c) xs[row[q] * NK + c] = x[q][c];
                }
                __syncwarp();
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    T ax[NK];
#pragma unroll
                    for (int c = 0; c < NK; ++c) ax[c] = T(0);
                    const int rr = row_ok[q] ? row[q] : M - 1;
#pragma unroll 5
                    for (int k = 0; k < M; ++k) {
                        const T kv = k0s[rr * MP + k];
#pragma unroll
                        for (int c = 0; c < NK; ++c) ax[c] += kv * xs[k * NK + c];
                    }
#pragma unroll
                    for (int c = 0; c < NK; ++c)
                        res[q][c] = row_ok[q] ? rhs[q][c] - ax[c] : T(0);
                }
            }
            if (pass == refine + 1) {
#pragma unroll
                for (int q = 0; q < 2; ++q)
#pragma unroll
                    for (int c = 0; c < NK; ++c) {
                        ssr_part += res[q][c] * res[q][c];
                        ssb_part += rhs[q][c] * rhs[q][c];
                        ssx_part += x[q][c] * x[q][c];
                        x_finite = x_finite && finite_(x[q][c]);
                    }
                break;
            }
            if (pass > 0) {              // y <- L^-1 P y, a column a step
#pragma unroll 1
                for (int j = 0; j < M; ++j) {
                    const int pj = (int)pv[j];
                    const bool pq = pj >= 32;
                    T yb[NK];
#pragma unroll
                    for (int c = 0; c < NK; ++c)
                        yb[c] = __shfl_sync(FULL, pq ? res[1][c] : res[0][c],
                                            pj & 31);
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const T lj = ls[j * WP + (row_ok[q] ? row[q] : M - 1)];
#pragma unroll
                        for (int c = 0; c < NK; ++c) res[q][c] -= lj * yb[c];
                    }
                }
            }
            // y <- the solution of L^T x = D^-1 y, from the last pivot: every
            // row takes L(pivot, own step) x_pivot off its own entry
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int c = 0; c < NK; ++c) res[q][c] = res[q][c] / my_d[q];
#pragma unroll 1
            for (int i = M - 1; i >= 0; --i) {
                const int pi = (int)pv[i];
                const bool pq = pi >= 32;
                T xb[NK];
#pragma unroll
                for (int c = 0; c < NK; ++c)
                    xb[c] = __shfl_sync(FULL, pq ? res[1][c] : res[0][c],
                                        pi & 31);
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const T lv = ls[(row_ok[q] ? my_step[q] : 0) * WP + pi];
#pragma unroll
                    for (int c = 0; c < NK; ++c) res[q][c] -= lv * xb[c];
                }
            }
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int c = 0; c < NK; ++c)
                    x[q][c] = row_ok[q]
                        ? ((pass == 0) ? res[q][c] : x[q][c] + res[q][c])
                        : T(0);
        }
        const T ssr = group_sum(ssr_part), ssa = group_sum(ssa_part);
        const T ssx = group_sum(ssx_part), ssb = group_sum(ssb_part);
        const unsigned fin = __ballot_sync(FULL, x_finite);
        const bool solve_ok =
            (sqrt(ssr) <= rtol * (sqrt(ssa) * sqrt(ssx) + sqrt(ssb)))
            && (fin == FULL);

        PROF(2)
        // ---- gains: each lane writes its rows ----
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            if (!valid || !row_ok[q]) continue;
            if (row[q] < NU) {
                const int i = row[q];
                const T sl = T(1) / il_t[i];
                const T su = T(1) / iu_t[i];
                const T sig_l = zl_t[i] * sl;
                const T sig_u = zu_t[i] * su;
                alpha[s * NU + i] = x[q][0];
                chi_l[s * NU + i] = mu * sl - zl_t[i] - sig_l * x[q][0];
                chi_u[s * NU + i] = mu * su - zu_t[i] + sig_u * x[q][0];
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    const T be = x[q][1 + j];
                    beta[(s * NU + i) * NX + j] = be;
                    zeta_l[(s * NU + i) * NX + j] = -sig_l * be;
                    zeta_u[(s * NU + i) * NX + j] = sig_u * be;
                }
            } else {
                const int c = row[q] - NU;
                psi[s * NC + c] = x[q][0];
#pragma unroll
                for (int j = 0; j < NX; ++j)
                    omega[(s * NC + c) * NX + j] = x[q][1 + j];
            }
        }

        PROF(3)
        // ---- value recursion (rs: -Qu, -B, -c, -cx; xs: the gains) ----
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
                for (int k = 0; k < NX; ++k) v += fx_t[k * NX + i] * vx[k];
                vxn[i] = v;
            } else {
                T dq = T(0);
#pragma unroll 5
                for (int q = 0; q < M; ++q) dq += rs[q * NK] * xs[q * NK];
                dL -= dq;
            }
        }
        __syncwarp();
        // Symmetrize: roundoff asymmetry is amplified stage by stage otherwise.
        for (int task = r; task < NX * NX; task += 32) {
            const int i = task / NX, j = task - i * NX;
            const int lo = i < j ? i : j, hi = i < j ? j : i;
            vxx[task] = (i == j) ? cs[task]
                : T(0.5) * (cs[lo * NX + hi] + cs[hi * NX + lo]);
        }
        for (int i = r; i < NX; i += 32) vx[i] = vxn[i];

        PROF(4)
        const bool stage_ok =
            d_finite && (n_zero == 0) && (n_pos == NU) && solve_ok;
        if (!fail && !stage_ok && n_zero > 0) singular = true;
        fail = fail || !stage_ok;
    }

    if (valid && r == (NX * NX + NX) % 32) ((T*)a.dL)[b] = dL;
    if (valid && r == 0) {
        a.fail[b] = fail ? 1 : 0;
        a.singular[b] = singular ? 1 : 0;
    }
}
