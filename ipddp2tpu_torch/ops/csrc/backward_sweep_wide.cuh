// The LDL^T sweep for KKT sizes 32 < m <= 64, included by backward_sweep.cu
// when NU + NC > 32 (no define: the size decides). It is the same kernel as
// the m <= 32 one there (K1 / K2: the same pivoted LDL^T, inertia count,
// iterative refinement and residual gate), for a size that a group of at
// most 32 lanes cannot hold: cartpole's KKT matrix has m = 35. It replaces
// K1 / K2 (ipddp2tpu/ops/backward_pallas.py::backward_sweep_pallas,
// ipddp2tpu/ops/backward_pallas_df64.py::backward_sweep_pallas_df64) above
// m = 32, which the Pallas kernels take on the TPU.
//
// What bounds it: latency, as the m <= 32 kernel, with a longer chain (m
// pivot steps a stage), and at B = 100 one instance on each busy
// scheduler. The design keeps each step short and spreads it over more
// threads, on the skeleton of the Bunch-Kaufman sweep (sweep_instance.cuh):
//
//  * G = 32 WPI threads own an instance, WPI = 1, 2 or 4 warps
//    (`launch_geometry` chooses, -DWPI); the phases of a stage end at a
//    named barrier of the instance (`inst_sync`). Thread i % G forms row i.
//  * The working matrix lives in shared memory [m][m | 1] beside the KKT
//    matrix that the residuals read, the diagonal the pivot search reads
//    and the right-hand sides, forward-substituted as the elimination goes.
//  * Pivot search: the largest |diagonal| over the live rows, the lowest
//    index on ties, a NaN first: an order key of |d| and the warp's integer
//    max (`inst_argmax`), the warps' winners meeting in shared memory.
//    Pivoting stays implicit: L goes to shared memory [step][row], the pivot
//    order beside it, and a list of the live rows.
//  * Elimination of a pivot: each row's multiplier, its diagonal and its
//    right-hand sides by the row's thread; then the live rows' live entries,
//    dealt over all G threads as a flat index, each W(i, k) -= l_i W(p, k)
//    as the first design wrote it (a row's entries there were all updated,
//    the eliminated columns never read again), so the factor is the same bit
//    for bit.
//  * Substitution and refinement: the first warp, lane r its rows r and
//    r + 32 in registers as in the first design (shuffles, no barrier); the
//    residual K X - rhs of each pass is dealt over all G threads, an entry
//    a thread, each summing its row in the same order as before. The gate's
//    sums of squares go over the first warp, ||K||_F over all threads.
//  * Assembly, gains and the value recursion as the m <= 32 kernel, rows
//    and tasks over the G threads.
//
// A block is 4 warps where its double shared memory fits 227 KB, else 2,
// else 1 (`launch_geometry` in the wrapper). The plain version is
// `ipddp2tpu_torch.backward.sweep_plain(..., inertia="ldl")`.
//
// What holds it back now (the H100, cartpole's 100 campaign states, f64, 4
// warps): a stage is about 122,000 clocks: factor 85,000 (35 pivot steps
// of about 2,400, the same chain as the Bunch-Kaufman sweep's), solve
// 26,000 (the refinement's serial substitutions on one warp, as in the
// first design), assemble 7,800.

#pragma once

static_assert(M > 32 && M <= 64, "the wide LDL^T sweep takes 32 < m <= 64");

constexpr int WP = AP;           // row stride of the L mirror [step][row]

template <typename T>
struct LayW {
    static constexpr int K0 = 2 * Lay<T>::IN_LEN;   // KKT matrix [M][AP]
    static constexpr int W0 = K0 + M * AP;          // working copy [M][AP]
    static constexpr int LS = W0 + M * AP;          // L mirror [M steps][WP]
    static constexpr int RS = LS + M * WP;          // right-hand sides [M][NK]
    static constexpr int YS = RS + M * NK;          // forward-substituted
    static constexpr int XS = YS + M * NK;          // solution [M][NK]
    static constexpr int ZS = XS + M * NK;          // residuals [M][NK]
    static constexpr int CS = ZS + M * NK;          // C, then unsymmetrized Vxx
    static constexpr int VXX = CS + NX * NX;        // value Hessian carry
    static constexpr int VX = VXX + NX * NX;        // value gradient carry
    static constexpr int VXN = VX + NX;             // next value gradient
    static constexpr int DG = VXN + NX;             // diagonal of the rows
    static constexpr int LU = DG + M;               // multiplier of a step
    static constexpr int PV = LU + M;               // pivot row of each step
    static constexpr int SP = PV + M;               // step of each row (M: live)
    static constexpr int MD = SP + M;               // pivot of each row, guarded
    static constexpr int LR = MD + M;               // live rows, then pivots
    static constexpr int LP = LR + M;               // place of a row in LR
    static constexpr int RED = up<T>(LP + M);       // reduction buffers
    static constexpr int INST = up<T>(RED + red_values<T>());
};

template <typename T>
__global__ void __launch_bounds__(NT)
backward_sweep_wide_kernel(const SweepArgs a, const int B, const int Tn,
                           const int refine, const T rtol) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using S = Lay<T>;
    using L = LayW<T>;
    const int r = threadIdx.x % G;            // thread of the instance
    const int grp = threadIdx.x / G;          // instance of the block
    const int b_raw = blockIdx.x * IPB + grp;
    const bool valid = b_raw < B;             // a ragged last block repeats
    const int b = valid ? b_raw : B - 1;      // the last instance, stores none
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + (size_t)grp * L::INST;

    T* __restrict__ k0s = sm + L::K0;
    T* __restrict__ ws = sm + L::W0;
    T* __restrict__ ls = sm + L::LS;
    T* __restrict__ rs = sm + L::RS;
    T* __restrict__ ys = sm + L::YS;
    T* __restrict__ xs = sm + L::XS;
    T* __restrict__ zs = sm + L::ZS;
    T* __restrict__ cs = sm + L::CS;
    T* __restrict__ vxx = sm + L::VXX;
    T* __restrict__ vx = sm + L::VX;
    T* __restrict__ vxn = sm + L::VXN;
    T* __restrict__ dg = sm + L::DG;
    T* __restrict__ lus = sm + L::LU;
    T* __restrict__ pv = sm + L::PV;
    T* __restrict__ sp = sm + L::SP;
    T* __restrict__ md = sm + L::MD;
    T* __restrict__ lr = sm + L::LR;
    T* __restrict__ lp = sm + L::LP;
    unsigned long long* red =
        reinterpret_cast<unsigned long long*>(sm + L::RED);
    int buf = 0;

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
    for (int i = r; i < NX; i += G) vx[i] = ((const T*)a.lTx)[b * NX + i];
    for (int i = r; i < NX * NX; i += G)
        vxx[i] = ((const T*)a.lTxx)[(size_t)b * NX * NX + i];

    T dL = T(0);                     // held by the thread of the last task
    bool fail = false, singular = false;

#pragma unroll 1
    for (int t = Tn - 1; t >= 0; --t) {
        const size_t s = (size_t)b * Tn + t;
        long long tick = (a.prof != nullptr) ? clock64() : 0;
        const int cur = (Tn - 1 - t) & 1;
        T* __restrict__ in = sm + cur * S::IN_LEN;
        inst_sync(grp);
        if (t > 0) copy_stage<T>(sm + (cur ^ 1) * S::IN_LEN, a, s - 1, r);
        cp_async_commit();
        cp_async_wait_but_one();
        inst_sync(grp);

        const T* fx_t = in + S::FX;    const T* fu_t = in + S::FU;
        const T* lx_t = in + S::LX;    const T* lu_t = in + S::LU;
        const T* lxx_t = in + S::LXX;  const T* lux_t = in + S::LUX;
        const T* luu_t = in + S::LUU;  const T* cx_t = in + S::CX;
        const T* cu_t = in + S::CU;    const T* sec_t = in + S::SEC;
        const T* c_t = in + S::CC;     const T* il_t = in + S::IL;
        const T* iu_t = in + S::IU;    const T* phi_t = in + S::PHI;
        const T* zl_t = in + S::ZL;    const T* zu_t = in + S::ZU;

        // ---- assembly: row i of K (twice: K and the working copy), its
        // diagonal and its rhs (twice) by thread i % G ----
        T ssa_part = T(0);
#pragma unroll 1
        for (int row = r; row < M; row += G) {
            T* krow = k0s + row * AP;
            T* wrow = ws + row * AP;
            T rhs[NK];
            T diag = T(0);
            if (row < NU) {
                const int i = row;
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
                rhs[0] = -qu;
#pragma unroll
                for (int j = 0; j < NX; ++j) {   // B = lux + fuV fx + sec_ux
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fuv[k] * fx_t[k * NX + j];
                    rhs[1 + j] = -(lux_t[i * NX + j] + acc
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
                        diag = h;
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
                const int c = row - NU;
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
                diag = -dc;
                rhs[0] = -c_t[c];
#pragma unroll
                for (int j = 0; j < NX; ++j) rhs[1 + j] = -cx_t[c * NX + j];
            }
#pragma unroll
            for (int c = 0; c < NK; ++c) {
                rs[row * NK + c] = rhs[c];
                ys[row * NK + c] = rhs[c];
            }
            dg[row] = diag;
            sp[row] = T(M);
            lr[row] = T(row);
            lp[row] = T(row);
        }
        // C = lxx + sec_xx + fx^T Vxx' fx, row ri on thread G - 1 - ri % G
        for (int ri = G - 1 - r; ri < NX; ri += G) {
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
        const T ssa = inst_sum(ssa_part, red, buf, grp);
        inst_sync(grp);                  // the working copy is complete

        PROF(0)
        // ---- LDL^T with implicit max-|diagonal| pivoting ----
        int n_pos = 0, n_zero = 0;
        bool d_finite = true;
#pragma unroll 1
        for (int j = 0; j < M; ++j) {
            // arg-max of |diagonal| over the live rows
            Key<T> key = 0;
            int p = INT_MAX;
            for (int i = r; i < M; i += G) {
                const Key<T> ki = order_key(fabs(dg[i]), sp[i] == T(M));
                if (key_before(ki, i, key, p)) {
                    key = ki;
                    p = i;
                }
            }
            inst_argmax(key, p, red, buf, grp);
            PROF_FINE(0)
            const T dj = dg[p];
            const T safe = (dj == T(0)) ? T(1) : dj;   // zero-pivot guard
            n_pos += (dj > T(0));
            n_zero += (dj == T(0));
            d_finite = d_finite && finite_(dj);
            // each row's multiplier (only a live row with a numerator other
            // than 0 divides, see the m <= 32 kernel), diagonal and rhs; the
            // pivot row's rhs after the barrier, once every row has read it
            for (int i = r; i < M; i += G) {
                const bool live = sp[i] == T(M) && i != p;
                const T wp = ws[i * AP + p];
                const bool divide = live && wp != T(0);
                const T l = divide ? wp / safe : T(0);
                ls[j * WP + i] = l;
                if (i != p) {
#pragma unroll
                    for (int c = 0; c < NK; ++c)
                        ys[i * NK + c] -= l * ys[p * NK + c];
                }
                // the Schur update's factor: nothing where the pivot is an
                // exact zero
                const T lu = (dj == T(0)) ? T(0) : l;
                lus[i] = lu;
                if (live) dg[i] -= lu * wp;
            }
            if (r == 0) {
                pv[j] = T(p);
                const int at = (int)lp[p], was = (int)lr[j];
                lr[at] = T(was);
                lp[was] = T(at);
                lr[j] = T(p);
                lp[p] = T(j);
            }
            inst_sync(grp);
            PROF_FINE(3)
            if (r == (p % G)) {
                sp[p] = T(j);
                md[p] = safe;
#pragma unroll
                for (int c = 0; c < NK; ++c)
                    ys[p * NK + c] -= T(0) * ys[p * NK + c];
            }
            // Schur update W(i, k) -= L(i, j) dj L(k, j) from the pivot's
            // row, over the live rows and columns
            const T* __restrict__ prow = ws + p * AP;
            const T* __restrict__ live = lr + j + 1;
            trailing_update(M - 1 - j, r, [&](int i_, int k_) {
                const int i = (int)live[i_], k = (int)live[k_];
                T* e = ws + i * AP + k;
                T v = *e;
                v -= lus[i] * prow[k];
                return Upd<T>{e, v};
            });
            inst_sync(grp);              // the rows are updated before the
                                         // next step reads its pivot row
            PROF_FINE(4)
        }

        PROF(1)
        // ---- solve, refine, gate: all right-hand sides together; the
        // first warp holds rows r and r + 32, the residuals over all ----
        T ssr_part = T(0), ssx_part = T(0), ssb_part = T(0);
        bool x_finite = true;
        T x[2][NK], rhs[2][NK];
        int row[2], my_step[2];
        bool row_ok[2];
        T my_d[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            row[q] = (r & 31) + 32 * q;
            row_ok[q] = row[q] < M;
            const int rr = row_ok[q] ? row[q] : M - 1;
            my_step[q] = row_ok[q] ? (int)sp[rr] : M;
            my_d[q] = row_ok[q] ? md[rr] : T(1);
#pragma unroll
            for (int c = 0; c < NK; ++c) {
                x[q][c] = T(0);
                rhs[q][c] = row_ok[q] ? rs[rr * NK + c] : T(0);
            }
        }
#pragma unroll 1
        for (int pass = 0; pass <= refine + 1; ++pass) {
            T res[2][NK];
            if (pass > 0) {
                if (r < 32) {
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        if (!row_ok[q]) continue;
#pragma unroll
                        for (int c = 0; c < NK; ++c)
                            xs[row[q] * NK + c] = x[q][c];
                    }
                }
                inst_sync(grp);
                // the residual rhs - K X, an entry a thread
                for (int e = r; e < M * NK; e += G) {
                    const int i = e / NK, c = e - i * NK;
                    T ax = T(0);
#pragma unroll 5
                    for (int k = 0; k < M; ++k)
                        ax += k0s[i * AP + k] * xs[k * NK + c];
                    zs[e] = rs[e] - ax;
                }
                inst_sync(grp);
            }
            if (r < 32) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int rr = row_ok[q] ? row[q] : M - 1;
#pragma unroll
                    for (int c = 0; c < NK; ++c)
                        res[q][c] = !row_ok[q] ? T(0)
                            : (pass == 0) ? ys[rr * NK + c] : zs[rr * NK + c];
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
                } else {
                    if (pass > 0) {      // y <- L^-1 P y, a column a step
#pragma unroll 4
                        for (int j = 0; j < M; ++j) {
                            const int pj = (int)pv[j];
                            const bool pq = pj >= 32;
                            T yb[NK];
#pragma unroll
                            for (int c = 0; c < NK; ++c)
                                yb[c] = __shfl_sync(
                                    FULL, pq ? res[1][c] : res[0][c], pj & 31);
#pragma unroll
                            for (int q = 0; q < 2; ++q) {
                                const T lj =
                                    ls[j * WP + (row_ok[q] ? row[q] : M - 1)];
#pragma unroll
                                for (int c = 0; c < NK; ++c)
                                    res[q][c] -= lj * yb[c];
                            }
                        }
                    }
                    // y <- the solution of L^T x = D^-1 y, from the last
                    // pivot: every row takes L(pivot, own step) x_pivot off
                    // its own entry
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int c = 0; c < NK; ++c)
                            res[q][c] = res[q][c] / my_d[q];
#pragma unroll 4
                    for (int i = M - 1; i >= 0; --i) {
                        const int pi = (int)pv[i];
                        const bool pq = pi >= 32;
                        T xb[NK];
#pragma unroll
                        for (int c = 0; c < NK; ++c)
                            xb[c] = __shfl_sync(
                                FULL, pq ? res[1][c] : res[0][c], pi & 31);
#pragma unroll
                        for (int q = 0; q < 2; ++q) {
                            const T lv = ls[(row_ok[q] ? my_step[q] : 0) * WP
                                            + pi];
#pragma unroll
                            for (int c = 0; c < NK; ++c)
                                res[q][c] -= lv * xb[c];
                        }
                    }
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                        for (int c = 0; c < NK; ++c)
                            x[q][c] = row_ok[q]
                                ? ((pass == 0) ? res[q][c]
                                               : x[q][c] + res[q][c])
                                : T(0);
                }
            }
        }
        bool solve_ok = false;
        if (r < 32) {
            const T ssr = warp_sum(ssr_part), ssx = warp_sum(ssx_part);
            const T ssb = warp_sum(ssb_part);
            const unsigned fin = __ballot_sync(FULL, x_finite);
            solve_ok = (sqrt(ssr) <= rtol * (sqrt(ssa) * sqrt(ssx) + sqrt(ssb)))
                       && (fin == FULL);
        }
        if constexpr (NW > 1) {
            // the first warp's verdict to the instance (xs holds the last X)
            solve_ok = inst_add(solve_ok ? 1 : 0, red, buf, grp) > 0;
        } else {
            inst_sync(grp);
        }

        PROF(2)
        // ---- gains: row i by thread i % G, from the solution ----
        for (int i_ = r; i_ < M; i_ += G) {
            if (!valid) break;
            const T* xr = xs + i_ * NK;
            if (i_ < NU) {
                const int i = i_;
                const T sl = T(1) / il_t[i];
                const T su = T(1) / iu_t[i];
                const T sig_l = zl_t[i] * sl;
                const T sig_u = zu_t[i] * su;
                alpha[s * NU + i] = xr[0];
                chi_l[s * NU + i] = mu * sl - zl_t[i] - sig_l * xr[0];
                chi_u[s * NU + i] = mu * su - zu_t[i] + sig_u * xr[0];
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    const T be = xr[1 + j];
                    beta[(s * NU + i) * NX + j] = be;
                    zeta_l[(s * NU + i) * NX + j] = -sig_l * be;
                    zeta_u[(s * NU + i) * NX + j] = sig_u * be;
                }
            } else {
                const int c = i_ - NU;
                psi[s * NC + c] = xr[0];
#pragma unroll
                for (int j = 0; j < NX; ++j)
                    omega[(s * NC + c) * NX + j] = xr[1 + j];
            }
        }

        PROF(3)
        // ---- value recursion (rs: -Qu, -B, -c, -cx; xs: the gains) ----
        constexpr int NV = NX * NX + NX + 1;
        for (int task = r; task < NV; task += G) {
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
        inst_sync(grp);
        // Symmetrize: roundoff asymmetry is amplified stage by stage otherwise.
        for (int task = r; task < NX * NX; task += G) {
            const int i = task / NX, j = task - i * NX;
            const int lo = i < j ? i : j, hi = i < j ? j : i;
            vxx[task] = (i == j) ? cs[task]
                : T(0.5) * (cs[lo * NX + hi] + cs[hi * NX + lo]);
        }
        for (int i = r; i < NX; i += G) vx[i] = vxn[i];

        PROF(4)
        const bool stage_ok =
            d_finite && (n_zero == 0) && (n_pos == NU) && solve_ok;
        if (!fail && !stage_ok && n_zero > 0) singular = true;
        fail = fail || !stage_ok;
    }

    if (valid && r == (NX * NX + NX) % G) ((T*)a.dL)[b] = dL;
    if (valid && r == 0) {
        a.fail[b] = fail ? 1 : 0;
        a.singular[b] = singular ? 1 : 0;
    }
}
