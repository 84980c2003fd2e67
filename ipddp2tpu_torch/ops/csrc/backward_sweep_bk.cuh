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
// What bounds it on this card: latency. The work is a chain of T dependent
// factorizations per instance whose every step depends on the data (which
// column, 1x1 or 2x2, how long the rook chain is); bytes and FP64
// operations are a small share of its time, and a B = 100 batch puts one
// instance on each busy scheduler, so nothing hides a latency. The design
// keeps the chain of each pivot step short and every thread of the
// instance busy:
//  * G = 32 WPI threads own an instance: one warp up to m = 32, four above
//    (`launch_geometry` chooses, -DWPI; 1, 2 or 4 to time them in turns:
//    at m = 35 four took 0.72x one's time). The working matrix lives
//    in shared memory [m][m | 1] (the odd stride keeps a column's reads
//    on distinct banks; 9.8 KB in double at m = 35).
//  * Each elimination updates only the entries still live: the trailing
//    (m - k - 1)^2 or (m - k - 2)^2 block, both triangles, dealt over all the
//    instance's threads as a flat index, so a thread's share shrinks with k
//    (acrobot: at most 7 entries at k = 0, where a row of 15 a lane idled 17
//    lanes). Each entry's arithmetic is the masked full-matrix update's of
//    the JAX package and of this kernel's first design, a - wdk (l_i l_j)
//    for a 1x1 pivot and (a - l1_i w1_j) - l2_i w2_j for a 2x2 one, so the
//    factor, the pivots, `info` and the inertia count are the same bit for
//    bit on finite stages. (That design's update also reached the rows and
//    columns already eliminated, where it changes nothing on finite data; on
//    a non-finite stage it spread NaN into the factor's eliminated part, not
//    into the decisions of the stage, so `fail` and `singular` stay the
//    plain version's; the crafted NaN lane holds that on the card.)
//  * Pivot search (the column's arg-max and each trip of the rook chain):
//    one read a thread and the warp's integer max on an order key of |a|
//    (`order_key`: a NaN first, masked entries below every 0), then the
//    lowest index among the winners, three reductions in double and two in
//    float where a xor butterfly took five rounds of three shuffles; above
//    a warp the warps' winners meet in shared memory. Every thread ends with
//    the same pivot, so the control flow stays uniform over the instance.
//  * Interchanges touch the two rows (their L part moves with them) and,
//    of the two columns, only the live rows; the permutation stays
//    explicit, so the substitution reads L in place.
//  * The forward substitution rides along: the nx + 1 right-hand sides are
//    extra columns of the elimination, swapped with their rows and updated
//    y_i -= L_ik y_k in the order of a column-wise solve (a 2x2 block's two
//    columns one after the other), the same arithmetic as a solve after
//    the factorization. What stays serial is the D solve and the backward
//    solve: one warp of the instance, each lane its rows in registers,
//    x_j broadcast by shuffles, no barrier.
//  * Stage inputs arrive in shared memory one stage ahead by `cp.async`, as
//    in the LDL^T kernel; assembly, gains and value recursion as there.
// The block holds 4 warps where its double shared memory fits 227 KB, else
// 2, else 1 (`launch_geometry(..., inertia="bk")` in the wrapper).
//
// What holds it back now (the H100, B = 100 campaign states, f64): a stage
// of acrobot is about 52,700 clocks (factor 36,000, solve 7,200, assemble
// 6,700, gains and value 2,700), a pivot step about 2,400 clocks whatever
// its size: with the counters on its steps (-DSWEEP_PROF_FINE, each read
// costing about 80 clocks) the column search takes about 570, the
// multipliers' division and barrier 590, the trailing update and its
// barrier 1,150, and two warps an instance (half the entries a thread)
// leave the step's time where it was. The step is a chain of shared-memory
// round trips, warp reductions and one division, each waiting for the last.
//
// Compile-time parameters as backward_sweep.cu (NX, NU, NC, IPB, WPI), plus
// SWEEP_BK=1. The `refine` argument is ignored and the tolerance argument is
// the inertia tolerance atol (Options.inertia_atol).

#pragma once

constexpr double BK_ALPHA = 0.6403882032022076;   // (1 + sqrt(17)) / 8

template <typename T>
struct LayBK {
    static constexpr int A0 = 2 * Lay<T>::IN_LEN;   // working matrix [M][AP]
    static constexpr int RS = A0 + M * AP;          // rhs [M][NK]
    static constexpr int YS = RS + M * NK;          // rhs in pivot order,
                                                    // forward-substituted
    static constexpr int XS = YS + M * NK;          // solution, original order
    static constexpr int CS = XS + M * NK;          // C, then unsymmetrized Vxx
    static constexpr int VXX = CS + NX * NX;        // value Hessian carry
    static constexpr int VX = VXX + NX * NX;        // value gradient carry
    static constexpr int VXN = VX + NX;             // next value gradient
    static constexpr int DV = VXN + NX;             // D diagonal [M]
    static constexpr int EV = DV + M;               // D subdiagonal [M]
    static constexpr int PM = EV + M;               // permutation [M]
    static constexpr int WS = PM + M;               // multipliers [4][M]
    static constexpr int RED = up<T>(WS + 4 * M);   // reduction buffers
    static constexpr int INST = up<T>(RED + red_values<T>());
};

// jnp.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T bk_max(T a, T b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// symmetric interchange of rows and columns i, j (> = k, rows first, as the
// JAX package's _sym_swap): the two rows over every column (the L part of a
// row moves with it) and their right-hand sides, then the two columns over
// the live rows k.., and the permutation
template <typename T>
__device__ __forceinline__ void bk_swap(T* __restrict__ A, T* __restrict__ ys,
                                        T* __restrict__ pm, const int i,
                                        const int j, const int k, const int r,
                                        const int grp) {
    for (int c = r; c < M + NK; c += G) {
        T* pi = c < M ? A + i * AP + c : ys + i * NK + (c - M);
        T* pj = c < M ? A + j * AP + c : ys + j * NK + (c - M);
        const T t = *pi;
        *pi = *pj;
        *pj = t;
    }
    inst_sync(grp);
    for (int q = k + r; q < M; q += G) {
        const T t = A[q * AP + i];
        A[q * AP + i] = A[q * AP + j];
        A[q * AP + j] = t;
    }
    if (r == 0) {
        const T t = pm[i];
        pm[i] = pm[j];
        pm[j] = t;
    }
    inst_sync(grp);
}

// L(i, j), i > j, from the factored matrix: the strict lower part, except
// the subdiagonal slot of a 2x2 block, which belongs to D
template <typename T>
__device__ __forceinline__ T bk_l(const T* __restrict__ A,
                                  const T* __restrict__ ev, const int i,
                                  const int j) {
    return (i == j + 1 && ev[j] != T(0)) ? T(0) : A[i * AP + j];
}

// arg-max of |A(row, col)| over the entries a thread holds (its rows or its
// columns, by `by_row`), `live(i)` picking the candidates; then over the
// instance
template <typename T, typename F>
__device__ __forceinline__ int bk_search(const T* __restrict__ A,
                                         const int line, const bool by_row,
                                         F live, Key<T>& key,
                                         unsigned long long* red, int& buf,
                                         const int r, const int grp) {
    key = 0;
    int idx = INT_MAX;
    for (int i = r; i < M; i += G) {
        const T v = fabs(by_row ? A[line * AP + i] : A[i * AP + line]);
        const Key<T> ki = order_key(v, live(i));
        if (key_before(ki, i, key, idx)) {
            key = ki;
            idx = i;
        }
    }
    inst_argmax(key, idx, red, buf, grp);
    return idx;
}

template <typename T>
__global__ void __launch_bounds__(NT)
backward_sweep_bk_kernel(const SweepArgs a, const int B, const int Tn,
                         const int /* refine: unused */, const T atol) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using S = Lay<T>;
    using L = LayBK<T>;
    const T NEG_INF = -INFINITY;
    const int r = threadIdx.x % G;            // thread of the instance
    const int grp = threadIdx.x / G;          // instance of the block
    const int b_raw = blockIdx.x * IPB + grp;
    const bool valid = b_raw < B;             // a ragged last block repeats
    const int b = valid ? b_raw : B - 1;      // the last instance, stores none
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + (size_t)grp * L::INST;

    T* __restrict__ Am = sm + L::A0;
    T* __restrict__ rs = sm + L::RS;
    T* __restrict__ ys = sm + L::YS;
    T* __restrict__ xs = sm + L::XS;
    T* __restrict__ cs = sm + L::CS;
    T* __restrict__ vxx = sm + L::VXX;
    T* __restrict__ vx = sm + L::VX;
    T* __restrict__ vxn = sm + L::VXN;
    T* __restrict__ dv = sm + L::DV;
    T* __restrict__ ev = sm + L::EV;
    T* __restrict__ pm = sm + L::PM;
    T* __restrict__ ws = sm + L::WS;
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

        // ---- assembly: row i of K and of the rhs by thread i % G; the rhs
        // twice (ys is the one the elimination carries along) ----
#pragma unroll 1
        for (int row = r; row < M; row += G) {
            T* krow = Am + row * AP;
            T* rrow = rs + row * NK;
            T* yrow = ys + row * NK;
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
                yrow[0] = -qu;
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    T acc = T(0);
#pragma unroll
                    for (int k = 0; k < NX; ++k) acc += fuv[k] * fx_t[k * NX + j];
                    const T v = -(lux_t[i * NX + j] + acc
                                  + sec_t[(NX + i) * NZ + j]);
                    rrow[1 + j] = v;
                    yrow[1 + j] = v;
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
                yrow[0] = -c_t[c];
#pragma unroll
                for (int j = 0; j < NX; ++j) {
                    rrow[1 + j] = -cx_t[c * NX + j];
                    yrow[1 + j] = -cx_t[c * NX + j];
                }
            }
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
        for (int q = r; q < M; q += G) {
            dv[q] = T(0);
            ev[q] = T(0);
            pm[q] = T(q);
        }
        inst_sync(grp);
        // A = (K + K^T) / 2, as bk_factor_rook symmetrizes its input
#pragma unroll 1
        for (int q = r; q < M * M; q += G) {
            const int i = q / M, j = q - i * M;
            if (i < j) {
                const T v = T(0.5) * (Am[i * AP + j] + Am[j * AP + i]);
                Am[i * AP + j] = v;
                Am[j * AP + i] = v;
            }
        }
        inst_sync(grp);

        PROF(0)
        // ---- rook-pivoted Bunch-Kaufman on shared memory, the trailing
        // block over the instance's threads ----
        int k = 0, info = 0;
#pragma unroll 1
        while (k < M) {
            Key<T> key;
            const int ci = bk_search<T>(Am, k, false,
                                        [k](int i) { return i > k; }, key,
                                        red, buf, r, grp);
            const T absakk = fabs(Am[k * AP + k]);
            const T colmax = (k < M - 1) ? key_value(key, NEG_INF) : NEG_INF;
            const bool zero_col = bk_max(absakk, bk_max(colmax, T(0))) == T(0);
            const bool plain1 = absakk >= T(BK_ALPHA) * colmax;
            int kp = k, p = k, kstep = 1;
            PROF_FINE(0)
            if (!(zero_col || plain1)) {
                // the rook chain: its rows are distinct (ops/bk.py), so M
                // trips bound it; if none ends it, take its first row as a
                // 2x2 pivot, as the plain version's table does
                int im = ci > k ? ci : k, pp = k;
                T cm = colmax;
                kp = im; p = k; kstep = 2;
#pragma unroll 1
                for (int it = 0; it < M; ++it) {
                    const int im_ = im;
                    const int rj = bk_search<T>(
                        Am, im, true,
                        [k, im_](int j) { return j >= k && j != im_; }, key,
                        red, buf, r, grp);
                    const T rv = key_value(key, NEG_INF);
                    const T aii = fabs(Am[im * AP + im]);
                    const bool take1 = aii >= T(BK_ALPHA) * rv;
                    const bool take2 = !take1 && (pp == rj || rv <= cm);
                    if (take1 || take2) {
                        kp = im; p = pp; kstep = take1 ? 1 : 2;
                        break;
                    }
                    pp = im; cm = rv; im = rj;
                }
            }
            PROF_FINE(1)
            if (zero_col && info == 0) info = k + 1;
            const bool do2 = kstep == 2;
            if (do2 && p != k) bk_swap(Am, ys, pm, k, p, k, r, grp);
            const int tgt = do2 ? k + 1 : k;
            if (kp != tgt && tgt < M) bk_swap(Am, ys, pm, tgt, kp, k, r, grp);
            PROF_FINE(2)

            if (!do2) {
                const T dk = Am[k * AP + k];
                const T safe = (dk == T(0)) ? T(1) : dk;
                const T wdk = ((dk == T(0)) ? T(0) : T(1)) * dk;
                // the multipliers of the rows below k, into column k
                for (int i = k + 1 + r; i < M; i += G) {
                    const T l = Am[i * AP + k] / safe;
                    ws[i] = l;
                    Am[i * AP + k] = l;
                }
                inst_sync(grp);
                PROF_FINE(3)
                // the trailing block, both triangles, and the rhs below k
                const int R = M - 1 - k;
                const T* __restrict__ w = ws + k + 1;
                T* __restrict__ a0 = Am + (k + 1) * AP + k + 1;
                trailing_update(R, r, [&](int i, int j) {
                    T* e = a0 + i * AP + j;
                    return Upd<T>{e, *e - wdk * (w[i] * w[j])};
                });
                chunked_update(R * NK, r, [&](int q) {
                    const int i = k + 1 + q / NK, c = q % NK;
                    T* e = ys + i * NK + c;
                    T v = *e;
                    v -= ws[i] * ys[k * NK + c];
                    return Upd<T>{e, v};
                });
                if (r == 0) dv[k] = dk;
            } else {
                const int k1 = (k + 1 < M) ? k + 1 : M - 1;
                const T a11 = Am[k * AP + k];
                const T a21 = Am[k1 * AP + k];
                const T a22 = Am[k1 * AP + k1];
                const T det = a11 * a22 - a21 * a21;
                const T sdet = (det == T(0)) ? T(1) : det;
                for (int i = k + 2 + r; i < M; i += G) {
                    const T w1 = Am[i * AP + k];
                    const T w2 = Am[i * AP + k1];
                    const T l1 = (w1 * a22 - w2 * a21) / sdet;
                    const T l2 = (w2 * a11 - w1 * a21) / sdet;
                    ws[i] = l1;
                    ws[M + i] = l2;
                    ws[2 * M + i] = w1;
                    ws[3 * M + i] = w2;
                    Am[i * AP + k] = l1;
                    Am[i * AP + k1] = l2;
                }
                // column k of the forward substitution on row k + 1: L(k+1, k)
                // is the block's slot of D, taken as 0
                if (k + 1 < M)
                    for (int c = r; c < NK; c += G)
                        ys[(k + 1) * NK + c] -= T(0) * ys[k * NK + c];
                inst_sync(grp);
                PROF_FINE(3)
                const int R = M - 2 - k > 0 ? M - 2 - k : 0;
                const T* __restrict__ w = ws + k + 2;
                T* __restrict__ a0 = Am + (k + 2) * AP + k + 2;
                trailing_update(R, r, [&](int i, int j) {
                    T* e = a0 + i * AP + j;
                    return Upd<T>{e, (*e - w[i] * w[2 * M + j])
                                         - w[M + i] * w[3 * M + j]};
                });
                chunked_update(R * NK, r, [&](int q) {
                    const int i = k + 2 + q / NK, c = q % NK;
                    T* e = ys + i * NK + c;
                    T v = *e;
                    v -= ws[i] * ys[k * NK + c];
                    v -= ws[M + i] * ys[(k + 1) * NK + c];
                    return Upd<T>{e, v};
                });
                if (r == 0) {
                    dv[k] = a11;
                    if (k + 1 < M) dv[k + 1] = a22;
                    ev[k] = a21;
                }
            }
            inst_sync(grp);
            PROF_FINE(4)
            k += kstep;
        }

        // ---- inertia: positive eigenvalues of D at atol (1x1, 2x2) ----
        int npos_part = 0;
        for (int q = r; q < M; q += G) {
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
        const int n_pos = inst_add(npos_part, red, buf, grp);

        PROF(1)
        // ---- D solve and backward substitution: the first warp, lane r
        // its rows r and r + 32 in registers (the forward substitution is
        // done) ----
        if (r < 32) {
            T z[2][NK];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = r + 32 * h;
#pragma unroll
                for (int c = 0; c < NK; ++c) z[h][c] = T(0);
                if (i >= M) continue;
                const T d = dv[i], e = ev[i];
#pragma unroll
                for (int c = 0; c < NK; ++c) {
                    const int q = i * NK + c;
                    const T y = ys[q];
                    if (e != T(0)) {
                        const T d2 = (i + 1 < M) ? dv[i + 1] : T(0);
                        const T det = d * d2 - e * e;
                        const T yn = (i + 1 < M) ? ys[q + NK] : T(0);
                        z[h][c] = (d2 * y - e * yn)
                                  / ((det == T(0)) ? T(1) : det);
                    } else if (i > 0 && ev[i - 1] != T(0)) {
                        const T dp = dv[i - 1], ep = ev[i - 1];
                        const T det = dp * d - ep * ep;
                        z[h][c] = (dp * y - ep * ys[q - NK])
                                  / ((det == T(0)) ? T(1) : det);
                    } else {
                        z[h][c] = y / ((d == T(0)) ? T(1) : d);
                    }
                }
            }
            // x <- L^-T z, column j from the last: z_i -= L(j, i) z_j
#pragma unroll 4
            for (int j = M - 1; j > 0; --j) {
                T zb[NK];
#pragma unroll
                for (int c = 0; c < NK; ++c)
                    zb[c] = __shfl_sync(FULL, j >= 32 ? z[1][c] : z[0][c],
                                        j & 31);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = r + 32 * h;
                    if (i < j) {
                        const T l = bk_l(Am, ev, j, i);
#pragma unroll
                        for (int c = 0; c < NK; ++c) z[h][c] -= l * zb[c];
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {     // undo the permutation
                const int i = r + 32 * h;
                if (i < M) {
                    const int o = (int)pm[i];
#pragma unroll
                    for (int c = 0; c < NK; ++c) xs[o * NK + c] = z[h][c];
                }
            }
        }
        inst_sync(grp);

        PROF(2)
        // ---- gains ----
        for (int row = r; row < M; row += G) {
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
                for (int k2 = 0; k2 < NX; ++k2) v += fx_t[k2 * NX + i] * vx[k2];
                vxn[i] = v;
            } else {
                T dq = T(0);
#pragma unroll 5
                for (int q = 0; q < M; ++q) dq += rs[q * NK] * xs[q * NK];
                dL -= dq;
            }
        }
        inst_sync(grp);
        for (int task = r; task < NX * NX; task += G) {
            const int i = task / NX, j = task - i * NX;
            const int lo = i < j ? i : j, hi = i < j ? j : i;
            vxx[task] = (i == j) ? cs[task]
                : T(0.5) * (cs[lo * NX + hi] + cs[hi * NX + lo]);
        }
        for (int i = r; i < NX; i += G) vx[i] = vxn[i];

        PROF(4)
        const bool stage_ok = (info == 0) && (n_pos == NU);
        if (!fail && !stage_ok && info > 0) singular = true;
        fail = fail || !stage_ok;
    }

    if (valid && r == (NX * NX + NX) % G) ((T*)a.dL)[b] = dL;
    if (valid && r == 0) {
        a.fail[b] = fail ? 1 : 0;
        a.singular[b] = singular ? 1 : 0;
    }
}
