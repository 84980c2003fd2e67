// Backward sweep of the interior-point DDP solver, one launch per sweep.
//
// Replaces the TPU kernels `backward_sweep_pallas`
// (ipddp2tpu/ops/backward_pallas.py, `_kernel` / `_ldlt_solve_lanes`) as the
// float instantiation, and `backward_sweep_pallas_df64`
// (ipddp2tpu/ops/backward_pallas_df64.py) as the double instantiation: Hopper
// has native FP64, so the double-single arithmetic of the TPU twin is not
// carried over.
//
// What it computes: for each problem instance b, the whole reverse-time
// recursion at fixed (mu, reg, delta_c)[b]. Per stage it forms Sigma_L, Sigma_U,
// Qu, C, H, B (with the pre-contracted second-order block), the KKT matrix
// [[H + reg I, cu^T], [cu, -delta_c I]] of size m = nu + nc, factors it by
// LDL^T with max-|diagonal| pivoting (first index on ties), counts the
// inertia from the pivot signs, solves for the gains with `refine` sweeps of
// iterative refinement, applies the residual gate
// ||r||_F <= rtol (||K||_F ||X||_F + ||rhs||_F) & finite(X), writes the gains
// alpha beta psi omega and the closed-form chi_l zeta_l chi_u zeta_u, and
// carries (Vx, Vxx) to the next stage with Vxx symmetrized. The plain version
// is `ipddp2tpu_torch.backward.sweep_plain`.
//
// Design for this card. The work is a chain of T dependent small dense
// factorizations per instance with data-dependent pivot indices: it is bound
// by latency, not by the bytes it moves (its lower bound) or by the FP64
// rate. One thread owns one instance and loops over T inside the kernel, so
// nothing of the carry ever leaves the SM, and a block is one warp, so that a
// batch spreads over the most SMs. The matrices that are indexed by the
// pivots (K, its factor, rhs, X) do not fit in registers (a 14x14 double
// matrix alone is 392 registers), so they live in dynamic shared memory laid
// out [entry][thread]: thread i always touches bank (i * sizeof(T) / 4)
// whatever row its own pivot selects, so a warp's accesses never conflict.
// What the latency bound asks for is independent accesses in flight, so:
// the block width is a compile-time constant (shared-memory addresses are
// then constants the compiler can tell apart and reorder); pivoting is
// implicit (no swaps); the factor loop keeps the pivot column in registers
// and updates the matrix a row at a time through registers; the triangular
// solves run one right-hand side at a time on a register vector in pivot
// order, reading L through the pivot indices; the KKT assembly keeps Vxx'
// and fx in registers. The stage inputs are read straight from the
// [B, T, ...] tensors; each thread reads its own contiguous run. Prefetching
// the next stage, coalesced input layouts and splitting an instance over
// several threads are left to later work.
//
// Built with plain IEEE arithmetic (no fast-math): 1/il must be exactly 0
// where il = +inf, and isfinite must see NaN and inf.
//
// Compile-time parameters: -DNX=.. -DNU=.. -DNC=.. (one library per triple).
// Plain C interface for ctypes: `backward_sweep_f32`, `backward_sweep_f64`.

#include <cuda_runtime.h>
#include <math.h>

#ifndef NX
#error "define NX, NU, NC"
#endif

constexpr int NT = 32;           // threads per block: one warp, so that a
                                 // batch spreads over the most SMs
constexpr int M = NU + NC;       // KKT size
constexpr int NK = NX + 1;       // right-hand sides: feedforward + NX feedback
constexpr int NZ = NX + NU;

// Entries of per-thread shared scratch, in units of the scalar type.
constexpr int OFF_K0 = 0;                    // KKT matrix, kept for residuals
constexpr int OFF_W = OFF_K0 + M * M;        // working copy -> L columns
constexpr int OFF_RHS = OFF_W + M * M;       // right-hand side
constexpr int OFF_X = OFF_RHS + M * NK;      // solution
constexpr int OFF_R = OFF_X + M * NK;        // residual of one column
constexpr int OFF_D = OFF_R + M;             // pivots, in elimination order
constexpr int OFF_VXX = OFF_D + M;           // value Hessian carry
constexpr int SCRATCH = OFF_VXX + NX * NX;

struct SweepArgs {
    // inputs, [B, T, ...] row-major unless noted
    const void *fx, *fu, *lx, *lu, *lxx, *lux, *luu, *cx, *cu, *sec;
    const void *c, *il, *iu, *phi, *zl, *zu;
    const void *lTx, *lTxx;          // [B, NX], [B, NX, NX]
    const void *mu, *reg, *dc;       // [B]
    // outputs
    void *alpha, *beta, *psi, *omega, *chi_l, *zeta_l, *chi_u, *zeta_u;
    void *dL;                        // [B]
    unsigned char *fail, *singular;  // [B]
    long long *prof;                 // optional: cycles per section, see PROF
};

// With a non-null `prof` (the wrapper's profiling call), lane 0 of every
// block adds the clock cycles it spent in each section of the stage loop:
// prof[0..4] = assemble, factor, solve, gains, value.
#define PROF(slot)                                                    \
    if (a.prof != nullptr && threadIdx.x == 0) {                      \
        const long long now = clock64();                              \
        atomicAdd((unsigned long long*)&a.prof[slot],                 \
                  (unsigned long long)(now - tick));                  \
        tick = now;                                                   \
    }

template <typename T>
__device__ __forceinline__ bool finite_(T v) { return isfinite(v); }

// Solve (L D L^T) y = y in pivot order on a register vector: ro[i] / co[j] are
// the shared-memory offsets of row piv[i] / column piv[j] of W, whose entry
// (piv[i], piv[j]), i > j, is L(i, j); dd holds the pivots.
template <typename T>
__device__ __forceinline__ void ldlt_solve_regs(
        T (&y)[M > 0 ? M : 1], const T* __restrict__ sm,
        const int (&ro)[M > 0 ? M : 1], const int (&co)[M > 0 ? M : 1],
        const T (&dd)[M > 0 ? M : 1]) {
#pragma unroll
    for (int j = 0; j < M; ++j) {            // forward: z = L^{-1} P b
#pragma unroll
        for (int i = j + 1; i < M; ++i) y[i] -= sm[ro[i] + co[j]] * y[j];
    }
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {       // backward: L^T x = D^{-1} z
        const T safe = (dd[j] == T(0)) ? T(1) : dd[j];   // zero-pivot guard
        T dot = T(0);
#pragma unroll
        for (int i = j + 1; i < M; ++i) dot += sm[ro[i] + co[j]] * y[i];
        y[j] = y[j] / safe - dot;
    }
}

template <typename T>
__global__ void backward_sweep_kernel(const SweepArgs a, const int B,
                                      const int Tn, const int refine,
                                      const T rtol) {
    extern __shared__ unsigned char smem_raw[];
    const int b = blockIdx.x * NT + threadIdx.x;
    if (b >= B) return;              // no block-wide barrier is ever used
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
    // [entry][thread]; NT is a compile-time constant so that the compiler
    // can tell two entries apart and keep independent accesses in flight
#define S(off, idx) sm[((off) + (idx)) * NT]

    const T* __restrict__ fx = (const T*)a.fx;   const T* __restrict__ fu = (const T*)a.fu;
    const T* __restrict__ lx = (const T*)a.lx;   const T* __restrict__ lu = (const T*)a.lu;
    const T* __restrict__ lxx = (const T*)a.lxx; const T* __restrict__ lux = (const T*)a.lux;
    const T* __restrict__ luu = (const T*)a.luu; const T* __restrict__ cx = (const T*)a.cx;
    const T* __restrict__ cu = (const T*)a.cu;   const T* __restrict__ sec = (const T*)a.sec;
    const T* __restrict__ cc = (const T*)a.c;    const T* __restrict__ il = (const T*)a.il;
    const T* __restrict__ iu = (const T*)a.iu;   const T* __restrict__ phi = (const T*)a.phi;
    const T* __restrict__ zl = (const T*)a.zl;   const T* __restrict__ zu = (const T*)a.zu;
    T* __restrict__ alpha = (T*)a.alpha;   T* __restrict__ beta = (T*)a.beta;
    T* __restrict__ psi = (T*)a.psi;       T* __restrict__ omega = (T*)a.omega;
    T* __restrict__ chi_l = (T*)a.chi_l;   T* __restrict__ zeta_l = (T*)a.zeta_l;
    T* __restrict__ chi_u = (T*)a.chi_u;   T* __restrict__ zeta_u = (T*)a.zeta_u;

    const T mu = ((const T*)a.mu)[b];
    const T reg = ((const T*)a.reg)[b];
    const T dc = ((const T*)a.dc)[b];

    T Vx[NX];
    for (int i = 0; i < NX; ++i) Vx[i] = ((const T*)a.lTx)[b * NX + i];
    for (int i = 0; i < NX * NX; ++i)
        S(OFF_VXX, i) = ((const T*)a.lTxx)[b * NX * NX + i];

    T dL = T(0);
    bool fail = false, singular = false;
    int piv[M > 0 ? M : 1];

    for (int t = Tn - 1; t >= 0; --t) {
        const size_t s = (size_t)b * Tn + t;          // stage index
        const T* fx_t = fx + s * NX * NX;             // [NX, NX]
        const T* fu_t = fu + s * NX * NU;             // [NX, NU]
        const T* cx_t = cx + s * NC * NX;             // [NC, NX]
        const T* cu_t = cu + s * NC * NU;             // [NC, NU]
        const T* sec_t = sec + s * NZ * NZ;           // [NZ, NZ]
        const T* il_t = il + s * NU;
        const T* iu_t = iu + s * NU;
        const T* zl_t = zl + s * NU;
        const T* zu_t = zu + s * NU;
        const T* c_t = cc + s * NC;
        const T* phi_t = phi + s * NC;

        long long tick = (a.prof != nullptr) ? clock64() : 0;
        // Vxx' and fx in registers; C = lxx + sec_xx + fx^T Vxx' fx overwrites
        // the carry
        T vxx[NX * NX], fxr[NX * NX];
#pragma unroll
        for (int i = 0; i < NX * NX; ++i) {
            vxx[i] = S(OFF_VXX, i);
            fxr[i] = fx_t[i];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            T fxv[NX];                        // row i of fx^T Vxx'
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k)
                    acc += fxr[k * NX + i] * vxx[k * NX + j];
                fxv[j] = acc;
            }
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fxv[k] * fxr[k * NX + j];
                S(OFF_VXX, i * NX + j) =
                    lxx[s * NX * NX + i * NX + j] + acc + sec_t[i * NZ + j];
            }
        }

        // KKT matrix and right-hand side, row block of the controls
#pragma unroll
        for (int i = 0; i < NU; ++i) {
            T fui[NX], fuv[NX];               // column i of fu; row i of fu^T Vxx'
#pragma unroll
            for (int k = 0; k < NX; ++k) fui[k] = fu_t[k * NU + i];
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fui[k] * vxx[k * NX + j];
                fuv[j] = acc;
            }
            const T sl = T(1) / il_t[i];      // exactly 0 where il = +inf
            const T su = T(1) / iu_t[i];
            T qu = lu[s * NU + i];
#pragma unroll
            for (int c = 0; c < NC; ++c) qu += cu_t[c * NU + i] * phi_t[c];
#pragma unroll
            for (int k = 0; k < NX; ++k) qu += fui[k] * Vx[k];
            qu = qu - mu * sl + mu * su;
            S(OFF_RHS, i * NK) = -qu;
#pragma unroll
            for (int j = 0; j < NX; ++j) {    // B = lux + fuV fx + sec_ux
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fuv[k] * fxr[k * NX + j];
                S(OFF_RHS, i * NK + 1 + j) =
                    -(lux[s * NU * NX + i * NX + j] + acc
                      + sec_t[(NX + i) * NZ + j]);
            }
#pragma unroll
            for (int j = 0; j < NU; ++j) {    // H = luu + fuV fu + sec_uu
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fuv[k] * fu_t[k * NU + j];
                T h = luu[s * NU * NU + i * NU + j] + acc
                      + sec_t[(NX + i) * NZ + NX + j];
                if (i == j) h = h + (zl_t[i] * sl + zu_t[i] * su) + reg;
                S(OFF_K0, i * M + j) = h;
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const T v = cu_t[c * NU + i];
                S(OFF_K0, i * M + NU + c) = v;
                S(OFF_K0, (NU + c) * M + i) = v;
            }
        }
        for (int c = 0; c < NC; ++c) {
            for (int c2 = 0; c2 < NC; ++c2)
                S(OFF_K0, (NU + c) * M + NU + c2) = (c == c2) ? -dc : T(0);
            S(OFF_RHS, (NU + c) * NK) = -c_t[c];
            for (int j = 0; j < NX; ++j)
                S(OFF_RHS, (NU + c) * NK + 1 + j) = -cx_t[c * NX + j];
        }

        PROF(0)
        // ---- LDL^T with implicit max-|diagonal| pivoting on a copy ----
#pragma unroll
        for (int i = 0; i < M * M; ++i) S(OFF_W, i) = S(OFF_K0, i);
        unsigned live = (M >= 32) ? 0xffffffffu : ((1u << M) - 1u);
        int n_pos = 0, n_zero = 0;
        bool d_finite = true;
#pragma unroll 1
        for (int j = 0; j < M; ++j) {
            // first live row opens (best = -1); later rows need a strictly
            // larger |diagonal| (first index wins ties); a NaN diagonal wins
            // like it does in an argmax
            int p = 0;
            T best = T(-1), dj = T(0);
#pragma unroll
            for (int i = 0; i < M; ++i) {
                const T v = S(OFF_W, i * M + i);
                const T av = fabs(v);
                const bool take = ((live >> i) & 1u)
                    && (av > best || (av != av && best == best));
                if (take) { p = i; best = av; dj = v; }
            }
            const T safe = (dj == T(0)) ? T(1) : dj;   // zero-pivot guard
            live &= ~(1u << p);
            piv[j] = p;
            S(OFF_D, j) = dj;
            n_pos += (dj > T(0));
            n_zero += (dj == T(0));
            d_finite = d_finite && finite_(dj);
            T l[M > 0 ? M : 1];                        // L column j, by row
#pragma unroll
            for (int i = 0; i < M; ++i)
                l[i] = ((live >> i) & 1u) ? S(OFF_W, i * M + p) / safe : T(0);
#pragma unroll
            for (int i = 0; i < M; ++i) {              // Schur update, by row
                if (!((live >> i) & 1u)) continue;
                const T dl = l[i] * dj;
                T w[M > 0 ? M : 1];
#pragma unroll
                for (int k = 0; k < M; ++k) w[k] = S(OFF_W, i * M + k);
#pragma unroll
                for (int k = 0; k < M; ++k)            // dead columns hold L
                    w[k] = ((live >> k) & 1u) ? w[k] - dl * l[k] : w[k];
#pragma unroll
                for (int k = 0; k < M; ++k) S(OFF_W, i * M + k) = w[k];
            }
#pragma unroll
            for (int i = 0; i < M; ++i) S(OFF_W, i * M + p) = l[i];
        }

        PROF(1)
        // ---- solve, refine, gate: one right-hand side at a time ----
        int ro[M > 0 ? M : 1], co[M > 0 ? M : 1];
        T dd[M > 0 ? M : 1];
#pragma unroll
        for (int j = 0; j < M; ++j) {
            ro[j] = (OFF_W + piv[j] * M) * NT;
            co[j] = piv[j] * NT;
            dd[j] = S(OFF_D, j);
        }
        T ssr = T(0), ssa = T(0), ssx = T(0), ssb = T(0);
        bool x_finite = true;
#pragma unroll 1
        for (int c = 0; c < NK; ++c) {
            // pass 0 solves for rhs itself, passes 1..refine for the
            // residual (iterative refinement), the last pass only measures
            for (int pass = 0; pass <= refine + 1; ++pass) {
                T x[M > 0 ? M : 1];
#pragma unroll
                for (int k = 0; k < M; ++k)
                    x[k] = (pass == 0) ? T(0) : S(OFF_X, k * NK + c);
                T r[M > 0 ? M : 1];
#pragma unroll
                for (int i = 0; i < M; ++i) {
                    const T q = S(OFF_RHS, i * NK + c);
                    T ax = T(0);
                    if (pass > 0) {
#pragma unroll
                        for (int k = 0; k < M; ++k)
                            ax += S(OFF_K0, i * M + k) * x[k];
                    }
                    r[i] = q - ax;
                    if (pass == refine + 1) { ssr += r[i] * r[i]; ssb += q * q; }
                }
#pragma unroll
                for (int i = 0; i < M; ++i) S(OFF_R, i) = r[i];
                if (pass == refine + 1) {
#pragma unroll
                    for (int k = 0; k < M; ++k) {
                        ssx += x[k] * x[k];
                        x_finite = x_finite && finite_(x[k]);
                    }
                    break;
                }
                T y[M > 0 ? M : 1];
#pragma unroll
                for (int j = 0; j < M; ++j) y[j] = sm[OFF_R * NT + co[j]];
                ldlt_solve_regs<T>(y, sm, ro, co, dd);
#pragma unroll
                for (int j = 0; j < M; ++j) {
                    T* xp = sm + (OFF_X + c) * NT + co[j] * NK;
                    *xp = (pass == 0) ? y[j] : *xp + y[j];
                }
            }
        }
#pragma unroll
        for (int i = 0; i < M * M; ++i) {
            const T k = S(OFF_K0, i);
            ssa += k * k;
        }
        const bool solve_ok =
            (sqrt(ssr) <= rtol * (sqrt(ssa) * sqrt(ssx) + sqrt(ssb)))
            && x_finite;

        PROF(2)
        // ---- gains ----
        for (int i = 0; i < NU; ++i) {
            const T sl = T(1) / il_t[i];
            const T su = T(1) / iu_t[i];
            const T sig_l = zl_t[i] * sl;
            const T sig_u = zu_t[i] * su;
            const T al = S(OFF_X, i * NK);
            alpha[s * NU + i] = al;
            chi_l[s * NU + i] = mu * sl - zl_t[i] - sig_l * al;
            chi_u[s * NU + i] = mu * su - zu_t[i] + sig_u * al;
            for (int j = 0; j < NX; ++j) {
                const T be = S(OFF_X, i * NK + 1 + j);
                beta[(s * NU + i) * NX + j] = be;
                zeta_l[(s * NU + i) * NX + j] = -sig_l * be;
                zeta_u[(s * NU + i) * NX + j] = sig_u * be;
            }
        }
        for (int c = 0; c < NC; ++c) {
            psi[s * NC + c] = S(OFF_X, (NU + c) * NK);
            for (int j = 0; j < NX; ++j)
                omega[(s * NC + c) * NX + j] = S(OFF_X, (NU + c) * NK + 1 + j);
        }

        PROF(3)
        // ---- value recursion (rhs holds -Qu, -B, -c, -cx) ----
        // Vxx = C + beta^T B + omega^T cx;  Vx = lx + cx^T phi + beta^T Qu
        //       + omega^T c + fx^T Vx';     dL += Qu.alpha + c.psi
        T Vx_new[NX];
        for (int i = 0; i < NX; ++i) {
            T v = lx[s * NX + i];
            for (int c = 0; c < NC; ++c) v += cx_t[c * NX + i] * phi_t[c];
            T gq = T(0);
            for (int r = 0; r < M; ++r)
                gq += S(OFF_X, r * NK + 1 + i) * S(OFF_RHS, r * NK);
            v -= gq;
            for (int k = 0; k < NX; ++k) v += fx_t[k * NX + i] * Vx[k];
            Vx_new[i] = v;
            for (int j = 0; j < NX; ++j) {
                T g = T(0);
                for (int r = 0; r < M; ++r)
                    g += S(OFF_X, r * NK + 1 + i) * S(OFF_RHS, r * NK + 1 + j);
                S(OFF_VXX, i * NX + j) -= g;
            }
        }
        for (int i = 0; i < NX; ++i) Vx[i] = Vx_new[i];
        // Symmetrize: roundoff asymmetry is amplified stage by stage otherwise.
        for (int i = 0; i < NX; ++i)
            for (int j = i + 1; j < NX; ++j) {
                const T v = T(0.5) * (S(OFF_VXX, i * NX + j)
                                      + S(OFF_VXX, j * NX + i));
                S(OFF_VXX, i * NX + j) = v;
                S(OFF_VXX, j * NX + i) = v;
            }
        T dq = T(0);
        for (int r = 0; r < M; ++r) dq += S(OFF_RHS, r * NK) * S(OFF_X, r * NK);
        dL -= dq;

        PROF(4)
        const bool stage_ok =
            d_finite && (n_zero == 0) && (n_pos == NU) && solve_ok;
        if (!fail && !stage_ok && n_zero > 0) singular = true;
        fail = fail || !stage_ok;
    }

    ((T*)a.dL)[b] = dL;
    a.fail[b] = fail ? 1 : 0;
    a.singular[b] = singular ? 1 : 0;
#undef S
}

template <typename T>
static int launch(const SweepArgs* args, int B, int Tn, int refine,
                  double rtol, cudaStream_t stream) {
    if (B <= 0 || Tn <= 0) return 0;
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = (size_t)SCRATCH * NT * sizeof(T);
    if (bytes > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(backward_sweep_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + NT - 1) / NT;
    backward_sweep_kernel<T><<<blocks, NT, bytes, stream>>>(
        *args, B, Tn, refine, (T)rtol);
    return (int)cudaGetLastError();
}

extern "C" {

// Both return the CUDA error code of the launch (0 = launched). `args` is a
// host array of 33 pointers in the order of SweepArgs (the last, `prof`,
// may be null).
int backward_sweep_f32(const void* const* ptrs, int B, int Tn, int refine,
                       double rtol, void* stream);
int backward_sweep_f64(const void* const* ptrs, int B, int Tn, int refine,
                       double rtol, void* stream);
int backward_sweep_dims(int* nx, int* nu, int* nc);

}

static SweepArgs unpack(const void* const* p) {
    SweepArgs a;
    a.fx = p[0]; a.fu = p[1]; a.lx = p[2]; a.lu = p[3]; a.lxx = p[4];
    a.lux = p[5]; a.luu = p[6]; a.cx = p[7]; a.cu = p[8]; a.sec = p[9];
    a.c = p[10]; a.il = p[11]; a.iu = p[12]; a.phi = p[13]; a.zl = p[14];
    a.zu = p[15]; a.lTx = p[16]; a.lTxx = p[17];
    a.mu = p[18]; a.reg = p[19]; a.dc = p[20];
    a.alpha = (void*)p[21]; a.beta = (void*)p[22]; a.psi = (void*)p[23];
    a.omega = (void*)p[24]; a.chi_l = (void*)p[25]; a.zeta_l = (void*)p[26];
    a.chi_u = (void*)p[27]; a.zeta_u = (void*)p[28]; a.dL = (void*)p[29];
    a.fail = (unsigned char*)p[30]; a.singular = (unsigned char*)p[31];
    a.prof = (long long*)p[32];
    return a;
}

int backward_sweep_f32(const void* const* ptrs, int B, int Tn, int refine,
                       double rtol, void* stream) {
    const SweepArgs a = unpack(ptrs);
    return launch<float>(&a, B, Tn, refine, rtol, (cudaStream_t)stream);
}

int backward_sweep_f64(const void* const* ptrs, int B, int Tn, int refine,
                       double rtol, void* stream) {
    const SweepArgs a = unpack(ptrs);
    return launch<double>(&a, B, Tn, refine, rtol, (cudaStream_t)stream);
}

int backward_sweep_dims(int* nx, int* nu, int* nc) {
    *nx = NX; *nu = NU; *nc = NC;
    return 0;
}
