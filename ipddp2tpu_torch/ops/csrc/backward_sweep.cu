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
// What bounds it on this card: latency. The work is a chain of T dependent
// small factorizations per instance with data-dependent pivot indices; the
// bytes it moves and its FP64 operations are a few per cent of its time, and
// a warp that walks this chain alone issues one machine op every 3 to 5
// clocks. So the design shortens the chain of one instance, keeps the
// machine ops per step few, and keeps many chains resident:
//
//  * An instance is owned by a GROUP of G lanes of one warp, G the smallest
//    power of two >= m (concar: m = 14, G = 16, two instances a warp). Lane i
//    owns row i of the KKT matrix, of the working copy, of all nx + 1
//    right-hand sides and of the solution, in registers with static column
//    indices. Groups never talk to each other and warps never to other
//    warps: the only barrier is `__syncwarp`. m > 32 does not fit a group:
//    for 32 < m <= 64 the same sweep runs with a warp an instance and its
//    working matrix in shared memory (backward_sweep_wide.cuh, chosen by
//    the size; cartpole's m = 35 with inertia_method="ldl"); the wrapper
//    refuses m > 64.
//  * Pivot search: an arg-max over the live diagonal (each lane keeps its
//    own diagonal entry in a register) by a xor butterfly of (|d|, index)
//    pairs with the rule of the plain version: largest |d|, the lower index
//    on ties, a NaN wins over numbers but not over an earlier NaN. Every
//    lane of the group ends with the same pivot. Pivoting is implicit. (The
//    warp's integer max, `__reduce_max_sync` on an order-preserving key, was
//    tried in its place and was slower.)
//  * Elimination of a pivot: the pivot lane's row is broadcast (m shuffles
//    that do not wait for any division); by symmetry it is the pivot column
//    times the pivot. Each lane takes its own entry of the pivot column from
//    its own row (a select chain over the static columns), divides once,
//    and updates its row with m multiply-adds, where one thread did m*m (a
//    structural zero is not divided, see there). No
//    row or column is masked: the multiplier is 0 on rows that are gone and
//    columns that are gone are never read again. L goes to shared memory
//    `[step][lane]`, the pivot order beside it.
//  * The right-hand sides ride along as nx + 1 further columns of the
//    elimination: step j of their forward substitution is done in step j of
//    the factorization, its broadcasts beside the pivot row's.
//  * Triangular solves for all right-hand sides at once: forward
//    substitution (for the refinement's residuals) is, per step, a broadcast
//    of the pivot lane's nx + 1 values and as many multiply-adds on every
//    lane; backward substitution runs column-wise the same way, each lane
//    reading L(pivot, own step) from shared memory (the one place that needs
//    a dynamic column). Where a 0 of L meets a non-finite value a lane that
//    the plain version leaves finite turns NaN; the instance then fails the
//    gate on either side.
//  * Residuals (refinement and the gate): the group's solution goes to
//    shared memory, lane i forms row i of K X from its row of K (shared,
//    row stride m + 1, conflict-free for a group). The gate's four sums of
//    squares are butterfly reductions: their order of summation differs
//    from the plain version's.
//  * Assembly: lane i < nu forms row i of H, B and Qu, lane nu + c row c of
//    the constraint block; the rows of C = lxx + fx^T Vxx' fx go to the
//    lanes from the top of the group down, which are idle or hold the short
//    constraint rows. Vx, Vxx stay in shared memory for the whole sweep.
//    The value recursion's sums over rows (Vxx, Vx, dL: nx*nx + nx + 1 of
//    them) are spread over the lanes, each summing m products read from
//    shared memory in row order.
//  * Stage inputs: the 16 stage tensors are dense [B, T, ...], so an
//    instance's stage is 16 contiguous runs. The group copies the runs of
//    stage t-1 into one of two shared-memory buffers with `cp.async` (16
//    bytes a lane where a run's size allows, else element-wise) while it
//    computes stage t: loads are coalesced over the lanes of a group and a
//    whole stage ahead of their use.
//  * Outputs are written by the lanes that hold them: lane i its entries of
//    alpha, chi and its rows of beta, zeta (contiguous runs per instance).
//
// The working matrix lives in registers (row i on lane i), its factor and
// the KKT matrix for the residuals in shared memory. `-Xptxas -v` for concar:
// 162 registers in double, 80 in float, no spills, no stack. Shared memory
// per instance: 2 stage buffers + K + L + pivot order + rhs + X + C + Vxx +
// Vx, 1,694 values for concar (13,552 bytes in double, 6,864 in float). The
// wrapper chooses the instances per block (-DIPB) so that a block is 4 warps
// (8 instances, 108,416 bytes in double: two blocks and 16 instances an SM,
// 2,112 on the card) and checks the bytes against the card's 227 KB. The
// loops over the m pivot steps are unrolled in full (-DSWEEP_UNROLL to
// change it: rolled they cost 5 % more time and 18 registers less). A batch
// that does not fill its last block is padded by clamping the instance
// index and masking the stores: every lane reaches every shuffle.
//
// What holds it back now: a stage is about 31,000 clocks for one warp alone
// (factor 13,400, solve 9,800, assemble 5,300, gains and value 2,600) and
// 20 % more with the 8 warps that B = 2048 puts on an SM; about 6,000
// machine ops a stage issue at one in 5 clocks because nearly every one
// waits for a shuffle, a shared-memory load or the last multiply-add.
//
// Built with plain IEEE arithmetic (no fast-math): 1/il must be exactly 0
// where il = +inf, and isfinite must see NaN and inf.
//
// Compile-time parameters: -DNX=.. -DNU=.. -DNC=.. -DIPB=.. (one library per
// tuple; -DSWEEP_UNROLL optional). Plain C interface for ctypes:
// `backward_sweep_f32`, `backward_sweep_f64`, `backward_sweep_dims`.
//
// -DSWEEP_BK=1 builds the other stage solve instead: rook Bunch-Kaufman with
// the reference's inertia count and plain substitution, -DWPI whole warps
// an instance, for the contact models (backward_sweep_bk.cuh, which says
// what it replaces and what bounds it). Without it, and for m <= 32, the
// preprocessed kernel is the LDL^T one above, unchanged; for 32 < m <= 64
// it is the LDL^T sweep of backward_sweep_wide.cuh (-DWPI warps). What the
// two share is in sweep_instance.cuh. -DSWEEP_PROF_FINE (see PROF) splits
// their factorization's clocks by step instead of the stage's by section.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

#if !defined(NX) || !defined(NU) || !defined(NC) || !defined(IPB)
#error "define NX, NU, NC and IPB"
#endif

constexpr int M = NU + NC;       // KKT size
constexpr int NK = NX + 1;       // right-hand sides: feedforward + NX feedback
constexpr int NZ = NX + NU;

constexpr int pow2_at_least(int n) {
    int g = 1;
    while (g < n) g *= 2;
    return g;
}
#if SWEEP_BK || (NU + NC) > 32
#if !SWEEP_BK
// the LDL^T sweep for 32 < m <= 64 (backward_sweep_wide.cuh)
#define SWEEP_WIDE 1
#endif
// the Bunch-Kaufman instantiation (backward_sweep_bk.cuh) and the wide LDL^T
// sweep: WPI whole warps own an instance (1, 2 or 4; the wrapper takes 1 up
// to m = 32 and WIDE_WARPS above)
#ifndef WPI
#define WPI 1
#endif
constexpr int G = 32 * WPI;
static_assert(M >= 1, "the KKT size must be at least 1");
static_assert(WPI == 1 || WPI == 2 || WPI == 4, "WPI is 1, 2 or 4");
#else
constexpr int G = pow2_at_least(M);          // lanes that own one instance
static_assert(M >= 1 && G <= 32, "the KKT size must be 1..32");
#endif
constexpr int NT = IPB * G;                  // threads per block
static_assert(NT % 32 == 0 && NT <= 1024, "a block is whole warps");

constexpr unsigned FULL = 0xffffffffu;
constexpr int MP = M + 1;        // row stride of K in shared memory (odd for
                                 // even m: a group's rows fall on other banks)
constexpr int LP = G + 1;        // row stride of the L mirror [step][lane]
#ifndef SWEEP_UNROLL
#define SWEEP_UNROLL (NU + NC)
#endif
// how far the loops over the m pivot steps are unrolled (see the header)
constexpr int STEP_UNROLL = SWEEP_UNROLL;

// Per-instance shared memory, in units of T. Every run of the stage buffer
// starts on a 16-byte boundary so that it can be the target of a 16-byte
// asynchronous copy.
template <typename T>
constexpr int up(int n) {        // n values rounded up to whole 16 bytes
    constexpr int A = 16 / (int)sizeof(T);
    return (n + A - 1) / A * A;
}

template <typename T>
struct Lay {
    static constexpr int FX = 0;
    static constexpr int FU = FX + up<T>(NX * NX);
    static constexpr int LX = FU + up<T>(NX * NU);
    static constexpr int LU = LX + up<T>(NX);
    static constexpr int LXX = LU + up<T>(NU);
    static constexpr int LUX = LXX + up<T>(NX * NX);
    static constexpr int LUU = LUX + up<T>(NU * NX);
    static constexpr int CX = LUU + up<T>(NU * NU);
    static constexpr int CU = CX + up<T>(NC * NX);
    static constexpr int SEC = CU + up<T>(NC * NU);
    static constexpr int CC = SEC + up<T>(NZ * NZ);
    static constexpr int IL = CC + up<T>(NC);
    static constexpr int IU = IL + up<T>(NU);
    static constexpr int PHI = IU + up<T>(NU);
    static constexpr int ZL = PHI + up<T>(NC);
    static constexpr int ZU = ZL + up<T>(NU);
    static constexpr int IN_LEN = ZU + up<T>(NU);   // one stage buffer

    static constexpr int K0 = 2 * IN_LEN;        // KKT matrix [M][MP]
    static constexpr int LS = K0 + M * MP;       // L mirror [M steps][LP]
    static constexpr int RS = LS + M * LP;       // right-hand sides [M][NK]
    static constexpr int XS = RS + M * NK;       // solution [M][NK]
    static constexpr int CS = XS + M * NK;       // C, then unsymmetrized Vxx
    static constexpr int VXX = CS + NX * NX;     // value Hessian carry
    static constexpr int VX = VXX + NX * NX;     // value gradient carry
    static constexpr int VXN = VX + NX;          // next value gradient
    static constexpr int PV = VXN + NX;          // pivot lane of each step
    static constexpr int INST = up<T>(PV + M);   // values per instance
};

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

// With a non-null `prof` (the wrapper's profiling call), thread 0 of every
// block adds the clock cycles its warp spent in each section of the stage
// loop: prof[0..4] = assemble, factor, solve, gains, value. The wait for the
// stage's asynchronous copies counts as assembly.
// Built with -DSWEEP_PROF_FINE (the Bunch-Kaufman and wide kernels), the
// slots split the factorization instead: column search, rook trips,
// interchanges, multipliers, trailing update (PROF_FINE); the other
// sections are not counted.
#define PROF_ADD(slot)                                                \
    if (a.prof != nullptr && threadIdx.x == 0) {                      \
        const long long now = clock64();                              \
        atomicAdd((unsigned long long*)&a.prof[slot],                 \
                  (unsigned long long)(now - tick));                  \
        tick = now;                                                   \
    }
#if SWEEP_PROF_FINE
#define PROF(slot)                                                    \
    if (a.prof != nullptr && threadIdx.x == 0) tick = clock64();
#define PROF_FINE(slot) PROF_ADD(slot)
#else
#define PROF(slot) PROF_ADD(slot)
#define PROF_FINE(slot)
#endif

template <typename T>
__device__ __forceinline__ bool finite_(T v) { return isfinite(v); }

// One contiguous run of LEN values, copied by the G lanes of a group: in
// 16-byte pieces when the run's size is a multiple of 16 bytes (source and
// target then are 16-byte aligned: the wrapper checks the tensors' bases,
// the layout aligns the targets), else value by value.
template <typename T, int LEN>
__device__ __forceinline__ void copy_run(T* dst, const T* src, const int r) {
    constexpr int BYTES = LEN * (int)sizeof(T);
    if constexpr (LEN == 0) {
        return;
    } else if constexpr (BYTES % 16 == 0) {
        constexpr int N = BYTES / 16;
        char* d = reinterpret_cast<char*>(dst);
        const char* s = reinterpret_cast<const char*>(src);
        for (int i = r; i < N; i += G) cp_async_16(d + 16 * i, s + 16 * i);
    } else if constexpr (sizeof(T) == 8) {
        for (int i = r; i < LEN; i += G) cp_async_8(dst + i, src + i);
    } else {
        for (int i = r; i < LEN; i += G) cp_async_4(dst + i, src + i);
    }
}

// All 16 runs of stage row s (= b * T + t) into the stage buffer `buf`.
template <typename T>
__device__ __forceinline__ void copy_stage(T* buf, const SweepArgs& a,
                                           const size_t s, const int r) {
    using L = Lay<T>;
    copy_run<T, NX * NX>(buf + L::FX, (const T*)a.fx + s * (NX * NX), r);
    copy_run<T, NX * NU>(buf + L::FU, (const T*)a.fu + s * (NX * NU), r);
    copy_run<T, NX>(buf + L::LX, (const T*)a.lx + s * NX, r);
    copy_run<T, NU>(buf + L::LU, (const T*)a.lu + s * NU, r);
    copy_run<T, NX * NX>(buf + L::LXX, (const T*)a.lxx + s * (NX * NX), r);
    copy_run<T, NU * NX>(buf + L::LUX, (const T*)a.lux + s * (NU * NX), r);
    copy_run<T, NU * NU>(buf + L::LUU, (const T*)a.luu + s * (NU * NU), r);
    copy_run<T, NC * NX>(buf + L::CX, (const T*)a.cx + s * (NC * NX), r);
    copy_run<T, NC * NU>(buf + L::CU, (const T*)a.cu + s * (NC * NU), r);
    copy_run<T, NZ * NZ>(buf + L::SEC, (const T*)a.sec + s * (NZ * NZ), r);
    copy_run<T, NC>(buf + L::CC, (const T*)a.c + s * NC, r);
    copy_run<T, NU>(buf + L::IL, (const T*)a.il + s * NU, r);
    copy_run<T, NU>(buf + L::IU, (const T*)a.iu + s * NU, r);
    copy_run<T, NC>(buf + L::PHI, (const T*)a.phi + s * NC, r);
    copy_run<T, NU>(buf + L::ZL, (const T*)a.zl + s * NU, r);
    copy_run<T, NU>(buf + L::ZU, (const T*)a.zu + s * NU, r);
}

// Sum over the lanes of a group; every lane ends with the same value.
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL, v, off, G);
    return v;
}

// Triangular solves with the factor L D L^T for all NK right-hand sides at
// once, lane i holding row i. `ls` is L in shared memory, [step][lane]:
// L(i, step j) for lane i (0 unless lane i was live after step j); `pv[j]`
// the lane eliminated at step j, `my_step` this lane's own step, `safe` its
// pivot with the zero-pivot guard.
//
// Forward: y <- L^{-1} P y, a column of L per step. L(i, j) is 0 on the
// lanes that step j does not touch, so no lane is masked; where a 0 meets a
// non-finite value the lane's solution is non-finite anyway and the gate
// fails it. (For the right-hand side itself the factorization loop does
// these same steps as it goes, see there.)
template <typename T>
__device__ __forceinline__ void ldlt_forward_group(
        T (&y)[NK], const T* __restrict__ ls, const T* __restrict__ pv,
        const int r) {
#pragma unroll STEP_UNROLL
    for (int j = 0; j < M; ++j) {
        const int pj = (int)pv[j];
        const T lj = ls[j * LP + r];
#pragma unroll
        for (int c = 0; c < NK; ++c) {
            const T yb = __shfl_sync(FULL, y[c], pj, G);
            y[c] -= lj * yb;
        }
    }
}

// Backward: y <- the solution of L^T x = D^{-1} y, column-wise from the last
// pivot: once the pivot lane of step i holds its x, every lane q takes
// L(i, step q) x_i off its own entry (the mirror holds 0 for the pivots that
// came before q, and for q itself).
template <typename T>
__device__ __forceinline__ void ldlt_backward_group(
        T (&y)[NK], const T* __restrict__ pv, const int my_step, const T safe,
        const T* __restrict__ ls, const bool row_ok) {
#pragma unroll
    for (int c = 0; c < NK; ++c) y[c] = y[c] / safe;
    const T* my_l = ls + (row_ok ? my_step : 0) * LP;
#pragma unroll STEP_UNROLL
    for (int i = M - 1; i >= 0; --i) {
        const int pi = (int)pv[i];
        const T lv = my_l[pi];
#pragma unroll
        for (int c = 0; c < NK; ++c) {
            const T xb = __shfl_sync(FULL, y[c], pi, G);
            y[c] -= lv * xb;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(NT)
backward_sweep_kernel(const SweepArgs a, const int B, const int Tn,
                      const int refine, const T rtol) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using L = Lay<T>;
    const int r = threadIdx.x % G;            // lane of the group = row
    const int grp = threadIdx.x / G;          // instance within the block
    const int b_raw = blockIdx.x * IPB + grp;
    // a ragged last block repeats the last instance and stores nothing: no
    // lane may leave before the shuffles
    const bool valid = b_raw < B;
    const int b = valid ? b_raw : B - 1;
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + (size_t)grp * L::INST;
    const bool row_ok = r < M;                // lanes M..G-1 own no row
    const int rr = row_ok ? r : M - 1;        // a row they may safely read
    const unsigned gshift = ((threadIdx.x & 31) / G) * G;
    const unsigned gmask = (G == 32) ? FULL : (((1u << (G % 32)) - 1u) << gshift);

    T* __restrict__ k0s = sm + L::K0;
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

    // first stage's inputs on their way, then the terminal value function
    const size_t s_last = (size_t)b * Tn + (Tn - 1);
    copy_stage<T>(sm, a, s_last, r);
    cp_async_commit();
    for (int i = r; i < NX; i += G) vx[i] = ((const T*)a.lTx)[b * NX + i];
    for (int i = r; i < NX * NX; i += G)
        vxx[i] = ((const T*)a.lTxx)[(size_t)b * NX * NX + i];

    T dL = T(0);                     // held by the lane of the last task
    bool fail = false, singular = false;

    for (int t = Tn - 1; t >= 0; --t) {
        const size_t s = (size_t)b * Tn + t;          // stage row
        long long tick = (a.prof != nullptr) ? clock64() : 0;
        const int cur = (Tn - 1 - t) & 1;
        T* __restrict__ in = sm + cur * L::IN_LEN;
        // every lane is done with the other buffer (end of the last stage)
        __syncwarp();
        if (t > 0) copy_stage<T>(sm + (cur ^ 1) * L::IN_LEN, a, s - 1, r);
        cp_async_commit();           // an empty group at t = 0
        cp_async_wait_but_one();     // this stage's copies have landed
        __syncwarp();

        const T* fx_t = in + L::FX;    const T* fu_t = in + L::FU;
        const T* lx_t = in + L::LX;    const T* lu_t = in + L::LU;
        const T* lxx_t = in + L::LXX;  const T* lux_t = in + L::LUX;
        const T* luu_t = in + L::LUU;  const T* cx_t = in + L::CX;
        const T* cu_t = in + L::CU;    const T* sec_t = in + L::SEC;
        const T* c_t = in + L::CC;     const T* il_t = in + L::IL;
        const T* iu_t = in + L::IU;    const T* phi_t = in + L::PHI;
        const T* zl_t = in + L::ZL;    const T* zu_t = in + L::ZU;

        // ---- assembly: lane r forms row r of K and of the rhs ----
        T w[M], rhs[NK];
        T diag = T(0);
#pragma unroll
        for (int k = 0; k < M; ++k) w[k] = T(0);
#pragma unroll
        for (int c = 0; c < NK; ++c) rhs[c] = T(0);
        if (r < NU) {
            const int i = r;
            T fui[NX], fuv[NX];          // column i of fu; row i of fu^T Vxx'
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
            T qu = lu_t[i];
#pragma unroll
            for (int c = 0; c < NC; ++c) qu += cu_t[c * NU + i] * phi_t[c];
#pragma unroll
            for (int k = 0; k < NX; ++k) qu += fui[k] * vx[k];
            qu = qu - mu * sl + mu * su;
            rhs[0] = -qu;
#pragma unroll
            for (int j = 0; j < NX; ++j) {    // B = lux + fuV fx + sec_ux
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fuv[k] * fx_t[k * NX + j];
                rhs[1 + j] = -(lux_t[i * NX + j] + acc
                               + sec_t[(NX + i) * NZ + j]);
            }
#pragma unroll
            for (int j = 0; j < NU; ++j) {    // H = luu + fuV fu + sec_uu
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < NX; ++k) acc += fuv[k] * fu_t[k * NU + j];
                T h = luu_t[i * NU + j] + acc + sec_t[(NX + i) * NZ + NX + j];
                if (i == j) {
                    h = h + (zl_t[i] * sl + zu_t[i] * su) + reg;
                    diag = h;
                }
                w[j] = h;
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) w[NU + c] = cu_t[c * NU + i];
        } else if (r < M) {
            const int c = r - NU;
#pragma unroll
            for (int j = 0; j < NU; ++j) w[j] = cu_t[c * NU + j];
#pragma unroll
            for (int c2 = 0; c2 < NC; ++c2)
                w[NU + c2] = (c2 == c) ? -dc : T(0);
            diag = -dc;
            rhs[0] = -c_t[c];
#pragma unroll
            for (int j = 0; j < NX; ++j) rhs[1 + j] = -cx_t[c * NX + j];
        }
        T ssa_part = T(0);
        if (row_ok) {
#pragma unroll
            for (int k = 0; k < M; ++k) {
                k0s[r * MP + k] = w[k];
                ssa_part += w[k] * w[k];
            }
#pragma unroll
            for (int c = 0; c < NK; ++c) rs[r * NK + c] = rhs[c];
        }
        // C = lxx + sec_xx + fx^T Vxx' fx, row ri on lane G-1 - ri % G
#pragma unroll
        for (int ri = 0; ri < NX; ++ri) {
            if ((ri % G) != G - 1 - r) continue;
            T fxv[NX];                        // row ri of fx^T Vxx'
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

        PROF(0)
        // ---- LDL^T with implicit max-|diagonal| pivoting, a row a lane ----
        unsigned live = (M >= 32) ? FULL : ((1u << (M % 32)) - 1u);
        int n_pos = 0, n_zero = 0;
        bool d_finite = true;
        int my_step = M;                 // never reached by a lane w/o row
        T my_d = T(1);
        // the right-hand sides ride along as further columns: step j of their
        // forward substitution is done with step j of the elimination, so
        // that its broadcasts travel with the pivot row's
        T y0[NK];
#pragma unroll
        for (int c = 0; c < NK; ++c) y0[c] = rhs[c];
#pragma unroll STEP_UNROLL
        for (int j = 0; j < M; ++j) {
            // arg-max of |diagonal| over the live rows: the larger value, the
            // lower index on ties, a NaN before any number, the first NaN
            const bool me_live = row_ok && ((live >> r) & 1u);
            // before a later one: a xor butterfly of (|d|, index) pairs;
            // rows that are gone carry -1
            T bav = me_live ? fabs(diag) : T(-1);
            int bidx = r;
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
                const T oav = __shfl_xor_sync(FULL, bav, off, G);
                const int oidx = __shfl_xor_sync(FULL, bidx, off, G);
                const bool onan = oav != oav, mnan = bav != bav;
                const bool other = (onan || mnan)
                    ? (onan && (!mnan || oidx < bidx))
                    : (oav > bav || (oav == bav && oidx < bidx));
                bav = other ? oav : bav;
                bidx = other ? oidx : bidx;
            }
            const int p = bidx;
            const T dj = __shfl_sync(FULL, diag, p, G);
            const T safe = (dj == T(0)) ? T(1) : dj;   // zero-pivot guard
            live &= ~(1u << p);
            if (r == 0) pv[j] = T(p);
            n_pos += (dj > T(0));
            n_zero += (dj == T(0));
            d_finite = d_finite && finite_(dj);
            if (r == p) { my_step = j; my_d = safe; }
            // the pivot's row, which by symmetry is its column times the
            // pivot: dj * L(k, j) for the live k. It does not wait for the
            // division below.
            T prow[M];
#pragma unroll
            for (int k = 0; k < M; ++k) prow[k] = __shfl_sync(FULL, w[k], p, G);
            // this lane's entry of the pivot column, from its own row
            T wp = T(0);
#pragma unroll
            for (int k = 0; k < M; ++k) wp = (k == p) ? w[k] : wp;
            const bool still = row_ok && ((live >> r) & 1u);
            // Only a live lane with a numerator other than 0 divides it by
            // the pivot; every other lane divides 1 and drops the result.
            // The division has a slow path for special operands, a zero
            // numerator among them (K is full of structural zeros), and the
            // lanes that take it hold up their warp: a fifth of the
            // factorization's time on sparse matrices. 0 over a number is 0
            // either way, up to its sign. (Over a NaN pivot it would be NaN;
            // that instance fails at this stage on either side.)
            const bool divide = still && wp != T(0);
            const T l = divide ? (divide ? wp : T(1)) / safe : T(0);
            ls[j * LP + r] = l;
#pragma unroll
            for (int c = 0; c < NK; ++c) {
                const T yb = __shfl_sync(FULL, y0[c], p, G);
                y0[c] -= l * yb;
            }
            // Schur update W(i, k) -= L(i, j) dj L(k, j); nothing where the
            // pivot is an exact zero, as in dj * l * l. No row or column is
            // masked: l is 0 on the rows that are gone, and what lands in a
            // column that is gone is never read again.
            const T lu = (dj == T(0)) ? T(0) : l;
#pragma unroll
            for (int k = 0; k < M; ++k) w[k] -= lu * prow[k];
            diag -= lu * wp;
        }
        __syncwarp();                    // L and the pivot order are complete

        PROF(1)
        // ---- solve, refine, gate: all right-hand sides together ----
        T x[NK];
#pragma unroll
        for (int c = 0; c < NK; ++c) x[c] = T(0);
        T ssr_part = T(0), ssx_part = T(0), ssb_part = T(0);
        bool x_finite = true;
        // pass 0 solves for rhs itself, passes 1..refine for the residual
        // (iterative refinement), the last pass only measures
#pragma unroll 1
        for (int pass = 0; pass <= refine + 1; ++pass) {
            T res[NK];
            if (pass == 0) {         // forward substitution done above
#pragma unroll
                for (int c = 0; c < NK; ++c) res[c] = y0[c];
            } else {
                __syncwarp();            // the last residual has been read
                if (row_ok) {
#pragma unroll
                    for (int c = 0; c < NK; ++c) xs[r * NK + c] = x[c];
                }
                __syncwarp();
                T ax[NK];
#pragma unroll
                for (int c = 0; c < NK; ++c) ax[c] = T(0);
#pragma unroll
                for (int k = 0; k < M; ++k) {
                    const T kv = k0s[rr * MP + k];
#pragma unroll
                    for (int c = 0; c < NK; ++c) ax[c] += kv * xs[k * NK + c];
                }
#pragma unroll
                for (int c = 0; c < NK; ++c)
                    res[c] = row_ok ? rhs[c] - ax[c] : T(0);
            }
            if (pass == refine + 1) {
#pragma unroll
                for (int c = 0; c < NK; ++c) {
                    ssr_part += res[c] * res[c];
                    ssb_part += rhs[c] * rhs[c];
                    ssx_part += x[c] * x[c];
                    x_finite = x_finite && finite_(x[c]);
                }
                break;
            }
            if (pass > 0) ldlt_forward_group<T>(res, ls, pv, r);
            ldlt_backward_group<T>(res, pv, my_step, my_d, ls, row_ok);
#pragma unroll
            for (int c = 0; c < NK; ++c)
                x[c] = row_ok ? ((pass == 0) ? res[c] : x[c] + res[c]) : T(0);
        }
        const T ssr = group_sum(ssr_part), ssa = group_sum(ssa_part);
        const T ssx = group_sum(ssx_part), ssb = group_sum(ssb_part);
        const unsigned fin = __ballot_sync(FULL, x_finite || !row_ok);
        const bool solve_ok =
            (sqrt(ssr) <= rtol * (sqrt(ssa) * sqrt(ssx) + sqrt(ssb)))
            && ((fin & gmask) == gmask);

        PROF(2)
        // ---- gains: each lane writes what it holds ----
        if (valid && r < NU) {
            const int i = r;
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
        } else if (valid && r < M) {
            const int c = r - NU;
            psi[s * NC + c] = x[0];
#pragma unroll
            for (int j = 0; j < NX; ++j)
                omega[(s * NC + c) * NX + j] = x[1 + j];
        }

        PROF(3)
        // ---- value recursion (rs holds -Qu, -B, -c, -cx; xs the gains) ----
        // Vxx = C + beta^T B + omega^T cx;  Vx = lx + cx^T phi + beta^T Qu
        //       + omega^T c + fx^T Vx';     dL += Qu.alpha + c.psi
        // nx*nx + nx + 1 sums over the rows, spread over the lanes
        constexpr int NV = NX * NX + NX + 1;
        for (int task = r; task < NV; task += G) {
            if (task < NX * NX) {
                const int i = task / NX, j = task - i * NX;
                T g = T(0);
#pragma unroll
                for (int q = 0; q < M; ++q)
                    g += xs[q * NK + 1 + i] * rs[q * NK + 1 + j];
                cs[task] -= g;
            } else if (task < NX * NX + NX) {
                const int i = task - NX * NX;
                T v = lx_t[i];
#pragma unroll
                for (int c = 0; c < NC; ++c) v += cx_t[c * NX + i] * phi_t[c];
                T gq = T(0);
#pragma unroll
                for (int q = 0; q < M; ++q)
                    gq += xs[q * NK + 1 + i] * rs[q * NK];
                v -= gq;
#pragma unroll
                for (int k = 0; k < NX; ++k) v += fx_t[k * NX + i] * vx[k];
                vxn[i] = v;
            } else {
                T dq = T(0);
#pragma unroll
                for (int q = 0; q < M; ++q) dq += rs[q * NK] * xs[q * NK];
                dL -= dq;
            }
        }
        __syncwarp();
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

#if SWEEP_BK || SWEEP_WIDE
#include "sweep_instance.cuh"
#endif
#if SWEEP_BK
#include "backward_sweep_bk.cuh"
#define SWEEP_KERNEL backward_sweep_bk_kernel
#define SWEEP_INST(T) LayBK<T>::INST
#elif SWEEP_WIDE
#include "backward_sweep_wide.cuh"
#define SWEEP_KERNEL backward_sweep_wide_kernel
#define SWEEP_INST(T) LayW<T>::INST
#else
#define SWEEP_KERNEL backward_sweep_kernel
#define SWEEP_INST(T) Lay<T>::INST
#endif

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
    const size_t bytes = (size_t)SWEEP_INST(T) * IPB * sizeof(T);
    if (bytes > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(SWEEP_KERNEL<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + IPB - 1) / IPB;
    SWEEP_KERNEL<T><<<blocks, NT, bytes, stream>>>(
        *args, B, Tn, refine, (T)rtol);
    return (int)cudaGetLastError();
}

extern "C" {

// Both return the CUDA error code of the launch (0 = launched). `args` is a
// host array of 33 pointers in the order of SweepArgs (the last, `prof`,
// may be null). The 16 stage tensors must start on 16-byte boundaries.
// Built with SWEEP_BK, `refine` is ignored and `rtol` is the inertia
// tolerance atol.
int backward_sweep_f32(const void* const* ptrs, int B, int Tn, int refine,
                       double rtol, void* stream);
int backward_sweep_f64(const void* const* ptrs, int B, int Tn, int refine,
                       double rtol, void* stream);
// out[0..7] = nx, nu, nc, lanes per instance, instances per block, threads
// per block, shared-memory bytes per block in float and in double
int backward_sweep_dims(int* out);

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

int backward_sweep_dims(int* out) {
    out[0] = NX; out[1] = NU; out[2] = NC; out[3] = G; out[4] = IPB;
    out[5] = NT;
    out[6] = SWEEP_INST(float) * IPB * (int)sizeof(float);
    out[7] = SWEEP_INST(double) * IPB * (int)sizeof(double);
    return 0;
}
