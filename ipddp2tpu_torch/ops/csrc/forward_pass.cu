// Forward pass of the interior-point DDP solver: the line search's rollouts,
// one launch for all of a batch.
//
// Replaces the TPU kernels of ipddp2tpu/ops/forward_pallas.py:
//   forward_metrics_{f32,f64}  <- forward_metrics_pallas (K3): for every
//       instance b and every candidate step size gammas[k], roll the affine
//       update law out over the T stages with the model inside the kernel
//       and reduce to the line search's measures: theta = sum |c_rel|, the
//       barrier Lagrangian L, the objective J, and the two flags "all
//       finite" and "fraction to the boundary kept". No trajectory is
//       written.
//   forward_trial_{f32,f64}    <- forward_trial_pallas (K4): the same
//       rollout at one step size gamma[b] per instance, writing the trial
//       (x, u, phi, zl, zu, il, iu, c_raw un-relaxed) and no measures.
// The double instantiation is native FP64: the double-single arithmetic of
// the TPU kernel is not carried over. The Pallas grid (batch tiles, K, T)
// with the state carried in scratch from grid step to grid step becomes a
// loop over t inside a group of lanes. Both kernels share the row
// arithmetic and the model call, as the Pallas source shares
// `_kernel_body`. Their plain versions are `forward_metrics_plain` /
// `forward_trial_plain` in `ops/forward_cuda.py`, which walk the stages in
// this order.
//
// Per stage, from x = xbar[0]:
//   dx  = x - xbar[t]
//   u   = ubar   + gamma * alpha + beta   dx      (likewise phi, zl, zu)
//   il  = u - lo,  iu = hi - u                    (+inf at an absent bound)
//   (x', c_raw, cost) = model::stage(x, u, t, theta)
//   c_rel = c_raw - mu on the complementarity rows (COMPL_MASK, metrics only)
//   theta += sum |c_rel|;  J += cost
//   L += cost + (c_rel . phi - mu * (sum log il + sum log iu)), logs over
//        finite bounds only
//   finite &= u, phi, zl, zu, x', c_raw all finite
//   ftb    &= no entry with (1 - tau) * nominal > current on il, iu, zl, zu
// and after the last stage J, L += model::terminal(x_T).
//
// Bound on this card: bytes. Each instance reads 248 values per stage
// (concar; the eight gains are 170 of them) and the arithmetic is a few
// hundred operations per stage and candidate, so the least time is the
// inputs over the memory rate. What stands between a kernel and that bound
// is the number of instructions a lane runs per stage: a warp alone gets
// through about one in 5 clocks, so the designs below deal the stage's rows
// over lanes and keep enough warps on an SM to hide that.
//
// The trial kernel (K4): a GROUP of GT lanes of a warp owns an instance (GT
// = 16 for concar, two instances a warp, 1,024 warps at B = 2048). The rows
// of the update law, stacked u | phi | zl | zu (34 for concar), are dealt
// round over the lanes; a row is `bar + gamma * ff + fb . dx` from 2 + nx
// values that are contiguous with the next lane's, so a group's loads cover
// whole runs of an instance's stage instead of 32 scattered addresses a warp.
// The addresses of a stage's inputs do not depend on the state x, so every
// lane loads its rows of stage t+1 into a second set of registers before
// stage t's model runs: the loads of a whole stage are in flight during the
// chain dx -> nx multiply-adds -> gather of u by shuffles -> model::stage.
// The model is evaluated by every lane of the group on the gathered u (the
// same time as once, and x', c need no broadcast). Every value is stored by
// the lane that holds it: a row by its owner (with il, iu beside a u row),
// x and c by the first lanes. A batch that does not fill its last block is
// padded by clamping the instance and masking the stores.
//
// The metrics kernel (K3): a WARP owns an instance and all K of its
// candidates; they share one copy of the instance's stage.
//  * Stage buffer: the warp's lanes copy the 17 runs of stage t+1 (lo, hi,
//    xbar, the nominal rows and slacks, the eight gains; each a contiguous
//    run of the solver's dense [B, T, ...] tensors) into the second of two
//    shared-memory buffers with `cp.async` while stage t is computed. The
//    buffer stacks the rows as the update law does (bar, feedforward and
//    feedback of u | phi | zl | zu each one array), so row q of any kind is
//    found at one index. A run is copied in 16-byte pieces where its length
//    and its place in the buffer allow, else in 8- or 4-byte pieces.
//    theta is copied once per instance, beside the buffers.
//  * Candidates over lanes: LC lanes own a candidate, LC the largest power
//    of two <= 32 / K (concar at K = 8: 4 lanes, 8 candidates a warp). A K
//    above 32 loops over chunks of 32 candidates; a K that leaves lanes over
//    puts them on a clamped candidate that stores nothing. No lane leaves
//    before a shuffle.
//  * Rows over the candidate's lanes: lane r takes rows r, r + LC, .. of
//    the 34, reading bar, feedforward and feedback from the shared buffer
//    (lanes of other candidates read the same address: a broadcast). A u
//    row's lane also tests il, iu against their nominal and takes their two
//    logs, a zl or zu row's lane tests it against its nominal, a phi row's
//    lane keeps it for c . phi. u is gathered by shuffles, the model runs on
//    every lane of the candidate (x', c need no broadcast).
//  * Sums per lane: L gets each lane's c . phi and log terms, the first lane
//    of a candidate adds the cost and keeps theta and J; the lanes' sums are
//    added by a butterfly at the end, the flags AND-ed by a ballot. L is
//    thereby summed in another order than the plain version's.
//  * One warp an instance, 4 warps a block (16 KB of shared memory in
//    double for concar) and at most 128 registers a thread: 16 warps an SM,
//    2,048 warps of B = 2048 in one wave of the 132 SMs.
// The wrapper computes the geometry (lanes per candidate, chunks, warps and
// shared bytes a block, `metrics_geometry`) and passes it; the library
// refuses a launch whose geometry differs from its own.
//
// Plain IEEE arithmetic (no fast-math): comparisons with NaN must be false,
// inf - inf must be NaN, and log is only taken where the bound is finite.
//
// Compile-time parameters: -DNX -DNU -DNC (checked against the model),
// -DCOMPL_MASK (bit r set = row r is relaxed by mu), -DMODEL_HEADER (the
// model's device functions, a header under models/). One library per tuple.
// Plain C interface for ctypes, see the end of the file.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "async_copy.cuh"

#if !defined(NX) || !defined(NU) || !defined(NC) || !defined(MODEL_HEADER)
#error "define NX, NU, NC and MODEL_HEADER"
#endif
#ifndef COMPL_MASK
#define COMPL_MASK 0
#endif

#include MODEL_HEADER

static_assert(model::NX_ == NX && model::NU_ == NU && model::NC_ == NC,
              "the model's device functions have other dimensions");

constexpr int NC1 = NC > 0 ? NC : 1;         // no zero-length arrays
constexpr int WARP = 32;
constexpr int NT_METRICS = 128;              // at most 4 warps, one instance each
constexpr int NT_TRIAL = 128;                // 4 warps of instance groups
constexpr int NR = 3 * NU + NC;              // rows of the update law
constexpr int SMEM_LIMIT = 232448;           // 227 KB a block on an H100
constexpr int pow2_at_least(int n) {
    int g = 1;
    while (g < n) g *= 2;
    return g;
}
// lanes that own one instance in the trial kernel, and rows a lane holds
constexpr int GT = pow2_at_least(NR) < 16 ? pow2_at_least(NR) : 16;
constexpr int KR = (NR + GT - 1) / GT;
constexpr unsigned FULL = 0xffffffffu;

struct FwdArgs {
    // inputs, dense row-major
    const void *lo, *hi;                     // [B, T, NU]
    const void *xbar;                        // [B, T+1, NX]
    const void *ubar, *phibar, *zlbar, *zubar, *ilbar, *iubar;  // [B, T, .]
    const void *alpha, *beta, *psi, *omega;  // [B, T, NU], [B, T, NU, NX], ..
    const void *chi_l, *zeta_l, *chi_u, *zeta_u;
    const void *theta;                       // [B, THETA_DIM] or null
    const void *mu, *tau;                    // [B]
    const void *gamma;                       // metrics: [K]; trial: [B]
    // outputs of the metrics kernel, [B, K]
    void *th, *L, *J;
    unsigned char *finite, *ftb;
    // outputs of the trial kernel
    void *x;                                 // [B, T+1, NX]
    void *u, *phi, *zl, *zu, *il, *iu, *c;   // [B, T, .]
};

// One affine row: bar + gamma * ff + fb . dx
template <typename T>
__device__ __forceinline__ T affine(const T bar, const T gamma, const T ff,
                                    const T* __restrict__ fb, const T* dx) {
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < NX; ++i) acc += fb[i] * dx[i];
    return bar + gamma * ff + acc;
}

// ---- K3: the metrics kernel ----------------------------------------------

// Values of T rounded up to whole 16 bytes.
template <typename T>
constexpr int up16(int n) {
    constexpr int A = 16 / (int)sizeof(T);
    return (n + A - 1) / A * A;
}

// One instance's shared memory, in values of T: two stage buffers, then
// theta. Within a buffer the rows are stacked u | phi | zl | zu.
template <typename T>
struct MLay {
    static constexpr int BAR = 0;                    // [NR] ubar|phibar|zlbar|zubar
    static constexpr int FF = BAR + NR;              // [NR] alpha|psi|chi_l|chi_u
    static constexpr int FB = up16<T>(FF + NR);      // [NR][NX] beta|omega|zeta_l|zeta_u
    static constexpr int LO = up16<T>(FB + NR * NX); // [NU] lo, hi, ilbar, iubar
    static constexpr int HI = LO + NU;
    static constexpr int ILB = HI + NU;
    static constexpr int IUB = ILB + NU;
    static constexpr int XB = up16<T>(IUB + NU);     // [NX] xbar[t]
    static constexpr int LEN = up16<T>(XB + NX);     // one stage buffer
    static constexpr int TH = 2 * LEN;               // theta
    static constexpr int INST = up16<T>(TH + model::THETA_DIM);
};

// Lanes of a warp that own one candidate: the largest power of two <= 32/K.
__host__ __device__ constexpr int metrics_lanes(int K) {
    const int room = K >= 1 ? WARP / K : 0;
    int g = 1;
    while (2 * g <= room) g *= 2;
    return g;
}

// The launch geometry for K candidates (what `metrics_geometry` in
// ops/forward_cuda.py computes): lanes per candidate, chunks of candidates,
// warps (= instances) per block, threads per block, shared bytes per block.
// Warps per block: 4 where their shared memory fits the card, else 2, else
// 1, else 0 (the wrapper refuses such a model).
template <typename T>
static void metrics_geometry_of(int K, int* out) {
    const int lanes = metrics_lanes(K);
    const int per_chunk = WARP / lanes;
    const int bytes = MLay<T>::INST * (int)sizeof(T);
    int warps = NT_METRICS / WARP;
    while (warps > 0 && warps * bytes > SMEM_LIMIT) warps /= 2;
    out[0] = lanes;
    out[1] = (K + per_chunk - 1) / per_chunk;
    out[2] = warps;
    out[3] = warps * WARP;
    out[4] = warps * bytes;
}

// A run of LEN values from device memory to buffer offset OFF, copied by the
// 32 lanes of a warp in the largest pieces that the run's length and its
// offset allow (the source's alignment follows: its base is 16-byte aligned
// and it lies a whole number of runs from it).
template <typename T, int OFF, int LEN>
__device__ __forceinline__ void copy_run(T* buf, const T* src,
                                         const int lane) {
    constexpr int BYTES = LEN * (int)sizeof(T);
    constexpr int AT = OFF * (int)sizeof(T);
    char* d = reinterpret_cast<char*>(buf + OFF);
    const char* s = reinterpret_cast<const char*>(src);
    if constexpr (LEN == 0) {
        return;
    } else if constexpr (BYTES % 16 == 0 && AT % 16 == 0) {
        for (int i = lane; i < BYTES / 16; i += WARP)
            cp_async_16(d + 16 * i, s + 16 * i);
    } else if constexpr (BYTES % 8 == 0 && AT % 8 == 0) {
        for (int i = lane; i < BYTES / 8; i += WARP)
            cp_async_8(d + 8 * i, s + 8 * i);
    } else {
        for (int i = lane; i < BYTES / 4; i += WARP)
            cp_async_4(d + 4 * i, s + 4 * i);
    }
}

// All 17 runs of instance b's stage t into the stage buffer `buf`.
template <typename T>
__device__ __forceinline__ void copy_metrics_stage(T* buf, const FwdArgs& a,
                                                   const int b, const int Tn,
                                                   const int t,
                                                   const int lane) {
    using L = MLay<T>;
    const size_t s = (size_t)b * Tn + t;     // stage row
    constexpr int U = 0, P = NU, ZL = NU + NC, ZU = 2 * NU + NC;
    copy_run<T, L::BAR + U, NU>(buf, (const T*)a.ubar + s * NU, lane);
    copy_run<T, L::BAR + P, NC>(buf, (const T*)a.phibar + s * NC, lane);
    copy_run<T, L::BAR + ZL, NU>(buf, (const T*)a.zlbar + s * NU, lane);
    copy_run<T, L::BAR + ZU, NU>(buf, (const T*)a.zubar + s * NU, lane);
    copy_run<T, L::FF + U, NU>(buf, (const T*)a.alpha + s * NU, lane);
    copy_run<T, L::FF + P, NC>(buf, (const T*)a.psi + s * NC, lane);
    copy_run<T, L::FF + ZL, NU>(buf, (const T*)a.chi_l + s * NU, lane);
    copy_run<T, L::FF + ZU, NU>(buf, (const T*)a.chi_u + s * NU, lane);
    copy_run<T, L::FB + U * NX, NU * NX>(buf, (const T*)a.beta + s * NU * NX,
                                         lane);
    copy_run<T, L::FB + P * NX, NC * NX>(buf, (const T*)a.omega + s * NC * NX,
                                         lane);
    copy_run<T, L::FB + ZL * NX, NU * NX>(
        buf, (const T*)a.zeta_l + s * NU * NX, lane);
    copy_run<T, L::FB + ZU * NX, NU * NX>(
        buf, (const T*)a.zeta_u + s * NU * NX, lane);
    copy_run<T, L::LO, NU>(buf, (const T*)a.lo + s * NU, lane);
    copy_run<T, L::HI, NU>(buf, (const T*)a.hi + s * NU, lane);
    copy_run<T, L::ILB, NU>(buf, (const T*)a.ilbar + s * NU, lane);
    copy_run<T, L::IUB, NU>(buf, (const T*)a.iubar + s * NU, lane);
    copy_run<T, L::XB, NX>(buf,
                           (const T*)a.xbar + ((size_t)b * (Tn + 1) + t) * NX,
                           lane);
}

// NX values from shared memory, in 16-byte loads where a row is whole 16
// bytes (the buffer keeps such rows 16-byte aligned).
__device__ __forceinline__ void unpack_vec(const double2 v, double* f) {
    f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unpack_vec(const float4 v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load_row(T (&f)[NX], const T* src) {
    if constexpr ((NX * sizeof(T)) % 16 == 0) {
        using V = typename std::conditional<sizeof(T) == 8, double2,
                                            float4>::type;
        constexpr int W = 16 / (int)sizeof(T);
#pragma unroll
        for (int i = 0; i < NX / W; ++i)
            unpack_vec(reinterpret_cast<const V*>(src)[i], f + W * i);
    } else {
#pragma unroll
        for (int i = 0; i < NX; ++i) f[i] = src[i];
    }
}

// At most 128 registers a thread (4 blocks, 16 warps an SM), except where a
// lane holds all rows of its candidate (K > 16): 168.
template <typename T, int LC>
__global__ void __launch_bounds__(NT_METRICS, LC == 1 ? 3 : 4)
forward_metrics_kernel(const FwdArgs a, const int B, const int Tn,
                       const int K, const int chunks) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    using L = MLay<T>;
    constexpr int PER_CHUNK = WARP / LC;          // candidates a chunk
    constexpr int RL = (NR + LC - 1) / LC;        // rows a lane
    const int lane = threadIdx.x % WARP;
    const int warp = threadIdx.x / WARP;
    const int r = lane % LC;                      // lane of the candidate
    const int cand = lane / LC;                   // candidate of the chunk
    const int b_raw = blockIdx.x * (blockDim.x / WARP) + warp;
    // a ragged last block repeats the last instance and stores nothing: no
    // lane may leave before the shuffles
    const bool valid = b_raw < B;
    const int b = valid ? b_raw : B - 1;
    T* __restrict__ sm = reinterpret_cast<T*>(smem_raw) + (size_t)warp * L::INST;
    T* __restrict__ theta = sm + L::TH;
    const unsigned mine = (LC == WARP) ? FULL    // this candidate's lanes
        : ((1u << (LC % WARP)) - 1u) << (cand * LC);

    for (int i = lane; i < model::THETA_DIM; i += WARP)
        theta[i] = ((const T*)a.theta)[(size_t)b * model::THETA_DIM + i];
    const T mu = ((const T*)a.mu)[b];
    const T s_ftb = T(1) - ((const T*)a.tau)[b];
    const T* xb0 = (const T*)a.xbar + (size_t)b * (Tn + 1) * NX;

    for (int chunk = 0; chunk < chunks; ++chunk) {
        const int kc = chunk * PER_CHUNK + cand;
        const bool live_c = kc < K;
        const T gamma = ((const T*)a.gamma)[live_c ? kc : K - 1];
        __syncwarp();            // theta is written, the buffers are free
        copy_metrics_stage<T>(sm, a, b, Tn, 0, lane);
        cp_async_commit();

        T x[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xb0[i];
        T th = T(0), Lp = T(0), J = T(0);
        bool fin = true, ftb = true;

        for (int t = 0; t < Tn; ++t) {
            const T* in = sm + (t & 1) * L::LEN;
            __syncwarp();        // every lane is done with the other buffer
            if (t + 1 < Tn)
                copy_metrics_stage<T>(sm + ((t + 1) & 1) * L::LEN, a, b, Tn,
                                      t + 1, lane);
            cp_async_commit();   // an empty group at the last stage
            cp_async_wait_but_one();
            __syncwarp();        // this stage's copies have landed

            T dx[NX];
#pragma unroll
            for (int i = 0; i < NX; ++i) dx[i] = x[i] - in[L::XB + i];

            // this lane's rows r, r + LC, ..: the value, the flags, the logs
            T row[RL], lg = T(0);
#pragma unroll
            for (int k = 0; k < RL; ++k) {
                const int q = r + k * LC;
                const bool live = q < NR;
                const int qq = live ? q : 0;       // dead slots read row 0
                T fb[NX];
                load_row<T>(fb, in + L::FB + qq * NX);
                const T bar = in[L::BAR + qq];
                const T v = affine(bar, gamma, in[L::FF + qq], fb, dx);
                row[k] = v;
                fin = fin && (!live || finite_(v));
                if (k * LC < NU) {                 // the slot may hold a u row
                    const bool is_u = q < NU;
                    const int j = is_u ? q : 0;
                    // +inf at an absent bound, like plain u - (-inf)
                    const T lo = in[L::LO + j], hi = in[L::HI + j];
                    const T il = v - lo, iu = hi - v;
                    ftb = ftb && !(is_u && (s_ftb * in[L::ILB + j] > il
                                            || s_ftb * in[L::IUB + j] > iu));
                    // log 1 = 0 where the row is not a u row or the bound
                    // is absent: every lane takes the same two logs
                    lg += log_(is_u && finite_(lo) ? il : T(1));
                    lg += log_(is_u && finite_(hi) ? iu : T(1));
                }
                if (k * LC + LC > NU + NC) {       // ... a zl or zu row
                    const bool is_z = live && q >= NU + NC;
                    ftb = ftb && !(is_z && s_ftb * bar > v);
                }
            }
            // control j is row j: slot j / LC of lane j % LC
            T u[NU];
#pragma unroll
            for (int j = 0; j < NU; ++j)
                u[j] = LC == 1 ? row[j]
                               : __shfl_sync(FULL, row[j / LC], j % LC, LC);

            T xn[NX], c[NC1], cost;
            model::stage(x, u, t, theta, xn, c, cost);

            T c_rel[NC1], th_stage = T(0);
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                c_rel[j] = ((COMPL_MASK >> j) & 1) ? c[j] - mu : c[j];
                th_stage += abs_(c_rel[j]);
                fin = fin && finite_(c[j]);
            }
#pragma unroll
            for (int i = 0; i < NX; ++i) fin = fin && finite_(xn[i]);
            // c . phi over this lane's phi rows
            T cphi = T(0);
#pragma unroll
            for (int k = 0; k < RL; ++k) {
                if (k * LC + LC > NU && k * LC < NU + NC) {
                    const int j = r + k * LC - NU;
                    T cj = T(0);
#pragma unroll
                    for (int i = 0; i < NC; ++i) cj = (j == i) ? c_rel[i] : cj;
                    cphi += (j >= 0 && j < NC) ? cj * row[k] : T(0);
                }
            }
            if (r == 0) {
                th += th_stage;
                J += cost;
                Lp += cost;
            }
            Lp += cphi - mu * lg;
#pragma unroll
            for (int i = 0; i < NX; ++i) x[i] = xn[i];
        }

        // the candidate's lanes: sums by a butterfly, flags by a ballot
#pragma unroll
        for (int off = LC / 2; off > 0; off >>= 1) {
            th += __shfl_xor_sync(FULL, th, off, LC);
            Lp += __shfl_xor_sync(FULL, Lp, off, LC);
            J += __shfl_xor_sync(FULL, J, off, LC);
        }
        const unsigned fin_lanes = __ballot_sync(FULL, fin);
        const unsigned ftb_lanes = __ballot_sync(FULL, ftb);
        const T term = model::terminal(x, theta);
        if (valid && live_c && r == 0) {
            const size_t o = (size_t)b * K + kc;
            ((T*)a.th)[o] = th;
            ((T*)a.L)[o] = Lp + term;
            ((T*)a.J)[o] = J + term;
            a.finite[o] = (fin_lanes & mine) == mine ? 1 : 0;
            a.ftb[o] = (ftb_lanes & mine) == mine ? 1 : 0;
        }
    }
}

// ---- K4: the trial kernel -------------------------------------------------

// What one lane of a trial group holds of one stage: its KR rows of the
// update law (bar, feedforward, feedback), the bounds beside its u rows,
// and the nominal state. Filled one stage ahead of its use.
template <typename T>
struct StageRows {
    T bar[KR], ff[KR], fb[KR][NX], lo[KR], hi[KR], xb[NX];
};

// Where a lane finds row q of the stacked update law u | phi | zl | zu:
// pointers to stage 0 of instance b, and the values per stage (the row's
// stride from stage to stage).
template <typename T>
struct RowSource {
    const T *bar, *ff, *fb, *lo, *hi;
    T *out, *il, *iu;
    int width;           // rows of this kind per stage: NU or NC
    bool is_u, live;     // a control row (bounds, il, iu); a row at all
};

template <typename T>
__device__ __forceinline__ RowSource<T> row_source(const FwdArgs& a,
                                                   const int b, const int Tn,
                                                   const int q) {
    RowSource<T> s;
    s.live = q < NR;
    const int row = s.live ? q : 0;          // dead slots read row 0 again
    int idx;
    const void *bar, *ff, *fb;
    void* out;
    s.is_u = row < NU;
    s.width = NU;
    if (row < NU) {
        idx = row;
        bar = a.ubar; ff = a.alpha; fb = a.beta; out = a.u;
    } else if (row < NU + NC) {
        idx = row - NU;
        s.width = NC;
        bar = a.phibar; ff = a.psi; fb = a.omega; out = a.phi;
    } else if (row < 2 * NU + NC) {
        idx = row - NU - NC;
        bar = a.zlbar; ff = a.chi_l; fb = a.zeta_l; out = a.zl;
    } else {
        idx = row - 2 * NU - NC;
        bar = a.zubar; ff = a.chi_u; fb = a.zeta_u; out = a.zu;
    }
    const size_t at = (size_t)b * Tn * s.width + idx;
    s.bar = (const T*)bar + at;
    s.ff = (const T*)ff + at;
    s.fb = (const T*)fb + at * NX;
    s.out = (T*)out + at;
    // bounds and slacks exist for the control rows; other rows point at
    // control row 0 and never use what they load there
    const size_t at_u = (size_t)b * Tn * NU + (s.is_u ? idx : 0);
    s.lo = (const T*)a.lo + at_u;
    s.hi = (const T*)a.hi + at_u;
    s.il = (T*)a.il + at_u;
    s.iu = (T*)a.iu + at_u;
    return s;
}

template <typename T>
__device__ __forceinline__ void load_rows(StageRows<T>& g,
                                          const RowSource<T> (&src)[KR],
                                          const T* xb, const int t) {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
        const size_t o = (size_t)t * src[k].width;
        g.bar[k] = src[k].bar[o];
        g.ff[k] = src[k].ff[o];
#pragma unroll
        for (int i = 0; i < NX; ++i) g.fb[k][i] = src[k].fb[o * NX + i];
        if (k * GT < NU) {                   // slots that can hold a u row
            g.lo[k] = src[k].lo[(size_t)t * NU];
            g.hi[k] = src[k].hi[(size_t)t * NU];
        } else {
            g.lo[k] = g.hi[k] = T(0);
        }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) g.xb[i] = xb[t * NX + i];
}

template <typename T>
__global__ void __launch_bounds__(NT_TRIAL)
forward_trial_kernel(const FwdArgs a, const int B, const int Tn) {
    constexpr int IPB = NT_TRIAL / GT;       // instances per block
    const int r = threadIdx.x % GT;          // lane of the group
    const int b_raw = blockIdx.x * IPB + threadIdx.x / GT;
    // a ragged last block repeats the last instance and stores nothing: no
    // lane may leave before the shuffles
    const bool valid = b_raw < B;
    const int b = valid ? b_raw : B - 1;
    const T gamma = ((const T*)a.gamma)[b];
    const T* theta = a.theta == nullptr
        ? nullptr : (const T*)a.theta + (size_t)b * model::THETA_DIM;
    const T* xb = (const T*)a.xbar + (size_t)b * (Tn + 1) * NX;
    T* xo = (T*)a.x + (size_t)b * (Tn + 1) * NX;
    T* co = (T*)a.c + (size_t)b * Tn * NC;

    RowSource<T> src[KR];                    // this lane's rows r, r + GT, ..
#pragma unroll
    for (int k = 0; k < KR; ++k) src[k] = row_source<T>(a, b, Tn, r + k * GT);

    T x[NX], dx[NX], xn[NX], u[NU], c[NC1];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xb[i];

    StageRows<T> cur, nxt;
    load_rows<T>(cur, src, xb, 0);
    for (int t = 0; t < Tn; ++t) {
        // the next stage's rows: their addresses do not depend on x
        load_rows<T>(nxt, src, xb, t + 1 < Tn ? t + 1 : t);
#pragma unroll
        for (int i = 0; i < NX; ++i) dx[i] = x[i] - cur.xb[i];
        T row[KR];
#pragma unroll
        for (int k = 0; k < KR; ++k) {
            row[k] = affine(cur.bar[k], gamma, cur.ff[k], cur.fb[k], dx);
            if (valid && src[k].live) {
                const size_t o = (size_t)t * src[k].width;
                src[k].out[o] = row[k];
                if (src[k].is_u) {
                    // +inf at an absent bound, like plain u - (-inf)
                    src[k].il[(size_t)t * NU] = row[k] - cur.lo[k];
                    src[k].iu[(size_t)t * NU] = cur.hi[k] - row[k];
                }
            }
        }
        // control j is row j: slot j / GT of lane j % GT
#pragma unroll
        for (int j = 0; j < NU; ++j)
            u[j] = __shfl_sync(FULL, row[j / GT], j % GT, GT);

        T cost;
        model::stage(x, u, t, theta, xn, c, cost);

        if (valid) {
#pragma unroll
            for (int i = 0; i < NX; ++i)
                if (r == i % GT) xo[t * NX + i] = x[i];
#pragma unroll
            for (int j = 0; j < NC; ++j)
                if (r == (NX + j) % GT) co[t * NC + j] = c[j];   // un-relaxed
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
        cur = nxt;
    }
    if (valid) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
            if (r == i % GT) xo[Tn * NX + i] = x[i];
    }
}

static FwdArgs unpack(const void* const* p) {
    FwdArgs a;
    a.lo = p[0]; a.hi = p[1]; a.xbar = p[2]; a.ubar = p[3];
    a.phibar = p[4]; a.zlbar = p[5]; a.zubar = p[6]; a.ilbar = p[7];
    a.iubar = p[8]; a.alpha = p[9]; a.beta = p[10]; a.psi = p[11];
    a.omega = p[12]; a.chi_l = p[13]; a.zeta_l = p[14]; a.chi_u = p[15];
    a.zeta_u = p[16]; a.theta = p[17]; a.mu = p[18]; a.tau = p[19];
    a.gamma = p[20];
    a.th = (void*)p[21]; a.L = (void*)p[22]; a.J = (void*)p[23];
    a.finite = (unsigned char*)p[24]; a.ftb = (unsigned char*)p[25];
    a.x = (void*)p[26]; a.u = (void*)p[27]; a.phi = (void*)p[28];
    a.zl = (void*)p[29]; a.zu = (void*)p[30]; a.il = (void*)p[31];
    a.iu = (void*)p[32]; a.c = (void*)p[33];
    return a;
}

template <typename T, int LC>
static int launch_metrics_lanes(const FwdArgs& a, int B, int Tn, int K,
                                const int* geo, cudaStream_t stream) {
    const int chunks = geo[1], warps = geo[2], bytes = geo[4];
    if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            forward_metrics_kernel<T, LC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (B + warps - 1) / warps;
    forward_metrics_kernel<T, LC><<<blocks, warps * WARP, bytes, stream>>>(
        a, B, Tn, K, chunks);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_metrics(const void* const* ptrs, int B, int Tn, int K,
                          const int* geo, cudaStream_t stream) {
    if (B <= 0 || Tn <= 0 || K <= 0) return 0;
    int want[5];
    metrics_geometry_of<T>(K, want);
    for (int i = 0; i < 5; ++i)
        if (geo[i] != want[i]) return (int)cudaErrorInvalidValue;
    if (want[2] == 0) return (int)cudaErrorInvalidConfiguration;
    const FwdArgs a = unpack(ptrs);
    switch (want[0]) {
        case 1: return launch_metrics_lanes<T, 1>(a, B, Tn, K, geo, stream);
        case 2: return launch_metrics_lanes<T, 2>(a, B, Tn, K, geo, stream);
        case 4: return launch_metrics_lanes<T, 4>(a, B, Tn, K, geo, stream);
        case 8: return launch_metrics_lanes<T, 8>(a, B, Tn, K, geo, stream);
        case 16: return launch_metrics_lanes<T, 16>(a, B, Tn, K, geo, stream);
        default: return launch_metrics_lanes<T, 32>(a, B, Tn, K, geo, stream);
    }
}

template <typename T>
static int launch_trial(const void* const* ptrs, int B, int Tn,
                        cudaStream_t stream) {
    if (B <= 0 || Tn <= 0) return 0;
    const FwdArgs a = unpack(ptrs);
    constexpr int IPB = NT_TRIAL / GT;
    const int blocks = (B + IPB - 1) / IPB;
    forward_trial_kernel<T><<<blocks, NT_TRIAL, 0, stream>>>(a, B, Tn);
    return (int)cudaGetLastError();
}

extern "C" {

// Each returns the CUDA error code of the launch (0 = launched). `ptrs` is
// a host array of 34 device pointers in the order of `unpack`; the metrics
// kernel ignores the trial outputs and the trial kernel the metrics outputs
// (null is fine), and `theta` is null for a model without parameters. The
// metrics kernel reads its 17 stage tensors with asynchronous copies: their
// bases must be 16-byte aligned. `geo` is the launch geometry the wrapper
// computed (5 ints, see `forward_metrics_geometry`); a launch with another
// one than the library's own is refused (cudaErrorInvalidValue).
int forward_metrics_f32(const void* const* ptrs, int B, int Tn, int K,
                        const int* geo, void* stream) {
    return launch_metrics<float>(ptrs, B, Tn, K, geo, (cudaStream_t)stream);
}

int forward_metrics_f64(const void* const* ptrs, int B, int Tn, int K,
                        const int* geo, void* stream) {
    return launch_metrics<double>(ptrs, B, Tn, K, geo, (cudaStream_t)stream);
}

int forward_trial_f32(const void* const* ptrs, int B, int Tn, void* stream) {
    return launch_trial<float>(ptrs, B, Tn, (cudaStream_t)stream);
}

int forward_trial_f64(const void* const* ptrs, int B, int Tn, void* stream) {
    return launch_trial<double>(ptrs, B, Tn, (cudaStream_t)stream);
}

// The metrics kernel's geometry at K candidates for values of `itemsize`
// bytes (4 or 8): out[0..4] = lanes per candidate, chunks of candidates,
// warps (instances) per block, threads per block, shared bytes per block.
int forward_metrics_geometry(int K, int itemsize, int* out) {
    if (K < 1 || (itemsize != 4 && itemsize != 8)) return -1;
    if (itemsize == 4) metrics_geometry_of<float>(K, out);
    else metrics_geometry_of<double>(K, out);
    return 0;
}

// What this library was built for: (nx, nu, nc, theta width, compl mask).
int forward_dims(int* out) {
    out[0] = NX; out[1] = NU; out[2] = NC; out[3] = model::THETA_DIM;
    out[4] = COMPL_MASK;
    return 0;
}

}
