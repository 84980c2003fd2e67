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
// loop over t inside a thread (K3) or a group of lanes (K4). Both kernels
// share the row arithmetic and the model call, as the Pallas source shares
// `_kernel_body`. Their plain versions are `forward_metrics_plain` / `forward_trial_plain` in
// `ops/forward_cuda.py`, which walk the stages in this order.
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
// Bound on this card: bytes. Each instance reads about 230 values per stage
// once (the eight gains dominate: 170 of them) and the arithmetic is a few
// hundred operations per stage, so the least time is the inputs over the
// memory rate.
//
// The trial kernel (K4) is laid out for that bound. A GROUP of GT lanes of
// a warp owns an instance (GT = 16 for concar, two instances a warp, 1,024
// warps at B = 2048 where one thread per instance gave 64). The rows of the
// update law, stacked u | phi | zl | zu (34 for concar), are dealt round
// over the lanes; a row is `bar + gamma * ff + fb . dx` from 2 + nx values
// that are contiguous with the next lane's, so a group's loads cover whole
// runs of an instance's stage instead of 32 scattered addresses a warp.
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
// The metrics kernel (K3) keeps its first layout: one thread owns one
// (instance, candidate) and reads the solver's dense [B, T, ...] tensors as
// they are; neighbouring threads are the K candidates of one instance, which
// read the same addresses (one transaction, broadcast). What is left for it:
// the K candidates of an instance sharing one copy of its gains in shared
// memory, loaded one stage ahead like here. Both kernels use one `affine`
// row, one `model::stage` and the same flag rules.
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
constexpr int NT_METRICS = 64;               // threads per block
constexpr int NT_TRIAL = 128;                // 4 warps of instance groups
constexpr int NR = 3 * NU + NC;              // rows of the update law
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

// The rollout of instance b at step size gamma, reduced to the line
// search's measures.
template <typename T>
__device__ __forceinline__ void rollout_metrics(const FwdArgs& a, const int b,
                                                const int Tn, const T gamma,
                                                T& th_out, T& L_out, T& J_out,
                                                bool& fin_out, bool& ftb_out) {
    const T* __restrict__ lo = (const T*)a.lo;
    const T* __restrict__ hi = (const T*)a.hi;
    const T* __restrict__ xbar = (const T*)a.xbar;
    const T* __restrict__ ubar = (const T*)a.ubar;
    const T* __restrict__ phibar = (const T*)a.phibar;
    const T* __restrict__ zlbar = (const T*)a.zlbar;
    const T* __restrict__ zubar = (const T*)a.zubar;
    const T* __restrict__ ilbar = (const T*)a.ilbar;
    const T* __restrict__ iubar = (const T*)a.iubar;
    const T* __restrict__ alpha = (const T*)a.alpha;
    const T* __restrict__ beta = (const T*)a.beta;
    const T* __restrict__ psi = (const T*)a.psi;
    const T* __restrict__ omega = (const T*)a.omega;
    const T* __restrict__ chi_l = (const T*)a.chi_l;
    const T* __restrict__ zeta_l = (const T*)a.zeta_l;
    const T* __restrict__ chi_u = (const T*)a.chi_u;
    const T* __restrict__ zeta_u = (const T*)a.zeta_u;
    const T* theta = a.theta == nullptr
        ? nullptr : (const T*)a.theta + (size_t)b * model::THETA_DIM;

    const T mu = ((const T*)a.mu)[b];
    const T s_ftb = T(1) - ((const T*)a.tau)[b];

    T x[NX], dx[NX], xn[NX], u[NU], phi[NC1], c[NC1];
    const T* xb = xbar + (size_t)b * (Tn + 1) * NX;
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xb[i];

    T th = T(0), L = T(0), J = T(0);
    bool fin = true, ftb = true;

    for (int t = 0; t < Tn; ++t) {
        const size_t s = (size_t)b * Tn + t;             // stage row
#pragma unroll
        for (int i = 0; i < NX; ++i) dx[i] = x[i] - xb[t * NX + i];

        T logsum_l = T(0), logsum_u = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) {
            const size_t r = s * NU + j;
            const T uj = affine(ubar[r], gamma, alpha[r], beta + r * NX, dx);
            const T zlj = affine(zlbar[r], gamma, chi_l[r], zeta_l + r * NX,
                                 dx);
            const T zuj = affine(zubar[r], gamma, chi_u[r], zeta_u + r * NX,
                                 dx);
            const T loj = lo[r], hij = hi[r];
            // +inf at an absent bound, like plain u - (-inf)
            const T ilj = uj - loj, iuj = hij - uj;
            u[j] = uj;
            fin = fin && finite_(uj) && finite_(zlj) && finite_(zuj);
            ftb = ftb && !(s_ftb * ilbar[r] > ilj)
                      && !(s_ftb * iubar[r] > iuj)
                      && !(s_ftb * zlbar[r] > zlj)
                      && !(s_ftb * zubar[r] > zuj);
            logsum_l += finite_(loj) ? log_(ilj) : T(0);
            logsum_u += finite_(hij) ? log_(iuj) : T(0);
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const size_t r = s * NC + j;
            phi[j] = affine(phibar[r], gamma, psi[r], omega + r * NX, dx);
        }

        T cost;
        model::stage(x, u, t, theta, xn, c, cost);

        T th_stage = T(0), cphi = T(0);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const T c_rel = ((COMPL_MASK >> j) & 1) ? c[j] - mu : c[j];
            th_stage += abs_(c_rel);
            cphi += c_rel * phi[j];
            fin = fin && finite_(phi[j]) && finite_(c[j]);
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) fin = fin && finite_(xn[i]);
        th += th_stage;
        J += cost;
        L += cost + (cphi - mu * (logsum_l + logsum_u));
#pragma unroll
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }

    const T term = model::terminal(x, theta);
    th_out = th; J_out = J + term; L_out = L + term;
    fin_out = fin; ftb_out = ftb;
}

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
__global__ void __launch_bounds__(NT_METRICS)
forward_metrics_kernel(const FwdArgs a, const int B, const int Tn,
                       const int K) {
    // neighbouring threads are the K candidates of one instance
    const int idx = blockIdx.x * NT_METRICS + threadIdx.x;
    if (idx >= B * K) return;
    const int b = idx / K, k = idx - b * K;
    T th, L, J;
    bool fin, ftb;
    rollout_metrics<T>(a, b, Tn, ((const T*)a.gamma)[k], th, L, J, fin, ftb);
    ((T*)a.th)[idx] = th;
    ((T*)a.L)[idx] = L;
    ((T*)a.J)[idx] = J;
    a.finite[idx] = fin ? 1 : 0;
    a.ftb[idx] = ftb ? 1 : 0;
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

template <typename T>
static int launch_metrics(const void* const* ptrs, int B, int Tn, int K,
                          cudaStream_t stream) {
    if (B <= 0 || Tn <= 0 || K <= 0) return 0;
    const FwdArgs a = unpack(ptrs);
    const int blocks = (B * K + NT_METRICS - 1) / NT_METRICS;
    forward_metrics_kernel<T><<<blocks, NT_METRICS, 0, stream>>>(a, B, Tn, K);
    return (int)cudaGetLastError();
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
// (null is fine), and `theta` is null for a model without parameters.
int forward_metrics_f32(const void* const* ptrs, int B, int Tn, int K,
                        void* stream) {
    return launch_metrics<float>(ptrs, B, Tn, K, (cudaStream_t)stream);
}

int forward_metrics_f64(const void* const* ptrs, int B, int Tn, int K,
                        void* stream) {
    return launch_metrics<double>(ptrs, B, Tn, K, (cudaStream_t)stream);
}

int forward_trial_f32(const void* const* ptrs, int B, int Tn, void* stream) {
    return launch_trial<float>(ptrs, B, Tn, (cudaStream_t)stream);
}

int forward_trial_f64(const void* const* ptrs, int B, int Tn, void* stream) {
    return launch_trial<double>(ptrs, B, Tn, (cudaStream_t)stream);
}

// What this library was built for: (nx, nu, nc, theta width, compl mask).
int forward_dims(int* out) {
    out[0] = NX; out[1] = NU; out[2] = NC; out[3] = model::THETA_DIM;
    out[4] = COMPL_MASK;
    return 0;
}

}
