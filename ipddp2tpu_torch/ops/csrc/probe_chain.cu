// Two probes of the card's arithmetic over T dependent steps.
//
// They replace the two probe kernels of scripts/tpu_dd_probe.py, which asked
// whether double-single arithmetic holds over a 100-step recursion inside a
// TPU kernel. On this card the working types are native, and the question is
// the same: does a chain of T dependent steps inside one kernel land where
// the same chain does in plain PyTorch?
//
//   mul_chain_{f32,f64}       <- kern_mul (tpu_dd_probe.py:49): x <- x * c,
//       T times, one thread per element. A chain of T dependent multiplies:
//       bound by the multiply's latency per step, plus the launch.
//   dynamics_chain_{f32,f64}  <- kern_dyn (tpu_dd_probe.py:98): T steps of
//       the concar dynamics (`model::dynamics`, the device function the
//       forward kernels run T times a lane) from x0 [B, 4] under controls
//       [B, T, 10]; writes x_T.
//
// The dynamics chain. Its byte bound is the controls read once. The first
// design (one thread an instance, 128 threads a block) loaded a step's
// controls from device memory inside the step loop: every step waited one
// load round trip before its arithmetic could start, neighbouring threads
// read 80*T bytes apart, and B = 2048 gave 16 blocks, so 16 of the 132 SMs
// streamed the controls.
//
// This design takes the controls off the chain. A block owns
// `blockDim.x` instances (one thread each; `chain_geometry` in
// ops/probe_chain.py picks 16, so B = 2048 spreads over 128 SMs). Each
// instance's controls u[b, :, :] are one contiguous row, brought into shared
// memory a window of `window` steps at a time by a TMA bulk copy
// (`cp.async.bulk`, global -> shared), its completion counted on the slot's
// `mbarrier` by bytes. The ring has two slots: a thread waits on a window's
// barrier once, then issues the next window's copy into the other slot
// (whose previous window it has finished) and steps through this one while
// that copy runs. Inside a window the next step's controls are read from
// shared memory one step ahead. No device-memory load is left inside the
// step loop.
//
// The bulk copy wants its source, its target and its size in multiples of
// 16 bytes. A row's window of W steps is 80 W bytes in double and 40 W in
// float: `chain_geometry` takes W = 20 (even, so a float window is a
// multiple of 16), and pads a float row of odd T by a step in the wrapper
// (`row_steps`), so that every row starts on 16 bytes and the last window's
// copy, rounded up into the pad, stays a multiple of 16. The wrapper hands a
// base aligned to 16 bytes. The launcher checks all of this and refuses a
// geometry that breaks it.
//
// The arithmetic is the first design's: `model::dynamics` from
// models/concar.cuh, the same operations in the same order, plain IEEE (no
// fast-math), so x_T equals the first design's bit for bit. Only the path of
// the controls and the launch geometry changed. What is left is the chain
// itself: a step's sine and cosine of the midpoint heading, issued by one
// warp on its SM's sub-partition, one step after another.
//
// Plain versions: `mul_chain_plain`, `dynamics_chain_plain` in
// ops/probe_chain.py. `empty_launch` launches a kernel that does nothing, at
// any geometry: the card's floor for one launch, timed beside the probes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "models/concar.cuh"

constexpr int NT = 128;      // threads a block of the multiply chain
constexpr int SLOTS = 2;     // windows a block of the dynamics chain holds

template <typename T>
__global__ void mul_chain_kernel(const T* __restrict__ x0, T* __restrict__ out,
                                 const int n, const int steps, const T c) {
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= n) return;
    T x = x0[i];
    for (int t = 0; t < steps; ++t) x = x * c;
    out[i] = x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the barriers' initialization visible to the copies (the async proxy)
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n"
                 "fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's reads of shared memory ordered before its next bulk copy
// into the same place
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// arrive, and add `bytes` to what the barrier's phase waits for
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16) from device memory to shared
// memory, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

template <typename T>
__global__ void dynamics_chain_kernel(const T* __restrict__ x0,
                                      const T* __restrict__ u,
                                      T* __restrict__ out, const int B,
                                      const int steps, const int row_steps,
                                      const int window) {
    constexpr int NX = model::NX_, NU = model::NU_;
    extern __shared__ __align__(16) unsigned char ring_bytes[];
    __shared__ __align__(8) uint64_t full[SLOTS];
    // slot s, instance i: ring[(s * blockDim.x + i) * span ...], one row's
    // window of `window` steps
    T* ring = reinterpret_cast<T*>(ring_bytes);
    const int lane = threadIdx.x, ipb = blockDim.x;
    const int b = blockIdx.x * ipb + lane;
    const bool live = b < B;
    const int span = window * NU;
    const int windows = (steps + window - 1) / window;
    if (lane == 0) {
        for (int s = 0; s < SLOTS; ++s) mbar_init(&full[s], ipb);
        fence_barrier_init();
    }
    __syncthreads();
    const T* row = u + (size_t)b * row_steps * NU;
    // every thread arrives once on the slot's barrier for each window,
    // announcing the bytes of its own row's copy (none past B)
    auto fetch = [&](int w) {
        uint64_t* bar = &full[w % SLOTS];
        if (!live) {
            mbar_arrive(bar);
            return;
        }
        const int t0 = w * window;
        const uint32_t bytes =
            (uint32_t)(min(window, row_steps - t0) * NU * sizeof(T));
        mbar_arrive_expect(bar, bytes);
        bulk_copy(ring + ((size_t)(w % SLOTS) * ipb + lane) * span,
                  row + (size_t)t0 * NU, bytes, bar);
    };
    T x[NX], xn[NX], ut[NU], un[NU];
    if (windows > 0) fetch(0);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = live ? x0[(size_t)b * NX + i] : T(0);
    for (int w = 0; w < windows; ++w) {
        mbar_wait(&full[w % SLOTS], (uint32_t)((w / SLOTS) & 1));
        if (w + 1 < windows) {
            fence_proxy_async();
            fetch(w + 1);
        }
        if (!live) continue;
        const T* us = ring + ((size_t)(w % SLOTS) * ipb + lane) * span;
        const int t0 = w * window, n = min(window, steps - t0);
#pragma unroll
        for (int j = 0; j < NU; ++j) ut[j] = us[j];
#pragma unroll 1
        for (int k = 0; k < n; ++k) {
            const T* next = us + min(k + 1, n - 1) * NU;
#pragma unroll
            for (int j = 0; j < NU; ++j) un[j] = next[j];
            model::dynamics(x, ut, t0 + k, (const T*)nullptr, xn);
#pragma unroll
            for (int i = 0; i < NX; ++i) x[i] = xn[i];
#pragma unroll
            for (int j = 0; j < NU; ++j) ut[j] = un[j];
        }
    }
    if (live) {
#pragma unroll
        for (int i = 0; i < NX; ++i) out[(size_t)b * NX + i] = x[i];
    }
}

__global__ void empty_kernel() {}

template <typename T>
static int launch_mul(const void* x0, void* out, int n, int steps, double c,
                      cudaStream_t stream) {
    if (n <= 0) return 0;
    mul_chain_kernel<T><<<(n + NT - 1) / NT, NT, 0, stream>>>(
        (const T*)x0, (T*)out, n, steps, (T)c);
    return (int)cudaGetLastError();
}

static int allow_smem(const void* kernel, int bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The geometry is the wrapper's (`chain_geometry`); refused unless the bulk
// copies' 16-byte rule holds for every row and window and the shared memory
// is the ring's.
template <typename T>
static int launch_dyn(const void* x0, const void* u, void* out, int B,
                      int steps, int row_steps, int ipb, int window,
                      int smem_bytes, cudaStream_t stream) {
    if (B <= 0) return 0;
    const long row_bytes = (long)row_steps * model::NU_ * sizeof(T);
    const long window_bytes = (long)window * model::NU_ * sizeof(T);
    if (steps < 0 || row_steps < steps || ipb <= 0 || ipb > 1024 ||
        window <= 0 || row_bytes % 16 || window_bytes % 16 ||
        (steps > 0 && (uintptr_t)u % 16) ||
        (long)smem_bytes != SLOTS * ipb * window_bytes)
        return (int)cudaErrorInvalidValue;
    const int err = allow_smem((const void*)dynamics_chain_kernel<T>,
                               smem_bytes);
    if (err) return err;
    dynamics_chain_kernel<T><<<(B + ipb - 1) / ipb, ipb, smem_bytes,
                               stream>>>(
        (const T*)x0, (const T*)u, (T*)out, B, steps, row_steps, window);
    return (int)cudaGetLastError();
}

extern "C" {

// Each returns the CUDA error code of the launch (0 = launched).
int mul_chain_f32(const void* x0, void* out, int n, int steps, double c,
                  void* stream) {
    return launch_mul<float>(x0, out, n, steps, c, (cudaStream_t)stream);
}

int mul_chain_f64(const void* x0, void* out, int n, int steps, double c,
                  void* stream) {
    return launch_mul<double>(x0, out, n, steps, c, (cudaStream_t)stream);
}

int dynamics_chain_f32(const void* x0, const void* u, void* out, int B,
                       int steps, int row_steps, int ipb, int window,
                       int smem_bytes, void* stream) {
    return launch_dyn<float>(x0, u, out, B, steps, row_steps, ipb, window,
                             smem_bytes, (cudaStream_t)stream);
}

int dynamics_chain_f64(const void* x0, const void* u, void* out, int B,
                       int steps, int row_steps, int ipb, int window,
                       int smem_bytes, void* stream) {
    return launch_dyn<double>(x0, u, out, B, steps, row_steps, ipb, window,
                              smem_bytes, (cudaStream_t)stream);
}

int empty_launch(int blocks, int threads, int smem_bytes, void* stream) {
    if (blocks <= 0) return 0;
    const int err = allow_smem((const void*)empty_kernel, smem_bytes);
    if (err) return err;
    empty_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}
