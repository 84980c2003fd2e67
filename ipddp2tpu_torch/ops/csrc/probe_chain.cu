// Two probes of the card's arithmetic over T dependent steps.
//
// They replace the two probe kernels of scripts/tpu_dd_probe.py, which asked
// whether double-single arithmetic holds over a 100-step recursion inside a
// TPU kernel. On this card the working types are native, and the question is
// the same: does a chain of T dependent steps inside one kernel land where
// the same chain does in plain PyTorch?
//   mul_chain_{f32,f64}       <- kern_mul (tpu_dd_probe.py:49): x <- x * c,
//       T times, one thread per element.
//   dynamics_chain_{f32,f64}  <- kern_dyn (tpu_dd_probe.py:98): T steps of
//       the concar dynamics (the device function the forward kernels use)
//       from x0 [B, 4] under controls [B, T, 10], one thread per instance;
//       writes x_T.
// Both are chains of dependent operations on a handful of values: bound by
// latency, far above their byte bound (the controls read once). Plain
// versions: `mul_chain_plain`, `dynamics_chain_plain` in ops/probe_chain.py.
// Plain IEEE arithmetic, no fast-math.

#include <cuda_runtime.h>

#include "models/concar.cuh"

constexpr int NT = 128;

template <typename T>
__global__ void mul_chain_kernel(const T* __restrict__ x0, T* __restrict__ out,
                                 const int n, const int steps, const T c) {
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= n) return;
    T x = x0[i];
    for (int t = 0; t < steps; ++t) x = x * c;
    out[i] = x;
}

template <typename T>
__global__ void dynamics_chain_kernel(const T* __restrict__ x0,
                                      const T* __restrict__ u,
                                      T* __restrict__ out, const int B,
                                      const int steps) {
    const int b = blockIdx.x * NT + threadIdx.x;
    if (b >= B) return;
    T x[model::NX_], xn[model::NX_], ut[model::NU_];
#pragma unroll
    for (int i = 0; i < model::NX_; ++i) x[i] = x0[b * model::NX_ + i];
    for (int t = 0; t < steps; ++t) {
        const T* ub = u + ((size_t)b * steps + t) * model::NU_;
#pragma unroll
        for (int j = 0; j < model::NU_; ++j) ut[j] = ub[j];
        model::dynamics(x, ut, t, (const T*)nullptr, xn);
#pragma unroll
        for (int i = 0; i < model::NX_; ++i) x[i] = xn[i];
    }
#pragma unroll
    for (int i = 0; i < model::NX_; ++i) out[b * model::NX_ + i] = x[i];
}

template <typename T>
static int launch_mul(const void* x0, void* out, int n, int steps, double c,
                      cudaStream_t stream) {
    if (n <= 0) return 0;
    mul_chain_kernel<T><<<(n + NT - 1) / NT, NT, 0, stream>>>(
        (const T*)x0, (T*)out, n, steps, (T)c);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_dyn(const void* x0, const void* u, void* out, int B,
                      int steps, cudaStream_t stream) {
    if (B <= 0) return 0;
    dynamics_chain_kernel<T><<<(B + NT - 1) / NT, NT, 0, stream>>>(
        (const T*)x0, (const T*)u, (T*)out, B, steps);
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
                       int steps, void* stream) {
    return launch_dyn<float>(x0, u, out, B, steps, (cudaStream_t)stream);
}

int dynamics_chain_f64(const void* x0, const void* u, void* out, int B,
                       int steps, void* stream) {
    return launch_dyn<double>(x0, u, out, B, steps, (cudaStream_t)stream);
}

}
