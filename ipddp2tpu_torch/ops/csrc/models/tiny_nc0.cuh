// Device functions of a two-state, three-control problem without equality
// constraints: the nc = 0 instantiation of the forward kernels, which the
// card run builds and holds against the same functions in Python
// (`chip_smoke.py::tiny_problem`).

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 2, NU_ = 3, NC_ = 0;
constexpr int THETA_DIM = 0;

template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T*, T* x_next, T*, T& cost) {
    x_next[0] = x[0] + T(0.1) * x[1] + T(0.05) * u[0]
                + T(0.01) * sin_(u[1]);
    x_next[1] = x[1] + T(0.1) * u[0] - T(0.02) * x[0] * u[2];
    cost = (x[0] * x[0] + x[1] * x[1])
           + T(0.1) * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
           + T(0.01) * x[0] * u[1] + T(0.001) * (u[0] * u[0] * u[0]);
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    return T(2.0) * (x[0] * x[0] + x[1] * x[1]) + T(0.1) * x[0] * x[1];
}

}  // namespace model
