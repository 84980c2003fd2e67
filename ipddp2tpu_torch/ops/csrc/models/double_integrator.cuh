// Device functions of the double integrator (`models/double_integrator.py`),
// for one instance and one stage.
//
//   x = [position, velocity], u = [force, s_plus, s_minus], no theta

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 2, NU_ = 3, NC_ = 1;
constexpr int THETA_DIM = 0;

template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T*, T* x_next, T* c, T& cost) {
    const T dt = T(0.01);
    x_next[0] = x[0] + dt * x[1];
    x_next[1] = x[1] + dt * u[0];
    cost = dt * (u[1] + u[2]);
    c[0] = u[1] - u[2] - u[0] * x[1];
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    const T d0 = x[0] - T(1.0), d1 = x[1];
    return T(500.0) * (d0 * d0 + d1 * d1);
}

}  // namespace model
