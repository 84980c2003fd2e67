// Device functions of the constrained-car model (`models/concar.py`), for
// one instance and one stage. The Python functions stay the definition; the
// tests hold the kernels' plain versions, which call them, against the JAX
// package, and the card run holds these functions against the plain
// versions.
//
//   x = [px, py, heading, speed], u = [accel, steer, s-_1..4, s+_1..4]
//   theta = the [4, 3] obstacle rows (x, y, r), row-major

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 4, NU_ = 10, NC_ = 4;
constexpr int THETA_DIM = 12;
constexpr int NUM_OBSTACLES = 4;

// continuous-time unicycle
template <typename T>
__device__ __forceinline__ void g_(const T* x, const T* u, T* out) {
    out[0] = x[3] * cos_(x[2]);
    out[1] = x[3] * sin_(x[2]);
    out[2] = u[1];
    out[3] = u[0];
}

// RK2 / explicit midpoint, dt = 0.05
template <typename T>
__device__ __forceinline__ void dynamics(const T* x, const T* u, int,
                                         const T*, T* x_next) {
    const T dt = T(0.05);
    T k1[4], xm[4], k2[4];
    g_(x, u, k1);
#pragma unroll
    for (int i = 0; i < 4; ++i) xm[i] = x[i] + dt * T(0.5) * k1[i];
    g_(xm, u, k2);
#pragma unroll
    for (int i = 0; i < 4; ++i) x_next[i] = x[i] + dt * k2[i];
}

template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int t,
                                      const T* theta, T* x_next, T* c,
                                      T& cost) {
    dynamics(x, u, t, theta, x_next);
#ifdef CONCAR_QUADRATIC_SLACK_PENALTY
    // effort + quadratic penalty on the violation slacks (concar_quad)
    T s = T(0);
#pragma unroll
    for (int i = 0; i < NUM_OBSTACLES; ++i) s += u[2 + i] * u[2 + i];
    cost = T(0.05) * (T(5.0) * (u[0] * u[0]) + T(1.0) * (u[1] * u[1]))
           + T(1000.0) * s;
#else
    // effort + L1 penalty on the violation slacks
    T s = T(0);
#pragma unroll
    for (int i = 0; i < NUM_OBSTACLES; ++i) s += u[2 + i];
    cost = T(0.05) * (T(5.0) * (u[0] * u[0]) + T(1.0) * (u[1] * u[1]))
           + T(50.0) * s;
#endif
    // (r_obs + r_car)^2 - |xy - xy_obs|^2 - s- + s+
#pragma unroll
    for (int i = 0; i < NUM_OBSTACLES; ++i) {
        const T dx = x[0] - theta[3 * i], dy = x[1] - theta[3 * i + 1];
        const T r = theta[3 * i + 2] + T(0.02);
        c[i] = r * r - (dx * dx + dy * dy) - u[2 + i]
               + u[2 + NUM_OBSTACLES + i];
    }
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    // x_goal = (1, 1, pi/4, 0)
    const T d0 = x[0] - T(1.0), d1 = x[1] - T(1.0);
    const T d2 = x[2] - T(0.78539816339744830962), d3 = x[3];
    return T(200.0) * (d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3);
}

}  // namespace model
