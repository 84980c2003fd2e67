// Device functions of the cartpole swing-up (`models/cartpole_swingup.py`),
// for one instance and one stage.
//
//   x = [p, theta, pdot, thetadot], u = [force], no constraints, no theta

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 4, NU_ = 1, NC_ = 0;
constexpr int THETA_DIM = 0;

template <typename T>
__device__ __forceinline__ void accel_(const T* x, const T* u, T* out) {
    const T mc = T(1.0), mp = T(0.2), l = T(0.5), g = T(9.81);
    const T s = sin_(x[1]), c = cos_(x[1]);
    const T thdot = x[3], f = u[0];
    const T denom = mc + mp * (s * s);
    out[0] = x[2];
    out[1] = thdot;
    out[2] = (f + mp * s * (l * (thdot * thdot) + g * c)) / denom;
    out[3] = (-f * c - T(0.2 * 0.5) * (thdot * thdot) * c * s
              - (mc + mp) * g * s) / (l * denom);
}

// RK2 / explicit midpoint, dt = 0.05
template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T*, T* x_next, T*, T& cost) {
    const T dt = T(0.05);
    T k1[4], xm[4], k2[4];
    accel_(x, u, k1);
#pragma unroll
    for (int i = 0; i < 4; ++i) xm[i] = x[i] + T(0.5) * dt * k1[i];
    accel_(xm, u, k2);
#pragma unroll
    for (int i = 0; i < 4; ++i) x_next[i] = x[i] + dt * k2[i];
    cost = dt * (T(0.01) * (u[0] * u[0]) + T(0.1) * (x[0] * x[0]));
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    // goal (0, pi, 0, 0)
    const T d1 = x[1] - T(3.14159265358979323846);
    return T(500.0) * (x[0] * x[0] + d1 * d1 + x[2] * x[2] + x[3] * x[3]);
}

}  // namespace model
