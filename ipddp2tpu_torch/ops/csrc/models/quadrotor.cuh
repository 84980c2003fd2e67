// Device functions of the quadrotor (`models/quadrotor.py`), for one
// instance and one stage.
//
//   x = [p(3), rpy(3), v(3), w(3)], u = 4 rotor thrusts, no constraints
//   theta = goal (3)

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 12, NU_ = 4, NC_ = 0;
constexpr int THETA_DIM = 3;

template <typename T>
__device__ __forceinline__ void rates_(const T* x, const T* u, T* out) {
    const T mass = T(1.0), g = T(9.81), arm = T(0.2), kyaw = T(0.05);
    const T I[3] = {T(0.01), T(0.01), T(0.02)};
    const T* w = x + 9;
    const T cph = cos_(x[3]), sph = sin_(x[3]);
    const T cth = cos_(x[4]), sth = sin_(x[4]);
    const T cps = cos_(x[5]), sps = sin_(x[5]);
    const T thrust = ((u[0] + u[1]) + u[2]) + u[3];
    // body-z axis in the world frame (ZYX Euler)
    const T bz0 = cph * sth * cps + sph * sps;
    const T bz1 = cph * sth * sps - sph * cps;
    const T bz2 = cph * cth;
    // torques from the rotor layout (+ configuration)
    const T tau0 = arm * (u[1] - u[3]);
    const T tau1 = arm * (u[2] - u[0]);
    const T tau2 = kyaw * (u[0] - u[1] + u[2] - u[3]);
    const T Iw0 = I[0] * w[0], Iw1 = I[1] * w[1], Iw2 = I[2] * w[2];
    const T tth = tan_(x[4]);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = x[6 + i];        // p' = v
    out[3] = w[0] + sph * tth * w[1] + cph * tth * w[2];  // rpy' = E w
    out[4] = cph * w[1] - sph * w[2];
    out[5] = sph / cth * w[1] + cph / cth * w[2];
    out[6] = thrust / mass * bz0;                          // v'
    out[7] = thrust / mass * bz1;
    out[8] = thrust / mass * bz2 - g;
    out[9] = (tau0 - (w[1] * Iw2 - w[2] * Iw1)) / I[0];    // w'
    out[10] = (tau1 - (w[2] * Iw0 - w[0] * Iw2)) / I[1];
    out[11] = (tau2 - (w[0] * Iw1 - w[1] * Iw0)) / I[2];
}

// RK2 / explicit midpoint, dt = 0.05
template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T*, T* x_next, T*, T& cost) {
    const T dt = T(0.05);
    T k1[12], xm[12], k2[12];
    rates_(x, u, k1);
#pragma unroll
    for (int i = 0; i < 12; ++i) xm[i] = x[i] + T(0.5) * dt * k1[i];
    rates_(xm, u, k2);
#pragma unroll
    for (int i = 0; i < 12; ++i) x_next[i] = x[i] + dt * k2[i];
    // hover thrust mass * g / 4 per rotor
    const T hover = T(1.0 * 9.81 / 4.0);
    T du2 = T(0), w2 = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) du2 += (u[i] - hover) * (u[i] - hover);
#pragma unroll
    for (int i = 9; i < 12; ++i) w2 += x[i] * x[i];
    cost = dt * (T(0.1) * du2 + T(0.1) * w2);
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T* theta) {
    T dp2 = T(0), v2 = T(0), a2 = T(0), w2 = T(0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const T dp = x[i] - theta[i];
        dp2 += dp * dp;
        a2 += x[3 + i] * x[3 + i];
        v2 += x[6 + i] * x[6 + i];
        w2 += x[9 + i] * x[9 + i];
    }
    return T(200.0) * dp2 + T(50.0) * v2 + T(50.0) * a2 + T(50.0) * w2;
}

}  // namespace model
