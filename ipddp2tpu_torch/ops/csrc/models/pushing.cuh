// Device functions of planar pushing with one obstacle (`models/pushing.py`),
// for one instance and one stage.
//
//   x = [px, py, theta, phi], u = [fn, ft, vphi+, vphi-, g+, g-, sc1, sc2,
//   qphi, so+, so-], 6 constraint rows
//   theta = (zx, zy, c, mu_fric, obstacle x, y, r)

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 4, NU_ = 11, NC_ = 6;
constexpr int THETA_DIM = 7;

template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T* th, T* x_next, T* c,
                                      T& cost) {
    const T dt = T(0.04), r_push = T(0.01);
    const T zx = th[0], zy = th[1], cc = th[2], mu = th[3];
    // ellipsoidal limit surface, forward Euler
    const T s2 = zx / T(2) * (tan_(x[3]) * u[0] - u[1]) / (cc * cc);
    const T ct = cos_(x[2]), st = sin_(x[2]);
    x_next[0] = x[0] + dt * (ct * u[0] - st * u[1]);
    x_next[1] = x[1] + dt * (st * u[0] + ct * u[1]);
    x_next[2] = x[2] + dt * s2;
    x_next[3] = x[3] + dt * (u[2] - u[3]);
    cost = T(1e-2) * (u[0] * u[0] + u[1] * u[1])
           + T(2.0) * (u[6] + u[7]) + T(2.0) * u[10];
    const T r_total = (zx > zy ? zx : zy) + r_push;
    const T dx = x[0] - th[4], dy = x[1] - th[5];
    const T ro = th[6] + r_total;
    c[0] = mu * u[0] - u[1] - u[4];
    c[1] = mu * u[0] + u[1] - u[5];
    c[2] = u[4] * u[2] - u[6];
    c[3] = u[5] * u[3] - u[7];
    c[4] = x[3] - u[8];
    c[5] = ro * ro - (dx * dx + dy * dy) + u[9] - u[10];
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    // 20 |x - (0.3, 0.4, 1.5 pi, 0)|^2
    const T d0 = x[0] - T(0.3), d1 = x[1] - T(0.4);
    const T d2 = x[2] - T(4.71238898038468985769), d3 = x[3];
    return T(20.0) * (d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3);
}

}  // namespace model
