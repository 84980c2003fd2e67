// Device functions of the acrobot with elbow joint-limit contact
// (`models/acrobot.py`), for one instance and one stage.
//
//   x = [q-, q], u = [tau, q+, lam(2), s(2), sc(2)], 6 constraint rows
//   theta = (m1, l1, m2, l2); I1 = I2 = 0.333, lc1 = lc2 = 0.5 fixed

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 4, NU_ = 9, NC_ = 6;
constexpr int THETA_DIM = 4;

// M(q) v with M = [[a, b], [b, I2]]
template <typename T>
__device__ __forceinline__ void mass_times_(const T* th, const T* q,
                                            const T* v, T* out) {
    const T I1 = T(0.333), I2 = T(0.333), lc2 = T(0.5);
    const T m2 = th[2], l1 = th[1];
    const T cq = cos_(q[1]);
    const T a = I1 + I2 + m2 * (l1 * l1) + T(2.0) * m2 * l1 * lc2 * cq;
    const T b = I2 + m2 * l1 * lc2 * cq;
    out[0] = a * v[0] + b * v[1];
    out[1] = b * v[0] + I2 * v[1];
}

// C~(q, qd) qd - tau_g(q)
template <typename T>
__device__ __forceinline__ void bias_(const T* th, const T* q, const T* qd,
                                      T* out) {
    const T g = T(9.81), lc1 = T(0.5), lc2 = T(0.5);
    const T m1 = th[0], l1 = th[1], m2 = th[2];
    const T h = m2 * l1 * lc2 * sin_(q[1]);
    const T cor0 = T(-2.0) * h * qd[1] * qd[0] - h * qd[1] * qd[1];
    const T cor1 = h * qd[0] * qd[0];
    const T s01 = sin_(q[0] + q[1]);
    const T g1 = -m1 * g * lc1 * sin_(q[0])
                 - m2 * g * (l1 * sin_(q[0]) + lc2 * s01);
    const T g2 = -m2 * g * lc2 * s01;
    out[0] = cor0 - g1;
    out[1] = cor1 - g2;
}

template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T* th, T* x_next, T* c,
                                      T& cost) {
    const T dt = T(0.05);
    // trivial shift
    x_next[0] = x[2];
    x_next[1] = x[3];
    x_next[2] = u[1];
    x_next[3] = u[2];
    cost = T(0.01) * dt * (u[0] * u[0]) + T(2.0) * (u[7] + u[8]);
    // variational midpoint residual with joint damping 0.5 qd+
    const T* qp = x;
    const T* q = x + 2;
    const T* qn = u + 1;
    T qm_minus[2], qm_plus[2], qd_minus[2], qd_plus[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        qm_minus[i] = T(0.5) * (qp[i] + q[i]);
        qm_plus[i] = T(0.5) * (q[i] + qn[i]);
        qd_minus[i] = (q[i] - qp[i]) / dt;
        qd_plus[i] = (qn[i] - q[i]) / dt;
    }
    T mp[2], mm[2], bp[2], bm[2];
    mass_times_(th, qm_plus, qd_plus, mp);
    mass_times_(th, qm_minus, qd_minus, mm);
    bias_(th, qm_plus, qd_plus, bp);
    bias_(th, qm_minus, qd_minus, bm);
    const T b_tau[2] = {T(0), u[0]};
    const T p_lam[2] = {T(0), u[4] - u[3]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const T c_mid = T(0.5) * (bp[i] + bm[i]);
        c[i] = (mp[i] - mm[i])
               + dt * (c_mid - b_tau[i] - p_lam[i] + T(0.5) * qd_plus[i]);
    }
    // gap s - phi(q+), phi = (pi/2 - q+_2, q+_2 + pi/2)
    const T half_pi = T(1.57079632679489661923);
    c[2] = u[5] - (half_pi - qn[1]);
    c[3] = u[6] - (qn[1] + half_pi);
    // complementarity lam . s = sc
    c[4] = u[3] * u[5] - u[7];
    c[5] = u[4] * u[6] - u[8];
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    // 200 |qd|^2 + 700 |q - (pi, 0)|^2, qd = (q - q-) / dt
    const T dt = T(0.05);
    const T qd0 = (x[2] - x[0]) / dt, qd1 = (x[3] - x[1]) / dt;
    const T d0 = x[2] - T(3.14159265358979323846), d1 = x[3];
    return T(200.0) * (qd0 * qd0 + qd1 * qd1)
           + T(700.0) * (d0 * d0 + d1 * d1);
}

}  // namespace model
