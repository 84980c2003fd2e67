// Device functions of the contact-implicit cartpole with joint friction
// (`models/cartpole.py`), for one instance and one stage.
//
//   x = [q-, q], u = [F, q+, beta1(2), beta2(2), eta1(2), eta2(2), psi(2),
//   s(2), sc(6)], 14 constraint rows; theta = (mc, mp, l, friction(2))

#pragma once

#include "../scalar_math.cuh"

namespace model {

constexpr int NX_ = 4, NU_ = 21, NC_ = 14;
constexpr int THETA_DIM = 5;

// M(q) v with M = [[mc + mp, mp l cos q2], [mp l cos q2, mp l^2]]
template <typename T>
__device__ __forceinline__ void mass_times_(const T* th, const T* q,
                                            const T* v, T* out) {
    const T mc = th[0], mp = th[1], l = th[2];
    const T c = mp * l * cos_(q[1]);
    out[0] = (mc + mp) * v[0] + c * v[1];
    out[1] = c * v[0] + (mp * (l * l)) * v[1];
}

// C(q, qd) qd - g(q)
template <typename T>
__device__ __forceinline__ void bias_(const T* th, const T* q, const T* qd,
                                      T* out) {
    const T mp = th[1], l = th[2];
    const T sq = sin_(q[1]);
    out[0] = -mp * qd[1] * l * sq * qd[1];
    out[1] = -(-mp * T(9.81) * l * sq);
}

template <typename T>
__device__ __forceinline__ void stage(const T* x, const T* u, int,
                                      const T* th, T* x_next, T* c,
                                      T& cost) {
    const T dt = T(0.05), g = T(9.81);
    x_next[0] = x[2];
    x_next[1] = x[3];
    x_next[2] = u[1];
    x_next[3] = u[2];
    T sc = T(0);
#pragma unroll
    for (int i = 15; i < 21; ++i) sc += u[i];
    cost = T(0.01) * dt * (u[0] * u[0]) + sc;

    const T* qp = x;
    const T* q = x + 2;
    const T* qn = u + 1;
    const T* beta1 = u + 3;
    const T* beta2 = u + 5;
    const T* eta1 = u + 7;
    const T* eta2 = u + 9;
    const T* psi = u + 11;
    const T* s = u + 13;
    const T* scv = u + 15;
    T qm_minus[2], qm_plus[2], qd_minus[2], qd_plus[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        qm_minus[i] = T(0.5) * (qp[i] + q[i]);
        qm_plus[i] = T(0.5) * (q[i] + qn[i]);
        qd_minus[i] = (q[i] - qp[i]) / dt;
        qd_plus[i] = (qn[i] - q[i]) / dt;
    }
    T mpl[2], mmi[2], bp[2], bm[2];
    mass_times_(th, qm_plus, qd_plus, mpl);
    mass_times_(th, qm_minus, qd_minus, mmi);
    bias_(th, qm_plus, qd_plus, bp);
    bias_(th, qm_minus, qd_minus, bm);
    const T lam[2] = {beta1[0] - beta1[1], beta2[0] - beta2[1]};
    const T b_force[2] = {u[0], T(0)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const T c_mid = T(0.5) * (bp[i] + bm[i]);
        c[i] = (mpl[i] - mmi[i]) + dt * (c_mid - b_force[i] - lam[i]);
    }
    c[2] = qd_plus[0] + psi[0] - eta1[0];
    c[3] = -qd_plus[0] + psi[0] - eta1[1];
    c[4] = qd_plus[1] + psi[1] - eta2[0];
    c[5] = -qd_plus[1] + psi[1] - eta2[1];
    const T gamma1 = th[3] * (th[1] + th[0]) * g;
    const T gamma2 = th[4] * th[1] * g * th[2];
    c[6] = gamma1 - (beta1[0] + beta1[1]) - s[0];
    c[7] = gamma2 - (beta2[0] + beta2[1]) - s[1];
    c[8] = psi[0] * s[0] - scv[0];
    c[9] = psi[1] * s[1] - scv[1];
    c[10] = beta1[0] * eta1[0] - scv[2];
    c[11] = beta1[1] * eta1[1] - scv[3];
    c[12] = beta2[0] * eta2[0] - scv[4];
    c[13] = beta2[1] * eta2[1] - scv[5];
}

template <typename T>
__device__ __forceinline__ T terminal(const T* x, const T*) {
    // 200 |qd|^2 + 700 |q - (0, pi)|^2, qd = (q - q-) / dt
    const T dt = T(0.05);
    const T qd0 = (x[2] - x[0]) / dt, qd1 = (x[3] - x[1]) / dt;
    const T d0 = x[2], d1 = x[3] - T(3.14159265358979323846);
    return T(200.0) * (qd0 * qd0 + qd1 * qd1)
           + T(700.0) * (d0 * d0 + d1 * d1);
}

}  // namespace model
