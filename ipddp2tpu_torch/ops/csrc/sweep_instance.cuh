// What the Bunch-Kaufman sweep (backward_sweep_bk.cuh) and the wide LDL^T
// sweep (backward_sweep_wide.cuh) share: G = 32 * WPI threads, whole warps,
// own one instance; the barrier that closes a phase of the instance, and
// the arg-max and the sum over its threads. Included by backward_sweep.cu
// after G, M and FULL.

#pragma once

#include <limits.h>
#include <type_traits>

constexpr int NW = G / 32;       // warps an instance
// row stride of an m x m matrix in shared memory: odd, so that the threads
// that read a column (row i on thread i) fall on distinct banks, in float
// and in double (an even stride put every lane of a warp on one bank pair
// at m = 15)
constexpr int AP = M | 1;

// every thread of the instance has reached this point and sees what the
// others wrote to shared memory before it: `__syncwarp` for a warp, a named
// barrier of the instance's G threads (id 1 + the instance's slot in the
// block; 0 is `__syncthreads`) for more
__device__ __forceinline__ void inst_sync(const int grp) {
    if constexpr (NW == 1) {
        __syncwarp();
    } else {
        asm volatile("bar.sync %0, %1;\n" :: "r"(grp + 1), "n"(G)
                     : "memory");
    }
}

// Arg-max keys. For a >= 0 the IEEE bits order like unsigned integers, so
// the key of |v| is its bits + 1; a NaN takes the largest key and an entry
// that does not take part (`live` false) the key 0, below every number
// (0 included). The arg-max is then an unsigned max, the lowest index on
// ties: jnp.argmax's rule with NaN first (the lowest index between NaNs)
// and the excluded entries as -inf.
template <typename T>
using Key = std::conditional_t<sizeof(T) == 8, unsigned long long, unsigned>;

__device__ __forceinline__ unsigned long long order_key(const double a,
                                                        const bool live) {
    return !live ? 0ull
        : (a != a) ? ~0ull
        : (unsigned long long)__double_as_longlong(a) + 1ull;
}
__device__ __forceinline__ unsigned order_key(const float a,
                                              const bool live) {
    return !live ? 0u : (a != a) ? ~0u : __float_as_uint(a) + 1u;
}

// the value of a key: `masked` for 0, NaN for the largest
__device__ __forceinline__ double key_value(const unsigned long long k,
                                            const double masked) {
    return k == 0ull ? masked
        : (k == ~0ull) ? __longlong_as_double(0x7ff8000000000000ll)
        : __longlong_as_double((long long)(k - 1ull));
}
__device__ __forceinline__ float key_value(const unsigned k,
                                           const float masked) {
    return k == 0u ? masked
        : (k == ~0u) ? __uint_as_float(0x7fc00000u) : __uint_as_float(k - 1u);
}

// (key, idx) before (best, bi): the larger key, the lower index on ties
template <typename K>
__device__ __forceinline__ bool key_before(const K key, const int idx,
                                           const K best, const int bi) {
    return key > best || (key == best && idx < bi);
}

// arg-max over the warp: the warp's integer reductions on the key's words,
// then the lowest index among the lanes that hold the largest key
__device__ __forceinline__ void warp_argmax(unsigned long long& key,
                                            int& idx) {
    const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
    const unsigned hm = __reduce_max_sync(FULL, hi);
    const unsigned lm = __reduce_max_sync(FULL, hi == hm ? lo : 0u);
    const bool win = hi == hm && lo == lm;
    idx = (int)__reduce_min_sync(FULL, win ? (unsigned)idx : (unsigned)INT_MAX);
    key = ((unsigned long long)hm << 32) | lm;
}
__device__ __forceinline__ void warp_argmax(unsigned& key, int& idx) {
    const unsigned km = __reduce_max_sync(FULL, key);
    idx = (int)__reduce_min_sync(FULL, key == km ? (unsigned)idx
                                                 : (unsigned)INT_MAX);
    key = km;
}

// Arg-max over the instance; every thread ends with the same pair. Above
// one warp the warps' winners meet in shared memory `red` ([2][2 NW], two
// buffers used in turns: a buffer is written again only after the barrier
// of the next reduction, when every thread has read it).
template <typename K>
__device__ __forceinline__ void inst_argmax(K& key, int& idx,
                                            unsigned long long* red,
                                            int& buf, const int grp) {
    warp_argmax(key, idx);
    if constexpr (NW > 1) {
        unsigned long long* rb = red + buf * 2 * NW;
        const int w = (threadIdx.x % G) / 32;
        if ((threadIdx.x & 31) == 0) {
            rb[w] = key;
            rb[NW + w] = (unsigned long long)idx;
        }
        inst_sync(grp);
        key = (K)rb[0];
        idx = (int)rb[NW];
#pragma unroll
        for (int v = 1; v < NW; ++v) {
            const K kv = (K)rb[v];
            const int iv = (int)rb[NW + v];
            if (key_before(kv, iv, key, idx)) {
                key = kv;
                idx = iv;
            }
        }
        buf ^= 1;
    }
}

// sum of an integer over the instance, the same buffers
__device__ __forceinline__ int inst_add(int v, unsigned long long* red,
                                        int& buf, const int grp) {
    v = __reduce_add_sync(FULL, v);
    if constexpr (NW > 1) {
        unsigned long long* rb = red + buf * 2 * NW;
        if ((threadIdx.x & 31) == 0)
            rb[(threadIdx.x % G) / 32] = (unsigned long long)(unsigned)v;
        inst_sync(grp);
        v = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) v += (int)(unsigned)rb[w];
        buf ^= 1;
    }
    return v;
}

// values of T that the reduction buffers take in an instance's shared
// memory (none for one warp)
template <typename T>
constexpr int red_values() {
    return NW > 1 ? 4 * NW * (int)(sizeof(unsigned long long) / sizeof(T))
                  : 0;
}

// sum over the warp, every lane ends with it
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// sum over the instance, the same buffers (the warps' sums in the order of
// the warps)
template <typename T>
__device__ __forceinline__ T inst_sum(T v, unsigned long long* red, int& buf,
                                      const int grp) {
    v = warp_sum(v);
    if constexpr (NW > 1) {
        T* rb = reinterpret_cast<T*>(red + buf * 2 * NW);
        if ((threadIdx.x & 31) == 0) rb[(threadIdx.x % G) / 32] = v;
        inst_sync(grp);
        v = rb[0];
#pragma unroll
        for (int w = 1; w < NW; ++w) v += rb[w];
        buf ^= 1;
    }
    return v;
}

// An entry of a block update: where it goes and its new value.
template <typename T>
struct Upd {
    T* at;
    T v;
};

// The entries q = r, r + G, .. of an R x R block (R >= 0), as (i, j) =
// (q / R, q % R), four at a time: `entry(i, j)` reads and computes all four
// (an `Upd`) before they are stored, so that their shared-memory reads are
// in flight together. Each entry is read and written by one thread.
template <typename F>
__device__ __forceinline__ void trailing_update(const int R, const int r,
                                                F entry) {
    constexpr int CH = 4;
    const int RR = R * R;
    if (r >= RR) return;
    int i = r / R, j = r - i * R;
    const int di = G / R, dj = G - di * R;
#pragma unroll 1
    for (int q0 = r; q0 < RR; q0 += CH * G) {
        decltype(entry(0, 0)) e[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
            if (q0 + u * G < RR) e[u] = entry(i, j);
            i += di;
            j += dj;
            if (j >= R) {
                j -= R;
                ++i;
            }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u)
            if (q0 + u * G < RR) *e[u].at = e[u].v;
    }
}

// The entries q = r, r + G, .. of a flat range of n, four at a time as
// `trailing_update` takes them.
template <typename F>
__device__ __forceinline__ void chunked_update(const int n, const int r,
                                               F entry) {
    constexpr int CH = 4;
#pragma unroll 1
    for (int q0 = r; q0 < n; q0 += CH * G) {
        decltype(entry(0)) e[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u)
            if (q0 + u * G < n) e[u] = entry(q0 + u * G);
#pragma unroll
        for (int u = 0; u < CH; ++u)
            if (q0 + u * G < n) *e[u].at = e[u].v;
    }
}
