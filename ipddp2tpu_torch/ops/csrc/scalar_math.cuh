// Scalar functions by type, for kernels templated on float / double.
//
// The kernels are built with plain IEEE arithmetic (no fast-math), and each
// type gets its own library function: sinf/cosf/logf for float, sin/cos/log
// for double. A float kernel must never widen to the double routine by
// overload resolution, so the names are spelled out here.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
template <typename T>
__device__ __forceinline__ bool finite_(T v) { return isfinite(v); }
