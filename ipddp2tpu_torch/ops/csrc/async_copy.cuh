// Asynchronous copies from device memory into shared memory (`cp.async`,
// sm_80 and later), for kernels that bring a stage's inputs in one stage
// ahead of their use: the backward sweep and the forward-metrics kernel.
//
// A piece of 16, 8 or 4 bytes needs its source and its target aligned to
// its size. The kernels pick the piece from the run's length and its place
// in the buffer at compile time; the wrappers hand them tensors whose bases
// are 16-byte aligned.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_but_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
