// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (nvcc -shared) and bound from Python with ctypes; every entry
// point returns cudaGetLastError() right after its launch, and the Python
// wrapper raises on a non-zero code.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rgba {

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Round an fp32 value to T's precision and back: the point where the
// reference casts an fp32-accumulated result to the activation dtype.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

// D += A * B on the tensor cores, one m16n8k16 tile: bf16 in, fp32
// accumulate.  a: the A fragment (4 x 2 bf16), b0 / b1: the B fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive bf16 as one 32-bit fragment register (4-byte aligned).
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace rgba

extern "C" const char* rgba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
