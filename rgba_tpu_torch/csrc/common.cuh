// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (nvcc -shared) and bound from Python with ctypes; every entry
// point returns cudaGetLastError() right after its launch, and the Python
// wrapper raises on a non-zero code.
#pragma once

#include <cmath>

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

}  // namespace rgba

extern "C" const char* rgba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
