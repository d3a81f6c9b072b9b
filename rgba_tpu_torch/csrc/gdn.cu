// Fused GDN / IGDN over (M, C) rows: y = x * rsqrt(x^2 @ gamma_t + beta),
// or * sqrt for the inverse form.
//
// Replaces rgba_tpu/ops/pallas/gdn.py::fused_gdn (body :31-37, call :58).
// gamma_t and beta arrive post-reparameterization (the lower_bound and the
// 2^-36 pedestal stay in PyTorch, as in rgba_tpu/ops/gdn.py:47-49).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// outside the tensor cores): at the largest main-path site (batch 16,
// 512x768 image, H/2: M = 1,572,864 rows, C = 192) the kernel must read x
// once and write y once, 1.2 GB in bf16 (0.36 ms), and do 2*M*C*C = 116
// GFLOP (0.12 ms on bf16 tensor cores): in bf16 it is bound by bytes.  In
// fp32 without TF32 the same work is 1.7 ms at the fp32 peak: bound by
// operations.
//
// Design: one block of 256 threads takes a tile of 64 rows.  It squares the
// rows into shared memory (fp32, rounded to the activation dtype first, as
// the reference squares in that dtype), then walks gamma_t in K-tiles of 32
// rows (the whole 192x192 fp32 gamma_t would take 147 KB).  Each thread
// keeps a 4-row x 12-column register tile, so 16 shared loads feed 48
// FMAs; the epilogue adds beta, takes the rsqrt (sqrt) in fp32, and scales
// x, re-read from global memory where it is still in L2.  x and y cross
// device memory once each, which is the bytes bound; the products run on
// the fp32 CUDA cores, so in bf16 this first version is bound by its
// FMA rate, far above the tensor-core bound (wgmma is later work).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // rows per block
constexpr int kK = 32;         // gamma_t rows per K-tile
constexpr int kColGroups = 12; // columns per thread: C <= 16 * 12 = 192

template <typename T>
__global__ void __launch_bounds__(kThreads)
gdn_kernel(const T* __restrict__ x, const T* __restrict__ gamma_t,
           const float* __restrict__ beta, T* __restrict__ y, long long m,
           int c, int inverse) {
  extern __shared__ float smem[];
  const int ldx = c + 1;            // +1 pad: rows ty and ty+1 hit different banks
  float* x2s = smem;                // kRows x ldx
  float* gs = smem + kRows * ldx;   // kK x c

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int ncg = c / 16;

  for (int i = threadIdx.x; i < kRows * c; i += kThreads) {
    const int r = i / c, col = i - r * c;
    const long long row = row0 + r;
    const float v = row < m ? rgba::to_float(x[row * c + col]) : 0.f;
    x2s[r * ldx + col] = rgba::round_to<T>(v * v);
  }

  float acc[4][kColGroups];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) acc[r][g] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kK) {
    const int kt = min(kK, c - k0);
    __syncthreads();  // x2s written; previous K-tile consumed
    for (int i = threadIdx.x; i < kt * c; i += kThreads)
      gs[i] = rgba::to_float(gamma_t[static_cast<long long>(k0) * c + i]);
    __syncthreads();
    for (int k = 0; k < kt; ++k) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = x2s[(ty + 16 * r) * ldx + k0 + k];
#pragma unroll
      for (int g = 0; g < kColGroups; ++g) {
        if (g < ncg) {
          const float b = gs[k * c + tx + 16 * g];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][g] = fmaf(a[r], b, acc[r][g]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = row0 + ty + 16 * r;
    if (row >= m) continue;
#pragma unroll
    for (int g = 0; g < kColGroups; ++g) {
      if (g < ncg) {
        const int col = tx + 16 * g;
        const float norm = acc[r][g] + beta[col];
        const float s = inverse ? sqrtf(norm) : rsqrtf(norm);
        const long long idx = row * c + col;
        y[idx] = rgba::from_float<T>(rgba::to_float(x[idx]) * s);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* gamma_t, const void* beta, void* y,
           long long m, int c, int inverse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRows * (c + 1) + kK * c);
  cudaFuncSetAttribute(gdn_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const long long blocks = (m + kRows - 1) / kRows;
  gdn_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma_t),
      static_cast<const float*>(beta), static_cast<T*>(y), m, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (m, c) contiguous in the activation dtype (fp32 or bf16);
// gamma_t: (c, c) in the same dtype; beta: (c,) fp32.  c % 16 == 0 and
// c <= 192 (checked by the Python wrapper).
extern "C" int rgba_gdn(const void* x, const void* gamma_t, const void* beta,
                        void* y, long long m, int c, int inverse, int bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, gamma_t, beta, y, m, c, inverse, s);
  return launch<float>(x, gamma_t, beta, y, m, c, inverse, s);
}
