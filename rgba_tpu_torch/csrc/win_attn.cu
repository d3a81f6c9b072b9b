// Fused masked window attention: per window, qkv projection, per-head
// scores + relative-position bias + the Swin region mask (-100 where two
// tokens' region ids differ), fp32 softmax, P.V, output projection, and
// the alive gate.  The output is pre-residual; dead windows are exactly 0.
//
// Replaces rgba_tpu/ops/pallas/win_attn.py::fused_window_attention (body
// _kernel :26-61, call :85).  The rel_bias gather table[rel_idx] stays in
// PyTorch, as in rgba_tpu/ops/attention.py:81-82.  Rounding points follow
// the reference kernel: qkv, P and the concatenated head outputs are cast
// to the activation dtype; every product accumulates in fp32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s fp32 outside
// the tensor cores, 3.35 TB/s): at N=64 tokens, C=192, 8 heads (hd=24),
// one window needs 2*N*C*3C + 2*2*N*N*C + 2*N*C*C = 22.0 MFLOP and moves
// its N*C tokens in and out; at batch 16, 512x768 (6144 windows) that is
// ~135 GFLOP against ~0.30 GB in bf16, so the op is bound by operations
// (0.14 ms on bf16 tensor cores).  Only alive windows need the work.
//
// Design: one block per window.  A dead window (alive == 0) writes zeros
// and returns, as the reference's remove_zero_windows drops it (about half
// the windows on blob-shaped alpha).  An alive window stages its tokens in
// shared memory as fp32 (64x192 is 48 KB, so the launch opts in to
// dynamic shared memory above 48 KB), loops over heads, and keeps q/k/v of
// one head (N x 3hd), the N x N fp32 scores and the concatenated head
// outputs (N x C) in shared memory; device memory sees the tokens once and
// the output once.  Both projections stream weight columns through a
// C x 32 shared tile and give each thread a 4-row register tile.  This
// first version runs its products on the fp32 CUDA cores: hd = 24 and 10
// are not multiples of the 16-deep bf16 MMA step, so a tensor-core version
// must pad the heads (later work).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kCols = 32;  // weight columns per shared tile
constexpr int kRowTile = 4;
constexpr int kMaxThreads = 512;  // caps registers at 128 a thread

// out[n][j] = sum_k a[n][k] * W[k][col(j)] for n < n_rows, j < ncols;
// a: shared, row stride lda (multiple of 4, 16-byte aligned rows);
// W: global (K x ldw) row-major; epi(n, j, acc) consumes each result.
template <typename T, typename ColMap, typename Epi>
__device__ __forceinline__ void gemm_cols(const float* a, int lda, int n_rows,
                                          int k_dim, const T* __restrict__ w,
                                          int ldw, int ncols, ColMap col,
                                          float* bs, Epi epi) {
  const int groups = n_rows / kRowTile;
  for (int j0 = 0; j0 < ncols; j0 += kCols) {
    const int jt = min(kCols, ncols - j0);
    for (int i = threadIdx.x; i < k_dim * jt; i += blockDim.x) {
      const int k = i / jt, jj = i - k * jt;
      bs[k * kCols + jj] =
          rgba::to_float(w[static_cast<long long>(k) * ldw + col(j0 + jj)]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < groups * jt; i += blockDim.x) {
      const int g = i / jt, jj = i - g * jt;
      float acc[kRowTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
      for (int k = 0; k < k_dim; k += 4) {
        const float b0 = bs[(k + 0) * kCols + jj];
        const float b1 = bs[(k + 1) * kCols + jj];
        const float b2 = bs[(k + 2) * kCols + jj];
        const float b3 = bs[(k + 3) * kCols + jj];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const float4 av =
              *reinterpret_cast<const float4*>(a + (g + r * groups) * lda + k);
          float s = acc[r];
          s = fmaf(av.x, b0, s);
          s = fmaf(av.y, b1, s);
          s = fmaf(av.z, b2, s);
          s = fmaf(av.w, b3, s);
          acc[r] = s;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) epi(g + r * groups, j0 + jj, acc[r]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
win_attn_kernel(const T* __restrict__ tokens, const int* __restrict__ region,
                const float* __restrict__ alive, const T* __restrict__ wqkv,
                const float* __restrict__ bqkv, const T* __restrict__ wproj,
                const float* __restrict__ bproj,
                const float* __restrict__ rel_bias, T* __restrict__ out,
                int n, int c, int nh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const long long win = blockIdx.x;
  const T* tok = tokens + win * n * c;
  T* o = out + win * n * c;
  const float gate = alive[win];
  if (gate == 0.f) {  // dead window: exact zeros, no work
    for (int i = threadIdx.x; i < n * c; i += blockDim.x)
      o[i] = rgba::from_float<T>(0.f);
    return;
  }

  const int hd = c / nh;
  const int lda = c + 4;           // 16-byte rows, rows 4 banks apart
  const int lq = 3 * hd + 1;       // odd stride: k rows spread over banks
  float* xs = smem;                // n x lda   tokens
  float* os = xs + n * lda;        // n x lda   concatenated head outputs
  float* qkv = os + n * lda;       // n x lq    q | k | v of one head
  float* s = qkv + n * lq;         // n x n     scores, then P
  float* bs = s + n * n;           // c x kCols weight tile
  int* reg = reinterpret_cast<int*>(bs + c * kCols);  // n region ids

  for (int i = threadIdx.x; i < n * c; i += blockDim.x) {
    const int r = i / c;
    xs[r * lda + (i - r * c)] = rgba::to_float(tok[i]);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) reg[i] = region[win * n + i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int h = 0; h < nh; ++h) {
    // q | k | v of head h: columns part*C + h*hd + d of wqkv
    auto qkv_col = [=](int j) { return (j / hd) * c + h * hd + j % hd; };
    gemm_cols<T>(xs, lda, n, c, wqkv, 3 * c, 3 * hd, qkv_col, bs,
                 [=](int row, int j, float acc) {
                   qkv[row * lq + j] = rgba::round_to<T>(acc + bqkv[qkv_col(j)]);
                 });
    // gemm_cols ends with a barrier: qkv is complete
    const float* rb = rel_bias + static_cast<long long>(h) * n * n;
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int qi = i / n, ki = i - qi * n;
      const float* q = qkv + qi * lq;
      const float* k = qkv + ki * lq + hd;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(q[d], k[d], acc);
      s[i] = acc * scale + rb[i] + (reg[qi] != reg[ki] ? -100.f : 0.f);
    }
    __syncthreads();
    for (int row = warp; row < n; row += nwarps) {
      float* sr = s + row * n;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(sr[j] - mx);
        sr[j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int j = lane; j < n; j += 32) sr[j] = rgba::round_to<T>(sr[j] / sum);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
      const int qi = i / hd, d = i - qi * hd;
      const float* p = s + qi * n;
      const float* v = qkv + 2 * hd + d;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], v[j * lq], acc);
      os[qi * lda + h * hd + d] = rgba::round_to<T>(acc);
    }
    __syncthreads();
  }

  gemm_cols<T>(os, lda, n, c, wproj, c, c, [](int j) { return j; }, bs,
               [=](int row, int j, float acc) {
                 o[row * c + j] = rgba::from_float<T>((acc + bproj[j]) * gate);
               });
}

size_t smem_bytes(int n, int c, int nh) {
  const int hd = c / nh;
  const size_t floats = 2 * static_cast<size_t>(n) * (c + 4) +
                        static_cast<size_t>(n) * (3 * hd + 1) +
                        static_cast<size_t>(n) * n + static_cast<size_t>(c) * kCols;
  return floats * sizeof(float) + n * sizeof(int);
}

template <typename T>
int launch(const void* tokens, const void* region, const void* alive,
           const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* rel_bias, void* out, int nw, int n,
           int c, int nh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, c, nh);
  cudaFuncSetAttribute(win_attn_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  // one 4-row group per thread and weight column of a tile
  const int threads =
      std::max(64, std::min(kMaxThreads, (n / kRowTile) * kCols));
  win_attn_kernel<T><<<nw, threads, smem, stream>>>(
      static_cast<const T*>(tokens), static_cast<const int*>(region),
      static_cast<const float*>(alive), static_cast<const T*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<T*>(out), n, c, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens, out: (nw, n, c) in the activation dtype (fp32 or bf16); region:
// (nw, n) int32; alive: (nw,) fp32; wqkv: (c, 3c) and wproj: (c, c) in the
// activation dtype; bqkv (3c,), bproj (c,), rel_bias (nh, n, n) fp32;
// scale = hd^-0.5 rounded to fp32 by the caller.
// The Python wrapper checks n % 4 == 0, c % 4 == 0, c % nh == 0, nh >= 3.
extern "C" int rgba_win_attn(const void* tokens, const void* region,
                             const void* alive, const void* wqkv,
                             const void* bqkv, const void* wproj,
                             const void* bproj, const void* rel_bias,
                             void* out, int nw, int n, int c, int nh,
                             float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(tokens, region, alive, wqkv, bqkv, wproj,
                                 bproj, rel_bias, out, nw, n, c, nh, scale,
                                 s);
  return launch<float>(tokens, region, alive, wqkv, bqkv, wproj, bproj,
                       rel_bias, out, nw, n, c, nh, scale, s);
}
