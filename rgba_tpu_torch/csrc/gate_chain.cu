// Fused gated conv chain: out = x + chain_t(x) * sigmoid(1x1(chain_g(g))).
//
// Replaces rgba_tpu/ops/pallas/gate_chain.py::fused_gate_chain (body
// :51-134, call :234).  A chain is three bottleneck blocks
//   h0 = act(1x1 C->C/2 + b)         cast to the activation dtype, zero
//                                    outside the image (the 3x3's padding)
//   h1 = act(3x3 C/2->C/2 + b)       cast
//   cur = [act](1x1 C/2->C + b + cur)  fp32 sum, optional post-act, cast
// and the gate adds a final 1x1 C->C + b under a sigmoid.  WinGateAttention
// runs it with GELU, post-act and g = the window-attention output;
// SimplifiedAttention with ReLU, no post-act and g = x.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// outside the tensor cores): at the largest main-path site (C = 192 at
// 128x192, batch 16) the chain does 1,511,424 FLOP per output pixel, 594
// GFLOP, against 453 MB of x, g and out in bf16: bound by operations, 0.60
// ms on bf16 tensor cores and 8.9 ms at the fp32 peak.
//
// Design: one block of 256 threads takes one output tile of one image and
// a frame of halo 3 around it (three chained 3x3 convs).  The frame's
// activations (C wide) and the block's h0 (C/2 wide) stay in dynamic shared
// memory in the activation dtype, which holds every value exactly because
// the reference casts at exactly these points; h1 is made 64 pixels at a
// time into a small chunk and consumed at once by the 1x1 that follows,
// which updates the frame in place (each pixel reads only its own skip).
// Regions shrink by one pixel per block, so the first block computes the
// whole frame and the last only the tile.  The trunk's tile goes to the
// output buffer in device memory and is read back by the same block for
// the final gate, so shared memory holds one chain at a time.  Products are
// register-tiled on the CUDA cores (each thread 4 pixels x up to 12
// columns of 16) with fp32 accumulation in a fixed order, so results are
// deterministic.  The frame leaves almost no L1 beside it, so the weights,
// which every block shares, are staged 16 rows at a time through the last
// ~12 KB of shared memory by all threads together, the next chunk in
// flight in registers while the current one is used.
// That is the fp32 path; bf16 runs the products on the tensor cores (see
// the bf16 path below).  The tile is the largest of a fixed list that fits
// the card's shared memory for this C and dtype.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMR = 4;            // pixels per thread per pass
constexpr int kPass = 16 * kMR;   // 64 pixels per pass
constexpr int kNR = 12;           // column groups of 16: N <= 192
constexpr int kHalo = 3;
constexpr int kKC = 16;           // weight rows staged per step (fp32 path)

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return fmaxf(v, 0.f);                                // relu
  if (act == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(u));                                // gelu_tanh
}

template <typename T>
struct Chain {
  const T* w0; const float* b0;   // (3, C, C/2), (3, C/2)
  const T* w1; const float* b1;   // (3, 9*C/2, C/2) rows (dy, dx, ci), (3, C/2)
  const T* w2; const float* b2;   // (3, C/2, C), (3, C)
};

struct Geo {
  int h, w, c, half;   // image size, channels
  int th, tw, fw, nf;  // tile, frame width (tw + 2*halo), frame pixels
  int r0, c0;          // frame origin in image coordinates (may be < 0)
  int ldc, ldh;        // padded shared-memory row strides
};

__device__ __forceinline__ bool in_image(const Geo& g, int f) {
  const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
  return r >= 0 && r < g.h && col >= 0 && col < g.w;
}

// Frame index of pixel q of the region inset by s from the frame's edge.
__device__ __forceinline__ int region_pix(const Geo& g, int s, int q) {
  const int rw = g.fw - 2 * s;
  return (s + q / rw) * g.fw + s + q % rw;
}

__device__ __forceinline__ int region_size(const Geo& g, int s) {
  return (g.th + 2 * (kHalo - s)) * (g.tw + 2 * (kHalo - s));
}

// acc[i][j] += sum_k a[rows[i] * lda + k] * w[k * n + tx + 16 j].  The
// block stages w through `wbuf` (kKC x n) in shared memory, kKC rows at a
// time; each thread holds its share of the next chunk in registers while
// the current one is used, so the global loads overlap the products.
// Every thread of the block must call it with the same k_len.
constexpr int kPre = kKC * 16 * kNR / kThreads;  // chunk share: n <= 192

template <typename T>
__device__ __forceinline__ void gemm(float (&acc)[kMR][kNR], const T* a,
                                     int lda, const int (&rows)[kMR],
                                     const T* __restrict__ w, int k_len,
                                     int n, int tx, T* wbuf) {
  const T* ap[kMR];
#pragma unroll
  for (int i = 0; i < kMR; ++i) ap[i] = a + rows[i] * lda;
  const int ncg = (n + 15) / 16;
  T pre[kPre];
  auto fetch = [&](int k0) {
    const int len = min(kKC, k_len - k0) * n;
#pragma unroll
    for (int e = 0; e < kPre; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < len) pre[e] = w[static_cast<size_t>(k0) * n + i];
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < k_len; k0 += kKC) {
    const int kc = min(kKC, k_len - k0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int e = 0; e < kPre; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < kc * n) wbuf[i] = pre[e];
    }
    __syncthreads();
    if (k0 + kKC < k_len) fetch(k0 + kKC);
    for (int k = 0; k < kc; ++k) {
      float av[kMR];
#pragma unroll
      for (int i = 0; i < kMR; ++i) av[i] = rgba::to_float(ap[i][k0 + k]);
      const T* wr = wbuf + k * n;
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const int o = tx + 16 * j;
        if (j < ncg && o < n) {
          const float b = rgba::to_float(wr[o]);
#pragma unroll
          for (int i = 0; i < kMR; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kMR][kNR]) {
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < kNR; ++j) acc[i][j] = 0.f;
}

// Pixels of one pass over the region inset by s; a pixel past the region's
// end reads the region's first pixel and is never stored.
__device__ __forceinline__ void pass_rows(const Geo& g, int s, int p0, int np,
                                          int ty, int (&f)[kMR],
                                          bool (&ok)[kMR]) {
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int q = p0 + ty + 16 * i;
    ok[i] = q < np;
    f[i] = region_pix(g, s, ok[i] ? q : 0);
  }
}

template <typename T>
__device__ void load_frame(T* cur, const T* img, const Geo& g) {
  for (int i = threadIdx.x; i < g.nf * g.c; i += kThreads) {
    const int f = i / g.c, ch = i - f * g.c;
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < g.h && col >= 0 && col < g.w;
    cur[f * g.ldc + ch] = inside
        ? img[(static_cast<size_t>(r) * g.w + col) * g.c + ch]
        : rgba::from_float<T>(0.f);
  }
  __syncthreads();
}

// Runs one chain over the frame in `cur`, in place; on return the tile
// (the region inset by kHalo) holds the chain's output.
template <typename T>
__device__ void run_chain(T* cur, T* h0, T* h1c, T* wbuf, const Chain<T>& cw,
                          const Geo& g, int act, int post_act) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int C = g.c, HF = g.half;
  float acc[kMR][kNR];
  int f[kMR];
  bool ok[kMR];
  for (int blk = 0; blk < 3; ++blk) {
    const T* w0 = cw.w0 + static_cast<size_t>(blk) * C * HF;
    const float* b0 = cw.b0 + blk * HF;
    const T* w1 = cw.w1 + static_cast<size_t>(blk) * 9 * HF * HF;
    const float* b1 = cw.b1 + blk * HF;
    const T* w2 = cw.w2 + static_cast<size_t>(blk) * HF * C;
    const float* b2 = cw.b2 + blk * C;

    // h0 = act(1x1(cur) + b0) on the region inset by blk; 0 outside the image
    int np = region_size(g, blk);
    for (int p0 = 0; p0 < np; p0 += kPass) {
      pass_rows(g, blk, p0, np, ty, f, ok);
      zero(acc);
      gemm<T>(acc, cur, g.ldc, f, w0, C, HF, tx, wbuf);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        if (!ok[i]) continue;
        const bool inside = in_image(g, f[i]);
#pragma unroll
        for (int j = 0; j < kNR; ++j) {
          const int o = tx + 16 * j;
          if (o < HF)
            h0[f[i] * g.ldh + o] = rgba::from_float<T>(
                inside ? act_fn(acc[i][j] + b0[o], act) : 0.f);
        }
      }
    }
    __syncthreads();

    // per pass of the region inset by blk + 1: h1 = act(3x3(h0) + b1) into
    // the chunk, then cur = [act](1x1(h1) + b2 + cur) in place
    np = region_size(g, blk + 1);
    for (int p0 = 0; p0 < np; p0 += kPass) {
      pass_rows(g, blk + 1, p0, np, ty, f, ok);
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
        int fo[kMR];
#pragma unroll
        for (int i = 0; i < kMR; ++i) fo[i] = f[i] + off;
        gemm<T>(acc, h0, g.ldh, fo, w1 + static_cast<size_t>(tap) * HF * HF,
                HF, HF, tx, wbuf);
      }
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
#pragma unroll
        for (int j = 0; j < kNR; ++j) {
          const int o = tx + 16 * j;
          if (o < HF)
            h1c[(ty + 16 * i) * g.ldh + o] =
                rgba::from_float<T>(act_fn(acc[i][j] + b1[o], act));
        }
      }
      __syncthreads();
      int lrow[kMR];
#pragma unroll
      for (int i = 0; i < kMR; ++i) lrow[i] = ty + 16 * i;
      zero(acc);
      gemm<T>(acc, h1c, g.ldh, lrow, w2, HF, C, tx, wbuf);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        if (!ok[i]) continue;
#pragma unroll
        for (int j = 0; j < kNR; ++j) {
          const int o = tx + 16 * j;
          if (o < C) {
            T* dst = cur + f[i] * g.ldc + o;
            float v = acc[i][j] + b2[o] + rgba::to_float(*dst);
            if (post_act) v = act_fn(v, act);
            *dst = rgba::from_float<T>(v);
          }
        }
      }
      __syncthreads();  // the chunk is refilled by the next pass
    }
  }
}

// one block per SM at these shared-memory sizes: let it take the registers
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gate_chain_kernel(const T* __restrict__ x, const T* __restrict__ gin,
                  Chain<T> trunk, Chain<T> gate, const T* __restrict__ fwt,
                  const float* __restrict__ fb, T* out, int h, int w, int c,
                  int th, int tw, int tiles_w, int act, int post_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int pad = 4 / static_cast<int>(sizeof(T));  // odd word stride
  Geo g;
  g.h = h; g.w = w; g.c = c; g.half = c / 2;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ldc = c + pad;
  g.ldh = g.half + pad;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* h0 = cur + g.nf * g.ldc;
  T* h1c = h0 + g.nf * g.ldh;
  T* wbuf = h1c + kPass * g.ldh;

  const size_t img = static_cast<size_t>(blockIdx.y) * h * w * c;
  load_frame<T>(cur, x + img, g);
  run_chain<T>(cur, h0, h1c, wbuf, trunk, g, act, post_act);

  // the trunk's tile goes to `out`; the final pass below reads it back
  for (int i = threadIdx.x; i < th * tw * c; i += kThreads) {
    const int p = i / c, ch = i - p * c;
    const int r = g.r0 + kHalo + p / tw, col = g.c0 + kHalo + p % tw;
    if (r < h && col < w)
      out[img + (static_cast<size_t>(r) * w + col) * c + ch] =
          cur[((kHalo + p / tw) * g.fw + kHalo + p % tw) * g.ldc + ch];
  }
  __syncthreads();

  load_frame<T>(cur, (gin ? gin : x) + img, g);
  run_chain<T>(cur, h0, h1c, wbuf, gate, g, act, post_act);

  // out = x + trunk * sigmoid(1x1(gate) + fb) on the tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[kMR][kNR];
  int f[kMR];
  bool ok[kMR];
  const int np = th * tw;
  for (int p0 = 0; p0 < np; p0 += kPass) {
    pass_rows(g, kHalo, p0, np, ty, f, ok);
    zero(acc);
    gemm<T>(acc, cur, g.ldc, f, fwt, c, c, tx, wbuf);
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
      if (!ok[i]) continue;
      const int r = g.r0 + f[i] / g.fw, col = g.c0 + f[i] % g.fw;
      if (r >= h || col >= w) continue;
      const size_t base = img + (static_cast<size_t>(r) * w + col) * c;
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const int o = tx + 16 * j;
        if (o < c) {
          const float s = 1.f / (1.f + expf(-(acc[i][j] + fb[o])));
          const float v = rgba::to_float(x[base + o]) +
                          rgba::to_float(out[base + o]) * s;
          out[base + o] = rgba::from_float<T>(v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 path
// The same chain with its products on the tensor cores: mma.sync m16n8k16
// (bf16 in, fp32 accumulate).  A warp takes 16 pixels of a 128-pixel pass
// and all output columns (in chunks of 96); A fragments come from the
// frame in shared memory, B fragments from the weights, laid out [out][in]
// so a pair of consecutive k is one 32-bit load, staged 64 k at a time
// through shared memory (the next chunk in flight in registers).  K runs in steps of 16: the wrapper pads the 3x3's per-tap input
// and the 1x1-out's input from C/2 to a multiple of 16 (`halfp`) with zero
// weights, and the padding columns of h0 and the h1 chunk are zeroed once.
// Shared-memory rows are padded by 8 bf16, which spreads a fragment load's
// 8 rows over distinct banks.

constexpr int kWarps = kThreads / 32;
constexpr int kMPass = 16 * kWarps;   // 128 pixels per pass
constexpr int kNT = 12;               // n-tiles of 8 per chunk: 96 columns

struct MmaChain {
  const __nv_bfloat16* w0; const float* b0;  // (3, C/2, C), (3, C/2)
  const __nv_bfloat16* w1; const float* b1;  // (3, C/2, 9*halfp) k=(tap, ci)
  const __nv_bfloat16* w2; const float* b2;  // (3, C, halfp), (3, C)
};

constexpr int kKM = 64;               // k staged per step
constexpr int kLdB = kKM + 8;         // staged row stride: 36 words, 4g + t
constexpr int kPreM = kNT * 8 * kKM / 8 / kThreads;  // uint4 per thread: 3

// acc[j] (j < nt) += A[16 rows] x W^T for n-tiles n0 + 8 j: rows lo / hi are
// the shared-memory rows of this thread's fragment rows g and g + 8; w is
// [n][k] with row stride ldw (a multiple of 8), k_len a multiple of 16.
// The block stages W's rows n0 .. n0 + 8 nt through `wb` (8 nt x kLdB) in
// shared memory, kKM k at a time, the next chunk in flight in registers;
// every thread of the block must call it with the same arguments but lo/hi.
__device__ __forceinline__ void mma_gemm(float (&acc)[kNT][4],
                                         const __nv_bfloat16* lo,
                                         const __nv_bfloat16* hi,
                                         const __nv_bfloat16* __restrict__ w,
                                         int ldw, int k_len, int n0, int nt,
                                         __nv_bfloat16* wb) {
  const int lane = threadIdx.x % 32, gq = lane / 4, t2 = 2 * (lane % 4);
  uint4 pre[kPreM];
  auto fetch = [&](int k0) {
    const int kq = min(kKM, k_len - k0) / 8;  // uint4 per row
#pragma unroll
    for (int e = 0; e < kPreM; ++e) {
      const int i = threadIdx.x + e * kThreads, row = i / (kKM / 8);
      const int q = i % (kKM / 8);
      if (row < 8 * nt && q < kq)
        pre[e] = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(n0 + row) * ldw + k0 + 8 * q);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < k_len; k0 += kKM) {
    const int kc = min(kKM, k_len - k0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int e = 0; e < kPreM; ++e) {
      const int i = threadIdx.x + e * kThreads, row = i / (kKM / 8);
      const int q = i % (kKM / 8);
      if (row < 8 * nt && q < kc / 8)
        *reinterpret_cast<uint4*>(wb + row * kLdB + 8 * q) = pre[e];
    }
    __syncthreads();
    if (k0 + kKM < k_len) fetch(k0 + kKM);
    for (int kk = 0; kk < kc; kk += 16) {
      const uint32_t a[4] = {
          rgba::ld32(lo + k0 + kk + t2), rgba::ld32(hi + k0 + kk + t2),
          rgba::ld32(lo + k0 + kk + 8 + t2), rgba::ld32(hi + k0 + kk + 8 + t2)};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < nt) {
          const __nv_bfloat16* br = wb + (8 * j + gq) * kLdB + kk + t2;
          rgba::mma_bf16(acc[j], a, rgba::ld32(br), rgba::ld32(br + 8));
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_nt(float (&acc)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// This thread's two fragment rows (g, g + 8) of its warp's 16 pixels in a
// pass over the region inset by s: frame indices and validity.
__device__ __forceinline__ void mma_rows(const Geo& g, int s, int p0, int np,
                                         int (&f)[2], bool (&ok)[2]) {
  const int warp = threadIdx.x / 32, gq = (threadIdx.x % 32) / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = p0 + 16 * warp + gq + 8 * r;
    ok[r] = q < np;
    f[r] = region_pix(g, s, ok[r] ? q : 0);
  }
}

__device__ void run_chain_mma(__nv_bfloat16* cur, __nv_bfloat16* h0,
                              __nv_bfloat16* h1c, __nv_bfloat16* wb,
                              const MmaChain& cw, const Geo& g, int halfp,
                              int act, int post_act) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);
  const int C = g.c, HF = g.half;
  float acc[kNT][4];
  int f[2];
  bool ok[2];
  for (int blk = 0; blk < 3; ++blk) {
    const __nv_bfloat16* w0 = cw.w0 + static_cast<size_t>(blk) * HF * C;
    const float* b0 = cw.b0 + blk * HF;
    const __nv_bfloat16* w1 = cw.w1 + static_cast<size_t>(blk) * HF * 9 * halfp;
    const float* b1 = cw.b1 + blk * HF;
    const __nv_bfloat16* w2 = cw.w2 + static_cast<size_t>(blk) * C * halfp;
    const float* b2 = cw.b2 + blk * C;

    // h0 = act(1x1(cur) + b0) on the region inset by blk; 0 outside the image
    int np = region_size(g, blk);
    for (int p0 = 0; p0 < np; p0 += kMPass) {
      mma_rows(g, blk, p0, np, f, ok);
      zero_nt(acc);
      mma_gemm(acc, cur + f[0] * g.ldc, cur + f[1] * g.ldc, w0, C, C, 0,
               HF / 8, wb);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;
        const bool inside = in_image(g, f[r]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int o = 8 * j + t2;
          if (o < HF) {
            const float v0 = inside ? act_fn(acc[j][2 * r] + b0[o], act) : 0.f;
            const float v1 = inside ? act_fn(acc[j][2 * r + 1] + b0[o + 1], act) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(h0 + f[r] * g.ldh + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    __syncthreads();

    // per pass of the region inset by blk + 1: h1 = act(3x3(h0) + b1) into
    // this warp's 16 rows of the chunk, then cur = [act](1x1(h1) + b2 + cur)
    np = region_size(g, blk + 1);
    __nv_bfloat16* hw = h1c + 16 * warp * g.ldh;
    for (int p0 = 0; p0 < np; p0 += kMPass) {
      mma_rows(g, blk + 1, p0, np, f, ok);
      zero_nt(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
        mma_gemm(acc, h0 + (f[0] + off) * g.ldh, h0 + (f[1] + off) * g.ldh,
                 w1 + tap * halfp, 9 * halfp, halfp, 0, HF / 8, wb);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int o = 8 * j + t2;
          if (o < HF)
            *reinterpret_cast<__nv_bfloat162*>(hw + (gq + 8 * r) * g.ldh + o) =
                __floats2bfloat162_rn(act_fn(acc[j][2 * r] + b1[o], act),
                                      act_fn(acc[j][2 * r + 1] + b1[o + 1], act));
        }
      }
      __syncwarp();
      for (int n0 = 0; n0 < C; n0 += 8 * kNT) {
        const int nt = min(kNT, (C - n0) / 8);
        zero_nt(acc);
        mma_gemm(acc, hw + gq * g.ldh, hw + (gq + 8) * g.ldh, w2, halfp,
                 halfp, n0, nt, wb);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!ok[r]) continue;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j >= nt) continue;
            const int o = n0 + 8 * j + t2;
            __nv_bfloat162* dst =
                reinterpret_cast<__nv_bfloat162*>(cur + f[r] * g.ldc + o);
            const float2 skip = __bfloat1622float2(*dst);
            float v0 = acc[j][2 * r] + b2[o] + skip.x;
            float v1 = acc[j][2 * r + 1] + b2[o + 1] + skip.y;
            if (post_act) { v0 = act_fn(v0, act); v1 = act_fn(v1, act); }
            *dst = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      __syncwarp();  // the warp's chunk rows are refilled by the next pass
    }
    __syncthreads();
  }
}

// one block per SM at these shared-memory sizes: let it take the registers
__global__ void __launch_bounds__(kThreads, 1)
gate_chain_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ gin, MmaChain trunk,
                      MmaChain gate, const __nv_bfloat16* __restrict__ fwt,
                      const float* __restrict__ fb, __nv_bfloat16* out, int h,
                      int w, int c, int th, int tw, int tiles_w, int act,
                      int post_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf16 = __nv_bfloat16;
  Geo g;
  g.h = h; g.w = w; g.c = c; g.half = c / 2;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  const int halfp = (g.half + 15) / 16 * 16;
  g.ldc = c + 8;
  g.ldh = halfp + 8;
  bf16* cur = reinterpret_cast<bf16*>(smem_raw);
  bf16* h0 = cur + g.nf * g.ldc;
  bf16* h1c = h0 + g.nf * g.ldh;
  bf16* wb = h1c + kMPass * g.ldh;
  // the K padding of h0 and the chunk is read (against zero weights) and
  // never written: zero it, since 0 * NaN is NaN
  const int padw = halfp - g.half;
  for (int i = threadIdx.x; i < (g.nf + kMPass) * padw; i += kThreads) {
    const int row = i / padw, col = g.half + i % padw;
    (row < g.nf ? h0 + row * g.ldh : h1c + (row - g.nf) * g.ldh)[col] =
        __float2bfloat16(0.f);
  }

  const size_t img = static_cast<size_t>(blockIdx.y) * h * w * c;
  load_frame<bf16>(cur, x + img, g);
  run_chain_mma(cur, h0, h1c, wb, trunk, g, halfp, act, post_act);

  // the trunk's tile goes to `out`; the final pass below reads it back
  for (int i = threadIdx.x; i < th * tw * c; i += kThreads) {
    const int p = i / c, ch = i - p * c;
    const int r = g.r0 + kHalo + p / tw, col = g.c0 + kHalo + p % tw;
    if (r < h && col < w)
      out[img + (static_cast<size_t>(r) * w + col) * c + ch] =
          cur[((kHalo + p / tw) * g.fw + kHalo + p % tw) * g.ldc + ch];
  }
  __syncthreads();

  load_frame<bf16>(cur, (gin ? gin : x) + img, g);
  run_chain_mma(cur, h0, h1c, wb, gate, g, halfp, act, post_act);

  // out = x + trunk * sigmoid(1x1(gate) + fb) on the tile
  const int t2 = 2 * (threadIdx.x % 4);
  float acc[kNT][4];
  int f[2];
  bool ok[2];
  const int np = th * tw;
  for (int p0 = 0; p0 < np; p0 += kMPass) {
    mma_rows(g, kHalo, p0, np, f, ok);
    for (int n0 = 0; n0 < c; n0 += 8 * kNT) {
      const int nt = min(kNT, (c - n0) / 8);
      zero_nt(acc);
      mma_gemm(acc, cur + f[0] * g.ldc, cur + f[1] * g.ldc, fwt, c, c, n0,
               nt, wb);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;
        const int ir = g.r0 + f[r] / g.fw, ic = g.c0 + f[r] % g.fw;
        if (ir >= h || ic >= w) continue;
        const size_t base = img + (static_cast<size_t>(ir) * w + ic) * c;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j >= nt) continue;
          const int o = n0 + 8 * j + t2;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + base + o));
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + base + o);
          const float2 tv = __bfloat1622float2(*dst);
          const float s0 = 1.f / (1.f + expf(-(acc[j][2 * r] + fb[o])));
          const float s1 = 1.f / (1.f + expf(-(acc[j][2 * r + 1] + fb[o + 1])));
          *dst = __floats2bfloat162_rn(xv.x + tv.x * s0, xv.y + tv.y * s1);
        }
      }
    }
  }
}

size_t smem_bytes_mma(int c, int th, int tw) {
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  const size_t halfp = (c / 2 + 15) / 16 * 16;
  return 2 * (nf * (c + 8) + (nf + kMPass) * (halfp + 8) + 8 * kNT * kLdB);
}

size_t smem_bytes(int c, int th, int tw, size_t es) {
  const size_t pad = 4 / es;
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  const size_t half = c / 2;
  return es * (nf * (c + pad) + nf * (half + pad) + kPass * (half + pad) +
               kKC * c);
}

template <typename T>
int launch(const void* x, const void* g, const void* const* tw_,
           const void* const* gw_, const void* fw, const void* fb, void* out,
           int b, int h, int w, int c, int act, int post_act,
           cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static const int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {6, 8},
                                  {4, 8}, {4, 4}, {2, 4}};
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int th = 0, tw = 0;
  size_t smem = 0;
  for (const auto& t : kTiles) {
    smem = kMma ? smem_bytes_mma(c, t[0], t[1])
                : smem_bytes(c, t[0], t[1], sizeof(T));
    if (smem <= static_cast<size_t>(max_smem)) { th = t[0]; tw = t[1]; break; }
  }
  if (!th) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  dim3 grid(tiles_h * tiles_w, b);
  if constexpr (kMma) {
    cudaFuncSetAttribute(gate_chain_mma_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    auto chain = [](const void* const* p) {
      return MmaChain{static_cast<const T*>(p[0]), static_cast<const float*>(p[1]),
                      static_cast<const T*>(p[2]), static_cast<const float*>(p[3]),
                      static_cast<const T*>(p[4]), static_cast<const float*>(p[5])};
    };
    gate_chain_mma_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), chain(tw_),
        chain(gw_), static_cast<const T*>(fw), static_cast<const float*>(fb),
        static_cast<T*>(out), h, w, c, th, tw, tiles_w, act, post_act);
  } else {
    cudaFuncSetAttribute(gate_chain_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    auto chain = [](const void* const* p) {
      return Chain<T>{static_cast<const T*>(p[0]), static_cast<const float*>(p[1]),
                      static_cast<const T*>(p[2]), static_cast<const float*>(p[3]),
                      static_cast<const T*>(p[4]), static_cast<const float*>(p[5])};
    };
    gate_chain_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), chain(tw_),
        chain(gw_), static_cast<const T*>(fw), static_cast<const float*>(fb),
        static_cast<T*>(out), h, w, c, th, tw, tiles_w, act, post_act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (b, h, w, c) contiguous NHWC in the activation dtype (fp32 or
// bf16); g: the same, or null for g = x.  trunk / gate: 6 pointers each,
// w0 b0 w1 b1 w2 b2, weights in the activation dtype and biases fp32: in
// fp32 as in Chain with fw (c, c) [in, out]; in bf16 as in MmaChain with fw
// (c, c) [out, in].  act: 0 relu, 1 gelu (erf), 2 gelu (tanh).  c even and
// <= 192, and a multiple of 16 in bf16 (checked by the Python wrapper).
extern "C" int rgba_gate_chain(const void* x, const void* g,
                               const void* const* trunk,
                               const void* const* gate, const void* fw,
                               const void* fb, void* out, int b, int h, int w,
                               int c, int act, int post_act, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, g, trunk, gate, fw, fb, out, b, h, w, c,
                                 act, post_act, s);
  return launch<float>(x, g, trunk, gate, fw, fb, out, b, h, w, c, act,
                       post_act, s);
}
