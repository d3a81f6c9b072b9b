// Fused DSE enhancement tail at full image resolution:
//   first = 1x1 cio->32 (x) + b             cast, zero outside the image
//   y = first; 3 times: y = y + 3x3(act(3x3(y) + b)) + b   (fp32 sum, cast)
//   out = 1x1 32->cio (cast(y + first)) + b + x             cast
// with ReLU (RGB decoder, cio = 3) or LeakyReLU 0.01 (mask decoder, cio = 1).
//
// Replaces rgba_tpu/ops/pallas/dse.py::fused_dse (body :71-123, call :191).
// The TPU kernel packs 4 images into the 128-lane axis (kron(I, w)); that is
// a TPU layout and has no counterpart here.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// outside the tensor cores): at the main-path size (batch 16, 512x768) the
// six 32-channel 3x3 convs do ~110,976 FLOP per pixel, 698 GFLOP, against
// ~75 MB of x and out in bf16 at cio = 3: bound by operations, 0.71 ms on
// bf16 tensor cores and 10.4 ms at the fp32 peak.
//
// Design: one block of 256 threads takes one output tile of one image and
// a frame of halo 6 around it (six chained 3x3 convs).  Two frame buffers
// of 32 channels live in dynamic shared memory in the activation dtype,
// which holds every value exactly because the reference casts at exactly
// these points: `y` (first, then each block's output, updated in place
// since each pixel reads only its own skip) and the block's inner
// activation.  Regions shrink by one pixel per conv.  `first` at the tile
// is recomputed from x at the end (a cio-deep 1x1) instead of being kept.
// Each conv's weights are staged in shared memory before its passes.  In
// fp32 each thread holds 4 pixels x 4 consecutive output channels, so a
// weight row is one 16-byte load per thread, and the products run on the
// CUDA cores; in bf16 they run on the tensor cores (below).  Both
// accumulate in fp32 in a fixed order (deterministic).  The tile is the
// largest of a fixed list that fits the card's shared memory for this
// dtype.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kF = 32;            // filters
constexpr int kQ = kF / 4;        // channel quads: 8 threads across
constexpr int kMR = 4;            // pixels per thread per pass
constexpr int kRows = kThreads / kQ;  // 32 pixel rows
constexpr int kPass = kRows * kMR;    // 128 pixels per pass
constexpr int kHalo = 6;
constexpr int kMaxCio = 4;

struct Geo {
  int h, w, cio;
  int th, tw, fw, nf;
  int r0, c0;
  int ld;
};

__device__ __forceinline__ bool in_image(const Geo& g, int f) {
  const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
  return r >= 0 && r < g.h && col >= 0 && col < g.w;
}

__device__ __forceinline__ int region_pix(const Geo& g, int s, int q) {
  const int rw = g.fw - 2 * s;
  return (s + q / rw) * g.fw + s + q % rw;
}

__device__ __forceinline__ int region_size(const Geo& g, int s) {
  return (g.th + 2 * (kHalo - s)) * (g.tw + 2 * (kHalo - s));
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ float act_fn(float v, int leaky) {
  return v > 0.f ? v : (leaky ? 0.01f * v : 0.f);
}

// One conv's weights (rows x cols of T, 16-byte rows) into shared memory
// with row stride ld, by all threads; the caller synchronises.
template <typename T>
__device__ __forceinline__ void stage_weights(T* dst, const T* src, int rows,
                                              int cols, int ld) {
  const int q = cols * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < rows * q; i += kThreads)
    reinterpret_cast<uint4*>(dst + (i / q) * ld)[i % q] =
        reinterpret_cast<const uint4*>(src + (i / q) * cols)[i % q];
}

// 1x1 cio -> 32 of x at image pixel (r, col), fp32 + bias.
template <typename T>
__device__ __forceinline__ float first_at(const T* img, const Geo& g, int r,
                                          int col, int o, const T* w_in,
                                          const float* b_in) {
  const T* px = img + (static_cast<size_t>(r) * g.w + col) * g.cio;
  float s = 0.f;
  for (int ci = 0; ci < g.cio; ++ci)
    s = fmaf(rgba::to_float(px[ci]), rgba::to_float(w_in[ci * kF + o]), s);
  return s + b_in[o];
}

// dst = 3x3(src) + b over the region inset by s, fp32 in acc; then `emit`.
template <typename T>
__device__ __forceinline__ void conv3x3_pass(const T* src, const Geo& g, int s,
                                             int p0, int np, const T* w3,
                                             float (&acc)[kMR][4],
                                             int (&f)[kMR], bool (&ok)[kMR]) {
  const int tq = threadIdx.x % kQ, tp = threadIdx.x / kQ;
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int q = p0 + tp + kRows * i;
    ok[i] = q < np;
    f[i] = region_pix(g, s, ok[i] ? q : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
    const T* ap[kMR];
#pragma unroll
    for (int i = 0; i < kMR; ++i) ap[i] = src + (f[i] + off) * g.ld;
    const T* wt = w3 + tap * kF * kF + 4 * tq;
#pragma unroll 8
    for (int ci = 0; ci < kF; ++ci) {
      float wv[4];
      load4(wt + ci * kF, wv);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const float a = rgba::to_float(ap[i][ci]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dse_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
           const float* __restrict__ b_in, const T* __restrict__ w3,
           const float* __restrict__ b3, const T* __restrict__ w_out,
           const float* __restrict__ b_out, T* __restrict__ out, int h, int w,
           int cio, int th, int tw, int tiles_w, int leaky) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int pad = 4 / static_cast<int>(sizeof(T));  // odd word stride
  Geo g;
  g.h = h; g.w = w; g.cio = cio;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ld = kF + pad;
  T* ybuf = reinterpret_cast<T*>(smem_raw);
  T* zbuf = ybuf + g.nf * g.ld;
  T* wsm = zbuf + g.nf * g.ld;  // the current conv's (288, 32) weights
  const T* img = x + static_cast<size_t>(blockIdx.y) * h * w * cio;
  T* oimg = out + static_cast<size_t>(blockIdx.y) * h * w * cio;

  // first = 1x1(x) + b on the whole frame, cast, 0 outside the image
  for (int i = threadIdx.x; i < g.nf * kF; i += kThreads) {
    const int f = i / kF, o = i - f * kF;
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < h && col >= 0 && col < w;
    ybuf[f * g.ld + o] = rgba::from_float<T>(
        inside ? first_at(img, g, r, col, o, w_in, b_in) : 0.f);
  }
  __syncthreads();

  const int tq = threadIdx.x % kQ;
  float acc[kMR][4];
  int f[kMR];
  bool ok[kMR];
  for (int blk = 0; blk < 3; ++blk) {
    const T* wa = w3 + static_cast<size_t>(2 * blk) * 9 * kF * kF;
    const T* wb = wa + 9 * kF * kF;
    const float* ba = b3 + 2 * blk * kF;
    const float* bb = ba + kF;
    // z = act(3x3(y) + ba) on the region inset by 2 blk + 1, 0 outside
    int s = 2 * blk + 1;
    int np = region_size(g, s);
    stage_weights(wsm, wa, 9 * kF, kF, kF);
    __syncthreads();
    for (int p0 = 0; p0 < np; p0 += kPass) {
      conv3x3_pass<T>(ybuf, g, s, p0, np, wsm, acc, f, ok);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        if (!ok[i]) continue;
        const bool inside = in_image(g, f[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 4 * tq + j;
          zbuf[f[i] * g.ld + o] = rgba::from_float<T>(
              inside ? act_fn(acc[i][j] + ba[o], leaky) : 0.f);
        }
      }
    }
    __syncthreads();
    // y = 3x3(z) + bb + y on the region inset by 2 blk + 2, 0 outside
    s = 2 * blk + 2;
    np = region_size(g, s);
    stage_weights(wsm, wb, 9 * kF, kF, kF);
    __syncthreads();
    for (int p0 = 0; p0 < np; p0 += kPass) {
      conv3x3_pass<T>(zbuf, g, s, p0, np, wsm, acc, f, ok);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        if (!ok[i]) continue;
        const bool inside = in_image(g, f[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 4 * tq + j;
          T* dst = ybuf + f[i] * g.ld + o;
          const float v = acc[i][j] + bb[o] + rgba::to_float(*dst);
          *dst = rgba::from_float<T>(inside ? v : 0.f);
        }
      }
    }
    __syncthreads();
  }

  // merged = cast(y + first); out = 1x1(merged) + b_out + x on the tile
  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int r = g.r0 + kHalo + i / tw, col = g.c0 + kHalo + i % tw;
    if (r >= h || col >= w) continue;
    const T* yp = ybuf + ((kHalo + i / tw) * g.fw + kHalo + i % tw) * g.ld;
    float o_acc[kMaxCio];
    for (int co = 0; co < cio; ++co) o_acc[co] = 0.f;
    for (int ci = 0; ci < kF; ++ci) {
      const float first = rgba::round_to<T>(
          first_at(img, g, r, col, ci, w_in, b_in));
      const float m = rgba::round_to<T>(rgba::to_float(yp[ci]) + first);
      for (int co = 0; co < cio; ++co)
        o_acc[co] = fmaf(m, rgba::to_float(w_out[ci * cio + co]), o_acc[co]);
    }
    const size_t base = (static_cast<size_t>(r) * w + col) * cio;
    for (int co = 0; co < cio; ++co)
      oimg[base + co] = rgba::from_float<T>(
          o_acc[co] + b_out[co] + rgba::to_float(img[base + co]));
  }
}


// ---------------------------------------------------------------- bf16 path
// The same tail with the 3x3 products on the tensor cores: mma.sync
// m16n8k16 (bf16 in, fp32 accumulate).  A warp takes 16 pixels of a
// 128-pixel pass and all 32 output channels (4 n-tiles of 8); A fragments
// come from the frame in shared memory (rows padded by 8 bf16, which
// spreads a fragment load's 8 rows over distinct banks), B fragments from
// the weights, laid out [out][in] so a pair of consecutive k is one 32-bit
// load and staged in shared memory one conv at a time.

constexpr int kWarps = kThreads / 32;
constexpr int kMPass = 16 * kWarps;   // 128 pixels per pass
constexpr int kLdMma = kF + 8;
constexpr int kLdW = 9 * kF + 8;      // staged [out][in] row: 148 words, 20g

// acc = 3x3(src) (no bias) for this thread's fragment rows of its warp's 16
// pixels of a pass over the region inset by s; w3t: (32, 288) [out][in]
// with row stride kLdW, in shared memory.
__device__ __forceinline__ void conv3x3_mma(const __nv_bfloat16* src,
                                            const Geo& g, int s, int p0, int np,
                                            const __nv_bfloat16* __restrict__ w3t,
                                            float (&acc)[4][4], int (&f)[2],
                                            bool (&ok)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = p0 + 16 * warp + gq + 8 * r;
    ok[r] = q < np;
    f[r] = region_pix(g, s, ok[r] ? q : 0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
    const __nv_bfloat16* lo = src + (f[0] + off) * kLdMma;
    const __nv_bfloat16* hi = src + (f[1] + off) * kLdMma;
#pragma unroll
    for (int k0 = 0; k0 < kF; k0 += 16) {
      const uint32_t a[4] = {
          rgba::ld32(lo + k0 + t2), rgba::ld32(hi + k0 + t2),
          rgba::ld32(lo + k0 + 8 + t2), rgba::ld32(hi + k0 + 8 + t2)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* wr =
            w3t + (8 * j + gq) * kLdW + tap * kF + k0 + t2;
        rgba::mma_bf16(acc[j], a, rgba::ld32(wr), rgba::ld32(wr + 8));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dse_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w_in,
               const float* __restrict__ b_in,
               const __nv_bfloat16* __restrict__ w3t,
               const float* __restrict__ b3,
               const __nv_bfloat16* __restrict__ w_out,
               const float* __restrict__ b_out, __nv_bfloat16* __restrict__ out,
               int h, int w, int cio, int th, int tw, int tiles_w, int leaky) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Geo g;
  g.h = h; g.w = w; g.cio = cio;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ld = kLdMma;
  bf16* ybuf = reinterpret_cast<bf16*>(smem_raw);
  bf16* zbuf = ybuf + g.nf * g.ld;
  bf16* wsm = zbuf + g.nf * g.ld;  // the current conv's [out][in] weights
  const bf16* img = x + static_cast<size_t>(blockIdx.y) * h * w * cio;
  bf16* oimg = out + static_cast<size_t>(blockIdx.y) * h * w * cio;

  for (int i = threadIdx.x; i < g.nf * kF; i += kThreads) {
    const int f = i / kF, o = i - f * kF;
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < h && col >= 0 && col < w;
    ybuf[f * g.ld + o] = rgba::from_float<bf16>(
        inside ? first_at(img, g, r, col, o, w_in, b_in) : 0.f);
  }
  __syncthreads();

  const int t2 = 2 * (threadIdx.x % 4);
  float acc[4][4];
  int f[2];
  bool ok[2];
  for (int blk = 0; blk < 3; ++blk) {
    const bf16* wa = w3t + static_cast<size_t>(2 * blk) * 9 * kF * kF;
    const bf16* wb = wa + 9 * kF * kF;
    const float* ba = b3 + 2 * blk * kF;
    const float* bb = ba + kF;
    int s = 2 * blk + 1;
    int np = region_size(g, s);
    stage_weights(wsm, wa, kF, 9 * kF, kLdW);
    __syncthreads();
    for (int p0 = 0; p0 < np; p0 += kMPass) {
      conv3x3_mma(ybuf, g, s, p0, np, wsm, acc, f, ok);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;
        const bool inside = in_image(g, f[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 8 * j + t2;
          *reinterpret_cast<__nv_bfloat162*>(zbuf + f[r] * g.ld + o) =
              __floats2bfloat162_rn(
                  inside ? act_fn(acc[j][2 * r] + ba[o], leaky) : 0.f,
                  inside ? act_fn(acc[j][2 * r + 1] + ba[o + 1], leaky) : 0.f);
        }
      }
    }
    __syncthreads();
    s = 2 * blk + 2;
    np = region_size(g, s);
    stage_weights(wsm, wb, kF, 9 * kF, kLdW);
    __syncthreads();
    for (int p0 = 0; p0 < np; p0 += kMPass) {
      conv3x3_mma(zbuf, g, s, p0, np, wsm, acc, f, ok);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ok[r]) continue;
        const bool inside = in_image(g, f[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 8 * j + t2;
          __nv_bfloat162* dst =
              reinterpret_cast<__nv_bfloat162*>(ybuf + f[r] * g.ld + o);
          const float2 y = __bfloat1622float2(*dst);
          *dst = __floats2bfloat162_rn(
              inside ? acc[j][2 * r] + bb[o] + y.x : 0.f,
              inside ? acc[j][2 * r + 1] + bb[o + 1] + y.y : 0.f);
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int r = g.r0 + kHalo + i / tw, col = g.c0 + kHalo + i % tw;
    if (r >= h || col >= w) continue;
    const bf16* yp = ybuf + ((kHalo + i / tw) * g.fw + kHalo + i % tw) * g.ld;
    float o_acc[kMaxCio];
    for (int co = 0; co < cio; ++co) o_acc[co] = 0.f;
    for (int ci = 0; ci < kF; ++ci) {
      const float first = rgba::round_to<bf16>(
          first_at(img, g, r, col, ci, w_in, b_in));
      const float m = rgba::round_to<bf16>(rgba::to_float(yp[ci]) + first);
      for (int co = 0; co < cio; ++co)
        o_acc[co] = fmaf(m, rgba::to_float(w_out[ci * cio + co]), o_acc[co]);
    }
    const size_t base = (static_cast<size_t>(r) * w + col) * cio;
    for (int co = 0; co < cio; ++co)
      oimg[base + co] = rgba::from_float<bf16>(
          o_acc[co] + b_out[co] + rgba::to_float(img[base + co]));
  }
}

size_t smem_bytes(int th, int tw, size_t es, int ld) {
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  // two frame buffers and one conv's weights
  return es * (2 * nf * ld + (es == 2 ? kF * kLdW : 9 * kF * kF));
}

template <typename T>
int launch(const void* x, const void* w_in, const void* b_in, const void* w3,
           const void* b3, const void* w_out, const void* b_out, void* out,
           int b, int h, int w, int cio, int leaky, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static const int kTiles[][2] = {{32, 32}, {32, 24}, {16, 32}, {16, 16},
                                  {16, 12}, {8, 8}};
  const int ld = kMma ? kLdMma : kF + 4 / static_cast<int>(sizeof(T));
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int th = 0, tw = 0;
  size_t smem = 0;
  for (const auto& t : kTiles) {
    smem = smem_bytes(t[0], t[1], sizeof(T), ld);
    if (smem <= static_cast<size_t>(max_smem)) { th = t[0]; tw = t[1]; break; }
  }
  if (!th || cio > kMaxCio) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  dim3 grid(tiles_h * tiles_w, b);
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w_in),
        static_cast<const float*>(b_in), static_cast<const T*>(w3),
        static_cast<const float*>(b3), static_cast<const T*>(w_out),
        static_cast<const float*>(b_out), static_cast<T*>(out), h, w, cio, th,
        tw, tiles_w, leaky);
  };
  if constexpr (kMma)
    run(dse_mma_kernel);
  else
    run(dse_kernel<T>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (b, h, w, cio) contiguous NHWC in the activation dtype (fp32 or
// bf16), cio <= 4; w_in (cio, 32), w3 in the order enh1.conv1, enh1.conv2,
// ..., enh3.conv2, (6, 9*32, 32) rows (dy, dx, ci) in fp32 and (6, 32, 9*32)
// [out][in] in bf16, w_out (32, cio), all in the activation dtype; b_in
// (32,), b3 (6, 32), b_out (cio,) fp32.
extern "C" int rgba_dse(const void* x, const void* w_in, const void* b_in,
                        const void* w3, const void* b3, const void* w_out,
                        const void* b_out, void* out, int b, int h, int w,
                        int cio, int leaky, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, w_in, b_in, w3, b3, w_out, b_out, out, b,
                                 h, w, cio, leaky, s);
  return launch<float>(x, w_in, b_in, w3, b3, w_out, b_out, out, b, h, w,
                       cio, leaky, s);
}
