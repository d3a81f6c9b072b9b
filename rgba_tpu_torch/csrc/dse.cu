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
// CUDA cores, accumulating in fp32 in a fixed order (deterministic).  The
// tile is the largest of a fixed list that fits the card's shared memory
// for this dtype.
//
// bf16 design (dse_mma_kernel): the same frames, with the six 3x3 convs on
// wgmma m64n32k16 (bf16 in, fp32 accumulate).
// - Roles: two consumer warpgroups and one producer warpgroup (384
//   threads; setmaxnreg moves the producer's registers to the consumers).
//   One producer lane streams the six convs' weights (32 x 288 bf16, 18 KB
//   each, laid out once per weights by the wrapper as K-major core
//   matrices) with cp.async.bulk into a ring of two stages tracked by
//   mbarriers, so conv i + 1's weights land while conv i runs; consumers
//   release a stage per warp and meet on a named barrier only between
//   convs.
// - A from registers: each warp loads its 16 pixels' A fragments for all 18
//   k steps (9 taps x 32 channels) with ldmatrix, whose per-lane row
//   addresses do the region gather and the tap shift; a warpgroup runs two
//   64-pixel m-tiles per pass (one in a region's last pass when that is
//   all that is left: the count is the same in both warpgroups and fixed
//   at compile time, since a wgmma under a condition is serialised).
// - N = 32 is narrow for wgmma: each k step reads 2 KB of A through
//   ldmatrix and 1 KB of B for 65,536 FLOP, so shared-memory bandwidth, not
//   the tensor cores, bounds this loop at about 2/3 of the bf16 peak.
//   m64n32k16 was measured against ldmatrix-fed mma.sync m16n8k16 in the
//   same design and kept (PERF.md §6).
// - The first and last 1x1 (cio <-> 32) run on the CUDA cores a pixel per
//   thread, x read once and the frame row moved as 16-byte chunks.
// - Shared memory: the two 32-channel frames have 64-byte rows whose 16-byte
//   chunks are XOR-swizzled by row (no padding), 157,696 bytes at a 16x32
//   tile (frame 28x44), + the ring 36,864 + barriers: 194,592 of 232,448.
// - Sums in a fixed order (k ascending), no atomics: the same bits twice.
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
// The same tail with the 3x3 products on Hopper's tensor cores (see the
// header's bf16 design).

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;                // two warpgroups
constexpr int kMmaThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kMT = 2;                         // m-tiles of 64 per warpgroup
constexpr int kStages = 2;                     // convs in the weight ring
constexpr int kConvW = kF * 9 * kF;            // one conv's weights: 9216

// Element (f, ch) of a 32-channel frame: 64-byte rows whose four 16-byte
// chunks are XOR-swizzled by bits 1-2 of the row, so that ldmatrix's 8
// consecutive rows fall in distinct banks without padding.
__device__ __forceinline__ int sw(int f, int ch) {
  return f * kF + ((((ch >> 3) ^ (f >> 1)) & 3) << 3) + (ch & 7);
}

// acc[i] = 3x3(src) (no bias) for this warpgroup's MT m-tiles of a pass
// (compile-time, so no wgmma sits under a condition), the conv's weights w
// ([out][in = tap*32 + ci], K-major core matrices) in shared memory.
template <int MT>
__device__ __forceinline__ void conv3x3_wgmma(float (&acc)[MT][kF / 2],
                                              const bf16* src, const Geo& g,
                                              const int (&f_lane)[kMT],
                                              const bf16* w) {
  const int kl = 8 * ((threadIdx.x % 32) / 16);
  uint32_t a[MT][18][4];
#pragma unroll
  for (int ks = 0; ks < 18; ++ks) {
    const int tap = ks / 2;
    const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      rgba::ldsm_x4(a[i][ks], src + sw(f_lane[i] + off, 16 * (ks % 2) + kl));
  }
  const uint64_t desc = rgba::kmajor_desc(w, 9 * kF / 8 * 128);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < kF / 2; ++e) acc[i][e] = 0.f;
    rgba::fence_operands(acc[i]);
  }
  rgba::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 18; ++ks)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      rgba::wgmma_rs<kF>(acc[i], a[i][ks], desc + 16 * ks);
  rgba::wgmma_commit_wait();
#pragma unroll
  for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
}

// One pass of a conv: MT m-tiles per warpgroup, then the epilogue: odd
// convs z = act(3x3(y) + b), 0 outside the image; even y = 3x3(z) + b + y.
template <int MT>
__device__ __forceinline__ void conv_pass(bf16* ybuf, bf16* zbuf,
                                          const Geo& g, bool inner,
                                          const int (&f_lane)[kMT],
                                          const int (&f_row)[kMT][2],
                                          const bool (&ok)[kMT][2],
                                          const float* bias, const bf16* w,
                                          int leaky) {
  const int t2 = 2 * (threadIdx.x % 4);
  float acc[MT][kF / 2];
  conv3x3_wgmma<MT>(acc, inner ? ybuf : zbuf, g, f_lane, w);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!ok[i][r]) continue;
      const int f = f_row[i][r];
      const bool inside = in_image(g, f);
#pragma unroll
      for (int j = 0; j < kF / 8; ++j) {
        const int o = 8 * j + t2;
        const float v0 = acc[i][4 * j + 2 * r] + bias[o];
        const float v1 = acc[i][4 * j + 2 * r + 1] + bias[o + 1];
        if (inner) {
          *reinterpret_cast<__nv_bfloat162*>(zbuf + sw(f, o)) =
              __floats2bfloat162_rn(inside ? act_fn(v0, leaky) : 0.f,
                                    inside ? act_fn(v1, leaky) : 0.f);
        } else {
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ybuf + sw(f, o));
          const float2 y = __bfloat1622float2(*dst);
          *dst = __floats2bfloat162_rn(inside ? v0 + y.x : 0.f,
                                       inside ? v1 + y.y : 0.f);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
dse_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
               const float* __restrict__ b_in, const bf16* __restrict__ w3c,
               const float* __restrict__ b3, const bf16* __restrict__ w_out,
               const float* __restrict__ b_out, bf16* __restrict__ out,
               int h, int w, int cio, int th, int tw, int tiles_w, int leaky) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Geo g;
  g.h = h; g.w = w; g.cio = cio;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ld = kF;
  bf16* ybuf = reinterpret_cast<bf16*>(smem_raw);
  bf16* zbuf = ybuf + g.nf * kF;
  bf16* ring = zbuf + g.nf * kF;     // kStages convs' weights
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kConvW);
  uint64_t* empty = full + kStages;
  const bf16* img = x + static_cast<size_t>(blockIdx.y) * h * w * cio;
  bf16* oimg = out + static_cast<size_t>(blockIdx.y) * h * w * cio;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rgba::mbar_init(&full[s], 1);
      rgba::mbar_init(&empty[s], kConsumers / 32);
    }
    rgba::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers; one
    // lane streams the six convs' weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < 6; ++i) {
        const int s = i % kStages;
        rgba::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        rgba::mbar_expect(&full[s], kConvW * 2);
        rgba::bulk_load(ring + s * kConvW, w3c + static_cast<size_t>(i) * kConvW,
                        kConvW * 2, &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // first = 1x1(x) + b on the whole frame, cast, 0 outside the image: a
  // pixel per thread, its 32 outputs stored as four 16-byte chunks
  for (int f = threadIdx.x; f < g.nf; f += kConsumers) {
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < h && col >= 0 && col < w;
    float xin[kMaxCio];
#pragma unroll
    for (int c = 0; c < kMaxCio; ++c)
      xin[c] = inside && c < cio
          ? rgba::to_float(img[(static_cast<size_t>(r) * w + col) * cio + c]) : 0.f;
#pragma unroll
    for (int q = 0; q < kF / 8; ++q) {
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int o = 8 * q + 2 * e + t;
          float acc = 0.f;   // first_at's order: ci ascending, then the bias
#pragma unroll
          for (int c = 0; c < kMaxCio; ++c)
            if (c < cio) acc = fmaf(xin[c], rgba::to_float(w_in[c * kF + o]), acc);
          v[t] = inside ? acc + b_in[o] : 0.f;
        }
        packed[e] = rgba::pack_bf16(v[0], v[1]);
      }
      *reinterpret_cast<uint4*>(ybuf + sw(f, 8 * q)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
  rgba::named_sync(1, kConsumers);

  const int wg = threadIdx.x / 128, wr = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int lrow = lane % 8 + 8 * ((lane / 8) % 2);
  for (int conv = 0; conv < 6; ++conv) {
    const bool inner = conv % 2 == 0;   // z = act(3x3(y)); else y += 3x3(z)
    const float* bias = b3 + conv * kF;
    const int s = conv + 1;
    const int np = region_size(g, s), tiles = (np + 63) / 64;
    const int st = conv % kStages;
    const bf16* wst = ring + st * kConvW;
    rgba::mbar_wait(&full[st], (conv / kStages) & 1);
    for (int p = 0; 2 * kMT * p < tiles; ++p) {
      // m-tiles 4 p + wg + 2 i (i < nm), nm alike in both warpgroups; one
      // past the region's end reads its first pixel and stores nothing
      const int nm = min(kMT, (tiles - 2 * kMT * p + 1) / 2);
      int f_lane[kMT], f_row[kMT][2];
      bool ok[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int mt = 2 * kMT * p + wg + 2 * i;
        const int q0 = mt * 64 + 16 * wr;
        f_lane[i] = region_pix(g, s, q0 + lrow < np ? q0 + lrow : 0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + lane / 4 + 8 * r;
          ok[i][r] = q < np;
          f_row[i][r] = region_pix(g, s, ok[i][r] ? q : 0);
        }
      }
      if (nm == 2)
        conv_pass<2>(ybuf, zbuf, g, inner, f_lane, f_row, ok, bias, wst, leaky);
      else
        conv_pass<1>(ybuf, zbuf, g, inner, f_lane, f_row, ok, bias, wst, leaky);
    }
    if (lane == 0) rgba::mbar_arrive(&empty[st]);
    rgba::named_sync(1, kConsumers);
  }

  // merged = cast(y + first); out = 1x1(merged) + b_out + x on the tile: a
  // pixel per thread, x read once, y as four 16-byte chunks
  for (int i = threadIdx.x; i < th * tw; i += kConsumers) {
    const int r = g.r0 + kHalo + i / tw, col = g.c0 + kHalo + i % tw;
    if (r >= h || col >= w) continue;
    const int f = (kHalo + i / tw) * g.fw + kHalo + i % tw;
    const size_t base = (static_cast<size_t>(r) * w + col) * cio;
    float xin[kMaxCio], o_acc[kMaxCio];
#pragma unroll
    for (int c = 0; c < kMaxCio; ++c) {
      xin[c] = c < cio ? rgba::to_float(img[base + c]) : 0.f;
      o_acc[c] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < kF / 8; ++q) {
      const uint4 yv = *reinterpret_cast<const uint4*>(ybuf + sw(f, 8 * q));
      const bf16* yp = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ci = 8 * q + e;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxCio; ++c)
          if (c < cio) acc = fmaf(xin[c], rgba::to_float(w_in[c * kF + ci]), acc);
        const float first = rgba::round_to<bf16>(acc + b_in[ci]);
        const float m = rgba::round_to<bf16>(rgba::to_float(yp[e]) + first);
#pragma unroll
        for (int co = 0; co < kMaxCio; ++co)
          if (co < cio)
            o_acc[co] = fmaf(m, rgba::to_float(w_out[ci * cio + co]), o_acc[co]);
      }
    }
#pragma unroll
    for (int co = 0; co < kMaxCio; ++co)
      if (co < cio)
        oimg[base + co] = rgba::from_float<bf16>(o_acc[co] + b_out[co] + xin[co]);
  }
}

size_t smem_bytes_mma(int th, int tw) {
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  // two swizzled frames, the weight ring, its barriers
  return 2 * (2 * nf * kF + kStages * kConvW) + 2 * kStages * sizeof(uint64_t);
}

size_t smem_bytes(int th, int tw, size_t es, int ld) {
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  // two frame buffers and one conv's weights
  return es * (2 * nf * ld + 9 * kF * kF);
}

template <typename T>
int launch(const void* x, const void* w_in, const void* b_in, const void* w3,
           const void* b3, const void* w_out, const void* b_out, void* out,
           int b, int h, int w, int cio, int leaky, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static const int kTiles[][2] = {{32, 32}, {32, 24}, {16, 32}, {16, 16},
                                  {16, 12}, {8, 8}};
  const int ld = kF + 4 / static_cast<int>(sizeof(T));
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int th = 0, tw = 0;
  size_t smem = 0;
  for (const auto& t : kTiles) {
    smem = kMma ? smem_bytes_mma(t[0], t[1])
                : smem_bytes(t[0], t[1], sizeof(T), ld);
    if (smem <= static_cast<size_t>(max_smem)) { th = t[0]; tw = t[1]; break; }
  }
  if (!th || cio > kMaxCio) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  dim3 grid(tiles_h * tiles_w, b);
  auto run = [&](auto kernel, int threads) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w_in),
        static_cast<const float*>(b_in), static_cast<const T*>(w3),
        static_cast<const float*>(b3), static_cast<const T*>(w_out),
        static_cast<const float*>(b_out), static_cast<T*>(out), h, w, cio, th,
        tw, tiles_w, leaky);
  };
  if constexpr (kMma)
    run(dse_mma_kernel, kMmaThreads);
  else
    run(dse_kernel<T>, kThreads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (b, h, w, cio) contiguous NHWC in the activation dtype (fp32 or
// bf16), cio <= 4; w_in (cio, 32), w3 in the order enh1.conv1, enh1.conv2,
// ..., enh3.conv2: in fp32 (6, 9*32, 32) rows (dy, dx, ci); in bf16 (6,
// 32*288), each conv [out][in = (dy, dx, ci)] in K-major core-matrix order
// (16-byte aligned); w_out (32, cio), all in the activation dtype; b_in
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
