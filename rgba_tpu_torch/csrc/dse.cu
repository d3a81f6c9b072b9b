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
// Bound on an H100 SXM (3.35 TB/s; dense tensor cores 989 TFLOP/s bf16 and
// 495 TF32): at the main-path size (batch 16, 512x768) the six 32-channel
// 3x3 convs do ~110,976 FLOP per pixel, 698 GFLOP, against ~75 MB of x and
// out in bf16 at cio = 3: bound by operations, 0.71 ms on bf16 tensor cores
// and 4.2 ms in fp32 as 3xTF32 (three TF32 products per fp32 product; 10.4
// ms at the 67 TFLOP/s of the CUDA cores).
//
// Both dtypes share one design: one block takes one output tile of one
// image and a frame of halo 6 around it (six chained 3x3 convs).  Two frame
// buffers of 32 channels live in dynamic shared memory in the activation
// dtype, which holds every value exactly because the reference casts at
// exactly these points: `y` (first, then each block's output, updated in
// place since each pixel reads only its own skip) and the block's inner
// activation.  Regions shrink by one pixel per conv.  `first` at the tile is
// recomputed from x at the end (a cio-deep 1x1) instead of being kept.  The
// first and last 1x1 (cio <-> 32) run on the CUDA cores a pixel per thread,
// x read once and the frame row moved as 16-byte chunks.  The tile is the
// largest of a fixed list that fits the card's shared memory for this dtype.
//
// fp32 design (dse_tf32_kernel): the bf16 design below with the 3x3
// products at fp32 accuracy as 3xTF32 on wgmma m64n32k8 (common.cuh), the
// small terms a_lo b_hi, a_hi b_lo issued before a_hi b_hi every k step.
// - Shared memory: two fp32 frames of 32 channels (128-byte rows, 16-byte
//   chunks XOR-swizzled by row) at a 16x16 tile (frame 28x28) are 200,704
//   bytes; one conv's hi + lo weights (72 KB) do not fit beside them, so the
//   producer streams them a tap at a time (32 x 32 hi + lo, 8 KB, laid out
//   once per weights by dse.kernel_weights) into a ring of three stages, for
//   every pass of the conv.  Halo: the convs compute 2716 region pixels for
//   the tile's 256 x 6 (1.77x), in 64-row m-tiles.
// - A from registers: ldmatrix of the fp32 frame gives each lane its TF32
//   A fragment (an 8 x 8 b16 tile is 8 rows x 4 fp32); it is split into hi
//   and lo in registers.
// - Epilogues in exact fp32; sums in a fixed order (k ascending within a
//   term, the terms in the order above), no atomics: an image's result is
//   the same bits in any batch and any launch.
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
// - Shared memory: the two 32-channel frames have 64-byte rows whose 16-byte
//   chunks are XOR-swizzled by row (no padding), 157,696 bytes at a 16x32
//   tile (frame 28x44), + the ring 36,864 + barriers: 194,592 of 232,448.
// - Sums in a fixed order (k ascending), no atomics: the same bits twice.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kF = 32;            // filters
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

__device__ __forceinline__ float act_fn(float v, int leaky) {
  return v > 0.f ? v : (leaky ? 0.01f * v : 0.f);
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

// ---------------------------------------------------------------- fp32 path
// The same tail at fp32 accuracy with the six 3x3 convs as 3xTF32 on wgmma
// m64n32k8 (see the header's fp32 design and common.cuh).

constexpr int kTapW = 2 * kF * kF;   // one tap's weights, hi then lo: 2048

// Element (f, ch) of a 32-channel fp32 frame: 128-byte rows whose eight
// 16-byte chunks are XOR-swizzled by the low 3 bits of the row, so that
// ldmatrix's 8 consecutive rows fall in distinct banks without padding.
__device__ __forceinline__ int sw32(int f, int ch) {
  return f * kF + ((((ch >> 2) ^ f) & 7) << 2) + (ch & 3);
}

struct Taps {
  float* buf;          // stages x kTapW
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int it;
};

__device__ __forceinline__ int dse_passes(const Geo& g, int s) {
  return ((region_size(g, s) + 63) / 64 + 2 * kMT - 1) / (2 * kMT);
}

// acc[i] = 3x3(src) (no bias) for this warpgroup's MT m-tiles of a pass,
// the conv's weights streaming through the ring a tap at a time.
template <int MT>
__device__ __forceinline__ void conv3x3_tf32(float (&acc)[MT][kF / 2],
                                             const float* src, const Geo& g,
                                             const int (&f_lane)[kMT], Taps& t) {
  const int kl = 4 * ((threadIdx.x % 32) / 16);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < kF / 2; ++e) acc[i][e] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
    uint32_t hi[MT][4][4], lo[MT][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        rgba::ldsm_x4(a, src + sw32(f_lane[i] + off, 8 * kk + kl));
        rgba::split_tf32(a, hi[i][kk], lo[i][kk]);
      }
    const int s = t.it % t.stages;
    rgba::mbar_wait(&t.full[s], (t.it / t.stages) & 1);
    const float* b = t.buf + s * kTapW;
    const uint64_t bh = rgba::kmajor_desc(b, 4 * 256);
    const uint64_t bl = rgba::kmajor_desc(b + kF * kF, 4 * 256);
#pragma unroll
    for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
    rgba::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        rgba::wgmma_3xtf32<kF>(acc[i], hi[i][kk], lo[i][kk], bh + 16 * kk,
                               bl + 16 * kk);
    rgba::wgmma_commit_wait();
#pragma unroll
    for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
    if (threadIdx.x % 32 == 0) rgba::mbar_arrive(&t.empty[s]);
    ++t.it;
  }
}

// One pass of a conv, then its epilogue: inner convs z = act(3x3(y) + b),
// 0 outside the image; the others y = 3x3(z) + b + y.
template <int MT>
__device__ __forceinline__ void conv_pass_tf32(float* ybuf, float* zbuf,
                                               const Geo& g, bool inner,
                                               const int (&f_lane)[kMT],
                                               const int (&f_row)[kMT][2],
                                               const bool (&ok)[kMT][2],
                                               const float* bias, Taps& t,
                                               int leaky) {
  const int t2 = 2 * (threadIdx.x % 4);
  float acc[MT][kF / 2];
  conv3x3_tf32<MT>(acc, inner ? ybuf : zbuf, g, f_lane, t);
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
          *reinterpret_cast<float2*>(zbuf + sw32(f, o)) =
              make_float2(inside ? act_fn(v0, leaky) : 0.f,
                          inside ? act_fn(v1, leaky) : 0.f);
        } else {
          float2* dst = reinterpret_cast<float2*>(ybuf + sw32(f, o));
          const float2 y = *dst;
          *dst = make_float2(inside ? v0 + y.x : 0.f, inside ? v1 + y.y : 0.f);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
dse_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
                const float* __restrict__ b_in, const float* __restrict__ w3t,
                const float* __restrict__ b3, const float* __restrict__ w_out,
                const float* __restrict__ b_out, float* __restrict__ out,
                int h, int w, int cio, int th, int tw, int tiles_w, int stages,
                int leaky) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Geo g;
  g.h = h; g.w = w; g.cio = cio;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ld = kF;
  float* ybuf = reinterpret_cast<float*>(smem_raw);
  float* zbuf = ybuf + g.nf * kF;
  Taps t;
  t.buf = zbuf + g.nf * kF;
  t.full = reinterpret_cast<uint64_t*>(t.buf + stages * kTapW);
  t.empty = t.full + stages;
  t.stages = stages;
  t.it = 0;
  const float* img = x + static_cast<size_t>(blockIdx.y) * h * w * cio;
  float* oimg = out + static_cast<size_t>(blockIdx.y) * h * w * cio;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      rgba::mbar_init(&t.full[s], 1);
      rgba::mbar_init(&t.empty[s], kConsumers / 32);
    }
    rgba::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // one producer lane streams each pass's nine taps of its conv
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      for (int conv = 0; conv < 6; ++conv)
        for (int p = dse_passes(g, conv + 1); p > 0; --p)
          for (int tap = 0; tap < 9; ++tap, ++t.it) {
            const int s = t.it % stages;
            rgba::mbar_wait(&t.empty[s], ((t.it / stages) & 1) ^ 1);
            rgba::mbar_expect(&t.full[s], kTapW * 4);
            rgba::bulk_load(t.buf + s * kTapW,
                            w3t + static_cast<size_t>(conv * 9 + tap) * kTapW,
                            kTapW * 4, &t.full[s]);
          }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // first = 1x1(x) + b on the whole frame, 0 outside the image: a pixel per
  // thread, its 32 outputs stored as eight 16-byte chunks
  for (int f = threadIdx.x; f < g.nf; f += kConsumers) {
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < h && col >= 0 && col < w;
    float xin[kMaxCio];
#pragma unroll
    for (int c = 0; c < kMaxCio; ++c)
      xin[c] = inside && c < cio ? img[(static_cast<size_t>(r) * w + col) * cio + c] : 0.f;
#pragma unroll
    for (int q = 0; q < kF / 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 4 * q + e;
        float acc = 0.f;   // ci ascending, then the bias
#pragma unroll
        for (int c = 0; c < kMaxCio; ++c)
          if (c < cio) acc = fmaf(xin[c], w_in[c * kF + o], acc);
        v[e] = inside ? acc + b_in[o] : 0.f;
      }
      *reinterpret_cast<float4*>(ybuf + sw32(f, 4 * q)) = make_float4(v[0], v[1], v[2], v[3]);
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
    for (int p = 0, npass = dse_passes(g, s); p < npass; ++p) {
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
        conv_pass_tf32<2>(ybuf, zbuf, g, inner, f_lane, f_row, ok, bias, t, leaky);
      else
        conv_pass_tf32<1>(ybuf, zbuf, g, inner, f_lane, f_row, ok, bias, t, leaky);
    }
    rgba::named_sync(1, kConsumers);
  }

  // merged = y + first; out = 1x1(merged) + b_out + x on the tile: a pixel
  // per thread, x read once, y as eight 16-byte chunks
  for (int i = threadIdx.x; i < th * tw; i += kConsumers) {
    const int r = g.r0 + kHalo + i / tw, col = g.c0 + kHalo + i % tw;
    if (r >= h || col >= w) continue;
    const int f = (kHalo + i / tw) * g.fw + kHalo + i % tw;
    const size_t base = (static_cast<size_t>(r) * w + col) * cio;
    float xin[kMaxCio], o_acc[kMaxCio];
#pragma unroll
    for (int c = 0; c < kMaxCio; ++c) {
      xin[c] = c < cio ? img[base + c] : 0.f;
      o_acc[c] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < kF / 4; ++q) {
      const float4 yv = *reinterpret_cast<const float4*>(ybuf + sw32(f, 4 * q));
      const float yq[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 4 * q + e;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxCio; ++c)
          if (c < cio) acc = fmaf(xin[c], w_in[c * kF + ci], acc);
        const float m = yq[e] + (acc + b_in[ci]);
#pragma unroll
        for (int co = 0; co < kMaxCio; ++co)
          if (co < cio) o_acc[co] = fmaf(m, w_out[ci * cio + co], o_acc[co]);
      }
    }
#pragma unroll
    for (int co = 0; co < kMaxCio; ++co)
      if (co < cio) oimg[base + co] = o_acc[co] + b_out[co] + xin[co];
  }
}

int launch_bf16(const void* x, const void* w_in, const void* b_in,
                const void* w3, const void* b3, const void* w_out,
                const void* b_out, void* out, int b, int h, int w, int cio,
                int leaky, int max_smem, cudaStream_t stream) {
  static const int kTiles[][2] = {{32, 32}, {32, 24}, {16, 32}, {16, 16},
                                  {16, 12}, {8, 8}};
  int th = 0, tw = 0;
  size_t smem = 0;
  for (const auto& t : kTiles) {
    smem = smem_bytes_mma(t[0], t[1]);
    if (smem <= static_cast<size_t>(max_smem)) { th = t[0]; tw = t[1]; break; }
  }
  if (!th) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  dim3 grid(tiles_h * tiles_w, b);
  cudaFuncSetAttribute(dse_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dse_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
      static_cast<const float*>(b_in), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const bf16*>(w_out),
      static_cast<const float*>(b_out), static_cast<bf16*>(out), h, w, cio, th,
      tw, tiles_w, leaky);
  return static_cast<int>(cudaGetLastError());
}

int launch_tf32(const void* x, const void* w_in, const void* b_in,
                const void* w3, const void* b3, const void* w_out,
                const void* b_out, void* out, int b, int h, int w, int cio,
                int leaky, int max_smem, cudaStream_t stream) {
  static const int kTiles[][2] = {{16, 16}, {16, 12}, {8, 8}};
  constexpr int kMaxStages = 6;
  const size_t stage = kTapW * 4 + 2 * sizeof(uint64_t);
  int th = 0, tw = 0, stages = 0;
  size_t frames = 0;
  for (const auto& t : kTiles) {
    frames = 2 * static_cast<size_t>(t[0] + 2 * kHalo) * (t[1] + 2 * kHalo) * kF * 4;
    if (frames + 2 * stage <= static_cast<size_t>(max_smem)) {
      th = t[0]; tw = t[1];
      stages = static_cast<int>(std::min<size_t>(kMaxStages, (max_smem - frames) / stage));
      break;
    }
  }
  if (!th) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = frames + stages * stage;
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  dim3 grid(tiles_h * tiles_w, b);
  cudaFuncSetAttribute(dse_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dse_tf32_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const float*>(w_out),
      static_cast<const float*>(b_out), static_cast<float*>(out), h, w, cio, th,
      tw, tiles_w, stages, leaky);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (b, h, w, cio) contiguous NHWC in the activation dtype (fp32 or
// bf16), cio <= 4; w_in (cio, 32), w_out (32, cio) in the activation dtype,
// b_in (32,), b3 (6, 32), b_out (cio,) fp32; w3 the six 3x3 convs in the
// order enh1.conv1, enh1.conv2, ..., enh3.conv2, laid out by the wrapper
// (dse.kernel_weights): in bf16 (6, 32*288), each conv [out][in = (dy, dx,
// ci)] in K-major core-matrix order; in fp32 (6, 9*2*32*32), each conv's
// taps in order, each tap [out][ci] as its TF32 hi then its lo in K-major
// core matrices of 8 x 4.  All 16-byte aligned.
extern "C" int rgba_dse(const void* x, const void* w_in, const void* b_in,
                        const void* w3, const void* b3, const void* w_out,
                        const void* b_out, void* out, int b, int h, int w,
                        int cio, int leaky, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cio > kMaxCio) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bf16)
    return launch_bf16(x, w_in, b_in, w3, b3, w_out, b_out, out, b, h, w, cio,
                       leaky, max_smem, s);
  return launch_tf32(x, w_in, b_in, w3, b3, w_out, b_out, out, b, h, w, cio,
                     leaky, max_smem, s);
}
