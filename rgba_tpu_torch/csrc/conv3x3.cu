// 3x3 convolution at stride 1, zero padding 1, of fp32 NHWC activations
// over the whole batch in one launch: y = conv2d(x, w, b, stride=1,
// padding=1), every product at fp32 accuracy on the tensor cores as 3xTF32.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It was added because the codec's convolutions run inside
// batch_invariant_scope, where cuDNN's deterministic fp32 convolutions run
// on the CUDA cores' FFMA (67 TFLOP/s), one image at a time: TF32 is off for
// the codec's fp32 policy, and cuDNN picks its algorithm, and so its sum
// order, by the batch size.  This kernel's sum order depends on nothing but
// (Cin, Cout), so it takes the whole batch at once.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 3.35 TB/s): an implicit
// GEMM of M = B H W output pixels, N = Cout, K = 9 Cin.  At the mixed
// Transformer-CNN codec's H/2 layer (batch 16, 256x384, 256 -> 256) that is
// 2 M N K = 1.86 TFLOP against 3.2 GB of input and output: bound by
// operations, 3.75 ms at the TF32 peak (0.96 ms of bytes).  3xTF32 issues every product three
// times, so the kernel can reach at most a third of that peak (33% of the
// bound counted at one TF32 product per fp32 product).  Measured on an H100
// 80GB HBM3 at 700 W: 15.4 ms there (24% of the bound), against 47.9 ms for
// cuDNN's fp32 convolution one image at a time.
//
// Design (conv3x3_tf32_kernel<BN>):
// - A block computes one output tile of 8 rows x 16 columns of one image
//   (128 pixels) for BN output channels (16, 64 or 128, by Cout alone).
//   Two consumer warpgroups take 4 rows each, one wgmma m64nBNk8 row of
//   fragments per warp row of 16 pixels; a producer warpgroup feeds them
//   (setmaxnreg gives its registers to the consumers' two sums).
// - K order: input channels in blocks of 32 (the last zero-filled past
//   Cin), within a block the taps in order (dy, dx row-major), within a tap
//   the block's channels in k steps of 8.  Each (block, tap) is one unit:
//   4 k steps, each p += a_lo b_hi + a_hi b_lo + a_hi b_hi (common.cuh),
//   summed on wgmma into registers p from zero; the unit's p is then added
//   to the output's sum d on the CUDA cores.  The tensor cores' adds into
//   their accumulators cut the low bits off; over K = 9 Cin terms that
//   error grows with K (at Cin = 256 on the H100, 9x cuDNN's fp32 error),
//   while the rounded adds of 9 Cin / 32 unit sums keep it below cuDNN's.
// - Activations: three producer warps copy the block's halo tile (10 x 18
//   pixels x 32 channels, zero-filled outside the image and past Cin) with
//   cp.async into one of two buffers, so the next block lands while this
//   one computes.  A tile never spans two images and its halo's rows and
//   columns are checked against its own image, so the padding is every
//   image's own zeros.  Pixels are 36 fp32 apart: ldmatrix's 8 rows fall in
//   distinct banks.  The consumers read each halo buffer for all 9 taps:
//   ldmatrix with per-lane row addresses does the tap shift and gives each
//   lane its TF32 A fragment (8 rows x 4 fp32 per matrix), split into hi
//   and lo in registers (wgmma with A from registers).
// - Weights: laid out once per weights by the wrapper (conv3x3.py,
//   kernel_weights): per N tile, per unit, the unit's BN x 32 weights'
//   TF32 hi in K-major core matrices of 8 rows x 4 fp32, then their lo.  One
//   producer lane streams the units with cp.async.bulk into a ring of 4
//   stages on mbarriers; each consumer warp releases a stage once its wgmma
//   have read it.
// - Bias in the epilogue, straight from the accumulators to device memory;
//   pixels past the image and channels past Cout are not stored.
// - Batch invariance by construction: no split-K, no atomics, one fixed K
//   walk; the tile shape and BN depend on Cout only, so an output element's
//   sum is the same sequence of operations whatever the batch size, the
//   image size or the image's place in the batch.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;            // output tile: rows x columns
constexpr int kHH = kTH + 2, kHW = kTW + 2; // halo tile
constexpr int kHaloPix = kHH * kHW;         // 180
constexpr int kKC = 32;                     // input channels per block
constexpr int kLd = kKC + 4;                // fp32 per halo pixel: 144 bytes
constexpr int kHaloFloats = kHaloPix * kLd;
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kLoaders = 96;                // its warps 1-3 load the halo
constexpr int kStages = 4;                  // weight units in the ring
constexpr int kTaps = 9;

template <int BN> constexpr size_t smem_bytes() {  // ring of hi | lo units, halo
  return sizeof(float) * (kStages * 2 * BN * kKC + 2 * kHaloFloats) +
         sizeof(uint64_t) * (2 * kStages + 4);
}

// This lane's A fragments of one unit (4 k steps of 8) from the halo at a
// (this lane's ldmatrix row, shifted by the tap), split into hi and lo.
__device__ __forceinline__ void load_unit(const float* a, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t v[4];
    rgba::ldsm_x4(v, a + 8 * s);
    rgba::split_tf32(v, hi[s], lo[s]);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int h, int w, int cin, int cout, int tiles_h, int tiles_w,
                    int ntn) {
  constexpr int kUnit = 2 * BN * kKC;     // floats of a weight unit: hi, lo
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);       // kStages x kUnit
  float* halo = ring + kStages * kUnit;                   // 2 x kHaloFloats
  uint64_t* full = reinterpret_cast<uint64_t*>(halo + 2 * kHaloFloats);
  uint64_t* empty = full + kStages;
  uint64_t* h_full = empty + kStages;
  uint64_t* h_empty = h_full + 2;

  // N tiles of one output tile are neighbours in the grid: they share
  // their halo in L2
  const int nt = static_cast<int>(blockIdx.x % ntn);
  const long long mt = blockIdx.x / ntn;
  const int tj = static_cast<int>(mt % tiles_w);
  const int ti = static_cast<int>((mt / tiles_w) % tiles_h);
  const long long img = mt / (static_cast<long long>(tiles_w) * tiles_h);
  const int r0 = ti * kTH, c0 = tj * kTW;
  const int nblocks = (cin + kKC - 1) / kKC;
  const int units = kTaps * nblocks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rgba::mbar_init(&full[s], 1);
      rgba::mbar_init(&empty[s], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      rgba::mbar_init(&h_full[i], kLoaders);
      rgba::mbar_init(&h_empty[i], kConsumers / 32);
    }
    rgba::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers;
    if (pt == 0) {
      // the weight units of this N tile, in the consumers' order
      const float* wt = wp + static_cast<size_t>(nt) * units * kUnit;
      for (int u = 0; u < units; ++u) {
        const int s = u % kStages;
        rgba::mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        rgba::mbar_expect(&full[s], kUnit * 4);
        rgba::bulk_load(ring + s * kUnit, wt + static_cast<size_t>(u) * kUnit,
                        kUnit * 4, &full[s]);
      }
    } else if (pt >= 32) {
      // the halo of each channel block, zero outside the image and past Cin
      const int lt = pt - 32;
      const float* xi = x + static_cast<size_t>(img) * h * w * cin;
      for (int b = 0; b < nblocks; ++b) {
        const int buf = b & 1;
        rgba::mbar_wait(&h_empty[buf], ((b >> 1) & 1) ^ 1);
        float* dst = halo + buf * kHaloFloats;
        for (int i = lt; i < kHaloPix * (kKC / 4); i += kLoaders) {
          const int p = i / (kKC / 4), q = i % (kKC / 4);
          const int rr = r0 - 1 + p / kHW, cc = c0 - 1 + p % kHW;
          const int ch = b * kKC + 4 * q;
          const bool ok = rr >= 0 && rr < h && cc >= 0 && cc < w && ch < cin;
          rgba::cp_async16(dst + p * kLd + 4 * q,
                           ok ? xi + (static_cast<size_t>(rr) * w + cc) * cin + ch : xi,
                           ok);
        }
        rgba::cp_async_commit();
        rgba::cp_async_wait<0>();
        rgba::mbar_arrive(&h_full[buf]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumers: warp row (4 wg + warp) of the tile, 16 pixels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int orow = warp;  // warps 0-3: rows 0-3 (first warpgroup), 4-7
  // this lane's ldmatrix row: pixel (lane % 8) + 8 ((lane / 8) % 2) of the
  // warp's row, channels 4 (lane / 16) onwards of each k step
  const int lane_off = (orow * kHW + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                       4 * (lane >> 4);
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  int u = 0;
  for (int b = 0; b < nblocks; ++b) {
    const int buf = b & 1;
    rgba::mbar_wait(&h_full[buf], (b >> 1) & 1);
    const float* hb = halo + buf * kHaloFloats + lane_off;
#pragma unroll 1
    for (int t = 0; t < kTaps; ++t, ++u) {
      uint32_t hi[4][4], lo[4][4];
      load_unit(hb + ((t / 3) * kHW + t % 3) * kLd, hi, lo);
      if (t == kTaps - 1) {  // the block's halo is read: the loaders may refill it
        __syncwarp();
        if (lane == 0) rgba::mbar_arrive(&h_empty[buf]);
      }
      const int s = u % kStages;
      rgba::mbar_wait(&full[s], (u / kStages) & 1);
      const float* bs = ring + s * kUnit;
      const uint64_t bh = rgba::kmajor_desc(bs, kKC * 32);
      const uint64_t bl = rgba::kmajor_desc(bs + BN * kKC, kKC * 32);
      float p[BN / 2];  // the unit's sum, from zero
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) p[i] = 0.f;
      rgba::fence_operands(p);
      rgba::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rgba::wgmma_3xtf32<BN>(p, hi[k], lo[k], bh + 16 * k, bl + 16 * k);
      rgba::wgmma_commit_wait();
      rgba::fence_operands(p);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] += p[i];
      __syncwarp();
      if (lane == 0) rgba::mbar_arrive(&empty[s]);
    }
  }

  // epilogue: d[4 j + 2 r + e] is pixel column (lane / 4) + 8 r of the
  // warp's row, channel 8 j + 2 (lane % 4) + e of the N tile
  const int row = r0 + orow;
  if (row >= h) return;
  float* yr = y + (static_cast<size_t>(img) * h + row) * w * cout;
  const int gq = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = nt * BN + 8 * j + t2;
    if (n >= cout) continue;  // Cout is even: n + 1 < Cout too
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = c0 + gq + 8 * r;
      if (col < w)
        *reinterpret_cast<float2*>(yr + static_cast<size_t>(col) * cout + n) =
            make_float2(d[4 * j + 2 * r] + b0, d[4 * j + 2 * r + 1] + b1);
    }
  }
}

template <int BN>
int launch_as(const void* x, const void* wp, const void* bias, void* y,
              int batch, int h, int w, int cin, int cout, cudaStream_t stream) {
  const auto kernel = conv3x3_tf32_kernel<BN>;
  constexpr size_t smem = smem_bytes<BN>();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int tiles_h = (h + kTH - 1) / kTH, tiles_w = (w + kTW - 1) / kTW;
  const int ntn = (cout + BN - 1) / BN;
  const long long grid = static_cast<long long>(batch) * tiles_h * tiles_w * ntn;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp),
      static_cast<const float*>(bias), static_cast<float*>(y), h, w, cin, cout,
      tiles_h, tiles_w, ntn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, h, w, cin) fp32 NHWC, contiguous, 16-byte aligned; y: (batch,
// h, w, cout) fp32, contiguous, 8-byte aligned; bias: (cout,) fp32.  wp: the
// weights as conv3x3.kernel_weights lays them out for bn (the N tile: 16, 64
// or 128): [N tile][channel block of 32][tap][TF32 hi | lo of bn x 32 in
// K-major core matrices], zero past Cout and Cin.  cin % 8 == 0 and cout
// even (checked by the Python wrapper).
extern "C" int rgba_conv3x3(const void* x, const void* wp, const void* bias,
                            void* y, int batch, int h, int w, int cin,
                            int cout, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch_as<16>(x, wp, bias, y, batch, h, w, cin, cout, s);
    case 64: return launch_as<64>(x, wp, bias, y, batch, h, w, cin, cout, s);
    case 128: return launch_as<128>(x, wp, bias, y, batch, h, w, cin, cout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
