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
// Bound on an H100 SXM (3.35 TB/s; dense tensor cores 989 TFLOP/s bf16 and
// 495 TF32): at the largest main-path site (C = 192 at 128x192, batch 16)
// the chain does 1,511,424 FLOP per output pixel, 594 GFLOP, against 453 MB
// of x, g and out in bf16 (906 MB in fp32): bound by operations, 0.60 ms on
// bf16 tensor cores and 3.6 ms in fp32 as 3xTF32 (three TF32 products per
// fp32 product; 8.9 ms at the 67 TFLOP/s of the CUDA cores).
//
// Both dtypes share one design: one block takes one output tile of one
// image and a frame of halo 3 around it (three chained 3x3 convs).  The
// frame's activations (C wide) and the block's h0 (C/2 wide) stay in dynamic
// shared memory in the activation dtype, which holds every value exactly
// because the reference casts at exactly these points.  Regions shrink by
// one pixel per block, so the first block computes the whole frame and the
// last only the tile; each 1x1 after a 3x3 updates the frame in place (each
// pixel reads only its own skip).  The trunk's tile goes to the output
// buffer in device memory and is read back by the same block for the final
// gate, so shared memory holds one chain at a time.  The tile is the largest
// of a fixed list that fits the card's shared memory for this C and dtype.
//
// fp32 design (gate_chain_tf32_kernel<HP>, HP = C/2 rounded up to 16, 32,
// 40, 48, 64, 80 or 96): the bf16 design below with every product at fp32
// accuracy on the tensor cores as 3xTF32 (common.cuh): wgmma m64 x HP x k8
// with the small terms a_lo b_hi, a_hi b_lo issued before a_hi b_hi, in that
// order, every k step.
// - The weights' TF32 hi and lo are laid out once per weights by the
//   wrapper (gate_chain.kernel_weights): chunks of 16 k, each its hi then its
//   lo in K-major core matrices of 8 rows x 4 fp32, one bulk copy per chunk.
//   The activations are split in registers after ldmatrix, which gives each
//   lane exactly its TF32 A fragment from an 8 x 8 b16 tile of the fp32
//   frame (row lane / 4, fp32 column lane % 4), so the region gather and
//   the tap shift by per-lane row addresses carry over.
// - Shared memory at C = 192: an fp32 frame and h0 (rows padded by 4 fp32)
//   fit only a 6x8 tile, frame 12x14 = 168 pixels, 198,912 bytes; the ring
//   takes what is left, two chunks of 12,288 bytes (HP 96 x 16 k x hi + lo).
//   Halo and 64-row m-tiles: the 3x3s compute 128 rows for each of the
//   regions of 120, 80 and 48 pixels (2.67x the tile's 48 per block), the
//   h0 1x1s 256, 128 and 128 for 168, 120 and 80.  C = 80 fits an 8x16
//   tile (frame 14x22) with six chunks in the ring.
// - One m-tile per warpgroup and pass (128 pixels a pass): h1 (HP/2 fp32 a
//   thread) and the 1x1's accumulators must sit in registers together.  h1
//   stays in the 3x3's accumulators, which are not a TF32 A fragment (a lane
//   holds channels 2q, 2q + 1 of an n-tile, the fragment wants k = q, q + 4):
//   the wrapper permutes the k of the following 1x1 within each 8 to match,
//   so h1 never touches shared memory.  The sum order stays fixed.
// - K padding: C/2 -> HP with zero weights, h0's and h1's padding columns
//   written as exact zeros.  C = 80 needs none (40 is a multiple of k8).
// - Epilogues in exact fp32: GELU with erff (or tanhf), the sigmoid with
//   expf; none of the bf16 path's approximations.
// - Sums in a fixed order per output (k ascending within a term, the terms
//   in the order above), no atomics, no split-K: an image's result is the
//   same bits in any batch and any launch, as the codec's encoder and decoder
//   need (both rebuild the mask reconstruction).
//
// bf16 design (gate_chain_mma_kernel<HP>, HP = C/2 rounded up to 16): the
// halo-fused frame above, with every product on wgmma (m64 x HP x k16, bf16
// in, fp32 accumulate) and the weights streamed, not restaged.
// - Roles: a block is two consumer warpgroups and one producer warpgroup
//   (384 threads; setmaxnreg moves the producer's registers to the
//   consumers, 232 each, for the accumulators).  One producer lane walks the consumers' schedule and keeps a ring
//   of three weight chunks (HP x 64 k, 12 KB at C=192) full with
//   cp.async.bulk copies that complete on one mbarrier per stage; each
//   consumer warp releases a chunk on a second mbarrier once its wgmma have
//   read it.  No block-wide barrier per k chunk: the consumers meet on a
//   named barrier only between the chain's phases (h0, then 3x3 + 1x1).
// - A from registers: each warp loads its 16 pixels' A fragments with
//   ldmatrix, whose per-lane row addresses do the region gather and the
//   3x3 tap shift (no im2col buffer); B is the staged chunk, K-major core
//   matrices (the wrapper lays the weights out once per weights).  Each
//   chunk feeds two 64-pixel m-tiles per warpgroup, 256 pixels, twice the
//   pixels per staged weight of the mma.sync design.  A region's last pass
//   may take one m-tile per warpgroup; the count is the same in both
//   warpgroups and, like the k steps of a chunk, fixed at compile time: a
//   wgmma under a condition, or behind a function call, is serialised.
// - h1 never touches shared memory: the 3x3's accumulators, biased,
//   activated and rounded to bf16, are the A fragments of the 1x1 that
//   follows (accumulator n-tiles 2ks, 2ks+1 are k step ks), which updates
//   the frame in place.  C-wide products run as C/HP n-blocks of HP.
// - K padding: C/2 -> HP with zero weights; h0's and h1's padding columns
//   are written as exact zeros (0 * NaN is NaN).
// - Epilogues (bias, activation, skip, sigmoid gate) run on the CUDA cores
//   while the tensor cores idle, so their cost counts: the activation is
//   picked once per epilogue at compile time (a runtime choice executed
//   every activation under predicates), and GELU (tanh) and the sigmoid
//   use the special-function unit (tanh.approx, ex2, rcp; errors far below
//   a bf16 ulp).
// - Shared memory at C=192, tile 8x16 (frame 14x22 = 308 pixels): frame
//   308 x 200 + h0 308 x 104 bf16 (rows padded by 8 bf16, so ldmatrix's 8
//   rows fall in distinct banks), 187,264 bytes, + ring 36,864 + barriers:
//   224,176 of the 232,448 a block may have.  One block per SM.
// - Sums in a fixed order per output (k ascending), no atomics, no split-K:
//   two launches give the same bits.
#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHalo = 3;

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

// ---------------------------------------------------------------- bf16 path
// The same chain on Hopper's tensor cores (see the header's bf16 design).
// HP: C/2 rounded up to 16, the width of every wgmma (m64 x HP x k16).

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;                // two warpgroups
constexpr int kMmaThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kMT = 2;                         // m-tiles of 64 per warpgroup
constexpr int kKChunk = 64;                        // k per weight chunk
constexpr int kStages = 3;                     // chunks in the ring

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1 / (1 + e^-v) on the special-function unit (ex2, rcp; rcp(inf) = 0):
// a few fp32 ulps, far below the bf16 ulp of the result.
__device__ __forceinline__ float sigmoid_fast(float v) {
  return rcp_approx(1.f + __expf(-v));
}

// act_fn for the bf16 path with the activation fixed at compile time (3:
// none), so that an epilogue runs one activation, not all of them under
// predicates; gelu (tanh) uses the hardware tanh (relative error ~2^-11, a
// quarter of a bf16 ulp) instead of tanhf's polynomial.
template <int A>
__device__ __forceinline__ float act_c(float v) {
  if constexpr (A == 0) return fmaxf(v, 0.f);
  if constexpr (A == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if constexpr (A == 2) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanh_approx(u));
  }
  return v;
}

// body(std::integral_constant<int, act>{}) for a runtime act in 0 .. 3.
template <class F>
__device__ __forceinline__ void with_act(int act, F&& body) {
  switch (act) {
    case 0: body(std::integral_constant<int, 0>{}); break;
    case 1: body(std::integral_constant<int, 1>{}); break;
    case 2: body(std::integral_constant<int, 2>{}); break;
    default: body(std::integral_constant<int, 3>{}); break;
  }
}

struct MmaChain {
  const bf16* w0; const float* b0;  // (3, HP*C): [n < HP][k < C]
  const bf16* w1; const float* b1;  // (3, HP*9HP): [n < HP][k = tap*HP + ci]
  const bf16* w2; const float* b2;  // (3, nb*HP*HP): nb n-blocks [n][ci < HP]
};

// The ring of weight chunks: a weight matrix [n < HP][k < K] is stored as
// chunks of kKChunk k (the last may be shorter), each in K-major core-matrix
// order (rgba::core_off with kb = kc / 8) and contiguous, so chunk c starts
// HP * kKChunk * c elements in and is one bulk copy.
struct Ring {
  bf16* buf;           // kStages x HP x kKChunk
  uint64_t* full;      // kStages: the chunk landed (producer's bytes)
  uint64_t* empty;     // kStages: the 8 consumer warps are done with it
  int it;              // chunks consumed (or produced) so far
};

__device__ __forceinline__ int n_passes(const Geo& g, int s) {
  const int tiles = (region_size(g, s) + 63) / 64;
  return (tiles + 2 * kMT - 1) / (2 * kMT);
}

// The producer: every chunk of one use of an HP x K matrix, in order.
template <int HP>
__device__ __forceinline__ void produce(Ring& r, const bf16* w, int k_len) {
  for (int k0 = 0; k0 < k_len; k0 += kKChunk, ++r.it) {
    const int s = r.it % kStages;
    rgba::mbar_wait(&r.empty[s], ((r.it / kStages) & 1) ^ 1);
    const int bytes = HP * min(kKChunk, k_len - k0) * 2;
    rgba::mbar_expect(&r.full[s], bytes);
    rgba::bulk_load(r.buf + s * HP * kKChunk, w + HP * k0, bytes, &r.full[s]);
  }
}

// One consumer warpgroup's share of a pass over the region inset by s:
// m-tiles 4 p + wg + 2 i (i < nm) of 64 pixels.  nm is the same in both
// warpgroups (it depends on the region and the pass alone, so the
// compiler sees wgmma under a uniform condition); an m-tile past the
// region's end reads its first pixel and stores nothing.
struct Pass {
  int nm;
  int f_lane[kMT];     // frame pixel of this lane's ldmatrix row
  int f_row[kMT][2];   // frame pixels of this thread's accumulator rows
  bool ok[kMT][2];     // ... and whether they are in the region
};

__device__ __forceinline__ Pass make_pass(const Geo& g, int s, int p) {
  const int np = region_size(g, s);
  const int tiles = (np + 63) / 64;
  const int wg = threadIdx.x / 128, wr = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int lrow = lane % 8 + 8 * ((lane / 8) % 2);
  Pass ps;
  ps.nm = min(kMT, (tiles - 2 * kMT * p + 1) / 2);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int mt = 2 * kMT * p + wg + 2 * i;
    const int q0 = mt * 64 + 16 * wr;
    const int ql = q0 + lrow;
    ps.f_lane[i] = region_pix(g, s, ql < np ? ql : 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + lane / 4 + 8 * r;
      ps.ok[i][r] = q < np;
      ps.f_row[i][r] = region_pix(g, s, q < np ? q : 0);
    }
  }
  return ps;
}

// One chunk of KS k steps at depth k0, for MT m-tiles (all compile-time,
// so no wgmma sits under a condition and the accumulators stay in place):
// A through a_ptr(i, k), this lane's ldmatrix row address for m-tile i.
template <int HP, int MT, int KS, class APtr>
__device__ __forceinline__ void chunk_smem_a(float (&acc)[MT][HP / 2], int k0,
                                             Ring& r, APtr a_ptr) {
  const int s = r.it % kStages;
  uint32_t a[MT][KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < MT; ++i) rgba::ldsm_x4(a[i][kk], a_ptr(i, k0 + 16 * kk));
  rgba::mbar_wait(&r.full[s], (r.it / kStages) & 1);
  const uint64_t desc = rgba::kmajor_desc(r.buf + s * HP * kKChunk, KS * 256);
#pragma unroll
  for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
  rgba::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < MT; ++i) rgba::wgmma_rs<HP>(acc[i], a[i][kk], desc + 16 * kk);
  rgba::wgmma_commit_wait();
#pragma unroll
  for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
  if (threadIdx.x % 32 == 0) rgba::mbar_arrive(&r.empty[s]);
  ++r.it;
}

// acc += A (64 MT x K) x W^T, W the HP x K matrix streaming through the
// ring in chunks of 64 k and a last one of K % 64.
template <int HP, int MT, class APtr>
__device__ __forceinline__ void gemm_smem_a(float (&acc)[MT][HP / 2],
                                            int k_len, Ring& r, APtr a_ptr) {
  int k0 = 0;
  for (; k0 + kKChunk <= k_len; k0 += kKChunk)
    chunk_smem_a<HP, MT, 4>(acc, k0, r, a_ptr);
  switch ((k_len - k0) / 16) {
    case 1: chunk_smem_a<HP, MT, 1>(acc, k0, r, a_ptr); break;
    case 2: chunk_smem_a<HP, MT, 2>(acc, k0, r, a_ptr); break;
    case 3: chunk_smem_a<HP, MT, 3>(acc, k0, r, a_ptr); break;
    default: break;
  }
}

// The same for K = HP with A in registers: a[i][ks] is m-tile i's
// fragment at depth 16 ks; the chunk of KS k steps starts at step K0.
template <int HP, int MT, int KS, int K0>
__device__ __forceinline__ void chunk_reg_a(float (&acc)[MT][HP / 2],
                                            const uint32_t (&a)[MT][HP / 16][4],
                                            Ring& r) {
  const int s = r.it % kStages;
  rgba::mbar_wait(&r.full[s], (r.it / kStages) & 1);
  const uint64_t desc = rgba::kmajor_desc(r.buf + s * HP * kKChunk, KS * 256);
#pragma unroll
  for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
  rgba::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      rgba::wgmma_rs<HP>(acc[i], a[i][K0 + kk], desc + 16 * kk);
  rgba::wgmma_commit_wait();
#pragma unroll
  for (int i = 0; i < MT; ++i) rgba::fence_operands(acc[i]);
  if (threadIdx.x % 32 == 0) rgba::mbar_arrive(&r.empty[s]);
  ++r.it;
}

template <int HP, int MT>
__device__ __forceinline__ void gemm_reg_a(float (&acc)[MT][HP / 2],
                                           const uint32_t (&a)[MT][HP / 16][4],
                                           Ring& r) {
  if constexpr (HP >= 64) chunk_reg_a<HP, MT, 4, 0>(acc, a, r);
  if constexpr (HP % 64 != 0)
    chunk_reg_a<HP, MT, (HP % 64) / 16, HP / 64 * 4>(acc, a, r);
}

template <int HP, int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][HP / 2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < HP / 2; ++e) acc[i][e] = 0.f;
}

__device__ __forceinline__ void consumer_sync() {
  rgba::named_sync(1, kConsumers);
}

// The producer's side of one chain: the chunks in the order run_chain_mma
// consumes them.
template <int HP>
__device__ void produce_chain(Ring& r, const MmaChain& cw, const Geo& g,
                              int nb) {
  const int C = g.c;
  for (int blk = 0; blk < 3; ++blk) {
    for (int p = n_passes(g, blk); p > 0; --p)
      produce<HP>(r, cw.w0 + static_cast<size_t>(blk) * HP * C, C);
    for (int p = n_passes(g, blk + 1); p > 0; --p) {
      produce<HP>(r, cw.w1 + static_cast<size_t>(blk) * 9 * HP * HP, 9 * HP);
      for (int j = 0; j < nb; ++j)
        produce<HP>(r, cw.w2 + (static_cast<size_t>(blk) * nb + j) * HP * HP,
                    HP);
    }
  }
}

// h0 = act(1x1(cur) + b0) for one pass of MT m-tiles; 0 outside the image
// and in the K padding columns HF .. HP.
template <int HP, int MT>
__device__ __forceinline__ void h0_pass(bf16* cur, bf16* h0, Ring& r,
                                        const Pass& ps, const Geo& g,
                                        const float* b0, int act) {
  const int lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4), kl = 8 * (lane / 16);
  float acc[MT][HP / 2];
  zero_acc<HP, MT>(acc);
  gemm_smem_a<HP, MT>(acc, g.c, r, [&](int i, int k) {
    return cur + ps.f_lane[i] * g.ldc + k + kl;
  });
  with_act(act, [&](auto A) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!ps.ok[i][rr]) continue;
        const int f = ps.f_row[i][rr];
        const bool inside = in_image(g, f);
#pragma unroll
        for (int j = 0; j < HP / 8; ++j) {
          const int o = 8 * j + t2;
          const bool live = inside && o < g.half;
          const float v0 = live ? act_c<decltype(A)::value>(acc[i][4 * j + 2 * rr] + b0[o]) : 0.f;
          const float v1 = live ? act_c<decltype(A)::value>(acc[i][4 * j + 2 * rr + 1] + b0[o + 1]) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(h0 + f * g.ldh + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  });
}

// h1 = act(3x3(h0) + b1), kept in registers as the A fragments of cur =
// [act](1x1(h1) + b2 + cur), for one pass of MT m-tiles.
template <int HP, int MT>
__device__ __forceinline__ void conv_pass(bf16* cur, const bf16* h0, Ring& r,
                                          const Pass& ps, const Geo& g,
                                          const float* b1, const float* b2,
                                          int nb, int act, int post_act) {
  const int lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4), kl = 8 * (lane / 16);
  uint32_t h1[MT][HP / 16][4];
  {
    float acc[MT][HP / 2];
    zero_acc<HP, MT>(acc);
    gemm_smem_a<HP, MT>(acc, 9 * HP, r, [&](int i, int k) {
      const int tap = k / HP;
      const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
      return h0 + (ps.f_lane[i] + off) * g.ldh + (k - tap * HP) + kl;
    });
    // accumulator n-tiles 2 ks and 2 ks + 1 are the A fragment of k step
    // ks (rows g, g + 8; k 2t .. and 8 + 2t ..)
    with_act(act, [&](auto A) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int ks = 0; ks < HP / 16; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * ks + e / 2, rr = e % 2;
            const int o = 8 * j + t2;
            const bool live = o < g.half;
            h1[i][ks][e] = rgba::pack_bf16(
                live ? act_c<decltype(A)::value>(acc[i][4 * j + 2 * rr] + b1[o]) : 0.f,
                live ? act_c<decltype(A)::value>(acc[i][4 * j + 2 * rr + 1] + b1[o + 1]) : 0.f);
          }
    });
  }
  for (int nbk = 0; nbk < nb; ++nbk) {
    float acc[MT][HP / 2];
    zero_acc<HP, MT>(acc);
    gemm_reg_a<HP, MT>(acc, h1, r);
    with_act(post_act ? act : 3, [&](auto P) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (!ps.ok[i][rr]) continue;
          bf16* row = cur + ps.f_row[i][rr] * g.ldc;
#pragma unroll
          for (int j = 0; j < HP / 8; ++j) {
            const int o = nbk * HP + 8 * j + t2;
            if (o >= g.c) continue;
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(row + o);
            const float2 skip = __bfloat1622float2(*dst);
            *dst = __floats2bfloat162_rn(
                act_c<decltype(P)::value>(acc[i][4 * j + 2 * rr] + b2[o] + skip.x),
                act_c<decltype(P)::value>(acc[i][4 * j + 2 * rr + 1] + b2[o + 1] + skip.y));
          }
        }
      }
    });
  }
}

// out = x + trunk * sigmoid(1x1(gate) + fb) for one pass over the tile.
template <int HP, int MT>
__device__ __forceinline__ void final_pass(const bf16* cur, Ring& r,
                                           const Pass& ps, const Geo& g,
                                           const bf16* x, const float* fb,
                                           bf16* out, size_t img, int nb) {
  const int lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4), kl = 8 * (lane / 16);
  for (int nbk = 0; nbk < nb; ++nbk) {
    float acc[MT][HP / 2];
    zero_acc<HP, MT>(acc);
    gemm_smem_a<HP, MT>(acc, g.c, r, [&](int i, int k) {
      return cur + ps.f_lane[i] * g.ldc + k + kl;
    });
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!ps.ok[i][rr]) continue;
        const int f = ps.f_row[i][rr];
        const int ir = g.r0 + f / g.fw, ic = g.c0 + f % g.fw;
        if (ir >= g.h || ic >= g.w) continue;
        const size_t base = img + (static_cast<size_t>(ir) * g.w + ic) * g.c;
#pragma unroll
        for (int j = 0; j < HP / 8; ++j) {
          const int o = nbk * HP + 8 * j + t2;
          if (o >= g.c) continue;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + base + o));
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + base + o);
          const float2 tv = __bfloat1622float2(*dst);
          const float s0 = sigmoid_fast(acc[i][4 * j + 2 * rr] + fb[o]);
          const float s1 = sigmoid_fast(acc[i][4 * j + 2 * rr + 1] + fb[o + 1]);
          *dst = __floats2bfloat162_rn(xv.x + tv.x * s0, xv.y + tv.y * s1);
        }
      }
    }
  }
}

// One chain over the frame in `cur`, in place, by the two consumer
// warpgroups; on return the tile holds the chain's output.  A pass takes
// two m-tiles per warpgroup, or one (the same in both warpgroups).
// Inlined: a wgmma pipeline that crosses a function call is serialised.
template <int HP>
__device__ __forceinline__ void run_chain_mma(bf16* cur, bf16* h0, Ring& r, const MmaChain& cw,
                              const Geo& g, int nb, int act, int post_act) {
  for (int blk = 0; blk < 3; ++blk) {
    const float* b0 = cw.b0 + blk * g.half;
    const float* b1 = cw.b1 + blk * g.half;
    const float* b2 = cw.b2 + blk * g.c;
    for (int p = 0, np = n_passes(g, blk); p < np; ++p) {
      const Pass ps = make_pass(g, blk, p);
      if (ps.nm == 2) h0_pass<HP, 2>(cur, h0, r, ps, g, b0, act);
      else h0_pass<HP, 1>(cur, h0, r, ps, g, b0, act);
    }
    consumer_sync();
    for (int p = 0, np = n_passes(g, blk + 1); p < np; ++p) {
      const Pass ps = make_pass(g, blk + 1, p);
      if (ps.nm == 2) conv_pass<HP, 2>(cur, h0, r, ps, g, b1, b2, nb, act, post_act);
      else conv_pass<HP, 1>(cur, h0, r, ps, g, b1, b2, nb, act, post_act);
    }
    consumer_sync();
  }
}

// The frame around the tile, from img (0 outside the image), by the
// consumers with cp.async.
__device__ __forceinline__ void load_frame_async(bf16* cur, const bf16* img,
                                                 const Geo& g) {
  const int q = g.c / 8;  // 16-byte pieces of a pixel
  for (int i = threadIdx.x; i < g.nf * q; i += kConsumers) {
    const int f = i / q, k = i - f * q;
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < g.h && col >= 0 && col < g.w;
    rgba::cp_async16(cur + f * g.ldc + 8 * k,
                     inside ? img + (static_cast<size_t>(r) * g.w + col) * g.c + 8 * k
                            : img, inside);
  }
  rgba::cp_async_commit();
  rgba::cp_async_wait<0>();
  consumer_sync();
}

template <int HP>
__global__ void __launch_bounds__(kMmaThreads, 1)
gate_chain_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gin,
                      MmaChain trunk, MmaChain gate,
                      const bf16* __restrict__ fwt,
                      const float* __restrict__ fb, bf16* out, int h, int w,
                      int c, int th, int tw, int tiles_w, int act,
                      int post_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Geo g;
  g.h = h; g.w = w; g.c = c; g.half = c / 2;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ldc = c + 8;       // 16-byte rows an odd number of 16 bytes apart:
  g.ldh = HP + 8;      // ldmatrix's 8 rows fall in distinct banks
  const int nb = (c + HP - 1) / HP;   // n-blocks of the C-wide products
  bf16* cur = reinterpret_cast<bf16*>(smem_raw);
  bf16* h0 = cur + g.nf * g.ldc;
  const size_t frames = (static_cast<size_t>(g.nf) * (g.ldc + g.ldh) * 2 + 127) / 128 * 128;
  Ring r;
  r.buf = reinterpret_cast<bf16*>(smem_raw + frames);
  r.full = reinterpret_cast<uint64_t*>(r.buf + kStages * HP * kKChunk);
  r.empty = r.full + kStages;
  r.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rgba::mbar_init(&r.full[s], 1);
      rgba::mbar_init(&r.empty[s], kConsumers / 32);
    }
    rgba::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers; one
    // lane walks the consumers' schedule of chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      produce_chain<HP>(r, trunk, g, nb);
      produce_chain<HP>(r, gate, g, nb);
      for (int p = n_passes(g, kHalo); p > 0; --p)
        for (int j = 0; j < nb; ++j)
          produce<HP>(r, fwt + static_cast<size_t>(j) * HP * c, c);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const size_t img = static_cast<size_t>(blockIdx.y) * h * w * c;
  load_frame_async(cur, x + img, g);
  run_chain_mma<HP>(cur, h0, r, trunk, g, nb, act, post_act);

  // the trunk's tile goes to `out`; the final pass below reads it back
  const int q = c / 8;
  for (int i = threadIdx.x; i < th * tw * q; i += kConsumers) {
    const int p = i / q, k = i - p * q;
    const int rr = g.r0 + kHalo + p / tw, col = g.c0 + kHalo + p % tw;
    if (rr < h && col < w)
      *reinterpret_cast<uint4*>(out + img + (static_cast<size_t>(rr) * w + col) * c + 8 * k) =
          *reinterpret_cast<const uint4*>(
              cur + ((kHalo + p / tw) * g.fw + kHalo + p % tw) * g.ldc + 8 * k);
  }
  consumer_sync();

  load_frame_async(cur, (gin ? gin : x) + img, g);
  run_chain_mma<HP>(cur, h0, r, gate, g, nb, act, post_act);

  // out = x + trunk * sigmoid(1x1(gate) + fb) on the tile
  for (int p = 0, np = n_passes(g, kHalo); p < np; ++p) {
    const Pass ps = make_pass(g, kHalo, p);
    if (ps.nm == 2) final_pass<HP, 2>(cur, r, ps, g, x, fb, out, img, nb);
    else final_pass<HP, 1>(cur, r, ps, g, x, fb, out, img, nb);
  }
}

size_t smem_bytes_mma(int c, int th, int tw) {
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  const size_t hp = (c / 2 + 15) / 16 * 16;
  const size_t frames = (nf * ((c + 8) + (hp + 8)) * 2 + 127) / 128 * 128;
  return frames + kStages * hp * kKChunk * 2 + 2 * kStages * sizeof(uint64_t);
}

// ---------------------------------------------------------------- fp32 path
// The same chain at fp32 accuracy on the tensor cores: every product as
// 3xTF32 on wgmma m64nHPk8 (see the header's fp32 design and common.cuh).
// HP: C/2 rounded up to one of 16, 32, 40, 48, 64, 80, 96.

constexpr int kKC32 = 16;   // k per fp32 weight chunk: two k8 steps

// The activation in exact fp32 (erff, tanhf), fixed at compile time (3:
// none), as the plain version computes it.
template <int A>
__device__ __forceinline__ float act_x(float v) {
  if constexpr (A == 0) return fmaxf(v, 0.f);
  if constexpr (A == 1) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if constexpr (A == 2) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(u));
  }
  return v;
}

struct Chain32 {
  const float* w0; const float* b0;  // (3, 2*HP*C): [n < HP][k < C]
  const float* w1; const float* b1;  // (3, 2*HP*9HP): [n < HP][k = tap*HP + ci]
  const float* w2; const float* b2;  // (3, nb*2*HP*HP): [n][k permuted, see h1]
};

// The ring of fp32 weight chunks: a matrix [n < HP][k < K] is stored as
// chunks of kKC32 k (the last may be 8), each the TF32 hi of the chunk in
// K-major core-matrix order (rgba core matrices of 8 rows x 4 fp32)
// followed by its lo, so chunk c starts 2 * HP * kKC32 * c elements in and
// is one bulk copy.  The stage count fills the shared memory the frames
// leave (at least 2).
struct Ring32 {
  float* buf;          // stages x 2 x HP x kKC32
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int it;
};

__device__ __forceinline__ int n_passes32(const Geo& g, int s) {
  return ((region_size(g, s) + 63) / 64 + 1) / 2;
}

template <int HP>
__device__ __forceinline__ void produce32(Ring32& r, const float* w, int k_len) {
  for (int k0 = 0; k0 < k_len; k0 += kKC32, ++r.it) {
    const int s = r.it % r.stages;
    rgba::mbar_wait(&r.empty[s], ((r.it / r.stages) & 1) ^ 1);
    const int bytes = 2 * HP * min(kKC32, k_len - k0) * 4;
    rgba::mbar_expect(&r.full[s], bytes);
    rgba::bulk_load(r.buf + s * 2 * HP * kKC32, w + 2 * HP * k0, bytes, &r.full[s]);
  }
}

// One m-tile per warpgroup and pass: m-tile 2 p + wg of 64 pixels; one
// past the region's end reads its first pixel and stores nothing.
struct Pass32 {
  int f_lane;          // frame pixel of this lane's ldmatrix row
  int f_row[2];        // frame pixels of this thread's accumulator rows
  bool ok[2];
};

__device__ __forceinline__ Pass32 make_pass32(const Geo& g, int s, int p) {
  const int np = region_size(g, s);
  const int wg = threadIdx.x / 128, wr = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (2 * p + wg) * 64 + 16 * wr;
  const int ql = q0 + lane % 8 + 8 * ((lane / 8) % 2);
  Pass32 ps;
  ps.f_lane = region_pix(g, s, ql < np ? ql : 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + lane / 4 + 8 * r;
    ps.ok[r] = q < np;
    ps.f_row[r] = region_pix(g, s, q < np ? q : 0);
  }
  return ps;
}

// Issue one chunk's KS k steps from split A fragments hi / lo, then release
// the chunk.
template <int HP, int KS>
__device__ __forceinline__ void chunk32_issue(float (&acc)[HP / 2],
                                              const uint32_t (&hi)[KS][4],
                                              const uint32_t (&lo)[KS][4],
                                              Ring32& r) {
  const int s = r.it % r.stages;
  rgba::mbar_wait(&r.full[s], (r.it / r.stages) & 1);
  const float* b = r.buf + s * 2 * HP * kKC32;
  const uint64_t bh = rgba::kmajor_desc(b, KS * 256);
  const uint64_t bl = rgba::kmajor_desc(b + HP * 8 * KS, KS * 256);
  rgba::fence_operands(acc);
  rgba::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    rgba::wgmma_3xtf32<HP>(acc, hi[kk], lo[kk], bh + 16 * kk, bl + 16 * kk);
  rgba::wgmma_commit_wait();
  rgba::fence_operands(acc);
  if (threadIdx.x % 32 == 0) rgba::mbar_arrive(&r.empty[s]);
  ++r.it;
}

// acc += A (64 x K) x W^T with A from shared memory through a_ptr(k), this
// lane's ldmatrix row address at depth k (a multiple of 8).
template <int HP, int KS, class APtr>
__device__ __forceinline__ void chunk32_smem_a(float (&acc)[HP / 2], int k0,
                                               Ring32& r, APtr a_ptr) {
  uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    rgba::ldsm_x4(a, a_ptr(k0 + 8 * kk));
    rgba::split_tf32(a, hi[kk], lo[kk]);
  }
  chunk32_issue<HP, KS>(acc, hi, lo, r);
}

template <int HP, class APtr>
__device__ __forceinline__ void gemm32_smem_a(float (&acc)[HP / 2], int k_len,
                                              Ring32& r, APtr a_ptr) {
  int k0 = 0;
  for (; k0 + kKC32 <= k_len; k0 += kKC32) chunk32_smem_a<HP, 2>(acc, k0, r, a_ptr);
  if (k0 < k_len) chunk32_smem_a<HP, 1>(acc, k0, r, a_ptr);
}

// The same with A = h1 in registers, in the 3x3's accumulator layout: k
// step j of the following 1x1 takes n-tile j, whose lane holds channels
// 8 j + 2 q, 8 j + 2 q + 1 (q = lane % 4) of rows g and g + 8.  As a TF32
// A fragment they are read as k 8 j + q and 8 j + q + 4: the wrapper
// permutes that 1x1's k within each 8 to match (gate_chain.py, H1_ORDER).
template <int HP, int KS, int J0>
__device__ __forceinline__ void chunk32_reg_a(float (&acc)[HP / 2],
                                              const float (&h1)[HP / 2],
                                              Ring32& r) {
  uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int j = J0 + kk;
    const uint32_t a[4] = {__float_as_uint(h1[4 * j]), __float_as_uint(h1[4 * j + 2]),
                           __float_as_uint(h1[4 * j + 1]), __float_as_uint(h1[4 * j + 3])};
    rgba::split_tf32(a, hi[kk], lo[kk]);
  }
  chunk32_issue<HP, KS>(acc, hi, lo, r);
}

template <int HP, int C = 0>
__device__ __forceinline__ void gemm32_reg_a(float (&acc)[HP / 2],
                                             const float (&h1)[HP / 2], Ring32& r) {
  if constexpr (kKC32 * (C + 1) <= HP) {
    chunk32_reg_a<HP, 2, 2 * C>(acc, h1, r);
    gemm32_reg_a<HP, C + 1>(acc, h1, r);
  } else if constexpr (kKC32 * C < HP) {
    chunk32_reg_a<HP, 1, 2 * C>(acc, h1, r);
  }
}

template <int R>
__device__ __forceinline__ void zero32(float (&acc)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;
}

template <int HP>
__device__ void produce_chain32(Ring32& r, const Chain32& cw, const Geo& g,
                                int nb) {
  const int C = g.c;
  for (int blk = 0; blk < 3; ++blk) {
    for (int p = n_passes32(g, blk); p > 0; --p)
      produce32<HP>(r, cw.w0 + static_cast<size_t>(blk) * 2 * HP * C, C);
    for (int p = n_passes32(g, blk + 1); p > 0; --p) {
      produce32<HP>(r, cw.w1 + static_cast<size_t>(blk) * 2 * 9 * HP * HP, 9 * HP);
      for (int j = 0; j < nb; ++j)
        produce32<HP>(r, cw.w2 + (static_cast<size_t>(blk) * nb + j) * 2 * HP * HP,
                      HP);
    }
  }
}

// h0 = act(1x1(cur) + b0) for one pass; 0 outside the image and in the K
// padding columns HF .. HP.
template <int HP>
__device__ __forceinline__ void h0_pass32(const float* cur, float* h0, Ring32& r,
                                          const Pass32& ps, const Geo& g,
                                          const float* b0, int act) {
  const int lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4), kl = 4 * (lane / 16);
  float acc[HP / 2];
  zero32(acc);
  gemm32_smem_a<HP>(acc, g.c, r, [&](int k) {
    return cur + ps.f_lane * g.ldc + k + kl;
  });
  with_act(act, [&](auto A) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!ps.ok[rr]) continue;
      const int f = ps.f_row[rr];
      const bool inside = in_image(g, f);
#pragma unroll
      for (int j = 0; j < HP / 8; ++j) {
        const int o = 8 * j + t2;
        const bool live = inside && o < g.half;
        *reinterpret_cast<float2*>(h0 + f * g.ldh + o) = make_float2(
            live ? act_x<decltype(A)::value>(acc[4 * j + 2 * rr] + b0[o]) : 0.f,
            live ? act_x<decltype(A)::value>(acc[4 * j + 2 * rr + 1] + b0[o + 1]) : 0.f);
      }
    }
  });
}

// h1 = act(3x3(h0) + b1), kept in registers in the accumulators' layout,
// then cur = [act](1x1(h1) + b2 + cur) per n-block of HP outputs.
template <int HP>
__device__ __forceinline__ void conv_pass32(float* cur, const float* h0, Ring32& r,
                                            const Pass32& ps, const Geo& g,
                                            const float* b1, const float* b2,
                                            int nb, int act, int post_act) {
  const int lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4), kl = 4 * (lane / 16);
  float h1[HP / 2];
  zero32(h1);
  gemm32_smem_a<HP>(h1, 9 * HP, r, [&](int k) {
    const int tap = k / HP;
    const int off = (tap / 3 - 1) * g.fw + (tap % 3 - 1);
    return h0 + (ps.f_lane + off) * g.ldh + (k - tap * HP) + kl;
  });
  with_act(act, [&](auto A) {
#pragma unroll
    for (int j = 0; j < HP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * j + t2 + e % 2;
        h1[4 * j + e] = o < g.half ? act_x<decltype(A)::value>(h1[4 * j + e] + b1[o]) : 0.f;
      }
  });
  for (int nbk = 0; nbk < nb; ++nbk) {
    float acc[HP / 2];
    zero32(acc);
    gemm32_reg_a<HP>(acc, h1, r);
    with_act(post_act ? act : 3, [&](auto P) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!ps.ok[rr]) continue;
        float* row = cur + ps.f_row[rr] * g.ldc;
#pragma unroll
        for (int j = 0; j < HP / 8; ++j) {
          const int o = nbk * HP + 8 * j + t2;
          if (o >= g.c) continue;
          float2* dst = reinterpret_cast<float2*>(row + o);
          const float2 skip = *dst;
          *dst = make_float2(
              act_x<decltype(P)::value>(acc[4 * j + 2 * rr] + b2[o] + skip.x),
              act_x<decltype(P)::value>(acc[4 * j + 2 * rr + 1] + b2[o + 1] + skip.y));
        }
      }
    });
  }
}

// out = x + trunk * sigmoid(1x1(gate) + fb) for one pass over the tile.
template <int HP>
__device__ __forceinline__ void final_pass32(const float* cur, Ring32& r,
                                             const Pass32& ps, const Geo& g,
                                             const float* x, const float* fb,
                                             float* out, size_t img, int nb) {
  const int lane = threadIdx.x % 32;
  const int t2 = 2 * (lane % 4), kl = 4 * (lane / 16);
  for (int nbk = 0; nbk < nb; ++nbk) {
    float acc[HP / 2];
    zero32(acc);
    gemm32_smem_a<HP>(acc, g.c, r, [&](int k) {
      return cur + ps.f_lane * g.ldc + k + kl;
    });
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!ps.ok[rr]) continue;
      const int f = ps.f_row[rr];
      const int ir = g.r0 + f / g.fw, ic = g.c0 + f % g.fw;
      if (ir >= g.h || ic >= g.w) continue;
      const size_t base = img + (static_cast<size_t>(ir) * g.w + ic) * g.c;
#pragma unroll
      for (int j = 0; j < HP / 8; ++j) {
        const int o = nbk * HP + 8 * j + t2;
        if (o >= g.c) continue;
        const float2 xv = *reinterpret_cast<const float2*>(x + base + o);
        float2* dst = reinterpret_cast<float2*>(out + base + o);
        const float2 tv = *dst;
        const float s0 = 1.f / (1.f + expf(-(acc[4 * j + 2 * rr] + fb[o])));
        const float s1 = 1.f / (1.f + expf(-(acc[4 * j + 2 * rr + 1] + fb[o + 1])));
        *dst = make_float2(xv.x + tv.x * s0, xv.y + tv.y * s1);
      }
    }
  }
}

template <int HP>
__device__ __forceinline__ void run_chain32(float* cur, float* h0, Ring32& r,
                                            const Chain32& cw, const Geo& g,
                                            int nb, int act, int post_act) {
  for (int blk = 0; blk < 3; ++blk) {
    const float* b0 = cw.b0 + blk * g.half;
    const float* b1 = cw.b1 + blk * g.half;
    const float* b2 = cw.b2 + blk * g.c;
    for (int p = 0, np = n_passes32(g, blk); p < np; ++p)
      h0_pass32<HP>(cur, h0, r, make_pass32(g, blk, p), g, b0, act);
    consumer_sync();
    for (int p = 0, np = n_passes32(g, blk + 1); p < np; ++p)
      conv_pass32<HP>(cur, h0, r, make_pass32(g, blk + 1, p), g, b1, b2, nb,
                      act, post_act);
    consumer_sync();
  }
}

// The fp32 frame around the tile (0 outside the image), by the consumers.
__device__ __forceinline__ void load_frame32(float* cur, const float* img,
                                             const Geo& g) {
  const int q = g.c / 4;  // 16-byte pieces of a pixel
  for (int i = threadIdx.x; i < g.nf * q; i += kConsumers) {
    const int f = i / q, k = i - f * q;
    const int r = g.r0 + f / g.fw, col = g.c0 + f % g.fw;
    const bool inside = r >= 0 && r < g.h && col >= 0 && col < g.w;
    rgba::cp_async16(cur + f * g.ldc + 4 * k,
                     inside ? img + (static_cast<size_t>(r) * g.w + col) * g.c + 4 * k
                            : img, inside);
  }
  rgba::cp_async_commit();
  rgba::cp_async_wait<0>();
  consumer_sync();
}

__host__ __device__ inline size_t frames32_bytes(int c, int hp, int th, int tw) {
  const size_t nf = static_cast<size_t>(th + 2 * kHalo) * (tw + 2 * kHalo);
  return (nf * ((c + 4) + (hp + 4)) * 4 + 127) / 128 * 128;
}

template <int HP>
__global__ void __launch_bounds__(kMmaThreads, 1)
gate_chain_tf32_kernel(const float* __restrict__ x, const float* __restrict__ gin,
                       Chain32 trunk, Chain32 gate, const float* __restrict__ fwt,
                       const float* __restrict__ fb, float* out, int h, int w,
                       int c, int th, int tw, int tiles_w, int stages, int act,
                       int post_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Geo g;
  g.h = h; g.w = w; g.c = c; g.half = c / 2;
  g.th = th; g.tw = tw; g.fw = tw + 2 * kHalo;
  g.nf = (th + 2 * kHalo) * g.fw;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x % tiles_w;
  g.r0 = ti * th - kHalo;
  g.c0 = tj * tw - kHalo;
  g.ldc = c + 4;       // 16-byte rows an odd number of 16 bytes apart:
  g.ldh = HP + 4;      // ldmatrix's 8 rows fall in distinct banks
  const int nb = (c + HP - 1) / HP;
  float* cur = reinterpret_cast<float*>(smem_raw);
  float* h0 = cur + g.nf * g.ldc;
  Ring32 r;
  r.buf = reinterpret_cast<float*>(smem_raw + frames32_bytes(c, HP, th, tw));
  r.full = reinterpret_cast<uint64_t*>(r.buf + stages * 2 * HP * kKC32);
  r.empty = r.full + stages;
  r.stages = stages;
  r.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      rgba::mbar_init(&r.full[s], 1);
      rgba::mbar_init(&r.empty[s], kConsumers / 32);
    }
    rgba::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      produce_chain32<HP>(r, trunk, g, nb);
      produce_chain32<HP>(r, gate, g, nb);
      for (int p = n_passes32(g, kHalo); p > 0; --p)
        for (int j = 0; j < nb; ++j)
          produce32<HP>(r, fwt + static_cast<size_t>(j) * 2 * HP * c, c);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const size_t img = static_cast<size_t>(blockIdx.y) * h * w * c;
  load_frame32(cur, x + img, g);
  run_chain32<HP>(cur, h0, r, trunk, g, nb, act, post_act);

  const int q = c / 4;
  for (int i = threadIdx.x; i < th * tw * q; i += kConsumers) {
    const int p = i / q, k = i - p * q;
    const int rr = g.r0 + kHalo + p / tw, col = g.c0 + kHalo + p % tw;
    if (rr < h && col < w)
      *reinterpret_cast<float4*>(out + img + (static_cast<size_t>(rr) * w + col) * c + 4 * k) =
          *reinterpret_cast<const float4*>(
              cur + ((kHalo + p / tw) * g.fw + kHalo + p % tw) * g.ldc + 4 * k);
  }
  consumer_sync();

  load_frame32(cur, (gin ? gin : x) + img, g);
  run_chain32<HP>(cur, h0, r, gate, g, nb, act, post_act);

  for (int p = 0, np = n_passes32(g, kHalo); p < np; ++p)
    final_pass32<HP>(cur, r, make_pass32(g, kHalo, p), g, x, fb, out, img, nb);
}

int launch_bf16(const void* x, const void* g, const void* const* tw_,
                const void* const* gw_, const void* fw, const void* fb,
                void* out, int b, int h, int w, int c, int act, int post_act,
                int max_smem, cudaStream_t stream) {
  static const int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {6, 8},
                                  {4, 8}, {4, 4}, {2, 4}};
  int th = 0, tw = 0;
  size_t smem = 0;
  for (const auto& t : kTiles) {
    smem = smem_bytes_mma(c, t[0], t[1]);
    if (smem <= static_cast<size_t>(max_smem)) { th = t[0]; tw = t[1]; break; }
  }
  if (!th) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  dim3 grid(tiles_h * tiles_w, b);
  auto chain = [](const void* const* p) {
    return MmaChain{static_cast<const bf16*>(p[0]), static_cast<const float*>(p[1]),
                    static_cast<const bf16*>(p[2]), static_cast<const float*>(p[3]),
                    static_cast<const bf16*>(p[4]), static_cast<const float*>(p[5])};
  };
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), chain(tw_),
        chain(gw_), static_cast<const bf16*>(fw), static_cast<const float*>(fb),
        static_cast<bf16*>(out), h, w, c, th, tw, tiles_w, act, post_act);
  };
  switch ((c / 2 + 15) / 16 * 16) {
    case 16: run(gate_chain_mma_kernel<16>); break;
    case 32: run(gate_chain_mma_kernel<32>); break;
    case 48: run(gate_chain_mma_kernel<48>); break;
    case 64: run(gate_chain_mma_kernel<64>); break;
    case 80: run(gate_chain_mma_kernel<80>); break;
    case 96: run(gate_chain_mma_kernel<96>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// HP of the fp32 path: C/2 rounded up to one of its instantiations.
int hp32(int c) {
  for (int hp : {16, 32, 40, 48, 64, 80, 96})
    if (2 * hp >= c) return hp;
  return 0;
}

int launch_tf32(const void* x, const void* g, const void* const* tw_,
                const void* const* gw_, const void* fw, const void* fb,
                void* out, int b, int h, int w, int c, int act, int post_act,
                int max_smem, cudaStream_t stream) {
  static const int kTiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {6, 8},
                                  {4, 8}, {4, 4}, {2, 4}};
  constexpr int kMaxStages = 6;
  const int hp = hp32(c);
  if (!hp) return static_cast<int>(cudaErrorInvalidValue);
  const size_t stage = 2 * static_cast<size_t>(hp) * kKC32 * 4 + 2 * sizeof(uint64_t);
  int th = 0, tw = 0, stages = 0;
  size_t frames = 0;
  for (const auto& t : kTiles) {
    frames = frames32_bytes(c, hp, t[0], t[1]);
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
  auto chain = [](const void* const* p) {
    return Chain32{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
                   static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
                   static_cast<const float*>(p[4]), static_cast<const float*>(p[5])};
  };
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), chain(tw_),
        chain(gw_), static_cast<const float*>(fw), static_cast<const float*>(fb),
        static_cast<float*>(out), h, w, c, th, tw, tiles_w, stages, act, post_act);
  };
  switch (hp) {
    case 16: run(gate_chain_tf32_kernel<16>); break;
    case 32: run(gate_chain_tf32_kernel<32>); break;
    case 40: run(gate_chain_tf32_kernel<40>); break;
    case 48: run(gate_chain_tf32_kernel<48>); break;
    case 64: run(gate_chain_tf32_kernel<64>); break;
    case 80: run(gate_chain_tf32_kernel<80>); break;
    case 96: run(gate_chain_tf32_kernel<96>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (b, h, w, c) contiguous NHWC in the activation dtype (fp32 or
// bf16), 16-byte aligned; g: the same, or null for g = x.  trunk / gate: 6
// pointers each, w0 b0 w1 b1 w2 b2, biases fp32, b0 (3, C/2), b1 (3, C/2),
// b2 (3, C).  Each weight matrix is [out][in] with zero rows and columns up
// to HP (n-blocks of HP rows for the C-wide products), laid out by the
// Python wrapper (gate_chain.kernel_weights).  bf16: as in MmaChain and fw
// (nb, HP*c), in chunks of 64 k in K-major core-matrix order (see Ring).
// fp32: as in Chain32 and fw (nb, 2*HP*c), in chunks of 16 k, each its TF32
// hi then lo in K-major core matrices of 8 x 4 (see Ring32), the k of each
// w2 permuted within groups of 8 (see chunk32_reg_a).  act: 0 relu, 1 gelu
// (erf), 2 gelu (tanh).  c <= 192, a multiple of 16 in bf16 and of 8 in
// fp32 (checked by the Python wrapper).
extern "C" int rgba_gate_chain(const void* x, const void* g,
                               const void* const* trunk,
                               const void* const* gate, const void* fw,
                               const void* fb, void* out, int b, int h, int w,
                               int c, int act, int post_act, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bf16)
    return launch_bf16(x, g, trunk, gate, fw, fb, out, b, h, w, c, act,
                       post_act, max_smem, s);
  return launch_tf32(x, g, trunk, gate, fw, fb, out, b, h, w, c, act,
                     post_act, max_smem, s);
}
