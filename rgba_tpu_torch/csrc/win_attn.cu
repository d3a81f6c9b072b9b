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
// bf16 design (win_attn_mma_kernel): all four products on the tensor cores
// (bf16 in, fp32 accumulate), on a persistent grid of 8-warp blocks.
// - Alive list on the device: every block scans `alive` once (a block-wide
//   prefix count, no host sync) and keeps the windows it owns: alive
//   windows in groups of `wb` consecutive ranks (2 windows of N=64, 8 of
//   N=16: 128 token rows), dealt round robin over the blocks, and dead
//   windows, which it fills with zeros.
// - Projections on wgmma: per group, the tokens stay in shared memory in
//   bf16 as K-major core matrices (C padded with zero columns to the
//   16-deep K step), and the qkv projection runs head by head, each of the
//   two warpgroups taking 64 rows in one m64n96k16 (hd=24) or m64n48k16
//   (hd=10) per k step.  Head dims are padded with zero weight rows to 32
//   or 16: zero q/k columns leave the scores unchanged.  q and k of the
//   head go to shared memory in bf16, v transposed (the B operand of P.V).
//   The output projection reads the concatenated head outputs, also kept
//   as core matrices, in chunks of the same width.
// - Scores and softmax in registers, as flash attention, on mma.sync
//   m16n8k16: a warp owns 16 query rows of one window, S = Q K^T stays in
//   accumulator fragments, takes the fp32 scale, rel_bias (fp32, loaded
//   into registers while the head's projection runs) and the -100 region
//   mask (bits made once per group), reduces max and sum over the quad with
//   shuffles, and P, rounded to bf16, is reused in registers as the A
//   fragments of P.V.  Bias and gate end the projection; the output goes
//   back into the token buffer and out 16 bytes a thread.
// - Weights: the wrapper lays them out [out][in] as core matrices (per
//   head, q|k|v rows of hdp each), so each stage (one head's qkv weights,
//   or one chunk of the projection's) is one contiguous block, copied by
//   cp.async into one of two shared buffers while the previous stage
//   computes.  Biases and the group's alive gates sit in shared memory.
// - Sums in a fixed order, no atomics: the same inputs give the same bits.
//
// fp32 design (win_attn_tf32_kernel<KT, NS>): the bf16 design's skeleton
// (persistent grid, the alive list scanned on the device, dead windows
// written as exact zeros, groups of windows filling 64-row m-tiles) with
// every product at fp32 accuracy on the tensor cores as 3xTF32
// (common.cuh: hi = the nearest TF32 value, lo = the remainder's; terms
// a_lo b_hi, a_hi b_lo, a_hi b_hi in that order, fixed-order sums).  In
// fp32 the bound is 3 x 22.0 MFLOP per alive window at the TF32 peak: 0.50
// ms at batch 16, 512x768.
// - Shared memory sets the shape.  fp32 tokens of one 64-row group take
//   50,176 bytes (rows padded by 4 fp32), and the weights' hi + lo for one
//   head's q | k | v (72 rows x 192 k at hd 24) 110,592: a double buffer of
//   whole head stages does not fit beside them.  So a block takes one
//   64-row group (1 window of N=64 or 4 of N=16) and splits its heads over
//   two consumer warpgroups (even and odd heads; the output projection's
//   chunks likewise), each with its own q, k, v buffers and its own ring of
//   weight chunks, fed by its own producer warp: one warpgroup's scores
//   and softmax overlap the other's projections (one warpgroup running
//   all heads ran slower on the H100), and each weight chunk is still read
//   from L2 once per group.  The wrapper lays the weights' hi
//   and lo out once per weights (win_attn.kernel_weights: each head's q|k|v
//   rows, hd padded to a multiple of 8, and the output projection in
//   chunks of NS = 3 hdp rows, each cut into chunks of 16 k); a producer
//   lane streams its group's chunks (9,216 bytes at NS=72) with
//   cp.async.bulk into a ring of up to 4 stages on mbarriers, in the order
//   its consumers take them.  Budget at N=64, C=192: tokens 50,176 + head
//   outputs 50,176 + 2 x q, k, v 55,296 + 2 rings of 3 stages 55,392 +
//   biases, region ids and lists ~3,700: 214,760 bytes, one block per SM.
//   320 threads leave 204 registers a thread, enough without spills (the
//   producers are single warps, so setmaxnreg, which works per warpgroup,
//   does not apply).
// - Projections on wgmma m64nNSk8 (q|k|v of a head, and each output
//   chunk), A from shared memory by ldmatrix (an 8 x 8 b16 tile is 8 rows of
//   4 fp32: each lane gets its TF32 A fragment) split in registers.
// - Scores and P.V on mma.sync m16n8k8 TF32, three terms each, one warp per
//   16 query rows, so a warp owns one window of N=16 (wgmma would compute
//   all 64 x 64 pairs of 4 windows).  S stays in registers; the fp32 scale,
//   rel_bias (loaded into registers while the head's projection runs) and
//   the -100 region mask are added in fp32, the softmax reduces in fp32 over
//   the quad, and P (fp32) is reused in registers as the A fragments of
//   P.V: slots q and q + 4 of a k step hold keys 2q and 2q + 1, and V's
//   rows are read in that order.  Head outputs go to shared memory, where
//   the output projection reads them.
// - Each block streams all weights once per group from L2 (1.18 MB of hi +
//   lo at C=192, 4.4 GB at batch 16): that L2 traffic, not HBM, is the
//   next limit.
// - Sums in a fixed order, no atomics, no split-K: a window gives the same
//   bits in any batch and any launch.
#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- fp32 path
constexpr int kCons = 256;                // two consumer warpgroups: heads apart
constexpr int kThreads32 = kCons + 64;    // + one producer warp per warpgroup
constexpr int kLdh = 36;                  // row stride of q, k, v (fp32; <= 32 used)
constexpr int kMaxStages = 4;             // per warpgroup's ring

struct Geo32 {
  int nw, n, np, c, nh, hd;  // np: n rounded up to 16
  int wb;                    // windows per group (wb * np <= 64)
  int ko;                    // nh * hdp: the head outputs' padded width
  int nco;                   // output-projection chunks of NS rows
  int ldx, ldo;              // row strides of tokens and head outputs
  int stages, cap_a, cap_d;  // stages of each ring; alive / dead list entries per block
};

// This lane's ldmatrix row within a warp's 16 rows and its fp32 column
// offset (see rgba::a_row): the TF32 A fragment of rows 16 w .. 16 w + 15.
__device__ __forceinline__ int lane_row() {
  const int l = threadIdx.x % 32;
  return l % 8 + 8 * ((l / 8) % 2);
}
__device__ __forceinline__ int lane_k() { return 4 * ((threadIdx.x % 32) / 16); }

// KT: key tiles of 8 held in registers (np <= 8 KT); NS = 3 hdp: the
// width of a qkv stage and of an output-projection chunk.
template <int KT, int NS>
__global__ void __launch_bounds__(kThreads32, 1)
win_attn_tf32_kernel(const float* __restrict__ tokens,
                     const int* __restrict__ region,
                     const float* __restrict__ alive,
                     const float* __restrict__ wqkv,
                     const float* __restrict__ bqkv,
                     const float* __restrict__ wproj,
                     const float* __restrict__ bproj,
                     const float* __restrict__ rel_bias,
                     float* __restrict__ out, Geo32 g, float scale) {
  constexpr int HT = NS / 24;  // n-tiles of 8 per head dim (hdp = 8 HT)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int warp_count[kThreads32 / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // consumer warpgroup 0 or 1 (warps 0-3, 4-7), or the one a producer warp
  // (8, 9) feeds
  const int wg = warp < 8 ? warp / 4 : warp - 8;
  const int stage = 2 * NS * rgba::kChunkK;
  float* rings = reinterpret_cast<float*>(smem_raw);         // 2 x stages x stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + 2 * g.stages * stage);
  rgba::ChunkRing r;                  // this warpgroup's ring
  r.buf = rings + wg * g.stages * stage;
  r.full = bars + wg * 2 * g.stages;
  r.empty = r.full + g.stages;
  r.stages = g.stages;
  r.it = 0;
  float* xs = reinterpret_cast<float*>(bars + 4 * g.stages);  // 64 x ldx tokens
  float* os = xs + 64 * g.ldx;        // 64 x ldo head outputs
  float* qs = os + 64 * g.ldo + wg * 3 * 64 * kLdh;  // 64 x kLdh, then ks, vs
  float* ks = qs + 64 * kLdh;
  float* vs = ks + 64 * kLdh;
  float* bsm = os + 64 * g.ldo + 6 * 64 * kLdh;      // bqkv | bproj
  float* gates = bsm + 4 * g.c;       // 4: alive of the group's windows
  int* reg = reinterpret_cast<int*>(gates + 4);  // 64 region ids
  int* alist = reg + 64;              // cap_a
  int* dlist = alist + g.cap_a;       // cap_d

  const int gq = lane / 4, t2 = 2 * (lane % 4);
  const int nblk = gridDim.x;
  if (threadIdx.x == kCons) rgba::ring_init(r, 4);
  if (threadIdx.x == kCons + 32) rgba::ring_init(r, 4);
  for (int i = threadIdx.x; i < 4 * g.c; i += kThreads32)
    bsm[i] = i < 3 * g.c ? bqkv[i] : bproj[i - 3 * g.c];

  // alive windows by rank: group r / wb belongs to block (r / wb) % nblk;
  // dead windows by rank: block rank % nblk (as the bf16 kernel)
  int n_alive = 0;
  for (int w0 = 0; w0 < g.nw; w0 += kThreads32) {
    const int w = w0 + threadIdx.x;
    const bool a = w < g.nw && alive[w] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, a);
    if (lane == 0) warp_count[warp] = __popc(bal);
    __syncthreads();
    int before = n_alive + __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int i = 0; i < kThreads32 / 32; ++i) {
      if (i < warp) before += warp_count[i];
      total += warp_count[i];
    }
    if (w < g.nw) {
      if (a) {
        const int grp = before / g.wb;
        if (grp % nblk == static_cast<int>(blockIdx.x))
          alist[(grp / nblk) * g.wb + before % g.wb] = w;
      } else {
        const int rd = w - before;
        if (rd % nblk == static_cast<int>(blockIdx.x)) dlist[rd / nblk] = w;
      }
    }
    n_alive += total;
    __syncthreads();  // warp_count is rewritten; lists, biases, ring ready
  }
  const int n_groups = (n_alive + g.wb - 1) / g.wb;

  if (warp >= kCons / 32) {  // producers: each group's chunks in its order
    if (lane == 0)
      for (int grp = blockIdx.x; grp < n_groups; grp += nblk) {
        for (int h = wg; h < g.nh; h += 2)
          rgba::ring_produce<NS>(r, wqkv + static_cast<size_t>(h) * 2 * NS * g.c, g.c);
        for (int oc = wg; oc < g.nco; oc += 2)
          rgba::ring_produce<NS>(r, wproj + static_cast<size_t>(oc) * 2 * NS * g.ko, g.ko);
      }
    return;
  }

  // dead windows: exact zeros
  const int vec = g.n * g.c / 4;  // 16-byte pieces of a window
  for (int i = 0; static_cast<int>(blockIdx.x) + i * nblk < g.nw - n_alive; ++i) {
    float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(dlist[i]) * g.n * g.c);
    for (int e = threadIdx.x; e < vec; e += kCons) o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (static_cast<int>(blockIdx.x) >= n_groups) return;

  const int chunks = g.c / 4;  // 16-byte pieces of a token row
  auto load_tokens = [&](int gi, int grp) {
    const int nwin = min(g.wb, n_alive - grp * g.wb);
    const int* wins = alist + gi * g.wb;
    for (int i = threadIdx.x; i < 64 * chunks; i += kCons) {
      const int row = i / chunks, q = i - row * chunks;
      const int wi = row / g.np, rr = row - wi * g.np;
      const bool ok = wi < nwin && rr < g.n;
      const float* src =
          ok ? tokens + (static_cast<size_t>(wins[wi]) * g.n + rr) * g.c + 4 * q : tokens;
      rgba::cp_async16(xs + row * g.ldx + 4 * q, src, ok);
    }
    rgba::cp_async_commit();
  };

  const int q0 = 16 * (warp % 4);               // this warp's first row
  const int wi = q0 / g.np, kb = wi * g.np;     // its window, the window's first row
  const int nkt = g.np / 8;
  const int lr = lane_row(), lk = lane_k();
  unsigned diff[2] = {0u, 0u};  // this thread's region-mask bits (see below)
  load_tokens(0, blockIdx.x);
  for (int gi = 0, grp = blockIdx.x; grp < n_groups; ++gi, grp += nblk) {
    const int nwin = min(g.wb, n_alive - grp * g.wb);
    const int* wins = alist + gi * g.wb;
    rgba::named_sync(1, kCons);  // the previous group's gates and region ids are read
    if (threadIdx.x < 4)
      gates[threadIdx.x] = threadIdx.x < nwin ? alive[wins[threadIdx.x]] : 0.f;
    for (int row = threadIdx.x; row < 64; row += kCons) {
      const int w = row / g.np, rr = row - w * g.np;
      reg[row] = (w < nwin && rr < g.n)
                     ? region[static_cast<size_t>(wins[w]) * g.n + rr] : 0;
    }
    rgba::cp_async_wait<0>();
    // generic-proxy writes (cp.async) before wgmma reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    rgba::named_sync(1, kCons);  // tokens, gates and region ids in place

    for (int h = wg; h < g.nh; h += 2) {  // the heads of this warpgroup
      // this warp's rel_bias values load now and land while the q | k | v
      // projection runs
      float2 rbv[KT][2];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 - kb + gq + 8 * e, kc = 8 * j + t2;
          rbv[j][e] = (wi < nwin && j < nkt && qi < g.n && kc < g.n)
              ? __ldg(reinterpret_cast<const float2*>(
                    rel_bias + (static_cast<size_t>(h) * g.n + qi) * g.n + kc))
              : make_float2(0.f, 0.f);
        }
      float acc[NS / 2];
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
      rgba::ring_gemm_smem_a<NS>(acc, g.c, r, [&](int k) {
        return xs + (q0 + lr) * g.ldx + k + lk;
      });
      rgba::named_sync(2 + wg, 128);  // the group's warps are done with its last q, k, v
      // q | k | v of head h, + bias (0 in the head dims' padding columns)
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int part = j / HT, d = 8 * (j - part * HT) + t2;
        const float* bq = bsm + part * g.c + h * g.hd;
        const float b0 = d < g.hd ? bq[d] : 0.f;
        const float b1 = d + 1 < g.hd ? bq[d + 1] : 0.f;
        float* dst = part == 0 ? qs : part == 1 ? ks : vs;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(dst + (q0 + gq + 8 * e) * kLdh + d) =
              make_float2(acc[4 * j + 2 * e] + b0, acc[4 * j + 2 * e + 1] + b1);
      }
      rgba::named_sync(2 + wg, 128);  // q, k, v of head h complete

      if (wi < nwin) {  // the same for the whole warp
        if (h == wg) {  // region ids differ: bit 2j+e for key 8j+t2+e, per row
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rq = reg[q0 + gq + 8 * e];
            diff[e] = 0u;
            for (int kc = t2, bit = 0; kc < g.np; kc += 8, bit += 2)
              diff[e] |= (static_cast<unsigned>(rq != reg[kb + kc]) |
                          static_cast<unsigned>(rq != reg[kb + kc + 1]) << 1) << bit;
          }
        }
        // S = Q K^T for this warp's 16 query rows against the window's
        // keys, as 3xTF32 mma.sync m16n8k8: ldmatrix of fp32 rows gives
        // the A fragments of Q and the B fragments of K (8 x 4 fp32 each)
        float s[KT][4];
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        const bf16* qrow = rgba::a_row(reinterpret_cast<const bf16*>(qs + q0 * kLdh), 2 * kLdh);
        const bf16* krow = rgba::b_row(reinterpret_cast<const bf16*>(ks + kb * kLdh), 2 * kLdh);
#pragma unroll
        for (int t = 0; t < HT; ++t) {
          uint32_t a[4], ahi[4], alo[4];
          rgba::ldsm_x4(a, qrow + 16 * t);
          rgba::split_tf32(a, ahi, alo);
#pragma unroll
          for (int j = 0; j < KT; j += 2) {
            if (j < nkt) {  // nkt is even: np % 16 == 0
              uint32_t b[4], bhi[4], blo[4];
              rgba::ldsm_x4(b, krow + 16 * j * kLdh + 16 * t);
              rgba::split_tf32(b, bhi, blo);
              const uint32_t h0[2] = {bhi[0], bhi[1]}, l0[2] = {blo[0], blo[1]};
              const uint32_t h1[2] = {bhi[2], bhi[3]}, l1[2] = {blo[2], blo[3]};
              rgba::mma_3xtf32(s[j], ahi, alo, h0, l0);
              rgba::mma_3xtf32(s[j + 1], ahi, alo, h1, l1);
            }
          }
        }
        // scale, bias, region mask (fp32), padded keys out; softmax over the quad
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j >= nkt) continue;
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int kc = 8 * j + t2 + x;
              float v = -INFINITY;
              if (kc < g.n)
                v = s[j][2 * e + x] * scale + (x ? rbv[j][e].y : rbv[j][e].x) +
                    ((diff[e] >> (2 * j + x)) & 1u ? -100.f : 0.f);
              s[j][2 * e + x] = v;
              mx[e] = fmaxf(mx[e], v);
            }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j >= nkt) continue;
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float ex = expf(s[j][2 * e + x] - mx[e]);
              s[j][2 * e + x] = ex;
              sum[e] += ex;
            }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
        }
        // O = P V: key tile j of S is k step j of P's A fragments, whose
        // slots q and q + 4 hold keys 8j + 2q and 8j + 2q + 1; V's rows are
        // read in that order
        const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
        float o[HT][4];
#pragma unroll
        for (int j = 0; j < HT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (j >= nkt) continue;
          const uint32_t p[4] = {__float_as_uint(s[j][0] * inv[0]),
                                 __float_as_uint(s[j][2] * inv[1]),
                                 __float_as_uint(s[j][1] * inv[0]),
                                 __float_as_uint(s[j][3] * inv[1])};
          uint32_t phi[4], plo[4];
          rgba::split_tf32(p, phi, plo);
          const float* v0 = vs + (kb + 8 * j + t2) * kLdh + gq;
#pragma unroll
          for (int jd = 0; jd < HT; ++jd) {
            uint32_t bhi[2], blo[2];
            rgba::split1_tf32(v0[8 * jd], bhi[0], blo[0]);
            rgba::split1_tf32(v0[kLdh + 8 * jd], bhi[1], blo[1]);
            rgba::mma_3xtf32(o[jd], phi, plo, bhi, blo);
          }
        }
        // head outputs into the concat buffer at columns h * hdp + d
#pragma unroll
        for (int jd = 0; jd < HT; ++jd)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(os + (q0 + gq + 8 * e) * g.ldo + h * 8 * HT +
                                       8 * jd + t2) =
                make_float2(o[jd][2 * e], o[jd][2 * e + 1]);
      }
    }

    // generic-proxy writes (head outputs) before wgmma reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    rgba::named_sync(1, kCons);  // every head's outputs are complete, xs is read
    if (grp + nblk < n_groups) load_tokens(gi + 1, grp + nblk);  // the next group's
    for (int oc = wg; oc < g.nco; oc += 2) {  // (O W^T + b) * gate -> out
      float acc[NS / 2];
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
      rgba::ring_gemm_smem_a<NS>(acc, g.ko, r, [&](int k) {
        return os + (q0 + lr) * g.ldo + k + lk;
      });
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + gq + 8 * e, w = row / g.np, rr = row - w * g.np;
        if (w >= nwin || rr >= g.n) continue;
        const float gate = gates[w];
        float* dst = out + (static_cast<size_t>(wins[w]) * g.n + rr) * g.c;
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int o = oc * NS + 8 * j + t2;
          if (o >= g.c) continue;
          *reinterpret_cast<float2*>(dst + o) =
              make_float2((acc[4 * j + 2 * e] + bsm[3 * g.c + o]) * gate,
                          (acc[4 * j + 2 * e + 1] + bsm[3 * g.c + o + 1]) * gate);
        }
      }
    }
  }
}

int launch_tf32(const void* tokens, const void* region, const void* alive,
                const void* wqkv, const void* bqkv, const void* wproj,
                const void* bproj, const void* rel_bias, void* out, int nw,
                int n, int c, int nh, float scale, cudaStream_t stream) {
  Geo32 g;
  g.nw = nw; g.n = n; g.np = (n + 15) / 16 * 16; g.c = c; g.nh = nh;
  g.hd = c / nh;
  const int hdp = (g.hd + 7) / 8 * 8, ns = 3 * hdp;
  if (g.np > 64 || hdp > 32 || c % 8) return static_cast<int>(cudaErrorInvalidValue);
  g.wb = std::max(1, 64 / g.np);
  g.ko = nh * hdp;
  g.nco = (c + ns - 1) / ns;
  g.ldx = c + 4; g.ldo = g.ko + 4;   // rows an odd number of 16 bytes apart:
                                      // ldmatrix's 8 rows in distinct banks
  using Kernel = void (*)(const float*, const int*, const float*, const float*,
                          const float*, const float*, const float*,
                          const float*, float*, Geo32, float);
  static const Kernel kernels[2][4] = {
      {win_attn_tf32_kernel<2, 24>, win_attn_tf32_kernel<2, 48>,
       win_attn_tf32_kernel<2, 72>, win_attn_tf32_kernel<2, 96>},
      {win_attn_tf32_kernel<8, 24>, win_attn_tf32_kernel<8, 48>,
       win_attn_tf32_kernel<8, 72>, win_attn_tf32_kernel<8, 96>}};
  const Kernel kernel = kernels[g.np <= 16 ? 0 : 1][hdp / 8 - 1];
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // one stage of both warpgroups' rings, with its two barriers each
  const size_t stage = 2 * (sizeof(float) * 2 * ns * rgba::kChunkK + 2 * sizeof(uint64_t));
  auto fixed = [&](int blocks) {
    g.cap_a = ((nw + g.wb - 1) / g.wb + blocks - 1) / blocks * g.wb;
    g.cap_d = (nw + blocks - 1) / blocks;
    return sizeof(float) * (64 * g.ldx + 64 * g.ldo + 6 * 64 * kLdh + 4 * c + 4) +
           sizeof(int) * (64 + g.cap_a + g.cap_d);
  };
  // the lists shrink as the grid grows: size the grid with the lists of
  // one block per SM, then the lists for that grid
  const size_t base = fixed(std::max(1, sms));
  g.stages = base < static_cast<size_t>(max_smem)
                 ? static_cast<int>(std::min<size_t>(kMaxStages, (max_smem - base) / stage))
                 : 0;
  if (g.stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t probe = base + g.stages * stage;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(probe));
  const int groups = (nw + g.wb - 1) / g.wb;
  const int grid = std::max(1, std::min(groups, rgba::persistent_grid(
      kernel, kThreads32, probe)));
  const size_t smem = fixed(grid) + g.stages * stage;
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<grid, kThreads32, smem, stream>>>(
      static_cast<const float*>(tokens), static_cast<const int*>(region),
      static_cast<const float*>(alive), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<float*>(out), g, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 path
constexpr int kThreadsM = 256;   // 8 warps: 2 warpgroups of 64 token rows
constexpr int kRowsM = 128;      // token rows per group of windows
constexpr int kMaxKT = 8;        // key tiles of 8: N <= 64 (see the kernel)
constexpr int kMaxHT = 4;        // head-dim tiles of 8: hdp <= 32

struct Geo {
  int nw, n, np, c, cp, nh, hd, hdp;  // np, cp, hdp: n, c, hd padded to 16
  int wb;                             // windows per group (wb * np <= 128)
  int ldq, ldv;                       // row strides of q, k and v^T (bf16)
  int stages;                         // nh + projection chunks of 3 hdp
  int cap_a, cap_d;                   // alive / dead list entries per block
};

// d (64 x N fp32 over the warpgroup; this thread's registers run over
// n-tiles of 8 as mma m16n8k16's do) += A (64 x 16) x B (16 x N), both
// K-major core-matrix operands in shared memory: wgmma.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// d = A (the warpgroup's 64 rows of a, k_len deep) x B^T (ws: N rows): one
// wgmma per 16-deep k step, issued together, then waited for.
template <int N>
__device__ __forceinline__ void group_gemm(float (&d)[N / 2], const bf16* a,
                                           const bf16* w, int k_len) {
  const int sbo = k_len / 8 * 128;
  const uint64_t da = rgba::kmajor_desc(a, sbo), db = rgba::kmajor_desc(w, sbo);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  rgba::fence_operands(d);
  rgba::wgmma_fence();
  for (int ks = 0; ks < k_len / 16; ++ks)
    wgmma_ss<N>(d, da + 16 * ks, db + 16 * ks);
  rgba::wgmma_commit_wait();
  rgba::fence_operands(d);
}

// Copy weight stage st into ws: a head's q|k|v rows (st < nh) or a chunk
// of the projection's output rows, both in core-matrix layout with cp
// columns, so the stage is one contiguous block.
template <int NS>
__device__ __forceinline__ void issue_stage(const Geo& g, int st,
                                            const bf16* __restrict__ wqkv,
                                            const bf16* __restrict__ wproj,
                                            bf16* ws) {
  const bf16* src;
  int rows;
  if (st < g.nh) {
    src = wqkv + static_cast<size_t>(st) * NS * g.cp;
    rows = NS;
  } else {
    const int n0 = (st - g.nh) * NS;
    src = wproj + static_cast<size_t>(n0) * g.cp;
    rows = min(NS, g.c - n0);
  }
  for (int i = threadIdx.x; i < rows * g.cp / 8; i += kThreadsM)
    rgba::cp_async16(ws + 8 * i, src + 8 * i, true);
  rgba::cp_async_commit();
}

// KT: key tiles of 8 held in registers (np <= 8 KT).  Windows of 16 tokens
// keep few registers, so two blocks share an SM where shared memory allows.
// NS = 3 hdp: the width of a weight stage and of its wgmma.
template <int KT, int NS>
__global__ void __launch_bounds__(kThreadsM, KT <= 2 ? 2 : 1)
win_attn_mma_kernel(const bf16* __restrict__ tokens,
                    const int* __restrict__ region,
                    const float* __restrict__ alive,
                    const bf16* __restrict__ wqkv,
                    const float* __restrict__ bqkv,
                    const bf16* __restrict__ wproj,
                    const float* __restrict__ bproj,
                    const float* __restrict__ rel_bias, bf16* __restrict__ out,
                    Geo g, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int warp_count[kThreadsM / 32];
  const int cb = g.cp / 8;                       // core matrices per 8 rows
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // kRowsM x cp tokens, then out
  bf16* os = xs + kRowsM * g.cp;                 // kRowsM x cp head outputs
  bf16* qs = os + kRowsM * g.cp;                 // kRowsM x ldq
  bf16* ks = qs + kRowsM * g.ldq;                // kRowsM x ldq
  bf16* vt = ks + kRowsM * g.ldq;                // hdp x ldv (v transposed)
  bf16* ws = vt + g.hdp * g.ldv;                 // 2 x NS x cp
  int* reg = reinterpret_cast<int*>(ws + 2 * NS * g.cp);  // kRowsM
  int* alist = reg + kRowsM;                     // cap_a
  int* dlist = alist + g.cap_a;                  // cap_d
  float* bsm = reinterpret_cast<float*>(dlist + g.cap_d);  // bqkv | bproj
  float* gates = bsm + 4 * g.c;                  // wb: alive of the group

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);
  const int nblk = gridDim.x;

  // alive windows by rank: group r / wb belongs to block (r / wb) % nblk;
  // dead windows by rank: block rank % nblk
  int n_alive = 0;
  float next = threadIdx.x < g.nw ? alive[threadIdx.x] : 0.f;
  for (int w0 = 0; w0 < g.nw; w0 += kThreadsM) {
    const int w = w0 + threadIdx.x;
    const bool a = w < g.nw && next != 0.f;
    if (w + kThreadsM < g.nw) next = alive[w + kThreadsM];  // in flight
    const unsigned bal = __ballot_sync(0xffffffffu, a);
    if (lane == 0) warp_count[warp] = __popc(bal);
    __syncthreads();
    int before = n_alive + __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int i = 0; i < kThreadsM / 32; ++i) {
      if (i < warp) before += warp_count[i];
      total += warp_count[i];
    }
    if (w < g.nw) {
      if (a) {
        const int grp = before / g.wb;
        if (grp % nblk == static_cast<int>(blockIdx.x))
          alist[(grp / nblk) * g.wb + before % g.wb] = w;
      } else {
        const int rd = w - before;
        if (rd % nblk == static_cast<int>(blockIdx.x)) dlist[rd / nblk] = w;
      }
    }
    n_alive += total;
    __syncthreads();  // warp_count is rewritten; the lists are complete
  }

  // dead windows: exact zeros
  const int vec = g.n * g.c / 8;  // 16-byte pieces of a window
  for (int i = 0; static_cast<int>(blockIdx.x) + i * nblk < g.nw - n_alive; ++i) {
    uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(dlist[i]) *
                                                  g.n * g.c);
    for (int e = threadIdx.x; e < vec; e += kThreadsM) o[e] = make_uint4(0, 0, 0, 0);
  }

  const int n_groups = (n_alive + g.wb - 1) / g.wb;
  if (static_cast<int>(blockIdx.x) >= n_groups) return;

  // K padding columns of the token and head-output buffers: read against
  // zero weights and never written, so zero them (0 * NaN is NaN)
  const int padc = g.cp - g.c;
  for (int i = threadIdx.x; i < 2 * kRowsM * padc; i += kThreadsM) {
    const int r = i / padc;
    xs[rgba::core_off(r, g.c + i % padc, cb)] = __float2bfloat16(0.f);
  }

  for (int i = threadIdx.x; i < 4 * g.c; i += kThreadsM)
    bsm[i] = i < 3 * g.c ? bqkv[i] : bproj[i - 3 * g.c];
  int buf = 0;
  issue_stage<NS>(g, 0, wqkv, wproj, ws);
  const int chunks = g.c / 8;
  const int wg = warp / 4;                       // warpgroup: rows 64 wg ..
  unsigned diff[2] = {0u, 0u};  // this thread's region-mask bits, per group
  for (int gi = 0, grp = blockIdx.x; grp < n_groups; ++gi, grp += nblk) {
    const int nwin = min(g.wb, n_alive - grp * g.wb);
    const int* wins = alist + gi * g.wb;
    __syncthreads();  // the previous group's output rows are stored
    for (int i = threadIdx.x; i < kRowsM * chunks; i += kThreadsM) {
      const int r = i / chunks, q = i - r * chunks;
      const int wi = r / g.np, rr = r - wi * g.np;
      const bool ok = wi < nwin && rr < g.n;
      const bf16* src =
          ok ? tokens + (static_cast<size_t>(wins[wi]) * g.n + rr) * g.c + 8 * q
             : tokens;
      rgba::cp_async16(xs + rgba::core_off(r, 8 * q, cb), src, ok);
    }
    rgba::cp_async_commit();
    if (threadIdx.x < g.wb)
      gates[threadIdx.x] = threadIdx.x < nwin ? alive[wins[threadIdx.x]] : 0.f;
    for (int r = threadIdx.x; r < kRowsM; r += kThreadsM) {
      const int wi = r / g.np, rr = r - wi * g.np;
      reg[r] = (wi < nwin && rr < g.n)
                   ? region[static_cast<size_t>(wins[wi]) * g.n + rr] : 0;
    }

    for (int st = 0; st < g.stages; ++st, buf ^= 1) {
      rgba::cp_async_wait<0>();
      // generic-proxy writes (cp.async, head outputs) before wgmma reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // stage st (and the tokens) landed; stage st-1 done
      if (st + 1 < g.stages || grp + nblk < n_groups)
        issue_stage<NS>(g, (st + 1) % g.stages, wqkv, wproj,
                        ws + (buf ^ 1) * NS * g.cp);
      const bf16* w = ws + buf * NS * g.cp;
      float acc[NS / 2];   // n-tile j: acc[4 j .. 4 j + 3], as mma's
      if (st >= g.nh) {  // output projection chunk: (O W^T + b) * gate -> xs
        const int n0 = (st - g.nh) * NS;
        const int nt = min(NS, g.c - n0) / 8;
        group_gemm<NS>(acc, os + 64 * wg * g.cp, w, g.cp);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + gq + 8 * r, wi = row / g.np;
          const float gate = wi < g.wb ? gates[wi] : 0.f;
#pragma unroll
          for (int j = 0; j < NS / 8; ++j) {
            if (j >= nt) continue;
            const int o = n0 + 8 * j + t2;
            *reinterpret_cast<uint32_t*>(xs + rgba::core_off(row, o, cb)) =
                rgba::pack_bf16((acc[4 * j + 2 * r] + bsm[3 * g.c + o]) * gate,
                                (acc[4 * j + 2 * r + 1] + bsm[3 * g.c + o + 1]) * gate);
          }
        }
        continue;
      }

      // head h = st: this warp's rel_bias values load now and land while
      // the q | k | v projection of every row runs
      const int h = st;
      const int q0 = 16 * warp, wi = q0 / g.np, kb = wi * g.np;
      const int nkt = g.np / 8;
      float2 rbv[KT][2];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 - kb + gq + 8 * r, kc = 8 * j + t2;
          rbv[j][r] = (j < nkt && qi < g.n && kc < g.n)
              ? __ldg(reinterpret_cast<const float2*>(
                    rel_bias + (static_cast<size_t>(h) * g.n + qi) * g.n + kc))
              : make_float2(0.f, 0.f);
        }
      group_gemm<NS>(acc, xs + 64 * wg * g.cp, w, g.cp);
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int part = 8 * j / g.hdp, d = 8 * j + t2 - part * g.hdp;
        const float* bq = bsm + part * g.c + h * g.hd;
        const float b0 = d < g.hd ? bq[d] : 0.f;
        const float b1 = d + 1 < g.hd ? bq[d + 1] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + gq + 8 * r;
          const float v0 = acc[4 * j + 2 * r] + b0, v1 = acc[4 * j + 2 * r + 1] + b1;
          if (part < 2) {
            *reinterpret_cast<uint32_t*>((part ? ks : qs) + row * g.ldq + d) =
                rgba::pack_bf16(v0, v1);
          } else {
            vt[d * g.ldv + row] = __float2bfloat16(v0);
            vt[(d + 1) * g.ldv + row] = __float2bfloat16(v1);
          }
        }
      }
      __syncthreads();  // q, k, v of head h complete

      if (wi >= nwin) continue;
      if (h == 0) {  // region ids differ: bit 2j+e for key 8j+t2+e, per row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rq = reg[q0 + gq + 8 * r];
          diff[r] = 0u;
          for (int kc = t2, bit = 0; kc < g.np; kc += 8, bit += 2)
            diff[r] |= (static_cast<unsigned>(rq != reg[kb + kc]) |
                        static_cast<unsigned>(rq != reg[kb + kc + 1]) << 1) << bit;
        }
      }
      // S = Q K^T for this warp's 16 query rows against the window's keys
      float s[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const bf16* qrow = rgba::a_row(qs + q0 * g.ldq, g.ldq);
      const bf16* krow = rgba::b_row(ks + kb * g.ldq, g.ldq);
      for (int kk = 0; kk < g.hdp; kk += 16) {
        uint32_t a[4];
        rgba::ldsm_x4(a, qrow + kk);
#pragma unroll
        for (int j = 0; j < KT; j += 2) {
          if (j < nkt) {  // nkt is even: np % 16 == 0
            uint32_t b[4];
            rgba::ldsm_x4(b, krow + 8 * j * g.ldq + kk);
            rgba::mma_bf16(s[j], a, b[0], b[1]);
            rgba::mma_bf16(s[j + 1], a, b[2], b[3]);
          }
        }
      }
      // scale, bias, region mask, padded keys out; softmax over the quad
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (j >= nkt) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = 8 * j + t2 + e;
            float v = -INFINITY;
            if (kc < g.n)
              v = s[j][2 * r + e] * scale + (e ? rbv[j][r].y : rbv[j][r].x) +
                  ((diff[r] >> (2 * j + e)) & 1u ? -100.f : 0.f);
            s[j][2 * r + e] = v;
            mx[r] = fmaxf(mx[r], v);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          if (j >= nkt) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = expf(s[j][2 * r + e] - mx[r]);
            s[j][2 * r + e] = ex;
            sum[r] += ex;
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      }
      // O = P V: P rounded to bf16 as A fragments, V^T rows as B fragments
      const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
      float o[kMaxHT][4];
      const int nht = g.hdp / 8;
#pragma unroll
      for (int j = 0; j < kMaxHT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
      for (int ks16 = 0; ks16 < KT / 2; ++ks16) {
        if (2 * ks16 >= nkt) continue;
        const uint32_t a[4] = {
            rgba::pack_bf16(s[2 * ks16][0] * inv[0], s[2 * ks16][1] * inv[0]),
            rgba::pack_bf16(s[2 * ks16][2] * inv[1], s[2 * ks16][3] * inv[1]),
            rgba::pack_bf16(s[2 * ks16 + 1][0] * inv[0], s[2 * ks16 + 1][1] * inv[0]),
            rgba::pack_bf16(s[2 * ks16 + 1][2] * inv[1], s[2 * ks16 + 1][3] * inv[1])};
        const bf16* vrow = rgba::b_row(vt + kb + 16 * ks16, g.ldv);
#pragma unroll
        for (int j = 0; j < kMaxHT; j += 2) {
          if (j < nht) {  // nht is even: hdp % 16 == 0
            uint32_t b[4];
            rgba::ldsm_x4(b, vrow + 8 * j * g.ldv);
            rgba::mma_bf16(o[j], a, b[0], b[1]);
            rgba::mma_bf16(o[j + 1], a, b[2], b[3]);
          }
        }
      }
      // head outputs into the concat buffer at columns h * hd + d
#pragma unroll
      for (int j = 0; j < kMaxHT; ++j) {
        if (j >= nht) continue;
        const int d = 8 * j + t2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + gq + 8 * r, col = h * g.hd + d;
          if (d < g.hd)
            os[rgba::core_off(row, col, cb)] = __float2bfloat16(o[j][2 * r]);
          if (d + 1 < g.hd)
            os[rgba::core_off(row, col + 1, cb)] = __float2bfloat16(o[j][2 * r + 1]);
        }
      }
    }

    __syncthreads();  // the group's output rows are in xs
    for (int i = threadIdx.x; i < nwin * g.n * chunks; i += kThreadsM) {
      const int wi = i / (g.n * chunks), rem = i - wi * g.n * chunks;
      const int rr = rem / chunks, q = rem - rr * chunks;
      bf16* dst = out + (static_cast<size_t>(wins[wi]) * g.n + rr) * g.c + 8 * q;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
          xs + rgba::core_off(wi * g.np + rr, 8 * q, cb));
    }
  }
}

int launch_mma(const void* tokens, const void* region, const void* alive,
               const void* wqkv, const void* bqkv, const void* wproj,
               const void* bproj, const void* rel_bias, void* out, int nw,
               int n, int c, int nh, float scale, cudaStream_t stream) {
  auto up16 = [](int v) { return (v + 15) / 16 * 16; };
  Geo g;
  g.nw = nw; g.n = n; g.np = up16(n); g.c = c; g.cp = up16(c); g.nh = nh;
  g.hd = c / nh; g.hdp = up16(g.hd);
  g.wb = std::max(1, kRowsM / g.np);
  g.ldq = g.hdp + 8; g.ldv = kRowsM + 8;
  const int ns = 3 * g.hdp;
  g.stages = nh + (c + ns - 1) / ns;
  if (g.np > 8 * kMaxKT || (ns != 48 && ns != 96) || c % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto smem_for = [&](int blocks) {
    g.cap_a = ((nw + g.wb - 1) / g.wb + blocks - 1) / blocks * g.wb;
    g.cap_d = (nw + blocks - 1) / blocks;
    return sizeof(bf16) * (2 * kRowsM * g.cp + 2 * kRowsM * g.ldq +
                           g.hdp * g.ldv + 2 * ns * g.cp) +
           sizeof(int) * (kRowsM + g.cap_a + g.cap_d) +
           sizeof(float) * (4 * c + g.wb);
  };
  using Kernel = void (*)(const bf16*, const int*, const float*, const bf16*,
                          const float*, const bf16*, const float*,
                          const float*, bf16*, Geo, float);
  static const Kernel kernels[3][2] = {
      {win_attn_mma_kernel<2, 48>, win_attn_mma_kernel<2, 96>},
      {win_attn_mma_kernel<4, 48>, win_attn_mma_kernel<4, 96>},
      {win_attn_mma_kernel<kMaxKT, 48>, win_attn_mma_kernel<kMaxKT, 96>}};
  const Kernel kernel = kernels[g.np <= 16 ? 0 : g.np <= 32 ? 1 : 2][ns == 96];
  // the lists shrink as the grid grows: size the grid with the lists of
  // one block per SM, then the lists for that grid
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t probe = smem_for(std::max(1, sms));
  cudaFuncSetAttribute(kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(probe));
  const int groups = (nw + g.wb - 1) / g.wb;
  const int grid = std::max(1, std::min(groups, rgba::persistent_grid(
      kernel, kThreadsM, probe)));
  const size_t smem = smem_for(grid);
  cudaFuncSetAttribute(kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<grid, kThreadsM, smem, stream>>>(
      static_cast<const bf16*>(tokens), static_cast<const int*>(region),
      static_cast<const float*>(alive), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<bf16*>(out), g, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens, out: (nw, n, c) in the activation dtype (fp32 or bf16); region:
// (nw, n) int32; alive: (nw,) fp32; bqkv (3c,), bproj (c,), rel_bias (nh,
// n, n) fp32; scale = hd^-0.5 rounded to fp32 by the caller.  The dtype
// picks the kernel, and the weights' layout:
// - fp32: wqkv (nh, 2 NS c): per head its rows [q|k|v, d < hdp] x [in],
//   and wproj (ceil(c / NS), 2 NS nh hdp): [out, NS per chunk] x [h hdp +
//   d], hdp = hd rounded up to 8, NS = 3 hdp, zero padding, each as chunks
//   of 16 k of TF32 hi then lo in K-major core matrices of 8 x 4 (see
//   rgba::ChunkRing; win_attn.kernel_weights); tokens 16-byte aligned;
// - bf16: wqkv (nh, 3 hdp, cp) [head][q|k|v, d][in] and wproj (c, cp)
//   [out][in], with hdp, cp = hd, c rounded up to 16 and zero padding, each
//   (rows, cp) matrix in K-major core-matrix order (8 x 8 blocks, see
//   core_off); tokens and out 16-byte aligned.
// The Python wrapper checks n % 4 == 0, c % nh == 0, nh >= 3, n <= 64,
// hd <= 32 and c % 8 == 0.
extern "C" int rgba_win_attn(const void* tokens, const void* region,
                             const void* alive, const void* wqkv,
                             const void* bqkv, const void* wproj,
                             const void* bproj, const void* rel_bias,
                             void* out, int nw, int n, int c, int nh,
                             float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_mma(tokens, region, alive, wqkv, bqkv, wproj, bproj,
                      rel_bias, out, nw, n, c, nh, scale, s);
  return launch_tf32(tokens, region, alive, wqkv, bqkv, wproj, bproj,
                     rel_bias, out, nw, n, c, nh, scale, s);
}
