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
// bf16 design (gdn_mma_kernel): a persistent grid, one block of two
// warpgroups per SM.  The block stages gamma_t once for its lifetime, as
// the K-major core matrices that wgmma reads (rows n >= C zero, so one
// m64n192k16 shape serves every C <= 192).  Each warpgroup then walks its
// own stream of 64-row tiles through its own ring of three buffers, filled
// with cp.async two tiles ahead and synchronised by its own named barrier,
// so one group's products overlap the other's loads and stores (231,168
// bytes of shared memory at C=192).  Per tile, each warp loads its 16 rows'
// A fragments with ldmatrix, squares them in fp32 and rounds to bf16 (the
// reference squares in the activation dtype) in registers, and the
// warpgroup runs C/16 wgmma with A from registers and fp32 accumulators.
// The epilogue adds beta, takes the rsqrt (sqrt) in fp32, scales x read
// from the same tile and writes y back into it; the bulk-copy engine then
// stores each row, so no warp spends instructions on the stores, and the
// ring refills a buffer only once its rows have been read.  Rows past M
// are zero-filled on load and never stored.  Sums run in a fixed order,
// without atomics.
//
// fp32 design (gdn_tf32_kernel): every product at fp32 accuracy on the
// tensor cores as 3xTF32 (common.cuh): wgmma m64n192k8 with the terms
// x2_lo g_hi, x2_hi g_lo, x2_hi g_hi in that order, every k step.  As 3xTF32
// the work is 3 x 116 GFLOP, 0.70 ms at the 495 TFLOP/s TF32 peak, about
// the 0.72 ms that reading x and writing y in fp32 takes: bytes and
// operations bound it alike.
// - gamma_t does not fit: its hi and lo at C=192 take 294,912 bytes, more
//   than a block's 232,448.  It streams from L2 in chunks of 16 k (hi then
//   lo, 24,576 bytes; laid out once per weights by the wrapper,
//   gdn.kernel_weights) through a ring of 4 stages, each chunk feeding the
//   block's 128-row tile: both warpgroups take every chunk, and thread 0
//   refills a stage with cp.async.bulk once the block has read it.  L2
//   sees 2.3 KB of gamma per row, HBM x once and y once.  (Two designs ran
//   slower on the H100: gamma's hi resident with lo streamed per
//   warpgroup, and an 8-stage ring fed by a producer warpgroup with x
//   loaded straight into registers, whose loads waited on memory in every
//   epilogue.)
// - x comes by bulk copies, one per row, into a 128-row tile in shared
//   memory (rows padded by 8 fp32: at most 2-way bank conflicts), issued a
//   whole tile ahead: as soon as the block has read the tile into
//   registers, the next one is requested.
// - A from registers: the wrapper permutes gamma_t's k within each 8 (k
//   8j + p is channel 8j + (0,2,4,6,1,3,5,7)[p]), so the TF32 A fragment of
//   k step j (lane l: rows l/4 and l/4 + 8, k l%4 and l%4 + 4) is channels
//   8j + 2(l%4) and + 1 of those rows: exactly the float2 each lane holds
//   of the accumulators' n-tile j.  Each lane reads its 2 rows x 24 float2
//   of x once, squares and splits them for the products, and scales the
//   same registers in the epilogue (y = x rsqrt(x2 @ gamma_t + beta), or
//   sqrt, in fp32), which stores y straight from the registers.  96
//   accumulators and 96 x registers a thread: the block has no producer
//   warp, so its 256 threads may hold 255 registers each (with 384 threads
//   ptxas serialised the wgmma for want of registers, note C7511).
// - Persistent grid, one block per SM; rows past M are never stored.  Sums
//   in a fixed order (k ascending, the three terms in the order above), no
//   atomics: a row gives the same bits for any M.
//
// C in (192, 256] (the mixed Transformer-CNN codec's GDN, C=256): both
// kernels are templates over the width NT of one product and the PASSES
// that cover the channels (NT x PASSES = 192 x 1 for C <= 192, which is
// the design above unchanged, and 128 x 2 past it).  Each tile's outputs
// are made in two passes of m64n128 wgmma, output channels 0-127 then
// 128-255, over all k; the x^2 fragments stay in registers across both.
// - fp32: gamma_t's B operand is laid out [pass][chunk of 16 k][hi | lo of
//   128 rows] (gdn.kernel_weights), so a ring stage holds 16,384 bytes and
//   the four-stage ring streams the passes' chunks in turn; x (128 floats
//   of it a thread) and one pass's 64 accumulators stay in registers.
//   Shared memory: ring 65,536 + the 128-row x tile 135,168 bytes.
// - bf16: gamma_t staged whole (256 x 256 bf16, 131,072 bytes) leaves room
//   for one warpgroup's ring of two 64-row tiles (67,584 bytes): a block of
//   128 threads per SM, one tile landing while the other computes.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------- bf16 path
constexpr int kGroupThreads = 128;      // a warpgroup: one stream of tiles
constexpr int kTileRows = 16 * kGroupThreads / 32;  // 16 rows per warp: 64

using bf16 = __nv_bfloat16;

// x^2 of two packed bf16, formed in fp32 and rounded back to bf16.
__device__ __forceinline__ uint32_t square2(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return rgba::pack_bf16(f.x * f.x, f.y * f.y);
}

// sqrt to within 2 fp32 ulps in one special-function instruction, as
// rsqrtf is: the bf16 result rounds away both functions' errors alike.
__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Barrier of one warpgroup (named barrier 1 + group, kGroupThreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + group), "n"(kGroupThreads));
}

// d (64 x N fp32 over the warpgroup) += a (64 x 16 bf16, this warp's 16
// rows as the A fragment of mma m16n8k16) x B (16 x N from shared memory,
// K-major): wgmma.  d's registers run over n-tiles of 8 as mma's do.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// NT x PASSES: the channels held (C <= NT PASSES), each pass NT output
// channels wide; GROUPS warpgroups per block, each with a ring of STAGES
// 64-row tiles.
template <int NT, int PASSES, int GROUPS, int STAGES>
__global__ void __launch_bounds__(GROUPS * kGroupThreads, 1)
gdn_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma_t,
               const float* __restrict__ beta, bf16* __restrict__ y,
               long long m, int c, int inverse) {
  constexpr int kN = NT * PASSES;        // rows of the staged B; c < kN pads
  constexpr int kKS = kN / 16;           // k steps: C <= kN
  constexpr int kBlock = GROUPS * kGroupThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = c + 8;                  // x rows 4 banks apart: no conflicts
  const int sbo = c / 8 * 128;           // bytes between 8-row blocks of gs
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);          // kN x c, K-major cores
  float* bs = reinterpret_cast<float*>(gs + kN * c);     // c
  const int group = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  bf16* xs = reinterpret_cast<bf16*>(bs + c) +    // STAGES x kTileRows x ld
             group * STAGES * kTileRows * ld;             // per group
  const int chunks = c / 8;              // 16-byte pieces of a row
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  const long long streams = static_cast<long long>(GROUPS) * gridDim.x;

  // every call commits one cp.async group, empty past the last tile, so
  // a fixed wait count finds the oldest tile landed
  auto load = [&](long long t, bf16* buf) {
    for (int i = gt; t < tiles && i < kTileRows * chunks; i += kGroupThreads) {
      const int r = i / chunks, q = i - r * chunks;
      const long long row = t * kTileRows + r;
      const bool ok = row < m;
      rgba::cp_async16(buf + r * ld + 8 * q, x + (ok ? row : 0) * c + 8 * q, ok);
    }
    rgba::cp_async_commit();
  };

  long long t = static_cast<long long>(GROUPS) * blockIdx.x + group;
  for (int st = 0; st < STAGES - 1; ++st)
    load(t + st * streams, xs + st * kTileRows * ld);
  // gamma_t (k, n) to the B operand's core-matrix layout, rows n >= c zero
  for (int i = threadIdx.x; i < c * kN; i += kBlock) {
    const int k = i / kN, n = i - k * kN;
    gs[rgba::core_off(n, k, c / 8)] =
        n < c ? gamma_t[k * c + n] : __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < c; i += kBlock) bs[i] = beta[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // gamma_t and beta staged; from here each group alone

  const int warp = gt / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);
  const int nk = c / 16, nt = c / 8;
  for (int buf = 0; t < tiles; t += streams, buf = (buf + 1) % STAGES) {
    rgba::cp_async_wait<STAGES - 2>();
    group_sync(group);  // this tile landed for every thread of the group

    bf16* xt = xs + buf * kTileRows * ld;
    bf16* lo = xt + (16 * warp + gq) * ld;
    bf16* hi = lo + 8 * ld;
    const bf16* arow = rgba::a_row(xt + 16 * warp * ld, ld);
    uint32_t a[kKS][4];   // x^2 of this warp's rows, every k step
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      if (ks < nk) {
        rgba::ldsm_x4(a[ks], arow + 16 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[ks][e] = square2(a[ks][e]);
      }
    }
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      // output channels NT pass .. NT pass + NT - 1 (rows of gs)
      const uint64_t desc0 = rgba::kmajor_desc(gs + NT * pass * c, sbo);
      float d[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) d[i] = 0.f;
      rgba::fence_operands(d);
      rgba::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        if (ks < nk) wgmma_bf16<NT>(d, a[ks], desc0 + 16 * ks);
      rgba::wgmma_commit_wait();
      rgba::fence_operands(d);
#pragma unroll
      for (int jj = 0; jj < NT / 8; ++jj) {
        const int j = NT / 8 * pass + jj;
        if (j >= nt) continue;
        const int col = 8 * j + t2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>((r ? hi : lo) + col);
          const float2 xv = __bfloat1622float2(*p);
          const float n0 = d[4 * jj + 2 * r] + bs[col];
          const float n1 = d[4 * jj + 2 * r + 1] + bs[col + 1];
          const float s0 = inverse ? sqrt_approx(n0) : rsqrtf(n0);
          const float s1 = inverse ? sqrt_approx(n1) : rsqrtf(n1);
          *p = __floats2bfloat162_rn(xv.x * s0, xv.y * s1);
        }
      }
    }
    // y rows to device memory by the bulk-copy engine, one row per lane
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    const long long row = t * kTileRows + 16 * warp + lane;
    if (lane < 16 && row < m)
      rgba::bulk_store(y + row * c, xt + (16 * warp + lane) * ld, 2 * c);
    rgba::bulk_commit();
    // refill the buffer of the tile before this one, once its rows are read
    rgba::bulk_wait_read<1>();
    group_sync(group);
    load(t + (STAGES - 1) * streams,
         xs + (buf + STAGES - 1) % STAGES * kTileRows * ld);
  }
  rgba::bulk_wait_read<0>();  // shared memory must outlive the last copies
}

template <int NT, int PASSES, int GROUPS, int STAGES>
int launch_mma_as(const void* x, const void* gamma_t, const void* beta,
                  void* y, long long m, int c, int inverse,
                  cudaStream_t stream) {
  const auto kernel = gdn_mma_kernel<NT, PASSES, GROUPS, STAGES>;
  const int threads = GROUPS * kGroupThreads;
  const size_t smem =
      sizeof(bf16) * (NT * PASSES * c + STAGES * GROUPS * kTileRows * (c + 8)) +
      sizeof(float) * c;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  const long long grid = std::min<long long>(
      (tiles + GROUPS - 1) / GROUPS,
      rgba::persistent_grid(kernel, threads, smem));
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma_t),
      static_cast<const float*>(beta), static_cast<bf16*>(y), m, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, const void* gamma_t, const void* beta, void* y,
               long long m, int c, int inverse, cudaStream_t stream) {
  if (c <= 192)   // two warpgroups, three tiles each in flight
    return launch_mma_as<192, 1, 2, 3>(x, gamma_t, beta, y, m, c, inverse,
                                       stream);
  return launch_mma_as<128, 2, 1, 2>(x, gamma_t, beta, y, m, c, inverse,
                                     stream);
}

// ---------------------------------------------------------------- fp32 path
constexpr int kStages32 = 4;                        // gamma chunks in the ring
constexpr int kRows32 = 2 * kTileRows;              // rows per tile: 128

template <int NT>
size_t smem_tf32(int c) {  // a ring stage holds 2 NT kChunkK floats: hi, lo
  return sizeof(float) * (kStages32 * 2 * NT * rgba::kChunkK + kRows32 * (c + 8) + c) +
         sizeof(uint64_t) * (kStages32 + 1);
}

// NT x PASSES as in the bf16 kernel: NT output channels a pass, their
// chunks of gamma streamed pass after pass.
template <int NT, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
gdn_tf32_kernel(const float* __restrict__ x, const float* __restrict__ gw,
                const float* __restrict__ beta, float* __restrict__ y,
                long long m, int c, int inverse) {
  constexpr int kN = NT * PASSES;         // channels held: C <= kN
  constexpr int kChunk32 = 2 * NT * rgba::kChunkK;   // floats of a chunk: hi, lo
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nch = c / rgba::kChunkK, nt = c / 8, ldx = c + 8;
  float* ring = reinterpret_cast<float*>(smem_raw);       // kStages32 x kChunk32
  float* xs = ring + kStages32 * kChunk32;                // kRows32 x ldx
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + kRows32 * ldx);
  uint64_t* x_bar = full + kStages32;
  float* bs = reinterpret_cast<float*>(x_bar + 1);        // beta
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);
  const long long tiles = (m + kRows32 - 1) / kRows32;
  const int per_tile = nch * PASSES;  // gamma chunks a tile takes
  const long long total =  // gamma chunks this block takes
      blockIdx.x < tiles ? ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * per_tile : 0;
  auto fill = [&](long long q) {  // chunk q % per_tile of gamma into its stage
    const int s = static_cast<int>(q % kStages32);
    rgba::mbar_expect(&full[s], kChunk32 * 4);
    rgba::bulk_load(ring + s * kChunk32, gw + (q % per_tile) * kChunk32,
                    kChunk32 * 4, &full[s]);
  };
  auto load_x = [&](long long tt) {  // warp 0: tile tt's rows into xs
    const long long rows = m - tt * kRows32;
    const int n = static_cast<int>(rows < kRows32 ? rows : kRows32);
    if (lane == 0) rgba::mbar_expect(x_bar, n * c * 4);
    __syncwarp();
    for (int r = lane; r < n; r += 32)
      rgba::bulk_load(xs + r * ldx, x + (tt * kRows32 + r) * c, c * 4, x_bar);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages32; ++i) rgba::mbar_init(full + i, 1);
    rgba::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < c; i += kThreads) bs[i] = beta[i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (long long q = 0; q < kStages32 && q < total; ++q) fill(q);
  if (warp == 0 && blockIdx.x < tiles) load_x(blockIdx.x);

  long long q = 0;  // gamma chunks taken
  for (long long t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    // this lane's x of the tile, in the accumulators' layout, then the
    // next tile's rows into xs, a whole tile ahead of their use
    rgba::mbar_wait(x_bar, static_cast<unsigned>(i & 1));
    float2 xv[kN / 8][2];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        xv[j][rr] = j < nt ? *reinterpret_cast<const float2*>(
                                 xs + (16 * warp + gq + 8 * rr) * ldx + 8 * j + t2)
                           : make_float2(0.f, 0.f);
    __syncthreads();  // xs is read
    if (warp == 0 && t + gridDim.x < tiles) load_x(t + gridDim.x);

#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      float d[NT / 2];
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) d[e] = 0.f;
      rgba::fence_operands(d);
#pragma unroll
      for (int ch = 0; ch < kN / rgba::kChunkK; ++ch) {
        if (ch < nch) {  // the same for every thread: no wgmma is predicated
          uint32_t hi[2][4], lo[2][4];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const float2 p = xv[2 * ch + kk][0], r = xv[2 * ch + kk][1];
            const float v[4] = {p.x * p.x, r.x * r.x, p.y * p.y, r.y * r.y};
#pragma unroll
            for (int e = 0; e < 4; ++e) rgba::split1_tf32(v[e], hi[kk][e], lo[kk][e]);
          }
          const int s = static_cast<int>(q % kStages32);
          rgba::mbar_wait(&full[s], static_cast<unsigned>((q / kStages32) & 1));
          const float* b = ring + s * kChunk32;
          const uint64_t bh = rgba::kmajor_desc(b, 2 * 256);
          const uint64_t bl = rgba::kmajor_desc(b + kChunk32 / 2, 2 * 256);
          rgba::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            rgba::wgmma_3xtf32<NT>(d, hi[kk], lo[kk], bh + 16 * kk, bl + 16 * kk);
          rgba::wgmma_commit_wait();
          __syncthreads();  // both groups are done with stage s
          if (threadIdx.x == 0 && q + kStages32 < total) fill(q + kStages32);
          ++q;
        }
      }
      rgba::fence_operands(d);
#pragma unroll
      for (int jj = 0; jj < NT / 8; ++jj) {
        const int j = NT / 8 * pass + jj;
        if (j >= nt) continue;
        const int col = 8 * j + t2;
        const float b0 = bs[col], b1 = bs[col + 1];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const long long row = t * kRows32 + 16 * warp + gq + 8 * rr;
          if (row >= m) continue;
          const float n0 = d[4 * jj + 2 * rr] + b0, n1 = d[4 * jj + 2 * rr + 1] + b1;
          const float s0 = inverse ? sqrtf(n0) : rsqrtf(n0);
          const float s1 = inverse ? sqrtf(n1) : rsqrtf(n1);
          *reinterpret_cast<float2*>(y + row * c + col) =
              make_float2(xv[j][rr].x * s0, xv[j][rr].y * s1);
        }
      }
    }
  }
}

template <int NT, int PASSES>
int launch_tf32_as(const void* x, const void* gw, const void* beta, void* y,
                   long long m, int c, int inverse, cudaStream_t stream) {
  const auto kernel = gdn_tf32_kernel<NT, PASSES>;
  const size_t smem = smem_tf32<NT>(c);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const long long tiles = (m + kRows32 - 1) / kRows32;
  const long long grid = std::min<long long>(
      tiles, rgba::persistent_grid(kernel, kThreads, smem));
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gw),
      static_cast<const float*>(beta), static_cast<float*>(y), m, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

int launch_tf32(const void* x, const void* gw, const void* beta, void* y,
                long long m, int c, int inverse, cudaStream_t stream) {
  if (c <= 192)
    return launch_tf32_as<192, 1>(x, gw, beta, y, m, c, inverse, stream);
  return launch_tf32_as<128, 2>(x, gw, beta, y, m, c, inverse, stream);
}

}  // namespace

// x, y: (m, c) contiguous in the activation dtype (fp32 or bf16), 16-byte
// aligned; beta: (c,) fp32.  c % 16 == 0 and c <= 256 (checked by the
// Python wrapper).  The dtype picks the kernel and gamma's layout:
// - bf16: gamma_t (c, c) [in][out] in bf16;
// - fp32: gw, gamma_t as the B operand [n < kN][k < c], n = output
//   channel (rows n >= c zero; kN = 192 for c <= 192, else 256), k
//   permuted within each 8 (see the fp32 design), cut into passes of NT
//   rows (one of 192, or two of 128), each in chunks of 16 k, each chunk
//   its TF32 hi then lo in K-major core matrices of 8 x 4
//   (gdn.kernel_weights; 2 * kN * c floats).
extern "C" int rgba_gdn(const void* x, const void* gamma_t, const void* beta,
                        void* y, long long m, int c, int inverse, int bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_mma(x, gamma_t, beta, y, m, c, inverse, s);
  return launch_tf32(x, gamma_t, beta, y, m, c, inverse, s);
}
