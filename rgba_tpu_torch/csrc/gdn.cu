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
// fp32 design (gdn_kernel): one block of 256 threads per tile of 64 rows on
// the CUDA cores (TF32 would break the fp32 tolerance).  It squares the rows
// into shared memory, then walks gamma_t in K-tiles of 32 rows; each thread
// keeps a 4-row x 12-column register tile, so 16 shared loads feed 48 FMAs;
// the epilogue adds beta, takes the rsqrt (sqrt) in fp32, and scales x.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // rows per block
constexpr int kK = 32;         // gamma_t rows per K-tile
constexpr int kColGroups = 12; // columns per thread: C <= 16 * 12 = 192

__global__ void __launch_bounds__(kThreads)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ gamma_t,
           const float* __restrict__ beta, float* __restrict__ y, long long m,
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
    const float v = row < m ? x[row * c + col] : 0.f;
    x2s[r * ldx + col] = v * v;
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
      gs[i] = gamma_t[static_cast<long long>(k0) * c + i];
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
        y[idx] = x[idx] * s;
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 path
constexpr int kGroups = 2;              // warpgroups: independent tile streams
constexpr int kStages = 3;              // tiles per group's ring: 2 in flight
constexpr int kGroupThreads = kThreads / kGroups;
constexpr int kTileRows = 16 * kGroupThreads / 32;  // 16 rows per warp: 64
constexpr int kN = 192;                 // wgmma width; C < 192 pads gamma_t
constexpr int kKS = 192 / 16;           // k steps: C <= 192

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

// d (64 x 192 fp32 over the warpgroup) += a (64 x 16 bf16, this warp's 16
// rows as the A fragment of mma m16n8k16) x B (16 x 192 from shared memory,
// K-major): wgmma.  d's registers run over n-tiles of 8 as mma's do.
__device__ __forceinline__ void wgmma_192(float (&d)[kN / 2],
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

__global__ void __launch_bounds__(kThreads, 1)
gdn_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma_t,
               const float* __restrict__ beta, bf16* __restrict__ y,
               long long m, int c, int inverse) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = c + 8;                  // x rows 4 banks apart: no conflicts
  const int sbo = c / 8 * 128;           // bytes between 8-row blocks of gs
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);          // kN x c, K-major cores
  float* bs = reinterpret_cast<float*>(gs + kN * c);     // c
  const int group = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  bf16* xs = reinterpret_cast<bf16*>(bs + c) +    // kStages x kTileRows x ld
             group * kStages * kTileRows * ld;            // per group
  const int chunks = c / 8;              // 16-byte pieces of a row
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  const long long streams = static_cast<long long>(kGroups) * gridDim.x;

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

  long long t = static_cast<long long>(kGroups) * blockIdx.x + group;
  for (int st = 0; st < kStages - 1; ++st)
    load(t + st * streams, xs + st * kTileRows * ld);
  // gamma_t (k, n) to the B operand's core-matrix layout, rows n >= c zero
  for (int i = threadIdx.x; i < c * kN; i += kThreads) {
    const int k = i / kN, n = i - k * kN;
    gs[rgba::core_off(n, k, c / 8)] =
        n < c ? gamma_t[k * c + n] : __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < c; i += kThreads) bs[i] = beta[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // gamma_t and beta staged; from here each group alone

  const int warp = gt / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);
  const int nk = c / 16, nt = c / 8;
  const uint64_t desc0 = rgba::kmajor_desc(gs, sbo);
  for (int buf = 0; t < tiles; t += streams, buf = (buf + 1) % kStages) {
    rgba::cp_async_wait<kStages - 2>();
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
    float d[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) d[i] = 0.f;
    rgba::fence_operands(d);
    rgba::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
      if (ks < nk) wgmma_192(d, a[ks], desc0 + 16 * ks);
    rgba::wgmma_commit_wait();
    rgba::fence_operands(d);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      if (j >= nt) continue;
      const int col = 8 * j + t2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>((r ? hi : lo) + col);
        const float2 xv = __bfloat1622float2(*p);
        const float n0 = d[4 * j + 2 * r] + bs[col];
        const float n1 = d[4 * j + 2 * r + 1] + bs[col + 1];
        const float s0 = inverse ? sqrt_approx(n0) : rsqrtf(n0);
        const float s1 = inverse ? sqrt_approx(n1) : rsqrtf(n1);
        *p = __floats2bfloat162_rn(xv.x * s0, xv.y * s1);
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
    load(t + (kStages - 1) * streams,
         xs + (buf + kStages - 1) % kStages * kTileRows * ld);
  }
  rgba::bulk_wait_read<0>();  // shared memory must outlive the last copies
}

int launch_mma(const void* x, const void* gamma_t, const void* beta, void* y,
               long long m, int c, int inverse, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (kN * c + kStages * kGroups * kTileRows * (c + 8)) +
      sizeof(float) * c;
  cudaFuncSetAttribute(gdn_mma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  const long long grid = std::min<long long>(
      (tiles + kGroups - 1) / kGroups,
      rgba::persistent_grid(gdn_mma_kernel, kThreads, smem));
  gdn_mma_kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma_t),
      static_cast<const float*>(beta), static_cast<bf16*>(y), m, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* gamma_t, const void* beta, void* y,
           long long m, int c, int inverse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRows * (c + 1) + kK * c);
  cudaFuncSetAttribute(gdn_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const long long blocks = (m + kRows - 1) / kRows;
  gdn_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma_t),
      static_cast<const float*>(beta), static_cast<float*>(y), m, c, inverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (m, c) contiguous in the activation dtype (fp32 or bf16), 16-byte
// aligned; gamma_t: (c, c) in the same dtype; beta: (c,) fp32.  c % 16 == 0
// and c <= 192 (checked by the Python wrapper).  The dtype picks the kernel.
extern "C" int rgba_gdn(const void* x, const void* gamma_t, const void* beta,
                        void* y, long long m, int c, int inverse, int bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_mma(x, gamma_t, beta, y, m, c, inverse, s);
  return launch(x, gamma_t, beta, y, m, c, inverse, s);
}
