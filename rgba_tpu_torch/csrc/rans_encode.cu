// One segment of the lane-format rANS encode: every (image, lane) walks the
// segment's T steps backwards, T-1 down to 0, and pushes one symbol a step.
//
// Replaces rgba_tpu/entropy/device_rans.py::encode_segment (:272-332), a
// reverse lax.scan program (not Pallas) that lets the v3 encode fetch only
// the finished words instead of every symbol and index.  The arithmetic is
// that of the host coder's lane encoder, rans32_encode_lanes
// (native/rans.cpp:331-379): state uint32 in [2^16, 2^32), 16-bit renorm
// words, 16-bit quantized CDFs, a 4-bit bypass escape (the chunks high
// first, then one count chunk, then the escape value, the reverse of the
// decoder's reads).  The kernel, the plain version
// (entropy/device_rans.py::encode_segment) and the C++ twin give the same
// words, state and pointer bit for bit.  Each lane has a budget of W words:
// writes past it are clamped to slot W-1 while the pointer counts on, as in
// the JAX program, so an overflowing lane never writes out of bounds and
// finish_lanes sees the overflow.  The flush and the reversal of each lane's
// words into decode order (finish_lanes) are layout, done by plain tensor
// indexing on the card (entropy/device_rans.py::finish_lanes).
//
// Bounds on an H100 SXM.  Bytes (3.35 TB/s): one y slice of the RGB codec
// at batch 16, 512x768, 128 lanes is 49,152 x 16 positions; the function
// must read the indexes (1 B: the codec's uint8 rows) and symbols (2 B:
// int16) and the active flags (1 B), read and write the lane state (8 B)
// and pointer (4 B), write the 16-bit words it emits (2 B each), and read
// the CDF entries the segment addresses with their rows' max value and
// offset: about 3 MB, some 1 us.  The chain: each step's state depends on
// the last (the state decides the renorm, the quotient and the next
// state), and a launch has only B x L threads (2,048 at batch 16), so the
// y slice's 384 steps take at least 384 times the shortest dependent path
// of one step (the renorm compare and select, a high multiply and four
// integer operations for the quotient, a multiply-add), which no byte count
// reaches.
//
// Design.  One thread per (image, lane), blocks of 128 threads, as the
// decode.  Nothing the chain waits on comes from device memory, and it
// divides nothing:
//  - the tables are in shared memory: the same compact layout as the decode
//    (entropy/device_rans.py::compact_layout), of which the encode stages
//    the per-row info, the rows as uint16 entries and, beside each entry,
//    the exact reciprocal of its frequency (one bulk copy, completing on an
//    mbarrier, while the threads load their lane state);
//  - the indexes, symbols and active flags come a group of kGroup steps
//    ahead: two groups in registers used in turn, one loading while the
//    other is coded, read in the caller's types (uint8 / int16 / int32
//    indexes, int16 / int32 symbols) and widened by the loads;
//  - a step's table reads (row info, the escape decision and its raw bits,
//    start, frequency and reciprocal) depend on its index and symbol only,
//    so they are made ahead of the state chain in three stages a step
//    apart (software-pipelined), no stage waiting on its own loads;
//  - the quotient x / freq is Granlund and Montgomery's exact division by
//    an invariant (entropy/device_rans.py::reciprocal): a __umulhi, a
//    subtract, two shifts and an add, exact for every uint32 x and every
//    freq in [1, 2^16), in place of a 32-bit division;
//  - a step's common path has no branch but the rare escape (the renorm's
//    store is predicated), so ptxas can schedule the coming steps' stages
//    into the chain's waits.
// What bounds it now: one warp per scheduler issues each step's ~65
// instructions largely one after another (their latencies, not memory).
// Words are stored off the chain at the lane's pointer; the state and
// pointer are read at the start and written back at the end, so they stay
// on the card between the launches of one encode.
#include "common.cuh"

namespace {

using namespace rgba;

constexpr int kThreads = 128;
constexpr int kGroup = 8;             // steps whose inputs load together
constexpr int kCopyChunk = 32768;     // bytes a bulk copy
constexpr int kPrecision = 16;
constexpr uint32_t kBypassBits = 4;
constexpr uint32_t kBypassMask = (1u << kBypassBits) - 1;

struct Lane {
  uint32_t x;
  int wptr;
  int* words;  // this lane's W slots
  int last;    // W - 1
};

// Renorm: write the low 16 bits at the pointer (clamped to the last slot)
// and shift them out.
__device__ __forceinline__ void emit(Lane& s) {
  s.words[min(s.wptr, s.last)] = static_cast<int>(s.x & 0xFFFFu);
  ++s.wptr;
  s.x >>= 16;
}

__device__ __forceinline__ void put_bits(Lane& s, uint32_t val) {
  if (s.x >= (1u << (32 - kBypassBits))) emit(s);
  s.x = (s.x << kBypassBits) | val;
}

// A step's coding is made in three stages, each a step before the next,
// so that no stage waits on a shared-memory load issued in its own step:
// (A) two steps ahead, the row's info; (B) a step ahead, the value, the
// escape and the loads of its CDF entries and reciprocal; (C) in its own
// step, ahead of the state chain, the frequency and the quotient's shifts.

// idx: the step's row; one outside the staged group [row0, row0 + rows)
// (an inactive step's padding) reads row 0 of the group, and its result is
// not used.
__device__ __forceinline__ int4 stage_a(int idx, int row0, int rows,
                                        const int4* __restrict__ sinfo) {
  const int r = idx - row0;
  return sinfo[static_cast<unsigned>(r) < static_cast<unsigned>(rows) ? r : 0];
}

struct Loaded {       // stage B's output
  bool act;
  bool esc;
  int n;              // bypass value chunks
  uint32_t raw;       // the escape's raw bits
  uint32_t s0, s1;    // the value's CDF entry and the next (2^16 stored as 0)
  uint32_t m;         // the reciprocal's multiplier
};

__device__ __forceinline__ Loaded stage_b(const int4& info, int sym, int act,
                                          const uint16_t* __restrict__ sstarts,
                                          const uint32_t* __restrict__ srcp) {
  Loaded b;
  b.act = act != 0;
  const int maxv = info.y;
  const int value = sym - info.z;
  b.esc = value < 0 || value >= maxv;
  // the escape: raw magnitude in 4-bit chunks (raw fits 32 bits, so at most
  // 8 chunks and one count chunk), pushed high chunk first
  const uint32_t v = static_cast<uint32_t>(value);
  const uint32_t raw = value < 0 ? 0u - 2u * v - 1u
                                 : 2u * (v - static_cast<uint32_t>(maxv));
  b.raw = b.esc ? raw : 0u;
  b.n = (35 - __clz(b.raw)) >> 2;     // __clz(0) is 32: no chunk
  const int at = info.x + (b.esc ? maxv : value);
  b.s0 = sstarts[at];
  b.s1 = sstarts[at + 1];
  b.m = srcp[at];
  return b;
}

struct Coded {        // stage C's output
  bool act;
  bool esc;
  int n;
  uint32_t raw;
  uint32_t start;
  uint32_t cmpl;      // 2^16 - freq
  uint32_t x_max;     // freq << 16: renorm at or above
  uint32_t m;         // the reciprocal's multiplier
  uint32_t sh1, sh2;  // and its shifts
};

__device__ __forceinline__ Coded stage_c(const Loaded& b) {
  Coded c;
  c.act = b.act;
  c.esc = b.esc;
  c.n = b.n;
  c.raw = b.raw;
  c.start = b.s0;
  const uint32_t freq = ((b.s1 - 1u) & 0xFFFFu) + 1u - b.s0;
  c.cmpl = (1u << kPrecision) - freq;
  // freq << 16 wraps modulo 2^32 as in the twins (unreachable: a packed
  // row's frequencies are at most 2^16 - 1)
  c.x_max = freq << 16;
  c.m = b.m;
  const uint32_t l = 32u - static_cast<uint32_t>(__clz(freq - 1u));
  c.sh1 = min(l, 1u);
  c.sh2 = max(l, 1u) - 1u;
  return c;
}

// The escape's bypass chunks, high chunk first, then their count (the
// rare path).
__device__ __forceinline__ void put_escape(Lane& s, const Coded& c) {
  for (int j = c.n - 1; j >= 0; --j) {
    put_bits(s, (c.raw >> (kBypassBits * j)) & kBypassMask);
  }
  put_bits(s, static_cast<uint32_t>(c.n));
}

// One step on the state chain; an inactive step leaves the lane as it is.
// The common path has no branch (the renorm's store is predicated), so the
// compiler can schedule the coming steps' stages into its waits.
__device__ __forceinline__ void put(Lane& s, const Coded& c) {
  if (c.act && c.esc) put_escape(s, c);
  const bool emit_word = c.act && s.x >= c.x_max;
  if (emit_word) s.words[min(s.wptr, s.last)] = static_cast<int>(s.x & 0xFFFFu);
  s.wptr += emit_word ? 1 : 0;
  const uint32_t x = emit_word ? s.x >> 16 : s.x;
  // q = x / freq, exactly; x' = (q << 16) + x % freq + start
  //                          = q (2^16 - freq) + (x + start)
  const uint32_t t = __umulhi(x, c.m);
  const uint32_t xs = x + c.start;
  const uint32_t q = (t + ((x - t) >> c.sh1)) >> c.sh2;
  s.x = c.act ? q * c.cmpl + xs : x;
}

// The group of kGroup steps taken from the `first`-th (step t =
// steps-1-first, walking down; clamped to the last step taken): each
// lane's index, symbol and active flag in the caller's types, widened by
// the loads.
template <typename IdxT, typename SymT>
__device__ __forceinline__ void load_group(const IdxT* __restrict__ indexes,
                                           const SymT* __restrict__ symbols,
                                           const uint8_t* __restrict__ active,
                                           int first, int steps,
                                           long long lanes_total, int lane,
                                           int (&idx)[kGroup],
                                           int (&sym)[kGroup],
                                           int (&act)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const long long at = max(steps - 1 - (first + j), 0) * lanes_total + lane;
    idx[j] = static_cast<int>(__ldg(indexes + at));
    sym[j] = static_cast<int>(__ldg(symbols + at));
    act[j] = __ldg(active + at);
  }
}

// One block's encode of its lanes: the tables in shared memory, one lane's
// state, and the three stages of the coming steps.
struct Encoder {
  const int4* sinfo;
  const uint16_t* sstarts;
  const uint32_t* srcp;
  int row0, rows, steps;
  Lane s;
  Loaded b_cur;     // stage B of the step about to be taken
  int4 a_next;      // stage A of the step after it

  // the i-th step taken; idx2 is the index of the (i + 2)-th, sym1 and
  // act1 the symbol and flag of the (i + 1)-th
  __device__ __forceinline__ void step(int idx2, int sym1, int act1) {
    const int4 a_after = stage_a(idx2, row0, rows, sinfo);
    const Coded cur = stage_c(b_cur);
    b_cur = stage_b(a_next, sym1, act1, sstarts, srcp);
    a_next = a_after;
    put(s, cur);
  }

  // the kGroup steps from the i0-th, from `cur`; the steps after them
  // begin `nxt`.  kAll: every one of them exists (no per-step bound check).
  template <bool kAll>
  __device__ __forceinline__ void group(int i0, const int (&cur_sym)[kGroup],
                                        const int (&cur_act)[kGroup],
                                        const int (&cur_idx)[kGroup],
                                        const int (&nxt_idx)[kGroup],
                                        const int (&nxt_sym)[kGroup],
                                        const int (&nxt_act)[kGroup]) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (kAll || i0 + j < steps) {
        step(j + 2 < kGroup ? cur_idx[j + 2] : nxt_idx[j + 2 - kGroup],
             j + 1 < kGroup ? cur_sym[j + 1] : nxt_sym[0],
             j + 1 < kGroup ? cur_act[j + 1] : nxt_act[0]);
      }
    }
  }
};

template <typename IdxT, typename SymT>
__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(long long* __restrict__ state_io, int* __restrict__ wptr_io,
                   int* __restrict__ words, int budget,
                   const IdxT* __restrict__ indexes,
                   const SymT* __restrict__ symbols,
                   const uint8_t* __restrict__ active,
                   const unsigned char* __restrict__ layout, int head_bytes,
                   int info_bytes, int starts_bytes, int row0, int rows,
                   int steps, int lanes_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar, head_bytes);
    for (int o = 0; o < head_bytes; o += kCopyChunk) {
      bulk_load(smem + o, layout + o, min(kCopyChunk, head_bytes - o), &bar);
    }
  }
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lane < lanes_total;
  Encoder e;
  // two groups of inputs in registers, used in turn: while one is coded,
  // the other loads (a group ahead), so that no step waits on device
  // memory; taking them in turn, not copying one into the other, keeps the
  // compiler from moving registers whose loads are in flight
  int a_idx[kGroup], a_sym[kGroup], a_act[kGroup];
  int b_idx[kGroup], b_sym[kGroup], b_act[kGroup];
  if (live) {
    e.s = Lane{static_cast<uint32_t>(state_io[lane]), wptr_io[lane],
               words + static_cast<long long>(lane) * budget, budget - 1};
    load_group(indexes, symbols, active, 0, steps, lanes_total, lane, a_idx,
               a_sym, a_act);
    load_group(indexes, symbols, active, kGroup, steps, lanes_total, lane,
               b_idx, b_sym, b_act);
  }
  mbar_wait(&bar, 0);
  if (!live) return;

  e.sinfo = reinterpret_cast<const int4*>(smem);
  e.sstarts = reinterpret_cast<const uint16_t*>(smem + info_bytes);
  e.srcp = reinterpret_cast<const uint32_t*>(smem + info_bytes + starts_bytes);
  e.row0 = row0;
  e.rows = rows;
  e.steps = steps;
  // the pipeline's fill: stage B of step 0, stage A of step 1
  e.b_cur = stage_b(stage_a(a_idx[0], row0, rows, e.sinfo), a_sym[0],
                    a_act[0], e.sstarts, e.srcp);
  e.a_next = stage_a(a_idx[1], row0, rows, e.sinfo);
  int i0 = 0;
  for (; i0 + 2 * kGroup <= steps; i0 += 2 * kGroup) {
    e.group<true>(i0, a_sym, a_act, a_idx, b_idx, b_sym, b_act);
    load_group(indexes, symbols, active, i0 + 2 * kGroup, steps, lanes_total,
               lane, a_idx, a_sym, a_act);
    e.group<true>(i0 + kGroup, b_sym, b_act, b_idx, a_idx, a_sym, a_act);
    load_group(indexes, symbols, active, i0 + 3 * kGroup, steps, lanes_total,
               lane, b_idx, b_sym, b_act);
  }
  if (i0 < steps) {             // the last, partial pair of groups
    e.group<false>(i0, a_sym, a_act, a_idx, b_idx, b_sym, b_act);
    e.group<false>(i0 + kGroup, b_sym, b_act, b_idx, a_idx, a_sym, a_act);
  }
  state_io[lane] = static_cast<long long>(e.s.x);
  wptr_io[lane] = e.s.wptr;
}

template <typename IdxT, typename SymT>
int launch(void* state, void* wptr, void* words, int budget,
           const void* indexes, const void* symbols, const void* active,
           const void* layout, int head_bytes, int info_bytes,
           int starts_bytes, int row0, int rows, int steps, int lanes_total,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rans_encode_kernel<IdxT, SymT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, head_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (lanes_total + kThreads - 1) / kThreads;
  rans_encode_kernel<IdxT, SymT><<<grid, kThreads, head_bytes, stream>>>(
      static_cast<long long*>(state), static_cast<int*>(wptr),
      static_cast<int*>(words), budget, static_cast<const IdxT*>(indexes),
      static_cast<const SymT*>(symbols), static_cast<const uint8_t*>(active),
      static_cast<const unsigned char*>(layout), head_bytes, info_bytes,
      starts_bytes, row0, rows, steps, lanes_total);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdxT>
int launch_sym(int sym_bytes, void* state, void* wptr, void* words,
               int budget, const void* indexes, const void* symbols,
               const void* active, const void* layout, int head_bytes,
               int info_bytes, int starts_bytes, int row0, int rows,
               int steps, int lanes_total, cudaStream_t stream) {
  switch (sym_bytes) {
    case 2:
      return launch<IdxT, short>(state, wptr, words, budget, indexes,
                                 symbols, active, layout, head_bytes,
                                 info_bytes, starts_bytes, row0, rows, steps,
                                 lanes_total, stream);
    case 4:
      return launch<IdxT, int>(state, wptr, words, budget, indexes, symbols,
                               active, layout, head_bytes, info_bytes,
                               starts_bytes, row0, rows, steps, lanes_total,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// state (B*L) int64 holding uint32 values and wptr (B*L) int32, read and
// written in place; words (B*L, budget) int32, written at each lane's
// pointer (clamped to budget - 1); indexes (steps, B*L) of idx_bytes each
// (1: uint8, 2: int16, 4: int32), each a row of [row0, row0 + rows);
// symbols (steps, B*L) of sym_bytes each (2: int16, 4: int32); active
// (steps, B*L) uint8; layout: the compact layout's blob (16-byte aligned),
// of which the first head_bytes (info, rows and reciprocals; info the
// first info_bytes, the rows the next starts_bytes) are staged.  Checked
// by the Python wrapper (ops/kernels/rans_encode.py).
extern "C" int rgba_rans_encode(void* state, void* wptr, void* words,
                                int budget, const void* indexes,
                                int idx_bytes, const void* symbols,
                                int sym_bytes, const void* active,
                                const void* layout, int head_bytes,
                                int info_bytes, int starts_bytes, int row0,
                                int rows, int steps, int lanes_total,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idx_bytes) {
    case 1:
      return launch_sym<uint8_t>(sym_bytes, state, wptr, words, budget,
                                 indexes, symbols, active, layout, head_bytes,
                                 info_bytes, starts_bytes, row0, rows, steps,
                                 lanes_total, s);
    case 2:
      return launch_sym<short>(sym_bytes, state, wptr, words, budget,
                               indexes, symbols, active, layout, head_bytes,
                               info_bytes, starts_bytes, row0, rows, steps,
                               lanes_total, s);
    case 4:
      return launch_sym<int>(sym_bytes, state, wptr, words, budget, indexes,
                             symbols, active, layout, head_bytes, info_bytes,
                             starts_bytes, row0, rows, steps, lanes_total, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
