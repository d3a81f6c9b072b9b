// One segment of the lane-format rANS decode: every (image, lane) takes T
// steps, one symbol a step.
//
// Replaces rgba_tpu/entropy/device_rans.py::decode_segment (:118-191), a
// lax.scan program (not Pallas) that lets the channel-AR decode run on the
// device.  The arithmetic is that of the host coder's lane decoder,
// rans32_decode_lanes (native/rans.cpp:381-447): state uint32 in
// [2^16, 2^32), 16-bit renorm words, 16-bit quantized CDFs, a 4-bit bypass
// escape (one count chunk, at most 8 value chunks).  On a valid stream the
// kernel, the plain version (entropy/device_rans.py::decode_segment) and
// the C++ twin give the same symbols, state and pointer bit for bit.  Like
// the C++ twin, and unlike the JAX scan (which clips the pointer to the
// array), a lane never uses a word at or past its own end.
//
// Bounds on an H100 SXM.  Bytes (3.35 TB/s): one y slice of the RGB codec
// at batch 16, 512x768, 128 lanes is 49,152 x 16 symbols; the function must
// read the indexes (4 B each) and the active flags (1 B), write the symbols
// (4 B), and read the slice's stream words and the CDF rows it addresses
// once each: about 8.1 MB, some 2.4 us.  The chain: a lane's steps depend
// on each other through the state (the state picks the CDF entry, the
// entry the next state, the next state whether a word is shifted in), and
// a launch has only B x L threads (2,048 at batch 16), so no amount of
// parallel work hides a step: the y slice's 384 steps take at least 384
// times the shortest dependent path of one step (one shared-memory read of
// the bucket, the state update and the renorm select), which no byte
// count reaches.
//
// Design.  One thread per (image, lane) (the lane count is part of the
// stream format), blocks of 128 threads: one image of 128 lanes at the
// codec's lane count, its four warps one on each of the SM's schedulers;
// with ~190 KB of tables one block fits an SM, so a batch of up to 132
// images runs in one wave (blocks of one warp measured no faster at batch
// 16 and would need a wave per 33 images).  Nothing the chain waits on
// comes from device memory:
//  - the CDF tables are in shared memory.  The wrapper passes the compact
//    layout of the rows the segment addresses (entropy/device_rans.py::
//    compact_layout: per-row info, the rows as uint16 entries, and per row
//    2^(16-shift) buckets, each row with its own shift, so that a long
//    row's buckets hold as few values as a short row's); thread 0
//    bulk-copies it into dynamic shared memory (cp.async.bulk, completing
//    on an mbarrier) while the threads load their lane state.  A lookup
//    reads one 8-byte bucket, which holds the first candidate value, the
//    count of further candidates and their bounding CDF entries: with no
//    further candidate it is the answer, else a bisection of the
//    candidates' entries.  The dense inverse tables (25 MB, gathered at
//    random in device memory) are gone;
//  - the renorm words are in registers before the state asks for them: at
//    the end of each step the lane loads the kBuffered words from its
//    pointer (the addresses are known before the next state is) and
//    prefetches the line a line ahead into L1, so the loads are L1 hits
//    issued a step before their use, and a renorm only selects.  On a
//    valid stream a step consumes at most kBuffered words (below), so the
//    escape's renorms select too.  No load runs past the end of the words
//    array, and a lane never uses a word at or past its end;
//  - the indexes and active flags come a group of kGroup steps ahead: two
//    groups in registers used in turn, one loading while the other is
//    decoded, and each step's row info from shared memory a step ahead.
//    (A ring refilled step by step, or one group copied into the other,
//    made ptxas move registers whose loads were in flight, and each such
//    move waited for its load);
//  - a step's common path has no branch but the bisection and the rare
//    escape (an inactive step computes a lookup it does not use), so ptxas
//    can schedule the next step's work into this one's waits.
// What bounds it now: one warp per scheduler issues each step's ~90
// instructions largely one after another (their latencies, not memory),
// and at the codec's live weights most y symbols escape, each escape two
// or more bypass chunks on the chain.
// The state and pointer are read at the start and written back at the end,
// so they stay on the card between the launches of one decode.
#include "common.cuh"

namespace {

using namespace rgba;

constexpr int kThreads = 128;
constexpr int kGroup = 8;             // steps whose indexes load together
constexpr int kCopyChunk = 32768;     // bytes a bulk copy
constexpr int kLineWords = 64;        // a 128-byte line of words
constexpr uint32_t kL = 1u << 16;
constexpr int kPrecision = 16;
constexpr uint32_t kBypassBits = 4;
constexpr uint32_t kBypassMask = (1u << kBypassBits) - 1;
constexpr uint32_t kMaxBypassChunks = 8;   // a 32-bit raw value
// The words a step of a valid stream can consume: its renorm, then at most
// three in an escape.  The state is at least 2^16 before each of the
// escape's at most 9 chunks of 4 bits, and a renorm there leaves it at
// least 2^28, so it renorms at most at chunks 1, 5 and 9.
constexpr uint32_t kBuffered = 4;

struct Lane {
  uint32_t x;
  int ptr;
  int end;
  uint32_t w0, w1, w2, w3;   // the words from ptr, loaded once ptr is known
  const uint16_t* words;
  int last;         // the last word of the array
};

// The kBuffered words from ptr, for the next step's renorms (L1 hits: the
// line was prefetched a line ahead), and the line after the next one into
// L1.  Never past the end of the array.
__device__ __forceinline__ void load_word(Lane& s) {
  s.w0 = __ldg(s.words + min(s.ptr, s.last));
  s.w1 = __ldg(s.words + min(s.ptr + 1, s.last));
  s.w2 = __ldg(s.words + min(s.ptr + 2, s.last));
  s.w3 = __ldg(s.words + min(s.ptr + 3, s.last));
  asm volatile("prefetch.global.L1 [%0];"
               :: "l"(s.words + min(s.ptr + kLineWords, s.last)));
}

// A bypass chunk (the escape's path).  A renorm here takes the step's next
// buffered word (`used` of them taken so far); only a corrupt stream, whose
// state can fall below 2^16, takes more than kBuffered in a step, and those
// load where they are needed.
__device__ __forceinline__ uint32_t get_bits(Lane& s, uint32_t& used) {
  const uint32_t v = s.x & kBypassMask;
  s.x >>= kBypassBits;
  if (s.x < kL && s.ptr < s.end) {
    const uint32_t w =
        used >= kBuffered ? static_cast<uint32_t>(__ldg(s.words + s.ptr))
        : used == 0 ? s.w0 : used == 1 ? s.w1 : used == 2 ? s.w2 : s.w3;
    s.x = (s.x << 16) | w;
    ++s.ptr;
    ++used;
  }
  return v;
}

// The group of kGroup steps from `first` (clamped to the last step): each
// lane's index and active flag, loaded a group before they are read.
__device__ __forceinline__ void load_group(const int* __restrict__ indexes,
                                           const uint8_t* __restrict__ active,
                                           int first, int steps,
                                           int lanes_total, int lane,
                                           int (&idx)[kGroup],
                                           int (&act)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const long long at =
        static_cast<long long>(min(first + j, steps - 1)) * lanes_total + lane;
    idx[j] = __ldg(indexes + at);
    act[j] = __ldg(active + at);
  }
}

// One block's decode of its lanes: the tables in shared memory, one lane's
// state, and each step's row info a step ahead.
struct Decoder {
  const int4* sinfo;
  const uint16_t* sstarts;
  const uint2* sbuckets;
  int row0, rows;
  int* syms;
  long long lanes_total;
  int lane, steps;
  Lane s;
  int4 info_next;

  // a row outside the staged group (an inactive step's padding) reads row 0
  // of the group, and its result is not used
  __device__ __forceinline__ void look_ahead(int idx) {
    const int r = idx - row0;
    info_next = sinfo[static_cast<unsigned>(r) < static_cast<unsigned>(rows) ? r : 0];
  }

  // One step.  The common path has no branch but the bisection's loop
  // (taken when a bucket holds more than one value) and the rare escape:
  // an inactive step computes a lookup it does not use, so that the
  // compiler can schedule the next step's work into this one's waits.
  __device__ __forceinline__ void step(int t, int act_flag, int idx_after) {
    const bool act = act_flag != 0;
    const long long at = t * lanes_total + lane;
    const int4 info = info_next;
    look_ahead(idx_after);      // the next step's row info, off this chain
    const uint32_t cum = s.x & 0xFFFFu;
    // the row's buckets start at info.w's low 24 bits, its shift in the top
    const uint2 e = sbuckets[(info.w & 0xFFFFFF) + (cum >> (info.w >> 24))];
    uint32_t a = e.x & 0xFFFFu;
    uint32_t s_a = e.y & 0xFFFFu;
    uint32_t s_b = (e.y >> 16) + 1u;
    uint32_t b = act ? a + (e.x >> 16) + 1u : a + 1u;
    // the last of the entries lo + 1 .. lo + n at or below cum
    const uint16_t* cdf = sstarts + info.x;
    while (b - a > 1u) {
      const uint32_t m = (a + b) >> 1;
      const uint32_t v = cdf[m];
      if (v <= cum) {
        a = m;
        s_a = v;
      } else {
        b = m;
        s_b = v;
      }
    }
    const uint32_t x = (s_b - s_a) * (s.x >> kPrecision) + cum - s_a;
    s.x = act ? x : s.x;
    const bool need = act && s.x < kL && s.ptr < s.end;
    s.x = need ? (s.x << 16) | s.w0 : s.x;
    s.ptr += need ? 1 : 0;
    uint32_t value = a;
    const int maxv = info.y;
    if (act && static_cast<int>(value) == maxv) {
      // the escape: a count chunk, then that many value chunks (at most 8
      // are read, as the twins do, whatever a corrupt count says)
      uint32_t used = need ? 1u : 0u;
      const uint32_t n_bypass = min(get_bits(s, used), kMaxBypassChunks);
      uint32_t raw = 0;
#pragma unroll 1
      for (uint32_t k = 0; k < n_bypass; ++k) {
        raw |= get_bits(s, used) << (kBypassBits * k);
      }
      const uint32_t v = raw >> 1;
      value = (raw & 1u) ? 0u - v - 1u : v + static_cast<uint32_t>(maxv);
    }
    syms[at] = act ? static_cast<int>(value + static_cast<uint32_t>(info.z))
                   : 0;
    // the words at the pointer for the next step's renorms, a step ahead
    load_word(s);
  }

  // steps t0 .. t0 + kGroup - 1 from `cur`; the step after them is `nxt`'s
  // first.  kAll: every one of them exists (no per-step bound check).
  template <bool kAll>
  __device__ __forceinline__ void group(int t0, const int (&cur_idx)[kGroup],
                                        const int (&cur_act)[kGroup],
                                        const int (&nxt_idx)[kGroup]) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (kAll || t0 + j < steps) {
        step(t0 + j, cur_act[j], j + 1 < kGroup ? cur_idx[j + 1] : nxt_idx[0]);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint16_t* __restrict__ words, int n_words,
                   long long* __restrict__ state_io, int* __restrict__ ptr_io,
                   const int* __restrict__ lane_end,
                   const int* __restrict__ indexes,
                   const uint8_t* __restrict__ active,
                   const unsigned char* __restrict__ layout, int head_bytes,
                   int info_bytes, int bucket_offset, int bucket_bytes,
                   int row0, int rows,
                   int* __restrict__ syms, int steps, int lanes_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar, head_bytes + bucket_bytes);
    for (int o = 0; o < head_bytes; o += kCopyChunk) {
      bulk_load(smem + o, layout + o, min(kCopyChunk, head_bytes - o), &bar);
    }
    for (int o = 0; o < bucket_bytes; o += kCopyChunk) {
      bulk_load(smem + head_bytes + o, layout + bucket_offset + o,
                min(kCopyChunk, bucket_bytes - o), &bar);
    }
  }
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lane < lanes_total;
  Decoder d;
  // two groups of indexes and flags in registers, used in turn: while one
  // is decoded, the other loads (a group ahead), so that no step waits on
  // device memory; taking them in turn, not copying one into the other,
  // keeps the compiler from moving registers whose loads are in flight
  int a_idx[kGroup], a_act[kGroup], b_idx[kGroup], b_act[kGroup];
  if (live) {
    d.s = Lane{static_cast<uint32_t>(state_io[lane]), ptr_io[lane],
               lane_end[lane], 0u, 0u, 0u, 0u, words, n_words - 1};
    load_word(d.s);
    load_group(indexes, active, 0, steps, lanes_total, lane, a_idx, a_act);
    load_group(indexes, active, kGroup, steps, lanes_total, lane, b_idx, b_act);
  }
  mbar_wait(&bar, 0);
  if (!live) return;

  d.sinfo = reinterpret_cast<const int4*>(smem);
  d.sstarts = reinterpret_cast<const uint16_t*>(smem + info_bytes);
  d.sbuckets = reinterpret_cast<const uint2*>(smem + head_bytes);
  d.row0 = row0;
  d.rows = rows;
  d.syms = syms;
  d.lanes_total = lanes_total;
  d.lane = lane;
  d.steps = steps;
  d.look_ahead(a_idx[0]);
  int t0 = 0;
  for (; t0 + 2 * kGroup <= steps; t0 += 2 * kGroup) {
    d.group<true>(t0, a_idx, a_act, b_idx);
    load_group(indexes, active, t0 + 2 * kGroup, steps, lanes_total, lane,
               a_idx, a_act);
    d.group<true>(t0 + kGroup, b_idx, b_act, a_idx);
    load_group(indexes, active, t0 + 3 * kGroup, steps, lanes_total, lane,
               b_idx, b_act);
  }
  if (t0 < steps) {             // the last, partial pair of groups
    d.group<false>(t0, a_idx, a_act, b_idx);
    d.group<false>(t0 + kGroup, b_idx, b_act, a_idx);
  }
  state_io[lane] = static_cast<long long>(d.s.x);
  ptr_io[lane] = d.s.ptr;
}

}  // namespace

// words: uint16 (all images' lanes), n_words (at least 1) of them;
// state (B*L) int64 holding uint32 values and ptr (B*L) int32, read and
// written in place; lane_end (B*L) int32; indexes (steps, B*L) int32, each
// a row of [row0, row0 + rows); active (steps, B*L) uint8; layout: the
// compact layout's blob (16-byte aligned), of which the first head_bytes
// (info and rows) and bucket_bytes from bucket_offset are staged; info
// takes the first info_bytes; syms (steps, B*L) int32 out.  Checked by the
// Python wrapper (ops/kernels/rans_decode.py).
extern "C" int rgba_rans_decode(const void* words, int n_words, void* state,
                                void* ptr, const void* lane_end,
                                const void* indexes, const void* active,
                                const void* layout, int head_bytes,
                                int info_bytes, int bucket_offset,
                                int bucket_bytes, int row0, int rows,
                                void* syms, int steps, int lanes_total,
                                void* stream) {
  const int smem = head_bytes + bucket_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (lanes_total + kThreads - 1) / kThreads;
  rans_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), n_words,
      static_cast<long long*>(state), static_cast<int*>(ptr),
      static_cast<const int*>(lane_end), static_cast<const int*>(indexes),
      static_cast<const uint8_t*>(active),
      static_cast<const unsigned char*>(layout), head_bytes, info_bytes,
      bucket_offset, bucket_bytes, row0, rows, static_cast<int*>(syms),
      steps, lanes_total);
  return static_cast<int>(cudaGetLastError());
}
