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
// Bound on an H100 SXM (3.35 TB/s): one y slice of the RGB codec at batch
// 16, 512x768, 128 lanes is 49,152 x 16 positions; the function must read
// the indexes (1 B: the codec's uint8 rows) and symbols (2 B: int16) and
// the active flags (1 B), read and write the lane state (8 B) and pointer
// (4 B), write the 16-bit words it emits (2 B each), and read the CDF
// entries the segment addresses with their rows' max value and offset:
// about 3 MB, some 1 us.  It is bound by bytes and far off: each step is
// a chain of dependent operations (the state decides the renorm, the
// division and the next state), the table reads depend on the step's
// symbol, and the launch has only B x L threads (2,048 at batch 16), so
// latency, not bandwidth, sets the pace.
//
// Design (simple and right first): one thread per (image, lane), blocks of
// one warp so the lanes spread over as many SMs as possible; the state in a
// register with uint32 arithmetic (an exact division where the JAX program
// searches the quotient bit by bit); the next step's index, symbol and flag
// loaded a step ahead (they do not depend on the state), read in the
// caller's types (uint8 / int16 / int32 indexes, int16 / int32 symbols) and
// widened in registers, so no widened copy is made; the tables through
// the read-only path (__ldg); the state and pointer read at the start and
// written back at the end, so they stay on the card between the launches of
// one encode.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kPrecision = 16;
constexpr uint32_t kBypassBits = 4;
constexpr uint32_t kBypassMask = (1u << kBypassBits) - 1;
constexpr int kMaxBypassChunks = 8;

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

__device__ __forceinline__ void put_sym(Lane& s, uint32_t start,
                                        uint32_t freq) {
  // freq << 16 wraps modulo 2^32 as in the twins (unreachable: a packed
  // row's frequencies are at most 2^16 - 1)
  if (s.x >= (freq << 16)) emit(s);
  const uint32_t q = s.x / freq;
  s.x = (q << kPrecision) + (s.x - q * freq) + start;
}

template <typename IdxT, typename SymT>
__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(long long* __restrict__ state_io, int* __restrict__ wptr_io,
                   int* __restrict__ words, int budget,
                   const IdxT* __restrict__ indexes,
                   const SymT* __restrict__ symbols,
                   const uint8_t* __restrict__ active,
                   const int* __restrict__ cdfs, int cols,
                   const int* __restrict__ max_values,
                   const int* __restrict__ offsets, int steps,
                   int lanes_total) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes_total || steps <= 0) return;
  Lane s{static_cast<uint32_t>(state_io[lane]), wptr_io[lane],
         words + static_cast<long long>(lane) * budget, budget - 1};
  long long at = static_cast<long long>(steps - 1) * lanes_total + lane;
  int idx_next = static_cast<int>(__ldg(indexes + at));
  int sym_next = static_cast<int>(__ldg(symbols + at));
  uint8_t act_next = __ldg(active + at);
  for (int t = steps - 1; t >= 0; --t, at -= lanes_total) {
    const int idx = idx_next;
    const int sym = sym_next;
    const uint8_t act = act_next;
    if (t > 0) {
      idx_next = static_cast<int>(__ldg(indexes + at - lanes_total));
      sym_next = static_cast<int>(__ldg(symbols + at - lanes_total));
      act_next = __ldg(active + at - lanes_total);
    }
    if (!act) continue;
    const int maxv = __ldg(max_values + idx);
    int value = sym - __ldg(offsets + idx);
    if (value < 0 || value >= maxv) {
      // the escape: raw magnitude in 4-bit chunks (raw fits 32 bits, so at
      // most 8 chunks and one count chunk), pushed high chunk first
      const uint32_t v = static_cast<uint32_t>(value);
      const uint32_t raw = value < 0 ? 0u - 2u * v - 1u
                                     : 2u * (v - static_cast<uint32_t>(maxv));
      int n = 0;
#pragma unroll
      for (int j = 1; j <= kMaxBypassChunks; ++j) {
        if ((raw >> (kBypassBits * (j - 1))) != 0) n = j;
      }
      for (int j = n - 1; j >= 0; --j) {
        put_bits(s, (raw >> (kBypassBits * j)) & kBypassMask);
      }
      put_bits(s, static_cast<uint32_t>(n));
      value = maxv;
    }
    const int* e = cdfs + static_cast<long long>(idx) * cols + value;
    const uint32_t start = static_cast<uint32_t>(__ldg(e));
    put_sym(s, start, static_cast<uint32_t>(__ldg(e + 1)) - start);
  }
  state_io[lane] = static_cast<long long>(s.x);
  wptr_io[lane] = s.wptr;
}

template <typename IdxT, typename SymT>
int launch(void* state, void* wptr, void* words, int budget,
           const void* indexes, const void* symbols, const void* active,
           const void* cdfs, int cols, const void* max_values,
           const void* offsets, int steps, int lanes_total,
           cudaStream_t stream) {
  const int grid = (lanes_total + kThreads - 1) / kThreads;
  rans_encode_kernel<IdxT, SymT><<<grid, kThreads, 0, stream>>>(
      static_cast<long long*>(state), static_cast<int*>(wptr),
      static_cast<int*>(words), budget, static_cast<const IdxT*>(indexes),
      static_cast<const SymT*>(symbols), static_cast<const uint8_t*>(active),
      static_cast<const int*>(cdfs), cols,
      static_cast<const int*>(max_values), static_cast<const int*>(offsets),
      steps, lanes_total);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdxT>
int launch_sym(int sym_bytes, void* state, void* wptr, void* words,
               int budget, const void* indexes, const void* symbols,
               const void* active, const void* cdfs, int cols,
               const void* max_values, const void* offsets, int steps,
               int lanes_total, cudaStream_t stream) {
  switch (sym_bytes) {
    case 2:
      return launch<IdxT, short>(state, wptr, words, budget, indexes,
                                 symbols, active, cdfs, cols, max_values,
                                 offsets, steps, lanes_total, stream);
    case 4:
      return launch<IdxT, int>(state, wptr, words, budget, indexes, symbols,
                               active, cdfs, cols, max_values, offsets,
                               steps, lanes_total, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// state (B*L) int64 holding uint32 values and wptr (B*L) int32, read and
// written in place; words (B*L, budget) int32, written at each lane's
// pointer (clamped to budget - 1); indexes (steps, B*L) of idx_bytes each
// (1: uint8, 2: int16, 4: int32), every index a row of the tables;
// symbols (steps, B*L) of sym_bytes each (2: int16, 4: int32); active
// (steps, B*L) uint8; cdfs (rows, cols) int32 padded with 2^16;
// max_values, offsets (rows,) int32.  Checked by the Python wrapper
// (ops/kernels/rans_encode.py).
extern "C" int rgba_rans_encode(void* state, void* wptr, void* words,
                                int budget, const void* indexes,
                                int idx_bytes, const void* symbols,
                                int sym_bytes, const void* active,
                                const void* cdfs, int cols,
                                const void* max_values, const void* offsets,
                                int steps, int lanes_total, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idx_bytes) {
    case 1:
      return launch_sym<uint8_t>(sym_bytes, state, wptr, words, budget,
                                 indexes, symbols, active, cdfs, cols,
                                 max_values, offsets, steps, lanes_total, s);
    case 2:
      return launch_sym<short>(sym_bytes, state, wptr, words, budget,
                               indexes, symbols, active, cdfs, cols,
                               max_values, offsets, steps, lanes_total, s);
    case 4:
      return launch_sym<int>(sym_bytes, state, wptr, words, budget, indexes,
                             symbols, active, cdfs, cols, max_values,
                             offsets, steps, lanes_total, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
