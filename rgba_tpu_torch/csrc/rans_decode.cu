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
// array), a lane never reads a word at or past its own end.
//
// Bound on an H100 SXM (3.35 TB/s): one y slice of the RGB codec at batch
// 16, 512x768, 128 lanes is 49,152 x 16 symbols; the function must read
// the indexes (4 B each) and the active flags (1 B), write the symbols
// (4 B), and read the slice's stream words and the CDF rows it addresses
// once each: about 8.1 MB, some 2.4 us (the inverse tables are this
// kernel's choice, not the function's, and are not counted).  It is bound
// by bytes, far off: each step is a chain of dependent loads (the state picks
// the inverse-table entry, the updated state decides the renorm read, that
// read sets the next step's entry), and the launch has only B x L threads
// (2,048 at batch 16), so latency, not bandwidth, sets the pace.
//
// Design (simple, as the lane count is part of the stream format): one
// thread per (image, lane), blocks of one warp so the lanes spread over
// as many SMs as possible, a loop over the segment's T steps with the
// next step's index and flag loaded a step ahead (they do not depend on
// the state), the tables through the read-only path (__ldg), and the
// state and pointer read at the start and written back at the end, so
// they stay on the card between the launches of one decode.  y segments
// pass the dense inverse tables (two independent gathers a step); the z
// segment passes none and searches its CDF row.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr uint32_t kL = 1u << 16;
constexpr int kPrecision = 16;
constexpr uint32_t kBypassBits = 4;
constexpr uint32_t kBypassMask = (1u << kBypassBits) - 1;
constexpr int kMaxBypassChunks = 8;

struct Lane {
  uint32_t x;
  int ptr;
  int end;
};

__device__ __forceinline__ void renorm(Lane& s,
                                       const uint16_t* __restrict__ words) {
  if (s.x < kL && s.ptr < s.end) {
    s.x = (s.x << 16) | static_cast<uint32_t>(__ldg(words + s.ptr));
    ++s.ptr;
  }
}

__device__ __forceinline__ uint32_t get_bits(Lane& s,
                                             const uint16_t* __restrict__ words) {
  const uint32_t v = s.x & kBypassMask;
  s.x >>= kBypassBits;
  renorm(s, words);
  return v;
}

__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint16_t* __restrict__ words,
                   long long* __restrict__ state_io, int* __restrict__ ptr_io,
                   const int* __restrict__ lane_end,
                   const int* __restrict__ indexes,
                   const uint8_t* __restrict__ active,
                   const int* __restrict__ cdfs, int cols,
                   const int* __restrict__ max_values,
                   const int* __restrict__ offsets,
                   const int* __restrict__ inv_si,
                   const int* __restrict__ inv_val,
                   int* __restrict__ syms, int steps, int lanes_total) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes_total) return;
  Lane s{static_cast<uint32_t>(state_io[lane]), ptr_io[lane], lane_end[lane]};
  int idx_next = steps > 0 ? __ldg(indexes + lane) : 0;
  uint8_t act_next = steps > 0 ? __ldg(active + lane) : 0;
  for (int t = 0; t < steps; ++t) {
    const long long at = static_cast<long long>(t) * lanes_total + lane;
    const int idx = idx_next;
    const uint8_t act = act_next;
    if (t + 1 < steps) {
      idx_next = __ldg(indexes + at + lanes_total);
      act_next = __ldg(active + at + lanes_total);
    }
    if (!act) {
      syms[at] = 0;
      continue;
    }
    const uint32_t cum = s.x & 0xFFFFu;
    uint32_t start, freq, value;
    if (inv_si != nullptr) {
      const uint32_t si = static_cast<uint32_t>(
          __ldg(inv_si + (static_cast<long long>(idx) << kPrecision) + cum));
      const uint32_t w = static_cast<uint32_t>(__ldg(
          inv_val + (static_cast<long long>(idx) << (kPrecision - 1)) +
          (cum >> 1)));
      start = si & 0xFFFFu;
      freq = (si >> 16) + 1u;
      value = (w >> ((cum & 1u) * 16u)) & 0xFFFFu;
    } else {
      // the rows are padded with 2^16 > cum and rise strictly, so the first
      // entry above cum is the count of the entries at or below it
      const int* row = cdfs + static_cast<long long>(idx) * cols;
      int v = 0;
      while (v < cols - 1 && __ldg(row + v + 1) <= static_cast<int>(cum)) ++v;
      value = static_cast<uint32_t>(v);
      start = static_cast<uint32_t>(__ldg(row + v));
      freq = static_cast<uint32_t>(__ldg(row + v + 1)) - start;
    }
    s.x = freq * (s.x >> kPrecision) + cum - start;
    renorm(s, words);
    const int maxv = __ldg(max_values + idx);
    if (static_cast<int>(value) == maxv) {
      const uint32_t n_bypass = get_bits(s, words);
      uint32_t raw = 0;
#pragma unroll
      for (int j = 0; j < kMaxBypassChunks; ++j) {
        if (static_cast<uint32_t>(j) < n_bypass) {
          raw |= get_bits(s, words) << (kBypassBits * j);
        }
      }
      const uint32_t v = raw >> 1;
      value = (raw & 1u) ? 0u - v - 1u : v + static_cast<uint32_t>(maxv);
    }
    syms[at] = static_cast<int>(value + static_cast<uint32_t>(
                                            __ldg(offsets + idx)));
  }
  state_io[lane] = static_cast<long long>(s.x);
  ptr_io[lane] = s.ptr;
}

}  // namespace

// words: uint16 (all images' lanes); state (B*L) int64 holding uint32
// values and ptr (B*L) int32, read and written in place; lane_end (B*L)
// int32; indexes (steps, B*L) int32, every one a row of the tables;
// active (steps, B*L) uint8; cdfs (rows, cols) int32 padded with 2^16;
// max_values, offsets (rows,) int32; inv_si (rows * 2^16) and inv_val
// (rows * 2^15) int32, or both null for the row search; syms (steps, B*L)
// int32 out.  Checked by the Python wrapper (ops/kernels/rans_decode.py).
extern "C" int rgba_rans_decode(const void* words, void* state, void* ptr,
                                const void* lane_end, const void* indexes,
                                const void* active, const void* cdfs, int cols,
                                const void* max_values, const void* offsets,
                                const void* inv_si, const void* inv_val,
                                void* syms, int steps, int lanes_total,
                                void* stream) {
  const int grid = (lanes_total + kThreads - 1) / kThreads;
  rans_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), static_cast<long long*>(state),
      static_cast<int*>(ptr), static_cast<const int*>(lane_end),
      static_cast<const int*>(indexes), static_cast<const uint8_t*>(active),
      static_cast<const int*>(cdfs), cols,
      static_cast<const int*>(max_values), static_cast<const int*>(offsets),
      static_cast<const int*>(inv_si), static_cast<const int*>(inv_val),
      static_cast<int*>(syms), steps, lanes_total);
  return static_cast<int>(cudaGetLastError());
}
