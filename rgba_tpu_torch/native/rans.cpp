// Host-side rANS range coder for the TPU RGBA codec.
//
// The reference relies on compressai.ans (pybind11 C++ rANS; SURVEY §2.2 N1)
// for real bitstreams.  This is a from-scratch implementation of the same
// public coding scheme — the 64-bit rANS of Giesen (ryg_rans, public
// domain) with 16-bit quantized CDFs and a 4-bit bypass escape for
// out-of-range symbols — exposed through a plain C ABI for ctypes (no
// pybind11 in this environment).
//
// Layout contract with the Python side:
//   * cdfs:        int32 matrix (rows x cols), row r holds cdf_lengths[r]
//                  valid entries: cdf[0]=0 .. cdf[len-1]=1<<16
//   * indexes[i]:  row of the CDF used for symbol i
//   * offsets[r]:  integer offset of row r; coded value = symbol - offset
//   * max coded value per row = cdf_lengths[r] - 2; values outside
//     [0, max) escape to bypass coding
//
// Build: g++ -O3 -shared -fPIC rans.cpp -o librans.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kRansL = 1ull << 31;
constexpr uint32_t kPrecision = 16;
constexpr uint32_t kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;

inline void enc_put(uint64_t& x, uint32_t*& pptr, uint32_t start,
                    uint32_t freq) {
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    *(--pptr) = static_cast<uint32_t>(x);
    x >>= 32;
  }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void enc_put_bits(uint64_t& x, uint32_t*& pptr, uint32_t val,
                         uint32_t nbits) {
  const uint64_t freq = 1u << (kPrecision - nbits);
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    *(--pptr) = static_cast<uint32_t>(x);
    x >>= 32;
  }
  x = (x << nbits) | val;
}

inline void enc_flush(uint64_t& x, uint32_t*& pptr) {
  pptr -= 2;
  pptr[0] = static_cast<uint32_t>(x);
  pptr[1] = static_cast<uint32_t>(x >> 32);
}

inline void dec_init(uint64_t& x, uint32_t const*& ptr) {
  x = (static_cast<uint64_t>(ptr[1]) << 32) | ptr[0];
  ptr += 2;
}

inline uint32_t dec_get(const uint64_t x) {
  return static_cast<uint32_t>(x & ((1u << kPrecision) - 1));
}

inline void dec_advance(uint64_t& x, uint32_t const*& ptr, uint32_t start,
                        uint32_t freq) {
  const uint64_t mask = (1ull << kPrecision) - 1;
  x = freq * (x >> kPrecision) + (x & mask) - start;
  if (x < kRansL) {
    x = (x << 32) | *ptr++;
  }
}

inline uint32_t dec_get_bits(uint64_t& x, uint32_t const*& ptr,
                             uint32_t nbits) {
  const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
  x >>= nbits;
  if (x < kRansL) {
    x = (x << 32) | *ptr++;
  }
  return val;
}

// One op in decode order: either a CDF-coded value or raw bypass bits.
struct Op {
  uint32_t start;
  uint32_t freq;
  uint32_t bits_val;  // valid when freq == 0 (bypass)
  bool bypass;
};

void append_symbol_ops(std::vector<Op>& ops, int32_t symbol, int32_t index,
                       const int32_t* cdfs, int cols,
                       const int32_t* cdf_lengths, const int32_t* offsets) {
  const int32_t* cdf = cdfs + static_cast<int64_t>(index) * cols;
  const int32_t max_value = cdf_lengths[index] - 2;
  int32_t value = symbol - offsets[index];

  uint32_t raw_val = 0;
  if (value < 0) {
    raw_val = static_cast<uint32_t>(-2 * value - 1);
    value = max_value;
  } else if (value >= max_value) {
    raw_val = static_cast<uint32_t>(2 * (value - max_value));
    value = max_value;
  }

  Op sym;
  sym.start = static_cast<uint32_t>(cdf[value]);
  sym.freq = static_cast<uint32_t>(cdf[value + 1] - cdf[value]);
  sym.bypass = false;
  ops.push_back(sym);

  if (value == max_value) {
    // count of 4-bit bypass chunks holding raw_val: at most 8 for 32 bits
    // (a shift by 32 would be undefined, and on x86 never reach 0)
    uint32_t n_bypass = 0;
    while (n_bypass < 32 / kBypassPrecision &&
           (raw_val >> (n_bypass * kBypassPrecision)) != 0) {
      ++n_bypass;
    }
    uint32_t val = n_bypass;
    while (val >= kMaxBypassVal) {
      ops.push_back({0, 0, kMaxBypassVal, true});
      val -= kMaxBypassVal;
    }
    ops.push_back({0, 0, val, true});
    for (uint32_t j = 0; j < n_bypass; ++j) {
      ops.push_back(
          {0, 0, (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal, true});
    }
  }
}

}  // namespace

extern "C" {

// Quantize a pmf (tail mass included as last entry) into a 16-bit CDF.
// out must hold n+1 uint32 entries. Returns 0 on success.
int rans_pmf_to_quantized_cdf(const float* pmf, int n, int precision,
                              uint32_t* out) {
  if (n <= 0 || precision <= 0 || precision > 24) return -1;
  std::vector<uint64_t> cdf(n + 1, 0);
  double total_check = 0.0;
  for (int i = 0; i < n; ++i) {
    if (!(pmf[i] >= 0.f)) return -2;
    total_check += pmf[i];
    cdf[i + 1] = static_cast<uint64_t>(
        pmf[i] * static_cast<double>(1u << precision) + 0.5);
  }
  if (total_check <= 0.0) return -3;
  uint64_t total = 0;
  for (int i = 0; i <= n; ++i) total += cdf[i];
  if (total == 0) return -3;
  for (int i = 0; i <= n; ++i) {
    cdf[i] = (static_cast<uint64_t>(1u << precision) * cdf[i]) / total;
  }
  for (int i = 1; i <= n; ++i) cdf[i] += cdf[i - 1];
  cdf[n] = 1u << precision;

  std::vector<int64_t> c(cdf.begin(), cdf.end());
  for (int i = 0; i < n; ++i) {
    if (c[i] == c[i + 1]) {
      int64_t best_freq = INT64_MAX;
      int best = -1;
      for (int j = 0; j < n; ++j) {
        const int64_t freq = c[j + 1] - c[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best = j;
        }
      }
      if (best < 0) return -4;
      if (best < i) {
        for (int j = best + 1; j <= i; ++j) --c[j];
      } else {
        for (int j = i + 1; j <= best; ++j) ++c[j];
      }
    }
  }
  for (int i = 0; i <= n; ++i) out[i] = static_cast<uint32_t>(c[i]);
  return 0;
}

// Encode n symbols. Returns number of bytes written, or -1 if out_cap is
// too small (call again with a bigger buffer).
int64_t rans_encode_with_indexes(const int32_t* symbols,
                                 const int32_t* indexes, int64_t n,
                                 const int32_t* cdfs, int rows, int cols,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, uint8_t* out,
                                 int64_t out_cap) {
  (void)rows;
  std::vector<Op> ops;
  ops.reserve(n + 16);
  for (int64_t i = 0; i < n; ++i) {
    append_symbol_ops(ops, symbols[i], indexes[i], cdfs, cols, cdf_lengths,
                      offsets);
  }

  // worst case one 32-bit word per op + 2 flush words
  std::vector<uint32_t> buf(ops.size() + 4);
  uint32_t* pptr = buf.data() + buf.size();
  uint64_t state = kRansL;
  for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
    if (it->bypass) {
      enc_put_bits(state, pptr, it->bits_val, kBypassPrecision);
    } else {
      enc_put(state, pptr, it->start, it->freq);
    }
  }
  enc_flush(state, pptr);

  const int64_t nwords = buf.data() + buf.size() - pptr;
  const int64_t nbytes = nwords * 4;
  if (nbytes > out_cap) return -1;
  std::memcpy(out, pptr, nbytes);
  return nbytes;
}

// ---- streaming decoder (slice-by-slice decode, SURVEY §3.4) ----

struct RansDecoderState {
  std::vector<uint32_t> words;
  uint32_t const* ptr;
  uint64_t state;
};

void* rans_decoder_new(const uint8_t* data, int64_t nbytes) {
  auto* d = new RansDecoderState();
  d->words.resize((nbytes + 3) / 4 + 8, 0);  // zero-pad tail reads
  std::memcpy(d->words.data(), data, nbytes);
  d->ptr = d->words.data();
  dec_init(d->state, d->ptr);
  return d;
}

void rans_decoder_free(void* handle) {
  delete static_cast<RansDecoderState*>(handle);
}

// Decode n symbols from the stream using per-symbol CDF rows.
int rans_decode_stream(void* handle, const int32_t* indexes, int64_t n,
                       const int32_t* cdfs, int rows, int cols,
                       const int32_t* cdf_lengths, const int32_t* offsets,
                       int32_t* out) {
  (void)rows;
  auto* d = static_cast<RansDecoderState*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t index = indexes[i];
    const int32_t* cdf = cdfs + static_cast<int64_t>(index) * cols;
    const int32_t max_value = cdf_lengths[index] - 2;

    const uint32_t cum = dec_get(d->state);
    // linear scan is fine: rows are short (<= ~130 entries)
    int32_t value = 0;
    while (static_cast<uint32_t>(cdf[value + 1]) <= cum) ++value;
    dec_advance(d->state, d->ptr, static_cast<uint32_t>(cdf[value]),
                static_cast<uint32_t>(cdf[value + 1] - cdf[value]));

    if (value == max_value) {
      uint32_t val = dec_get_bits(d->state, d->ptr, kBypassPrecision);
      uint32_t n_bypass = val;
      while (val == kMaxBypassVal) {
        val = dec_get_bits(d->state, d->ptr, kBypassPrecision);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec_get_bits(d->state, d->ptr, kBypassPrecision)
                   << (j * kBypassPrecision);
      }
      int32_t v = static_cast<int32_t>(raw_val >> 1);
      value = (raw_val & 1) ? -v - 1 : v + max_value;
    }
    out[i] = value + offsets[index];
  }
  return 0;
}

// ---- 32-bit lane-interleaved rANS (device-decodable stream format) ----
//
// State lives in [2^16, 2^32); renorm emits/reads 16-bit words.  Each
// image stream is L independent lane streams, so a TPU lax.scan can
// decode L symbols per step entirely on-device
// (rgba_tpu/entropy/device_rans.py) — the channel-AR decode's
// host<->device index round trips (the 11-sync critical path measured in
// PERFORMANCE.md round-4) vanish.  The coded symbol scheme (16-bit
// quantized CDFs, 4-bit bypass escape) is IDENTICAL to the 64-bit coder
// above; only the state width / renorm granularity and the lane split
// differ, costing ~4 bytes flush per lane.
//
// Lane assignment contract with the device decoder: symbols arrive as
// one flat sequence cut into SEGMENTS (the z latent, then each y slice,
// in decode order).  Within a segment, flat position p belongs to lane
// ((p - seg_start) % L) at step ((p - seg_start) / L); positions with
// alive[p] == 0 (rate-gated cells) emit no ops and are masked steps on
// the decoder side.  A lane's op sequence is the concatenation of its
// per-segment subsequences.

namespace {

constexpr uint32_t kRans32L = 1u << 16;

inline void enc32_put(uint32_t& x, std::vector<uint16_t>& emitted,
                      uint32_t start, uint32_t freq) {
  const uint32_t x_max = freq << 16;  // ((L >> precision) << 16) * freq
  if (x >= x_max) {
    emitted.push_back(static_cast<uint16_t>(x & 0xFFFFu));
    x >>= 16;
  }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

inline void enc32_put_bits(uint32_t& x, std::vector<uint16_t>& emitted,
                           uint32_t val, uint32_t nbits) {
  const uint32_t x_max = 1u << (32 - nbits);
  if (x >= x_max) {
    emitted.push_back(static_cast<uint16_t>(x & 0xFFFFu));
    x >>= 16;
  }
  x = (x << nbits) | val;
}

}  // namespace

// Encode n symbols into `lanes` interleaved 32-bit rANS lane streams.
// out_words layout: lane 0's words in DECODE order (2 init words holding
// the final state, then renorm words), then lane 1's, ...; lane_nwords[l]
// receives lane l's word count.  Returns total words, or -1 if
// out_cap_words is too small.
int64_t rans32_encode_lanes(const int32_t* symbols, const int32_t* indexes,
                            const uint8_t* alive, const int64_t* seg_ends,
                            int32_t nsegs, int64_t n, int32_t lanes,
                            const int32_t* cdfs, int cols,
                            const int32_t* cdf_lengths,
                            const int32_t* offsets, uint16_t* out_words,
                            int64_t out_cap_words, int32_t* lane_nwords) {
  if (lanes <= 0 || nsegs <= 0 || seg_ends[nsegs - 1] != n) return -2;
  std::vector<std::vector<Op>> ops(lanes);
  for (auto& v : ops) v.reserve(n / lanes + 8);
  int64_t seg_start = 0;
  for (int32_t s = 0; s < nsegs; ++s) {
    const int64_t seg_end = seg_ends[s];
    for (int64_t p = seg_start; p < seg_end; ++p) {
      if (alive != nullptr && alive[p] == 0) continue;
      append_symbol_ops(ops[(p - seg_start) % lanes], symbols[p], indexes[p],
                        cdfs, cols, cdf_lengths, offsets);
    }
    seg_start = seg_end;
  }

  int64_t total = 0;
  for (int32_t l = 0; l < lanes; ++l) {
    std::vector<uint16_t> emitted;
    emitted.reserve(ops[l].size() + 4);
    uint32_t state = kRans32L;
    for (auto it = ops[l].rbegin(); it != ops[l].rend(); ++it) {
      if (it->bypass) {
        enc32_put_bits(state, emitted, it->bits_val, kBypassPrecision);
      } else {
        enc32_put(state, emitted, it->start, it->freq);
      }
    }
    const int64_t nw = static_cast<int64_t>(emitted.size()) + 2;
    if (total + nw > out_cap_words) return -1;
    out_words[total] = static_cast<uint16_t>(state >> 16);
    out_words[total + 1] = static_cast<uint16_t>(state & 0xFFFFu);
    // decode order = reverse of emission order
    for (int64_t j = 0; j < static_cast<int64_t>(emitted.size()); ++j) {
      out_words[total + 2 + j] = emitted[emitted.size() - 1 - j];
    }
    lane_nwords[l] = static_cast<int32_t>(nw);
    total += nw;
  }
  return total;
}

// Host-side twin of the device lane decoder — an independent check of
// the format (tests pin C++ encode -> jax decode == C++ encode -> this)
// and a production fallback for hosts without an accelerator.
int rans32_decode_lanes(const uint16_t* words, const int32_t* lane_nwords,
                        const int32_t* indexes, const uint8_t* alive,
                        const int64_t* seg_ends, int32_t nsegs, int64_t n,
                        int32_t lanes, const int32_t* cdfs, int cols,
                        const int32_t* cdf_lengths, const int32_t* offsets,
                        int32_t* out) {
  if (lanes <= 0 || nsegs <= 0 || seg_ends[nsegs - 1] != n) return -2;
  std::vector<const uint16_t*> lane_ptr(lanes);
  std::vector<const uint16_t*> lane_end(lanes);
  std::vector<uint32_t> state(lanes);
  const uint16_t* w = words;
  for (int32_t l = 0; l < lanes; ++l) {
    state[l] = (static_cast<uint32_t>(w[0]) << 16) | w[1];
    lane_ptr[l] = w + 2;
    lane_end[l] = w + lane_nwords[l];
    w += lane_nwords[l];
  }
  auto renorm = [&](int32_t l) {
    if (state[l] < kRans32L && lane_ptr[l] < lane_end[l]) {
      state[l] = (state[l] << 16) | *lane_ptr[l]++;
    }
  };
  auto get_bits = [&](int32_t l, uint32_t nbits) -> uint32_t {
    const uint32_t val = state[l] & ((1u << nbits) - 1);
    state[l] >>= nbits;
    renorm(l);
    return val;
  };
  int64_t seg_start = 0;
  for (int32_t s = 0; s < nsegs; ++s) {
    const int64_t seg_end = seg_ends[s];
    for (int64_t p = seg_start; p < seg_end; ++p) {
      if (alive != nullptr && alive[p] == 0) {
        out[p] = 0;
        continue;
      }
      const int32_t l = static_cast<int32_t>((p - seg_start) % lanes);
      const int32_t index = indexes[p];
      const int32_t* cdf = cdfs + static_cast<int64_t>(index) * cols;
      const int32_t max_value = cdf_lengths[index] - 2;
      const uint32_t cum = state[l] & ((1u << kPrecision) - 1);
      int32_t value = 0;
      while (static_cast<uint32_t>(cdf[value + 1]) <= cum) ++value;
      state[l] = static_cast<uint32_t>(cdf[value + 1] - cdf[value]) *
                     (state[l] >> kPrecision) +
                 cum - static_cast<uint32_t>(cdf[value]);
      renorm(l);
      if (value == max_value) {
        uint32_t val = get_bits(l, kBypassPrecision);
        uint32_t n_bypass = val;
        while (val == kMaxBypassVal) {
          val = get_bits(l, kBypassPrecision);
          n_bypass += val;
        }
        uint32_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass; ++j) {
          raw_val |= get_bits(l, kBypassPrecision) << (j * kBypassPrecision);
        }
        int32_t v = static_cast<int32_t>(raw_val >> 1);
        value = (raw_val & 1) ? -v - 1 : v + max_value;
      }
      out[p] = value + offsets[index];
    }
    seg_start = seg_end;
  }
  return 0;
}

// One-shot decode convenience.
int rans_decode_with_indexes(const uint8_t* data, int64_t nbytes,
                             const int32_t* indexes, int64_t n,
                             const int32_t* cdfs, int rows, int cols,
                             const int32_t* cdf_lengths,
                             const int32_t* offsets, int32_t* out) {
  void* h = rans_decoder_new(data, nbytes);
  const int rc = rans_decode_stream(h, indexes, n, cdfs, rows, cols,
                                    cdf_lengths, offsets, out);
  rans_decoder_free(h);
  return rc;
}

}  // extern "C"
