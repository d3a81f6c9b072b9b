"""The lane stream format, its decode and its encode, on the card (port of
``rgba_tpu/entropy/device_rans.py``).

Format (written by ``native/rans.encode_lanes``): each image's stream is L
independent 32-bit rANS lanes (state in [2^16, 2^32), 16-bit renorm
words, the 16-bit quantized CDFs and 4-bit bypass escapes of the v64
coder).  Symbols are cut into segments in decode order: the z latent, then
each y slice.  Within a segment, flat position p goes to lane p % L at step
p // L.  One decode step takes one symbol from every lane of every image,
so the channel-AR decode needs no host round trip: the lane state and
pointer stay on the card between segments.

Rate-gated cells and the tail of a segment (n % L != 0) are inactive
steps: the encoder codes nothing there and the decoder advances nothing.
A bypass escape carries one 4-bit count and at most 8 4-bit chunks (the
raw values are 32-bit).

``decode_segment`` here is the plain PyTorch version of one segment's
decode, and ``init_encode`` / ``encode_segment`` / ``finish_lanes`` that of
the lane encode: the CPU runs them, and the tests and ``chip_smoke.py``
hold the CUDA kernels (``ops/kernels/rans_decode.py``,
``ops/kernels/rans_encode.py``) to them bit for bit.  Host-side
helpers (tables, stream packing) work on numpy.  The tables stay separate
tensors on the card (the JAX package packs them into one buffer because
its TPU runtime charged per argument buffer), with the same layout: z rows
after the 64 Gaussian rows (``z_row_offset``), their columns padded to a
multiple of 64 before the merge.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

PRECISION = 16
_MASK16 = (1 << 16) - 1
_MASK32 = (1 << 32) - 1
_L32 = 1 << 16
_BYPASS_BITS = 4
MAX_BYPASS_CHUNKS = 8   # 32-bit raw values need at most 8 4-bit chunks
MAX_LANE_WORDS = (1 << 16) - 1   # the container stores u16 word counts


def pack_tables(cdfs, cdf_lengths, offsets, pad_cols: int = 0) -> dict:
    """CDF rows padded with 2^16, so a symbol search that counts the
    entries <= cum (cum < 2^16) never walks past a row's length; numpy."""
    cdfs = np.asarray(cdfs, dtype=np.int32)
    lens = np.asarray(cdf_lengths, dtype=np.int32)
    offs = np.asarray(offsets, dtype=np.int32)
    cols = max(int(cdfs.shape[1]), int(pad_cols))
    padded = np.full((cdfs.shape[0], cols), 1 << PRECISION, dtype=np.int32)
    for r in range(cdfs.shape[0]):
        padded[r, :lens[r]] = cdfs[r, :lens[r]]
    return {"cdfs": padded, "max_values": lens - 2, "offsets": offs}


def build_inverse(cdfs, cdf_lengths) -> dict:
    """Dense inverse tables: for every (row, cum) the decoded value and its
    (start, freq), so a decode step makes two gathers instead of a row
    search.  numpy:
      si:  (rows * 2^16,) int32 = start | (freq - 1) << 16
      val: (rows * 2^15,) int32, two 16-bit values per word (even cum in
           the low half, odd cum in the high half)."""
    cdfs = np.asarray(cdfs, dtype=np.int64)
    lens = np.asarray(cdf_lengths, dtype=np.int32)
    rows = cdfs.shape[0]
    cum = np.arange(1 << PRECISION, dtype=np.int64)
    si = np.empty((rows, 1 << PRECISION), np.int32)
    val = np.empty((rows, 1 << PRECISION), np.int32)
    for r in range(rows):
        row = cdfs[r, :lens[r]]
        v = np.clip(np.searchsorted(row, cum, side="right") - 1, 0,
                    lens[r] - 2)
        start = row[v]
        freq = row[v + 1] - start
        si[r] = (start | ((freq - 1) << 16)).astype(np.int32)
        val[r] = v.astype(np.int32)
    packed = (val[:, 0::2] | (val[:, 1::2] << 16)).astype(np.int32)
    return {"si": si.reshape(-1), "val": packed.reshape(-1)}


def merge_tables(gauss: dict, z: dict) -> dict:
    """The y Gaussian rows and the z bottleneck rows in one row space (z
    rows at ``z_row_offset``), widened to one column count."""
    cols = max(gauss["cdfs"].shape[1], z["cdfs"].shape[1])

    def widen(t):
        c = t["cdfs"]
        pad = np.full((c.shape[0], cols - c.shape[1]), 1 << PRECISION,
                      dtype=np.int32)
        return np.concatenate([c, pad], axis=1)

    return {
        "cdfs": np.concatenate([widen(gauss), widen(z)], axis=0),
        "max_values": np.concatenate([gauss["max_values"], z["max_values"]]),
        "offsets": np.concatenate([gauss["offsets"], z["offsets"]]),
        "z_row_offset": int(gauss["cdfs"].shape[0]),
    }


def z_channel_indexes(zh: int, zw: int, channels: int) -> np.ndarray:
    """Each z position's CDF row (its channel), in the (zh, zw, c) order
    the coder flattens z in."""
    return np.broadcast_to(np.arange(channels, dtype=np.int32),
                           (zh, zw, channels)).reshape(-1)


# ------------------------------------------------ the kernels' compact tables
#
# The CUDA kernels read their CDF rows from shared memory.  A layout covers
# one row group (the rows one segment addresses: the Gaussian rows of the
# y slices, or the z rows) and is one byte buffer, staged by each block:
#   info     (rows, 4) int32: the row's first entry in ``starts``, its max
#            value (the escape, len - 2), its offset, and its first bucket
#            with its bucket shift in the top byte (first | shift << 24);
#   starts   uint16: each row's len CDF entries end to end, the last
#            (2^16) stored as 0; padded to 16 bytes;
#   rcp      uint32, beside each entry of ``starts``: the exact reciprocal
#            multiplier of the symbol's frequency (``reciprocal``); the
#            encode's;
#   buckets  2^(16 - shift) pairs of uint32 a row, the decode's: bucket b
#            of a row holds the values at cum = b << shift (lo) and at the
#            bucket's last cum (lo + n): (lo | n << 16, cdf[lo] |
#            (cdf[lo + n + 1] - 1) << 16).  A lookup reads one bucket and,
#            when n > 0, bisects cdf[lo + 1 .. lo + n] for the last entry
#            <= cum.  Each row has its own shift: about two buckets a
#            symbol, halved in the rows with the most buckets a symbol
#            until the decode's sections fit, so every row's buckets hold
#            about as few values.
# The decode stages info, starts and buckets; the encode info, starts and
# rcp.  Each must fit SMEM_BUDGET.

SMEM_BUDGET = 226 * 1024      # bytes a block stages (of the H100's 227 KB)
_SECTIONS = ("info", "starts", "rcp", "buckets")


def _pad16(a: np.ndarray) -> np.ndarray:
    """``a`` as bytes, zero-padded to a multiple of 16."""
    raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    return np.concatenate([raw, np.zeros(-raw.size % 16, np.uint8)])


def reciprocal(freq):
    """Exact division by ``freq`` in [1, 2^16) for every uint32 x
    (Granlund and Montgomery's unsigned method, 1994: a 33-bit magic whose
    low 32 bits are ``m``): with l = ceil(log2 freq),
    m = floor(2^32 (2^l - freq) / freq) + 1, and
    x // freq = (t + ((x - t) >> min(l, 1))) >> max(l - 1, 0),
    t = (x m) >> 32.  Returns (m uint32, l uint32); numpy."""
    f = np.asarray(freq, dtype=np.uint64)
    if f.size and (f.min() < 1 or f.max() >= 1 << 16):
        raise ValueError("reciprocal: freq must lie in [1, 2^16)")
    l = np.zeros(f.shape, np.uint64)
    for b in range(16):
        l += (f > (np.uint64(1) << np.uint64(b))).astype(np.uint64)
    m = ((np.uint64(1) << np.uint64(32)) * ((np.uint64(1) << l) - f)) // f + 1
    return m.astype(np.uint32), l.astype(np.uint32)


def divide(x, m, l):
    """x // freq through ``reciprocal(freq)`` = (m, l), as the encode kernel
    computes it on its state chain; numpy uint64."""
    x = np.asarray(x, np.uint64)
    m = np.asarray(m, np.uint64)
    l = np.asarray(l, np.uint64)
    t = (x * m) >> np.uint64(32)
    sh1 = np.minimum(l, np.uint64(1))
    sh2 = np.maximum(l, np.uint64(1)) - np.uint64(1)
    return (t + ((x - t) >> sh1)) >> sh2


def compact_layout(cdfs, max_values, offsets, rows=None,
                   budget: int = SMEM_BUDGET) -> dict:
    """The kernels' layout of rows [r0, r1) (``rows``, default all) of a
    ``pack_tables`` / ``merge_tables`` table (numpy).  Each row's bucket
    shift starts at about two buckets a symbol; while the decode's sections
    exceed ``budget``, the row with the most buckets a symbol halves them.  Raises
    ValueError if a row is not a lane coder row (0 first, 2^16 last,
    strictly rising) or if a kernel's sections cannot fit.  Returns
    {"info", "starts", "rcp", "buckets"} (numpy, as laid out; buckets (n, 2)
    uint32), "rows", "shifts" (per row) and "blob" (uint8, the four sections
    in that order, each padded to 16 bytes)."""
    cdfs = np.asarray(cdfs, np.int64)
    maxv = np.asarray(max_values, np.int64)
    offs = np.asarray(offsets, np.int64)
    r0, r1 = (0, cdfs.shape[0]) if rows is None else (int(rows[0]),
                                                      int(rows[1]))
    if not 0 <= r0 < r1 <= cdfs.shape[0]:
        raise ValueError(f"compact_layout: rows {rows} out of range")
    lens = maxv[r0:r1] + 2
    base = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    row_cdfs = [cdfs[r, :n] for r, n in zip(range(r0, r1), lens)]
    for r, row in zip(range(r0, r1), row_cdfs):
        if row.size < 2 or row[0] != 0 or row[-1] != 1 << PRECISION or \
                (np.diff(row) <= 0).any():
            raise ValueError(f"compact_layout: row {r} is not a lane coder "
                             f"CDF row (0 first, 2^16 last, rising)")
    flat = np.concatenate(row_cdfs)
    starts = (flat & _MASK16).astype(np.uint16)
    freq = np.concatenate([np.diff(row) for row in row_cdfs])
    # a reciprocal for every entry but each row's last (no symbol there)
    sym_at = np.ones(flat.size, bool)
    sym_at[base + lens - 1] = False
    rcp = np.zeros(flat.size, np.uint32)
    rcp[sym_at] = reciprocal(freq)[0]
    info = np.zeros((r1 - r0, 4), np.int64)
    info[:, 0], info[:, 1], info[:, 2] = base, maxv[r0:r1], offs[r0:r1]
    head = _pad16(info.astype(np.int32)).size + _pad16(starts).size
    if head + _pad16(rcp).size > budget:
        raise ValueError(f"compact_layout: rows {r0}-{r1} need "
                         f"{head + _pad16(rcp).size} bytes of shared memory "
                         f"for the encode, more than {budget}")
    # about two buckets a symbol: shift = 15 - ceil(log2(symbols))
    nsym = np.maximum(lens - 1, 1)
    shifts = np.clip(15 - np.ceil(np.log2(nsym)).astype(np.int64), 0,
                     PRECISION)
    while head + 8 * int((1 << (PRECISION - shifts)).sum()) > budget:
        # halve the buckets of the row with the most buckets a symbol
        ratio = (1 << (PRECISION - shifts)) / nsym
        ratio[shifts == PRECISION] = -1.0
        i = int(np.argmax(ratio))
        if ratio[i] < 0:
            raise ValueError(f"compact_layout: rows {r0}-{r1} need more than "
                             f"{budget} bytes of shared memory for the decode")
        shifts[i] += 1
    counts = 1 << (PRECISION - shifts)
    first_bucket = np.concatenate([[0], np.cumsum(counts)[:-1]])
    info[:, 3] = first_bucket | (shifts << 24)
    info = info.astype(np.int32)
    buckets = np.zeros((int(counts.sum()), 2), np.uint32)
    for i, row in enumerate(row_cdfs):
        sh = int(shifts[i])
        first = np.arange(counts[i], dtype=np.int64) << sh
        lo = np.clip(np.searchsorted(row, first, side="right") - 1, 0,
                     row.size - 2)
        hi = np.clip(np.searchsorted(row, first + (1 << sh) - 1,
                                     side="right") - 1, 0, row.size - 2)
        at = slice(first_bucket[i], first_bucket[i] + counts[i])
        buckets[at, 0] = lo | ((hi - lo) << 16)
        buckets[at, 1] = row[lo] | ((row[hi + 1] - 1) << 16)
    out = {"info": info, "starts": starts, "rcp": rcp, "buckets": buckets,
           "rows": (r0, r1), "shifts": shifts}
    out["blob"] = np.concatenate([_pad16(out[k]) for k in _SECTIONS])
    return out


def section_bytes(layout: dict) -> dict:
    """Each section's padded size in the blob, by name."""
    return {k: _pad16(layout[k]).size for k in _SECTIONS}


def compact_lookup(layout: dict, rows, cum):
    """(start, freq, value) of each cum (< 2^16) in its row (absolute row
    numbers, within the layout's), through the buckets and the bisection,
    as the decode kernel looks them up; numpy int64."""
    rows = np.asarray(rows, np.int64) - layout["rows"][0]
    cum = np.asarray(cum, np.int64)
    w = layout["info"][:, 3].astype(np.int64)[rows]
    e = layout["buckets"].astype(np.int64)[(w & 0xFFFFFF) + (cum >> (w >> 24))]
    a, n = e[..., 0] & _MASK16, e[..., 0] >> 16
    s_a = e[..., 1] & _MASK16
    s_b = (e[..., 1] >> 16) + 1
    b = a + n + 1
    base = layout["info"][:, 0].astype(np.int64)[rows]
    starts = layout["starts"].astype(np.int64)
    while True:
        open_ = b - a > 1
        if not open_.any():
            break
        m = (a + b) >> 1
        s = starts[base + np.where(open_, m, a)]
        up = open_ & (s <= cum)
        down = open_ & (s > cum)
        a, s_a = np.where(up, m, a), np.where(up, s, s_a)
        b, s_b = np.where(down, m, b), np.where(down, s, s_b)
    return s_a, s_b - s_a, a


def compact_symbol(layout: dict, rows, value):
    """(start, freq, m, l) of each value (in [0, max value]) of its row, as
    the encode kernel reads them: start and the next entry from
    ``starts`` (0 standing for 2^16), the reciprocal beside it; numpy."""
    rows = np.asarray(rows, np.int64) - layout["rows"][0]
    at = layout["info"][:, 0].astype(np.int64)[rows] + np.asarray(value,
                                                                  np.int64)
    starts = layout["starts"].astype(np.int64)
    start = starts[at]
    end = ((starts[at + 1] - 1) & _MASK16) + 1
    m = layout["rcp"][at]
    freq = end - start
    l = reciprocal(freq)[1]
    return start, freq, m, l


def segment_tables(tables: dict, rows=None) -> dict:
    """``tables`` (tensors, as the kernels take them) with the compact
    layout of rows [r0, r1) on their device under "compact": what a
    segment whose indexes address only those rows passes the kernels, so
    each block stages only them.  Built from a host copy of the tables."""
    layout = compact_layout(tables["cdfs"].cpu().numpy(),
                            tables["max_values"].cpu().numpy(),
                            tables["offsets"].cpu().numpy(), rows)
    dev = tables["cdfs"].device
    sizes = section_bytes(layout)
    out = {k: tables[k] for k in ("cdfs", "max_values", "offsets")}
    out["compact"] = {"blob": torch.from_numpy(layout["blob"]).to(dev),
                      "rows": layout["rows"],
                      "max_shift": int(layout["shifts"].max()),
                      "min_shift": int(layout["shifts"].min()),
                      **{k + "_bytes": v for k, v in sizes.items()}}
    return out


# ----------------------------------------------------------- stream packing

def split_stream(words: np.ndarray, lane_nwords: np.ndarray) -> bytes:
    """One image's lane stream as the container stores it: the u16 word
    count of each lane, then the words, little-endian."""
    lane_nwords = np.asarray(lane_nwords)
    for lane, n in enumerate(lane_nwords.tolist()):
        if n > MAX_LANE_WORDS:
            raise ValueError(
                f"lane {lane} has {n} words; the container stores a lane's "
                f"word count in 16 bits (at most {MAX_LANE_WORDS}): code "
                f"this image with more lanes")
    head = lane_nwords.astype("<u2").tobytes()
    return head + np.asarray(words, dtype="<u2").tobytes()


def parse_stream(data: bytes, lanes: int) -> tuple:
    """Inverse of ``split_stream`` -> (words uint16, lane_nwords int32)."""
    if len(data) < 2 * lanes or len(data) % 2:
        raise ValueError(f"lane stream of {len(data)} bytes cannot hold "
                         f"{lanes} lanes")
    head = np.frombuffer(data[:2 * lanes], dtype="<u2").astype(np.int32)
    words = np.frombuffer(data[2 * lanes:], dtype="<u2")
    if head.min(initial=2) < 2 or int(head.sum()) != words.size:
        raise ValueError("corrupt lane stream: word counts do not match "
                         "its length")
    return words, head


def pack_streams(per_image: Sequence[tuple], lanes: int) -> tuple:
    """Per-image (words, lane_nwords) pairs -> one flat uint16 word array,
    and the (B, L) int32 first and one-past-last word of every lane in it."""
    batch = len(per_image)
    lane_base = np.zeros((batch, lanes), dtype=np.int32)
    lane_end = np.zeros((batch, lanes), dtype=np.int32)
    off = 0
    for b, (words, lane_nwords) in enumerate(per_image):
        if np.size(lane_nwords) != lanes:
            raise ValueError(f"image {b} has {np.size(lane_nwords)} lanes, "
                             f"not {lanes}")
        ends = np.cumsum(lane_nwords).astype(np.int64)
        lane_base[b] = off + ends - lane_nwords
        lane_end[b] = off + ends
        off += int(ends[-1])
    if off >= 1 << 31:
        raise ValueError(f"{off} words do not fit int32 offsets")
    flat = np.concatenate([np.asarray(w, dtype=np.uint16)
                           for w, _ in per_image]) if batch else \
        np.zeros(0, np.uint16)
    return flat, lane_base, lane_end


# ------------------------------------------------------ the decode, plainly

def words_tensor(flat: np.ndarray, device) -> torch.Tensor:
    """uint16 words -> an int16 tensor of the same bits on ``device``."""
    flat = np.ascontiguousarray(flat, dtype=np.uint16)
    return torch.from_numpy(flat.view(np.int16)).to(device)


def init_lanes(words, lane_base):
    """(state int64, ptr int32) of each lane from its first two words;
    ``words`` the int16 tensor of ``words_tensor``, ``lane_base`` (..., L)."""
    base = lane_base.long()
    state = ((words[base].long() & _MASK16) << 16) | \
        (words[base + 1].long() & _MASK16)
    return state, (lane_base + 2).to(torch.int32)


def to_steps(flat, lanes: int, fill=0):
    """(..., n) per-segment array -> (T, ..., L) in the lane layout
    (position p at step p // L, lane p % L), the tail padded with ``fill``."""
    n = flat.shape[-1]
    t = -(-n // lanes)
    pad = torch.full(flat.shape[:-1] + (t * lanes - n,), fill,
                     dtype=flat.dtype, device=flat.device)
    arr = torch.cat([flat, pad], dim=-1).reshape(flat.shape[:-1] + (t, lanes))
    return arr.movedim(-2, 0).contiguous()


def from_steps(stepped, n: int):
    """Inverse of ``to_steps``: (T, ..., L) -> (..., n)."""
    arr = stepped.movedim(0, -2)
    return arr.reshape(arr.shape[:-2] + (-1,))[..., :n]


def _wrap_i32(x):
    """int64 holding a 32-bit pattern -> that pattern as int32."""
    x = x & _MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def decode_segment(tables: dict, words, state, ptr, indexes, active,
                   lane_end, inverse: Optional[dict] = None):
    """Decode one segment (the plain version of the CUDA kernel).

    tables: {"cdfs" (rows, cols), "max_values" (rows,), "offsets"
    (rows,)} int32 tensors; words: the int16 tensor of ``words_tensor``
    (all images' lanes); state (B, L) int64 holding uint32 values, ptr and
    lane_end (B, L) int32 (a lane reads no word at or past its end);
    indexes (T, B, L) int32 CDF rows; active (T, B, L) bool.  inverse:
    ``build_inverse`` of the rows the indexes address ({"si", "val"} int32
    tensors) for the two-gather search, else the row search.  Returns
    (symbols (T, B, L) int32, state, ptr); inactive steps give 0 and
    advance nothing.  Arithmetic is that of ``rans32_decode_lanes`` in
    uint32 (the C++ twin): on a valid stream the three agree bit for bit."""
    cdfs = tables["cdfs"].long()
    max_values = tables["max_values"].long()
    offsets = tables["offsets"].long()
    end = lane_end.long()
    state, ptr = state.long(), ptr.long()

    def renorm(state, ptr, need):
        need = need & (state < _L32) & (ptr < end)
        w = words[torch.where(need, ptr, 0)].long() & _MASK16
        state = torch.where(need, ((state << 16) | w) & _MASK32, state)
        return state, ptr + need.long()

    def get_bits(state, ptr, act):
        val = torch.where(act, state & ((1 << _BYPASS_BITS) - 1), 0)
        state = torch.where(act, state >> _BYPASS_BITS, state)
        state, ptr = renorm(state, ptr, act)
        return val, state, ptr

    syms = torch.zeros(indexes.shape, dtype=torch.int32,
                       device=indexes.device)
    for t in range(indexes.shape[0]):
        idx, act = indexes[t].long(), active[t].bool()
        cum = state & _MASK16
        if inverse is not None:
            si = inverse["si"][idx * (1 << PRECISION) + cum].long()
            start = si & _MASK16
            freq = ((si >> 16) & _MASK16) + 1
            w = inverse["val"][idx * (1 << (PRECISION - 1)) + (cum >> 1)]
            value = (w.long() >> ((cum & 1) * 16)) & _MASK16
        else:
            row = cdfs[idx]                                   # (B, L, cols)
            value = (row[..., 1:] <= cum[..., None]).sum(-1)
            start = row.gather(-1, value[..., None])[..., 0]
            freq = row.gather(-1, value[..., None] + 1)[..., 0] - start
        new = (freq * (state >> PRECISION) + cum - start) & _MASK32
        state = torch.where(act, new, state)
        state, ptr = renorm(state, ptr, act)

        maxv = max_values[idx]
        esc = act & (value == maxv)
        if bool(esc.any()):
            n_byp, state, ptr = get_bits(state, ptr, esc)
            raw = torch.zeros_like(value)
            for j in range(MAX_BYPASS_CHUNKS):
                on = esc & (j < n_byp)
                bits, state, ptr = get_bits(state, ptr, on)
                raw = raw | (bits << (_BYPASS_BITS * j))
            v = raw >> 1
            value = torch.where(esc, torch.where((raw & 1) == 1, -v - 1,
                                                 v + maxv), value)
        syms[t] = torch.where(act, _wrap_i32(value + offsets[idx]), 0)
    return syms, state, ptr.to(torch.int32)


# ------------------------------------------------------ the encode, plainly

def init_encode(batch_shape, lanes: int, max_words: int, device):
    """Fresh encode carries: state 2^16 (int64 holding the uint32), write
    pointer 0 (int32), and a (..., L, W) int32 word buffer of zeros; W is
    the per-lane word budget."""
    lead = tuple(batch_shape) + (lanes,)
    return (torch.full(lead, _L32, dtype=torch.int64, device=device),
            torch.zeros(lead, dtype=torch.int32, device=device),
            torch.zeros(lead + (max_words,), dtype=torch.int32,
                        device=device))


def _emit(out_words, wptr, need, word):
    """Lanes with ``need`` write ``word`` at their pointer, clamped to the
    last slot W-1, and count on: a lane whose pointer reaches W has
    overflowed (``finish_lanes``) and never writes out of bounds.
    ``out_words`` is updated in place."""
    slot = wptr.clamp(max=out_words.shape[-1] - 1).long()[..., None]
    cur = out_words.gather(-1, slot)
    out_words.scatter_(-1, slot, torch.where(
        need[..., None], word.to(torch.int32)[..., None], cur))
    return wptr + need.to(torch.int32)


def _put_sym(state, out_words, wptr, act, start, freq):
    """rANS push of one CDF-coded value (the host's ``enc32_put``): renorm
    by one 16-bit word when state >= freq << 16, then
    state = (state // freq) << 16 + state % freq + start.  ``freq << 16``
    wraps modulo 2^32 as in the uint32 programs; freq = 2^16 would wrap it
    to 0, but a packed row codes at least one value and the escape, each
    with a frequency of at least 1, so freq <= 2^16 - 1."""
    need = act & (state >= ((freq << 16) & _MASK32))
    wptr = _emit(out_words, wptr, need, state & _MASK16)
    state = torch.where(need, state >> 16, state)
    # exact division: after the renorm the quotient fits 16 bits (the JAX
    # program's bit search gives the same quotient)
    q = state // freq.clamp_min(1)
    new = (q << PRECISION) + (state - q * freq) + start
    return torch.where(act, new & _MASK32, state), wptr


def _put_bits(state, out_words, wptr, act, val, nbits: int):
    """Push ``nbits`` raw bits (the host's ``enc32_put_bits``)."""
    need = act & (state >= (1 << (32 - nbits)))
    wptr = _emit(out_words, wptr, need, state & _MASK16)
    state = torch.where(need, state >> 16, state)
    new = ((state << nbits) | val) & _MASK32
    return torch.where(act, new, state), wptr


def encode_segment(tables: dict, state, wptr, out_words, indexes, symbols,
                   active):
    """Encode one segment (the plain version of the CUDA kernel).

    rANS encodes in reverse of decode order, so the steps are walked
    T-1..0; per active position it pushes the bypass chunks (high chunk
    first), the chunk count, then the CDF-coded value: the exact reverse of
    ``decode_segment``'s reads.  tables as in ``decode_segment``; state
    (B, L) int64 holding uint32 values, wptr (B, L) int32, out_words
    (B, L, W) int32 (the words in emission order, reversed by
    ``finish_lanes``); indexes, symbols (T, B, L) integers (the codec
    passes uint8 / int16 indexes and int16 symbols) in decode step order,
    active (T, B, L) bool.  Returns (state, wptr, out_words);
    ``out_words`` is written in place, the state and pointer come back as
    new tensors.  Arithmetic is the uint32 arithmetic of the host coder's
    ``rans32_encode_lanes``, so the three encoders agree bit for bit."""
    cdfs = tables["cdfs"]
    cols = cdfs.shape[-1]
    flat = cdfs.reshape(-1).long()
    max_values = tables["max_values"].long()
    offsets = tables["offsets"].long()
    state, wptr = state.long(), wptr.to(torch.int32)
    for t in reversed(range(indexes.shape[0])):
        idx, act = indexes[t].long(), active[t].bool()
        maxv = max_values[idx]
        value = symbols[t].long() - offsets[idx]
        neg, over = value < 0, value >= maxv
        raw = torch.where(neg, -2 * value - 1,
                          torch.where(over, 2 * (value - maxv), 0)) & _MASK32
        esc = act & (neg | over)
        value = torch.where(esc, maxv, value)
        if bool(esc.any()):
            # raw fits 32 bits: at most 8 chunks and one count chunk
            n_byp = torch.zeros_like(raw)
            for j in range(1, MAX_BYPASS_CHUNKS + 1):
                n_byp = torch.where((raw >> ((j - 1) * _BYPASS_BITS)) != 0,
                                    j, n_byp)
            for j in reversed(range(MAX_BYPASS_CHUNKS)):
                chunk = (raw >> (j * _BYPASS_BITS)) & ((1 << _BYPASS_BITS) - 1)
                state, wptr = _put_bits(state, out_words, wptr,
                                        esc & (j < n_byp), chunk, _BYPASS_BITS)
            state, wptr = _put_bits(state, out_words, wptr, esc, n_byp,
                                    _BYPASS_BITS)
        # an inactive step's value may lie outside its row: read entry 0
        base = idx * cols + torch.where(act, value, 0)
        start = flat[base]
        state, wptr = _put_sym(state, out_words, wptr, act, start,
                               flat[base + 1] - start)
    return state, wptr, out_words


def finish_lanes(state, wptr, out_words):
    """Flush and reorder into decode order: each lane's stream becomes
    [state >> 16, state & 0xFFFF, its emitted words reversed].  Returns
    (words (..., L, W + 2) int32, nwords (..., L) int32, overflow): a lane
    whose pointer reached the budget W has lost words (its writes were
    clamped to slot W-1), and ``overflow`` (a 0-dim bool tensor) says the
    caller must code the segments again with a larger budget (the budget is
    not part of the bytes).  Plain tensor
    indexing: layout, not the coder's arithmetic, so it is the same on the
    CPU and on the card."""
    w = out_words.shape[-1]
    src = wptr.long()[..., None] - 1 - torch.arange(w, device=wptr.device)
    rev = out_words.gather(-1, src.clamp(0, w - 1))
    rev = torch.where(src >= 0, rev, 0)
    state = state.long()
    head = torch.stack([state >> 16, state & _MASK16], dim=-1).to(torch.int32)
    return (torch.cat([head, rev], dim=-1), wptr.to(torch.int32) + 2,
            (wptr >= w).any())
