"""The lane-rANS kernels' shared-memory tables and exact reciprocal, on the
CPU, through their plain versions in ``rgba_tpu_torch/entropy/
device_rans.py`` (the kernels in ``csrc/rans_{decode,encode}.cu`` read the
same layout the same way; the card tests hold them to the plain decode and
encode bit for bit).

- ``compact_lookup`` (one bucket read and a bisection) gives the JAX
  package's dense inverse, ``build_inverse``'s (start, freq, value), for
  every one of the 64 Gaussian rows x 2^16 cum values, and for every cum of
  the z rows of both codecs, in the row groups the codec stages.
- ``compact_symbol`` (the encode's reads) gives each value's CDF entries.
- ``divide`` through ``reciprocal`` equals ``//`` for every freq in
  [1, 2^16) at x = 0, 1, freq - 1, freq, multiples of freq and their
  neighbours, 2^32 - 1 and seeded random values (numpy uint64).
- Each check fails on a deliberately wrong bucket, row entry, bucket
  shift or division shift.
- The layout refuses rows that are not the lane coder's and tables whose
  sections cannot fit a block's shared memory.
- Tables given to a wrapper without a layout get one of all their rows,
  built once per table set.

Exact integer comparisons: the tables and the division are integer work.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgba_tpu.entropy.device_rans import build_inverse as j_build_inverse  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.entropy import device_rans as dr  # noqa: E402
from rgba_tpu_torch.entropy.gaussian import (GaussianConditional,  # noqa: E402
                                             get_scale_table)

P = 1 << 16


@pytest.fixture(scope="module")
def gauss():
    gc = GaussianConditional(get_scale_table())
    gc.update()
    return dr.pack_tables(gc.quantized_cdfs, gc.cdf_lengths, gc.offsets)


def _merged(kind, gauss):
    """The codec's merged lane table (Gaussian rows, then the z rows
    padded to a multiple of 64 columns), as ``CodecIO`` builds it."""
    from rgba_tpu_torch.models.mask_codec import MaskCodec
    from rgba_tpu_torch.models.rgb_codec import RGBCodec
    cls = RGBCodec if kind == "rgb" else MaskCodec
    model = cls(policy=DEFAULT_POLICY, device="cpu",
                generator=torch.Generator().manual_seed(0))
    t = model.entropy_bottleneck.cdf_tables()
    zc = int(np.asarray(t["quantized_cdfs"]).shape[1])
    z = dr.pack_tables(t["quantized_cdfs"], t["cdf_lengths"], t["offsets"],
                       pad_cols=-(-zc // 64) * 64)
    return dr.merge_tables(gauss, z)


def _inverse(tables, rows):
    """(start, freq, value) of every (row, cum) of rows [r0, r1), from the
    JAX package's dense inverse tables; (rows, 2^16) int64 each."""
    r0, r1 = rows
    inv = j_build_inverse(tables["cdfs"][r0:r1],
                          tables["max_values"][r0:r1] + 2)
    si = inv["si"].reshape(r1 - r0, P).astype(np.int64)
    packed = inv["val"].reshape(r1 - r0, P // 2).astype(np.int64)
    val = np.stack([packed & 0xFFFF, (packed >> 16) & 0xFFFF],
                   -1).reshape(r1 - r0, P)
    return si & 0xFFFF, ((si >> 16) & 0xFFFF) + 1, val


def _lookup_all(layout):
    r0, r1 = layout["rows"]
    rows = np.repeat(np.arange(r0, r1), P).reshape(r1 - r0, P)
    cum = np.broadcast_to(np.arange(P), rows.shape)
    return dr.compact_lookup(layout, rows, cum)


def _assert_lookup_is_inverse(tables, layout):
    got = _lookup_all(layout)
    want = _inverse(tables, layout["rows"])
    for name, g, w in zip(("start", "freq", "value"), got, want):
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{name} differs at (row, cum) {bad[:3]}"


def test_lookup_equals_the_inverse_on_every_gaussian_cum(gauss):
    layout = dr.compact_layout(gauss["cdfs"], gauss["max_values"],
                               gauss["offsets"])
    sizes = dr.section_bytes(layout)
    # 27,256 uint16 entries (54.5 KB); the longest row has the most buckets,
    # and no row has fewer buckets a symbol than half the average
    assert sizes["starts"] == 27256 * 2
    counts = 1 << (16 - layout["shifts"])
    assert layout["buckets"].shape == (counts.sum(), 2)
    assert counts[-1] == counts.max() > counts[0]
    per_symbol = counts / (gauss["max_values"] + 1)
    assert per_symbol.min() >= 0.5 * counts.sum() / 27192
    assert sizes["info"] + sizes["starts"] + sizes["buckets"] <= dr.SMEM_BUDGET
    assert sizes["info"] + sizes["starts"] + sizes["rcp"] <= dr.SMEM_BUDGET
    _assert_lookup_is_inverse(gauss, layout)


@pytest.mark.parametrize("kind", ["rgb", "mask"])
def test_lookup_equals_the_inverse_in_the_codec_row_groups(gauss, kind):
    """The groups ``CodecIO`` stages: the y slices' Gaussian rows and the
    z rows (192 rows of the bottleneck, finer buckets)."""
    merged = _merged(kind, gauss)
    z_off, rows = merged["z_row_offset"], merged["cdfs"].shape[0]
    for group in ((0, z_off), (z_off, rows)):
        layout = dr.compact_layout(merged["cdfs"], merged["max_values"],
                                   merged["offsets"], group)
        assert layout["rows"] == group
        _assert_lookup_is_inverse(merged, layout)
    z = dr.compact_layout(merged["cdfs"], merged["max_values"],
                          merged["offsets"], (z_off, rows))
    # the z rows' 22 symbols: two buckets a symbol, 2^6 a row
    assert rows - z_off == 192 and (z["shifts"] == 10).all()


def test_lookup_of_every_row_in_one_group(gauss):
    """A layout of all 256 rows (what a wrapper builds for tables without
    one): the buckets coarsen to fit, the lookups stay exact."""
    merged = _merged("rgb", gauss)
    layout = dr.compact_layout(merged["cdfs"], merged["max_values"],
                               merged["offsets"])
    sizes = dr.section_bytes(layout)
    assert sizes["info"] + sizes["starts"] + sizes["buckets"] <= dr.SMEM_BUDGET
    y = dr.compact_layout(merged["cdfs"], merged["max_values"],
                          merged["offsets"], (0, merged["z_row_offset"]))
    assert (layout["shifts"][:64] >= y["shifts"]).all()
    _assert_lookup_is_inverse(merged, layout)


def test_a_wrong_bucket_or_entry_fails_the_lookup_check(gauss):
    layout = dr.compact_layout(gauss["cdfs"], gauss["max_values"],
                               gauss["offsets"])
    last = int(layout["info"][63, 3]) & 0xFFFFFF      # row 63's buckets
    for section, fix in (("buckets", lambda b: b.__setitem__(
            (last + 100, 0), b[last + 100, 0] + 1)),
                         ("buckets", lambda b: b.__setitem__(
                             (last + 900, 1), b[last + 900, 1] ^ 1)),
                         ("info", lambda i: i.__setitem__(
                             (40, 3), i[40, 3] + (1 << 24))),
                         ("starts", lambda s: s.__setitem__(
                             int(layout["info"][50, 0]) + 700,
                             s[int(layout["info"][50, 0]) + 700] - 1))):
        bad = dict(layout, **{section: layout[section].copy()})
        fix(bad[section])
        with pytest.raises(AssertionError):
            _assert_lookup_is_inverse(gauss, bad)


def test_symbol_reads_give_each_value_its_entries(gauss):
    """The encode's view: start = cdf[v], freq = cdf[v + 1] - cdf[v] (the
    last entry 2^16 stored as 0), and the reciprocal beside it divides
    exactly."""
    merged = _merged("mask", gauss)
    z_off, rows = merged["z_row_offset"], merged["cdfs"].shape[0]
    rng = np.random.RandomState(3)
    for group in ((0, z_off), (z_off, rows)):
        layout = dr.compact_layout(merged["cdfs"], merged["max_values"],
                                   merged["offsets"], group)
        r = np.concatenate([np.full(merged["max_values"][i] + 1, i)
                            for i in range(*group)])
        v = np.concatenate([np.arange(merged["max_values"][i] + 1)
                            for i in range(*group)])
        start, freq, m, l = dr.compact_symbol(layout, r, v)
        cdfs = merged["cdfs"].astype(np.int64)
        np.testing.assert_array_equal(start, cdfs[r, v])
        np.testing.assert_array_equal(freq, cdfs[r, v + 1] - cdfs[r, v])
        x = rng.randint(0, 1 << 32, r.size, dtype=np.uint64)
        np.testing.assert_array_equal(dr.divide(x, m, l),
                                      x // freq.astype(np.uint64))


def _dividends(freq, rng):
    """Per freq: 0, 1, freq - 1, freq, freq + 1, 2^32 - 1, the multiples
    k freq and k freq +- 1 for the largest k and seeded random k, and
    seeded random x; (freqs, n) uint64."""
    f = freq.astype(np.uint64)[:, None]
    top = np.uint64((1 << 32) - 1)
    kmax = top // f
    k = (rng.rand(freq.size, 8) * kmax.astype(np.float64)).astype(np.uint64)
    k = np.concatenate([kmax, np.maximum(k, 1)], axis=1)
    mult = k * f
    cols = [np.zeros_like(f), np.ones_like(f), f - 1, f, f + 1,
            np.full_like(f, top), mult, mult - 1,
            np.minimum(mult + 1, top),
            rng.randint(0, 1 << 32, (freq.size, 32), dtype=np.uint64)]
    return np.concatenate(cols, axis=1)


def test_reciprocal_divides_exactly_for_every_freq():
    freq = np.arange(1, P)
    m, l = dr.reciprocal(freq)
    assert m.dtype == np.uint32 and int(l.max()) == 16
    x = _dividends(freq, np.random.RandomState(0))
    q = dr.divide(x, m[:, None], l[:, None])
    want = x // freq.astype(np.uint64)[:, None]
    bad = np.argwhere(q != want)
    assert bad.size == 0, f"(freq index, x index) {bad[:3]}"


@pytest.mark.parametrize("wrong", ["shift", "multiplier"])
def test_a_wrong_reciprocal_fails_the_division_check(wrong):
    freq = np.arange(1, P)
    m, l = dr.reciprocal(freq)
    if wrong == "shift":
        l = l + 1
    else:
        m = m - np.uint32(1)
    x = _dividends(freq, np.random.RandomState(0))
    q = dr.divide(x, m[:, None], l[:, None])
    assert (q != x // freq.astype(np.uint64)[:, None]).any()


def test_layout_refuses_what_a_block_cannot_stage(gauss):
    # 64 rows of 4,000 entries: 512 KB of rows alone
    wide = np.tile(np.round(np.linspace(0, P, 4000)).astype(np.int32),
                   (64, 1))
    with pytest.raises(ValueError, match="shared memory"):
        dr.compact_layout(wide, np.full(64, 3998, np.int32),
                          np.zeros(64, np.int32))
    # the Gaussian rows fit the default budget, not a smaller one
    with pytest.raises(ValueError, match="shared memory"):
        dr.compact_layout(gauss["cdfs"], gauss["max_values"],
                          gauss["offsets"], budget=100_000)
    bad = gauss["cdfs"].copy()
    bad[5, 3] = bad[5, 2]             # a zero frequency
    with pytest.raises(ValueError, match="row 5"):
        dr.compact_layout(bad, gauss["max_values"], gauss["offsets"])


def test_segment_tables_carry_the_group_layout(gauss):
    merged = _merged("rgb", gauss)
    tables = {k: torch.from_numpy(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    z_off = merged["z_row_offset"]
    y = dr.segment_tables(tables, (0, z_off))["compact"]
    lay = dr.compact_layout(merged["cdfs"], merged["max_values"],
                            merged["offsets"], (0, z_off))
    assert y["rows"] == (0, z_off)
    assert (y["min_shift"], y["max_shift"]) == (lay["shifts"].min(),
                                                lay["shifts"].max())
    assert np.array_equal(y["blob"].numpy(), lay["blob"])
    sizes = dr.section_bytes(lay)
    assert sum(y[k + "_bytes"] for k in sizes) == y["blob"].numel()
    # the sections in order: info, starts, rcp, buckets
    off = sizes["info"] + sizes["starts"] + sizes["rcp"]
    got = y["blob"].numpy()[off:off + sizes["buckets"]].view(np.uint32)
    np.testing.assert_array_equal(got, lay["buckets"].reshape(-1))
    info = y["blob"].numpy()[:sizes["info"]].view(np.int32).reshape(-1, 4)
    np.testing.assert_array_equal(info, lay["info"])


def test_host_coder_codes_escapes_of_eight_chunks(gauss):
    """A raw escape value of 2^28 or more takes all 8 value chunks: the host
    coder's chunk count stops there (it used to shift by 32 and never end),
    its lane words equal the plain lane encode's, and both decoders give
    the symbols back."""
    from rgba_tpu_torch.native import rans
    rng = np.random.RandomState(5)
    lanes, n = 16, 600
    idx = rng.randint(0, 64, n).astype(np.int32)
    sym = rng.randint(-4, 5, n).astype(np.int32)
    big = rng.randint(0, 1 << 20, sym[::23].size) + (1 << 30)
    sym[::23] = np.where(rng.rand(big.size) < 0.5, big, -big)
    lens = gauss["max_values"] + 2
    words, lnw = rans.encode_lanes(sym, idx, [n], lanes, gauss["cdfs"], lens,
                                   gauss["offsets"])
    np.testing.assert_array_equal(
        rans.decode_lanes(words, lnw, idx, [n], gauss["cdfs"], lens,
                          gauss["offsets"]), sym)

    tables = {k: torch.from_numpy(v) for k, v in gauss.items()}
    steps = dr.to_steps(torch.from_numpy(np.stack([idx])), lanes)
    act = dr.to_steps(torch.ones(1, n, dtype=torch.bool), lanes, fill=False)
    state, wptr, out = dr.init_encode((1,), lanes, 256, "cpu")
    state, wptr, out = dr.encode_segment(
        tables, state, wptr, out, steps,
        dr.to_steps(torch.from_numpy(sym[None]), lanes), act)
    fin, nwords, ovf = dr.finish_lanes(state, wptr, out)
    assert not bool(ovf)
    np.testing.assert_array_equal(nwords[0].numpy(), lnw)
    np.testing.assert_array_equal(np.concatenate(
        [fin[0, i, :lnw[i]].numpy() for i in range(lanes)]), words)

    flat, base, end = dr.pack_streams([(words, lnw)], lanes)
    w = dr.words_tensor(flat, "cpu")
    st, ptr = dr.init_lanes(w, torch.from_numpy(base))
    syms, _, ptr = dr.decode_segment(tables, w, st, ptr, steps, act,
                                     torch.from_numpy(end))
    np.testing.assert_array_equal(dr.from_steps(syms, n)[0].numpy(), sym)
    assert torch.equal(ptr, torch.from_numpy(end))


def test_tables_without_a_layout_get_one_of_all_rows_once(gauss):
    """Tables a kernel wrapper gets without "compact" are staged through
    the layout of all their rows (``rans_decode.all_rows_layout``), built
    once and kept with their cdfs tensor; changing a table in place builds
    it again."""
    from rgba_tpu_torch.ops.kernels import rans_decode as rd
    tables = {k: torch.from_numpy(v.copy()) for k, v in gauss.items()}
    first = rd.all_rows_layout(tables)
    lay = dr.compact_layout(gauss["cdfs"], gauss["max_values"],
                            gauss["offsets"])
    assert first["rows"] == (0, gauss["cdfs"].shape[0])
    assert np.array_equal(first["blob"].numpy(), lay["blob"])
    assert rd.all_rows_layout(dict(tables)) is first
    tables["offsets"] += 1
    again = rd.all_rows_layout(tables)
    assert again is not first
    assert np.array_equal(again["blob"].numpy(), dr.compact_layout(
        gauss["cdfs"], gauss["max_values"], gauss["offsets"] + 1)["blob"])
