"""The lane stream format ("lanes32", container version 3) in the PyTorch
port against the JAX package on the CPU.

The host coder's lane entry points (``native/rans.py``), the lane helpers
of ``entropy/device_rans.py`` and its plain ``decode_segment`` (the CUDA
kernel's reference, ``ops/kernels/rans_decode.py``), the codec's
``decompress_device`` and the version-3 container.  Exact everywhere: lane
bytes from the same tables and symbols, decoded symbols from every
decoder, the port's own round trips, and the v3 decode against the port's
v64 decode of the same images.  Both packages get one table set where a
z row is involved: their z CDF tables may differ by an ulp (ROADMAP
queue 3).  Streams stay at a few thousand symbols: the JAX scan compiles
per shape.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.entropy import device_rans as jdr  # noqa: E402
from rgba_tpu.native import rans as jrans  # noqa: E402

from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.entropy import device_rans as dr  # noqa: E402
from rgba_tpu_torch.entropy.gaussian import GaussianConditional, get_scale_table  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec, unpack_rgba  # noqa: E402
from rgba_tpu_torch.native import rans  # noqa: E402
from rgba_tpu_torch.ops.kernels import rans_decode as rd  # noqa: E402

from test_torch_port_codec import ios, pipe  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gauss():
    gc = GaussianConditional(get_scale_table())
    gc.update()
    return gc


@pytest.fixture(scope="module")
def merged(ios, gauss):
    """The port's lane tables: 64 Gaussian rows, then the mask codec's 192
    z rows (its columns padded to a multiple of 64)."""
    return ios[1]._lane_tables()["merged"]


def _payload(rng, n, rows, row0=0):
    """Symbols around each row's centre, with escapes below and above."""
    idx = rng.randint(row0, row0 + rows, n).astype(np.int32)
    sym = rng.randint(-6, 7, n).astype(np.int32)
    sym[::41] = rng.randint(-900, 900, sym[::41].size)
    return sym, idx


def _stream(merged, inverse_rows: bool, seed=0, lanes=16, gated=True):
    """A two-segment lane stream: (symbols, indexes, alive, seg_ends,
    words, lane_nwords).  inverse_rows: Gaussian rows only (the y path);
    else z rows (the row-search path)."""
    rng = np.random.RandomState(seed)
    n = 2600
    zoff = merged["z_row_offset"]
    if inverse_rows:
        sym, idx = _payload(rng, n, zoff)
    else:
        sym, idx = _payload(rng, n, merged["cdfs"].shape[0] - zoff, zoff)
        sym += merged["offsets"][idx] + 3
    sym[5] = 5000                       # a forced escape: many chunks
    alive = rng.rand(n) > 0.3 if gated else np.ones(n, bool)
    alive[5] = True
    seg_ends = np.array([1000, n], np.int64)
    lens = merged["max_values"] + 2
    words, lnw = rans.encode_lanes(sym, idx, seg_ends, lanes, merged["cdfs"],
                                   lens, merged["offsets"], alive=alive)
    return sym, idx, alive, seg_ends, words, lnw


def _segments(decode, idx, alive, seg_ends, lanes, tensor):
    out, start = [], 0
    for end in seg_ends:
        n = int(end - start)
        ii = tensor(idx[start:end])[None]
        aa = tensor(alive[start:end])[None]
        out.append(decode(ii, aa, n))
        start = int(end)
    return np.concatenate(out)


def _port_plain(merged, words, lnw, idx, alive, seg_ends, lanes, inverse):
    flat, base, end = dr.pack_streams([(words, lnw)], lanes)
    w = dr.words_tensor(flat, "cpu")
    tables = {k: torch.from_numpy(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    inv = None if inverse is None else \
        {k: torch.from_numpy(v) for k, v in inverse.items()}
    state, ptr = dr.init_lanes(w, torch.from_numpy(base))
    lane_end = torch.from_numpy(end)
    carry = [state, ptr]

    def decode(ii, aa, n):
        syms, carry[0], carry[1] = rd.rans_decode(
            tables, w, carry[0], carry[1], dr.to_steps(ii, lanes),
            dr.to_steps(aa, lanes, fill=False), lane_end, inverse=inv)
        return dr.from_steps(syms, n)[0].numpy()

    out = _segments(decode, idx, alive, seg_ends, lanes, torch.from_numpy)
    np.testing.assert_array_equal(carry[1].numpy(), end)  # every word read
    return out


def _jax_scan(merged, words, lnw, idx, alive, seg_ends, lanes, inverse):
    flat, base = jdr.pack_streams([(words, lnw)], lanes)
    w = jnp.asarray(flat.astype(np.int32))
    tables = {k: jnp.asarray(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    inv = None if inverse is None else \
        {k: jnp.asarray(v) for k, v in inverse.items()}
    carry = list(jdr.init_lanes(w, jnp.asarray(base)))

    def decode(ii, aa, n):
        syms, carry[0], carry[1] = jdr.decode_segment(
            tables, w, carry[0], carry[1], jdr.to_steps(ii, lanes),
            jdr.to_steps(aa, lanes, fill=False), inverse=inv)
        return np.asarray(jdr.from_steps(syms, n))[0]

    return _segments(decode, idx, alive, seg_ends, lanes, jnp.asarray)


@pytest.mark.parametrize("path", ["inverse", "row_search"])
def test_four_decoders_agree(merged, gauss, path):
    """One lane stream (two segments, masked positions, bypass escapes):
    the port's plain decode_segment, its decode_lanes, the JAX package's
    decode_lanes and its decode_segment give the same symbols."""
    lanes = 16
    sym, idx, alive, seg_ends, words, lnw = _stream(
        merged, path == "inverse", lanes=lanes)
    want = np.where(alive, sym, 0)
    inverse = dr.build_inverse(gauss.quantized_cdfs, gauss.cdf_lengths) \
        if path == "inverse" else None
    lens = merged["max_values"] + 2
    tabs = (merged["cdfs"], lens, merged["offsets"])
    np.testing.assert_array_equal(
        rans.decode_lanes(words, lnw, idx, seg_ends, *tabs, alive=alive), want)
    np.testing.assert_array_equal(
        jrans.decode_lanes(words, lnw, idx, seg_ends, *tabs, alive=alive),
        want)
    np.testing.assert_array_equal(
        _port_plain(merged, words, lnw, idx, alive, seg_ends, lanes, inverse),
        want)
    np.testing.assert_array_equal(
        _jax_scan(merged, words, lnw, idx, alive, seg_ends, lanes, inverse),
        want)


@pytest.mark.parametrize("lanes", [1, 16, 128])
def test_encode_lanes_bytes_equal_jax(merged, lanes):
    sym, idx, alive, seg_ends, _, _ = _stream(merged, False, seed=lanes)
    lens = merged["max_values"] + 2
    args = (sym, idx, seg_ends, lanes, merged["cdfs"], lens, merged["offsets"])
    for a in (alive, None):
        got = rans.encode_lanes(*args, alive=a)
        want = jrans.encode_lanes(*args, alive=a)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_lane_bindings_validate_their_arguments(merged):
    sym, idx, alive, seg_ends, words, lnw = _stream(merged, True)
    tabs = (merged["cdfs"], merged["max_values"] + 2, merged["offsets"])
    with pytest.raises(ValueError, match="segment ends"):
        rans.encode_lanes(sym, idx, [1000, 2000], 16, *tabs)
    with pytest.raises(ValueError, match="index out of range"):
        rans.encode_lanes(sym, idx + 1000, seg_ends, 16, *tabs)
    with pytest.raises(ValueError, match="alive flags"):
        rans.encode_lanes(sym, idx, seg_ends, 16, *tabs, alive=alive[:-1])
    with pytest.raises(ValueError, match="lanes"):
        rans.encode_lanes(sym, idx, seg_ends, 0, *tabs)
    with pytest.raises(ValueError, match="word counts"):
        rans.decode_lanes(words[:-1], lnw, idx, seg_ends, *tabs, alive=alive)
    with pytest.raises(ValueError, match="symbols but"):
        rans.encode_lanes(sym[:-1], idx, seg_ends, 16, *tabs)


def test_tables_and_helpers_equal_jax(ios, gauss, merged):
    g = dr.pack_tables(gauss.quantized_cdfs, gauss.cdf_lengths, gauss.offsets)
    jg = jdr.pack_tables(gauss.quantized_cdfs, gauss.cdf_lengths,
                         gauss.offsets)
    for k in g:
        np.testing.assert_array_equal(g[k], jg[k])
    t = ios[1].eb_tables
    zc = t["quantized_cdfs"].shape[1]
    jz = jdr.pack_tables(t["quantized_cdfs"], t["cdf_lengths"], t["offsets"],
                         pad_cols=-(-zc // 64) * 64)
    jm = jdr.merge_tables(jg, jz)
    assert merged["z_row_offset"] == jm["z_row_offset"] == 64
    for k in ("cdfs", "max_values", "offsets"):
        np.testing.assert_array_equal(merged[k], jm[k])
    inv = dr.build_inverse(gauss.quantized_cdfs, gauss.cdf_lengths)
    jinv = jdr.build_inverse(gauss.quantized_cdfs, gauss.cdf_lengths)
    for k in ("si", "val"):
        np.testing.assert_array_equal(inv[k], jinv[k])
    np.testing.assert_array_equal(dr.z_channel_indexes(2, 3, 192),
                                  jdr.z_channel_indexes(2, 3, 192))
    x = np.arange(2 * 37, dtype=np.int32).reshape(2, 37)
    steps = dr.to_steps(torch.from_numpy(x), 8, fill=-1)
    np.testing.assert_array_equal(steps.numpy(),
                                  np.asarray(jdr.to_steps(jnp.asarray(x), 8,
                                                          fill=-1)))
    np.testing.assert_array_equal(dr.from_steps(steps, 37).numpy(), x)


def test_stream_serialization(merged):
    _, _, _, _, words, lnw = _stream(merged, True)
    data = dr.split_stream(words, lnw)
    assert data == jdr.split_stream(words, lnw)
    w2, n2 = dr.parse_stream(data, lnw.size)
    np.testing.assert_array_equal(w2, words)
    np.testing.assert_array_equal(n2, lnw)
    with pytest.raises(ValueError, match="corrupt lane stream"):
        dr.parse_stream(data[:-2], lnw.size)
    big = lnw.copy()
    big[3] = 1 << 16
    with pytest.raises(ValueError, match=r"lane 3 has 65536 words"):
        dr.split_stream(np.zeros(int(big.sum()), np.uint16), big)
    ok = lnw.copy()
    ok[3] = (1 << 16) - 1
    dr.split_stream(np.zeros(int(ok.sum()), np.uint16), ok)


def test_wrapper_takes_the_plain_version_on_the_cpu_only(merged):
    """CPU tensors take the plain version; another device raises."""
    sym, idx, alive, seg_ends, words, lnw = _stream(merged, True, gated=False)
    flat, base, end = dr.pack_streams([(words, lnw)], 16)
    w = dr.words_tensor(flat, "cpu")
    tables = {k: torch.from_numpy(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    state, ptr = dr.init_lanes(w, torch.from_numpy(base))
    ii = dr.to_steps(torch.from_numpy(idx[:1000])[None], 16)
    aa = dr.to_steps(torch.ones(1, 1000, dtype=torch.bool), 16, fill=False)
    a = rd.rans_decode(tables, w, state, ptr, ii, aa, torch.from_numpy(end))
    b = rd.rans_decode_plain(tables, w, state, ptr, ii, aa,
                             torch.from_numpy(end))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(dr.from_steps(a[0], 1000)[0].numpy(),
                                  sym[:1000])
    before = rd.KERNEL.launches
    with pytest.raises(ValueError, match="unsupported device"):
        rd.rans_decode(tables, w.to("meta"), state, ptr, ii, aa,
                       torch.from_numpy(end))
    assert rd.KERNEL.launches == before


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_v3_decode_equals_the_v64_decode(ios, gated):
    """decompress_device (the plain decode on the CPU) gives the y_hat of
    the v64 chain on the same images, bit for bit, for every preview."""
    d = synthetic_rgba_batch(2, 64, 128, seed=18)
    a = d["alpha"].copy()
    a[:, :, 64:] = 0.0
    x = np.where(a > 0, d["image"], 0.0).astype(np.float32)
    io = ios[0]
    v64 = io.compress_batch(image=x, mask=a, rate_gate=gated)
    v3 = io.compress_batch(image=x, mask=a, rate_gate=gated,
                           stream_format="lanes32")
    assert v3[0]["lanes"] == 16 and ("gate" in v3[0]) == gated
    for k in (None, 3):
        _, want = io.decompress_batch_with_latent(v64, mask=a, max_slices=k)
        got = io.decompress_device_latent(v3, max_slices=k)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        io.decompress_device(v3, mask=a).numpy(),
        io.decompress_batch(v64, mask=a))
    if gated:
        eight = io.compress_batch(image=x, mask=a, rate_gate=True,
                                  stream_format="lanes32", lanes=8)
        assert eight[0]["lanes"] == 8 and eight[0]["stream"] != v3[0]["stream"]
        np.testing.assert_array_equal(
            io.decompress_device_latent(eight).numpy(),
            io.decompress_device_latent(v3).numpy())
        mixed = [v3[0], {k: v for k, v in v3[1].items() if k != "gate"}]
        with pytest.raises(ValueError, match="rate gate"):
            io.decompress_device(mixed, mask=a)


def test_v3_container_round_trip(ios):
    """Version 3: byte-identical re-encode, a blob alone as in its batch,
    the same RGBA as version 1 of the same images, and previews."""
    codec = RGBAFileCodec(*ios)
    d = synthetic_rgba_batch(2, 64, 64, seed=19)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    alpha[0] = 255                      # one opaque image: no mask stream
    v3 = codec.encode_batch(img, alpha, stream_format="lanes32")
    assert codec.encode_batch(img, alpha, stream_format="lanes32") == v3
    metas = [unpack_rgba(b) for b in v3]
    assert [m["stream_format"] for m in metas] == ["lanes32"] * 2
    assert metas[0]["mask"] is None and metas[1]["mask"]["lanes"] == 8
    out = codec.decode_batch(v3)
    np.testing.assert_array_equal(codec.decode(v3[1]), out[1:])
    v1 = codec.encode_batch(img, alpha)
    np.testing.assert_array_equal(out, codec.decode_batch(v1))
    np.testing.assert_array_equal(codec.decode_batch(v3, max_slices=4),
                                  codec.decode_batch(v1, max_slices=4))
    with pytest.raises(ValueError, match="one container version"):
        codec.decode_batch([v1[0], v3[1]])
