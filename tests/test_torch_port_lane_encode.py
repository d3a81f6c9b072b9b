"""The device lane encode of the PyTorch port against the JAX package on the
CPU.

``entropy/device_rans.py``'s plain ``init_encode`` / ``encode_segment`` /
``finish_lanes`` (the reference of the CUDA kernel
``ops/kernels/rans_encode.py``) against the JAX package's ``lax.scan``
program and the host C++ ``encode_lanes``, and the codec's device route
(``RGBA_TPU_DEVICE_ENCODE=1``) against its host route.  Exact everywhere:
words, word counts, final lane state and the overflow decision.  The JAX
scan runs only at small shapes (T <= 64 steps, L <= 16 lanes): it is slow
on the CPU.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.entropy import device_rans as jdr  # noqa: E402

from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.entropy import device_rans as dr  # noqa: E402
from rgba_tpu_torch.eval import codec_io  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec, unpack_rgba  # noqa: E402
from rgba_tpu_torch.native import rans  # noqa: E402
from rgba_tpu_torch.ops.kernels import rans_encode as re_  # noqa: E402

from test_torch_port_codec import ios, pipe  # noqa: E402,F401

torch.set_num_threads(2)

# one compiled scan for every JAX case: the tests share T, B, L and W
_jax_segment = jax.jit(jdr.encode_segment)
SIZES, LANES, BUDGET = np.array([256, 256]), 8, 128


@pytest.fixture(scope="module")
def merged(ios):
    """The port's lane tables: 64 Gaussian rows, then the mask codec's 192
    z rows."""
    return ios[1]._lane_tables()["merged"]


def _segments(merged, sizes, batch, seed, gated, z_first=True):
    """Symbols, indexes and alive flags (batch, sum(sizes)) of a stream cut
    into segments of ``sizes``: the first on z rows (if z_first), the rest
    on Gaussian rows; symbols near each row's centre with escapes below
    and above, one of many chunks."""
    rng = np.random.RandomState(seed)
    zoff = merged["z_row_offset"]
    rows = merged["cdfs"].shape[0]
    n = int(sum(sizes))
    idx = rng.randint(0, zoff, (batch, n)).astype(np.int32)
    if z_first:
        idx[:, :sizes[0]] = rng.randint(zoff, rows, (batch, sizes[0]))
    sym = merged["offsets"][idx] + merged["max_values"][idx] // 2 + \
        rng.randint(-4, 5, (batch, n))
    sym[:, ::29] = rng.randint(-900, 900, sym[:, ::29].shape)
    sym[:, 7] = 70000                              # an escape of five chunks
    alive = rng.rand(batch, n) > 0.3 if gated else np.ones((batch, n), bool)
    if z_first:
        alive[:, :sizes[0]] = True                 # z is never gated
    return sym.astype(np.int32), idx, alive


def _port_encode(merged, sizes, sym, idx, alive, lanes, budget):
    """The plain encode, segments walked last to first; returns (words,
    nwords, overflow, state) as numpy."""
    tables = {k: torch.from_numpy(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    state, wptr, out = dr.init_encode((sym.shape[0],), lanes, budget, "cpu")
    ends = np.cumsum(sizes)
    for a, b in reversed(list(zip(ends - sizes, ends))):
        def steps(x, fill=0):
            return dr.to_steps(torch.from_numpy(np.ascontiguousarray(x[:, a:b])),
                               lanes, fill=fill)
        state, wptr, out = re_.rans_encode(tables, state, wptr, out,
                                           steps(idx), steps(sym),
                                           steps(alive, False))
    words, nwords, ovf = dr.finish_lanes(state, wptr, out)
    return words.numpy(), nwords.numpy(), bool(ovf), state.numpy()


def _jax_encode(merged, sizes, sym, idx, alive, lanes, budget):
    tables = {k: jnp.asarray(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    state, wptr, out = jdr.init_encode((sym.shape[0],), lanes, budget)
    ends = np.cumsum(sizes)
    for a, b in reversed(list(zip(ends - sizes, ends))):
        def steps(x, fill=0):
            return jdr.to_steps(jnp.asarray(x[:, a:b]), lanes, fill=fill)
        state, wptr, out = _jax_segment(tables, state, wptr, out, steps(idx),
                                        steps(sym), steps(alive, False))
    words, nwords, ovf = jdr.finish_lanes(state, wptr, out)
    return (np.asarray(words), np.asarray(nwords), bool(ovf),
            np.asarray(state).astype(np.int64))


def _host_words(merged, sizes, sym, idx, alive, lanes, b):
    return rans.encode_lanes(sym[b], idx[b], np.cumsum(sizes), lanes,
                             merged["cdfs"], merged["max_values"] + 2,
                             merged["offsets"], alive=alive[b])


def _lane_words(words, nwords, b):
    """Image b's lanes, each in decode order, lane after lane."""
    return np.concatenate([words[b, lane, :nwords[b, lane]]
                           for lane in range(words.shape[1])])


@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_plain_encode_equals_the_jax_scan_and_the_host(merged, gated):
    """Two segments (z rows, then Gaussian rows), masked positions and
    escapes: the port's plain encode gives the JAX program's words, word
    counts, final state and overflow flag, and the host coder's bytes."""
    sym, idx, alive = _segments(merged, SIZES, 2, 3 + gated, gated)
    got = _port_encode(merged, SIZES, sym, idx, alive, LANES, BUDGET)
    want = _jax_encode(merged, SIZES, sym, idx, alive, LANES, BUDGET)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[2]
    for b in range(2):
        words, lnw = _host_words(merged, SIZES, sym, idx, alive, LANES, b)
        np.testing.assert_array_equal(got[1][b], lnw)
        np.testing.assert_array_equal(_lane_words(got[0], got[1], b), words)


def test_a_forced_overflow_flags_the_same_lanes_in_both_packages(merged):
    """Long escapes on lanes 0-3 only: those lanes run past the budget in
    both packages, their pointers count on while the writes stay in the
    last slot, the other lanes stay within it, and the flags and clamped
    words agree."""
    sym, idx, alive = _segments(merged, SIZES, 2, 11, False)
    lane = np.arange(sym.shape[1]) % LANES
    sym[:, lane < 4] = -(1 << 26)                  # seven chunks each
    got = _port_encode(merged, SIZES, sym, idx, alive, LANES, BUDGET)
    want = _jax_encode(merged, SIZES, sym, idx, alive, LANES, BUDGET)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    over = got[1] - 2 >= BUDGET
    assert got[2]
    np.testing.assert_array_equal(over, np.arange(LANES)[None].repeat(2, 0) < 4)
    _, lnw = _host_words(merged, SIZES, sym, idx, alive, LANES, 0)
    np.testing.assert_array_equal(got[1][0], lnw)   # the counts run on


def test_plain_encode_gives_the_host_bytes_at_codec_size(merged):
    """The segments of a 64x128 RGB stream (z, then ten y slices of 1,024
    positions), 16 lanes, gated y: the plain encode's lanes are the host
    coder's, word for word, for every image."""
    sizes = np.array([2 * 192] + [8 * 16 * 8] * 10)
    lanes = 16
    budget = max(64, (int(sizes.sum()) // lanes) // 2 + 16)
    sym, idx, alive = _segments(merged, sizes, 2, 5, True)
    words, nwords, ovf, _ = _port_encode(merged, sizes, sym, idx, alive,
                                         lanes, budget)
    assert not ovf
    for b in range(2):
        host, lnw = _host_words(merged, sizes, sym, idx, alive, lanes, b)
        np.testing.assert_array_equal(nwords[b], lnw)
        assert dr.split_stream(_lane_words(words, nwords, b), nwords[b]) == \
            dr.split_stream(host, lnw)


def test_packed_rows_keep_every_frequency_below_2_16(merged):
    """``freq << 16`` would wrap in uint32 at freq = 2^16: each packed row
    codes a value and the escape, each at least 1, so no frequency gets
    there."""
    cdfs, lens = merged["cdfs"].astype(np.int64), merged["max_values"] + 2
    for r in range(cdfs.shape[0]):
        f = np.diff(cdfs[r, :lens[r]])
        assert f.min() >= 1 and f.max() <= (1 << 16) - 1


def test_wrapper_takes_the_plain_version_on_the_cpu_only(merged):
    """CPU tensors take the plain version; another device raises, and no
    launch is counted."""
    sizes = np.array([300])
    sym, idx, alive = _segments(merged, sizes, 1, 2, True, z_first=False)
    tables = {k: torch.from_numpy(merged[k])
              for k in ("cdfs", "max_values", "offsets")}
    args = [dr.to_steps(torch.from_numpy(x), 8) for x in (idx, sym)]
    act = dr.to_steps(torch.from_numpy(alive), 8, fill=False)
    a = re_.rans_encode(tables, *dr.init_encode((1,), 8, 64, "cpu"), *args,
                        act)
    b = re_.rans_encode_plain(tables, *dr.init_encode((1,), 8, 64, "cpu"),
                              *args, act)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    before = re_.KERNEL.launches
    state, wptr, out = dr.init_encode((1,), 8, 64, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        re_.rans_encode(tables, state, wptr, out, *args, act)
    assert re_.KERNEL.launches == before


@pytest.fixture
def counted(monkeypatch):
    """Counts the codec's calls of the lane encode wrapper."""
    calls = []
    wrapped = codec_io._re.rans_encode

    def count(*args):
        calls.append(args[4].shape)
        return wrapped(*args)
    monkeypatch.setattr(codec_io._re, "rans_encode", count)
    return calls


def _routes(monkeypatch, encode):
    monkeypatch.setenv("RGBA_TPU_DEVICE_ENCODE", "0")
    host = encode()
    monkeypatch.setenv("RGBA_TPU_DEVICE_ENCODE", "1")
    return host, encode()


@pytest.mark.parametrize("option", ["overflow", "deadzone", "gated"])
def test_device_route_gives_the_host_routes_blobs(ios, monkeypatch, counted,
                                                  option):
    """compress_batch(stream_format="lanes32") with RGBA_TPU_DEVICE_ENCODE=1
    takes the device route (one encode launch per segment, 1 + 10) and
    returns the host route's streams.  At the test weights (encoder gain
    10) these images overflow a lane's budget, and the device codes the
    segments again with room for the longest lane (1 + 10 launches more);
    a deadzone of 1 keeps them under budget, with and without the rate
    gate."""
    d = synthetic_rgba_batch(2, 64, 128, seed=3)
    a = d["alpha"].copy()
    if option == "gated":
        a[:, :, 64:] = 0.0
    x = d["image"] if option == "overflow" else \
        np.where(a > 0, d["image"], 0.0).astype(np.float32)
    io = ios[0]
    kw = {"deadzone": 0.0 if option == "overflow" else 1.0,
          "rate_gate": option == "gated", "stream_format": "lanes32"}
    host, dev = _routes(monkeypatch,
                        lambda: io.compress_batch(image=x, mask=a, **kw))
    over = option == "overflow"
    assert len(counted) == (22 if over else 11)
    assert [c["stream"] for c in dev] == [c["stream"] for c in host]
    assert [("gate" in c) for c in dev] == [option == "gated"] * 2
    if option == "gated":
        np.testing.assert_array_equal(dev[1]["gate"], host[1]["gate"])
    info = io.last_lane_encode
    assert info["lanes"] == 16 and info["overflow"] == over
    assert (info["max_nwords"] - 2 >= info["budget"]) == over
    if over:
        # the second pass's budget holds the longest lane, in 64-word steps
        assert info["max_nwords"] - 2 < info["rerun_budget"]
        assert info["rerun_budget"] % 64 == 0
        assert counted[11:] == counted[:11]     # the same segments again
    else:
        assert info["rerun_budget"] is None


def test_container_device_encode_equals_the_host(ios, monkeypatch, counted):
    """RGBAFileCodec in version 3 with the device route: 11 RGB and 6 mask
    encode launches, the same containers as the host route, and they
    decode to the same RGBA.  At the test weights the mask codec's lanes
    overflow their budget (it takes no deadzone), so its 6 segments are
    coded twice on the card, the RGB codec's once."""
    codec = RGBAFileCodec(*ios)
    d = synthetic_rgba_batch(2, 64, 64, seed=22)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    host, dev = _routes(monkeypatch, lambda: codec.encode_batch(
        img, alpha, rate_gate=True, deadzone=1.0, stream_format="lanes32"))
    assert codec.mask_io.last_lane_encode["overflow"]
    assert not codec.rgb_io.last_lane_encode["overflow"]
    assert len(counted) == 6 + 6 + 11
    assert dev == host
    assert unpack_rgba(dev[0])["rate_gated"]
    np.testing.assert_array_equal(codec.decode_batch(dev),
                                  codec.decode_batch(host))
