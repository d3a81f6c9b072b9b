"""The codec's throughput options in the PyTorch port, on the CPU: shape
buckets, interleaved decode chains, the batch encode's host coding,
``PipelinedCodec``, and the two repairs they rest on (precision scopes and
kernel loading that hold across threads).

The bucket ladder is held to the JAX package's on the same sizes, and the
bucket check to the JAX container's; every other result is held to the
port's own serial, whole-batch or ``interleave=1`` result, exactly (bytes
and decoded arrays), as the JAX package's own tests hold its options
(``tests/test_pipeline.py``, ``tests/test_buckets.py``).
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.eval import buckets as jbuckets  # noqa: E402
from rgba_tpu.eval import container as jcontainer  # noqa: E402

from rgba_tpu_torch.core import precision  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.entropy.device_rans import split_stream  # noqa: E402
from rgba_tpu_torch.eval import buckets  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec, unpack_rgba  # noqa: E402
from rgba_tpu_torch.eval.pipeline import PipelinedCodec  # noqa: E402
from rgba_tpu_torch.native import rans  # noqa: E402
from rgba_tpu_torch.ops.kernels import build  # noqa: E402

from test_torch_port_codec import ios, pipe  # noqa: E402,F401

torch.set_num_threads(2)


def _u8(d):
    return (np.round(d["image"] * 255).astype(np.uint8),
            np.round(d["alpha"] * 255).astype(np.uint8))


# ---------------------------------------------------------------- buckets


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_waste", [0.0, 0.15, 0.3, 1.0])
def test_bucket_ladder_equals_jax(seed, max_waste):
    rng = np.random.RandomState(seed)
    sizes = [tuple(int(v) for v in rng.randint(1, 700, 2))
             for _ in range(rng.randint(1, 40))]
    sizes += sizes[:3]                               # repeated sizes
    assert buckets.choose_buckets(sizes, max_waste) == \
        jbuckets.choose_buckets(sizes, max_waste)
    for h, w in sizes:
        assert buckets.pad64(h, w) == jbuckets.pad64(h, w)
    for batch in (1, 3, 8):
        assert buckets.pad_batch(sizes, batch) == \
            jbuckets.pad_batch(sizes, batch)


def test_bucket_is_checked_as_the_jax_container_checks_it():
    """Each bucket raises ValueError in the port exactly where it does in
    the JAX package (both check it before any device work)."""
    img = np.zeros((1, 48, 112, 3), np.float32)
    alpha = np.ones((1, 48, 112, 1), np.float32)
    port = RGBAFileCodec(SimpleNamespace(device="cpu"), None)
    jax_codec = jcontainer.RGBAFileCodec(None, None)
    for bucket in [(64, 128), (128, 192), (48, 128), (64, 96), (64, 130),
                   (0, 0), (640, 64), (128, 128)]:
        raised = []
        for codec in (port, jax_codec):
            try:
                codec.encode_batch(img, alpha, bucket=bucket)
            except ValueError:
                raised.append(True)
            except (AttributeError, TypeError):
                raised.append(False)         # got past the check
        assert raised[0] == raised[1], bucket


def test_bucketed_encode_decodes_to_the_original_size(ios):
    """48x112 images on a 128x192 bucket: the blobs decode to 48x112, to
    the minimal canvas's result where the image lies, re-encode byte for
    byte, and blob 0 decodes alone as in the batch; the opaque image ships
    no mask stream (opacity is judged before the transparent margin)."""
    codec = RGBAFileCodec(*ios)
    img, alpha = _u8(synthetic_rgba_batch(2, 48, 112, seed=30))
    alpha[0] = 255
    blobs = codec.encode_batch(img, alpha, bucket=(128, 192))
    assert codec.encode_batch(img, alpha, bucket=(128, 192)) == blobs
    metas = [unpack_rgba(b) for b in blobs]
    assert [(m["height"], m["width"]) for m in metas] == [(48, 112)] * 2
    assert metas[0]["rgb"]["shape"] == (2, 3)
    assert metas[0]["mask"] is None and metas[1]["mask"] is not None
    out = codec.decode_batch(blobs, output="uint8")
    assert out.shape == (2, 48, 112, 4)
    np.testing.assert_array_equal(out[0, ..., 3], 255)
    np.testing.assert_array_equal(codec.decode(blobs[1], output="uint8"),
                                  out[1:])
    minimal = codec.decode_batch(codec.encode_batch(img, alpha),
                                 output="uint8")
    assert minimal.shape == out.shape


# ------------------------------------------------------------- interleave


@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_interleaved_decode_equals_one_chain(ios, gated):
    """decompress_batch with interleave 2 and 3 (and the default, 2 at
    batch 4) gives interleave=1's reconstruction and latent exactly, with
    and without the rate gate (each sub-chain its slice of the gate)."""
    io = ios[0]
    d = synthetic_rgba_batch(4, 64, 64, seed=31)
    a = d["alpha"].copy()
    a[:, 40:] = 0.0
    x = np.where(a > 0, d["image"], 0.0).astype(np.float32)
    comps = io.compress_batch(image=x, mask=a, rate_gate=gated)
    assert all(("gate" in c) == gated for c in comps)
    want_x, want_y = io.decompress_batch_with_latent(comps, mask=a,
                                                     interleave=1)
    assert [len(io.decompress_chains(comps, interleave=g))
            for g in (None, 1, 2, 3, 8)] == [2, 1, 2, 3, 4]
    for g in (None, 2, 3):
        got_x, got_y = io.decompress_batch_with_latent(comps, mask=a,
                                                       interleave=g)
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(
        io.decompress_batch(comps, mask=a, interleave=2, max_slices=3),
        io.decompress_batch(comps, mask=a, interleave=1, max_slices=3))


@pytest.mark.parametrize("rate_gate", [False, True])
def test_container_interleave_equals_one_chain(ios, rate_gate):
    """decode_batch(interleave=2) runs two RGB sub-chains beside the mask
    chain and gives interleave=1's RGBA exactly."""
    codec = RGBAFileCodec(*ios)
    img, alpha = _u8(synthetic_rgba_batch(4, 64, 64, seed=32))
    alpha[1] = 255
    blobs = codec.encode_batch(img, alpha, rate_gate=rate_gate)
    want = codec.decode_batch(blobs, interleave=1)
    for g in (2, None):
        np.testing.assert_array_equal(
            codec.decode_batch(blobs, interleave=g), want)


# ---------------------------------------------------------- batch encode


def _whole_batch_streams(io, x, a, lanes32):
    """The streams of one whole-batch fetch of ``_compress_device``'s
    tensors, coded image by image with the host coder."""
    syms, idxs, z = io._compress_device(io._nchw(x), io._nchw(a))
    n_slices, batch = syms.shape[:2]
    out = []
    for b in range(batch):
        if lanes32:
            z_n, s_n = z[b].size, syms[:, b].size // n_slices
            lanes = io._lane_count(z_n + n_slices * s_n, None)
            m = io._lane_tables()["merged"]
            z_idx = np.tile(np.arange(z.shape[-1], dtype=np.int32),
                            z_n // z.shape[-1]) + m["z_row_offset"]
            words, lnw = rans.encode_lanes(
                np.concatenate([z[b].ravel(), syms[:, b].ravel()]),
                np.concatenate([z_idx, idxs[:, b].ravel()]),
                z_n + s_n * np.arange(n_slices + 1), lanes, m["cdfs"],
                m["max_values"] + 2, m["offsets"])
            out.append(split_stream(words, lnw))
        else:
            t = io.eb_tables
            zi = np.broadcast_to(np.arange(z.shape[-1], dtype=np.int32),
                                 z.shape[1:]).ravel()
            out.append([rans.encode_with_indexes(
                syms[:, b].ravel(), idxs[:, b].ravel(), io.gc.quantized_cdfs,
                io.gc.cdf_lengths, io.gc.offsets), rans.encode_with_indexes(
                z[b].ravel(), zi, t["quantized_cdfs"], t["cdf_lengths"],
                t["offsets"])])
    return out


@pytest.mark.parametrize("fmt", ["v64", "lanes32"])
def test_batch_encode_gives_each_images_host_streams(ios, fmt):
    """compress_batch codes a batch of 3 on the host threads to the
    streams each image's symbols give when coded on their own, from one
    whole-batch fetch."""
    io = ios[0]
    d = synthetic_rgba_batch(3, 64, 64, seed=33)
    x = np.where(d["alpha"] > 0, d["image"], 0.0).astype(np.float32)
    got = io.compress_batch(image=x, mask=d["alpha"], stream_format=fmt)
    want = _whole_batch_streams(io, x, d["alpha"], fmt == "lanes32")
    assert [c["stream"] if fmt == "lanes32" else c["strings"]
            for c in got] == want


# ---------------------------------------------------------- the pipeline


def test_pipeline_ordering_and_depth():
    """Results come in submission order even when later items finish
    first, and no more than ``depth`` are in flight."""
    class FakeCodec:
        def __init__(self):
            self.in_flight = self.max_in_flight = 0
            self.lock = threading.Lock()

        def encode_batch(self, item, _alpha=None):
            with self.lock:
                self.in_flight += 1
                self.max_in_flight = max(self.max_in_flight, self.in_flight)
            time.sleep(0.05 if item == 0 else 0.005)
            with self.lock:
                self.in_flight -= 1
            return [bytes([item])]

    fake = FakeCodec()
    pipe_ = PipelinedCodec(fake, depth=2)
    out = list(pipe_.encode_stream((i, None) for i in range(6)))
    assert out == [[bytes([i])] for i in range(6)]
    assert fake.max_in_flight <= 2
    pipe_.close()


def test_pipeline_empty_single_and_depth_check():
    class Echo:
        def encode_batch(self, x, _a=None):
            return [x]

    pipe_ = PipelinedCodec(Echo(), depth=2)
    assert list(pipe_.encode_stream(iter([]))) == []
    assert list(pipe_.encode_stream(iter([("a", None)]))) == [["a"]]
    pipe_.close()
    with pytest.raises(ValueError, match="depth"):
        PipelinedCodec(Echo(), depth=0)


@pytest.mark.parametrize("fmt", ["v64", "lanes32"])
def test_pipelined_round_trips_equal_the_serial_loop(ios, fmt):
    """Two worker threads over two batches: the same blobs and the same
    decodes as the serial loop, in order, for the encode, decode and round
    trip streams."""
    codec = RGBAFileCodec(*ios)
    batches = [_u8(synthetic_rgba_batch(2, 64, 64, seed=40 + s))
               for s in range(2)]
    serial = [codec.encode_batch(*b, stream_format=fmt) for b in batches]
    decoded = [codec.decode_batch(bl) for bl in serial]
    pipe_ = PipelinedCodec(codec, depth=2)
    assert list(pipe_.encode_stream(iter(batches),
                                    stream_format=fmt)) == serial
    for got, want in zip(pipe_.decode_stream(iter(serial)), decoded):
        np.testing.assert_array_equal(got, want)
    for (blobs, rgba), want_b, want_r in zip(
            pipe_.roundtrip_stream(iter(batches), stream_format=fmt), serial,
            decoded):
        assert blobs == want_b
        np.testing.assert_array_equal(rgba, want_r)
    pipe_.close()


# ---------------------------------------------------------------- repairs


def test_precision_scopes_hold_across_threads():
    """Thread A opens the codec's scope, thread B opens one, A closes its
    own: B still runs with TF32 off and deterministic cuDNN without
    autotuning, and when both have closed the flags are back where they
    started.  (Each scope used to save and restore the flags itself, so A
    switched TF32 back on under B.)"""
    tf32 = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    start = (tf32[0].allow_tf32, tf32[1].allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    io = SimpleNamespace(model=SimpleNamespace(policy=precision.DEFAULT_POLICY))
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with CodecIO._scope(io):
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with CodecIO._scope(io):
            b_in.set()
            a_out.wait(10)
            seen["inside B"] = (tf32[0].allow_tf32, tf32[1].allow_tf32,
                                cudnn.deterministic, cudnn.benchmark,
                                precision.batch_invariant())

    tf32[0].allow_tf32, tf32[1].allow_tf32 = True, True
    cudnn.deterministic, cudnn.benchmark = False, True
    try:
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen["inside B"] == (False, False, True, False, True)
        assert (tf32[0].allow_tf32, tf32[1].allow_tf32, cudnn.deterministic,
                cudnn.benchmark) == (True, True, False, True)
        assert not precision.batch_invariant()
    finally:
        (tf32[0].allow_tf32, tf32[1].allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = start


def test_precision_scope_nests_on_one_thread():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with precision.precision_scope(precision.DEFAULT_POLICY):
            with precision.precision_scope(precision.DEFAULT_POLICY):
                assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            with precision.precision_scope(precision.BF16_POLICY):
                assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_a_kernel_loads_once_and_counts_every_launch_across_threads(
        monkeypatch, tmp_path):
    """Eight threads make a kernel's first launch at once: one library load
    and one entry point, and every launch counted; each build's temporary
    file is unique to its process and thread."""
    loads, cmds = [], []

    class Lib:
        def __init__(self, path):
            loads.append(path)
            time.sleep(0.05)                 # a slow load widens the race
            self.rgba_fake = lambda *a: 0
            self.rgba_cuda_error_string = lambda rc: b""

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    kern = build.CudaKernel("rans_decode.cu", "rgba_fake", [])
    monkeypatch.setattr(kern, "start_build", lambda: None)
    barrier = threading.Barrier(8)

    def go():
        barrier.wait()
        for _ in range(500):
            kern.launch()

    threads = [threading.Thread(target=go) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(loads) == 1 and kern.launches == 8 * 500

    class Proc:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    fresh = build.CudaKernel("rans_decode.cu", "rgba_fake", [])
    starts = [threading.Thread(target=fresh.start_build) for _ in range(2)]
    for t in starts:
        t.start()
    for t in starts:
        t.join(10)
    outs = [c[c.index("-o") + 1] for c in cmds]
    assert len(outs) == 2 and outs[0] != outs[1]
