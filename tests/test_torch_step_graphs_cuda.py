"""The codec's CUDA graphs (``rgba_tpu_torch/eval/step_graphs.py``) on a
card: a codec that captures and replays its device steps gives the eager
codec's blobs and decoded uint8 RGBA byte for byte, call after call, with
every hand-written kernel inside the graphs.

Needs an NVIDIA GPU with nvcc and skips without one; imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_step_graphs_cuda.py

The model is the benchmark's route (fp32, TF32 off, the four kernels)
with live weights (bias noise, an encoder gain), as the CPU codec tests
make them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec  # noqa: E402
from rgba_tpu_torch.eval.pipeline import PipelinedCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.ops.kernels import dse, gate_chain, gdn, win_attn  # noqa: E402

pytestmark = pytest.mark.cuda

KERNELS = (win_attn, gdn, gate_chain, dse)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _live(pipe, seed):
    """Seeded bias noise, DSE output biases at 0.5, encoder gain 10."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith(".bias"):
                p.add_((torch.randn(p.shape, generator=g) * 0.02).to(p.device))
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
        pipe.mask_codec.EncoderMask[7].weight.mul_(10.0)
    return pipe


@pytest.fixture(scope="module")
def pipe(card):
    policy = dataclasses.replace(DEFAULT_POLICY, fused_win_attn=True,
                                 fused_gdn=True, fused_gate_chain=True,
                                 fused_dse=True, packed_dse=False)
    return _live(RGBAPipeline(policy, seed=0), 1)


def _codec(pipe, graphs=True):
    c = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                      CodecIO(pipe.mask_codec, "mask"))
    for io in (c.rgb_io, c.mask_io):
        if not graphs:
            io.graphs.backend = None
    return c


def _close(*codecs):
    for c in codecs:
        c.rgb_io.close()
        c.mask_io.close()


def _u8(batch, h, w, seed):
    d = synthetic_rgba_batch(batch, h, w, seed=seed)
    return (np.round(d["image"] * 255).astype(np.uint8),
            np.round(d["alpha"] * 255).astype(np.uint8))


def _counts(codec):
    return [(io.graphs.captures, io.graphs.replays, io.graphs.fallbacks)
            for io in (codec.rgb_io, codec.mask_io)]


def _launches():
    return tuple(k.KERNEL.launches for k in KERNELS)


CASES = {
    "b1_256": dict(batch=1, h=256, w=256, enc={}, dec={}),
    "b4_256x384_interleave2": dict(batch=4, h=256, w=384, enc={},
                                   dec={"interleave": 2}),
    "gated_deadzone_preview": dict(batch=2, h=256, w=256,
                                   enc={"rate_gate": True, "deadzone": 0.3},
                                   dec={"max_slices": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replays_equal_the_eager_codec(pipe, case):
    """Four calls of a capturing codec (eager, capture, replay, replay)
    give an eager codec's blobs and uint8 RGBA byte for byte, with the
    same kernel launches a call; no capture falls back.  A fresh codec's
    eager first call decodes the replaying encoder's blobs, and the
    replaying decoder decodes the fresh codec's first blobs."""
    c = CASES[case]
    img, alpha = _u8(c["batch"], c["h"], c["w"], seed=len(case))
    eager = _codec(pipe, graphs=False)
    before = _launches()
    want = eager.encode_batch(img, alpha, **c["enc"])
    want_rgba = eager.decode_batch(want, output="uint8", **c["dec"])
    per_call = tuple(a - b for a, b in zip(_launches(), before))
    assert all(per_call)
    codec = _codec(pipe)
    for _ in range(4):
        before = _launches()
        assert codec.encode_batch(img, alpha, **c["enc"]) == want
        np.testing.assert_array_equal(
            codec.decode_batch(want, output="uint8", **c["dec"]), want_rgba)
        assert tuple(a - b for a, b in zip(_launches(), before)) == per_call
    (rc, rr, rf), (mc, mr, mf) = _counts(codec)
    assert rf == mf == 0 and rc > 0 and mc > 0 and rr > rc and mr > mc
    fresh = _codec(pipe)
    np.testing.assert_array_equal(
        fresh.decode_batch(codec.encode_batch(img, alpha, **c["enc"]),
                           output="uint8", **c["dec"]), want_rgba)
    fresh2 = _codec(pipe)
    np.testing.assert_array_equal(
        codec.decode_batch(fresh2.encode_batch(img, alpha, **c["enc"]),
                           output="uint8", **c["dec"]), want_rgba)
    _close(eager, codec, fresh, fresh2)


def test_the_cells_paths_replay_every_step(pipe):
    """At the benchmark's paths (v64, one image, no gate) a call replays
    24 steps once every key is captured, and captures nothing more."""
    img, alpha = _u8(1, 256, 256, seed=11)
    codec = _codec(pipe)
    for _ in range(2):
        codec.decode_batch(codec.encode_batch(img, alpha), output="uint8")
    before = _counts(codec)
    codec.decode_batch(codec.encode_batch(img, alpha), output="uint8")
    after = _counts(codec)
    assert [a[0] - b[0] for a, b in zip(after, before)] == [0, 0]
    assert sum(a[1] - b[1] for a, b in zip(after, before)) == 24
    assert [a[2] for a in after] == [0, 0]
    _close(codec)


def test_set_params_then_encode_equals_a_fresh_codec(pipe):
    """After set_params the replaying codec encodes as a fresh codec with
    the new weights, call after call (its graphs were dropped and are
    captured again)."""
    img, alpha = _u8(1, 256, 256, seed=12)
    mine = _live(RGBAPipeline(pipe.policy, seed=0), 1)
    other = _live(RGBAPipeline(pipe.policy, seed=3), 4)
    codec = _codec(mine)
    for _ in range(3):
        codec.encode_batch(img, alpha)
    for io, m in ((codec.rgb_io, other.rgb_codec),
                  (codec.mask_io, other.mask_codec)):
        io.set_params(m.state_dict())
        assert io.graphs.keys() == []
    fresh = _codec(other, graphs=False)
    want = fresh.encode_batch(img, alpha)
    for _ in range(3):
        assert codec.encode_batch(img, alpha) == want
    assert [io.graphs.fallbacks for io in (codec.rgb_io, codec.mask_io)] \
        == [0, 0]
    _close(codec, fresh)


def test_two_pipelined_workers_at_once(pipe):
    """PipelinedCodec's two workers replay one codec's graphs on the
    caller's stream at once and give the serial eager round trips."""
    batches = [_u8(2, 256, 256, seed=20 + i) for i in range(4)]
    eager = _codec(pipe, graphs=False)
    want = [(blobs, eager.decode_batch(blobs, output="uint8"))
            for blobs in (eager.encode_batch(*b) for b in batches)]
    codec = _codec(pipe)
    pc = PipelinedCodec(codec, depth=2)
    try:
        for _ in range(3):
            got = list(pc.roundtrip_stream(batches, output="uint8"))
            for (gb, gr), (wb, wr) in zip(got, want):
                assert gb == wb
                np.testing.assert_array_equal(gr, wr)
    finally:
        pc.close()
    # a capture may be invalidated by the other worker's device-wide work
    # (its key then runs eagerly, counted): the bytes hold either way
    (rc, rr, rf), (mc, mr, mf) = _counts(codec)
    assert rr > rc > 0 and mr > mc > 0
    _close(eager, codec)


def test_the_kernels_run_inside_the_graphs(pipe):
    """A profiled replaying round trip shows the hand-written kernels on
    the device, and no launch of them from the host."""
    from torch.profiler import ProfilerActivity, profile
    img, alpha = _u8(1, 256, 256, seed=13)
    codec = _codec(pipe)
    for _ in range(2):
        codec.decode_batch(codec.encode_batch(img, alpha))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        codec.decode_batch(codec.encode_batch(img, alpha))
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    for k in ("gate_chain_tf32_kernel", "dse_tf32_kernel", "gdn_tf32_kernel",
              "win_attn_tf32_kernel"):
        assert any(k in n for n in names), k
    assert any("cudaGraphLaunch" in n for n in names)
    _close(codec)
