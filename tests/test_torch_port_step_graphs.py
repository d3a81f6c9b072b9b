"""The codec's step graphs (``rgba_tpu_torch/eval/step_graphs.py``) on the
CPU, where nothing is captured: a CPU codec and a sharded codec run every
step eagerly; with a stand-in for CUDA graphs (``StubGraphs``: a "capture"
hands back outputs filled with a sentinel, as a real capture runs nothing,
and a replay runs the step again into them) the keys, the first-call-eager
rule, the copies in and out, the bound, ``set_params``, a failed capture,
the replay spans and the kernels' launch counts, with every blob and image
byte-identical to the eager codec's."""

import contextlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval import step_graphs  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec  # noqa: E402
from rgba_tpu_torch.eval.pipeline import PipelinedCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.ops.kernels import build  # noqa: E402
from rgba_tpu_torch.parallel.mesh import batch_sharding, make_mesh  # noqa: E402
from rgba_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

SENTINEL = 7


class _StubGraph:
    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        for o, new in zip(self.outputs, self.fn(*self.inputs)):
            o.copy_(new)


class StubGraphs:
    """Stands in for ``step_graphs.CudaGraphs`` on the CPU."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.order = []

    def capture(self, fn, inputs):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        outputs = tuple(torch.full_like(o, SENTINEL) for o in fn(*inputs))
        return _StubGraph(fn, inputs, outputs), outputs

    @contextlib.contextmanager
    def ordered(self):
        self.order.append("begin")
        yield
        self.order.append("end")

    def reset(self):
        self.order.append("reset")


@pytest.fixture(scope="module")
def pipe():
    return RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)


_OPEN: list = []


@pytest.fixture(scope="module", autouse=True)
def _close_codecs():
    yield
    for io in _OPEN:
        io.close()


def _codec(pipe, stub=True):
    c = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                      CodecIO(pipe.mask_codec, "mask"))
    for io in (c.rgb_io, c.mask_io):
        _OPEN.append(io)
        assert io.graphs.backend is None
        if stub:
            io.graphs.backend = StubGraphs()
    return c


@pytest.fixture(scope="module")
def eager(pipe):
    return _codec(pipe, stub=False)


def _u8(batch, h, w, seed):
    d = synthetic_rgba_batch(batch, h, w, seed=seed)
    return (np.round(d["image"] * 255).astype(np.uint8),
            np.round(d["alpha"] * 255).astype(np.uint8))


def _steps_per_call(codec, chains=1):
    """Device steps of an encode_batch + decode_batch with an alpha to
    code, whose decodes run in ``chains`` sub-batch chains (the encode's
    alpha decode picks its own, 1 or 2 at a batch of 1 or 4): the mask
    pass, the alpha chains and the alpha image, the RGB pass; the RGB
    chains, the mask chain and both images.  A chain is its first step, a
    step per serial slice and one for the parallel tail."""
    def chain(io):
        tail = io.num_slices - io.max_support
        return 1 + io.num_slices - max(0, tail) + int(tail > 0)
    rgb, mask = codec.rgb_io, codec.mask_io
    return (1 + chains * chain(mask) + 1 + 1) + \
        (chains * chain(rgb) + chain(mask) + 2)


def _counts(codec):
    return [(io.graphs.captures, io.graphs.replays, io.graphs.fallbacks)
            for io in (codec.rgb_io, codec.mask_io)]


CASES = {
    "b1": dict(batch=1, h=64, w=64, enc={}, dec={}),
    "b4_interleave2": dict(batch=4, h=64, w=128, enc={},
                           dec={"interleave": 2}),
    "gated_deadzone_preview": dict(batch=2, h=64, w=64,
                                   enc={"rate_gate": True, "deadzone": 0.3},
                                   dec={"max_slices": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replays_equal_the_eager_codec(pipe, eager, case):
    """Three calls give the eager codec's blobs and images byte for byte.
    The RGB codec's first call runs eagerly (the alpha's steps run in the
    encode and again in the decode, and two sub-batch chains of one key
    run in turn, so those capture within it); by the second every step is
    captured, and the third only replays, every step once."""
    c = CASES[case]
    img, alpha = _u8(c["batch"], c["h"], c["w"], seed=len(case))
    want = eager.encode_batch(img, alpha, **c["enc"])
    want_rgba = eager.decode_batch(want, output="uint8", **c["dec"])
    codec = _codec(pipe)
    counts = []
    for _ in range(3):
        assert codec.encode_batch(img, alpha, **c["enc"]) == want
        np.testing.assert_array_equal(
            codec.decode_batch(want, output="uint8", **c["dec"]), want_rgba)
        counts.append(_counts(codec))
    if c["batch"] != 4:       # two RGB chains of one key capture at once
        assert counts[0][0] == (0, 0, 0)
    (rc1, rr1, _), (mc1, mr1, _) = counts[1]
    (rc2, rr2, rf), (mc2, mr2, mf) = counts[2]
    keys = len(codec.rgb_io.graphs.keys()) + len(codec.mask_io.graphs.keys())
    assert (rc2, mc2) == (rc1, mc1) and rc2 + mc2 == keys
    assert rf == mf == 0
    if case != "gated_deadzone_preview":
        chains = 2 if c["batch"] == 4 else 1
        assert rr2 - rr1 + mr2 - mr1 == _steps_per_call(codec, chains)


def test_the_cells_take_24_steps_a_call(eager):
    assert _steps_per_call(eager) == 24


def test_a_cpu_codec_never_captures(eager):
    img, alpha = _u8(1, 64, 64, seed=3)
    blobs = [eager.encode_batch(img, alpha) for _ in range(3)]
    assert blobs[0] == blobs[1] == blobs[2]
    for io in (eager.rgb_io, eager.mask_io):
        assert io.graphs.backend is None
        assert io.graphs.keys() == []
        assert (io.graphs.captures, io.graphs.replays) == (0, 0)


def test_a_sharded_codec_never_captures(pipe, eager, monkeypatch):
    """The replicas of a batch-sharded codec run eagerly, even where the
    codec's own device captures; the bytes are the unsharded codec's."""
    monkeypatch.setattr(step_graphs, "backend", lambda device: StubGraphs())
    mesh = make_mesh(devices=["cpu", "cpu"])
    codec = RGBAFileCodec(
        CodecIO(pipe.rgb_codec, "rgb", sharding=batch_sharding(mesh)),
        CodecIO(pipe.mask_codec, "mask", sharding=batch_sharding(mesh)))
    img, alpha = _u8(2, 64, 64, seed=4)
    want = eager.encode_batch(img, alpha)
    want_rgba = eager.decode_batch(want, output="uint8")
    for _ in range(3):
        assert codec.encode_batch(img, alpha) == want
        np.testing.assert_array_equal(
            codec.decode_batch(want, output="uint8"), want_rgba)
    for io in (codec.rgb_io, codec.mask_io):
        for r in io._replicas:
            assert r.graphs.backend is None
            assert (r.graphs.captures, r.graphs.replays) == (0, 0)
        io.close()


# ------------------------------------------------------------------ keys


def _keys(io):
    return {k[0] for k in io.graphs.keys()}


def test_the_steps_keys(pipe):
    """A round trip of the RGB codec holds one key per step: the encode
    pass at its deadzone, the chain's first step, each serial slice step
    and the tail at (k, tail), and the image."""
    codec = _codec(pipe)
    img, alpha = _u8(1, 64, 64, seed=5)
    codec.decode_batch(codec.encode_batch(img, alpha))
    assert _keys(codec.rgb_io) == {
        ("encode", 0.0), ("first", 10, 5), ("tail", 10, 5), ("image",),
        *[("slice", 10, 5, i) for i in range(5)]}
    assert _keys(codec.mask_io) == {
        ("encode", 0.0), ("first", 5, 0), ("image",),
        *[("slice", 5, 0, i) for i in range(5)]}
    sig = {k[0]: k[1] for k in codec.rgb_io.graphs.keys()}
    # the symbols come from the host; the chain's state and the image's
    # inputs are device tensors
    host = sig[("slice", 10, 5, 2)][0]
    assert host[0] == "host" and host[1][0] == 1 and host[2] == "<i2"
    # symbols, hyper means and scales, mu, the mean support; two slices
    assert len(sig[("slice", 10, 5, 2)]) == 5 + 2
    assert sig[("encode", 0.0)][2] is None          # no gate


CHANGES = {
    "shape": (dict(h=64, w=128), {}, {}),
    "batch": (dict(batch=2), {}, {}),
    "k": ({}, {}, dict(max_slices=3)),
    "tail": ({}, {}, dict(tail_parallel=False)),
    "gate": ({}, dict(rate_gate=True), {}),
    "deadzone": ({}, dict(deadzone=0.25), {}),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_any_change_is_a_new_key(pipe, change):
    """A new shape, batch, k, tail, gate or deadzone makes new keys, none
    of which replays what the old keys captured."""
    size, enc, dec = CHANGES[change]
    io = CodecIO(pipe.rgb_codec, "rgb")
    io.graphs.backend = StubGraphs()

    def keys_of(batch=1, h=64, w=64, enc=None, dec=None):
        d = synthetic_rgba_batch(batch, h, w, seed=6)
        a = d["alpha"].copy()
        a[:, : h // 2] = 0.0
        x = np.where(a > 0, d["image"], 0.0).astype(np.float32)
        before = set(io.graphs.keys())
        comps = io.compress_batch(image=x, mask=a, **(enc or {}))
        io.decompress_batch(comps, mask=a, **(dec or {}))
        return set(io.graphs.keys()) - before

    base = keys_of()
    assert keys_of() == set()
    new = keys_of(**size, enc=enc, dec=dec)
    steps = {"encode"} if enc else {"first", "slice"} if dec else \
        {"encode", "first", "slice", "tail", "image"}
    assert new and {k[0][0] for k in new} == steps
    assert not new & base
    io.close()


# ------------------------------------------------------ the mechanism


def _graphs(fail=False):
    g = step_graphs.StepGraphs("cpu", "t.upload", "t.replay")
    g.backend = StubGraphs(fail)
    return g


def _double(x, y):
    return (2 * x + y,)


def test_first_call_eager_then_capture_then_replay():
    g = _graphs()
    x, y = torch.arange(4.0), np.arange(4, dtype=np.int16)
    for call in range(4):
        out, = g.run(("double",), _double, (x + call, y))
        torch.testing.assert_close(out, 2 * (x + call) + torch.from_numpy(y))
        assert (g.captures, g.replays) == (min(call, 1), max(call, 0))
    assert g.backend.order == ["begin", "end"] * 3


def test_a_replay_hands_back_copies():
    """Two callers of one key (interleaved chains) each own their output:
    the next replay writes the graph's static output, not theirs."""
    g = _graphs()
    x = torch.zeros(3)

    def inc(t, _):
        return (t + 1,)
    for _ in range(2):
        g.run(("k",), inc, (x, None))
    a, = g.run(("k",), inc, (x, None))
    b, = g.run(("k",), inc, (x + 10, None))
    assert torch.equal(a, torch.ones(3))
    assert torch.equal(b, torch.full((3,), 11.0))


def test_the_cache_is_bounded_least_recently_used_first(monkeypatch):
    monkeypatch.setattr(step_graphs, "MAX_KEYS", 3)
    g = _graphs()
    x = torch.ones(2)
    for key in ("a", "b", "a", "c", "d"):
        g.run((key,), _double, (x, x))
    assert [k[0] for k in g.keys()] == [("a",), ("c",), ("d",)]
    assert (g.captures, g.replays) == (1, 1)      # "a" at its second call
    # a cycle longer than the bound runs eagerly: each key is dropped
    # before its second call, and nothing more is captured
    for _ in range(3):
        for key in ("e", "f", "g", "h"):
            g.run((key,), _double, (x, x))
    assert (g.captures, g.replays) == (1, 1)
    # the last captured step was dropped: its pool goes with it
    assert g.backend.order[-1] == "reset"
    g.run(("h",), _double, (x, x))
    assert (g.captures, g.replays) == (2, 2)


def test_a_failed_capture_stays_eager_and_is_counted():
    g = _graphs(fail=True)
    x = torch.ones(2)
    with pytest.warns(RuntimeWarning, match="capturing a step failed"):
        for _ in range(4):
            out, = g.run(("k",), _double, (x, x))
            torch.testing.assert_close(out, 3 * x)
    assert (g.captures, g.replays, g.fallbacks) == (0, 0, 1)


def test_set_params_drops_the_graphs(pipe):
    """After set_params the codec's next call runs eagerly, the one after
    captures again, and the bytes are a fresh codec's with the new
    weights."""
    model = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0).rgb_codec
    io = CodecIO(model, "rgb")
    io.graphs.backend = StubGraphs()
    d = synthetic_rgba_batch(1, 64, 64, seed=7)
    x = np.where(d["alpha"] > 0, d["image"], 0.0).astype(np.float32)
    for _ in range(3):
        io.compress_batch(image=x, mask=d["alpha"])
    assert (io.graphs.captures, io.graphs.replays) == (1, 2)
    state = {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point()
             else v for k, v in model.state_dict().items()}
    io.set_params(state)
    assert io.graphs.keys() == [] and io.graphs.backend.order[-1] == "reset"
    fresh = CodecIO(RGBAPipeline(DEFAULT_POLICY, device="cpu",
                                 seed=1).rgb_codec, "rgb")
    fresh.set_params(state)
    want = fresh.compress_batch(image=x, mask=d["alpha"])
    for call in range(3):
        got = io.compress_batch(image=x, mask=d["alpha"])
        assert [g["strings"] for g in got] == [w["strings"] for w in want]
        assert (io.graphs.captures, io.graphs.replays) == (
            1 + min(call, 1), 2 + call)
    io.close()
    fresh.close()


def test_each_replay_is_a_leaf_span_of_its_call(pipe):
    """Under a profiler each replay is one ``<kind>.replay`` span, a leaf
    of its call's root beside the fetches, uploads and rANS (none nested
    in another): 24 a round trip."""
    codec = _codec(pipe)
    img, alpha = _u8(1, 64, 64, seed=8)
    for _ in range(2):
        codec.decode_batch(codec.encode_batch(img, alpha))
    last = max((s[3] for s in trace.spans()), default=0)
    with profile(activities=[ProfilerActivity.CPU]):
        codec.decode_batch(codec.encode_batch(img, alpha))
    spans = [s for s in trace.spans() if s[3] > last]
    roots = {s[3] for s in spans if s[4] is None}
    assert len(roots) == 2
    assert all(s[4] in roots for s in spans if s[4] is not None)
    replays = [s for s in spans if s[0].endswith(".replay")]
    assert len(replays) == _steps_per_call(codec) == 24
    assert sum(s[0] == "mask.replay" for s in replays) == 1 + 6 + 1 + 6 + 1


def test_pipelined_workers_share_the_graphs(pipe, eager):
    """Two PipelinedCodec workers replay one codec's graphs at once and get
    the serial loop's bytes."""
    codec = _codec(pipe)
    batches = [_u8(1, 64, 64, seed=10 + i) for i in range(4)]
    want = [eager.encode_batch(*b) for b in batches]
    for _ in range(2):
        codec.encode_batch(*batches[0])
    pc = PipelinedCodec(codec, depth=2)
    try:
        assert list(pc.encode_stream(batches * 2)) == want * 2
    finally:
        pc.close()
    assert codec.rgb_io.graphs.replays >= 1 + 8


def test_launches_made_in_a_capture_count_at_each_replay():
    """A kernel launched while a graph is captured runs only when the graph
    replays: the capture records the launch, each replay counts it; a
    launch on another thread meanwhile counts at once."""
    k = build.CudaKernel("none.cu", "none", [])
    k._function = lambda: (lambda *a: 0)
    k.launch()
    with build.recording() as rec:
        k.launch()
        k.launch()
        t = threading.Thread(target=k.launch)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert rec == {k: 2} and k.launches == 2
    for _ in range(3):
        build.count(rec)
    assert k.launches == 8
