"""The program's spans (``rgba_tpu_torch/utils/trace.py``) on the codec
path, on the CPU: a 64x64 ``RGBAFileCodec`` round trip records nothing
without a profiler; under ``torch.profiler`` each call is one root whose
fetch, upload and rANS leaves carry its request id, lie inside it and never
overlap, also with interleaved decode chains; each span's profiler range
lies within its two ``time.time_ns()`` stamps; and the fetches per call
follow from the codecs' slice counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec, unpack_rgba  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

ROOTS = ("container.encode_batch", "container.decode_batch")
LEAVES = ("fetch", "upload", "rans")


@pytest.fixture(scope="module")
def codec():
    pipe = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    c = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                      CodecIO(pipe.mask_codec, "mask"))
    yield c
    c.rgb_io.close()
    c.mask_io.close()


def _inputs(batch: int):
    d = synthetic_rgba_batch(batch, 64, 64, seed=batch)
    return (np.round(d["image"] * 255).astype(np.uint8),
            np.round(d["alpha"] * 255).astype(np.uint8))


def _round_trip(codec, batch: int, interleave=None):
    image, alpha = _inputs(batch)
    blobs = codec.encode_batch(image, alpha)
    assert all(unpack_rgba(b)["mask"] is not None for b in blobs)
    codec.decode_batch(blobs, output="uint8", interleave=interleave)


def _newest_id() -> int:
    return max((s[3] for s in trace.spans()), default=0)


def _traced(codec, batch: int, interleave=None):
    """(the spans of one traced round trip, the profiler)."""
    last = _newest_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _round_trip(codec, batch, interleave)
    return [s for s in trace.spans() if s[3] > last], prof


@pytest.fixture(scope="module")
def one(codec):
    return _traced(codec, 1)


@pytest.fixture(scope="module")
def four(codec):
    return _traced(codec, 4, interleave=2)[0]


def _tree(spans):
    """{root: its leaves}, checking that every span is a root or a leaf of
    one: a leaf's parent and request are its root's id, and it lies within
    its root."""
    roots = {s[3]: s for s in spans if s[4] is None}
    assert [r[0] for r in roots.values()] == list(ROOTS)
    assert all(r[5] == r[3] for r in roots.values())
    tree = {i: [] for i in roots}
    for s in spans:
        if s[4] is None:
            continue
        root = roots[s[4]]
        assert s[5] == root[3]
        assert root[1] <= s[1] <= s[2] <= root[2]
        assert s[0].split(".")[0] in ("rgb", "mask", "container")
        assert s[0].split(".")[1] in LEAVES
        tree[root[3]].append(s)
    return tree


def _fetches(tree) -> list:
    return [sum(s[0].endswith(".fetch") for s in leaves)
            for leaves in tree.values()]


def _expected_fetches(codec, chains: int):
    """(encode, decode) device-to-host waits of a batch with an alpha to
    code, whose decodes run in ``chains`` sub-batch chains (the encode's
    alpha decode picks its own, as a batch of 1 or 4 asks for 1 or 2): the
    mask's symbols, each alpha chain's slice steps, the RGB symbols; then
    each RGB chain's slice steps, the one mask chain's, and the RGBA.  A
    chain fetches once for each serial slice and once for its parallel
    tail."""
    def steps(io):
        tail = io.num_slices - io.max_support
        return io.num_slices - max(0, tail) + int(tail > 0)
    rgb, mask = codec.rgb_io, codec.mask_io
    return (1 + chains * steps(mask) + 1,
            chains * steps(rgb) + steps(mask) + 1)


def test_no_span_is_recorded_without_a_profiler(codec):
    before = trace.spans()
    _round_trip(codec, 1)
    assert trace.spans() == before


def test_each_call_is_one_root_over_its_leaves(one):
    tree = _tree(one[0])
    assert all(leaves for leaves in tree.values())
    assert len(one[0]) == len(tree) + sum(map(len, tree.values()))


def test_leaves_on_a_thread_never_overlap(one, four):
    for spans in (one[0], four):
        leaves = sorted((s for s in spans if s[4] is not None),
                        key=lambda s: s[1])
        assert all(a[2] <= b[1] for a, b in zip(leaves, leaves[1:]))


def test_interleaved_chains_keep_one_tree(codec, four):
    """Two RGB chains and the mask chain, driven in turn on one thread:
    each chain's z decode and each of its slice steps is one rANS span, and
    the chains' steps interleave."""
    tree = _tree(four)
    assert _fetches(tree) == list(_expected_fetches(codec, chains=2))
    decode = list(tree.values())[1]
    names = [s[0] for s in decode]
    assert names.count("rgb.rans") == 2 * (1 + 5 + 1)
    assert names.count("mask.rans") == 1 + 5
    first_mask = names.index("mask.rans")
    assert first_mask < len(names) - names[::-1].index("rgb.rans")
    assert "rgb.rans" in names[first_mask:]


def test_profiler_ranges_lie_within_the_spans(one):
    spans, prof = one
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    for name, mine in by_name.items():
        theirs = sorted(ranges.get(name, []))
        assert len(theirs) == len(mine), name
        for s, (a, b) in zip(sorted(mine, key=lambda s: s[1]), theirs):
            assert s[1] <= a <= b <= s[2], name


def test_fetches_per_call_follow_the_slices(codec, one):
    rgb, mask = codec.rgb_io, codec.mask_io
    assert (rgb.num_slices, rgb.max_support) == (10, 5)
    assert (mask.num_slices, mask.max_support) == (5, 5)
    assert _expected_fetches(codec, chains=1) == (7, 12)
    assert _fetches(_tree(one[0])) == [7, 12]
