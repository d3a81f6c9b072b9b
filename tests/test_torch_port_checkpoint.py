"""The port reads the JAX package's checkpoints: ``iter_<N>.ckpt`` files that
``rgba_tpu.train.checkpoint.save_checkpoint`` writes (flax msgpack of the
parameter tree), decoded without flax or msgpack
(``rgba_tpu_torch/train/flax_msgpack.py``) and mapped through
``weights.state_dict_from_jax``.

Exact throughout: the decoder against ``msgpack.unpackb`` and
``flax.serialization.msgpack_restore`` on flax's own bytes, and every
loaded tensor against ``state_dict_from_jax`` of the same tree, bit for
bit.  The parameter trees are the port's seeded weights carried into the
JAX layout by the JAX package's importer.
"""

import msgpack
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.train import checkpoint as jckpt  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import RGBCodec  # noqa: E402
from rgba_tpu_torch.train import flax_msgpack  # noqa: E402
from rgba_tpu_torch.train.checkpoint import (load_checkpoint,  # noqa: E402
                                             save_checkpoint, step_from_path)
from rgba_tpu_torch.weights import state_dict_from_jax  # noqa: E402

from torch_port_util import KEY, torch_sd  # noqa: E402

torch.set_num_threads(2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def trees():
    """{kind: (JAX parameter tree, port module class)} for the three kinds
    of tree, from one seeded port pipeline."""
    src = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=3)
    x = np.zeros((1, 64, 64, 3), np.float32)
    m = np.zeros((1, 64, 64, 1), np.float32)
    jm = JPipeline()
    tmpl = jax.eval_shape(lambda: jm.init({"params": KEY, "noise": KEY}, x, m,
                                          training=False))["params"]
    sd = torch_sd(src)
    sub = {
        s: convert_state_dict({k[len(s) + 1:]: v for k, v in sd.items()
                               if k.startswith(s + ".")}, tmpl[s], kind=kind)
        for s, kind in (("mask_codec", "mask"), ("rgb_codec", "rgb"))}
    return {"mask": sub["mask_codec"], "rgb": sub["rgb_codec"],
            "pipeline": sub}


def _fresh(kind):
    if kind == "pipeline":
        return RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=11)
    cls = MaskCodec if kind == "mask" else RGBCodec
    return cls(policy=DEFAULT_POLICY, device="cpu", generator=_gen(11))


@pytest.mark.parametrize("kind", ["mask", "rgb", "pipeline"])
def test_a_jax_checkpoint_loads_bit_for_bit(tmp_path, trees, kind):
    tree = trees[kind]
    path = jckpt.save_checkpoint(tree, str(tmp_path), 1234)
    assert path.endswith("iter_1234.ckpt") and step_from_path(path) == 1234
    with open(path, "rb") as f:
        assert flax_msgpack.is_msgpack_map(f.read(4), 2)
    module = _fresh(kind)
    assert load_checkpoint(module, path) == []
    want = state_dict_from_jax(tree, kind)
    got = module.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_a_tree_missing_a_subtree_loads_the_rest(tmp_path, trees):
    tree = {k: v for k, v in trees["mask"].items()}
    tree["decoder"] = {k: v for k, v in tree["decoder"].items()
                       if k != "dse9"}
    path = jckpt.save_checkpoint(tree, str(tmp_path), 7)
    module = _fresh("mask")
    before = {k: v.clone() for k, v in module.state_dict().items()}
    missing = load_checkpoint(module, path)
    dse = sorted(k for k in before if k.startswith("DecoderMask.9."))
    assert missing == dse and len(dse) == 16
    want = state_dict_from_jax(tree, "mask")
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k] if k in dse else want[k]), k


def test_the_ports_own_and_reference_files_still_load(tmp_path):
    src = MaskCodec(policy=DEFAULT_POLICY, device="cpu", generator=_gen(5))
    sd = src.state_dict()
    own = save_checkpoint(sd, str(tmp_path), 3)
    ref = str(tmp_path / "iter_9.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, ref)
    legacy = str(tmp_path / "legacy.pth")       # a pickle: 0x80 then 0x02
    torch.save(sd, legacy, _use_new_zipfile_serialization=False)
    with open(legacy, "rb") as f:
        assert f.read(1) == b"\x80"
    for path in (own, ref, legacy):
        dst = MaskCodec(policy=DEFAULT_POLICY, device="cpu", generator=_gen(6))
        assert load_checkpoint(dst, path) == [], path
        for k, v in dst.state_dict().items():
            assert torch.equal(v, sd[k]), (path, k)


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, "dtype"):
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            assert torch.is_tensor(got) and got.dtype == torch.bfloat16, where
            assert tuple(got.shape) == w.shape, where
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=where)
        else:
            g = np.asarray(got)
            assert g.dtype == w.dtype and g.shape == w.shape, where
            np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "kernel": rng.standard_normal((3, 5, 7)).astype(np.float32),
            "half": rng.standard_normal(6).astype(np.float16),
            "bf16": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16),
            "ints": rng.integers(-2 ** 40, 2 ** 40, 9).astype(np.int64),
            "bits": rng.random(5) > 0.5,
            "u8": rng.integers(0, 256, (2, 2), dtype=np.uint8),
            "empty": np.zeros((0, 4), np.float32),
        },
        "step": np.int32(17),
        "scale": np.float32(0.25),
        "meta": {"name": "iter_17", "n": -3, "big": 2 ** 40, "neg": -2 ** 35,
                 "x": 1.5, "none": None, "flag": True,
                 "list": [1, "two", 3.0, [4]], "blob": b"\x00\x01" * 200,
                 "long": "s" * 300},
    }


def test_the_decoder_equals_msgpack_on_flax_bytes():
    tree = _mixed_tree()
    data = serialization.msgpack_serialize(tree)
    want = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                           raw=False)
    _assert_same(flax_msgpack.unpackb(data), want)
    _assert_same(flax_msgpack.restore(data),
                 serialization.msgpack_restore(data))
    # a map of more than 15 entries (map16) and a long array (array16)
    wide = {f"k{i}": np.full(3, i, np.float32) for i in range(40)}
    wide["seq"] = list(range(70000, 70040))
    data = serialization.msgpack_serialize(wide)
    _assert_same(flax_msgpack.restore(data),
                 serialization.msgpack_restore(data))


def test_chunked_arrays_are_joined(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((9, 11)).astype(np.float32),
            "inner": {"b": jnp.asarray(rng.standard_normal(100),
                                       jnp.bfloat16)},
            "small": np.arange(3, dtype=np.float32)}
    data = serialization.msgpack_serialize(tree)
    raw = flax_msgpack.unpackb(data)
    assert raw["w"][flax_msgpack.CHUNKED] and len(raw["w"]["chunks"]) == 7
    assert raw["inner"]["b"][flax_msgpack.CHUNKED]
    _assert_same(flax_msgpack.restore(data),
                 serialization.msgpack_restore(data))


def test_corrupt_data_raises():
    data = serialization.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(data[:-3])
    with pytest.raises(ValueError, match="after the msgpack"):
        flax_msgpack.restore(data + b"\x00")
    with pytest.raises(ValueError, match="extension type 2"):
        flax_msgpack.restore(serialization.msgpack_serialize({"c": 1 + 2j}))
