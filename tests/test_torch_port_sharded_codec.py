"""Batch-sharded serving of the PyTorch port (``CodecIO(sharding=)``) on a
two-replica CPU mesh: the twins of ``tests/test_serving_sharded.py``.

A batch sharded over the mesh must give streams, container blobs and
decodes bit-identical to the unsharded codec's: sharding changes
throughput, not the format.  As in the JAX package, the lane (v3) decode
refuses a sharded codec and the decode chain is not interleaved.  Weights
are the port's, drawn from a seed and made live as in
``tests/test_torch_port_models.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,  # noqa: E402
                                          replicated_sharding)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipe():
    tp = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tp.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        tp.rgb_codec.Encoder.x4.weight.mul_(10.0)
        tp.mask_codec.EncoderMask[7].weight.mul_(10.0)
    return tp


@pytest.fixture(scope="module")
def sharding():
    return batch_sharding(make_mesh(devices=["cpu", "cpu"]))


def test_codec_batch_sharded_bitstream_identical(pipe, sharding):
    alpha = synthetic_rgba_batch(4, 64, 64, seed=11)["alpha"]
    plain = CodecIO(pipe.mask_codec, "mask")
    sharded = CodecIO(pipe.mask_codec, "mask", sharding=sharding)
    assert len(sharded._replicas) == 2
    # replica 0 is the codec's own model, replica 1 a copy
    assert sharded._replicas[0].model is pipe.mask_codec
    assert sharded._replicas[1].model is not pipe.mask_codec
    comps_plain = plain.compress_batch(mask=alpha)
    comps_shard = sharded.compress_batch(mask=alpha)
    assert len(comps_shard) == 4
    for a, b in zip(comps_plain, comps_shard):
        assert a["shape"] == b["shape"]
        assert a["strings"][0] == b["strings"][0]
        assert a["strings"][1] == b["strings"][1]
    out_plain = plain.decompress_batch(comps_plain)
    np.testing.assert_array_equal(out_plain, sharded.decompress_batch(comps_shard))
    # the decode chain is not interleaved on a sharded codec
    assert len(sharded.decompress_chains(comps_shard, interleave=2)) == 1
    with pytest.raises(ValueError, match="does not divide"):
        sharded.compress_batch(mask=alpha[:3])
    plain.close()
    sharded.close()


def test_container_roundtrip_batch_sharded_identical(pipe, sharding):
    """The full RGBAFileCodec encode_batch / decode_batch over two sharded
    CodecIOs: blobs and decoded RGBA equal the unsharded codec's."""
    d = synthetic_rgba_batch(4, 64, 64, seed=23)

    def build(sh):
        return RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb", sharding=sh),
                             CodecIO(pipe.mask_codec, "mask", sharding=sh))

    plain, sharded = build(None), build(sharding)
    blobs_plain = plain.encode_batch(d["image"], d["alpha"])
    blobs_shard = sharded.encode_batch(d["image"], d["alpha"])
    assert blobs_shard == blobs_plain, "sharded encode changed the format"
    np.testing.assert_array_equal(sharded.decode_batch(blobs_shard),
                                  plain.decode_batch(blobs_plain))
    # rate-gated streams (version 2) too
    gated = sharded.encode_batch(d["image"], d["alpha"], rate_gate=True)
    assert gated == plain.encode_batch(d["image"], d["alpha"], rate_gate=True)
    np.testing.assert_array_equal(sharded.decode_batch(gated),
                                  plain.decode_batch(gated))
    # the lane (v3) decode refuses a sharded codec, as in the JAX package
    comps = sharded.mask_io.compress_batch(mask=d["alpha"],
                                           stream_format="lanes32")
    with pytest.raises(NotImplementedError, match="sharded"):
        sharded.mask_io.decompress_device(comps)
    for c in (plain, sharded):
        c.rgb_io.close()
        c.mask_io.close()


def test_set_params_updates_every_replica(pipe, sharding):
    io = CodecIO(pipe.mask_codec, "mask", sharding=sharding)
    sd = {k: v + 0.01 if v.is_floating_point() else v
          for k, v in pipe.mask_codec.state_dict().items()}
    try:
        io.set_params(sd)
        for r in io._replicas:
            for k, v in r.model.state_dict().items():
                assert torch.equal(v, sd[k]), k
            assert r.eb_tables["quantized_cdfs"].tolist() == \
                io.eb_tables["quantized_cdfs"].tolist()
    finally:
        io.close()
        pipe.mask_codec.load_state_dict(
            {k: v - 0.01 if v.is_floating_point() else v
             for k, v in sd.items()})


def test_sharding_must_cut_the_batch(pipe):
    mesh = make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch sharding"):
        CodecIO(pipe.mask_codec, "mask", sharding=replicated_sharding(mesh))
