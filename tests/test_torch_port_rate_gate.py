"""The codec's v64 serving options in the PyTorch port against the JAX
package on the CPU: the rate gate, the deadzone quantizer, the progressive
preview (``max_slices``), ``set_params`` and the version-2 container.

Weights, fixtures and data as in tests/test_torch_port_codec.py (64x128
images; the alpha's right half transparent, so the gate closes cells).
Exact where the contract is exact: symbols (y and z) and the v64 y strings
against JAX's, the port's own round trips, bytes after ``set_params``.
The z strings are not compared across the packages: their z CDF tables
may differ by an ulp (ROADMAP queue 3).  The preview's x_hat is held to
JAX's within 2e-4, the x_hat tolerance of tests/test_torch_parity.py; the
gated decode to the gated forward within 1e-5, as the ungated one is.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.eval.codec_io import CodecIO as JCodecIO  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.ops.mask_pyramid import mask_pyramid as j_pyramid  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec, unpack_rgba  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid  # noqa: E402
from rgba_tpu_torch.weights import state_dict_from_jax  # noqa: E402

from test_torch_port_codec import ios, jax_params, pipe  # noqa: E402,F401
from torch_port_util import nchw  # noqa: E402

torch.set_num_threads(2)

PREVIEW_TOL = 2e-4
ROUND_TRIP_TOL = 1e-5
DEADZONE = 0.3


@pytest.fixture(scope="module")
def data():
    """Batch 2, 64x128, the right half transparent: masked RGB, alpha."""
    d = synthetic_rgba_batch(2, 64, 128, seed=8)
    a = d["alpha"].copy()
    a[:, :, 64:] = 0.0
    x = np.where(a > 0, d["image"], 0.0).astype(np.float32)
    return x, a


@pytest.fixture(scope="module")
def jio(jax_params):
    return JCodecIO(JRGBCodec(), jax_params["rgb_codec"], kind="rgb")


def _gate(a):
    return np.asarray(mask_pyramid(nchw(a))[2].permute(0, 2, 3, 1)) > 0


@pytest.mark.parametrize("option", ["rate_gate", "deadzone"])
def test_symbols_equal_jax_compress(ios, jio, data, option):
    """y and z symbols of the gated / deadzoned encoder equal JAX's exactly."""
    x, a = data
    gated = option == "rate_gate"
    dz = DEADZONE if option == "deadzone" else 0.0
    gate = mask_pyramid(nchw(a))[2] > 0 if gated else None
    y, idx, z = ios[0]._compress_device(nchw(x), nchw(a), gate, dz)
    me = j_pyramid(jnp.asarray(a))
    args = (jnp.asarray(x), jnp.asarray(a), me[1], me[2])
    if gated:
        jgate = np.asarray(me[2]) > 0
        np.testing.assert_array_equal(jgate, _gate(a))
        args = (jnp.asarray(jgate),) + args
    pre = [jnp.float32(dz)] if dz else []
    jy, jidx, jz = jio._compress_variant(gated, bool(dz))(
        jio._fp.flat, *pre, *args)[:3]
    np.testing.assert_array_equal(z, np.asarray(jz).astype(np.int32))
    np.testing.assert_array_equal(y, np.asarray(jy).astype(np.int32))
    np.testing.assert_array_equal(idx, np.asarray(jidx).astype(np.int32))
    plain = ios[0]._compress_device(nchw(x), nchw(a))[0]
    if gated:
        closed = ~_gate(a)
        assert closed.any() and not closed.all()
        assert not y[:, np.broadcast_to(closed, y.shape[1:])].any()
        assert (plain[:, np.broadcast_to(closed, y.shape[1:])] != 0).any()
    else:
        assert 0 < np.count_nonzero(y) < np.count_nonzero(plain)


@pytest.mark.parametrize("option", ["rate_gate", "deadzone"])
def test_v64_y_strings_are_the_jax_bytes(ios, jio, data, option):
    x, a = data
    kw = {"rate_gate": True} if option == "rate_gate" else \
        {"deadzone": DEADZONE}
    got = ios[0].compress_batch(image=x, mask=a, **kw)
    want = jio.compress_batch(image=x, mask=a, **kw)
    for g, w in zip(got, want):
        assert g["strings"][0] == w["strings"][0]
        assert g["shape"] == w["shape"]
        assert ("gate" in g) == (option == "rate_gate") == ("gate" in w)
        if "gate" in g:
            np.testing.assert_array_equal(g["gate"], np.asarray(w["gate"]))


def test_gated_decode_equals_the_gated_forward(pipe, ios, data):
    """The gated stream decodes to the RGB codec's forward with its rate
    gate on (gated cells at symbol 0, y = mu + lrp)."""
    x, a = data
    comps = ios[0].compress_batch(image=x, mask=a, rate_gate=True)
    recon = ios[0].decompress_batch(comps, mask=a)
    # the gate shipped in each stream is the one used, not one re-derived
    fake = [dict(c, gate=np.ones_like(c["gate"])) for c in comps]
    assert not np.array_equal(ios[0].decompress_batch(fake, mask=a), recon)
    pipe.rgb_codec.rate_gate = True
    try:
        with torch.inference_mode():
            ta = nchw(a)
            fwd = pipe.rgb_codec(nchw(x), ta, ta, mask_pyramid(ta))
    finally:
        pipe.rgb_codec.rate_gate = False
    want = np.clip(fwd["x_hat"].permute(0, 2, 3, 1).numpy(), 0, 1)
    np.testing.assert_allclose(recon, want, atol=ROUND_TRIP_TOL)


def test_gate_presence_is_checked_on_every_stream(ios, data):
    x, a = data
    comps = ios[0].compress_batch(image=x, mask=a, rate_gate=True)
    mixed = [comps[0], {k: v for k, v in comps[1].items() if k != "gate"}]
    with pytest.raises(ValueError, match="stream 1 carries no rate gate"):
        ios[0].decompress_batch(mixed, mask=a)
    # with no gate shipped, rate_gate=True derives it from the same mask
    bare = [{k: v for k, v in c.items() if k != "gate"} for c in comps]
    np.testing.assert_array_equal(
        ios[0].decompress_batch(bare, mask=a, rate_gate=True),
        ios[0].decompress_batch(comps, mask=a))


def test_encoder_default_gate_does_not_gate_ungated_streams(pipe, ios, data):
    """A codec built with rate_gate=True encodes gated by default, but
    decodes an ungated stream as ungated: the constructor's flag never
    makes the decoder derive a gate from the mask."""
    x, a = data
    gated_io = CodecIO(pipe.rgb_codec, "rgb", rate_gate=True)
    try:
        assert all("gate" in c for c in
                   gated_io.compress_batch(image=x, mask=a))
        plain = ios[0].compress_batch(image=x, mask=a)
        np.testing.assert_array_equal(gated_io.decompress_batch(plain, mask=a),
                                      ios[0].decompress_batch(plain, mask=a))
    finally:
        gated_io.close()


@pytest.fixture(scope="module")
def gated_streams(ios, jio, data):
    x, a = data
    return (ios[0].compress_batch(image=x, mask=a, rate_gate=True),
            jio.compress_batch(image=x, mask=a, rate_gate=True))


@pytest.mark.parametrize("k", [0, 3, 10])
def test_preview_slices(ios, jio, data, gated_streams, k):
    """The first k slices of a preview are a full decode's, bit for bit;
    k = 0 reads no y bytes; x_hat is JAX's preview within 2e-4."""
    x, a = data
    comps, jcomps = gated_streams
    io = ios[0]
    full_x, full_y = io.decompress_batch_with_latent(comps, mask=a)
    px, py = io.decompress_batch_with_latent(comps, mask=a, max_slices=k)
    sw = full_y.shape[1] // io.num_slices
    np.testing.assert_array_equal(py[:, :k * sw], full_y[:, :k * sw])
    if k == io.num_slices:
        np.testing.assert_array_equal(px, full_x)
    else:
        assert not np.array_equal(px, full_x)
    if k == 0:
        empty = [dict(c, strings=[b"", c["strings"][1]]) for c in comps]
        np.testing.assert_array_equal(
            io.decompress_batch(empty, mask=a, max_slices=0), px)
    want = np.asarray(jio.decompress_batch(jcomps, mask=a, rate_gate=True,
                                           max_slices=k))
    np.testing.assert_allclose(px, want, atol=PREVIEW_TOL)


def test_v2_container_round_trip(ios):
    """A rate-gated container (version 2) re-encodes byte for byte, decodes
    alone as in its batch, codes fewer bytes than version 1 and previews.
    70x70 images pad to 128x128 with transparent pixels: image 0 is opaque,
    so its decoded alpha is 0 in the padding and the gate closes those
    cells; image 1 ships a mask stream."""
    codec = RGBAFileCodec(*ios)
    d = synthetic_rgba_batch(2, 70, 70, seed=15)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.full((2, 70, 70, 1), 255, np.uint8)
    alpha[1] = np.round(d["alpha"][1] * 255).astype(np.uint8)
    v1 = codec.encode_batch(img, alpha)
    v2 = codec.encode_batch(img, alpha, rate_gate=True)
    assert codec.encode_batch(img, alpha, rate_gate=True) == v2
    metas = [unpack_rgba(b) for b in v2]
    assert [m["rate_gated"] for m in metas] == [True, True]
    assert not metas[0]["rgb"]["gate"].all() and metas[1]["mask"] is not None
    assert len(metas[0]["rgb"]["strings"][0]) < \
        len(unpack_rgba(v1[0])["rgb"]["strings"][0])
    assert len(v2[0]) < len(v1[0])          # the gate bitmap included
    out = codec.decode_batch(v2, output="uint8")
    assert out.shape == (2, 70, 70, 4)
    np.testing.assert_array_equal(codec.decode(v2[0], output="uint8"),
                                  out[:1])
    np.testing.assert_array_equal(out[..., 3], codec.decode_batch(
        v1, output="uint8")[..., 3])
    with pytest.raises(ValueError, match="one container version"):
        codec.decode_batch([v1[0], v2[1]])
    full = codec.decode_batch(v2)
    np.testing.assert_array_equal(codec.decode_batch(v2, max_slices=10), full)
    assert not np.array_equal(codec.decode_batch(v2, max_slices=2), full)


def test_blob_decodes_alone_as_in_its_batch_on_the_cpu(ios):
    """Inside the codec's scope the convolutions run image by image on the
    CPU too (oneDNN also picks its algorithm by the batch size): a blob
    decoded alone gives what it gives in its batch."""
    codec = RGBAFileCodec(*ios)
    d = synthetic_rgba_batch(2, 64, 128, seed=3)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    blobs = codec.encode_batch(img, alpha)
    both = codec.decode_batch(blobs)
    for i in range(2):
        np.testing.assert_array_equal(codec.decode(blobs[i]), both[i:i + 1])


def _mask_codec(seed):
    return MaskCodec(policy=DEFAULT_POLICY, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def test_set_params_codes_as_a_fresh_codec(jax_params):
    """After set_params with a state dict of new weights (here from a JAX
    tree, through state_dict_from_jax), the codec codes the bytes a codec
    built on those weights codes: its z tables and medians are rebuilt."""
    rng = np.random.RandomState(16)
    tree = jax.tree_util.tree_map(np.array, jax_params["mask_codec"])
    eb = tree["prior"]["entropy_bottleneck"]
    med = rng.randn(192).astype(np.float32)
    spread = rng.uniform(3, 20, 192).astype(np.float32)
    eb["quantiles"] = np.stack([med - spread, med, med + spread],
                               -1).reshape(192, 1, 3).astype(np.float32)
    sd = state_dict_from_jax(tree, "mask")
    fresh_model = _mask_codec(1)
    fresh_model.load_state_dict(sd)
    fresh = CodecIO(fresh_model, "mask")
    io = CodecIO(_mask_codec(2), "mask")
    a = synthetic_rgba_batch(2, 64, 64, seed=17)["alpha"]
    old = io.compress_batch(mask=a)
    io.set_params(sd)
    got, want = io.compress_batch(mask=a), fresh.compress_batch(mask=a)
    assert got == want and got != old
    for key in ("quantized_cdfs", "cdf_lengths", "offsets", "medians"):
        np.testing.assert_array_equal(io.eb_tables[key],
                                      fresh.eb_tables[key])
    np.testing.assert_array_equal(io.decompress_batch(got),
                                  fresh.decompress_batch(want))
    # the lane tables follow the new weights too
    lanes = io.compress_batch(mask=a, stream_format="lanes32")
    assert lanes == fresh.compress_batch(mask=a, stream_format="lanes32")
    # after an in-place change, set_params() rebuilds the tables alone
    with torch.no_grad():
        io.model.entropy_bottleneck.quantiles.add_(0.5)
    io.set_params()
    fresh_model.load_state_dict(io.model.state_dict())
    again = CodecIO(fresh_model, "mask")
    assert io.compress_batch(mask=a) == again.compress_batch(mask=a)
    for c in (io, fresh, again):
        c.close()
