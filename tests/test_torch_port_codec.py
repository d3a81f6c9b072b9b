"""The bitstream codec of the PyTorch port against the JAX package on the
CPU: the host rANS coder, the CDF tables, the container bytes, CodecIO
round trips and RGBAFileCodec.

Weights are the port's, drawn from a seed and made live as in
tests/test_torch_port_models.py; they reach the JAX modules through the JAX
package's importer.  Exact where the contract is exact (rANS bytes, CDF
tables, container bytes, the port's own round trips, z symbols).  The y
symbols are held to 99.9% agreement with JAX's: a latent within fp32 noise
of a half integer may round the other way in another framework's convs.
The decoded image is held to the port's own forward within 1e-5, as
tests/test_codec_io.py holds the JAX codec to the JAX forward.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.entropy.bottleneck import EntropyBottleneck as JEB  # noqa: E402
from rgba_tpu.entropy.cdf import pmf_to_quantized_cdf_py  # noqa: E402
from rgba_tpu.entropy.gaussian import GaussianConditional as JGC  # noqa: E402
from rgba_tpu.entropy.gaussian import get_scale_table as j_scale_table  # noqa: E402
from rgba_tpu.eval import container as jcontainer  # noqa: E402
from rgba_tpu.eval.codec_io import CodecIO as JCodecIO  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.native import rans as jrans  # noqa: E402
from rgba_tpu.ops.mask_pyramid import mask_pyramid as j_pyramid  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.entropy.gaussian import GaussianConditional, get_scale_table  # noqa: E402
from rgba_tpu_torch.eval import container as tcontainer  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.native import rans  # noqa: E402
from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid  # noqa: E402
from rgba_tpu_torch.weights import load_jax_params  # noqa: E402

from torch_port_util import KEY, nchw, torch_sd  # noqa: E402

torch.set_num_threads(2)

ROUND_TRIP_TOL = 1e-5
Y_AGREEMENT = 0.999


def _perturb(pipe, seed):
    """Seeded bias noise, DSE output biases at 0.5, encoder gain 10."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
        pipe.mask_codec.EncoderMask[7].weight.mul_(10.0)


@pytest.fixture(scope="module")
def pipe():
    tp = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _perturb(tp, 1)
    return tp


@pytest.fixture(scope="module")
def ios(pipe):
    rgb, mask = CodecIO(pipe.rgb_codec, "rgb"), CodecIO(pipe.mask_codec, "mask")
    yield rgb, mask
    rgb.close()
    mask.close()


@pytest.fixture(scope="module")
def jax_params(pipe):
    d = synthetic_rgba_batch(1, 64, 64, seed=0)
    tmpl = jax.eval_shape(lambda: JPipeline().init(
        {"params": KEY, "noise": KEY}, d["masked_image"], d["alpha"],
        training=False))["params"]
    sd = torch_sd(pipe)
    return {sub: convert_state_dict(
                {k[len(sub) + 1:]: v for k, v in sd.items()
                 if k.startswith(sub + ".")}, tmpl[sub], kind=kind)
            for sub, kind in (("mask_codec", "mask"), ("rgb_codec", "rgb"))}


# ------------------------------------------------------------------- rANS


def _gaussian_symbols(n, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 64, n).astype(np.int32)
    # wide enough to reach the bypass escapes of the small scales
    sym = np.round(rng.randn(n) * get_scale_table()[idx] * 1.5).astype(np.int32)
    sym[::97] = rng.randint(-300, 301, sym[::97].shape)
    return sym, idx


def test_rans_streams_are_the_jax_packages_bytes():
    gc = GaussianConditional(get_scale_table())
    gc.update()
    tables = (gc.quantized_cdfs, gc.cdf_lengths, gc.offsets)
    sym, idx = _gaussian_symbols(20000, 0)
    data = rans.encode_with_indexes(sym, idx, *tables)
    assert data == jrans.encode_with_indexes(sym, idx, *tables)
    np.testing.assert_array_equal(rans.decode_with_indexes(data, idx, *tables),
                                  sym)
    # streaming decode, in the slices the codec reads
    with rans.RansDecoder(data) as dec:
        parts = [dec.decode_stream(idx[a:a + 5000], *tables)
                 for a in range(0, 20000, 5000)]
    np.testing.assert_array_equal(np.concatenate(parts), sym)


def test_rans_quantized_cdf_matches_the_numpy_twin():
    rng = np.random.RandomState(1)
    for _ in range(20):
        pmf = rng.dirichlet(np.ones(rng.randint(2, 100))).astype(np.float32)
        np.testing.assert_array_equal(rans.pmf_to_quantized_cdf(pmf, 16),
                                      pmf_to_quantized_cdf_py(pmf, 16))


def test_rans_refuses_indexes_outside_the_table():
    gc = GaussianConditional(get_scale_table())
    gc.update()
    with pytest.raises(ValueError, match="index"):
        rans.encode_with_indexes([0], [64], gc.quantized_cdfs,
                                 gc.cdf_lengths, gc.offsets)


def test_rans_library_builds_in_the_checkout():
    lib = rans.build()
    assert lib.parent == rans.BUILD_DIR and lib.exists()
    assert rans.BUILD_DIR.parts[-2:] == ("build", "native")


# ----------------------------------------------------------------- tables


def test_gaussian_tables_and_indexes_equal_jax():
    np.testing.assert_array_equal(get_scale_table(), j_scale_table())
    tg, jg = GaussianConditional(get_scale_table()), JGC(j_scale_table())
    tg.update()
    jg.update()
    for k in ("quantized_cdfs", "cdf_lengths", "offsets"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k), k)
    scales = np.abs(np.random.RandomState(2).randn(4, 8, 8, 5) * 20).astype(
        np.float32)
    scales[0, 0, 0, :] = get_scale_table()[:5].astype(np.float32)  # ties
    np.testing.assert_array_equal(
        tg.build_indexes(torch.from_numpy(scales)).numpy(),
        np.asarray(jg.build_indexes(jnp.asarray(scales))))
    sym = np.array([-2.0, 0.0, 3.0], np.float32)
    mu = np.array([0.25, -0.5, 1.5], np.float32)
    np.testing.assert_array_equal(
        tg.quantize_symbols(torch.from_numpy(sym), torch.from_numpy(mu)).numpy(),
        np.asarray(JGC.quantize_symbols(sym, mu)))
    np.testing.assert_array_equal(
        tg.dequantize(torch.tensor([1, -2, 0]), torch.from_numpy(mu)).numpy(),
        np.asarray(JGC.dequantize(jnp.array([1, -2, 0]), mu)))


def test_bottleneck_tables_equal_jax_for_a_loaded_tree(pipe, jax_params):
    """A JAX tree with trained-looking quantiles and density, loaded with
    load_jax_params, gives the JAX package's tables.  Row lengths, offsets
    and medians are exact.  The fp32 pmf passes through exp/tanh/sigmoid,
    which the two frameworks' CPU libraries round an ulp apart, so a pmf
    value within that noise of a rounding boundary of pmf * 2^16 can land
    one unit over, and the renormalisation's floor(2^16 * cdf / total) then
    moves neighbouring steps by one more and the tail bin by the rest: every
    frequency but the tail's stays within 2 of JAX's, and most rows are
    identical."""
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(np.array, jax_params["mask_codec"])
    eb = tree["prior"]["entropy_bottleneck"]
    med = rng.randn(192).astype(np.float32) * 0.7
    spread = rng.uniform(3, 30, 192).astype(np.float32)
    eb["quantiles"] = np.stack([med - spread, med, med + spread * 0.8],
                               -1).reshape(192, 1, 3).astype(np.float32)
    for k in list(eb):
        if k != "quantiles":
            eb[k] = (eb[k] + rng.randn(*eb[k].shape) * 0.3).astype(np.float32)
    port = MaskCodec(policy=DEFAULT_POLICY, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    load_jax_params(port, tree, "mask")
    got = port.entropy_bottleneck.cdf_tables()
    want = JEB(192).cdf_tables(eb)
    for k in ("cdf_lengths", "offsets", "medians", "pmf_length"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    g = got["quantized_cdfs"].astype(np.int64)
    w = np.asarray(want["quantized_cdfs"]).astype(np.int64)
    assert (g == w).all(axis=1).mean() >= 0.9
    for r, ln in enumerate(got["cdf_lengths"]):
        assert g[r, 0] == 0 and g[r, ln - 1] == 1 << 16
        fg, fw = np.diff(g[r, :ln]), np.diff(w[r, :ln])
        assert (fg > 0).all()
        assert np.abs(fg[:-1] - fw[:-1]).max() <= 2, r


# -------------------------------------------------------------- container


def _sections():
    rgb = {"strings": [b"\x01\x02\x03", b"\x04\x05"], "shape": (8, 12)}
    mask = {"strings": [b"\xaa" * 10, b"\xbb"], "shape": (3, 4)}
    gate = np.random.RandomState(4).rand(64, 96, 1) > 0.3
    lanes = {"format": "lanes32", "lanes": 16, "stream": b"\x07" * 40,
             "shape": (8, 12)}
    mlanes = dict(lanes, stream=b"\x09" * 12, shape=(3, 4))
    return {"v1": (rgb, mask, None), "v1_opaque": (rgb, None, None),
            "v1_crop": (rgb, mask, (512, 768, 128, 320)),
            "v2": (dict(rgb, gate=gate), mask, None),
            "v2_crop": (dict(rgb, gate=gate), None, (600, 800, 3, 5)),
            "v3": (lanes, mlanes, None), "v3_crop": (lanes, None, (9, 9, 1, 1))}


@pytest.mark.parametrize("case", list(_sections()))
def test_container_bytes_equal_jax(case):
    rgb, mask, crop = _sections()[case]
    blob = tcontainer.pack_rgba(512, 768, rgb, mask, crop)
    assert blob == jcontainer.pack_rgba(512, 768, rgb, mask, crop)
    got, want = tcontainer.unpack_rgba(blob), jcontainer.unpack_rgba(blob)
    gate_t = got["rgb"].pop("gate", None)
    gate_j = want["rgb"].pop("gate", None)
    np.testing.assert_array_equal(gate_t, gate_j)
    assert got == want
    for cut in (3, 20, len(blob) - 1):
        with pytest.raises(ValueError):
            tcontainer.unpack_rgba(blob[:cut])


# ---------------------------------------------------------------- CodecIO


def _jax_symbols(kind, params, data):
    """The JAX codec's device pass: (y symbols (S, B, H, W, sw), z symbols)."""
    if kind == "rgb":
        jio = JCodecIO(JRGBCodec(), params, kind="rgb")
        a = jnp.asarray(data["alpha"])
        me = j_pyramid(a)
        out = jio._compress_fn(jio._fp.flat, jnp.asarray(data["masked_image"]),
                               a, me[1], me[2])
    else:
        jio = JCodecIO(JMaskCodec(), params, kind="mask")
        out = jio._compress_fn(jio._fp.flat, jnp.asarray(data["alpha"]))
    return np.asarray(out[0]).astype(np.int32), np.asarray(out[2]).astype(np.int32)


@pytest.mark.parametrize("kind,hw", [("mask", (64, 64)), ("rgb", (64, 128))])
def test_codec_symbols_match_jax_compress(pipe, ios, jax_params, kind, hw):
    d = synthetic_rgba_batch(2, *hw, seed=8)
    io = ios[0] if kind == "rgb" else ios[1]
    if kind == "rgb":
        y, _, z = io._compress_device(nchw(d["masked_image"]), nchw(d["alpha"]))
    else:
        y, _, z = io._compress_device(nchw(d["alpha"]))
    jy, jz = _jax_symbols(kind, jax_params[f"{kind}_codec"], d)
    np.testing.assert_array_equal(z, jz)
    assert y.shape == jy.shape
    assert (y == jy).mean() >= Y_AGREEMENT
    assert np.abs(y).max() > 0          # the latents span several bins


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_mask_codec_round_trip_equals_the_forward(pipe, ios, hw):
    a = synthetic_rgba_batch(1, *hw, seed=9)["alpha"]
    io = ios[1]
    comp = io.compress(mask=a)
    assert len(comp["strings"][0]) > 0 and len(comp["strings"][1]) > 0
    assert comp["shape"] == (hw[0] // 64, hw[1] // 64)
    recon = io.decompress(comp)
    with torch.inference_mode():
        fwd = pipe.mask_codec(nchw(a))
    want = np.clip(fwd["x_hat"].permute(0, 2, 3, 1).numpy(), 0, 1)
    np.testing.assert_allclose(recon, want, atol=ROUND_TRIP_TOL)
    # the stream's size is close to the forward's rate estimate
    bits = 8 * sum(map(len, comp["strings"]))
    assert bits < float(fwd["bpp"]) * hw[0] * hw[1] * 1.5 + 512


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_rgb_codec_round_trip_equals_the_forward(pipe, ios, hw):
    d = synthetic_rgba_batch(1, *hw, seed=10)
    x, a = d["masked_image"], d["alpha"]
    io = ios[0]
    comp = io.compress(image=x, mask=a)
    recon = io.decompress(comp, mask=a)
    assert recon.shape == (1, *hw, 3)
    with torch.inference_mode():
        ta = nchw(a)
        fwd = pipe.rgb_codec(nchw(x), ta, ta, mask_pyramid(ta))
    want = np.clip(fwd["x_hat"].permute(0, 2, 3, 1).numpy(), 0, 1)
    np.testing.assert_allclose(recon, want, atol=ROUND_TRIP_TOL)
    assert 0.05 < float(recon.mean()) < 0.95


def test_tail_parallel_decode_equals_the_serial_chain(ios):
    d = synthetic_rgba_batch(2, 64, 128, seed=11)
    io = ios[0]
    comp = io.compress_batch(image=d["masked_image"], mask=d["alpha"])
    a, ya = io.decompress_batch_with_latent(comp, mask=d["alpha"],
                                            tail_parallel=True)
    b, yb = io.decompress_batch_with_latent(comp, mask=d["alpha"],
                                            tail_parallel=False)
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(a, b)
    # and the batch decodes each stream as its own batch-1 encode would
    one = io.compress(image=d["masked_image"][1:], mask=d["alpha"][1:])
    assert one["strings"] == comp[1]["strings"]


def test_decode_chain_frees_its_decoders_when_a_sibling_fails(ios):
    from rgba_tpu_torch.eval.codec_io import drive_chains
    d = synthetic_rgba_batch(1, 64, 64, seed=12)
    comp = ios[1].compress(mask=d["alpha"])
    bad = dict(comp, shape=(2, 2))
    with pytest.raises(ValueError, match="same-shaped"):
        drive_chains([ios[1].decompress_chain([comp]),
                      ios[1].decompress_chain([comp, bad])])


# ---------------------------------------------------------- RGBAFileCodec


def test_rgba_file_codec_round_trip_bbox(ios):
    """One opaque and one transparent-bordered image, 8-bit in and out,
    bbox crop on; odd sizes exercise the /64 padding."""
    codec = RGBAFileCodec(*ios)
    rng = np.random.RandomState(13)
    img = (rng.rand(1, 70, 90, 3) * 255).astype(np.uint8)
    opaque = np.full((1, 70, 90, 1), 255, np.uint8)
    blob = codec.encode(img, opaque, bbox=True)
    meta = tcontainer.unpack_rgba(blob)
    assert meta["mask"] is None and meta["crop"] is None
    out = codec.decode(blob, output="uint8")
    assert out.shape == (1, 70, 90, 4) and out.dtype == np.uint8
    assert (out[..., 3] == 255).all()
    assert codec.decode(blob).dtype == np.float32

    alpha = np.zeros((1, 90, 110, 1), np.uint8)
    alpha[:, 10:60, 20:90] = (rng.rand(50, 70, 1) * 255).astype(np.uint8)
    alpha[:, 20:50, 30:80] = 255
    img2 = (rng.rand(1, 90, 110, 3) * 255).astype(np.uint8)
    blob2 = codec.encode(img2, alpha, bbox=True)
    assert blob2 == codec.encode(img2, alpha, bbox=True)
    meta2 = tcontainer.unpack_rgba(blob2)
    assert meta2["crop"] == (90, 110, 10, 20) and meta2["mask"] is not None
    out2 = codec.decode(blob2, output="uint8")
    assert out2.shape == (1, 90, 110, 4)
    assert not out2[:, :10].any() and not out2[:, 60:].any()
    assert not out2[:, :, :20].any() and not out2[:, :, 90:].any()
    # the alpha is the mask stream's decode, 8-bit and cleaned, as encoded
    from rgba_tpu_torch.ops.morphology import constraint_rgb
    rm = torch.from_numpy(ios[1].decompress(meta2["mask"]))
    rm = constraint_rgb(torch.round(rm.clamp(0, 1) * 255).permute(0, 3, 1, 2)
                        / 255).permute(0, 2, 3, 1).numpy()
    want = np.round(rm[0, :50, :70, 0] * 255).astype(np.uint8)
    np.testing.assert_array_equal(out2[0, 10:60, 20:90, 3], want)
    f2 = codec.decode(blob2)
    np.testing.assert_array_equal(np.round(f2 * 255).astype(np.uint8), out2)


def test_codec_io_needs_a_known_kind(pipe):
    with pytest.raises(ValueError, match="kind"):
        CodecIO(pipe.rgb_codec, "alpha")


def test_fused_flags_do_not_change_the_cpu_stream(pipe, ios):
    """On the CPU the kernel flags route through the plain versions of the
    same arithmetic: the mask stream stays decodable by the unflagged
    codec and the decoded alpha moves by float noise only."""
    a = synthetic_rgba_batch(1, 64, 64, seed=14)["alpha"]
    comp = ios[1].compress(mask=a)
    flagged = dataclasses.replace(DEFAULT_POLICY, fused_gate_chain=True,
                                  fused_dse=True, fused_gdn=True)
    saved = pipe.mask_codec.policy
    try:
        for m in pipe.mask_codec.modules():
            if hasattr(m, "policy"):
                m.policy = flagged
        io = CodecIO(pipe.mask_codec, "mask")
        got = io.decompress(comp)
        io.close()
    finally:
        for m in pipe.mask_codec.modules():
            if hasattr(m, "policy"):
                m.policy = saved
    np.testing.assert_allclose(got, ios[1].decompress(comp), atol=1e-4)
