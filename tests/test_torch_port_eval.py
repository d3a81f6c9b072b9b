"""The port's Kodak evaluation against the JAX package's on the CPU, fp32,
on the same weights: ``make_eval_step`` on one image, and
``evaluate_kodak`` over a 2-image synthetic Kodak tree with the estimated
rates, with the real bitstream and with the curriculum branch.

The weights are the port's, seeded and made live (bias noise, DSE output
biases at 0.5, gain 10 on both encoders' last 1x1 conv, as in
tests/test_torch_port_models.py); they reach the JAX modules through the
JAX package's importer and come back into fresh port modules through
``weights.load_jax_params``.

Tolerances (ROADMAP): x_hat 2e-4, MS-SSIM 1e-5, the decoded alpha in the
same 8-bit levels; averages: PSNR 1e-3 dB, psnr_real 1e-3 dB, codec_err <=
1e-5 on each side.  The rates are held to 2e-5 relative, not 1e-5: each
is an fp32 sum of some 2e4 log-likelihoods, which XLA and torch take in
different orders (measured: 5.7e-6 for one 64x128 image, 1.14e-5 for
the tree's average).  The real bpp comes from the
stream bytes, which the two packages write apart in two places
(tests/test_torch_port_codec.py): a y latent within fp32 noise of a half
integer may round the other way (the y symbols agree to >= 99.9%), and the
z CDF rows differ by an ulp in 1 to 4 rows in 100 (ROADMAP queue 3), which
moves a z stream by a few bytes.  So real_bpp is held to 64 bytes per
image, 0.0625 bpp at 64x128 (under 1% of it).
"""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.eval import kodak as jkodak  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data import png  # noqa: E402
from rgba_tpu_torch.data.synthetic import (synthetic_rgba_batch,  # noqa: E402
                                           write_synthetic_kodak_tree)
from rgba_tpu_torch.eval import kodak  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import RGBCodec  # noqa: E402
from rgba_tpu_torch.weights import load_jax_params  # noqa: E402

from torch_port_util import KEY, close, torch_sd  # noqa: E402

torch.set_num_threads(2)

XHAT_TOL = 2e-4
RATE_RTOL = 2e-5
MSSSIM_TOL = 1e-5
PSNR_DB = 1e-3
CODEC_ERR = 1e-5
REAL_BYTES = 64          # per image: y rounding ties and the z-CDF ulp


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
def models():
    """(port RGBCodec, port MaskCodec, JAX RGBCodec, JAX MaskCodec, JAX
    params {rgb_codec, mask_codec}) on the same weights."""
    src = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _perturb(src, 1)
    x = np.zeros((1, 64, 64, 3), np.float32)
    m = np.zeros((1, 64, 64, 1), np.float32)
    tmpl = jax.eval_shape(lambda: JPipeline().init(
        {"params": KEY, "noise": KEY}, x, m, training=False))["params"]
    sd = torch_sd(src)
    params = {
        s: convert_state_dict({k[len(s) + 1:]: v for k, v in sd.items()
                               if k.startswith(s + ".")}, tmpl[s], kind=kind)
        for s, kind in (("mask_codec", "mask"), ("rgb_codec", "rgb"))}
    gen = torch.Generator().manual_seed(9)
    rgb = RGBCodec(policy=DEFAULT_POLICY, device="cpu", generator=gen)
    mask = MaskCodec(policy=DEFAULT_POLICY, device="cpu", generator=gen)
    load_jax_params(rgb, params["rgb_codec"], "rgb")
    load_jax_params(mask, params["mask_codec"], "mask")
    return rgb, mask, JRGBCodec(), JMaskCodec(), params


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kodak"))
    write_synthetic_kodak_tree(root, n_images=2, height=64, width=128, seed=3)
    return root


@pytest.fixture(scope="module")
def jax_avg(models, tree):
    _, _, jrgb, jmask, params = models
    return jkodak.evaluate_kodak(jrgb, params["rgb_codec"], jmask,
                                 params["mask_codec"], tree)


def _steps(models, hw):
    rgb, mask, jrgb, jmask, params = models
    d = synthetic_rgba_batch(1, *hw, seed=4)
    got = kodak.make_eval_step(rgb, mask)(d["masked_image"], d["alpha"])
    want = jkodak.make_eval_step(jrgb, jmask)(
        params["rgb_codec"], params["mask_codec"], d["masked_image"],
        d["alpha"])
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_eval_step_matches_jax(models):
    got, want = _steps(models, (64, 128))
    assert got["x_hat"].shape == (1, 64, 128, 3)
    assert 0.05 < got["x_hat"].mean() < 0.95
    close(got["x_hat"], want["x_hat"], XHAT_TOL)
    # the same 8-bit levels; XLA divides by 255 as a product with the
    # reciprocal, so the float values may sit an ulp apart
    np.testing.assert_array_equal(np.round(got["recon_mask"] * 255),
                                  np.round(want["recon_mask"] * 255))
    close(got["recon_mask"], want["recon_mask"], 1e-7)
    assert 0.0 < got["recon_mask"].mean() < 1.0
    for k in ("bpp", "bpp_rgb", "bpp_mask"):
        close(got[k], want[k], 0.0, RATE_RTOL, k)
    close(got["mse"], want["mse"], 0.0, 1e-4, "mse")
    # MS-SSIM's five scales need more than 160 pixels a side
    assert np.isnan(got["msssim"]) and np.isnan(want["msssim"])


def test_eval_step_ms_ssim_matches_jax(models):
    """MS-SSIM where it is defined.  At 192x192 one mask latent of slice 2
    lies within fp32 noise of a half integer and rounds the other way in
    the two frameworks, and the channel-AR chain carries that to later
    slices (the decoded alpha moves by up to 6 levels on 2.4% of the
    pixels, the mask rate by 3e-5): the alpha and the rates are held at
    64x128 above.  The RGB codec, gated by the GT alpha's pyramid in its
    encoder, keeps x_hat within the tolerance."""
    got, want = _steps(models, (192, 192))
    close(got["x_hat"], want["x_hat"], XHAT_TOL)
    assert 0 < got["msssim"] < 1
    close(got["msssim"], want["msssim"], MSSSIM_TOL, what="msssim")


def test_evaluate_kodak_gives_the_jax_averages(models, tree, jax_avg,
                                               tmp_path):
    rgb, mask = models[:2]
    out = str(tmp_path / "out")
    avg = kodak.evaluate_kodak(rgb, mask, tree, output_dir=out)
    assert set(avg) == set(jax_avg)
    assert abs(avg["psnr"] - jax_avg["psnr"]) <= PSNR_DB
    close(avg["bpp"], jax_avg["bpp"], 0.0, RATE_RTOL, "bpp")
    assert np.isnan(avg["msssim"]) == np.isnan(jax_avg["msssim"])
    px, mode = png.read_png(os.path.join(out, "1img.png"))
    assert mode == "RGBA" and px.shape == (64, 128, 4)


def test_evaluate_kodak_real_codec_gives_the_jax_averages(models, tree):
    rgb, mask, jrgb, jmask, params = models
    avg = kodak.evaluate_kodak(rgb, mask, tree, real_codec=True)
    want = jkodak.evaluate_kodak(jrgb, params["rgb_codec"], jmask,
                                 params["mask_codec"], tree, real_codec=True)
    assert avg["codec_err"] <= CODEC_ERR and want["codec_err"] <= CODEC_ERR
    assert abs(avg["psnr_real"] - want["psnr_real"]) <= PSNR_DB
    assert abs(avg["psnr"] - want["psnr"]) <= PSNR_DB
    assert abs(avg["real_bpp"] - want["real_bpp"]) <= REAL_BYTES * 8 / (64 * 128)
    assert 0.5 * avg["bpp"] < avg["real_bpp"] < 1.5 * avg["bpp"] + 0.1
    assert avg["codec_time"] > 0


def test_a_supplied_codec_is_re_pointed_at_the_models(models, tree):
    """``codec=`` reuse: a codec built on other weights codes with the
    models' weights after ``set_params``."""
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    rgb, mask = models[:2]
    gen = torch.Generator().manual_seed(21)
    other = RGBAFileCodec(
        CodecIO(RGBCodec(policy=DEFAULT_POLICY, device="cpu", generator=gen),
                "rgb"),
        CodecIO(MaskCodec(policy=DEFAULT_POLICY, device="cpu", generator=gen),
                "mask"))
    try:
        a = kodak.evaluate_kodak(rgb, mask, tree, real_codec=True,
                                 codec=other)
        b = kodak.evaluate_kodak(rgb, mask, tree, real_codec=True)
    finally:
        other.rgb_io.close()
        other.mask_io.close()
    for k in ("real_bpp", "psnr_real", "codec_err", "bpp", "psnr"):
        assert a[k] == b[k], k


def test_the_curriculum_branch(models, tree, tmp_path):
    """The full unmasked image against an all-ones mask: equal to the plain
    branch on the same images made opaque, an RGB PNG, the JAX averages;
    with real_codec it raises, as in JAX."""
    rgb, mask, jrgb, jmask, params = models
    opaque = str(tmp_path / "opaque")
    shutil.copytree(tree, opaque)
    for f in os.listdir(os.path.join(opaque, "MaskImages")):
        p = os.path.join(opaque, "MaskImages", f)
        png.write_png(p, np.full((64, 128), 255, np.uint8))
    out = str(tmp_path / "out")
    a = kodak.evaluate_kodak(rgb, mask, tree, output_dir=out, curriculum=True)
    b = kodak.evaluate_kodak(rgb, mask, opaque)
    for k in ("bpp", "psnr"):
        assert a[k] == pytest.approx(b[k], abs=1e-9), k
    assert png.read_png(os.path.join(out, "1img.png"))[1] == "RGB"
    want = jkodak.evaluate_kodak(jrgb, params["rgb_codec"], jmask,
                                 params["mask_codec"], tree, curriculum=True)
    assert abs(a["psnr"] - want["psnr"]) <= PSNR_DB
    close(a["bpp"], want["bpp"], 0.0, RATE_RTOL, "bpp")
    with pytest.raises(ValueError, match="curriculum"):
        kodak.evaluate_kodak(rgb, mask, tree, curriculum=True,
                             real_codec=True)
