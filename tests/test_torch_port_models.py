"""Models of the PyTorch port against the JAX package on the CPU, fp32, on
the same weights: ChannelARPrior, MaskCodec, RGBCodec, and the whole
RGBAPipeline at 64x64 and 64x128.

The port draws its weights from a seed; they reach the JAX modules through
the JAX package's own importer (convert_state_dict).  Random init leaves
the latents within one quantization bin and x_hat below 0, so first every
bias is perturbed, the DSE output biases go to 0.5 and both encoders' last
1x1 conv gets a gain of 10: latents span several bins and the clipped
outputs are not constant.

Tolerances: 2e-4 for x_hat, 1e-4 for the decoded alpha.  The bpp values
are held to 1e-4 relative, not 1e-5: un-jitted JAX sums the fp32 bits of
~2e4 symbols one after another, 4.4e-5 off a float64 sum of the same
likelihoods at 64x128, where torch's pairwise sum is 1e-7 off.  A rate
near zero (every likelihood close to 1) gets 1e-8 absolute.
A round() of a latent that lies within fp32 noise of a half integer could
flip between the frameworks; at these seeds none does.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.models.hyperprior import ChannelARPrior as JPrior  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.ops.mask_pyramid import mask_pyramid as j_pyramid  # noqa: E402
from rgba_tpu.train.torch_import import _prior_map, convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.models.hyperprior import ChannelARPrior  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import reconstruct_error  # noqa: E402
from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid  # noqa: E402

from torch_port_util import (KEY, close, jax_params_from_torch, nchw,  # noqa: E402
                             nhwc, torch_sd)

torch.set_num_threads(2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


XHAT_TOL = 2e-4
MASK_TOL = 1e-4
BPP_RTOL = 1e-4
BPP_ATOL = 1e-8


def _perturb(pipe, seed):
    """Seeded bias noise, DSE output biases at 0.5, encoder gain 10."""
    g = _gen(seed)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
        pipe.mask_codec.EncoderMask[7].weight.mul_(10.0)


@pytest.fixture(scope="module")
def pipelines():
    tp = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _perturb(tp, 1)
    d = synthetic_rgba_batch(1, 64, 64, seed=0)
    jm = JPipeline()
    tmpl = jax.eval_shape(lambda: jm.init(
        {"params": KEY, "noise": KEY}, d["masked_image"], d["alpha"],
        training=False))["params"]
    sd = torch_sd(tp)
    params = {
        sub: convert_state_dict(
            {k[len(sub) + 1:]: v for k, v in sd.items()
             if k.startswith(sub + ".")}, tmpl[sub], kind=kind)
        for sub, kind in (("mask_codec", "mask"), ("rgb_codec", "rgb"))}
    return tp, jm, params


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_pipeline_matches_jax(pipelines, hw):
    tp, jm, params = pipelines
    d = synthetic_rgba_batch(2, *hw, seed=5)
    want = jm.apply({"params": params}, d["masked_image"], d["alpha"],
                    training=False)
    got = tp(d["masked_image"], d["alpha"])
    assert got["x_hat"].shape == (2, *hw, 3)
    assert 0.05 < float(got["x_hat"].mean()) < 0.95
    assert 0.0 < float(got["recon_mask"].mean()) < 1.0
    close(got["x_hat"].numpy(), np.asarray(want["x_hat"]), XHAT_TOL)
    close(got["recon_mask"].numpy(), np.asarray(want["recon_mask"]), MASK_TOL)
    for k in ("bpp", "bpp_rgb", "bpp_mask"):
        close(float(got[k]), float(want[k]), BPP_ATOL, BPP_RTOL, k)
    close(float(got["mse_loss"]), float(want["mse_loss"]), 0.0, 1e-4)


def test_opaque_alpha_drops_mask_bits(pipelines):
    tp = pipelines[0]
    d = synthetic_rgba_batch(1, 64, 64, seed=2, opaque=True)
    got = tp(d["masked_image"], d["alpha"])
    assert float(got["bpp"]) == float(got["bpp_rgb"])


@pytest.mark.parametrize("rate_gate", [False, True])
def test_rgb_codec_unclipped(pipelines, rate_gate):
    """The RGB codec's x_hat before the pipeline's clamp, gated by the GT
    alpha as the decoded one; with the alpha-rate gate on and off."""
    tp, _, params = pipelines
    d = synthetic_rgba_batch(2, 64, 64, seed=6)
    x, a = d["masked_image"], d["alpha"]
    jc = JRGBCodec(rate_gate=rate_gate)
    want = jc.apply({"params": params["rgb_codec"]}, x, a, a,
                    j_pyramid(a), training=False)
    tp.rgb_codec.rate_gate = rate_gate
    try:
        with torch.inference_mode():
            ta = nchw(a)
            got = tp.rgb_codec(nchw(x), ta, ta, mask_pyramid(ta))
    finally:
        tp.rgb_codec.rate_gate = False
    close(nhwc(got["x_hat"]), np.asarray(want["x_hat"]), XHAT_TOL)
    close(nhwc(got["y_hat"]), np.asarray(want["y_hat"]), XHAT_TOL)
    for k in ("bpp", "bpp_y", "bpp_z"):
        close(float(got[k]), float(want[k]), BPP_ATOL, BPP_RTOL, k)


def test_mask_codec_unclipped(pipelines):
    tp, _, params = pipelines
    a = synthetic_rgba_batch(2, 64, 128, seed=7)["alpha"]
    want = JMaskCodec().apply({"params": params["mask_codec"]}, a,
                              training=False)
    with torch.inference_mode():
        got = tp.mask_codec(nchw(a))
    close(nhwc(got["x_hat"]), np.asarray(want["x_hat"]), XHAT_TOL)
    for k in ("bpp", "bpp_y", "bpp_z"):
        close(float(got[k]), float(want[k]), BPP_ATOL, BPP_RTOL, k)
    close(float(got["mse_loss"]), float(want["mse_loss"]), 0.0, 1e-4)


@pytest.mark.parametrize("gated", [False, True])
def test_channel_ar_prior(gated):
    """The 5-slice head at its own width (M=40), with and without the
    alpha-rate gate."""
    rng = np.random.RandomState(8)
    y = (rng.randn(1, 8, 8, 40) * 3).astype(np.float32)
    gate = (rng.rand(1, 8, 8, 1) > 0.4).astype(np.float32) if gated else None
    tm = ChannelARPrior(40, 5, policy=DEFAULT_POLICY, device="cpu",
                        generator=_gen(3))
    jm = JPrior(latent_channels=40, num_slices=5)
    tmpl = jm.init({"params": KEY, "noise": KEY}, y)["params"]
    params = jax_params_from_torch(tm, tmpl, _prior_map)
    want = jm.apply({"params": params}, y, gate=gate)
    with torch.inference_mode():
        got = tm(nchw(y), None if gate is None else nchw(gate))
    for k in ("y_hat", "means", "scales"):
        close(nhwc(got[k]), np.asarray(want[k]), 1e-4, 0.0, k)
    for k in ("y_likelihoods", "z_likelihoods"):
        close(nhwc(got[k]), np.asarray(want[k]), 1e-6, 1e-4, k)


def test_reconstruct_error():
    from rgba_tpu.models.rgb_codec import reconstruct_error as j_err
    rng = np.random.RandomState(9)
    x = rng.rand(2, 8, 8, 3).astype(np.float32)
    xh = rng.rand(2, 8, 8, 3).astype(np.float32)
    m = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    m[1] = 0.0      # an empty mask divides by max(count, 1)
    close(float(reconstruct_error(nchw(x), nchw(xh), nchw(m))),
          float(j_err(x, xh, m)), 0.0, 1e-6)
