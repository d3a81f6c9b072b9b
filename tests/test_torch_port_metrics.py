"""Metrics of the PyTorch port against the JAX package on the CPU: psnr,
ssim, ms_ssim (with the reference's final-composition quirk) and
masked_ms_ssim, on seeded numpy images at 256x256, the smallest size whose
five levels fit the 11-tap window.  Tolerance 1e-5 absolute on values in
[0, 1] (fp32 blurs summed in another order); psnr 1e-4 dB.  The training
loss needs them differentiable: the gradient of 1 - masked_ms_ssim is held
to jax.grad (1e-4 * max|g|: a five-level product of blurred ratios, each
fp32 sum in another order) and must be finite.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import importlib  # noqa: E402

# the JAX package's metrics/__init__ exports functions of the same names
jm = importlib.import_module("rgba_tpu.metrics.ms_ssim")
jp = importlib.import_module("rgba_tpu.metrics.psnr")

from rgba_tpu_torch.core.config import TrainConfig  # noqa: E402
from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.metrics import ms_ssim as tm  # noqa: E402
from rgba_tpu_torch.metrics import psnr as tp  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import RGBCodec  # noqa: E402
from rgba_tpu_torch.train.loops import _rgb_loss_fn  # noqa: E402

from torch_port_util import close  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5


def _pair(seed, b=2, hw=(256, 256)):
    """A synthetic RGBA batch and a smoothly distorted copy of its image."""
    d = synthetic_rgba_batch(b, *hw, seed=seed)
    rng = np.random.RandomState(seed)
    y = np.clip(d["masked_image"] * 0.9 + 0.05
                + 0.05 * rng.randn(*d["masked_image"].shape), 0, 1)
    return d["masked_image"], y.astype(np.float32), d["alpha"]


def _t(a):
    return torch.from_numpy(a)


def test_psnr():
    x, y, _ = _pair(0, hw=(64, 64))
    close(float(tp.psnr(_t(x), _t(y))), float(jp.psnr(x, y)), 1e-4)
    close(float(tp.psnr_from_mse(0.0)), float(jp.psnr_from_mse(0.0)), 1e-4)
    close(float(tp.psnr_from_mse(2.5e-3, 255.0)),
          float(jp.psnr_from_mse(2.5e-3, 255.0)), 1e-4)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim(size_average):
    x, y, _ = _pair(1, hw=(64, 96))
    close(tm.ssim(_t(x), _t(y), size_average=size_average).numpy(),
          np.asarray(jm.ssim(x, y, size_average=size_average)), TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_ms_ssim(size_average):
    x, y, _ = _pair(2)
    got = tm.ms_ssim(_t(x), _t(y), size_average=size_average)
    close(got.numpy(),
          np.asarray(jm.ms_ssim(x, y, size_average=size_average)), TOL)
    assert 0.0 < float(got.min()) < 1.0


def test_ms_ssim_odd_sizes_pad_the_pool():
    """176 -> 88 -> 44 -> 22 -> 11 and 203 -> 102 -> 51 -> 26 -> 13: odd
    sizes take the padded 2x2 pool."""
    x, y, _ = _pair(3, b=1, hw=(192, 256))
    x, y = x[:, :176, :203], y[:, :176, :203]
    close(tm.ms_ssim(_t(x), _t(y)).numpy(), np.asarray(jm.ms_ssim(x, y)), TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_masked_ms_ssim(size_average):
    x, y, a = _pair(4)
    got = tm.masked_ms_ssim(_t(x), _t(y), _t(a), size_average=size_average)
    want = jm.masked_ms_ssim(x, y, a, size_average=size_average)
    close(got.numpy(), np.asarray(want), TOL)
    assert 0.0 < float(got.min()) < 1.0
    # an all-ones mask: the masked mean is the plain mean, the composition
    # is the masked variant's own
    ones = np.ones_like(a)
    close(tm.masked_ms_ssim(_t(x), _t(y), _t(ones)).numpy(),
          np.asarray(jm.masked_ms_ssim(x, y, ones)), TOL)


def test_masked_ms_ssim_gradient():
    x, y, a = _pair(5, b=1)
    want = jax.grad(lambda v: 1.0 - jm.masked_ms_ssim(x, v, a))(y)
    ty = _t(y).requires_grad_(True)
    (1.0 - tm.masked_ms_ssim(_t(x), ty, _t(a))).backward()
    assert bool(torch.isfinite(ty.grad).all())
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0
    close(ty.grad.numpy(), np.asarray(want), 1e-4 * scale)


def test_rgb_loss_with_msssim_distortion():
    """distortion="msssim": rd = lambda * (1 - masked MS-SSIM) + bpp, with
    finite gradients on every parameter."""
    d = synthetic_rgba_batch(1, 256, 256, seed=6)
    cfg = TrainConfig(train_lambda=64, distortion="msssim")
    model = RGBCodec(policy=DEFAULT_POLICY, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    batch = {k: _t(d[k]).permute(0, 3, 1, 2) for k in ("masked_image", "alpha")}
    gen = torch.Generator().manual_seed(1)
    rd, metrics = _rgb_loss_fn(cfg)(model, batch, gen)
    rd.backward()
    rd, bpp, mse = (float(v.detach()) for v in (rd, metrics["bpp"],
                                                metrics["mse_loss"]))
    assert np.isfinite(rd)
    # 1 - msssim lies in [0, 1], and is not the mse
    assert bpp <= rd <= cfg.train_lambda + bpp
    assert rd != pytest.approx(cfg.train_lambda * mse + bpp)
    for name, p in model.named_parameters():
        if name != "entropy_bottleneck.quantiles":
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
