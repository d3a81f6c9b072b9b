"""Banded models of the PyTorch port on the CPU against the JAX package and
against the port unbanded: two gloo ranks (``space`` 2), started once for
the file (``parallel/launch.py``), run ``torch_port_spatial_util
.model_bands``; this process builds the same seeded modules and computes
the references.

Tolerances, those of ``tests/test_spatial_sharding.py`` for the JAX
modules: the banded ``WinGateAttention`` (C=32, 4 heads, window 8, shift
4, 32x32) against the JAX module unsharded, 2e-5; the banded ``MaskCodec``
at 128x128 (eval, at its random init, as that test runs it) against JAX,
x_hat 5e-4 and bpp 1e-4 relative.  With live weights (encoder gain 10)
the latents span many bins, and the port and JAX, whose y differ by fp32
noise, round a latent at a tie apart (the port's banded and unbanded
forwards do not): there the banded ``MaskCodec`` is held to the port
unbanded, x_hat by the bulk gate of ``chip_smoke.py`` (mean |d| <= 1e-4,
at most 1e-3 of the values off by more than 1e-3; a latent within fp32
noise of a rounding boundary may round the other way), every rate 1e-5
relative.  So is the banded ``RGBAPipeline`` (64x128, bands of 32 rows,
live weights), its recon mask within 1e-4.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.ops import attention as jatt  # noqa: E402
from rgba_tpu.train.torch_import import (_win_gate_map,  # noqa: E402
                                         convert_state_dict)

from rgba_tpu_torch.parallel.launch import run_ranks  # noqa: E402

import torch_port_spatial_util as u  # noqa: E402
from torch_port_util import KEY, close, jax_params_from_torch, nhwc, torch_sd  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
S = 2

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bands():
    env = dict(os.environ, PYTHONPATH=TESTS)
    return run_ranks("torch_port_spatial_util:model_bands", S, space=S,
                     device="cpu", env=env, timeout=300)


def _whole(parts):
    """The bands, in rank order, as the whole NCHW image (NHWC numpy)."""
    return np.concatenate([nhwc(p) for p in parts], axis=1)


def test_win_gate_banded_matches_jax(bands):
    g = u.WIN_GATE
    x, alpha = u.win_gate_inputs()
    tm = u.make_win_gate()
    jm = jatt.WinGateAttention(g["dim"], num_heads=g["heads"],
                               window_size=g["window"], shift_size=g["shift"])
    params = jax_params_from_torch(tm, jm.init(KEY, x, alpha)["params"],
                                   _win_gate_map)
    want = np.asarray(jm.apply({"params": params}, x, alpha))
    close(_whole([b["win_gate"] for b in bands]), want, 2e-5, 2e-5)


def test_mask_codec_banded_matches_jax(bands):
    m = u.make_mask_codec(live=False)
    a = u.mask_input()
    tmpl = jax.eval_shape(lambda: JMaskCodec().init(
        {"params": KEY, "noise": KEY}, a[:1], training=False))["params"]
    params = convert_state_dict(torch_sd(m), tmpl, kind="mask")
    want = JMaskCodec().apply({"params": params}, a, training=False)
    got = [b["mask_codec_init"] for b in bands]
    close(_whole([g["x_hat"] for g in got]), np.asarray(want["x_hat"]),
          5e-4, 5e-4)
    for g in got:       # the whole image's rates on every rank
        for k in ("bpp", "bpp_y", "bpp_z"):
            close(float(g[k]), float(want[k]), 0.0, 1e-4, k)
        close(float(g["mse_loss"]), float(want["mse_loss"]), 0.0, 1e-4)


def _bulk(got, want):
    d = (got - want).abs()
    assert float(d.mean()) <= 1e-4 and float((d > 1e-3).float().mean()) <= 1e-3


def test_live_mask_codec_banded_matches_unbanded(bands):
    m = u.make_mask_codec(live=True)
    with torch.inference_mode():
        want = m(u._nchw(u.mask_input()))
    got = [b["mask_codec_live"] for b in bands]
    _bulk(torch.cat([g["x_hat"] for g in got], dim=2), want["x_hat"])
    assert float(want["bpp"]) > 1.0       # latents over many bins
    for g in got:
        for k in ("bpp", "bpp_y", "bpp_z", "mse_loss"):
            close(float(g[k]), float(want[k]), 0.0, 1e-5, k)


def test_pipeline_banded_matches_unbanded(bands):
    p = u.make_pipeline()
    x, a = u.pipeline_inputs()
    want = p(x, a)
    got = [b["pipeline"] for b in bands]
    _bulk(torch.cat([g["x_hat"] for g in got], dim=1), want["x_hat"])
    assert 0.05 < float(want["x_hat"].mean()) < 0.95
    close(torch.cat([g["recon_mask"] for g in got], dim=1).numpy(),
          want["recon_mask"].numpy(), 1e-4)
    for g in got:
        for k in ("bpp", "bpp_rgb", "bpp_mask", "mse_loss", "mse_mask"):
            close(float(g[k]), float(want[k]), 0.0, 1e-5, k)
