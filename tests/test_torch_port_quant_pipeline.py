"""The joint RGBA forward (``RGBAPipeline``) of the PyTorch port under
``serve-int8`` against the JAX package's ``SERVE_INT8_POLICY`` on the CPU,
on the same weights.

Both packages run bf16 with every convolution as the dynamic W8A8
convolution (exact int32 sums, the same scales).  The window attention
runs its plain formulation on both sides: the port's kernel wrapper takes
its plain version on CPU tensors, and the JAX side runs SERVE_INT8_POLICY
with ``fused_win_attn`` off, the Pallas kernel's plain reference (the
kernel in interpret mode is held to it in ``tests/test_pallas_attn.py``;
inside the jitted forward it would add 6 s).  The JAX forward is jitted
(eager takes 80 s).  GDN, attention and the entropy math stay in float.  Batch 2: the DSE is the
plain chain in both (the packed DSE is held to it bit for bit in
``test_torch_port_quant.py``).

Tolerances.  x_hat: the bf16 gate of the port's bf16 forward checks,
2^-5 * max(1, max|ref|).  The decoded alpha and the rates: a bf16 value a
hair apart moves a tensor's max and with it every int8 level of that
tensor, and a latent near a half integer then rounds the other way, so
these move as much between the JAX package's own jitted and eager
forwards of the same inputs (at these seeds: alpha mean |d| 0.0090, bpp
1.7e-3, RGB bpp 2.7e-3, mask bpp 1.1e-3 relative) as between the
packages.  They are held to about twice that gap: the alpha's mean |d|
<= 2^-6, each bpp within 5e-3 relative.  Every convolution's int32 sums
are held exactly in ``test_torch_port_quant.py``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.core.precision import SERVE_INT8_POLICY as J_SERVE_INT8  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import SERVE_INT8_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402

from torch_port_util import KEY, torch_sd  # noqa: E402

torch.set_num_threads(2)

BF16_TOL = 2.0 ** -5
ALPHA_MEAN_TOL = 2.0 ** -6
BPP_RTOL = 5e-3


def _perturb(pipe, seed):
    """Seeded bias noise, DSE output biases at 0.5, encoder gain 10, as the
    fp32 pipeline test does: latents span several bins, x_hat is not
    constant."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
        pipe.mask_codec.EncoderMask[7].weight.mul_(10.0)


def test_serve_int8_pipeline_matches_jax():
    tp = RGBAPipeline(SERVE_INT8_POLICY, device="cpu", seed=0)
    _perturb(tp, 1)
    d = synthetic_rgba_batch(2, 64, 64, seed=5)
    jm = JPipeline(policy=dataclasses.replace(J_SERVE_INT8,
                                              fused_win_attn=False))
    tmpl = jax.eval_shape(lambda: jm.init(
        {"params": KEY, "noise": KEY}, d["masked_image"][:1], d["alpha"][:1],
        training=False))["params"]
    sd = torch_sd(tp)
    params = {
        sub: convert_state_dict(
            {k[len(sub) + 1:]: v for k, v in sd.items()
             if k.startswith(sub + ".")}, tmpl[sub], kind=kind)
        for sub, kind in (("mask_codec", "mask"), ("rgb_codec", "rgb"))}
    want = jax.jit(lambda p, x, a: jm.apply({"params": p}, x, a,
                                            training=False))(
        params, d["masked_image"], d["alpha"])
    got = tp(d["masked_image"], d["alpha"])
    x, wx = got["x_hat"].float().numpy(), np.asarray(want["x_hat"], np.float32)
    assert x.shape == wx.shape == (2, 64, 64, 3)
    assert np.isfinite(x).all()
    assert 0.05 < float(x.mean()) < 0.95
    tol = BF16_TOL * max(1.0, float(np.abs(wx).max()))
    assert float(np.abs(x - wx).max()) <= tol
    m = got["recon_mask"].float().numpy()
    wm = np.asarray(want["recon_mask"], np.float32)
    assert m.shape == wm.shape and np.isfinite(m).all()
    assert float(np.abs(m - wm).mean()) <= ALPHA_MEAN_TOL
    for key in ("bpp", "bpp_rgb", "bpp_mask"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=BPP_RTOL, err_msg=key)
