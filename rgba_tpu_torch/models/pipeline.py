"""Joint RGBA eval pipeline: mask codec -> cleanup -> RGB codec (port of
``rgba_tpu/models/pipeline.py``).  This is the serving entry point.

  1. pyramid of the GT alpha for the RGB encoder;
  2. mask codec forward, clamp to [0, 1], 8-bit round, ``constraint_rgb``;
  3. RGB codec forward gated by the decoded alpha, clamp;
  4. bpp = bpp_rgb (+ bpp_mask unless the alpha is fully opaque).

Public tensors are NHWC, as in the JAX package; inside, NCHW tensors are
kept in channels_last memory, so the kernels read NHWC rows without a copy.

Height sharding: inside ``parallel.spatial.space_scope(mesh)`` every rank
of a space group passes its band of the same images (``mesh.band_slice``)
and gets back its band of x_hat and recon_mask, and the whole images'
rates and losses.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import DEFAULT_POLICY, Policy, precision_scope, resolve_device
from ..ops.mask_pyramid import mask_pyramid
from ..ops.morphology import constraint_rgb
from ..parallel import spatial
from .mask_codec import MaskCodec
from .rgb_codec import RGBCodec


class RGBAPipeline(nn.Module):
    """Both codecs under one module: ``mask_codec.*`` and ``rgb_codec.*``.

    Weights are drawn from ``seed`` with the JAX package's distributions;
    load trained weights with ``rgba_tpu_torch.weights.load_jax_params``.
    ``device`` defaults to ``cuda`` and raises without CUDA unless the
    caller passes ``"cpu"``.
    """

    def __init__(self, policy: Policy = DEFAULT_POLICY, device=None,
                 seed: int = 0, rate_gate: bool = False):
        super().__init__()
        self.device = resolve_device(device)
        self.policy = policy
        g = torch.Generator().manual_seed(seed)
        kw = dict(policy=policy, device=self.device, generator=g)
        self.mask_codec = MaskCodec(**kw)
        self.rgb_codec = RGBCodec(rate_gate=rate_gate, **kw)
        self.eval()

    def forward(self, masked_input, mask):
        """masked_input: (B, H, W, 3); mask: (B, H, W, 1) alpha in [0, 1];
        H and W multiples of 64 (bands of H under height sharding, see the
        module docstring).  Returns NHWC x_hat / recon_mask and the scalar
        rates and losses."""
        spatial.check_band(masked_input.shape[1])
        with torch.inference_mode(), precision_scope(self.policy):
            x = torch.as_tensor(masked_input, dtype=torch.float32,
                                device=self.device).permute(0, 3, 1, 2)
            a = torch.as_tensor(mask, dtype=torch.float32,
                                device=self.device).permute(0, 3, 1, 2)
            me_pyr = mask_pyramid(a)
            m = self.mask_codec(a)
            recon = torch.round(torch.clamp(m["x_hat"], 0.0, 1.0) * 255.0) / 255.0
            recon = constraint_rgb(recon)
            r = self.rgb_codec(x, a, recon, me_pyr)
            opaque = spatial.space_sum((a != 1.0).sum()) == 0
            bpp = r["bpp"] + torch.where(opaque, torch.zeros_like(m["bpp"]),
                                         m["bpp"])
            return {
                "x_hat": torch.clamp(r["x_hat"], 0.0, 1.0)
                .permute(0, 2, 3, 1).contiguous(),
                "recon_mask": recon.permute(0, 2, 3, 1).contiguous(),
                "mse_loss": r["mse_loss"],
                "bpp": bpp,
                "bpp_rgb": r["bpp"],
                "bpp_mask": m["bpp"],
                "mse_mask": m["mse_loss"],
            }
