"""RGB codec with alpha-masked window attention (port of
``rgba_tpu/models/rgb_codec.py``).

Analysis: conv5x5s2+GDN x2 -> WinGate(win 8, shift 4) at H/4 gated by me2
-> conv5x5s2+GDN -> 1x1 conv to M=80 -> WinGate(win 4, shift 2) at H/8 by
me3.  Synthesis mirrors it with IGDN/deconvs, gates md3/md2, DSE tail.
Entropy: hyperprior + 10-slice channel-AR head.  The decoded alpha is
re-rounded to 8 bits inside forward, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import Policy
from ..entropy.rate import bpp as bpp_of
from ..ops.attention import WinGateAttention
from ..ops.conv import Conv, ConvTranspose
from ..ops.enhance import DSE
from ..ops.gdn import GDN
from ..ops.mask_pyramid import mask_pyramid
from .hyperprior import ChannelARPrior

RGB_N = 192
RGB_M = 80


def reconstruct_error(x, x_hat, input_mask):
    """Masked MSE per visible value, averaged over the batch.
    x, x_hat: (B, 3, H, W); input_mask: (B, 1, H, W)."""
    m3 = (input_mask > 0.0).float().expand_as(x)
    per_sample = torch.square((x - x_hat) * m3).sum(dim=(1, 2, 3))
    count = torch.clamp_min(m3.sum(dim=(1, 2, 3)), 1.0)
    return torch.mean(per_sample / count)


class AnalysisTransform(nn.Module):
    def __init__(self, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        g = dict(policy=policy, device=device)
        n, m = RGB_N, RGB_M
        self.x1 = Conv(3, n, 5, 2, **kw)
        self.gdn1 = GDN(n, **g)
        self.x2 = Conv(n, n, 5, 2, **kw)
        self.gdn2 = GDN(n, **g)
        self.attention1 = WinGateAttention(n, 8, 8, 4, **kw)
        self.x3 = Conv(n, n, 5, 2, **kw)
        self.gdn3 = GDN(n, **g)
        self.x4 = Conv(n, m, 1, 1, **kw)
        self.attention2 = WinGateAttention(m, 8, 4, 2, **kw)

    def forward(self, x, me2, me3):
        y = self.gdn2(self.x2(self.gdn1(self.x1(x))))
        y = self.attention1(y, me2)
        y = self.x4(self.gdn3(self.x3(y)))
        return self.attention2(y, me3)


class SynthesisTransform(nn.Module):
    def __init__(self, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        g = dict(policy=policy, device=device)
        n, m = RGB_N, RGB_M
        self.attention1 = WinGateAttention(m, 8, 4, 2, **kw)
        self.x1 = Conv(m, n, 1, 1, **kw)
        self.igdn1 = GDN(n, inverse=True, **g)
        self.x2 = ConvTranspose(n, n, 5, 2, **kw)
        self.igdn2 = GDN(n, inverse=True, **g)
        self.attention2 = WinGateAttention(n, 8, 8, 4, **kw)
        self.x3 = ConvTranspose(n, n, 5, 2, **kw)
        self.igdn3 = GDN(n, inverse=True, **g)
        self.x4 = ConvTranspose(n, 3, 5, 2, **kw)
        self.dse = DSE(in_ch=3, **kw)

    def forward(self, y_hat, md2, md3):
        x = self.attention1(y_hat, md3)
        x = self.igdn2(self.x2(self.igdn1(self.x1(x))))
        x = self.attention2(x, md2)
        x = self.x4(self.igdn3(self.x3(x)))
        return self.dse(x)


class RGBCodec(ChannelARPrior):
    def __init__(self, *, policy: Policy, device, generator,
                 rate_gate: bool = False):
        kw = dict(policy=policy, device=device, generator=generator)
        super().__init__(latent_channels=RGB_M, num_slices=10, **kw)
        self.rate_gate = rate_gate
        self.Encoder = AnalysisTransform(**kw)
        self.Decoder = SynthesisTransform(**kw)

    def forward(self, x, mask, reconmask, me_pyr, training: bool = False,
                generator=None):
        """x: (B, 3, H, W) pre-masked RGB; mask: GT alpha (B, 1, H, W);
        reconmask: decoded alpha that gates the decoder; me_pyr: pyramid of
        the GT alpha.  Returns dict(x_hat, mse_loss, bpp, bpp_y, bpp_z,
        y_hat).  training: noise-relaxed likelihoods, the noise drawn from
        ``generator``; the rate gate is off in training."""
        b, _, h, w = x.shape
        reconmask = torch.round(reconmask * 255.0) / 255.0
        md_pyr = mask_pyramid(reconmask)
        y = self.encode_latent(x, me_pyr[1], me_pyr[2])
        gate = ((md_pyr[2] > 0).float()
                if self.rate_gate and not training else None)
        ent = self.entropy_forward(y, gate=gate, training=training,
                                   generator=generator)
        x_hat = self.decode_latent(ent["y_hat"], md_pyr[1], md_pyr[2])
        bpp_y = bpp_of(ent["y_likelihoods"], b, h, w)
        bpp_z = bpp_of(ent["z_likelihoods"], b, h, w)
        return {
            "x_hat": x_hat,
            "mse_loss": reconstruct_error(x.float(), x_hat, mask),
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
            "y_hat": ent["y_hat"],
        }

    # pieces of the bitstream codec (eval/codec_io.py)
    def encode_latent(self, x, me2, me3):
        return self.Encoder(self.policy.cast_in(x), me2, me3)

    def decode_latent(self, y_hat, md2, md3):
        return self.Decoder(y_hat.to(self.policy.compute_dtype),
                            md2, md3).float()
