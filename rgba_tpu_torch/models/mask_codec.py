"""Alpha-matte (mask) codec (port of ``rgba_tpu/models/mask_codec.py``).

EncoderMask: 3 x (conv5x5 s2 + GDN) with SimplifiedAttention after stage
2, a 1x1 conv to M=80, SimplifiedAttention.  DecoderMask mirrors it with
IGDN and a LeakyReLU DSE tail.  Entropy: hyperprior + 5-slice channel-AR
head.  Sequential indices are the reference's state-dict keys
(``EncoderMask.0.weight`` ... ``DecoderMask.9.enh1.conv1.weight``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import Policy
from ..entropy.rate import bpp as bpp_of
from ..ops.attention import SimplifiedAttention
from ..ops.conv import Conv, ConvTranspose
from ..ops.enhance import DSE
from ..ops.gdn import GDN
from .hyperprior import ChannelARPrior

MASK_N = 192
MASK_M = 80


class MaskCodec(ChannelARPrior):
    def __init__(self, *, policy: Policy, device, generator):
        kw = dict(policy=policy, device=device, generator=generator)
        super().__init__(latent_channels=MASK_M, num_slices=5, **kw)
        n, m = MASK_N, MASK_M
        g = dict(policy=policy, device=device)
        self.EncoderMask = nn.Sequential(
            Conv(1, n, 5, 2, **kw), GDN(n, **g),
            Conv(n, n, 5, 2, **kw), GDN(n, **g),
            SimplifiedAttention(n, **kw),
            Conv(n, n, 5, 2, **kw), GDN(n, **g),
            Conv(n, m, 1, 1, **kw),
            SimplifiedAttention(m, **kw))
        self.DecoderMask = nn.Sequential(
            SimplifiedAttention(m, **kw),
            ConvTranspose(m, n, 1, 1, padding=0, output_padding=0, **kw),
            GDN(n, inverse=True, **g),
            ConvTranspose(n, n, 5, 2, **kw), GDN(n, inverse=True, **g),
            SimplifiedAttention(n, **kw),
            ConvTranspose(n, n, 5, 2, **kw), GDN(n, inverse=True, **g),
            ConvTranspose(n, 1, 5, 2, **kw),
            DSE(in_ch=1, leaky=True, **kw))

    def forward(self, mask, training: bool = False, generator=None):
        """mask: (B, 1, H, W) in [0, 1] -> dict(x_hat, mse_loss, bpp,
        bpp_y, bpp_z, y_hat).  training: noise-relaxed likelihoods, the
        noise drawn from ``generator`` (``ChannelARPrior.entropy_forward``)."""
        b, _, h, w = mask.shape
        y = self.encode_latent(mask)
        ent = self.entropy_forward(y, training=training, generator=generator)
        x_hat = self.decode_latent(ent["y_hat"])
        bpp_y = bpp_of(ent["y_likelihoods"], b, h, w)
        bpp_z = bpp_of(ent["z_likelihoods"], b, h, w)
        return {
            "x_hat": x_hat,
            "mse_loss": torch.mean(torch.square(x_hat - mask.float())),
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
            "y_hat": ent["y_hat"],
        }

    # pieces of the bitstream codec (eval/codec_io.py)
    def encode_latent(self, mask):
        return self.EncoderMask(self.policy.cast_in(mask))

    def decode_latent(self, y_hat):
        return self.DecoderMask(y_hat.to(self.policy.compute_dtype)).float()
