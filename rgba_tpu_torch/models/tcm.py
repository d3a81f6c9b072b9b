"""TCM: learned image compression with mixed Transformer-CNN transforms
(Liu, Sun, Katto, CVPR 2023, arXiv 2303.14978; the public code is
LIC_TCM's ``models/tcm.py``), the port's codec for opaque RGB images.

The published large model is the default: N=128, M=320, two
``ConvTransBlock``s per stage, head dims (8, 16, 32, 32, 16, 8), windows of
8 (4 in the hyper transforms), 5 slices of 64 channels, each conditioned
on every slice decoded before it.  Module names are LIC_TCM's state-dict
keys (``g_a.*``, ``g_s.*``, ``h_a.*``, ``h_mean_s.*``, ``h_scale_s.*``,
``atten_mean.*``, ``atten_scale.*``, ``cc_mean_transforms.*``,
``cc_scale_transforms.*``, ``lrp_transforms.*``, ``entropy_bottleneck.*``).

* g_a: ResidualBlockWithStride(3, 2N), 2 CTB at H/2, RBWS(2N, 2N), 2 CTB at
  H/4, RBWS, 2 CTB at H/8, conv3x3(2N, M, stride 2): y at H/16;
* g_s mirrors it with ResidualBlockUpsample and a final subpel(2N, 3, 2);
* h_a: RBWS(M, 2N), 2 CTB (head 32, window 4) at H/32, conv3x3(2N, 192,
  stride 2): z at H/64; h_mean_s / h_scale_s: RBU(192, 2N), 2 CTB, subpel(
  2N, M, 2);
* slice i: the mean and scale supports (hyper output and the decoded
  slices) pass through ``SWAtten`` (``atten_mean[i]``, ``atten_scale[i]``)
  before the cc transforms, and the lrp transform reads the attended mean
  support (``ChannelARPrior``'s support transforms).  z is coded around
  the bottleneck's medians, as in the port's other codecs.

The widths are constructor arguments, so tests can run the model small.
The codec codes opaque images only (``eval/container.py``): its transforms
take no alpha.  Latents no larger than a window are refused (the published
code pads them), and every spatial size must hold whole windows.
"""

from __future__ import annotations

from torch import nn

from ..core.precision import Policy
from ..entropy.rate import bpp as bpp_of
from ..ops.conv import Conv, SubpelConv
from ..ops.residual import ResidualBlockUpsample, ResidualBlockWithStride
from ..ops.swin import ConvTransBlock, SWAtten
from .hyperprior import Z_CHANNELS, ChannelARPrior

TCM_N = 128
TCM_M = 320
CONFIG = (2, 2, 2, 2, 2, 2)
HEAD_DIM = (8, 16, 32, 32, 16, 8)


class TCM(ChannelARPrior):
    """The codec: ``encode_latent(x)`` -> y, the channel-AR entropy head of
    ``ChannelARPrior``, ``decode_latent(y_hat)`` -> x_hat."""

    architecture = "tcm"

    def __init__(self, *, policy: Policy, device, generator, N: int = TCM_N,
                 M: int = TCM_M, config=CONFIG, head_dim=HEAD_DIM,
                 window_size: int = 8, hyper_window: int = 4,
                 hyper_head_dim: int = 32, num_slices: int = 5,
                 max_support_slices: int = 5, atten_dim: int = 128,
                 atten_head_dim: int = 16):
        kw = dict(policy=policy, device=device, generator=generator)

        def stage(n_blocks, hd, ws):
            return [ConvTransBlock(N, hd, ws, bool(i % 2), **kw)
                    for i in range(n_blocks)]

        def hyper_synthesis():
            return nn.Sequential(
                ResidualBlockUpsample(Z_CHANNELS, 2 * N, **kw),
                *stage(config[3], hyper_head_dim, hyper_window),
                SubpelConv(2 * N, M, 2, **kw))

        h_a = nn.Sequential(ResidualBlockWithStride(M, 2 * N, **kw),
                            *stage(config[0], hyper_head_dim, hyper_window),
                            Conv(2 * N, Z_CHANNELS, 3, 2, **kw))
        hyper = (h_a, hyper_synthesis(), hyper_synthesis())
        sw = M // num_slices
        widths = [M + sw * min(i, max_support_slices)
                  for i in range(num_slices)]

        def attention():
            return nn.ModuleList(nn.Sequential(SWAtten(
                c, atten_dim, atten_head_dim, window_size, **kw))
                for c in widths)

        support = (attention(), attention())
        super().__init__(M, num_slices, max_support_slices, hyper=hyper,
                         support=support, **kw)
        self.g_a = nn.Sequential(
            ResidualBlockWithStride(3, 2 * N, **kw),
            *stage(config[0], head_dim[0], window_size),
            ResidualBlockWithStride(2 * N, 2 * N, **kw),
            *stage(config[1], head_dim[1], window_size),
            ResidualBlockWithStride(2 * N, 2 * N, **kw),
            *stage(config[2], head_dim[2], window_size),
            Conv(2 * N, M, 3, 2, **kw))
        self.g_s = nn.Sequential(
            ResidualBlockUpsample(M, 2 * N, **kw),
            *stage(config[3], head_dim[3], window_size),
            ResidualBlockUpsample(2 * N, 2 * N, **kw),
            *stage(config[4], head_dim[4], window_size),
            ResidualBlockUpsample(2 * N, 2 * N, **kw),
            *stage(config[5], head_dim[5], window_size),
            SubpelConv(2 * N, 3, 2, **kw))

    def forward(self, x, training: bool = False, generator=None):
        """x: (B, 3, H, W) in [0, 1], H and W multiples of 64 -> dict(
        x_hat, bpp, bpp_y, bpp_z, y, y_hat)."""
        b, _, h, w = x.shape
        y = self.encode_latent(x)
        ent = self.entropy_forward(y, training=training, generator=generator)
        x_hat = self.decode_latent(ent["y_hat"])
        bpp_y = bpp_of(ent["y_likelihoods"], b, h, w)
        bpp_z = bpp_of(ent["z_likelihoods"], b, h, w)
        return {"x_hat": x_hat, "bpp": bpp_y + bpp_z, "bpp_y": bpp_y,
                "bpp_z": bpp_z, "y": y, "y_hat": ent["y_hat"]}

    # pieces of the bitstream codec (eval/codec_io.py)
    def encode_latent(self, x):
        return self.g_a(self.policy.cast_in(x)).float()

    def decode_latent(self, y_hat):
        return self.g_s(y_hat.to(self.policy.compute_dtype)).float()
