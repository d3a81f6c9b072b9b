"""compressai's residual blocks, as the mixed Transformer-CNN codec
(``models/tcm.py``) uses them.  Module names follow compressai's
state-dict keys (``conv1``, ``conv2``, ``gdn``, ``skip``, ``subpel_conv``,
``igdn``, ``upsample``); the leaky ReLU has compressai's slope 0.01.

* ``ResidualBlock(c)``: x + lrelu(conv3x3(lrelu(conv3x3(x))));
* ``ResidualBlockWithStride(a, b)``: GDN(conv3x3(lrelu(conv3x3(x, a -> b,
  stride 2)))) + conv1x1 stride 2 (x);
* ``ResidualBlockUpsample(a, b)``: IGDN(conv3x3(lrelu(subpel(x, a -> b,
  2)))) + subpel(x, a -> b, 2), subpel a 3x3 convolution to b * 4 channels
  and a PixelShuffle(2).

The convolutions are the port's ``Conv`` (the policy's dtype, each image
alone inside ``batch_invariant_scope``) and the GDNs the port's ``GDN``,
which the policy routes through the GDN kernel.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..core.precision import Policy
from .conv import Conv, SubpelConv
from .gdn import GDN

LEAKY_SLOPE = 0.01


def lrelu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class ResidualBlock(nn.Module):
    def __init__(self, c: int, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.conv1 = Conv(c, c, 3, 1, **kw)
        self.conv2 = Conv(c, c, 3, 1, **kw)

    def forward(self, x):
        return x + lrelu(self.conv2(lrelu(self.conv1(x))))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, cin: int, cout: int, *, policy: Policy, device,
                 generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.conv1 = Conv(cin, cout, 3, 2, **kw)
        self.conv2 = Conv(cout, cout, 3, 1, **kw)
        self.gdn = GDN(cout, policy=policy, device=device)
        self.skip = Conv(cin, cout, 1, 2, **kw)

    def forward(self, x):
        return self.gdn(self.conv2(lrelu(self.conv1(x)))) + self.skip(x)


class ResidualBlockUpsample(nn.Module):
    def __init__(self, cin: int, cout: int, *, policy: Policy, device,
                 generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.subpel_conv = SubpelConv(cin, cout, 2, **kw)
        self.conv = Conv(cout, cout, 3, 1, **kw)
        self.igdn = GDN(cout, inverse=True, policy=policy, device=device)
        self.upsample = SubpelConv(cin, cout, 2, **kw)

    def forward(self, x):
        out = self.igdn(self.conv(lrelu(self.subpel_conv(x))))
        return out + self.upsample(x)
