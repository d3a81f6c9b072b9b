"""Decoder-side enhancement tail, DSE (port of ``rgba_tpu/ops/enhance.py``).

1x1 in-conv -> 3 residual enhancement blocks (3x3, act, 3x3) -> long skip
-> 1x1 out-conv -> identity skip.  ReLU in the RGB decoder, LeakyReLU 0.01
in the mask decoder.  The ``fused_dse`` kernel has no port yet, and
``packed_dse`` (a TPU lane layout of the same math) computes this plain
chain.
"""

from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from ..core.precision import Policy
from .conv import Conv


class EnhancementBlock(nn.Module):
    def __init__(self, filters: int, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.conv1 = Conv(filters, filters, 3, 1, **kw)
        self.conv2 = Conv(filters, filters, 3, 1, **kw)


class DSE(nn.Module):
    def __init__(self, in_ch: int = 3, filters: int = 32, leaky: bool = False,
                 *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.leaky = leaky
        self.input_conv = Conv(in_ch, filters, 1, 1, **kw)
        self.enh1 = EnhancementBlock(filters, **kw)
        self.enh2 = EnhancementBlock(filters, **kw)
        self.enh3 = EnhancementBlock(filters, **kw)
        self.output_conv = Conv(filters, in_ch, 1, 1, **kw)

    def forward(self, x):
        first = self.input_conv(x)
        y = first
        for enh in (self.enh1, self.enh2, self.enh3):
            z = enh.conv1(y)
            z = F.leaky_relu(z, 0.01) if self.leaky else F.relu(z)
            y = y + enh.conv2(z)
        y = y + first
        return self.output_conv(y) + x
