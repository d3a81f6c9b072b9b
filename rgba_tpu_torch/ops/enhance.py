"""Decoder-side enhancement tail, DSE (port of ``rgba_tpu/ops/enhance.py``).

1x1 in-conv -> 3 residual enhancement blocks (3x3, act, 3x3) -> long skip
-> 1x1 out-conv -> identity skip.  ReLU in the RGB decoder, LeakyReLU 0.01
in the mask decoder.  With ``policy.fused_dse`` the whole tail runs in the
CUDA kernel ``ops/kernels/dse.py``.  ``packed_dse`` (a TPU lane layout of
the same math) computes the plain chain, and as in the JAX package it wins
over ``fused_dse`` when the batch divides by 4.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..core.precision import Policy
from .conv import Conv
from .kernels.dse import fused_dse
from .kernels.nhwc import hwio3x3, io1x1

PACK_GROUPS = 4


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
        self.policy = policy
        self.input_conv = Conv(in_ch, filters, 1, 1, **kw)
        self.enh1 = EnhancementBlock(filters, **kw)
        self.enh2 = EnhancementBlock(filters, **kw)
        self.enh3 = EnhancementBlock(filters, **kw)
        self.output_conv = Conv(filters, in_ch, 1, 1, **kw)

    def kernel_weights(self):
        """(w_in, b_in, w3, b3, w_out, b_out) as the DSE kernel takes them."""
        convs = [c for enh in (self.enh1, self.enh2, self.enh3)
                 for c in (enh.conv1, enh.conv2)]
        return (io1x1(self.input_conv.weight), self.input_conv.bias,
                torch.stack([hwio3x3(c.weight) for c in convs]),
                torch.stack([c.bias for c in convs]),
                io1x1(self.output_conv.weight), self.output_conv.bias)

    def _kernel(self, x):
        rows = x.to(self.policy.compute_dtype).permute(0, 2, 3, 1).contiguous()
        out = fused_dse(rows, *self.kernel_weights(), leaky=self.leaky)
        return out.permute(0, 3, 1, 2)

    def forward(self, x):
        p = self.policy
        if p.fused_dse and not (p.packed_dse and x.shape[0] % PACK_GROUPS == 0):
            return self._kernel(x)
        first = self.input_conv(x)
        y = first
        for enh in (self.enh1, self.enh2, self.enh3):
            z = enh.conv1(y)
            z = F.leaky_relu(z, 0.01) if self.leaky else F.relu(z)
            y = y + enh.conv2(z)
        y = y + first
        return self.output_conv(y) + x
