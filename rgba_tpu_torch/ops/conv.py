"""Convolutions with torch geometry (port of ``rgba_tpu/ops/conv.py``).

Modules take NCHW tensors; on the card they stay in ``channels_last``
memory, so ``x.permute(0, 2, 3, 1)`` is the NHWC view the kernels read
without a copy.  Parameters are fp32 and are cast to the policy's compute
dtype at call time, as the JAX modules do.  Weights are stored in torch
layout: Conv (O, I, kh, kw), ConvTranspose (I, O, kh, kw).

The TPU lowerings ``_strided_conv5x5_s2_s2d`` and ``_subpixel_deconv5x5_s2``
are schedule variants of the same math and are not ported.
"""

from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from ..core import init
from ..core.precision import Policy


def conv2d(x, weight, bias, policy: Policy, stride: int = 1, padding: int = 0):
    """``Conv`` on explicit fp32 parameters in torch layout, cast to the
    policy's compute dtype: what the pure plain paths of the kernel sites
    are written in."""
    dt = policy.compute_dtype
    return F.conv2d(x.to(dt), weight.to(dt), bias.to(dt), stride, padding)


class Conv(nn.Module):
    """Conv2d(cin -> cout, k, stride, padding k//2 by default); zero bias."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5,
                 stride: int = 2, padding: int | None = None, *,
                 policy: Policy, device, generator):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.policy = policy
        self.weight = init.uniform_fan_in((cout, cin, k, k), k * k * cin,
                                          generator, device)
        self.bias = init.zeros((cout,), device)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.policy, self.stride,
                      self.padding)


class ConvTranspose(nn.Module):
    """ConvTranspose2d(k, stride, padding=k//2, output_padding=stride-1 by
    default): output size (H-1)*s - 2p + k + op.  Fan-in for the init is
    k*k*cin, as in the JAX module (torch's default would use cout)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5,
                 stride: int = 2, padding: int | None = None,
                 output_padding: int | None = None, *, policy: Policy,
                 device, generator):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.output_padding = (stride - 1 if output_padding is None
                               else output_padding)
        self.policy = policy
        self.weight = init.uniform_fan_in((cin, cout, k, k), k * k * cin,
                                          generator, device)
        self.bias = init.zeros((cout,), device)

    def forward(self, x):
        dt = self.policy.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride,
                                  self.padding, self.output_padding)


class SubpelConv(nn.Sequential):
    """compressai subpel_conv3x3: Conv3x3(C -> out*r^2) + PixelShuffle(r)
    (channel order c*r*r + i*r + j); child ``0`` is the conv, as in the
    reference's state-dict keys."""

    def __init__(self, cin: int, cout: int, r: int = 2, *, policy: Policy,
                 device, generator):
        super().__init__(
            Conv(cin, cout * r * r, 3, 1, policy=policy, device=device,
                 generator=generator),
            nn.PixelShuffle(r))


class GELU(nn.Module):
    """The policy's GELU flavour as a module (for nn.Sequential stacks)."""

    def __init__(self, policy: Policy):
        super().__init__()
        self.policy = policy

    def forward(self, x):
        return self.policy.gelu(x)
