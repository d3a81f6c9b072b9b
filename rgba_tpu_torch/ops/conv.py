"""Convolutions with torch geometry (port of ``rgba_tpu/ops/conv.py``).

Modules take NCHW tensors; on the card they stay in ``channels_last``
memory, so ``x.permute(0, 2, 3, 1)`` is the NHWC view the kernels read
without a copy.  Parameters are fp32 and are cast to the policy's compute
dtype at call time, as the JAX modules do.  Weights are stored in torch
layout: Conv (O, I, kh, kw), ConvTranspose (I, O, kh, kw).

Under ``policy.int8_conv`` both convolutions run as the dynamic W8A8
convolution of ``ops/quant.py`` (``policy_conv``) on the whole batch: its
activation scale is the batch's, as in the JAX package, so that branch
never goes one image at a time.

Inside ``parallel.spatial.space_scope`` both modules run on a band of
rows: the input gets the rows of its neighbours' bands that the kernel
reaches (zero rows at the image's top and bottom, the convolution's own
padding), the convolution pads only the width, and the band's output rows
come out (``_band_rows``).  ``conv2d`` itself stays a pure function of its
operands: the plain paths of the kernel sites, which run on bands that
their callers extend, and the autograd recomputations of those paths call
it.  The int8 branch refuses a scope: its activation scale would be the
band's, not the batch's.

Inside ``batch_invariant_scope`` a 3x3 convolution at stride 1 and
padding 1 in fp32 on a CUDA tensor, called from ``Conv``, runs on the
hand-written kernel of ``ops/kernels/conv3x3.py`` (``takes_conv3x3``),
the whole batch in one launch: its sum order does not depend on the
batch.  Every other convolution there, the plain paths of the kernel
sites among them, goes one image at a time (``per_image``).

The TPU lowerings ``_strided_conv5x5_s2_s2d`` and ``_subpixel_deconv5x5_s2``
are schedule variants of the same math and are not ported.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..core import init
from ..core.precision import Policy, batch_invariant
from ..parallel import spatial
from .kernels import conv3x3 as k3
from .kernels.cache import cached_layout
from .quant import policy_conv


def per_image(fn, x):
    """fn(x), or inside ``batch_invariant_scope`` fn of each image on its
    own: cuDNN on the card and oneDNN on the CPU pick a convolution's
    algorithm, and so its sum order, by the batch size among the rest of
    the shape."""
    if batch_invariant() and x.shape[0] > 1:
        return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])
    return fn(x)


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def takes_conv3x3(device: str, dtype, kernel_size, stride, padding,
                  cached: bool, invariant: bool) -> bool:
    """Whether ``conv2d`` runs on the 3x3 kernel: inside
    ``batch_invariant_scope`` (``invariant``), on a CUDA tensor, in fp32,
    with a 3x3 weight at stride 1 and padding 1 on both axes, called with
    the module that keeps the kernel's weight layout (``cached``).  A
    height band pads (0, 1) and keeps cuDNN; so do the plain paths of the
    kernel sites, which pass no module.  An int8 convolution never asks."""
    return (invariant and cached and device == "cuda"
            and dtype == torch.float32 and tuple(kernel_size) == (3, 3)
            and _pair(stride) == (1, 1) and _pair(padding) == (1, 1))


def conv2d(x, weight, bias, policy: Policy, stride: int = 1, padding=0,
           cache=None):
    """``Conv`` on explicit fp32 parameters in torch layout, cast to the
    policy's compute dtype: what the pure plain paths of the kernel sites
    are written in.  ``cache``: the module that keeps the 3x3 kernel's
    weight layout (``Conv``); a call without one keeps ``per_image``."""
    if policy.int8_conv:
        _no_int8_bands()
        return policy_conv(x, weight, bias, policy, stride, padding)
    dt = policy.compute_dtype
    if takes_conv3x3(x.device.type, dt, weight.shape[-2:], stride, padding,
                     cache is not None, batch_invariant()):
        prepared = cached_layout(cache, (weight,), dt,
                                 lambda: k3.kernel_weights(weight))
        return k3.conv3x3(x.to(dt), weight, bias, prepared)
    w, b = weight.to(dt), bias.to(dt)
    return per_image(lambda t: F.conv2d(t.to(dt), w, b, stride, padding), x)


def _band_rows(k: int, s: int, p: int, transposed: bool):
    """(rows above, rows below) that a band's input needs from its
    neighbours.  A convolution's output row j reads input rows s*j - p ...
    s*j - p + k - 1; a transposed one's output row r reads the inputs i
    with r = s*i - p + t, t < k.  Band starts and heights divide by s."""
    if transposed:
        return (k - 1 - p) // s, (s - 1 + p) // s
    return p, k - p - s


def _no_int8_bands():
    if spatial.current() is not None:
        raise ValueError("int8_conv under height sharding: the activation "
                         "scale would be each band's, not the batch's")


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
        self._kernel_cache = (None, None)   # (key, the 3x3 kernel's layout)

    def forward(self, x):
        k = self.weight.shape[-1]
        above, below = _band_rows(k, self.stride, self.padding, False)
        if spatial.current() is None or not (above or below):
            return conv2d(x, self.weight, self.bias, self.policy, self.stride,
                          self.padding, cache=self)
        return conv2d(spatial.halo(x, above, below), self.weight, self.bias,
                      self.policy, self.stride, (0, self.padding))


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
        k, s, p = self.weight.shape[-1], self.stride, self.padding
        above, below = _band_rows(k, s, p, True)
        if self.policy.int8_conv:
            _no_int8_bands()
            return policy_conv(x, self.weight, self.bias, self.policy, s, p,
                               transposed=True,
                               output_padding=self.output_padding)
        banded = spatial.current() is not None and (above or below)
        dt = self.policy.compute_dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if not banded:
            return per_image(lambda t: F.conv_transpose2d(
                t.to(dt), w, b, s, p, self.output_padding), x)
        # the extended band's output row r is the image's row
        # s * (offset - above) + r: keep the band's s * h rows
        h = x.shape[-2]
        y = per_image(lambda t: F.conv_transpose2d(
            t.to(dt), w, b, s, p, (0, self.output_padding)),
            spatial.halo(x, above, below))
        return y.narrow(-2, s * above, s * h)


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
