"""Decoder-side enhancement tail, DSE (port of ``rgba_tpu/ops/enhance.py``).

1x1 in-conv -> 3 residual enhancement blocks (3x3, act, 3x3) -> long skip
-> 1x1 out-conv -> identity skip.  ReLU in the RGB decoder, LeakyReLU 0.01
in the mask decoder.  With ``policy.fused_dse`` the whole tail runs in the
CUDA kernel ``ops/kernels/dse.py``.  ``packed_dse`` (a TPU lane layout of
the same math) computes the plain chain, and as in the JAX package it wins
over ``fused_dse`` when the batch divides by 4.  Under autograd the kernel
runs in the forward and the gradients come from the plain chain,
a pure function of the parameters (``ops/kernels/remat.py``).

Under height sharding (``parallel/spatial.py``) every route runs on the
band with ``DSE_HALO`` rows of each neighbour (one per 3x3 convolution;
none past the image's edges, where each layer pads itself), and the band's
rows of the result are kept.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..core.precision import Policy
from ..parallel import spatial
from .conv import Conv, conv2d
from .attention import cached_layout
from .kernels import dse as dsek
from .kernels.dse import fused_dse
from .kernels.nhwc import hwio3x3, io1x1
from .kernels.remat import fused_primal_plain_grad

PACK_GROUPS = 4
DSE_HALO = 6      # the six 3x3 convolutions of the three blocks


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

    _kernel_cache = (None, None)   # (key, the kernel's weight layout)

    def kernel_weights(self):
        """(w_in, b_in, w3, b3, w_out, b_out) as the DSE kernel takes them."""
        return dse_kernel_weights(list(self.parameters()))

    def kernel_layout(self, dtype):
        """The kernel's layout of the weights for ``dtype``
        (``dse.kernel_weights``), built once and kept until a parameter is
        written or moved (an optimizer step bumps its version)."""
        return cached_layout(self, list(self.parameters()), dtype,
                             lambda: dsek.kernel_weights(
                                 *self.kernel_weights(), dtype))

    def forward(self, x):
        p = self.policy
        h = x.shape[-2]
        xe, top = spatial.extend(x, DSE_HALO)
        if p.fused_dse and not (p.packed_dse and x.shape[0] % PACK_GROUPS == 0):
            return spatial.crop(self._kernel(xe), top, h)
        return spatial.crop(self.chain(xe), top, h)

    def chain(self, x):
        """The plain conv chain."""
        return dse_chain(x, list(self.parameters()), self.policy, self.leaky)

    def _kernel(self, x):
        """The kernel on the NHWC view of x.  The differentiable inputs are
        x and the module's parameters; their gradients come from
        ``dse_chain``."""
        dt = self.policy.compute_dtype
        prepared = self.kernel_layout(dt) if x.is_cuda else None

        def fused(r, *ps):
            return fused_dse(r, *dse_kernel_weights(ps), leaky=self.leaky,
                             prepared=prepared)

        def plain(r, *ps):
            out = dse_chain(r.permute(0, 3, 1, 2), ps, self.policy, self.leaky)
            return out.to(dt).permute(0, 2, 3, 1)

        rows = x.to(dt).permute(0, 2, 3, 1).contiguous()
        out = fused_primal_plain_grad(fused, plain, (rows, *self.parameters()))
        return out.permute(0, 3, 1, 2)


def dse_chain(x, p, policy: Policy, leaky: bool):
    """The plain conv chain as a pure function of the module's 16 parameters
    in registration order: (weight, bias) of input_conv, enh1.conv1,
    enh1.conv2, ..., enh3.conv2, output_conv."""
    first = conv2d(x, p[0], p[1], policy)
    y = first
    for i in range(2, 14, 4):
        z = conv2d(y, p[i], p[i + 1], policy, padding=1)
        z = F.leaky_relu(z, 0.01) if leaky else F.relu(z)
        y = y + conv2d(z, p[i + 2], p[i + 3], policy, padding=1)
    y = y + first
    return conv2d(y, p[14], p[15], policy) + x


def dse_kernel_weights(p):
    """The same 16 parameters as the DSE kernel takes them."""
    return (io1x1(p[0]), p[1],
            torch.stack([hwio3x3(w) for w in p[2:14:2]]),
            torch.stack(list(p[3:14:2])),
            io1x1(p[14]), p[15])
