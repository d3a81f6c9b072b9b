"""Generalized Divisive Normalization (port of ``rgba_tpu/ops/gdn.py``).

y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2)   (the inverse multiplies)

beta and gamma are stored through a sqrt reparameterization with pedestal
2^-36 and lower-bounded with the gradient-gated ``lower_bound``; that stays
in PyTorch.  With ``policy.fused_gdn`` the normalization runs in the CUDA
kernel ``ops/kernels/gdn.py`` on NHWC rows; under autograd its gradients
come from the plain path below (``ops/kernels/remat.py``).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..core.precision import Policy
from .attention import cached_layout
from .conv import per_image
from .kernels.gdn import fused_gdn, kernel_weights
from .kernels.remat import fused_primal_plain_grad
from .math import lower_bound

_REPARAM_OFFSET = 2.0 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False, *,
                 policy: Policy, device, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.policy = policy
        self.beta_min = beta_min
        eye = torch.eye(channels, device=device)
        self.beta = nn.Parameter(
            torch.sqrt(torch.ones(channels, device=device) + _PEDESTAL))
        self.gamma = nn.Parameter(torch.sqrt(gamma_init * eye + _PEDESTAL))
        self._kernel_cache = (None, None)   # (key, laid-out gamma_t)

    def reparam(self):
        """(beta, gamma) after the lower bound and pedestal."""
        beta_bound = (self.beta_min + _PEDESTAL) ** 0.5
        beta = lower_bound(self.beta, beta_bound) ** 2 - _PEDESTAL
        gamma = lower_bound(self.gamma, _REPARAM_OFFSET) ** 2 - _PEDESTAL
        return beta, gamma

    def kernel_gamma(self, dtype):
        """The kernel's layout of the post-reparam gamma_t for ``dtype``,
        built once and kept until gamma is written or moved (its version or
        storage changes; inference tensors keep no version, so only a move
        counts for them)."""
        return cached_layout(self, (self.gamma,), dtype, lambda: kernel_weights(
            self.reparam()[1].t(), dtype))

    def forward(self, x):
        """x: (B, C, H, W); gamma[i, j] weights input channel j into output
        channel i, as torch's 1x1 conv of x^2 does."""
        beta, gamma = self.reparam()
        x = x.to(self.policy.compute_dtype)
        if self.policy.fused_gdn:
            rows = x.permute(0, 2, 3, 1).contiguous()     # free if channels_last
            prepared = self.kernel_gamma(x.dtype)
            y = fused_primal_plain_grad(
                lambda r, gt, bt: fused_gdn(r, gt, bt, inverse=self.inverse,
                                            prepared=prepared),
                lambda r, gt, bt: self.normalize(
                    r.permute(0, 3, 1, 2), gt.t(), bt).permute(0, 2, 3, 1),
                (rows, gamma.t(), beta))
            return y.permute(0, 3, 1, 2)
        return self.normalize(x, gamma, beta)

    def normalize(self, x, gamma, beta):
        """The plain path: x (B, C, H, W) in the compute dtype, gamma and
        beta after ``reparam``."""
        dt = self.policy.compute_dtype
        g = gamma.to(dt)[:, :, None, None]
        norm = per_image(lambda t: F.conv2d(t * t, g), x).float() + \
            beta.float()[None, :, None, None]
        # fp32: exact sqrt/div; bf16: the elementwise tail in bf16
        if dt != torch.float32:
            norm = norm.to(dt)
        return x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))
