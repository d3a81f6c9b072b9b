"""Small differentiable primitives (port of ``rgba_tpu/ops/math.py``).

* ``lower_bound`` — max(x, bound); the gradient passes through iff
  ``x >= bound`` or the incoming gradient is negative (the step would push
  x back up into the feasible set).
* ``ste_round`` — round in the forward pass, identity gradient.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (above,) = ctx.saved_tensors
        return torch.where(above | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x, bound: float):
    return _LowerBound.apply(x, float(bound))


def ste_round(x):
    """round(x) forward (half to even, as jnp.round), identity backward."""
    return x + (torch.round(x) - x).detach()
