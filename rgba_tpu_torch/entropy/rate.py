"""Rate accounting (port of ``rgba_tpu/entropy/rate.py``):
bits = sum(clamp(-log2(likelihood + 1e-10), 0, 50))."""

from __future__ import annotations

import math

import torch

_LOG2 = math.log(2.0)


def rate_bits(likelihoods):
    """Total bits of a likelihood tensor, per-symbol clamped to [0, 50]."""
    bits = torch.clamp(-torch.log(likelihoods + 1e-10) / _LOG2, 0.0, 50.0)
    return bits.sum()


def bpp(likelihoods, batch: int, height: int, width: int):
    """Bits per pixel of the input image."""
    return rate_bits(likelihoods) / (batch * height * width)
