"""Seeded parameter draws with the JAX package's distributions.

Every draw runs on the CPU from an explicit ``torch.Generator`` and is then
moved to the module's device, so a seed gives the same weights on any
device.  The distributions are those of the flax initializers:
``variance_scaling(1/3, "fan_in", "uniform")`` is U(±sqrt(1/fan_in)) (also
torch's default conv init), ``lecun_normal`` a normal truncated at ±2σ
with σ = sqrt(1/fan_in)/0.8796, ``truncated_normal(0.02)`` a normal of
σ = 0.02 truncated at ±2σ.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2]; flax's lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


def uniform_fan_in(shape, fan_in: int, generator, device) -> nn.Parameter:
    bound = math.sqrt(1.0 / fan_in)
    w = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w.to(device))


def truncated_normal(shape, std: float, generator, device) -> nn.Parameter:
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return nn.Parameter(w.to(device))


def lecun_normal(shape, fan_in: int, generator, device) -> nn.Parameter:
    return truncated_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                            generator, device)


def zeros(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device))
