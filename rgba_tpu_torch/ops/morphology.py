"""Isolated-pixel cleanup of the decoded alpha (port of
``rgba_tpu/ops/morphology.py``).

The 8-neighbour sum is eight shifted fp32 adds over a zero-padded copy, not
a convolution: cuDNN may run a convolution in TF32 or reorder it, and the
``== 8`` / ``== 0`` tests below must stay exact.  Under height sharding
(``parallel/spatial.py``) the band takes one row of each neighbour band
(zero rows at the image's top and bottom, as the padding), so the same
adds run on the same values and the tests stay exact at band edges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial


def _neighbor_sum(mask):
    """(B, 1, H, W) -> sum of the 8 neighbours, zero outside the image."""
    h, w = mask.shape[-2:]
    p = F.pad(spatial.halo(mask.float(), 1, 1), (1, 1, 0, 0))
    total = torch.zeros_like(p[..., 1:h + 1, 1:w + 1])
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            total = total + p[..., dy:dy + h, dx:dx + w]
    return total


def constraint_rgb(mask):
    """Centre-aware variant: a 0 pixel whose neighbours are all 1 becomes 1;
    a positive pixel whose neighbours are all 0 becomes 0."""
    ns = _neighbor_sum(mask)
    isolated_zeros = (mask == 0) & (ns == 8)
    isolated_ones = (mask > 0) & (ns == 0)
    mask = torch.where(isolated_zeros, torch.ones_like(mask), mask)
    return torch.where(isolated_ones, torch.zeros_like(mask), mask)


def constraint_mask(mask):
    """Neighbour-sum-only variant (the reference mask trainer's)."""
    ns = _neighbor_sum(mask)
    mask = torch.where(ns == 8, torch.ones_like(mask), mask)
    return torch.where(ns == 0, torch.zeros_like(mask), mask)
