"""Multiscale alpha-mask pyramid (port of ``rgba_tpu/ops/mask_pyramid.py``).

Six levels of AvgPool(3x3, stride 2, pad 1, count_include_pad=True) on a
(B, 1, H, W) alpha matte.
"""

from __future__ import annotations

import torch.nn.functional as F


def mask_pyramid(mask, levels: int = 6):
    """[H/2, H/4, ..., H/64] average-pooled masks of a (B, 1, H, W) alpha."""
    out = []
    x = mask
    for _ in range(levels):
        x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
        out.append(x)
    return tuple(out)
