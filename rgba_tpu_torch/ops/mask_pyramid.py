"""Multiscale alpha-mask pyramid (port of ``rgba_tpu/ops/mask_pyramid.py``).

Six levels of AvgPool(3x3, stride 2, pad 1, count_include_pad=True) on a
(B, 1, H, W) alpha matte.

Under height sharding (``parallel/spatial.py``) each level pools its band
with the last row of the band above (a zero row at the image's top: with
the padding counted, the divisor is 9 either way), padding only the width,
so every level's rows equal the whole image's bit for bit.  A band holds
the levels at which its height is still whole: a band of 32 rows the
first five (the codecs read H/4 and H/8).
"""

from __future__ import annotations

import torch.nn.functional as F

from ..parallel import spatial


def mask_pyramid(mask, levels: int = 6):
    """[H/2, H/4, ..., H/64] average-pooled masks of a (B, 1, H, W) alpha
    (on a band: the levels it holds, see above)."""
    out = []
    x = mask
    banded = spatial.current() is not None
    for _ in range(levels):
        if not banded:
            x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
        elif x.shape[-2] % 2:
            break
        else:
            x = F.avg_pool2d(spatial.halo(x, 1, 0), 3, 2, (0, 1),
                             count_include_pad=True)
        out.append(x)
    return tuple(out)
