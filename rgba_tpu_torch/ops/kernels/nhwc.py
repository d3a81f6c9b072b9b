"""Convolutions on NHWC tensors with fp32 sums, for the plain versions of
the conv-chain kernels.

Inputs come in the activation dtype and every product accumulates in fp32,
as the kernels do; the caller casts where the kernel casts.  Weights are
(in, out) matrices: a 3x3 kernel is (9 * in, out) with rows ordered
(dy, dx, ci), the HWIO layout flattened.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1x1(t, w, b):
    """t (..., Ci) -> fp32 (..., Co) = t @ w + b."""
    return t.float() @ w.to(t.dtype).float() + b.float()


def conv3x3(t, w9, b):
    """t (B, H, W, Ci), zero padded -> fp32 (B, H, W, Co)."""
    _, h, w, _ = t.shape
    tp = F.pad(t.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([tp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1)
    return cols @ w9.to(t.dtype).float() + b.float()


def hwio3x3(weight):
    """Torch conv weight (O, I, 3, 3) -> (9 * I, O), rows (dy, dx, ci)."""
    o, i = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9 * i, o)


def io1x1(weight):
    """Torch 1x1 conv weight (O, I, 1, 1) -> (I, O)."""
    return weight[:, :, 0, 0].t()
