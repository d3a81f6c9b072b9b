"""PSNR helpers (port of ``rgba_tpu/metrics/psnr.py``):
psnr = 10 * log10(range^2 / mse)."""

from __future__ import annotations

import torch


def psnr_from_mse(mse, data_range: float = 1.0):
    mse = torch.as_tensor(mse, dtype=torch.float32)
    return 10.0 * torch.log10((data_range ** 2) / torch.clamp_min(mse, 1e-12))


def psnr(x, y, data_range: float = 1.0):
    return psnr_from_mse(torch.mean(torch.square(x - y)), data_range)
