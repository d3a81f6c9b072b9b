"""SSIM / MS-SSIM and the alpha-masked MS-SSIM variant (port of
``rgba_tpu/metrics/ms_ssim.py``); NHWC tensors as there, differentiable.

Plain version: separable 11-tap Gaussian (sigma 1.5), valid conv, 5 levels,
weights [0.0448, 0.2856, 0.3001, 0.2363, 0.1333], per-level 2x2 avg-pool
with odd-size padding.

Masked version: per level the images are multiplied by the binarized mask,
the SSIM/CS maps are averaged only over positions whose nearest-resized
mask is non-zero, cs and the final ssim are ReLU'd, and the mask is
avg-pooled along with the pyramid.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss_kernel(size: int, sigma: float, device):
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return torch.from_numpy(g.astype(np.float32)).to(device)


def _nchw(t):
    return t.float().permute(0, 3, 1, 2)


def _blur(x, win):
    """Separable valid-conv Gaussian blur, per channel.  x: (B, C, H, W).
    A side shorter than the window leaves nothing (an empty map, whose
    mean is nan, as the JAX package's valid convolution gives)."""
    b, c, h, w = x.shape
    k = win.shape[0]
    if h < k or w < k:
        return x.new_empty(b, c, max(h - k + 1, 0), max(w - k + 1, 0))
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_maps(x, y, win, data_range):
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu1 = _blur(x, win)
    mu2 = _blur(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _blur(x * x, win) - mu1_sq
    sigma2_sq = _blur(y * y, win) - mu2_sq
    sigma12 = _blur(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map, cs_map


def _avg_pool_2(x):
    """2x2 average pool, padding (H%2, W%2), pad counted in the mean."""
    return F.avg_pool2d(x, 2, padding=(x.shape[2] % 2, x.shape[3] % 2),
                        count_include_pad=True)


def ssim(x, y, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5, size_average: bool = True):
    """x, y: (B, H, W, C)."""
    x, y = _nchw(x), _nchw(y)
    win = _gauss_kernel(win_size, win_sigma, x.device)
    ssim_map, _ = _ssim_maps(x, y, win, data_range)
    val = ssim_map.mean(dim=(1, 2, 3))
    return val.mean() if size_average else val


def ms_ssim(x, y, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5, size_average: bool = True,
            weights=_WEIGHTS):
    """x, y: (B, H, W, C).  The smallest side must exceed (win-1) * 2^4."""
    x, y = _nchw(x), _nchw(y)
    win = _gauss_kernel(win_size, win_sigma, x.device)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    levels = len(weights)
    mcs = []
    ssim_val = None
    for lvl in range(levels):
        ssim_map, cs_map = _ssim_maps(x, y, win, data_range)
        ssim_val = ssim_map.mean(dim=(1, 2, 3))               # (B,)
        mcs.append(cs_map.mean(dim=(1, 2, 3)))
        if lvl < levels - 1:
            x = _avg_pool_2(x)
            y = _avg_pool_2(y)
    mcs_stack = torch.stack(mcs[:-1], dim=0)                  # (L-1, B)
    # Reference quirk kept verbatim: the ssim^w_last factor sits INSIDE the
    # prod over the L-1 cs levels, so it is applied L-1 times:
    # msssim = prod(cs_l^w_l) * ssim^((L-1)*w_last).
    val = torch.prod(mcs_stack ** w[:-1, None] * ssim_val ** w[-1], dim=0)
    return val.mean() if size_average else val


def _nearest_shrink(mask, out_h: int, out_w: int):
    """Nearest-neighbour resize of (B, C, H, W): src index = floor(dst *
    in/out), the product taken in fp32 as the JAX package takes it."""
    def index(n_in, n_out):
        i = np.floor(np.arange(n_out, dtype=np.float32)
                     * np.float32(n_in / n_out)).astype(np.int64)
        return torch.from_numpy(i).to(mask.device)
    return mask[:, :, index(mask.shape[2], out_h)][:, :, :,
                                                   index(mask.shape[3], out_w)]


def masked_ms_ssim(x, y, mask, data_range: float = 1.0, win_size: int = 11,
                   win_sigma: float = 1.5, size_average: bool = True,
                   weights=_WEIGHTS):
    """MS-SSIM over the alpha-visible region only.
    x, y: (B, H, W, C); mask: (B, H, W, 1) alpha."""
    x, y, mask = _nchw(x), _nchw(y), _nchw(mask)
    win = _gauss_kernel(win_size, win_sigma, x.device)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    levels = len(weights)
    eps = 1e-10
    one_win = win_size - 1
    mcs = []
    ssim_pc = None
    for lvl in range(levels):
        mbin = (mask > 0.0).float()
        x = x * mbin
        y = y * mbin
        ssim_map, cs_map = _ssim_maps(x, y, win, data_range)
        msmall = _nearest_shrink(mbin, mbin.shape[2] - one_win,
                                 mbin.shape[3] - one_win)
        nz = (msmall > 0.0).float()                            # (B, 1, h, w)
        denom = nz.sum(dim=(2, 3)) + eps                       # (B, 1)
        ssim_pc = (ssim_map * nz).sum(dim=(2, 3)) / denom      # (B, C)
        cs_pc = (cs_map * nz).sum(dim=(2, 3)) / denom
        if lvl < levels - 1:
            mcs.append(F.relu(cs_pc))
            x = _avg_pool_2(x)
            y = _avg_pool_2(y)
            mask = _avg_pool_2(mbin)
    stack = torch.stack(mcs + [F.relu(ssim_pc)], dim=0)        # (L, B, C)
    val = torch.prod(stack ** w[:, None, None], dim=0).mean(dim=1)
    return val.mean() if size_average else val
