"""Window partition/reverse, Swin shifted-window masks and zero-window
gating (port of ``rgba_tpu/ops/window.py``).

Tensors here are NHWC (B, H, W, C); windows are (B*nH*nW, ws, ws, C) in
row-major window order, batch-major.  The static masks are built in numpy,
exactly as the JAX package builds them, and cached per shape.
"""

from __future__ import annotations

import functools

import numpy as np


def window_partition(x, window_size: int):
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C), row-major window order."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, window_size: int, h: int, w: int):
    """(B*nH*nW, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def window_alive(alpha_windows):
    """(nWB, ws, ws, 1) alpha windows -> (nWB,) gate: 1 where any alpha."""
    s = alpha_windows.sum(dim=(1, 2, 3))
    return (s != 0).to(alpha_windows.dtype)


def _region_image(h: int, w: int, ws: int, ss: int, dtype, offset: int = 0,
                  global_h: int = 0):
    """Region labels of the shifted image's windows.  A band of ``h`` rows
    at row ``offset`` of an image of ``global_h`` rows (height sharding)
    takes its rows of the whole image's labels: only the last band holds
    the vertical wrap's."""
    gh = global_h or h
    img = np.zeros((gh, w), dtype=dtype)
    if ss > 0:
        slices = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
        cnt = 0
        for hs in slices:
            for wsl in slices:
                img[hs, wsl] = cnt
                cnt += 1
    img = img[offset:offset + h]
    nh, nw = h // ws, w // ws
    return img.reshape(nh, ws, nw, ws).transpose(0, 2, 1, 3).reshape(
        -1, ws * ws)


@functools.lru_cache(maxsize=64)
def swin_attention_bias(h: int, w: int, window_size: int, shift_size: int,
                        offset: int = 0, global_h: int = 0):
    """Additive (nW, N, N) SW-MSA bias: -100 where two tokens' regions
    differ, else 0 (the reference's fill value, not -inf).  ``offset`` and
    ``global_h``: a band of the image (``_region_image``)."""
    m = _region_image(h, w, window_size, shift_size, np.float32, offset,
                      global_h)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def swin_region_ids(h: int, w: int, window_size: int, shift_size: int,
                    offset: int = 0, global_h: int = 0):
    """(nW, N) int32 region labels per window (all zero when unshifted);
    the fused kernel adds -100 wherever two labels differ.  ``offset`` and
    ``global_h``: a band of the image (``_region_image``)."""
    return np.ascontiguousarray(_region_image(
        h, w, window_size, shift_size, np.int32, offset, global_h))


@functools.lru_cache(maxsize=16)
def relative_position_index(window_size: int):
    """(N, N) indices into the (2ws-1)^2 relative-position bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return np.ascontiguousarray(rel.sum(-1))
