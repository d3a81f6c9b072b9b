"""Synthetic RGBA batches for tests and benchmarks, numpy only (port of
``rgba_tpu/data/synthetic.py``).

Smooth random images with blob-shaped alpha mattes, deterministic per
seed; ``write_synthetic_kodak_tree`` materializes a fake Kodak eval tree
in the reference README's layout (written with the port's PNG writer).  The JAX package upsamples its noise octaves with Pillow's bilinear
resize; ``_resize_bilinear_u8`` reproduces that resize on uint8 images
bit for bit (Pillow's two-pass fixed-point resampling: horizontal pass,
then vertical, 22 fractional bits), so both packages draw the same images
from the same seed without the port needing Pillow.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .png import write_png

_PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear filter, normalized and
    converted to fixed point: (bounds (out, 2), kk (out, ksize) int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale))
             for x in range(xmax)]
        ww = sum(w)
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            kk[xx, x] = int((-0.5 if k < 0 else 0.5) + k * (1 << _PRECISION_BITS))
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` of a uint8
    (H, W, C) image."""
    in_size = img.shape[axis]
    bounds, kk = _coeffs(in_size, out_size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)      # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for k in range(kk.shape[1]):
        idx = np.minimum(bounds[:, 0] + k, in_size - 1)
        acc += src[idx] * kk[:, k].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize_bilinear_u8(img: np.ndarray, width: int, height: int):
    """Pillow ``Image.resize((width, height), BILINEAR)`` of a uint8
    (H, W, C) image."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


def _smooth_noise(rng, h, w, c, octaves=3):
    img = np.zeros((h, w, c), np.float32)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o + 1)), max(2, w >> (octaves - o + 1))
        base = rng.rand(sh, sw, c).astype(np.float32)
        up = _resize_bilinear_u8((base * 255).astype(np.uint8), w, h)
        img += up.astype(np.float32).reshape(h, w, c) / 255.0 * (0.5 ** o)
    img /= img.max() + 1e-6
    return np.clip(img, 0, 1)


def _blob_alpha(rng, h, w, n_blobs=3):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    alpha = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(0.1, 0.35) * h, rng.uniform(0.1, 0.35) * w
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        alpha = np.maximum(alpha, np.clip(1.5 - d, 0, 1))
    return np.clip(alpha, 0, 1)[..., None]


def synthetic_rgba_batch(batch: int, height: int, width: int, seed: int = 0,
                         opaque: bool = False):
    """Returns dict(masked_image, alpha, image, rgba) of NHWC float32."""
    rng = np.random.RandomState(seed)
    imgs, alphas = [], []
    for _ in range(batch):
        img = _smooth_noise(rng, height, width, 3)
        alpha = (np.ones((height, width, 1), np.float32) if opaque
                 else np.round(_blob_alpha(rng, height, width) * 255) / 255)
        imgs.append(img)
        alphas.append(alpha)
    image = np.stack(imgs)
    alpha = np.stack(alphas)
    masked = np.where(alpha > 0, image, alpha)
    return {
        "masked_image": masked.astype(np.float32),
        "alpha": alpha.astype(np.float32),
        "image": image.astype(np.float32),
        "rgba": np.concatenate([image, alpha], -1).astype(np.float32),
    }


def write_synthetic_kodak_tree(root: str, n_images: int = 2,
                               height: int = 512, width: int = 768,
                               seed: int = 0):
    """Materialize <root>/{PNGImages,MaskImages,ImageSets} like the real
    Kodak RGBA layout so the eval path can be driven without the dataset;
    image i is ``synthetic_rgba_batch(1, ..., seed=seed + i)``.  Returns
    the ids."""
    for sub in ("PNGImages", "MaskImages", "ImageSets"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = []
    for i in range(n_images):
        batch = synthetic_rgba_batch(1, height, width, seed=seed + i)
        img = (batch["image"][0] * 255).astype(np.uint8)
        alpha = (batch["alpha"][0, ..., 0] * 255).astype(np.uint8)
        name = f"synth{i:02d}"
        write_png(os.path.join(root, "PNGImages", name + ".png"), img)
        write_png(os.path.join(root, "MaskImages", name + ".png"), alpha)
        ids.append(name)
    with open(os.path.join(root, "ImageSets", "mask.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids
