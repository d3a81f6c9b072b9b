"""RGBA datasets, host side, numpy only (port of ``rgba_tpu/data/datasets.py``).

  * ``RGBATrainDataset``: RGBA PNGs from a COCO-composited dir and a P3M
    mask-patch dir, RandomResizedCrop to H x W, joint random horizontal and
    vertical flips, and with probability ``fill_mix_ratio`` an all-ones
    alpha.
  * ``KodakDataset``: ``PNGImages/<id>.png`` + ``MaskImages/<id>.png``
    listed in ``ImageSets/mask.txt``; the masked image keeps RGB only where
    alpha > 0.

Every item is a dict of NHWC float32 arrays in [0, 1] (masked_image, alpha,
image, rgba), the same values the JAX package's datasets give: PNGs go
through the port's reader (``data/png.py``), and the crop's resize is
Pillow's bilinear resize of an RGBA image reproduced bit for bit: Pillow
premultiplies RGBA to RGBa, resizes, and divides the alpha out again, each
with its own integer rounding.  Pillow is imported only for
``KodakDataset(img_ext="jpg")`` (the P3M-500 layout), which PNG cannot
carry.
"""

from __future__ import annotations

import glob
import math
import os
import random
from typing import List, Optional

import numpy as np

from . import png
from .synthetic import _resize_bilinear_u8


def _random_resized_crop_params(h: int, w: int, rng: random.Random,
                                scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop sampling: 10 tries, then center fallback."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            return i, j, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa: each colour times alpha / 255, rounded as
    MULDIV255 does: t = c * a + 128, (t + (t >> 8)) >> 8."""
    a = rgba[..., 3:].astype(np.uint32)
    t = rgba[..., :3].astype(np.uint32) * a + 128
    rgb = ((t + (t >> 8)) >> 8).astype(np.uint8)
    return np.concatenate([rgb, rgba[..., 3:]], axis=-1)


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: colour * 255 // alpha, clipped to 255, where
    alpha is neither 0 nor 255 (those pass the colour through)."""
    a = rgba[..., 3:].astype(np.uint32)
    c = rgba[..., :3].astype(np.uint32)
    div = np.minimum(c * 255 // np.maximum(a, 1), 255)
    rgb = np.where((a == 0) | (a == 255), c, div).astype(np.uint8)
    return np.concatenate([rgb, rgba[..., 3:]], axis=-1)


def resize_rgba(rgba: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``Image.fromarray(rgba, "RGBA").resize((width, height),
    BILINEAR)`` of a uint8 (H, W, 4) image (the same size is a copy)."""
    if rgba.shape[:2] == (height, width):
        return rgba.copy()
    return _unpremultiply(_resize_bilinear_u8(_premultiply(rgba), width,
                                              height))


def _to_item(img: np.ndarray, alpha: np.ndarray) -> dict:
    """img: (H,W,3) float32 [0,1]; alpha: (H,W,1)."""
    masked = np.where(alpha > 0, img, alpha)
    return {
        "masked_image": masked.astype(np.float32),
        "alpha": alpha.astype(np.float32),
        "image": img.astype(np.float32),
        "rgba": np.concatenate([img, alpha], axis=-1).astype(np.float32),
    }


class RGBATrainDataset:
    def __init__(self, coco_path: str = "../P3Mdata/COCOdata",
                 p3m_path: Optional[str] = "../P3Mdata/MASKpatches",
                 height: int = 256, width: int = 256,
                 fill_mix_ratio: float = 0.25, seed: int = 0):
        self.images: List[str] = sorted(
            glob.glob(os.path.join(coco_path, "*.png")))
        if p3m_path:
            self.images += sorted(glob.glob(os.path.join(p3m_path, "*.png")))
        self.height = height
        self.width = width
        self.fill_mix_ratio = fill_mix_ratio
        self.seed = seed

    def __len__(self):
        return len(self.images)

    def get(self, index: int, epoch_seed: int = 0) -> dict:
        # a string seed draws the same crops in every process
        rng = random.Random(f"{self.seed}:{epoch_seed}:{index}")
        arr = png.load(self.images[index], "RGBA")
        h, w = arr.shape[:2]
        i, j, ch, cw = _random_resized_crop_params(h, w, rng)
        crop = arr[i:i + ch, j:j + cw]
        out = resize_rgba(crop, self.width, self.height).astype(
            np.float32) / 255.0
        if rng.random() < 0.5:
            out = out[:, ::-1]
        if rng.random() < 0.5:
            out = out[::-1, :]
        img = np.ascontiguousarray(out[..., :3])
        alpha = np.ascontiguousarray(out[..., 3:4])
        if rng.random() < self.fill_mix_ratio:
            alpha = np.ones_like(alpha)
        return _to_item(img, alpha)


def _load_jpg(path: str, mode: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading a JPEG needs Pillow, which is "
                          f"not installed; the PNG layout needs nothing "
                          f"more") from e
    return np.asarray(Image.open(path).convert(mode))


class KodakDataset:
    """Eval tree: <root>/PNGImages/<id>.<ext>, <root>/MaskImages/<id>.png,
    ids from <root>/ImageSets/mask.txt.  img_ext="jpg" gives the P3M-500
    eval layout (needs Pillow)."""

    def __init__(self, rootpath: str, img_ext: str = "png"):
        ids = []
        with open(os.path.join(rootpath, "ImageSets", "mask.txt")) as f:
            for line in f:
                line = line.strip()
                if line:
                    ids.append(line)
        self.img_ext = img_ext
        self.img_paths = [os.path.join(rootpath, "PNGImages", f"{i}.{img_ext}")
                          for i in ids]
        self.anno_paths = [os.path.join(rootpath, "MaskImages", f"{i}.png")
                           for i in ids]

    def __len__(self):
        return len(self.img_paths)

    def get(self, index: int) -> dict:
        path = self.img_paths[index]
        rgb = (png.load(path, "RGB") if self.img_ext == "png"
               else _load_jpg(path, "RGB"))
        img = rgb.astype(np.float32) / 255.0
        anno = png.load(self.anno_paths[index], "L").astype(np.float32) / 255.0
        return _to_item(img, anno[..., None])
