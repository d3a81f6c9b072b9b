"""The port's PNG codec, synthetic Kodak tree, datasets and loader
factories against Pillow and the JAX package's data modules.  Exact
throughout: the same pixels, the same crops, the same floats.

The training images carry partly transparent pixels: the crop's resize is
Pillow's RGBA bilinear resize, which premultiplies the alpha and divides
it out again with its own integer rounding, and only such pixels show
whether the port reproduces both steps.
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from rgba_tpu.data import datasets as jds
from rgba_tpu.data.synthetic import synthetic_rgba_batch as j_batch
from rgba_tpu.data.synthetic import write_synthetic_kodak_tree as j_tree

from rgba_tpu_torch.data import datasets, png, prepare
from rgba_tpu_torch.data.loader import BatchLoader
from rgba_tpu_torch.data.synthetic import write_synthetic_kodak_tree


def _save(img: Image.Image, path) -> str:
    img.save(str(path))
    return str(path)


def _varied(h, w, ch, seed):
    """Ramps, flat rows and noise, so Pillow's adaptive filter picks
    several filter types."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((h, w, ch), np.uint8)
    for c in range(ch):
        base = [(xx * 3), (yy * 5), rng.integers(0, 256, (h, w)),
                (xx + yy) * 2][c % 4]
        out[..., c] = base % 256
    out[::7] = 0
    out[h // 2:, w // 2:] = rng.integers(0, 256, (h - h // 2, w - w // 2, ch))
    return out


@pytest.mark.parametrize("mode,ch", [("L", 1), ("LA", 2), ("RGB", 3),
                                     ("RGBA", 4), ("P", 1)])
def test_png_reads_what_pillow_writes(tmp_path, mode, ch):
    arr = _varied(45, 67, ch, seed=ch)
    img = Image.fromarray(arr[..., 0] if ch == 1 else arr,
                          "L" if mode == "P" else mode)
    if mode == "P":
        img = img.convert("P")
        img.info["transparency"] = 3            # a tRNS entry
    path = _save(img, tmp_path / f"{mode}.png")
    for to in ("L", "RGB", "RGBA"):
        np.testing.assert_array_equal(png.load(path, to),
                                      np.asarray(Image.open(path).convert(to)),
                                      err_msg=f"{mode} -> {to}")


def _filtered_png(px: np.ndarray, filters) -> bytes:
    """An RGBA PNG whose row y uses filter filters[y % len(filters)], each
    filter computed as the PNG specification defines it."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int32)
    raw = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_png_reads_all_five_filter_types(tmp_path):
    px = _varied(31, 29, 4, seed=9)
    path = tmp_path / "filters.png"
    path.write_bytes(_filtered_png(px, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), px)
    np.testing.assert_array_equal(png.load(str(path), "RGBA"), px)
    # and Pillow's own adaptive choice on a larger image
    buf = io.BytesIO()
    Image.fromarray(_varied(96, 80, 4, seed=1), "RGBA").save(buf, "PNG")
    path2 = tmp_path / "adaptive.png"
    path2.write_bytes(buf.getvalue())
    raw = zlib.decompress(b"".join(b for k, b in png._chunks(buf.getvalue(), "")
                                   if k == b"IDAT"))
    assert len({raw[y * (80 * 4 + 1)] for y in range(96)}) >= 3
    np.testing.assert_array_equal(png.load(str(path2), "RGBA"),
                                  np.asarray(Image.open(path2)))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_pillow_reads_what_png_writes(tmp_path, ch):
    arr = _varied(33, 50, ch, seed=ch)
    path = str(tmp_path / f"w{ch}.png")
    png.write_png(path, arr[..., 0] if ch == 1 else arr)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    assert png.png_size(path) == (33, 50)


def test_png_refuses_what_it_does_not_read(tmp_path):
    path = _save(Image.fromarray(np.zeros((4, 4), np.uint16) + 300),
                 tmp_path / "deep.png")
    with pytest.raises(ValueError, match="deep.png"):
        png.load(path, "L")
    _save(Image.new("RGB", (8, 8)), tmp_path / "plain.png")
    # Pillow writes no interlaced PNG: set the header's flag by hand
    data = bytearray((tmp_path / "plain.png").read_bytes())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "inter.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="inter.png"):
        png.load(str(tmp_path / "inter.png"), "RGB")
    (tmp_path / "junk.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="junk.png"):
        png.load(str(tmp_path / "junk.png"), "RGB")


def test_the_synthetic_tree_equals_the_jax_one(tmp_path):
    j_tree(str(tmp_path / "j"), n_images=3, height=64, width=128, seed=5)
    ids = write_synthetic_kodak_tree(str(tmp_path / "t"), n_images=3,
                                     height=64, width=128, seed=5)
    assert ids == ["synth00", "synth01", "synth02"]
    for sub in ("PNGImages", "MaskImages"):
        for name in ids:
            a = np.asarray(Image.open(tmp_path / "j" / sub / f"{name}.png"))
            b = np.asarray(Image.open(tmp_path / "t" / sub / f"{name}.png"))
            np.testing.assert_array_equal(a, b, err_msg=f"{sub}/{name}")
    for f in ("j", "t"):
        assert (tmp_path / f / "ImageSets" / "mask.txt").read_text() == \
            "synth00\nsynth01\nsynth02\n"


def test_kodak_dataset_equals_the_jax_one(tmp_path):
    root = str(tmp_path)
    j_tree(root, n_images=2, height=64, width=96, seed=2)
    # an RGB-mode mask too, which the dataset converts to L
    rgb_mask = np.asarray(Image.open(f"{root}/MaskImages/synth01.png"))
    Image.fromarray(np.stack([rgb_mask] * 3, -1), "RGB").save(
        f"{root}/MaskImages/synth01.png")
    want, got = jds.KodakDataset(root), datasets.KodakDataset(root)
    assert len(got) == len(want) == 2
    for i in range(2):
        a, b = want.get(i), got.get(i)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def _train_tree(root, n=4):
    """RGBA PNGs whose alpha is 0, 255 and levels between: the resize
    meets transparent, opaque and partly transparent pixels."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        b = j_batch(1, 72 + 8 * i, 104 - 8 * i, seed=i)
        rgba = np.concatenate([b["image"][0], b["alpha"][0]], -1)
        arr = (rgba * 255).astype(np.uint8)
        assert ((arr[..., 3] > 0) & (arr[..., 3] < 255)).any()
        Image.fromarray(arr, "RGBA").save(os.path.join(root, f"im{i:02d}.png"))
    return root


def test_train_dataset_equals_the_jax_one(tmp_path):
    coco = _train_tree(str(tmp_path / "coco"))
    p3m = _train_tree(str(tmp_path / "p3m"), n=2)
    want = jds.RGBATrainDataset(coco, p3m, 48, 64, fill_mix_ratio=0.3, seed=7)
    got = datasets.RGBATrainDataset(coco, p3m, 48, 64, fill_mix_ratio=0.3,
                                    seed=7)
    assert got.images == want.images and len(got) == 6
    pairs = [(i, e) for i in range(6) for e in (0, 1)]
    assert len(pairs) >= 8
    for i, e in pairs:
        a, b = want.get(i, e), got.get(i, e)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {e} {k}")


def test_rgba_resize_equals_pillow():
    rng = np.random.default_rng(0)
    for _ in range(20):
        h, w = rng.integers(2, 40, 2)
        a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        a[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, a[..., 3])
        a[..., 3] = np.where(rng.random((h, w)) < 0.3, 255, a[..., 3])
        ow, oh = (int(v) for v in rng.integers(2, 50, 2))
        np.testing.assert_array_equal(
            datasets.resize_rgba(a, ow, oh),
            np.asarray(Image.fromarray(a, "RGBA").resize((ow, oh),
                                                         Image.BILINEAR)))


def test_the_loader_factories(tmp_path):
    coco = _train_tree(str(tmp_path / "coco"))
    j_tree(str(tmp_path / "kodak"), n_images=3, height=64, width=64, seed=1)
    loader, ds = prepare.prepare_dataset_train_COCO(
        batch_size=2, COCOrootpath=coco, height=32, width=32, seed=3)
    assert isinstance(loader, BatchLoader) and len(ds) == 4
    batch = next(iter(loader))
    assert batch["rgba"].shape == (2, 32, 32, 4)
    loader, ds = prepare.prepare_dataset_train_COCOP3M(
        batch_size=2, COCOrootpath=coco, P3Mrootpath=coco, height=32,
        width=32)
    assert len(ds) == 8 and len(loader) == 4
    loader, ds = prepare.prepare_dataset_Kodak(
        batch_size=2, rootpath=str(tmp_path / "kodak"))
    batches = list(loader)
    assert [b["image"].shape[0] for b in batches] == [2, 1]
    want = jds.KodakDataset(str(tmp_path / "kodak")).get(2)
    np.testing.assert_array_equal(batches[1]["alpha"][0], want["alpha"])
    _, ds = prepare.prepare_dataset_P3Meval(rootpath=str(tmp_path / "kodak"))
    assert ds.img_paths[0].endswith("synth00.jpg")


def test_the_jpeg_layout_says_when_pillow_is_missing(tmp_path, monkeypatch):
    """The P3M-500 layout (JPEG images) is the one read that needs Pillow;
    without it the dataset says so.  PNGs need nothing."""
    root = str(tmp_path)
    j_tree(root, n_images=1, height=64, width=64, seed=3)
    img = np.asarray(Image.open(f"{root}/PNGImages/synth00.png"))
    Image.fromarray(img).save(f"{root}/PNGImages/synth00.jpg", quality=95)
    want = jds.KodakDataset(root, img_ext="jpg").get(0)
    got = datasets.KodakDataset(root, img_ext="jpg").get(0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        datasets.KodakDataset(root, img_ext="jpg").get(0)
    assert datasets.KodakDataset(root).get(0)["image"].shape == (64, 64, 3)
