"""A small PNG codec with ``zlib`` and numpy (the port needs no Pillow).

Read: 8-bit gray, RGB, palette, gray + alpha and RGBA, non-interlaced, all
five filter types, ``tRNS`` transparency.  Any other bit depth, or an
interlaced file, raises ``ValueError`` naming the file.  Write: 8-bit gray,
gray + alpha, RGB and RGBA, every row with the Up filter (the first row's
"up" is zeros, so it is filter None in effect), zlib level 6.

``convert`` gives Pillow's mode conversions for the modes the datasets and
the codec CLI ask for ("L", "RGB", "RGBA"), Pillow's integer luma
included, so a file reads to the same pixels as ``Image.open(path)
.convert(mode)``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (Pillow's mode, samples per pixel)
_COLOR = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
          6: ("RGBA", 4)}
_WRITE = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}
FILTER_UP = 2


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without IEND")


def _header(data: bytes, path: str):
    kinds = _chunks(data, path)
    kind, body = next(kinds)
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG does not start with IHDR")
    return struct.unpack(">IIBBBBB", body), kinds


def png_size(path: str) -> tuple:
    """(height, width) from the header, without reading the pixels."""
    with open(path, "rb") as f:
        (w, h, *_), _ = _header(f.read(33), path)
    return h, w


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xff


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xff


def _unfilter(raw: bytes, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:        # Sub: a running sum per sample, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> tuple:
    """(pixels, mode): pixels (H, W) uint8 for "L" and "P", else (H, W, C);
    mode as Pillow names it.  A palette image comes back as its RGBA
    colours ("RGBA") or, without ``tRNS``, its RGB colours ("RGB"); a gray
    or RGB image with a ``tRNS`` colour key comes back with the alpha the
    key gives ("LA" / "RGBA")."""
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, color, _, _, interlace), chunks = _header(data, path)
    if depth != 8 or color not in _COLOR or interlace:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}: only 8-bit, "
                         f"non-interlaced gray, RGB, palette, gray + alpha "
                         f"and RGBA are read")
    mode, ch = _COLOR[color]
    idat, plte, trns = [], None, None
    for kind, body in chunks:
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    px = _unfilter(raw, h, w * ch, ch, path).reshape(h, w, ch)
    if mode == "P":
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        alpha = np.full(len(plte), 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(plte)]
        colours = np.concatenate([plte, alpha[:, None]], axis=1)
        px = colours[px[..., 0]]
        return (px, "RGBA") if trns is not None else (px[..., :3], "RGB")
    if trns is not None and mode in ("L", "RGB"):
        key = np.frombuffer(trns, ">u2")[:ch].astype(np.uint16)
        a = np.where(np.all(px == key, axis=-1), 0, 255).astype(np.uint8)
        px = np.concatenate([px, a[..., None]], axis=-1)
        mode = "LA" if mode == "L" else "RGBA"
    return (px[..., 0] if ch == 1 and mode == "L" else px), mode


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (R 19595 + G 38470 + B 7471 + 2^15) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def convert(px: np.ndarray, mode: str, to: str) -> np.ndarray:
    """Pillow's ``Image.convert(to)`` of ``px`` in ``mode`` for to in "L",
    "RGB", "RGBA"; (H, W) for "L", else (H, W, C)."""
    if px.ndim == 2:
        px = px[..., None]
    if mode in ("L", "LA"):
        gray = px[..., 0]
        alpha = px[..., 1] if mode == "LA" else None
        rgb = np.repeat(gray[..., None], 3, axis=-1)
    elif mode in ("RGB", "RGBA"):
        rgb = px[..., :3]
        alpha = px[..., 3] if mode == "RGBA" else None
        gray = None
    else:
        raise ValueError(f"cannot convert from mode {mode!r}")
    if to == "L":
        return gray if gray is not None else _luma(rgb)
    if to == "RGB":
        return np.ascontiguousarray(rgb)
    if to == "RGBA":
        if alpha is None:
            alpha = np.full(rgb.shape[:2], 255, np.uint8)
        return np.concatenate([rgb, alpha[..., None]], axis=-1)
    raise ValueError(f"cannot convert to mode {to!r}")


def load(path: str, mode: str) -> np.ndarray:
    """``Image.open(path).convert(mode)`` as a uint8 array."""
    px, m = read_png(path)
    return convert(px, m, mode)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def encode_png(px: np.ndarray) -> bytes:
    """PNG bytes of a uint8 image: (H, W) or (H, W, 1) is "L", (H, W, 2)
    "LA", (H, W, 3) "RGB", (H, W, 4) "RGBA"."""
    px = np.asarray(px)
    if px.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8 pixels, got {px.dtype}")
    if px.ndim == 2:
        px = px[..., None]
    h, w, ch = px.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if color is None:
        raise ValueError(f"encode_png: {ch} channels")
    rows = px.reshape(h, w * ch)
    up = np.empty_like(rows)
    up[0] = rows[0]
    up[1:] = rows[1:] - rows[:-1]          # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((h, 1), FILTER_UP, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, px: np.ndarray) -> None:
    """Write ``encode_png(px)`` to ``path`` (through a temporary name)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(encode_png(px))
    os.replace(tmp, path)
