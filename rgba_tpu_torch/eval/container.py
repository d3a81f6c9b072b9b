"""Single-file RGBA bitstream container (port of ``rgba_tpu/eval/container.py``).

One self-describing blob holds both codecs' streams.  Layout
(little-endian), the byte contract shared with the JAX package:

  magic  b"RGBA"            4 bytes
  version u8                1; 2 when the RGB stream is rate-gated; 3 for
                            lane streams
  flags   u8                bit0: mask stream present (0 => opaque alpha)
                            bit1: crop placement present (alpha-bbox mode)
                            bit2: RGB stream rate-gated (gate bitmap ships
                            as a 5th section)
                            bit3: lane streams (version 3)
                            bit4: RGB stream written by TCM (the mixed
                            Transformer-CNN codec, models/tcm.py), not by
                            the paper's RGB codec
  height  u32, width u32    coded image size (before the /64 padding)
  zh, zw  u16 x2            RGB z-latent spatial shape
  mzh,mzw u16 x2            mask z-latent spatial shape (0 if no mask)
  [crop]  u32 x4            only with flags bit1: canvas_h, canvas_w, y0, x0
  then 4 length-prefixed (u32) sections: rgb_y, rgb_z, mask_y, mask_z
  [gate]  5th section, only with flags bit2: zlib(packbits(gate)) over the
          (8*zh, 8*zw) alive bitmap, row-major
  version 3: each codec's y section is "u16 lane count || lane stream"
  and its z section is empty.

``pack_rgba``/``unpack_rgba`` handle every version, and so does
``RGBAFileCodec``: it encodes and decodes versions 1 and 2 through the
host-coded v64 chains (a version-2 blob decodes with the gate it ships,
never one derived again), and version 3 through ``decompress_device``,
where the card decodes the lane streams of both codecs itself.
``decode(max_slices=k)`` gives the progressive preview of the RGB stream.
A codec whose ``rgb_io`` holds TCM codes opaque images only (no mask
stream, ``mask_io`` may be None) and sets flags bit4; a decoder refuses a
blob whose bit4 does not name its own RGB model.
``encode_batch(bucket=)`` codes on a larger /64 canvas (``eval/buckets.py``)
and ``decode_batch(interleave=)`` cuts the RGB chain into sub-batch chains
(``CodecIO.decompress_chains``); neither changes the format.
Under a profiler each ``encode_batch`` / ``decode_batch`` call is a root
span (``container.encode_batch`` / ``container.decode_batch``,
``utils/trace.py``) over the codecs' fetch, upload and rANS spans.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..ops.morphology import constraint_rgb
from ..utils.trace import span
from .codec_io import drive_chains

_MAGIC = b"RGBA"
# decode_batch's output modes: the float decode, its rounded 8 bits, and
# the codec CLIs' truncated 8 bits
OUTPUTS = ("float32", "uint8", "uint8_trunc")


def pack_rgba(height: int, width: int, rgb: dict, mask: dict | None,
              crop: tuple | None = None, tcm: bool = False) -> bytes:
    """crop, when given, is (canvas_h, canvas_w, y0, x0): the coded
    height x width region is a window into a larger transparent canvas.
    An rgb dict with a "gate" bitmap makes a version-2 container, one with
    format "lanes32" a version-3 container; tcm: the RGB stream is TCM's
    (flags bit4)."""
    gate = rgb.get("gate")
    lanes32 = rgb.get("format") == "lanes32"
    flags = ((1 if mask is not None else 0) | (2 if crop is not None else 0)
             | (4 if gate is not None else 0) | (8 if lanes32 else 0)
             | (16 if tcm else 0))
    version = 3 if lanes32 else (2 if gate is not None else 1)
    zh, zw = rgb["shape"]
    mzh, mzw = mask["shape"] if mask else (0, 0)
    head = struct.pack("<4sBBIIHHHH", _MAGIC, version, flags, height, width,
                       zh, zw, mzh, mzw)
    if crop is not None:
        head += struct.pack("<IIII", *crop)
    if lanes32:
        def lane_sec(c):
            return struct.pack("<H", c["lanes"]) + c["stream"]
        if mask is not None and mask.get("format") != "lanes32":
            raise ValueError("version-3 containers need both codecs in lane "
                             "format")
        sections = [lane_sec(rgb), b""]
        sections += [lane_sec(mask), b""] if mask else [b"", b""]
    else:
        sections = [rgb["strings"][0], rgb["strings"][1]]
        sections += [mask["strings"][0], mask["strings"][1]] if mask \
            else [b"", b""]
    if gate is not None:
        bits = np.asarray(gate, bool).reshape(zh * 8, zw * 8)
        sections.append(zlib.compress(np.packbits(bits).tobytes()))
    body = b"".join(struct.pack("<I", len(s)) + s for s in sections)
    return head + body


def unpack_rgba(blob: bytes) -> dict:
    """Parse a container blob.  The returned dict includes "consumed", the
    exact byte length of the container, so callers can detect trailing
    data."""
    head_len = struct.calcsize("<4sBBIIHHHH")
    if len(blob) < head_len:
        raise ValueError("not an rgba_tpu container (truncated header)")
    magic, ver, flags, h, w, zh, zw, mzh, mzw = struct.unpack(
        "<4sBBIIHHHH", blob[:head_len])
    if magic != _MAGIC or ver not in (1, 2, 3):
        raise ValueError("not an rgba_tpu container")
    rate_gated = bool(flags & 4)
    lanes32 = bool(flags & 8)
    if ver < 3 and rate_gated != (ver == 2):
        raise ValueError("corrupt rgba_tpu container (gate flag/version)")
    if lanes32 != (ver == 3):
        raise ValueError("corrupt rgba_tpu container (lane flag/version)")
    off = head_len
    crop = None
    if flags & 2:
        if off + 16 > len(blob):
            raise ValueError("truncated rgba_tpu container (crop fields)")
        crop = struct.unpack("<IIII", blob[off:off + 16])
        off += 16
    sections = []
    for _ in range(5 if rate_gated else 4):
        if off + 4 > len(blob):
            raise ValueError("truncated rgba_tpu container (section header)")
        (ln,) = struct.unpack("<I", blob[off:off + 4])
        off += 4
        if off + ln > len(blob):
            raise ValueError("truncated rgba_tpu container (section body)")
        sections.append(blob[off:off + ln])
        off += ln

    def lane_sec(data, shape):
        if len(data) < 2:
            raise ValueError("truncated rgba_tpu container (lane stream)")
        (lanes,) = struct.unpack("<H", data[:2])
        return {"format": "lanes32", "lanes": lanes, "stream": data[2:],
                "shape": shape}

    out = {
        "height": h, "width": w, "consumed": off, "crop": crop,
        "rate_gated": rate_gated,
        "stream_format": "lanes32" if lanes32 else "v64",
        "rgb": lane_sec(sections[0], (zh, zw)) if lanes32 else
               {"strings": [sections[0], sections[1]], "shape": (zh, zw)},
        "mask": None,
    }
    if rate_gated:
        lh, lw = zh * 8, zw * 8
        bits = np.unpackbits(
            np.frombuffer(zlib.decompress(sections[4]), np.uint8))
        if bits.size < lh * lw:
            raise ValueError("corrupt rgba_tpu container (gate bitmap)")
        out["rgb"]["gate"] = bits[:lh * lw].reshape(lh, lw, 1).astype(bool)
    if flags & 16:
        out["tcm"] = True     # the JAX package's containers never set it
    if flags & 1:
        out["mask"] = lane_sec(sections[2], (mzh, mzw)) if lanes32 else \
            {"strings": [sections[2], sections[3]], "shape": (mzh, mzw)}
    return out


class RGBAFileCodec:
    """End-to-end RGBA file encode/decode through the two codecs' CodecIO.

    Encode: compress the alpha with the mask codec and decode it again (the
    decoder only ever sees the decoded alpha), round it to 8 bits, clean it
    with constraint_rgb, and gate the RGB codec with it.  Decode: the mask
    and RGB slice chains run together (``drive_chains``), then the alpha is
    rebuilt the same way and gates the RGB synthesis, so encoder and
    decoder agree on it.

    An ``rgb_io`` over TCM (``models/tcm.py``) codes opaque images only:
    ``mask_io`` may be None, a non-opaque image raises ValueError, and the
    decoded alpha is 1 everywhere.
    """

    def __init__(self, rgb_io, mask_io=None):
        self.rgb_io = rgb_io
        self.mask_io = mask_io
        self.device = rgb_io.device
        self.tcm = getattr(rgb_io, "architecture", "paper") == "tcm"

    def _check_model(self, metas):
        """Each blob's RGB stream must be of this codec's RGB model."""
        for i, m in enumerate(metas):
            tcm = m.get("tcm", False)
            if tcm != self.tcm:
                names = ("the paper's RGB codec", "TCM")
                raise ValueError(
                    f"blob {i}: its RGB stream was written by "
                    f"{names[tcm]}, this decoder holds "
                    f"{names[self.tcm]}")

    def encode(self, image: np.ndarray, alpha: np.ndarray,
               bbox: bool = False, rate_gate: bool = False,
               deadzone: float = 0.0, stream_format: str = "v64") -> bytes:
        """image: (1, H, W, 3); alpha: (1, H, W, 1); float32 in [0, 1] or
        uint8."""
        return self.encode_batch(image, alpha, bbox=bbox, rate_gate=rate_gate,
                                 deadzone=deadzone,
                                 stream_format=stream_format)[0]

    def decode(self, blob: bytes, output: str = "float32",
               max_slices: int | None = None) -> np.ndarray:
        """Returns (1, H, W, 4) RGBA; max_slices=k decodes a preview (see
        ``decode_batch``)."""
        return self.decode_batch([blob], output=output, max_slices=max_slices)

    def _recon_alpha(self, rm_sub, b, h, w, hp, wp, rows):
        """The decoded alphas of images ``rows`` (8-bit, constraint_rgb)
        scattered into a (b, hp, wp, 1) canvas whose other images are
        opaque inside (h, w) and transparent in the padding."""
        rm = torch.zeros((b, hp, wp, 1), device=self.device)
        rm[:, :h, :w] = 1.0
        if rows:
            rm_s = torch.round(torch.clamp(rm_sub, 0, 1) * 255.0) / 255.0
            rm_s = constraint_rgb(rm_s.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            with span("container.upload"):
                at = torch.tensor(rows, device=self.device)
            rm[at] = rm_s
        return rm

    def encode_batch(self, images: np.ndarray, alphas: np.ndarray,
                     bbox: bool = False, rate_gate: bool = False,
                     deadzone: float = 0.0,
                     bucket: tuple[int, int] | None = None,
                     stream_format: str = "v64") -> list[bytes]:
        """Compress B same-shaped RGBA images, one batched device pass per
        stage; returns one container per image.  uint8 inputs are turned
        into floats on the card.  Any H, W: the images are padded to the
        /64 grid with transparent pixels, and decode crops back.  bbox=True
        crops the batch to the union alpha bounding box first; the
        container records the canvas and the offset.  rate_gate=True codes
        no RGB latent where the decoded alpha's /8 pool is 0 and ships the
        gate (version 2); deadzone > 0 widens the RGB quantizer's zero bin
        (no header flag: any decoder reads it); stream_format="lanes32"
        writes lane streams for both codecs (version 3), decoded on the
        card.  bucket=(bh, bw) pads to that canvas instead of the minimal
        /64 one (after the bbox crop; ``eval/buckets.py`` picks a ladder):
        it must be /64-aligned and cover the minimal canvas, else
        ValueError.  The header keeps the original (h, w), so a bucketed
        blob is the same container version and decodes to the same size."""
        with span("container.encode_batch"):
            images, alphas = np.asarray(images), np.asarray(alphas)
            b, h, w = images.shape[:3]
            crop = None
            if bbox:
                vis_y = np.any(alphas > 0, axis=(0, 2, 3))
                vis_x = np.any(alphas > 0, axis=(0, 1, 3))
                if vis_y.any() and not (vis_y.all() and vis_x.all()):
                    y0, y1 = np.flatnonzero(vis_y)[[0, -1]]
                    x0, x1 = np.flatnonzero(vis_x)[[0, -1]]
                    if (y1 - y0 + 1, x1 - x0 + 1) != (h, w):
                        crop = (h, w, int(y0), int(x0))
                        images = images[:, y0:y1 + 1, x0:x1 + 1]
                        alphas = alphas[:, y0:y1 + 1, x0:x1 + 1]
                        h, w = images.shape[1:3]
            one = 255 if alphas.dtype == np.uint8 else 1.0
            # opacity is judged on the original alpha: an opaque image ships no
            # mask stream, and the decoder rebuilds ones inside (h, w)
            non_op = [i for i in range(b) if not np.all(alphas[i] == one)]
            if non_op and (self.tcm or self.mask_io is None):
                raise ValueError(f"image {non_op[0]} is not opaque: a codec "
                                 f"{'over TCM' if self.tcm else 'without a mask codec'}"
                                 f" codes opaque images only")
            hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
            if bucket is not None:
                bh, bw = int(bucket[0]), int(bucket[1])
                if bh < hp or bw < wp or bh % 64 or bw % 64:
                    raise ValueError(f"bucket {tuple(bucket)} must be "
                                     f"/64-aligned and cover the minimal "
                                     f"padded canvas {(hp, wp)}")
                hp, wp = bh, bw
            if (hp, wp) != (h, w):
                pad = ((0, 0), (0, hp - h), (0, wp - w), (0, 0))
                images, alphas = np.pad(images, pad), np.pad(alphas, pad)

            lanes32 = stream_format == "lanes32"
            with torch.inference_mode():
                x_dev = self.rgb_io._nchw(images).permute(0, 2, 3, 1)
                a_dev = self.rgb_io._nchw(alphas).permute(0, 2, 3, 1)
                mask_comps: dict[int, dict] = {}
                rm_sub = None
                if non_op:
                    comps = self.mask_io.compress_batch(
                        mask=a_dev[non_op], stream_format=stream_format)
                    rm_sub = (self.mask_io.decompress_device(comps) if lanes32
                              else self.mask_io.decompress_batch(comps,
                                                                 device=True))
                    mask_comps = dict(zip(non_op, comps))
                recon = self._recon_alpha(rm_sub, b, h, w, hp, wp, non_op)
                masked = torch.where(recon > 0, x_dev, recon)
            rgb_comps = self.rgb_io.compress_batch(
                image=masked, mask=recon, rate_gate=rate_gate,
                deadzone=deadzone, stream_format=stream_format)
            return [pack_rgba(h, w, rgb_comps[i], mask_comps.get(i), crop,
                              self.tcm) for i in range(b)]

    def decode_batch(self, blobs: list[bytes], output: str = "float32",
                     max_slices: int | None = None,
                     interleave: int | None = None) -> np.ndarray:
        """Decode B same-shaped blobs of one container version; returns
        (B, H, W, 4) RGBA, float32 in [0, 1] or, with output="uint8",
        8-bit (the float decode times 255, rounded, as the JAX package's
        ``decode_batch``), or, with output="uint8_trunc", the 8-bit pixels
        the codec CLIs write (clipped to [0, 1], times 255, truncated; the
        JAX CLI's PNGs), made on the card so the fetch stays 8-bit.
        Versions 1 and 2 run the mask and RGB slice chains together
        (``drive_chains``), the RGB chain of a version-2 blob with the gate
        it ships; version 3 decodes both codecs' lane streams on the card
        (``decompress_device``).  max_slices=k decodes the first k of the
        RGB codec's slices and mean-fills the rest; the alpha is always
        decoded in full (the RGB synthesis needs the exact alpha the
        encoder used).  interleave=G cuts the RGB chain of versions 1 and
        2 into G sub-batch chains driven with the mask chain
        (``CodecIO.decompress_chains``; None picks 2 for batches of 4, 6
        and 8); the result is the same."""
        with span("container.decode_batch"):
            if output not in OUTPUTS:
                raise ValueError(f"output must be one of {OUTPUTS}, got "
                                 f"{output!r}")
            metas = [unpack_rgba(blob) for blob in blobs]
            self._check_model(metas)
            h, w = metas[0]["height"], metas[0]["width"]
            crop = metas[0]["crop"]
            if any((m["height"], m["width"], m["crop"]) != (h, w, crop)
                   for m in metas):
                raise ValueError("decode_batch requires same-sized images "
                                 "with identical crop placements")
            kind = (metas[0]["stream_format"], metas[0]["rate_gated"])
            if any((m["stream_format"], m["rate_gated"]) != kind
                   for m in metas):
                raise ValueError("decode_batch requires blobs of one "
                                 "container version")
            b = len(metas)
            zh, zw = metas[0]["rgb"]["shape"]
            hp, wp = zh * 64, zw * 64

            with_mask = [i for i, m in enumerate(metas)
                         if m["mask"] is not None]
            rgbs = [m["rgb"] for m in metas]
            masks = [metas[i]["mask"] for i in with_mask]
            if kind[0] == "lanes32":
                rm_sub = (self.mask_io.decompress_device(masks)
                          if with_mask else None)
                with torch.inference_mode():
                    recon = self._recon_alpha(rm_sub, b, h, w, hp, wp,
                                              with_mask)
                rgb = self.rgb_io.decompress_device(rgbs, mask=recon,
                                                    max_slices=max_slices)
            else:
                gate = (np.stack([r["gate"] for r in rgbs]) if kind[1]
                        else None)
                chains = self.rgb_io.decompress_chains(
                    rgbs, gate_host=gate, max_slices=max_slices,
                    interleave=interleave)
                n_rgb = len(chains)
                if with_mask:
                    chains.append(self.mask_io.decompress_chain(masks))
                outs = drive_chains(chains)
                rm_sub = (self.mask_io.decode_image(outs[n_rgb], device=True)
                          if with_mask else None)
                with torch.inference_mode():
                    recon = self._recon_alpha(rm_sub, b, h, w, hp, wp,
                                              with_mask)
                    y_rgb = outs[0] if n_rgb == 1 else torch.cat(outs[:n_rgb])
                rgb = self.rgb_io.decode_image(y_rgb, mask=recon, device=True)
            with torch.inference_mode():
                rgba = torch.cat([rgb[:, :h, :w], recon[:, :h, :w]], dim=-1)
                if output == "uint8":
                    rgba = torch.round(rgba * 255.0).to(torch.uint8)
                elif output == "uint8_trunc":
                    rgba = (rgba.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
                with span("container.fetch"):
                    out = rgba.cpu().numpy()
            if crop is not None:
                ch, cw, y0, x0 = crop
                canvas = np.zeros((b, ch, cw, 4), out.dtype)
                canvas[:, y0:y0 + h, x0:x0 + w] = out
                return canvas
            return out
