"""RGBA file codec CLI: PNGs to compressed blobs and back (port of
``rgba_tpu/cli/codec.py``: the same commands, flags, checks and printed
lines).

Single file:

    python -m rgba_tpu_torch.cli.codec encode in.png out.rgbc \\
        -r checkpoints/rgb/iter_1500000.ckpt -m checkpoints/mask/iter_600000.ckpt
    python -m rgba_tpu_torch.cli.codec decode out.rgbc recon.png -r ... -m ...

Directory (images grouped by size, each group coded in batches padded to a
shared bucket canvas, one batch's host rANS and transfers under the next
one's device work through ``PipelinedCodec(depth=2)``):

    python -m rgba_tpu_torch.cli.codec encode-dir in_dir/ out_dir/ -r ... -m ...
    python -m rgba_tpu_torch.cli.codec decode-dir out_dir/ recon_dir/ -r ... -m ...

Weights: the port's checkpoints, reference ``.pth.tar`` files or the JAX
package's ``iter_<N>.ckpt``; without them, seeded random weights.  The
models run the JAX CLI's policy (fp32, no conv kernels); lane streams
(``--stream-format lanes32``) decode on the card through the
``rans_decode`` kernel.  Any resolution: the container pads to the /64
grid and crops on decode.  Decoded PNGs hold what the JAX CLI writes,
the float decode clipped to [0, 1], times 255 and truncated
(``decode_batch(output="uint8_trunc")``, made on the card), not the
rounded ``output="uint8"`` of the library API.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data import png


def _load_codecs(rgb_path: str, mask_path: str, device=None):
    import torch
    from ..core.precision import DEFAULT_POLICY, resolve_device
    from ..eval.codec_io import CodecIO
    from ..eval.container import RGBAFileCodec
    from ..models.mask_codec import MaskCodec
    from ..models.rgb_codec import RGBCodec
    from .common import load_params_if

    dev = resolve_device(device)
    models = []
    for cls, path in ((RGBCodec, rgb_path), (MaskCodec, mask_path)):
        m = cls(policy=DEFAULT_POLICY, device=dev,
                generator=torch.Generator().manual_seed(0))
        load_params_if(path, m)
        models.append(m)
    return RGBAFileCodec(CodecIO(models[0], kind="rgb"),
                         CodecIO(models[1], kind="mask"))


def _read_rgba(path):
    arr = png.load(path, "RGBA").astype(np.float32)[None] / 255.0
    return arr[..., :3], arr[..., 3:4]


def _encode_one(codec, src, dst, bbox=False, rate_gate=False, deadzone=0.0,
                stream_format="v64"):
    rgb, alpha = _read_rgba(src)
    h, w = rgb.shape[1:3]
    blob = codec.encode_batch(rgb, alpha, bbox=bbox, rate_gate=rate_gate,
                              deadzone=deadzone,
                              stream_format=stream_format)[0]
    with open(dst, "wb") as f:
        f.write(blob)
    raw = os.path.getsize(src)
    print(f"{src} -> {dst}: {len(blob)} bytes "
          f"({len(blob) * 8 / (h * w):.4f} bpp, {raw / len(blob):.1f}x "
          f"vs source file)")


def _strip_legacy_trailer(blob, meta):
    """Older CLI builds appended an 8-byte crop trailer (the container now
    carries the original dims): honour it, so that old .rgbc files decode
    to their true size; any other trailing bytes are an error."""
    extra = len(blob) - meta["consumed"]
    if extra == 8:
        h = int.from_bytes(blob[-8:-4], "little")
        w = int.from_bytes(blob[-4:], "little")
        return blob[:-8], (h, w)
    if extra != 0:
        raise SystemExit(f"corrupt container: {extra} trailing bytes")
    return blob, None


def _decode_one(codec, src, dst, max_slices=None):
    from ..eval.container import unpack_rgba
    with open(src, "rb") as f:
        blob = f.read()
    blob, legacy_hw = _strip_legacy_trailer(blob, unpack_rgba(blob))
    rgba = codec.decode(blob, output="uint8_trunc", max_slices=max_slices)[0]
    if legacy_hw is not None:
        rgba = rgba[:legacy_hw[0], :legacy_hw[1]]
    png.write_png(dst, rgba)
    print(f"{src} -> {dst} ({rgba.shape[1]}x{rgba.shape[0]})")


def _group_by(keys_items):
    groups: dict = {}
    for k, item in keys_items:
        groups.setdefault(k, []).append(item)
    return groups


def _encode_dir(codec, src_dir, dst_dir, batch, bbox=False, rate_gate=False,
                deadzone=0.0, bucket_waste=0.3, stream_format="v64"):
    from ..eval.buckets import choose_buckets, pad_batch
    from ..eval.pipeline import PipelinedCodec
    paths = sorted(glob.glob(os.path.join(src_dir, "*.png")))
    if not paths:
        raise SystemExit(f"no .png files in {src_dir}")
    os.makedirs(dst_dir, exist_ok=True)
    # grouped by the size in each header; pixels load a chunk at a time
    groups = _group_by(((png.png_size(p), p) for p in paths))
    # each size group encodes as its own batches (the header keeps one
    # (h, w) per batch), padded to a bucket canvas that sizes share; a
    # ragged tail repeats its last image up to the batch size.  bbox mode
    # crops per batch, so it takes no bucket.
    buckets = None if bbox else choose_buckets(groups, max_waste=bucket_waste)
    pipe = PipelinedCodec(codec, depth=2)
    total_in = total_out = 0
    try:
        for size, ps in groups.items():
            chunks, real = pad_batch(ps, batch)

            def feeds(chunks=chunks):
                for ch in chunks:
                    pairs = [_read_rgba(p) for p in ch]
                    yield (np.concatenate([r for r, _ in pairs]),
                           np.concatenate([a for _, a in pairs]))

            for ch, n, blobs in zip(
                    chunks, real,
                    pipe.encode_stream(feeds(), bbox=bbox, rate_gate=rate_gate,
                                       deadzone=deadzone,
                                       stream_format=stream_format,
                                       bucket=None if buckets is None
                                       else buckets[size])):
                for p, blob in zip(ch[:n], blobs[:n]):
                    dst = os.path.join(
                        dst_dir,
                        os.path.splitext(os.path.basename(p))[0] + ".rgbc")
                    with open(dst, "wb") as f:
                        f.write(blob)
                    total_in += os.path.getsize(p)
                    total_out += len(blob)
    finally:
        pipe.close()
    if buckets is not None:
        n_buckets = len(set(buckets.values()))
        print(f"{len(groups)} distinct sizes -> {n_buckets} bucket "
              f"canvas(es)")
    print(f"{len(paths)} images -> {dst_dir}: {total_out} bytes "
          f"({total_in / max(total_out, 1):.1f}x vs source files)")


def _decode_dir(codec, src_dir, dst_dir, batch, interleave=None):
    from ..eval.buckets import pad_batch
    from ..eval.container import unpack_rgba
    from ..eval.pipeline import PipelinedCodec
    paths = sorted(glob.glob(os.path.join(src_dir, "*.rgbc")))
    if not paths:
        raise SystemExit(f"no .rgbc files in {src_dir}")
    os.makedirs(dst_dir, exist_ok=True)
    items = []
    for p in paths:
        with open(p, "rb") as f:
            blob = f.read()
        meta = unpack_rgba(blob)
        blob, legacy_hw = _strip_legacy_trailer(blob, meta)
        if legacy_hw is not None:
            raise SystemExit(
                f"{p}: legacy trailer format — decode it with the "
                f"single-file `decode` command")
        # the group key is everything decode_batch needs to agree across a
        # batch: the original dims, both z-latent canvases, the rate-gate
        # flag, the crop placement and the stream format
        items.append(((meta["height"], meta["width"],
                       meta["rgb"]["shape"],
                       None if meta["mask"] is None else meta["mask"]["shape"],
                       meta["rate_gated"], meta["crop"],
                       meta["stream_format"]),
                      (blob, p)))
    pipe = PipelinedCodec(codec, depth=2)
    n = 0
    try:
        for _, group in _group_by(items).items():
            # a ragged tail repeats its last blob up to the batch size; the
            # repeats are dropped
            chunks, real = pad_batch(group, batch)
            feeds = ([c[0] for c in ch] for ch in chunks)
            decoded = pipe.decode_stream(feeds, output="uint8_trunc",
                                         interleave=interleave)
            for ch, k, rgba in zip(chunks, real, decoded):
                for (_, p), img in zip(ch[:k], rgba[:k]):
                    dst = os.path.join(
                        dst_dir,
                        os.path.splitext(os.path.basename(p))[0] + ".png")
                    png.write_png(dst, img)
                    n += 1
    finally:
        pipe.close()
    print(f"{n} blobs -> {dst_dir}")


def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller passes another (the tests
    pass "cpu")."""
    p = argparse.ArgumentParser(description="rgba_tpu file codec")
    p.add_argument("command",
                   choices=["encode", "decode", "encode-dir", "decode-dir"])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-r", "--rgb-model", default="", help="RGB codec weights")
    p.add_argument("-m", "--mask-model", default="", help="mask codec weights")
    p.add_argument("-b", "--batch", type=int, default=8,
                   help="batch size for *-dir modes")
    p.add_argument("--bbox", action="store_true",
                   help="crop to the alpha bounding box before coding "
                        "(union bbox per batch in encode-dir); skips "
                        "bits AND compute for transparent borders")
    p.add_argument("--rate-gate", action="store_true",
                   help="skip entropy-coding RGB latent cells in fully-"
                        "transparent regions (arbitrary alpha shapes; "
                        "composes with --bbox)")
    p.add_argument("--deadzone", type=float, default=0.0,
                   help="widen the RGB quantizer's zero bin by this much "
                        "(runtime rate control from one model: more "
                        "deadzone = fewer bits, lower PSNR; streams stay "
                        "decoder-compatible). Try 0.1-0.4")
    p.add_argument("--bucket-waste", type=float, default=0.3,
                   help="encode-dir shape-bucket ladder: fold a size into "
                        "a larger bucket canvas when the extra transparent-"
                        "padded area stays within this fraction. 0 = exact "
                        "/64 padding only")
    p.add_argument("--interleave", type=int, default=None,
                   help="decode-dir: split each batch into this many "
                        "sub-chains driven together (bit-identical to "
                        "serial). Default: auto, 2 for even batches 4-8, "
                        "else 1")
    p.add_argument("--stream-format", choices=["v64", "lanes32"],
                   default="v64",
                   help="encode formats: v64 = host-decoded 64-bit rANS "
                        "(default, smallest); lanes32 = lane streams "
                        "(container v3) decoded wholly on the card with no "
                        "per-slice host round trips. decode auto-detects "
                        "either")
    p.add_argument("--preview-slices", type=int, default=None,
                   help="decode only the first K of the 10 RGB latent "
                        "slices and mean-fill the rest, a progressive "
                        "preview from the SAME blob (decode command only)")
    args = p.parse_args(argv)

    if args.preview_slices is not None:
        if args.command != "decode":
            p.error("--preview-slices only applies to the `decode` command")
        if not 0 <= args.preview_slices <= 10:
            p.error("--preview-slices must be in [0, 10] "
                    f"(got {args.preview_slices})")
    if args.interleave is not None:
        if args.command != "decode-dir":
            p.error("--interleave only applies to the `decode-dir` command")
        if args.interleave < 1:
            p.error(f"--interleave must be >= 1 (got {args.interleave})")

    codec = _load_codecs(args.rgb_model, args.mask_model, device)
    try:
        if args.command == "encode":
            _encode_one(codec, args.input, args.output, bbox=args.bbox,
                        rate_gate=args.rate_gate, deadzone=args.deadzone,
                        stream_format=args.stream_format)
        elif args.command == "decode":
            _decode_one(codec, args.input, args.output,
                        max_slices=args.preview_slices)
        elif args.command == "encode-dir":
            _encode_dir(codec, args.input, args.output, args.batch,
                        bbox=args.bbox, rate_gate=args.rate_gate,
                        deadzone=args.deadzone,
                        bucket_waste=args.bucket_waste,
                        stream_format=args.stream_format)
        else:
            _decode_dir(codec, args.input, args.output, args.batch,
                        interleave=args.interleave)
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()


if __name__ == "__main__":
    main()
