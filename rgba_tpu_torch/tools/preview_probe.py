"""The progressive-preview ladder on trained weights: decode latency and
masked PSNR against the number k of RGB slices decoded, from one
``lanes32`` blob per image.

One Kodak-shaped batch (16 x 512x768, seed 1) is encoded once as lane
streams (container version 3) and decoded on the card
(``decompress_device``: the ``rans_decode`` kernel, one launch per
segment, then the mean fill of the slices past k) at k = 10, 6, 3, 1, 0.
Checks: a re-encode is byte-identical (the lane budgets were sized at
random weights' 21 bpp), k = 10 is the full decode bit for bit, and on
the card a decode launches ``rans_decode`` 1 + k times for the RGB
stream and 1 + 5 for the mask's.  The latency is reported, not held (the
JAX tool asserts that k = 0 decodes faster than k = 10): on this path a
preview gives no speed benefit, since the decode segments take ~0.1 ms
each on the card and the slice-stat convolutions that the mean fill needs
run for every slice whatever k.  Skipping them past k is a ROADMAP item.

    python -m rgba_tpu_torch.tools.preview_probe --outdir build/proofs
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..data.synthetic import synthetic_rgba_batch
from . import _common as c

BATCH, HW = 16, (512, 768)
KS = (10, 6, 3, 1, 0)
REPS = 5
MASK_SEGMENTS = 6      # the mask stream's z and 5 y slices


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--lam", type=int, default=4096)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    codec = c.trained_codec(args.lam, args.outdir, device)
    d = synthetic_rgba_batch(BATCH, *HW, seed=1)
    image, alpha = d["image"], d["alpha"]
    ladder = []
    try:
        blobs = codec.encode_batch(image, alpha, stream_format="lanes32")
        if codec.encode_batch(image, alpha, stream_format="lanes32") != blobs:
            raise AssertionError("a lanes32 re-encode differs")
        bpp = sum(len(b) for b in blobs) * 8 / (BATCH * HW[0] * HW[1])
        print(json.dumps({"lam": args.lam, "bpp": round(bpp, 5),
                          "batch": BATCH}), flush=True)
        for k in KS:                      # warm-up of every k
            codec.decode_batch(blobs, max_slices=k)
        full = None
        for k in KS:
            c.reset_launches()
            t0 = time.perf_counter()
            for _ in range(REPS):
                rgba = codec.decode_batch(blobs, max_slices=k)
            dt = (time.perf_counter() - t0) / REPS
            if k == 10:
                full = rgba
            launches = c.launches()["rans_decode"] // REPS
            if device.type == "cuda" and launches != 1 + k + MASK_SEGMENTS:
                raise AssertionError(f"k = {k}: {launches} rans_decode "
                                     f"launches a decode")
            point = {"k": k, "decode_s_per_image": round(dt / BATCH, 5),
                     "images_per_sec": round(BATCH / dt, 3),
                     "rans_decode_launches": launches,
                     "masked_psnr_db": round(
                         c.masked_psnr(image, rgba[..., :3], alpha), 3)}
            ladder.append(point)
            print(json.dumps(point), flush=True)
        if not np.array_equal(full, codec.decode_batch(blobs)):
            raise AssertionError("k = 10 differs from the full decode")
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    out = {"lam": args.lam, "bpp": bpp, "preview_ladder": ladder,
           "device": c.card() if device.type == "cuda" else "cpu"}
    with open(os.path.join(args.outdir, "preview.json"), "w") as f:
        json.dump(out, f, indent=2)
    print("preview_probe OK", flush=True)
    return out


if __name__ == "__main__":
    main()
