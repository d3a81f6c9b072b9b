"""The alpha rate gate with the real bitstream, on trained weights.

Runs the container (mask stream, then the RGB stream gated by the decoded
alpha) on one Kodak-shaped batch (16 x 512x768, seed 1) with and without
the rate gate: the bpp of the bytes, the masked PSNR of each decode, the
recon delta between the two on visible pixels, and the round trip's
images/s (encode and decode, after a warm-up).  A gated re-encode must be
byte-identical (the lane and word budgets were sized at random weights'
21 bpp; trained weights code a few tenths of a bit).

    python -m rgba_tpu_torch.tools.rate_gate_codec_probe --outdir build/proofs
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..data.synthetic import synthetic_rgba_batch
from . import _common as c

BATCH, HW = 16, (512, 768)


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--lam", type=int, default=4096)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    codec = c.trained_codec(args.lam, args.outdir, device)
    d = synthetic_rgba_batch(BATCH, *HW, seed=1)
    image, alpha = d["image"], d["alpha"]
    npix = BATCH * HW[0] * HW[1]
    out, recon = {}, {}
    try:
        for name, gate in (("plain", False), ("rate_gate", True)):
            codec.decode_batch(codec.encode_batch(image, alpha,
                                                  rate_gate=gate))
            c.reset_launches()
            t0 = time.perf_counter()
            blobs = codec.encode_batch(image, alpha, rate_gate=gate)
            t1 = time.perf_counter()
            rgba = codec.decode_batch(blobs)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = c.launches()
            again = codec.encode_batch(image, alpha, rate_gate=gate)
            if again != blobs:
                raise AssertionError(f"{name}: a re-encode differs")
            recon[name] = rgba
            out[name] = {
                "bpp": round(sum(len(b) for b in blobs) * 8 / npix, 5),
                "psnr_db": round(c.masked_psnr(image, rgba[..., :3], alpha),
                                 4),
                "encode_img_per_s": round(BATCH / (t1 - t0), 3),
                "decode_img_per_s": round(BATCH / (t2 - t1), 3),
                "roundtrip_img_per_s": round(BATCH / (t2 - t0), 3),
                "launches_per_round_trip": launches}
            print(name, json.dumps(out[name]), flush=True)
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    diff = np.abs(recon["rate_gate"] - recon["plain"])[..., :3] * (alpha > 0)
    out["summary"] = {
        "real_rate_saving_pct": round(
            100 * (1 - out["rate_gate"]["bpp"] / out["plain"]["bpp"]), 2),
        "d_psnr_db": round(out["rate_gate"]["psnr_db"]
                           - out["plain"]["psnr_db"], 4),
        "max_visible_recon_delta": round(float(diff.max()), 5)}
    out.update(lam=args.lam, batch=BATCH,
               device=c.card() if device.type == "cuda" else "cpu")
    print(json.dumps(out["summary"]), flush=True)
    with open(os.path.join(args.outdir, "rate_gate_codec.json"), "w") as f:
        json.dump(out, f, indent=2)
    print("rate_gate_codec_probe OK", flush=True)
    return out


if __name__ == "__main__":
    main()
