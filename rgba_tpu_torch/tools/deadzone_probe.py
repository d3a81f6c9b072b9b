"""The deadzone's RD curve on trained weights: rate control at serving
time, from one model.

Encodes one Kodak-shaped batch (16 x 512x768, seed 1) through the real
container at several deadzone widths and reports the bpp of the bytes
and the masked PSNR of each decode.  The reference needs a model trained
per rate point; this knob moves along the RD curve with streams any
decoder reads.  The rate must not rise as the zero bin widens.

    python -m rgba_tpu_torch.tools.deadzone_probe --outdir build/proofs
"""

from __future__ import annotations

import json
import os

from ..data.synthetic import synthetic_rgba_batch
from . import _common as c

BATCH, HW = 16, (512, 768)
DEADZONES = (0.0, 0.1, 0.2, 0.3, 0.5)


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--lam", type=int, default=4096)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    codec = c.trained_codec(args.lam, args.outdir, device)
    d = synthetic_rgba_batch(BATCH, *HW, seed=1)
    image, alpha = d["image"], d["alpha"]
    npix = BATCH * HW[0] * HW[1]
    curve = []
    try:
        for dz in DEADZONES:
            blobs = codec.encode_batch(image, alpha, deadzone=dz)
            rgba = codec.decode_batch(blobs)
            point = {"dz": dz,
                     "bpp": round(sum(len(b) for b in blobs) * 8 / npix, 5),
                     "psnr_db": round(c.masked_psnr(image, rgba[..., :3],
                                                    alpha), 4)}
            curve.append(point)
            print(json.dumps(point), flush=True)
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    out = {"lam": args.lam, "deadzone_curve": curve,
           "device": c.card() if device.type == "cuda" else "cpu"}
    with open(os.path.join(args.outdir, "deadzone.json"), "w") as f:
        json.dump(out, f, indent=2)
    bpps = [p["bpp"] for p in curve]
    if not all(b2 <= b1 for b1, b2 in zip(bpps, bpps[1:])):
        raise AssertionError(f"the rate rose with the deadzone: {bpps}")
    print("deadzone_probe OK", flush=True)
    return out


if __name__ == "__main__":
    main()
