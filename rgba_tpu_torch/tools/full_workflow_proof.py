"""The user's workflow on the card with trained weights: train, write
checkpoints, reload them, and evaluate with the real bitstream.

Random weights exercise the machinery with degenerate entropy tables;
this run pins that trained priors give sane real-codec numbers: both
codecs trained (lambda 1024, bf16, the four kernels on; a model already
trained to ``--steps`` under ``--outdir``, such as the RD sweep's
``mask`` and ``rgb_1024``, is reused), their checkpoints loaded into the
fp32 codec through ``load_checkpoint``, then
``evaluate_kodak(real_codec=True)`` over a synthetic tree of 3 images at
512x768.  Checks (``check_point``): real bpp near the estimate
(0.5 x bpp < real < 1.5 x bpp + 0.1), and the decode against the forward
by ``eval.kodak.hold_codec_err``: codec_err below the JAX tool's 6e-3,
and at most 1e-5 or each image's decoded RGB within one 8-bit level of the
forward on the container's inputs and its decoded alpha within a rounded
tie of the eval step's.

    python -m rgba_tpu_torch.tools.full_workflow_proof --steps 1200 \\
        --outdir build/proofs
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..eval.kodak import hold_codec_err
from . import _common as c

IMAGES = 3


def check_point(codec, tree: str, point: dict):
    """The trained pair's real-codec point over ``tree``: finite averages,
    the real rate in its band around the estimate, and ``hold_codec_err``.
    Returns the decode's per-image parts (None when codec_err is at most
    1e-5); raises AssertionError naming what failed."""
    if not all(np.isfinite(v) for v in point.values()):
        raise AssertionError(f"an average is not finite: {point}")
    if not (point["real_bpp"] > 0
            and 0.5 * point["bpp"] < point["real_bpp"]
            < 1.5 * point["bpp"] + 0.1):
        raise AssertionError(f"real bpp {point['real_bpp']} outside its band "
                             f"around the estimate {point['bpp']}")
    return hold_codec_err(codec, tree, point["codec_err"])


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--steps", type=int, default=1200)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    get_data = c.lazy_data(device)

    ck = {name: c.latest_checkpoint(c.train_one(
              name, kind, c.MASK_LAMBDA, args.steps, args.outdir,
              data=get_data)["ckdir"])
          for name, kind in (("mask", "mask"), ("rgb_1024", "rgb"))}
    del get_data
    tree = c.kodak_tree(args.outdir, IMAGES)
    codec = c.make_codec(device)
    try:
        point = c.eval_point(codec, tree, ck["rgb_1024"], ck["mask"])
        print(json.dumps(point), flush=True)
        parts = check_point(codec, tree, point)
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    out = {"point": point, "codec_err_parts": parts,
           "device": c.card() if device.type == "cuda" else "cpu"}
    with open(os.path.join(args.outdir, "full_workflow.json"), "w") as f:
        json.dump(out, f, indent=2)
    print("full_workflow_proof OK", flush=True)
    return out


if __name__ == "__main__":
    main()
