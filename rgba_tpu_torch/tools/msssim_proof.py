"""MS-SSIM-distortion training proof on the card.

The reference carries masked MS-SSIM as a commented-out distortion; the
port exposes it as ``distortion="msssim"``.  This trains the RGB codec
with that loss at lambda 64 (the scale at which 1 - MS-SSIM trades
against bpp), beside the RD sweep's mask codec, evaluates it and the
sweep's mse lambda-4096 model over the same synthetic Kodak tree
(estimated rates, as the JAX tool), and checks the point of the option:
per bit, the MS-SSIM-trained model has the lower MS-SSIM deficit,
(1 - MS-SSIM) * bpp.

Needs the sweep's ``mask_ck`` and ``rgb_4096_ck`` under ``--outdir``
(``rd_sweep_proof``); a model already trained to ``--steps`` is reused.

    python -m rgba_tpu_torch.tools.msssim_proof --steps 1200 \\
        --outdir build/proofs
"""

from __future__ import annotations

import json
import os

from . import _common as c


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--steps", type=int, default=2400)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    ck = {}
    for name in ("mask", "rgb_4096"):
        ck[name] = c.latest_checkpoint(os.path.join(args.outdir,
                                                    f"{name}_ck"))
        if ck[name] is None:
            raise FileNotFoundError(f"no {name} checkpoint under "
                                    f"{args.outdir}: run rd_sweep_proof first")
    run = c.train_one("msssim", "rgb", c.MSSSIM_LAMBDA, args.steps,
                      args.outdir, "msssim",
                      data=c.lazy_data(device))
    ck["msssim"] = c.latest_checkpoint(run["ckdir"])
    tree = c.kodak_tree(args.outdir)
    codec = c.make_codec(device)
    points = {}
    try:
        for name, rgb in (("mse_4096", ck["rgb_4096"]),
                          (f"msssim_{c.MSSSIM_LAMBDA}", ck["msssim"])):
            points[name] = c.eval_point(codec, tree, rgb, ck["mask"],
                                        real_codec=False)
            print(f"{name}: {json.dumps(points[name])}", flush=True)
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    ms, mse = points[f"msssim_{c.MSSSIM_LAMBDA}"], points["mse_4096"]
    cost = {"msssim_trained": (1 - ms["msssim"]) * ms["bpp"],
            "mse_trained": (1 - mse["msssim"]) * mse["bpp"]}
    print(json.dumps({"msssim_deficit_x_bpp": cost}), flush=True)
    with open(os.path.join(args.outdir, "msssim_proof.json"), "w") as f:
        json.dump({"points": points, "msssim_deficit_x_bpp": cost,
                   "device": c.card() if device.type == "cuda" else "cpu"},
                  f, indent=2)
    if not cost["msssim_trained"] < cost["mse_trained"]:
        raise AssertionError(f"the MS-SSIM-trained model does not win per "
                             f"bit: {cost}")
    print("msssim_proof OK", flush=True)
    return points


if __name__ == "__main__":
    main()
