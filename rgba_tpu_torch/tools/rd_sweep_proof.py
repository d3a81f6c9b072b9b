"""Multi-lambda rate-distortion sweep proof on the card.

The reference ships lambda-sweep configs (examples/*.json) whose point is
a monotone RD curve: a higher lambda buys more bits and a higher PSNR
(the RD loss lambda * 255^2 * MSE + bpp).  This trains the mask codec
once (lambda 1024) and the RGB codec at lambda 256, 1024 and 4096 (and,
with ``--steps-msssim``, the MS-SSIM-distortion model at lambda 64),
evaluates each RGB model with the real bitstream on one synthetic Kodak
tree (4 images, 512x768), and checks the RD contract:

* the real rate is strictly monotone in lambda;
* each model's real bpp is within 15% of its estimate (the eval forward
  gates with the ground-truth alpha, the container with the decoded one:
  an undertrained mask codec gates other windows);
* PSNR monotone in lambda: a warning at partial budgets, enforced with
  ``--strict``.

Every model resumes from its latest checkpoint (``_common.train_one``), is
evaluated right after it trains, and its point lands in
``rd_points.json`` and ``QUALITY.json`` at once; a model whose point is
recorded at its checkpoint's step is not evaluated again.  All points
share one ``RGBAFileCodec``.

    python -m rgba_tpu_torch.tools.rd_sweep_proof --steps-mask 1200 \\
        --steps-rgb 1200 --steps-msssim 1200 --outdir build/proofs
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import _common as c


def sweep_runs(steps_mask: int, steps_rgb: int, steps_msssim: int) -> dict:
    """{name: (kind, lambda, steps, distortion)}."""
    runs = {"mask": ("mask", c.MASK_LAMBDA, steps_mask, "mse")}
    for lam in c.LAMBDAS:
        runs[f"rgb_{lam}"] = ("rgb", lam, steps_rgb, "mse")
    if steps_msssim:
        runs["msssim"] = ("rgb", c.MSSSIM_LAMBDA, steps_msssim, "msssim")
    return runs


def check_sweep(points: dict, strict: bool) -> None:
    names = [f"rgb_{lam}" for lam in c.LAMBDAS]
    bpps = [points[n]["real_bpp"] for n in names]
    psnrs = [points[n]["psnr"] for n in names]
    ests = [points[n]["bpp"] for n in names]
    print(f"RD sweep: real bpp {bpps}, psnr {psnrs}, estimated bpp {ests}",
          flush=True)
    if not all(np.isfinite(v) and v > 0 for v in bpps):
        raise AssertionError(f"a real rate is not finite and positive: {bpps}")
    # the lambda weighting prices bits directly: holds at any budget
    if not bpps[0] < bpps[1] < bpps[2]:
        raise AssertionError(f"real rate not strictly monotone in lambda: "
                             f"{bpps}")
    # distortion order needs a convergence partial budgets may not reach
    ordered = psnrs[0] < psnrs[1] < psnrs[2]
    if not ordered:
        print(f"WARN: PSNR not monotone in lambda at this budget: {psnrs}",
              flush=True)
        if strict:
            raise AssertionError(f"PSNR not monotone in lambda: {psnrs}")
    for n, est, real in zip(names, ests, bpps):
        gap = abs(real - est) / real
        print(f"{n}: real-vs-estimated bpp gap {gap * 100:.2f}%", flush=True)
        if not gap < 0.15:
            raise AssertionError(f"{n}: real bpp {real} vs estimate {est}")


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--steps-mask", type=int, default=800)
    ap.add_argument("--steps-rgb", type=int, default=800)
    ap.add_argument("--steps-msssim", type=int, default=0,
                    help="0 leaves the MS-SSIM-distortion model out")
    ap.add_argument("--strict", action="store_true",
                    help="enforce PSNR monotone in lambda")
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    runs = sweep_runs(args.steps_mask, args.steps_rgb, args.steps_msssim)
    tree = c.kodak_tree(args.outdir)
    points_path = os.path.join(args.outdir, "rd_points.json")
    points = {}
    if os.path.exists(points_path):
        with open(points_path) as f:
            points = json.load(f)
        c.log(f"resuming with {sorted(points)} already evaluated")
    get_data = c.lazy_data(device)

    def trained(name) -> str:
        """The latest checkpoint of ``name``, trained to its budget."""
        kind, lam, steps, dist = runs[name]
        return c.latest_checkpoint(c.train_one(
            name, kind, lam, steps, args.outdir, dist, data=get_data)["ckdir"])

    mask_ck = trained("mask")
    codec = c.make_codec(device)
    try:
        for name in [n for n in runs if n != "mask"]:
            ck = trained(name)
            if points.get(name, {}).get("step") == c.step_from_path(ck):
                c.log(f"{name}: point at step {points[name]['step']} "
                      f"already recorded")
                continue
            points[name] = c.eval_point(codec, tree, ck, mask_ck)
            c.write_points(args.outdir, points, runs)
            c.log(f"{name}: {json.dumps(points[name])}")
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    check_sweep(points, args.strict)
    print("rd_sweep_proof OK", flush=True)
    return points


if __name__ == "__main__":
    main()
