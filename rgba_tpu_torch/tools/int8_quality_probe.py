"""The serve-int8 path's quality and speed on trained weights.

Loads the trained pair (``--lam``, default 4096, and the mask codec)
under ``--outdir`` into ``RGBAPipeline`` and runs the Kodak-shaped
serving forward (batch 16, 512x768, 4 batches from seeds 0-3) under
three policies: fp32 with the four kernels on (the anchor), ``serve``
(bf16, the attention kernel, packed DSE) and ``serve-int8`` (``serve``
with dynamic W8A8 convolutions, ``ops/quant.py``).  For each: PSNR from
the mean masked MSE, the estimated bpp, and ms per batch on the card
(``utils/benchmark.device_time``, CUDA events over 8 calls), then the
int8 deltas against ``serve``.

    python -m rgba_tpu_torch.tools.int8_quality_probe --outdir build/proofs
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.precision import (DEFAULT_POLICY, SERVE_INT8_POLICY,
                              SERVE_POLICY)
from ..data.synthetic import synthetic_rgba_batch
from ..models.pipeline import RGBAPipeline
from ..utils.benchmark import device_time
from . import _common as c

BATCH, HW, BATCHES = 16, (512, 768), 4
POLICIES = {"fp32": c.all_kernels(DEFAULT_POLICY), "serve": SERVE_POLICY,
            "serve-int8": SERVE_INT8_POLICY}


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--lam", type=int, default=4096)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    sd = c.load_trained(args.lam, args.outdir)
    datas = [synthetic_rgba_batch(BATCH, *HW, seed=s) for s in range(BATCHES)]
    inputs = [(torch.from_numpy(d["masked_image"]).to(device),
               torch.from_numpy(d["alpha"]).to(device)) for d in datas]
    results = {}
    for name, policy in POLICIES.items():
        pipe = RGBAPipeline(policy, device=device)
        pipe.load_state_dict(sd)
        pipe(*inputs[0])                       # warm-up
        c.reset_launches()
        pipe(*inputs[0])
        launches = c.launches()
        sec = device_time(lambda x, m: pipe(x, m)["bpp"], inputs, iters=8)
        mses, bpps = [], []
        for x, m in inputs:
            out = pipe(x, m)
            mses.append(float(out["mse_loss"]))
            bpps.append(float(out["bpp"]))
        results[name] = {
            "psnr_db": round(10 * np.log10(1.0 / max(np.mean(mses), 1e-12)),
                             4),
            "bpp": round(float(np.mean(bpps)), 5),
            "ms_per_batch16": round(sec * 1e3, 2),
            "img_per_sec": round(BATCH / sec, 2),
            "launches": launches}
        print(name, json.dumps(results[name]), flush=True)
        del pipe
    int8, serve = results["serve-int8"], results["serve"]
    results["int8_vs_serve"] = {
        "d_psnr_db": round(int8["psnr_db"] - serve["psnr_db"], 4),
        "d_bpp": round(int8["bpp"] - serve["bpp"], 5),
        "speedup": round(serve["ms_per_batch16"] / int8["ms_per_batch16"], 3)}
    results.update(lam=args.lam,
                   device=c.card() if device.type == "cuda" else "cpu")
    print(json.dumps({"lam": args.lam,
                      "int8_vs_serve": results["int8_vs_serve"]}), flush=True)
    with open(os.path.join(args.outdir, "int8_quality.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
