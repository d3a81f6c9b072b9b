"""Quickstart: train both codecs a few steps on synthetic RGBA, run the
joint Kodak-style eval, and code one real bitstream, all self-contained.

    python -m rgba_tpu_torch.examples.quickstart            # on the card
    python -m rgba_tpu_torch.examples.quickstart --device cpu --steps 2

The trainers (bf16) and the codec (fp32) run the four CUDA kernels on the
card; on the CPU the kernels' plain versions.  This is a miniature of
the full workflow: for real training use the CLIs (``python -m
rgba_tpu_torch.cli.train_mask`` / ``train_rgb``) with the dataset layout
of the README, and ``rgba_tpu_torch.tools`` for the trained-weight
proofs.
"""

from __future__ import annotations

import logging
import os
import tempfile

import numpy as np

from ..core.config import TrainConfig
from ..data.synthetic import synthetic_rgba_batch, write_synthetic_kodak_tree
from ..eval.kodak import evaluate_kodak
from ..tools import _common as c

HW, BATCH = 64, 8


def main(argv=None) -> dict:
    ap = c.tool_parser(__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.set_defaults(outdir=None)
    args = ap.parse_args(argv)
    device = c.prepare(args.device)
    out_dir = args.outdir or tempfile.mkdtemp(prefix="rgba_quickstart_")
    cfg = TrainConfig(train_lambda=1024, batch_size=BATCH,
                      tot_step=args.steps, cal_step=1, print_freq=10,
                      snapshot_freq=10 ** 9, save_model_freq=10 ** 9)
    example = synthetic_rgba_batch(BATCH, HW, HW, seed=0)

    # 1-2. a few steps of each trainer on one batch
    models = {}
    for kind in ("mask", "rgb"):
        trainer = c.make_trainer(kind, cfg, os.path.join(out_dir, kind),
                                 device)
        state = trainer.init_state()
        per_step = (c.RGB_STEP_LAUNCHES if kind == "rgb"
                    else c.MASK_STEP_LAUNCHES)
        c.reset_launches()
        for _ in range(cfg.tot_step):
            metrics = trainer.step(state, example)
        c.check_launches(device, per_step, cfg.tot_step,
                         f"{cfg.tot_step} {kind} steps")
        print(f"{kind} codec: rd_loss after {cfg.tot_step} steps = "
              f"{float(metrics['rd_loss']):.2f}", flush=True)
        models[kind] = trainer.model

    # 3. joint Kodak-style eval on a synthetic tree
    root = os.path.join(out_dir, "kodak")
    write_synthetic_kodak_tree(root, n_images=1, height=192, width=256)
    logger = logging.getLogger("rgba_tpu_torch")
    logger.addHandler(logging.StreamHandler())
    logger.setLevel(logging.INFO)
    avg = evaluate_kodak(models["rgb"], models["mask"], root,
                         output_dir=os.path.join(out_dir, "out"))
    print(f"eval: bpp={avg['bpp']:.3f} psnr={avg['psnr']:.2f}", flush=True)

    # 4. one real bitstream through the fp32 codec holding the weights
    codec = c.make_codec(device)
    try:
        codec.rgb_io.set_params(models["rgb"].state_dict())
        codec.mask_io.set_params(models["mask"].state_dict())
        d = synthetic_rgba_batch(1, HW, HW, seed=7)
        blob = codec.encode(d["image"], d["alpha"])
        rgba = codec.decode(blob)
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    bpp = len(blob) * 8 / (HW * HW)
    print(f"bitstream: {len(blob)} bytes -> decoded {rgba.shape}, "
          f"bpp={bpp:.3f}", flush=True)
    if not (rgba.shape == (1, HW, HW, 4) and np.isfinite(rgba).all()):
        raise AssertionError(f"decoded {rgba.shape}")
    print(f"artifacts in {out_dir}", flush=True)
    return {"eval": avg, "bitstream_bytes": len(blob), "bitstream_bpp": bpp,
            "rgba": rgba, "outdir": out_dir}


if __name__ == "__main__":
    main()
