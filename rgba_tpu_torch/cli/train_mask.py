"""Mask-codec training and eval driver (port of ``rgba_tpu/cli/train_mask.py``,
the reference's trainmask.py).

Train:  python -m rgba_tpu_torch.cli.train_mask --config cfg.json -n run1
Eval:   python -m rgba_tpu_torch.cli.train_mask --config cfg.json -n run1 \\
            -p checkpoints/run1/iter_600000.ckpt --test --kodak ../Kodak/

``-p`` reads the port's checkpoints, reference ``.pth.tar`` files and the
JAX package's ``iter_<N>.ckpt``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..core.config import load_config
from ..core.precision import DEFAULT_POLICY, precision_scope, resolve_device
from ..data.datasets import KodakDataset, RGBATrainDataset
from ..data.loader import BatchLoader
from ..data.png import write_png
from ..metrics.ms_ssim import ms_ssim
from ..models.mask_codec import MaskCodec
from ..ops.morphology import constraint_mask
from ..train.loops import MaskTrainer
from .common import build_parser, load_params_if, make_tb_writer, setup_logging


def evaluate_mask(model, rootpath, logger, step=0, tb=None, output_dir=""):
    """Mask-only Kodak eval (the reference's trainmask.py test): bpp
    estimated from likelihoods; the recon rounded with round(x * 255,
    decimals=1), clamped to [0, 255] and divided by 255, the neighbour-sum
    constraint, PSNR and MS-SSIM on the 1-channel mask."""
    ds = KodakDataset(rootpath)
    device = next(model.parameters()).device

    def eval_step(mask):
        with torch.inference_mode(), precision_scope(model.policy):
            m_nhwc = torch.as_tensor(mask, dtype=torch.float32, device=device)
            m = m_nhwc.permute(0, 3, 1, 2)
            out = model(m, training=False)
            recon = torch.clamp(torch.round(out["x_hat"] * 255.0, decimals=1),
                                0.0, 255.0) / 255.0
            recon = constraint_mask(recon)
            mse = torch.mean(torch.square(recon - m))
            recon = recon.permute(0, 2, 3, 1)
            return {"bpp": out["bpp"], "mse": mse,
                    "msssim": ms_ssim(m_nhwc, recon, data_range=1.0),
                    "recon": recon}

    sums = {"bpp": 0.0, "psnr": 0.0, "msssim": 0.0, "msssimdb": 0.0}
    for i in range(len(ds)):
        item = ds.get(i)
        out = {k: v.cpu().numpy() for k, v in
               eval_step(item["alpha"][None]).items()}
        psnr = 10 * np.log10(1.0 / max(float(out["mse"]), 1e-12))
        msssim = float(out["msssim"])
        msssimdb = -10 * np.log10(max(1 - msssim, 1e-12))
        sums["bpp"] += float(out["bpp"])
        sums["psnr"] += psnr
        sums["msssim"] += msssim
        sums["msssimdb"] += msssimdb
        logger.info("Num:%d, Bpp:%.6f, PSNR:%.6f, MS-SSIM:%.6f, "
                    "MS-SSIM-DB:%.6f", i + 1, float(out["bpp"]), psnr,
                    msssim, msssimdb)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            arr = (np.clip(out["recon"][0, ..., 0], 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(output_dir, f"{i + 1}mask.png"), arr)
    n = max(len(ds), 1)
    avg = {k: v / n for k, v in sums.items()}
    logger.info("Dataset Average result---Bpp:%.6f, PSNR:%.6f, "
                "MS-SSIM:%.6f, MS-SSIM-DB:%.6f", avg["bpp"], avg["psnr"],
                avg["msssim"], avg["msssimdb"])
    if tb is not None:
        tb.add_scalar("BPP_Test", avg["bpp"], step)
        tb.add_scalar("PSNR_Test", avg["psnr"], step)
        tb.add_scalar("MS-SSIM_Test", avg["msssim"], step)
        tb.add_scalar("MS-SSIM_DB_Test", avg["msssimdb"], step)
    return avg


def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller passes another (the tests
    pass "cpu").  With ``--test``, returns the eval's averages."""
    args = build_parser("mask codec trainer").parse_args(argv)
    cfg = load_config(args.config if args.config else None,
                      parity=args.parity, seed=args.seed)
    # mask driver defaults (trainmask.py)
    if args.config is None:
        cfg.tot_step = 600_000
        cfg.decay_interval = 220_000
    if cfg.decay_interval2 is None:
        cfg.decay_interval2 = 500_000
    cfg.fill_mix_ratio = 0.0
    cfg.snapshot_freq = 2000            # the reference's rotating cadence

    save_path = os.path.join("checkpoints", args.name) if args.name else ""
    logger = setup_logging(save_path)
    logger.info("mask codec training (CUDA)")

    dev = resolve_device(device)
    # the JAX driver's model: the default (fp32) policy
    model = MaskCodec(policy=DEFAULT_POLICY, device=dev,
                      generator=torch.Generator().manual_seed(cfg.seed))
    ds = RGBATrainDataset(args.train_coco, args.train_p3m,
                          height=cfg.image_size, width=cfg.image_size,
                          fill_mix_ratio=cfg.fill_mix_ratio, seed=cfg.seed)
    if len(ds) == 0 and not args.test:
        logger.error("no training images under %s / %s", args.train_coco,
                     args.train_p3m)
        sys.exit(1)

    if args.test:
        load_params_if(args.pretrain, model)
        return evaluate_mask(model, args.kodak, logger)

    trainer = MaskTrainer(cfg, save_path or "checkpoints/_unnamed",
                          model=model, device=dev)
    loader = BatchLoader(ds, batch_size=cfg.batch_size, shuffle=True,
                         num_workers=4, seed=cfg.seed)
    state = trainer.init_state(step=load_params_if(args.pretrain, model))
    tb = make_tb_writer(save_path) if save_path else None

    def eval_fn(step, st):
        evaluate_mask(model, args.kodak, logger, step, tb)

    eval_hook = eval_fn if os.path.isdir(
        os.path.join(args.kodak, "PNGImages")) else None
    try:
        trainer.train(loader, state, tb_writer=tb, eval_fn=eval_hook)
    finally:
        if tb is not None:
            tb.close()


if __name__ == "__main__":
    main()
