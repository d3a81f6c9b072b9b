"""RGB-codec training and eval driver (port of ``rgba_tpu/cli/train_rgb.py``,
the reference's trainRGB.py).

Train:  python -m rgba_tpu_torch.cli.train_rgb --config cfgRGB.json -n run1 \\
            -pm checkpoints/mask/iter_600000.ckpt
Eval:   ... -p checkpoints/run1/iter_1500000.ckpt --test --kodak ../Kodak/

``-p`` / ``-pm`` read the port's checkpoints, reference ``.pth.tar``
files and the JAX package's ``iter_<N>.ckpt``.
"""

from __future__ import annotations

import os
import sys

import torch

from ..core.config import load_config
from ..core.precision import DEFAULT_POLICY, resolve_device
from ..data.datasets import RGBATrainDataset
from ..data.loader import BatchLoader
from ..eval.kodak import evaluate_kodak
from ..models.mask_codec import MaskCodec
from ..models.rgb_codec import RGBCodec
from ..train.loops import RGBTrainer
from .common import build_parser, load_params_if, make_tb_writer, setup_logging


def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller passes another (the tests
    pass "cpu").  With ``--test``, returns the eval's averages."""
    args = build_parser("RGB codec trainer").parse_args(argv)
    cfg = load_config(args.config if args.config else None,
                      parity=args.parity, seed=args.seed)

    save_path = os.path.join("checkpoints", args.name) if args.name else ""
    logger = setup_logging(save_path)
    logger.info("RGB codec training (CUDA)")

    dev = resolve_device(device)
    # the JAX driver's models: the default (fp32) policy, seeded weights
    # until a checkpoint replaces them
    model = RGBCodec(policy=DEFAULT_POLICY, device=dev,
                     generator=torch.Generator().manual_seed(cfg.seed))
    mask_model = MaskCodec(policy=DEFAULT_POLICY, device=dev,
                           generator=torch.Generator().manual_seed(0))
    load_params_if(args.pretrainmask, mask_model)

    if args.test:
        step = load_params_if(args.pretrain, model)
        # the reference's eval-time curriculum: while the checkpoint step is
        # inside the full-image phase, eval unmasked against an all-ones
        # mask (the real-codec path has no such branch)
        cur = step < cfg.curriculum_step and not args.real_codec
        return evaluate_kodak(model, mask_model, args.kodak,
                              output_dir="outputKodak", step=step,
                              real_codec=args.real_codec, curriculum=cur)

    ds = RGBATrainDataset(args.train_coco, args.train_p3m,
                          height=cfg.image_size, width=cfg.image_size,
                          fill_mix_ratio=cfg.fill_mix_ratio, seed=cfg.seed)
    if len(ds) == 0:
        logger.error("no training images under %s / %s", args.train_coco,
                     args.train_p3m)
        sys.exit(1)
    trainer = RGBTrainer(cfg, save_path or "checkpoints/_unnamed",
                         model=model, device=dev)
    loader = BatchLoader(ds, batch_size=cfg.batch_size, shuffle=True,
                         num_workers=4, seed=cfg.seed)
    state = trainer.init_state(step=load_params_if(args.pretrain, model))
    tb = make_tb_writer(save_path) if save_path else None

    def eval_fn(step, st):
        evaluate_kodak(model, mask_model, args.kodak,
                       output_dir="outputKodak", step=step, tb_writer=tb,
                       curriculum=step < cfg.curriculum_step)

    eval_hook = eval_fn if os.path.isdir(
        os.path.join(args.kodak, "PNGImages")) else None
    try:
        trainer.train(loader, state, tb_writer=tb, eval_fn=eval_hook)
    finally:
        if tb is not None:
            tb.close()


if __name__ == "__main__":
    main()
