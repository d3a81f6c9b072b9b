"""Shared CLI plumbing: flags, logging, checkpoint resolution (port of
``rgba_tpu/cli/common.py``).

The flags are the JAX package's (after the reference drivers):
-n/--name, -p/--pretrain, -pm/--pretrainmask, --test, --config, --seed,
--kodak, --real-codec, --train-coco, --train-p3m, --parity.  The device is
not a flag: each CLI's ``main(argv=None, device=None)`` runs on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import logging
import os


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-n", "--name", default="", help="run name (checkpoints/<name>)")
    p.add_argument("-p", "--pretrain", default="", help="load pretrained model")
    p.add_argument("-pm", "--pretrainmask", default="",
                   help="load pretrained mask model")
    p.add_argument("--test", action="store_true", help="eval only")
    p.add_argument("--config", dest="config", required=False,
                   help="hyperparameters in json format")
    p.add_argument("--seed", default=234, type=int)
    p.add_argument("--kodak", default="../Kodak/", help="Kodak RGBA root")
    p.add_argument("--real-codec", action="store_true",
                   help="eval with the actual rANS bitstream (byte-true bpp)")
    p.add_argument("--train-coco", default="../P3Mdata/COCOdata")
    p.add_argument("--train-p3m", default="../P3Mdata/MASKpatches")
    p.add_argument("--parity", action="store_true",
                   help="strict reference-parity preset: fp32 compute "
                        "(exact-erf GELU, no kernels) and aux_lr=0 "
                        "(quantiles untrained, like the reference)")
    return p


def setup_logging(save_path: str):
    logger = logging.getLogger("rgba_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "[%(asctime)s][%(filename)s][L%(lineno)d][%(levelname)s] %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_path, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def make_tb_writer(save_path: str):
    """A TensorBoard writer, or None where ``tensorboardX`` is not
    installed (an optional logger, as in the JAX package)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(save_path, "events"))


def load_params_if(path: str, module) -> int:
    """Load the checkpoint at ``path`` (the port's, a reference
    ``.pth.tar`` or the JAX package's msgpack) into ``module``; returns the
    step its name carries (0 without a path)."""
    from ..train.checkpoint import load_checkpoint, step_from_path
    if not path:
        return 0
    missing = load_checkpoint(module, path)
    if missing:
        logging.getLogger("rgba_tpu_torch").warning(
            "%s supplied no value for %d of the model's keys (first: %s)",
            path, len(missing), missing[0])
    return step_from_path(path)
