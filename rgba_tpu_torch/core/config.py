"""Typed training configuration (port of ``rgba_tpu/core/config.py``).

The JSON schema is the reference's: keys ``tot_epoch, tot_step,
train_lambda, batch_size, print_freq, save_model_freq, cal_step`` and the
nested ``lr.{base, decay, decay_interval, decay_interval2}``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # --- reference JSON keys (defaults are the reference's) ---
    tot_epoch: int = 1_000_000
    tot_step: int = 2_500_000
    train_lambda: float = 8192
    batch_size: int = 4
    print_freq: int = 100
    cal_step: int = 40
    save_model_freq: int = 50_000
    base_lr: float = 1e-4               # lr.base
    lr_decay: float = 0.1               # lr.decay
    decay_interval: int = 2_200_000     # lr.decay_interval
    # second decay stage, used by the mask codec's runs only: lr -> base*decay at
    # decay_interval, -> base*decay2 at decay_interval2
    decay_interval2: Optional[int] = None
    lr_decay2: float = 0.01
    warmup_step: int = 0
    image_size: int = 256

    # --- engineering knobs (not in the reference JSON) ---
    seed: int = 234
    grad_clip: float = 5.0              # value clamp +-5 before Adam
    aux_lr: float = 1e-3                # aux optimizer of the bottleneck
                                        # quantiles (the reference leaves them
                                        # untrained; 0.0 for strict parity)
    curriculum_step: int = 500_000      # full-image / all-ones-mask phase
    fill_mix_ratio: float = 0.25
    compute_dtype: str = "bfloat16"     # bf16 activations
    num_devices: int = 0                # 0, or the torch.distributed group's
                                        # size (one process per device; the
                                        # JAX trainer's gcd(batch, n) data
                                        # axis within one process has no
                                        # counterpart: train/loops.py raises)
    snapshot_freq: int = 5000           # rotating checkpoint cadence
    # RGB-codec distortion term: "mse" (reference default) or "msssim"
    # (1 - masked MS-SSIM over the alpha-visible region)
    distortion: str = "mse"

    def lr_at(self, step: int) -> float:
        """Piecewise-constant schedule."""
        if self.warmup_step > 0 and step < self.warmup_step:
            return self.base_lr * step / self.warmup_step
        if self.decay_interval2 is not None and step >= self.decay_interval2:
            return self.base_lr * self.lr_decay2
        if step >= self.decay_interval:
            return self.base_lr * self.lr_decay
        return self.base_lr


def load_config(path: Optional[str] = None, parity: bool = False,
                **overrides) -> TrainConfig:
    """Load a reference-format JSON config into a TrainConfig.

    parity=True is the strict-reference-parity preset in one flag: fp32
    compute (which also selects the exact-erf GELU and keeps every kernel
    flag off, ``core/precision.py`` DEFAULT_POLICY) and ``aux_lr=0`` (the
    reference never trains the bottleneck quantiles).  Explicit
    ``**overrides`` still win over the preset.
    """
    cfg = TrainConfig()
    if path:
        with open(path) as f:
            raw = json.load(f)
        for key in ("tot_epoch", "tot_step", "train_lambda", "batch_size",
                    "print_freq", "save_model_freq", "cal_step"):
            if key in raw:
                setattr(cfg, key, raw[key])
        lr = raw.get("lr", {})
        for key, field in (("base", "base_lr"), ("decay", "lr_decay"),
                           ("decay_interval", "decay_interval"),
                           ("decay_interval2", "decay_interval2")):
            if key in lr:
                setattr(cfg, field, lr[key])
        # engineering keys too, if present
        for key in ("seed", "grad_clip", "aux_lr", "curriculum_step",
                    "fill_mix_ratio", "compute_dtype", "num_devices",
                    "distortion"):
            if key in raw:
                setattr(cfg, key, raw[key])
    if parity:
        # after the JSON (the flag means parity even with a config file),
        # before the overrides (explicit keywords still win)
        cfg.compute_dtype = "float32"
        cfg.aux_lr = 0.0
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise KeyError(f"unknown config key: {k}")
        setattr(cfg, k, v)
    return cfg
