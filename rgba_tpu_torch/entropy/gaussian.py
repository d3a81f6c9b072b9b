"""Conditional Gaussian entropy model over the y-latent slices (port of
``rgba_tpu/entropy/gaussian.py``).

Training and eval likelihoods (fp32), and the codec's tables: the 64-entry log-spaced
scale table (0.11 -> 256), one quantized CDF row per table scale built with
numpy float64 on the host as the JAX package builds it, and the map from a
scale to its row (``build_indexes``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.math import lower_bound, uniform_noise
from .cdf import build_cdf_rows

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64
SCALE_BOUND = 0.11
_LIKELIHOOD_BOUND = 1e-9


def get_scale_table(minimum=SCALES_MIN, maximum=SCALES_MAX,
                    levels=SCALES_LEVELS) -> np.ndarray:
    """exp(linspace(log min, log max, levels))."""
    return np.exp(np.linspace(math.log(minimum), math.log(maximum), levels))


def _std_cumulative(x):
    """Standard normal CDF via erfc: 0.5 * erfc(-x / sqrt(2))."""
    return 0.5 * torch.special.erfc(-x * (2 ** -0.5))


def _std_quantile(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation, max
    relative error ~1.15e-9); it only sets the integer tail radius."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow = 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > 1 - plow:
        return -_std_quantile(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


class GaussianConditional:
    """Scales bounded at 0.11, integer-bin Gaussian mass; ``update`` builds
    the codec's CDF rows for ``scale_table``."""

    def __init__(self, scale_table=None, scale_bound: float = SCALE_BOUND,
                 tail_mass: float = 1e-9):
        self.scale_table = None if scale_table is None else np.asarray(scale_table)
        self.scale_bound = scale_bound
        self.tail_mass = tail_mass
        self._table_f32 = {}    # device -> fp32 table[:-1] for build_indexes

    def likelihood(self, y, scales, means, training: bool = False,
                   generator=None):
        """Eval: the likelihood of round(y - means), the value the decoder
        sees.  Training: of y - means + U(-0.5, 0.5) drawn from
        ``generator`` (the additive-noise relaxation)."""
        y = y.float()
        scales = lower_bound(scales.float(), self.scale_bound)
        values = y - means.float()
        if training:
            values = values + uniform_noise(y.shape, generator, y.device)
        else:
            values = torch.round(values)
        v = torch.abs(values)
        upper = _std_cumulative((0.5 - v) / scales)
        lower = _std_cumulative((-0.5 - v) / scales)
        return lower_bound(upper - lower, _LIKELIHOOD_BOUND)

    def build_indexes(self, scales):
        """Each scale's CDF row: the count of table entries (but the last)
        below it, i.e. the smallest entry >= the scale."""
        if self.scale_table is None:
            raise ValueError("scale table not set: call update() first")
        dev = scales.device
        if dev not in self._table_f32:
            self._table_f32[dev] = torch.tensor(
                self.scale_table[:-1], dtype=torch.float32, device=dev)
        scales = torch.clamp_min(scales.float(), self.scale_bound)
        return torch.searchsorted(self._table_f32[dev], scales.contiguous(),
                                  right=False).to(torch.int32)

    @staticmethod
    def quantize_symbols(y, means):
        return torch.round(y - means).to(torch.int32)

    @staticmethod
    def dequantize(symbols, means):
        return symbols.float() + means.float()

    def update(self, scale_table=None):
        """Quantized CDFs, lengths and offsets for every table scale."""
        if scale_table is not None:
            self.scale_table = np.asarray(scale_table)
            self._table_f32 = {}
        if self.scale_table is None:
            self.scale_table = get_scale_table()
        st = self.scale_table.astype(np.float64)
        erfc = np.vectorize(math.erfc)

        multiplier = -_std_quantile(self.tail_mass / 2)
        pmf_center = np.ceil(st * multiplier).astype(np.int64)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        samples = np.abs(np.arange(max_length)[None, :] - pmf_center[:, None])
        upper = 0.5 * erfc(-((0.5 - samples) / st[:, None]) * (2 ** -0.5))
        lower = 0.5 * erfc(-((-0.5 - samples) / st[:, None]) * (2 ** -0.5))
        pmf = (upper - lower).astype(np.float32)
        tail_mass = (2.0 * lower[:, :1])[:, 0].astype(np.float32)

        cdfs, cdf_lengths = build_cdf_rows(pmf, pmf_length, tail_mass)
        self.quantized_cdfs = cdfs
        self.cdf_lengths = cdf_lengths
        self.offsets = (-pmf_center).astype(np.int32)
        return True
