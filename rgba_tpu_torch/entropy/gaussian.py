"""Conditional Gaussian entropy model over the y-latent slices (port of
``rgba_tpu/entropy/gaussian.py``, eval likelihood only; the scale table and
CDF rows of the real codec are later work).  All math fp32.
"""

from __future__ import annotations

import torch

from ..ops.math import lower_bound

SCALE_BOUND = 0.11
_LIKELIHOOD_BOUND = 1e-9


def _std_cumulative(x):
    """Standard normal CDF via erfc: 0.5 * erfc(-x / sqrt(2))."""
    return 0.5 * torch.special.erfc(-x * (2 ** -0.5))


class GaussianConditional:
    """Stateless: scales bounded at 0.11, integer-bin Gaussian mass."""

    def __init__(self, scale_bound: float = SCALE_BOUND):
        self.scale_bound = scale_bound

    def likelihood(self, y, scales, means):
        """Likelihood of round(y - means), the value the decoder sees."""
        y = y.float()
        scales = lower_bound(scales.float(), self.scale_bound)
        v = torch.abs(torch.round(y - means.float()))
        upper = _std_cumulative((0.5 - v) / scales)
        lower = _std_cumulative((-0.5 - v) / scales)
        return lower_bound(upper - lower, _LIKELIHOOD_BOUND)
