"""PMF rows -> padded 16-bit quantized CDF tables for the rANS coder (port
of ``rgba_tpu/entropy/cdf.py``).

Each row is [pmf[:len], tail mass], quantized by the host coder's
``pmf_to_quantized_cdf`` (native/rans.cpp: scale to 2^16, renormalize,
steal one unit from the poorest range with freq > 1 so every symbol stays
decodable, as CompressAI does).
"""

from __future__ import annotations

import numpy as np

from ..native import rans


def build_cdf_rows(pmfs: np.ndarray, lengths: np.ndarray,
                   tail_masses: np.ndarray, precision: int = 16):
    """pmfs: (R, Lmax); lengths: (R,) valid pmf lengths; tail_masses: (R,).
    Returns (cdfs int32 (R, Lmax + 2), cdf_lengths int32 (R,))."""
    rows, lmax = pmfs.shape
    cdfs = np.zeros((rows, lmax + 2), dtype=np.int32)
    cdf_lengths = np.zeros(rows, dtype=np.int32)
    for r in range(rows):
        ln = int(lengths[r])
        prob = np.concatenate([pmfs[r, :ln], [max(tail_masses[r], 0.0)]])
        c = rans.pmf_to_quantized_cdf(prob, precision)
        cdfs[r, :len(c)] = c
        cdf_lengths[r] = len(c)
    return cdfs, cdf_lengths
