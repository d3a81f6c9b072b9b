"""fp32 weights for the 3xTF32 tensor-core products of ``csrc/*.cu``.

A tensor core reads an fp32 operand as TF32 and ignores its low 13 bits.
The fp32 kernels split every operand as v = hi + lo: hi is v rounded to
the nearest TF32 value (ties away from zero, as ``cvt.rna.tf32.f32``) with
the low 13 bits stored as zeros, lo is v - hi rounded the same way; a
product is then taken as a_lo b_hi + a_hi b_lo + a_hi b_hi
(``common.cuh``).  hi + lo is v within 2^-22 |v|.  This module lays out the
weights' hi and lo once per weights; the kernels split the activations in
registers by the same rule.
"""

from __future__ import annotations

import torch

CHUNK_K = 16   # k per weight chunk of the fp32 gate-chain kernel's ring


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero, as fp32 whose
    low 13 bits are 0."""
    bits = t.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """(hi, lo): hi = round_tf32(t), lo = round_tf32(t - hi)."""
    hi = round_tf32(t)
    return hi, round_tf32(t.float() - hi)


def core_matrices_tf32(w):
    """(..., n, k) -> the same values in wgmma's K-major core-matrix order
    for 4-byte types: core matrices of 8 rows x 4 k (16 bytes a row), the
    k-blocks of one 8-row group adjacent, so element (r, k) lands at
    (r // 8) * 8k + (k // 4) * 32 + (r % 8) * 4 + k % 4; n a multiple of
    8, k of 4."""
    *lead, n, k = w.shape
    return w.reshape(*lead, n // 8, 8, k // 4, 4).transpose(-3, -2).contiguous()


def hi_lo_core(w):
    """(..., n, k) -> (..., 2 * n * k): the hi of w in core-matrix order,
    then its lo."""
    hi, lo = split_tf32(w)
    return torch.cat([core_matrices_tf32(hi).flatten(-4),
                      core_matrices_tf32(lo).flatten(-4)], dim=-1)


def chunked_hi_lo(w, chunk: int = CHUNK_K):
    """(..., n, k) -> (..., 2 * n * k): chunks of ``chunk`` k (the last may
    be shorter), each ``hi_lo_core``, one after the other; n and k
    multiples of 8.  The split is elementwise, so the whole matrix is split
    once and cut into chunks after."""
    *lead, n, k = w.shape
    hi, lo = split_tf32(w)
    full = k // chunk * chunk
    parts = []
    if full:
        def chunks(t):      # (..., n, full) -> (..., full / chunk, n * chunk)
            t = t[..., :full].reshape(*lead, n, full // chunk, chunk)
            return core_matrices_tf32(t.movedim(-2, -3)).flatten(-4)
        parts.append(torch.stack([chunks(hi), chunks(lo)], dim=-2)
                     .flatten(-3))
    if full < k:
        parts.append(torch.cat([core_matrices_tf32(hi[..., full:]).flatten(-4),
                                core_matrices_tf32(lo[..., full:]).flatten(-4)],
                               dim=-1))
    return torch.cat(parts, dim=-1)
