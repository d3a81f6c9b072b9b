"""Fused masked window attention: the CUDA kernel ``csrc/win_attn.cu`` and
its plain version.

Port of ``rgba_tpu/ops/pallas/win_attn.py::fused_window_attention``.  Per
window: qkv projection, per-head scores + relative-position bias - 100
wherever two tokens' region ids differ, fp32 softmax, P.V, output
projection, times the alive gate.  Output is pre-residual; dead windows
are exactly zero.  Under autograd the kernel runs in the forward and the
gradients come from the plain version (``remat.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import CudaKernel
from .remat import fused_primal_plain_grad, needs_grad
from .tf32 import chunked_hi_lo

KERNEL = CudaKernel("win_attn.cu", "rgba_win_attn", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' register tiles: scores of at most 64 keys, head dims padded
# to at most 32
MMA_MAX_TOKENS = 64
MMA_MAX_HEAD_DIM = 32


def _up16(v: int) -> int:
    return (v + 15) // 16 * 16


def _up8(v: int) -> int:
    return (v + 7) // 8 * 8


def tf32_geometry(c: int, num_heads: int):
    """(hdp, ns, ko, nco) of the fp32 kernel: the head dim rounded up to 8,
    the rows of a weight stage (q|k|v of one head, or one output-projection
    chunk), the head outputs' padded width, the output-projection chunks."""
    hdp = _up8(c // num_heads)
    ns = 3 * hdp
    return hdp, ns, num_heads * hdp, -(-c // ns)


def tf32_weights(wqkv, wproj, num_heads: int):
    """The fp32 kernel's weights before the hi / lo split: wqkv (C, 3C)
    [in][out] becomes (nh, ns, C) [head][q|k|v, d < hdp][in] and wproj
    (C, C) becomes (nco, ns, ko) [chunk][out][h * hdp + d], zero padded."""
    c = wqkv.shape[0]
    nh = num_heads
    hd = c // nh
    hdp, ns, ko, nco = tf32_geometry(c, nh)
    w = wqkv.float().t().reshape(3, nh, hd, c).transpose(0, 1)
    wq = F.pad(w, (0, 0, 0, hdp - hd)).reshape(nh, ns, c)
    wp = F.pad(wproj.float().t().reshape(c, nh, hd), (0, hdp - hd))
    wp = F.pad(wp.reshape(c, ko), (0, 0, 0, nco * ns - c)).reshape(nco, ns, ko)
    return wq, wp


def mma_weights(wqkv, wproj, num_heads: int):
    """The bf16 kernel's weight layout: wqkv (C, 3C) [in][out] becomes
    (nh, 3, hdp, Cp) [head][q|k|v][d][in] and wproj (C, C) becomes (C, Cp)
    [out][in], hdp and Cp being hd and C rounded up to 16, zero padded."""
    c = wqkv.shape[0]
    nh = num_heads
    hd, hdp, cp = c // nh, _up16(c // nh), _up16(c)
    w = wqkv.to(torch.bfloat16).t().reshape(3, nh, hd, c).transpose(0, 1)
    wq = F.pad(w, (0, cp - c, 0, hdp - hd)).contiguous()
    wp = F.pad(wproj.to(torch.bfloat16).t(), (0, cp - c)).contiguous()
    return wq, wp


def core_matrices(w):
    """(..., n, k) -> the same values in wgmma's K-major core-matrix order:
    8 x 8 blocks of 8 rows of 8 k each, k-blocks of one 8-row group
    adjacent, so element (r, k) lands at (r // 8) * 8k + (k // 8) * 64 +
    (r % 8) * 8 + k % 8; n and k multiples of 8."""
    *lead, n, k = w.shape
    return w.reshape(*lead, n // 8, 8, k // 8, 8).transpose(-3, -2).contiguous()


class AttnWeights(NamedTuple):
    """The kernel's weights in the layout of one dtype (``kernel_weights``):
    fp32 holds ``tf32_weights`` as ``tf32.chunked_hi_lo`` chunks of 16 k
    (TF32 hi then lo), wqkv (nh, 2 ns C) and wproj (nco, 2 ns ko); bf16
    holds the padded ``mma_weights`` in core-matrix order.  Biases are
    fp32."""
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor


def kernel_weights(wqkv, bqkv, wproj, bproj, num_heads: int,
                   dtype) -> AttnWeights:
    """wqkv (C, 3C), bqkv (3C,), wproj (C, C), bproj (C,) -> the layout
    the kernel reads for tokens of ``dtype``.  The caller that owns the
    weights builds it once and passes it as ``fused_window_attention(...,
    prepared=)``."""
    if dtype == torch.bfloat16:
        wq, wp = mma_weights(wqkv, wproj, num_heads)
        wq = core_matrices(wq.reshape(num_heads, 3 * wq.shape[2], wq.shape[3]))
        wp = core_matrices(wp)
    else:
        wq, wp = (chunked_hi_lo(w).contiguous()
                  for w in tf32_weights(wqkv, wproj, num_heads))
    return AttnWeights(wq, bqkv.float().contiguous(), wp,
                       bproj.float().contiguous())


def window_attention_plain(tokens, region, alive, wqkv, bqkv, wproj, bproj,
                           rel_bias, num_heads: int):
    """The kernel's arithmetic in PyTorch: every product accumulates in
    fp32; qkv, P and the head outputs are cast to the tokens' dtype where
    the kernel casts them."""
    dt = tokens.dtype
    nw, n, c = tokens.shape
    nh = num_heads
    hd = c // nh
    scale = hd ** -0.5
    qkv = (tokens.float() @ wqkv.to(dt).float() + bqkv.float()).to(dt)
    qkv = qkv.float().reshape(nw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                       # (nw, nh, n, hd)
    mask = torch.where(region[:, :, None] != region[:, None, :],
                       -100.0, 0.0).float()
    s = (q @ k.transpose(-1, -2)) * scale + rel_bias.float()[None] + \
        mask[:, None]
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ v).to(dt).float().permute(0, 2, 1, 3).reshape(nw, n, c)
    res = o @ wproj.to(dt).float() + bproj.float()
    return (res * alive.float().reshape(nw, 1, 1)).to(dt)


def fused_window_attention(tokens, region, alive, wqkv, bqkv, wproj, bproj,
                           rel_bias, num_heads: int,
                           prepared: AttnWeights | None = None):
    """tokens: (nW, N, C) fp32 or bf16; region: (nW, N) int32 region ids
    (zeros when unshifted); alive: (nW, 1) gate; wqkv (C, 3C), bqkv (3C,),
    wproj (C, C), bproj (C,); rel_bias: (nh, N, N) fp32.  Returns (nW, N, C)
    in tokens' dtype.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the tensor cores, bf16 or fp32 as 3xTF32 (N <= 64,
    C / heads <= 32, C % 8 == 0).  ``prepared``: the weights'
    ``kernel_weights`` for tokens' dtype, which the kernel then reads
    instead of laying the weights out again on every call.  Tensors that
    need a gradient get it from ``window_attention_plain``."""
    diff = (tokens, wqkv, bqkv, wproj, bproj, rel_bias)
    if needs_grad(diff):
        return fused_primal_plain_grad(
            lambda t, *w: fused_window_attention(
                t, region, alive, *w, num_heads=num_heads, prepared=prepared),
            lambda t, *w: window_attention_plain(
                t, region, alive, *w, num_heads=num_heads), diff)
    if tokens.device.type == "cpu":
        return window_attention_plain(tokens, region, alive, wqkv, bqkv,
                                      wproj, bproj, rel_bias, num_heads)
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device "
                         f"{tokens.device}")
    nw, n, c = tokens.shape
    nh = num_heads
    dt = tokens.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_window_attention: dtype {dt} not in {_DTYPES}")
    if n % 4 or c % 8 or c % nh or nh < 3:
        raise ValueError(f"fused_window_attention: needs N % 4 == 0, "
                         f"C % 8 == 0, C % heads == 0, heads >= 3 "
                         f"(N={n}, C={c}, heads={nh})")
    shapes = {"region": (region, (nw, n)), "alive": (alive, (nw, 1)),
              "wqkv": (wqkv, (c, 3 * c)), "bqkv": (bqkv, (3 * c,)),
              "wproj": (wproj, (c, c)), "bproj": (bproj, (c,)),
              "rel_bias": (rel_bias, (nh, n, n))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_window_attention: {name} shape "
                             f"{tuple(t.shape)} != {want}")
        if t.device != tokens.device:
            raise ValueError(f"fused_window_attention: {name} is on "
                             f"{t.device}, tokens on {tokens.device}")
    if not tokens.is_contiguous():
        raise ValueError("fused_window_attention: tokens must be contiguous")
    if region.dtype != torch.int32:
        raise TypeError("fused_window_attention: region must be int32")
    hd = c // nh
    bf16 = dt == torch.bfloat16
    if n > MMA_MAX_TOKENS or hd > MMA_MAX_HEAD_DIM:
        raise ValueError(f"fused_window_attention: needs N <= "
                         f"{MMA_MAX_TOKENS} and C / heads <= "
                         f"{MMA_MAX_HEAD_DIM} (N={n}, C={c}, heads={nh})")
    if tokens.data_ptr() % 16:            # 16-byte copies of token rows
        tokens = tokens.clone()
    reg = region.contiguous()
    gate = alive.float().contiguous()
    if prepared is None:
        prepared = kernel_weights(wqkv, bqkv, wproj, bproj, nh, dt)
    elif (prepared.wqkv.dtype != dt or prepared.wqkv.device != tokens.device
          or prepared.wqkv.numel() != (nh * 3 * _up16(hd) * _up16(c) if bf16
                                       else 2 * nh * tf32_geometry(c, nh)[1] * c)):
        raise ValueError("fused_window_attention: prepared weights do not "
                         "match tokens' dtype, device or width")
    wq, bq, wp, bp = prepared
    rb = rel_bias.float().contiguous()
    out = torch.empty_like(tokens)
    if nw:
        KERNEL.launch(tokens.data_ptr(), reg.data_ptr(), gate.data_ptr(),
                      wq.data_ptr(), bq.data_ptr(), wp.data_ptr(),
                      bp.data_ptr(), rb.data_ptr(), out.data_ptr(),
                      nw, n, c, nh, hd ** -0.5, int(bf16),
                      torch.cuda.current_stream(tokens.device).cuda_stream)
    return out
