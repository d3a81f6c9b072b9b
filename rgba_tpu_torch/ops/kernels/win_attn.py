"""Fused masked window attention: the CUDA kernel ``csrc/win_attn.cu`` and
its plain version.

Port of ``rgba_tpu/ops/pallas/win_attn.py::fused_window_attention``.  Per
window: qkv projection, per-head scores + relative-position bias - 100
wherever two tokens' region ids differ, fp32 softmax, P.V, output
projection, times the alive gate.  Output is pre-residual; dead windows
are exactly zero.  Inference only.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KERNEL = CudaKernel("win_attn.cu", "rgba_win_attn", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)


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
                           rel_bias, num_heads: int):
    """tokens: (nW, N, C) fp32 or bf16; region: (nW, N) int32 region ids
    (zeros when unshifted); alive: (nW, 1) gate; wqkv (C, 3C), bqkv (3C,),
    wproj (C, C), bproj (C,); rel_bias: (nh, N, N) fp32.  Returns (nW, N, C)
    in tokens' dtype.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
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
    if n % 4 or c % 4 or c % nh or nh < 3:
        raise ValueError(f"fused_window_attention: needs N % 4 == 0, "
                         f"C % 4 == 0, C % heads == 0, heads >= 3 "
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (tokens, wqkv, bqkv, wproj, bproj,
                                      rel_bias)):
        raise RuntimeError("fused_window_attention is inference-only (no "
                           "backward yet): call it under torch.inference_mode()")
    if region.dtype != torch.int32:
        raise TypeError("fused_window_attention: region must be int32")
    hd = c // nh
    reg = region.contiguous()
    gate = alive.float().contiguous()
    wq = wqkv.to(dt).contiguous()
    wp = wproj.to(dt).contiguous()
    bq = bqkv.float().contiguous()
    bp = bproj.float().contiguous()
    rb = rel_bias.float().contiguous()
    out = torch.empty_like(tokens)
    if nw:
        KERNEL.launch(tokens.data_ptr(), reg.data_ptr(), gate.data_ptr(),
                      wq.data_ptr(), bq.data_ptr(), wp.data_ptr(),
                      bp.data_ptr(), rb.data_ptr(), out.data_ptr(),
                      nw, n, c, nh, hd ** -0.5, int(dt == torch.bfloat16),
                      torch.cuda.current_stream(tokens.device).cuda_stream)
    return out
