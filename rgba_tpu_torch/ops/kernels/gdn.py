"""Fused GDN / IGDN: the CUDA kernel ``csrc/gdn.cu`` and its plain version.

Port of ``rgba_tpu/ops/pallas/gdn.py::fused_gdn``:
y = x * rsqrt(x^2 @ gamma_t + beta) over (M, C) rows (sqrt for IGDN).
gamma_t and beta come in post-reparameterization.  Inference only.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KERNEL = CudaKernel("gdn.cu", "rgba_gdn", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 192   # csrc/gdn.cu: 12 column groups of 16 (fp32), one m64n192 wgmma (bf16)


def gdn_plain(x, gamma_t, beta, inverse: bool = False):
    """The kernel's arithmetic in PyTorch: x^2 rounded to x's dtype, the
    product with gamma_t (cast to x's dtype) accumulated in fp32, + beta,
    rsqrt or sqrt in fp32, times x, cast back."""
    dt = x.dtype
    c = x.shape[-1]
    xf = x.float()
    x2 = (xf * xf).to(dt).float().reshape(-1, c)
    norm = x2 @ gamma_t.to(dt).float() + beta.float()
    s = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (xf * s.reshape(x.shape)).to(dt)


def fused_gdn(x, gamma_t, beta, inverse: bool = False):
    """x: (..., C) contiguous, fp32 or bf16; gamma_t: (C, C) post-reparam,
    transposed so norm = x^2 @ gamma_t; beta: (C,) post-reparam.  Returns
    x's shape and dtype.  CPU tensors take the plain version; CUDA tensors
    launch the kernel: fp32 on the CUDA cores, bf16 on the tensor cores."""
    if x.device.type == "cpu":
        return gdn_plain(x, gamma_t, beta, inverse)
    c = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"fused_gdn: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_gdn: dtype {x.dtype} not in {_DTYPES}")
    if c % 16 or c > MAX_CHANNELS:
        raise ValueError(f"fused_gdn: C={c} must be a multiple of 16 and "
                         f"at most {MAX_CHANNELS}")
    if gamma_t.shape != (c, c) or beta.shape != (c,):
        raise ValueError(f"fused_gdn: gamma_t {tuple(gamma_t.shape)} / beta "
                         f"{tuple(beta.shape)} do not match C={c}")
    if not x.is_contiguous():
        raise ValueError("fused_gdn: x must be contiguous (NHWC rows)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma_t, beta)):
        raise RuntimeError("fused_gdn is inference-only (no backward yet): "
                           "call it under torch.inference_mode()")
    g = gamma_t.to(x.dtype).contiguous()
    b = beta.float().contiguous()
    for t in (g, b):
        if t.device != x.device:
            raise ValueError("fused_gdn: all inputs must be on x's device")
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        x = x.clone()                    # 16-byte copies of x rows
    y = torch.empty_like(x)
    m = x.numel() // c
    if m:
        KERNEL.launch(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                      m, c, int(inverse), int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return y
