"""Fused GDN / IGDN: the CUDA kernel ``csrc/gdn.cu`` and its plain version.

Port of ``rgba_tpu/ops/pallas/gdn.py::fused_gdn``:
y = x * rsqrt(x^2 @ gamma_t + beta) over (M, C) rows (sqrt for IGDN).
gamma_t and beta come in post-reparameterization.  Under autograd the
kernel runs in the forward and the gradients come from the plain version
(``remat.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel
from .remat import fused_primal_plain_grad, needs_grad
from .tf32 import chunked_hi_lo

KERNEL = CudaKernel("gdn.cu", "rgba_gdn", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 256   # csrc/gdn.cu: m64n192 wgmma to 192, two m64n128 past it
# fp32: the k of each 8 as the kernel's registers hold x (csrc/gdn.cu): k
# 8j + p of the product is channel 8j + K_ORDER[p]
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_passes(c: int) -> tuple:
    """(NT, passes) of the fp32 kernel at C=c: the width of one product
    and how many cover the channels (csrc/gdn.cu)."""
    return (192, 1) if c <= 192 else (128, 2)


def kernel_weights(gamma_t, dtype):
    """gamma_t (C, C) [in][out] post-reparam -> the layout the kernel reads
    for x of ``dtype``: bf16 keeps (C, C) in bf16 (the kernel stages it);
    fp32 gives the B operand [out n < NT passes][in k < C] (rows n >= C
    zero, k permuted within each 8 by ``K_ORDER``), cut into its passes of
    NT rows (``tf32_passes``), each as ``tf32.chunked_hi_lo`` chunks of 16
    k: 2 * 192 * C floats to C=192, 2 * 256 * C past it.  The module that
    owns gamma builds it once per weights and passes it as
    ``fused_gdn(..., prepared=)``."""
    if dtype == torch.bfloat16:
        return gamma_t.to(dtype).contiguous()
    c = gamma_t.shape[0]
    nt, passes = tf32_passes(c)
    order = torch.tensor([8 * (k // 8) + K_ORDER[k % 8] for k in range(c)],
                         device=gamma_t.device)
    b = torch.zeros(nt * passes, c, device=gamma_t.device)
    b[:c] = gamma_t.float()[order].t()
    return chunked_hi_lo(b.reshape(passes, nt, c)).reshape(-1).contiguous()


def _prepared_numel(c: int, dtype) -> int:
    if dtype == torch.bfloat16:
        return c * c
    nt, passes = tf32_passes(c)
    return 2 * nt * passes * c


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


def fused_gdn(x, gamma_t, beta, inverse: bool = False, prepared=None):
    """x: (..., C) contiguous, fp32 or bf16; gamma_t: (C, C) post-reparam,
    transposed so norm = x^2 @ gamma_t; beta: (C,) post-reparam.  Returns
    x's shape and dtype.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the tensor cores (bf16; fp32 as 3xTF32).
    ``prepared``: gamma_t's ``kernel_weights`` for x's dtype, which the
    kernel then reads instead of laying gamma_t out on every call.  Tensors
    that need a gradient get it from ``gdn_plain``."""
    if needs_grad((x, gamma_t, beta)):
        return fused_primal_plain_grad(
            lambda *a: fused_gdn(*a, inverse=inverse, prepared=prepared),
            lambda *a: gdn_plain(*a, inverse=inverse), (x, gamma_t, beta))
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
    if prepared is None:
        prepared = kernel_weights(gamma_t, x.dtype)
    elif (prepared.dtype != x.dtype or prepared.device != x.device
          or prepared.numel() != _prepared_numel(c, x.dtype)):
        raise ValueError("fused_gdn: prepared gamma does not match x's "
                         "dtype, device or width")
    b = beta.float().contiguous()
    for t in (prepared, b):
        if t.device != x.device:
            raise ValueError("fused_gdn: all inputs must be on x's device")
    return torch.ops.rgba_tpu_torch.gdn(x, prepared, b, inverse)


@torch.library.custom_op("rgba_tpu_torch::gdn", mutates_args=(),
                         device_types="cuda")
def gdn_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           inverse: bool) -> torch.Tensor:
    """The kernel's launch as an operator (``torch.export`` keeps it in the
    graph): the inputs ``fused_gdn`` checked, gamma in ``kernel_weights``'
    layout for x's dtype."""
    if x.data_ptr() % 16:
        x = x.clone()                    # 16-byte (bf16) / 8-byte (fp32) loads
    c = x.shape[-1]
    y = torch.empty_like(x)
    m = x.numel() // c
    if m:
        KERNEL.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr(), m, c, int(inverse),
                      int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return y


@gdn_op.register_fake
def _gdn_fake(x, *args):
    return torch.empty_like(x)
