"""Fused DSE enhancement tail: the CUDA kernel ``csrc/dse.cu`` and its
plain version.

Port of ``rgba_tpu/ops/pallas/dse.py::fused_dse``: first = 1x1 cio->32,
three blocks y += 3x3(act(3x3(y))), y += first, out = 1x1 32->cio (y) + x;
ReLU (RGB) or LeakyReLU 0.01 (mask).  The TPU kernel's 4-image lane
packing is TPU layout and not part of the function.  The kernel takes any
H and W.  Under autograd the kernel runs in the forward and the gradients
come from the plain version (``remat.py``).

Weights: w_in (cio, 32), b_in (32,), w3 (6, 288, 32) with rows (dy, dx,
ci) in the order enh1.conv1, enh1.conv2, ..., enh3.conv2, b3 (6, 32),
w_out (32, cio), b_out (cio,).  The kernel reads them in a layout of its
own (``kernel_weights``), which the module that owns the weights builds
once and passes as ``prepared=``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CudaKernel
from .nhwc import conv1x1, conv3x3
from .remat import fused_primal_plain_grad, needs_grad
from .tf32 import hi_lo_core
from .win_attn import core_matrices

KERNEL = CudaKernel("dse.cu", "rgba_dse", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
FILTERS = 32
MAX_CIO = 4


def dse_plain(x, w_in, b_in, w3, b3, w_out, b_out, leaky: bool):
    """The kernel's arithmetic in PyTorch: every product accumulates in
    fp32; first, each inner activation and each block's output are cast to
    x's dtype where the kernel casts them, and so is y + first before the
    output 1x1."""
    dt = x.dtype

    def act(v):
        return F.leaky_relu(v, 0.01) if leaky else F.relu(v)

    first = conv1x1(x, w_in, b_in).to(dt)
    y = first
    for blk in range(3):
        z = act(conv3x3(y, w3[2 * blk], b3[2 * blk])).to(dt)
        y = (conv3x3(z, w3[2 * blk + 1], b3[2 * blk + 1]) + y.float()).to(dt)
    merged = (y.float() + first.float()).to(dt)
    return (conv1x1(merged, w_out, b_out) + x.float()).to(dt)


def kernel_weights(w_in, b_in, w3, b3, w_out, b_out, dtype):
    """The weights -> the layout the kernel reads for activations of
    ``dtype``: weights in ``dtype``, biases fp32.  In bf16 each 3x3 becomes
    [out][in] (32, 288) in wgmma's K-major core-matrix order, (6, 9216); in
    fp32 each 3x3 becomes its nine taps in order, each [out][ci] (32, 32)
    as its TF32 hi then lo in core matrices of 8 x 4 (``tf32.hi_lo_core``),
    (6, 9 * 2048): the kernel streams a tap at a time."""
    if dtype == torch.bfloat16:
        w3 = core_matrices(w3.to(dtype).transpose(1, 2)).reshape(6, -1)
    else:
        w3 = hi_lo_core(w3.float().reshape(6, 9, FILTERS, FILTERS)
                        .transpose(2, 3)).reshape(6, -1)
    return (w_in.to(dtype).contiguous(), b_in.float().contiguous(),
            w3.to(dtype).contiguous(), b3.float().contiguous(),
            w_out.to(dtype).contiguous(), b_out.float().contiguous())


def fused_dse(x, w_in, b_in, w3, b3, w_out, b_out, leaky: bool,
              prepared=None):
    """x: (B, H, W, cio) NHWC, fp32 or bf16, cio <= 4.  Returns x's shape
    and dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel.  ``prepared``: the weights' ``kernel_weights`` for x's dtype,
    which the kernel then reads instead of laying the weights out again on
    every call.  Tensors that need a gradient get it from ``dse_plain``."""
    diff = (x, w_in, b_in, w3, b3, w_out, b_out)
    if needs_grad(diff):
        return fused_primal_plain_grad(
            lambda *a: fused_dse(*a, leaky=leaky, prepared=prepared),
            lambda *a: dse_plain(*a, leaky=leaky), diff)
    if x.device.type == "cpu":
        return dse_plain(x, w_in, b_in, w3, b3, w_out, b_out, leaky)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dse: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_dse: dtype {dt} not in {_DTYPES}")
    if x.dim() != 4 or x.shape[-1] > MAX_CIO:
        raise ValueError(f"fused_dse: x must be (B, H, W, cio <= {MAX_CIO}),"
                         f" got {tuple(x.shape)}")
    b, h, w, cio = x.shape
    f = FILTERS
    shapes = {"w_in": (w_in, (cio, f)), "b_in": (b_in, (f,)),
              "w3": (w3, (6, 9 * f, f)), "b3": (b3, (6, f)),
              "w_out": (w_out, (f, cio)), "b_out": (b_out, (cio,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_dse: {name} shape {tuple(t.shape)} != "
                             f"{want}")
        if t.device != x.device:
            raise ValueError(f"fused_dse: {name} is on {t.device}, x on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_dse: x must be contiguous NHWC")
    if prepared is None:
        prepared = kernel_weights(w_in, b_in, w3, b3, w_out, b_out, dt)
    elif (prepared[2].dtype != dt or prepared[2].device != x.device
          or prepared[0].shape != (cio, f) or prepared[2].shape[1] != 9 * f * f
          * (1 if dt == torch.bfloat16 else 2)):
        raise ValueError("fused_dse: prepared weights do not match x's "
                         "dtype, device or channels")
    return torch.ops.rgba_tpu_torch.dse(x, *prepared, leaky)


@torch.library.custom_op("rgba_tpu_torch::dse", mutates_args=(),
                         device_types="cuda")
def dse_op(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
           w3: torch.Tensor, b3: torch.Tensor, w_out: torch.Tensor,
           b_out: torch.Tensor, leaky: bool) -> torch.Tensor:
    """The kernel's launch as an operator (``torch.export`` keeps it in the
    graph): the inputs ``fused_dse`` checked, the weights in
    ``kernel_weights``' layout for x's dtype."""
    out = torch.empty_like(x)
    if x.numel():
        b, h, w, cio = x.shape
        KERNEL.launch(x.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
                      w3.data_ptr(), b3.data_ptr(), w_out.data_ptr(),
                      b_out.data_ptr(), out.data_ptr(), b, h, w, cio,
                      int(leaky), int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out


@dse_op.register_fake
def _dse_fake(x, *args):
    return torch.empty_like(x)
