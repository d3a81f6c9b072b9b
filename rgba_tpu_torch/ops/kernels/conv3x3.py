"""3x3 stride-1 fp32 convolutions on the tensor cores: the CUDA kernel
``csrc/conv3x3.cu`` and the kernel's walk in plain PyTorch.

``conv2d`` (``ops/conv.py``) routes here a ``Conv``'s 3x3 convolution at
stride 1 and padding 1 in fp32 on a CUDA tensor inside
``batch_invariant_scope`` (``takes_conv3x3``): the kernel takes the
whole batch in one launch, with an output element's sum order fixed by
(Cin, Cout) alone, where cuDNN ran each image on its own.  It replaces
no TPU kernel (the JAX package leaves convolutions to XLA).  Each product
is 3xTF32 (``tf32.py``).

K order: input channels in blocks of ``KC`` (zero past Cin), within a
block the 9 taps (dy, dx) row-major, within a tap the block's channels.
A (block, tap) is one unit of the weight layout (``kernel_weights``): the
kernel sums each unit from zero on the tensor cores and adds the unit
sums in order on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CudaKernel
from .remat import fused_primal_plain_grad, needs_grad
from .tf32 import hi_lo_core, split_tf32

KERNEL = CudaKernel("conv3x3.cu", "rgba_conv3x3", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])

KC = 32            # input channels per block (csrc/conv3x3.cu kKC)
TAPS = 9
TILE = (8, 16)     # output rows x columns of a block (kTH, kTW)


def block_n(cout: int) -> int:
    """The kernel's N tile for Cout: 16, 64 or 128 output channels."""
    return 16 if cout <= 16 else 64 if cout <= 64 else 128


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def kernel_weights(weight):
    """Torch conv weight (Cout, Cin, 3, 3) -> the flat fp32 layout the
    kernel reads: per N tile of ``block_n(Cout)`` rows, per channel block
    of ``KC``, per tap, the unit's (N tile x KC) weights as
    ``tf32.hi_lo_core`` (TF32 hi in K-major core matrices, then lo); rows
    past Cout and channels past Cin zero.  Conv modules build it once per
    weights (``ops/conv.py``)."""
    co, ci = weight.shape[:2]
    bn = block_n(co)
    wp = torch.zeros(_ceil(co, bn) * bn, _ceil(ci, KC) * KC, 3, 3,
                     device=weight.device)
    wp[:co, :ci] = weight.detach().float()
    units = wp.reshape(-1, bn, wp.shape[1] // KC, KC, TAPS)
    return hi_lo_core(units.permute(0, 2, 4, 1, 3)).reshape(-1).contiguous()


def check_shapes(x, weight, bias) -> None:
    """What the kernel takes: fp32, Cin a multiple of 8 (16-byte loads of
    whole k steps), Cout even (pairs of channels a store)."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"conv3x3: fp32 only, got {x.dtype} / {weight.dtype}")
    co, ci = weight.shape[:2]
    if tuple(weight.shape[2:]) != (3, 3) or x.shape[1] != ci:
        raise ValueError(f"conv3x3: weight {tuple(weight.shape)} does not "
                         f"fit x {tuple(x.shape)}")
    if ci % 8 or co % 2:
        raise ValueError(f"conv3x3: Cin={ci} must be a multiple of 8 and "
                         f"Cout={co} even")
    if bias is None or tuple(bias.shape) != (co,):
        raise ValueError(f"conv3x3: bias of shape ({co},) required")


def conv3x3(x, weight, bias, prepared=None):
    """conv2d(x, weight, bias, stride=1, padding=1) of fp32 x (B, Cin, H, W)
    on the card, the whole batch in one launch; returns (B, Cout, H, W) in
    channels_last.  x in channels_last is read in place.  ``prepared``:
    ``kernel_weights(weight)``, which the kernel then reads instead of
    laying the weights out on every call.  Tensors that need a gradient
    get it from ``F.conv2d``."""
    if needs_grad((x, weight, bias)):
        return fused_primal_plain_grad(
            lambda *a: conv3x3(*a, prepared=prepared),
            lambda t, wt, bt: F.conv2d(t, wt, bt, 1, 1), (x, weight, bias))
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: the kernel runs on CUDA tensors, got "
                         f"{x.device}")
    check_shapes(x, weight, bias)
    co = weight.shape[0]
    if prepared is None:
        prepared = kernel_weights(weight)
    elif (prepared.device != x.device or prepared.dtype != torch.float32
          or prepared.numel() != _prepared_numel(*weight.shape[:2])):
        raise ValueError("conv3x3: prepared weights do not match")
    rows = x.permute(0, 2, 3, 1).contiguous()
    if rows.data_ptr() % 16:
        rows = rows.clone()              # 16-byte loads
    b, h, w, ci = rows.shape
    bias = bias.float().contiguous()
    y = torch.empty(b, h, w, co, device=x.device, dtype=torch.float32)
    if y.numel():
        KERNEL.launch(rows.data_ptr(), prepared.data_ptr(), bias.data_ptr(),
                      y.data_ptr(), b, h, w, ci, co, block_n(co),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return y.permute(0, 3, 1, 2)


def _prepared_numel(co: int, ci: int) -> int:
    bn = block_n(co)
    return 2 * _ceil(co, bn) * bn * _ceil(ci, KC) * KC * TAPS


def conv3x3_plain(x, prepared, bias, cout: int):
    """The kernel's walk in PyTorch, for the tests: x (B, H, W, Cin) fp32
    NHWC -> (B, H, W, Cout).  Tiles of ``TILE`` pixels of one image, each
    halo gathered from the flat NHWC rows with the kernel's bounds checks
    (zero outside the tile's own image and past Cin), the weights read from
    the ``prepared`` layout; per unit, from zero, for each k step of 8 the
    three TF32 terms added in the kernel's order, each an 8-deep dot
    product in float64 rounded to fp32; the unit's sum added to the
    output's; the bias last."""
    b, h, w, ci = x.shape
    th, tw = TILE
    bn, nb = block_n(cout), _ceil(ci, KC)
    ntn = _ceil(cout, bn)
    # the halo of every tile: (tiles, th + 2, tw + 2, nb * KC)
    ti, tj = _ceil(h, th), _ceil(w, tw)
    img = torch.arange(b).view(-1, 1, 1, 1, 1)
    rr = (torch.arange(ti) * th).view(1, -1, 1, 1, 1) - 1 + \
        torch.arange(th + 2).view(1, 1, 1, -1, 1)
    cc = (torch.arange(tj) * tw).view(1, 1, -1, 1, 1) - 1 + \
        torch.arange(tw + 2).view(1, 1, 1, 1, -1)
    ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    flat = ((img * h + rr) * w + cc) * ok       # row 0 where out of range
    rows = torch.zeros(b * h * w, nb * KC)
    rows[:, :ci] = x.reshape(-1, ci).float()
    halo = rows[flat] * ok.unsqueeze(-1)
    halo = halo.reshape(-1, th + 2, tw + 2, nb * KC)
    # the weights per unit back from the core-matrix layout: (n, k) of the
    # hi and the lo of (N tile, block, tap)
    units = prepared.reshape(ntn, nb, TAPS, 2, bn // 8, KC // 4, 8, 4)
    units = units.permute(0, 1, 2, 3, 4, 6, 5, 7).reshape(
        ntn, nb, TAPS, 2, bn, KC)
    acc = torch.zeros(halo.shape[0] * th * tw, ntn * bn)
    for blk in range(nb):
        for t in range(TAPS):
            dy, dx = divmod(t, 3)
            a = halo[:, dy:dy + th, dx:dx + tw, blk * KC:(blk + 1) * KC]
            a_hi, a_lo = split_tf32(a.reshape(-1, KC))
            part = torch.zeros_like(acc)      # the unit's sum, from zero
            for s in range(KC // 8):
                ks = slice(8 * s, 8 * s + 8)
                for n in range(ntn):
                    b_hi = units[n, blk, t, 0, :, ks]
                    b_lo = units[n, blk, t, 1, :, ks]
                    cols = slice(n * bn, (n + 1) * bn)
                    for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                        part[:, cols] += (pa[:, ks].double()
                                          @ pb.double().t()).float()
            acc += part
    acc = acc[:, :cout] + bias.float()
    out = acc.reshape(b, ti, tj, th, tw, cout).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, ti * th, tj * tw, cout)[:, :h, :w]
