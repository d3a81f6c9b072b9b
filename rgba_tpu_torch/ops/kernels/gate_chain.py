"""Fused gated conv chain: the CUDA kernel ``csrc/gate_chain.cu`` and its
plain version.

Port of ``rgba_tpu/ops/pallas/gate_chain.py::fused_gate_chain``:
out = x + chain_t(x) * sigmoid(1x1(chain_g(g))), each chain three
bottleneck blocks (1x1 C->C/2, act, 3x3, act, 1x1 C/2->C, + skip, optional
post-act).  The kernel takes any H and W (the TPU tile gate is a limit of
VMEM).  Under autograd the kernel runs in the forward and the gradients
come from the plain version (``remat.py``).

A chain's weights are a ``GateChainWeights`` with the three blocks stacked:
w0 (3, C, C/2), w1 (3, 9*C/2, C/2) with rows (dy, dx, ci), w2 (3, C/2, C)
and biases b0 (3, C/2), b1 (3, C/2), b2 (3, C).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import CudaKernel
from .nhwc import conv1x1, conv3x3
from .remat import fused_primal_plain_grad, needs_grad

KERNEL = CudaKernel("gate_chain.cu", "rgba_gate_chain", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
ACTS = ("relu", "gelu_erf", "gelu_tanh")
MAX_CHANNELS = 192   # register tiles of csrc/gate_chain.cu (12 x 16 columns)


class GateChainWeights(NamedTuple):
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def activation(v, act: str):
    if act == "relu":
        return F.relu(v)
    return F.gelu(v, approximate="tanh" if act == "gelu_tanh" else "none")


def _chain_plain(t, cw: GateChainWeights, act: str, post_act: bool):
    dt = t.dtype
    cur = t
    for blk in range(3):
        h0 = activation(conv1x1(cur, cw.w0[blk], cw.b0[blk]), act).to(dt)
        h1 = activation(conv3x3(h0, cw.w1[blk], cw.b1[blk]), act).to(dt)
        out = conv1x1(h1, cw.w2[blk], cw.b2[blk]) + cur.float()
        if post_act:
            out = activation(out, act)
        cur = out.to(dt)
    return cur


def gate_chain_plain(x, g, trunk: GateChainWeights, gate: GateChainWeights,
                     fw, fb, act: str, post_act: bool):
    """The kernel's arithmetic in PyTorch: every product accumulates in
    fp32; h0, h1 and each block's output are cast to x's dtype where the
    kernel casts them; the gate and the residual are fp32, cast once."""
    t = _chain_plain(x, trunk, act, post_act)
    a = _chain_plain(x if g is None else g.to(x.dtype), gate, act, post_act)
    s = torch.sigmoid(conv1x1(a, fw, fb))
    return (x.float() + t.float() * s).to(x.dtype)


def _kernel_layout(cw: GateChainWeights, dt, bf16: bool):
    """The chain's weights as the kernel reads them.  fp32: as given.  bf16
    (tensor cores): [out][in] matrices, the 3x3's per-tap input and the
    last 1x1's input zero-padded from C/2 to a multiple of 16."""
    ws = [cw.w0, cw.w1, cw.w2]
    if bf16:
        half = cw.w0.shape[-1]
        pad = -half % 16
        w1 = cw.w1.reshape(3, 9, half, half)
        ws = [cw.w0.transpose(1, 2),
              F.pad(w1, (0, 0, 0, pad)).permute(0, 3, 1, 2).reshape(
                  3, half, 9 * (half + pad)),
              F.pad(cw.w2, (0, 0, 0, pad)).transpose(1, 2)]
    bs = [cw.b0, cw.b1, cw.b2]
    return [t for w, b in zip(ws, bs)
            for t in (w.to(dt).contiguous(), b.float().contiguous())]


def fused_gate_chain(x, g, trunk: GateChainWeights, gate: GateChainWeights,
                     fw, fb, act: str, post_act: bool):
    """x: (B, H, W, C) NHWC, fp32 or bf16; g: the same shape or None (g =
    x); fw (C, C) [in, out], fb (C,).  Returns x's shape and dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    Tensors that need a gradient get it from ``gate_chain_plain``."""
    if act not in ACTS:
        raise ValueError(f"fused_gate_chain: act {act!r} not in {ACTS}")
    diff = (x, g, trunk, gate, fw, fb)
    if needs_grad((x, g, *trunk, *gate, fw, fb)):
        return fused_primal_plain_grad(
            lambda *a: fused_gate_chain(*a, act, post_act),
            lambda *a: gate_chain_plain(*a, act, post_act), diff)
    if x.device.type == "cpu":
        return gate_chain_plain(x, g, trunk, gate, fw, fb, act, post_act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gate_chain: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_gate_chain: dtype {dt} not in {_DTYPES}")
    if x.dim() != 4:
        raise ValueError(f"fused_gate_chain: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    half = c // 2
    if c % 2 or c > MAX_CHANNELS:
        raise ValueError(f"fused_gate_chain: C={c} must be even and at most "
                         f"{MAX_CHANNELS}")
    if g is not None and tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"fused_gate_chain: g shape {tuple(g.shape)} != x "
                         f"shape {tuple(x.shape)}")
    want = GateChainWeights((3, c, half), (3, half), (3, 9 * half, half),
                            (3, half), (3, half, c), (3, c))
    tensors = [x, fw, fb] + ([] if g is None else [g])
    for name, cw in (("trunk", trunk), ("gate", gate)):
        for field, t, shape in zip(cw._fields, cw, want):
            if tuple(t.shape) != shape:
                raise ValueError(f"fused_gate_chain: {name}.{field} shape "
                                 f"{tuple(t.shape)} != {shape}")
            tensors.append(t)
    if tuple(fw.shape) != (c, c) or tuple(fb.shape) != (c,):
        raise ValueError(f"fused_gate_chain: final weights {tuple(fw.shape)}"
                         f" / {tuple(fb.shape)} do not match C={c}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"fused_gate_chain: an input is on {t.device}, "
                             f"x on {x.device}")
    if not x.is_contiguous() or (g is not None and not g.is_contiguous()):
        raise ValueError("fused_gate_chain: x and g must be contiguous NHWC")
    bf16 = dt == torch.bfloat16
    if bf16 and c % 16:
        raise ValueError(f"fused_gate_chain: bf16 needs C % 16 == 0 (the "
                         f"tensor-core K step), got C={c}")
    gg = None if g is None else g.to(dt).contiguous()
    tw_ = _kernel_layout(trunk, dt, bf16)
    gw_ = _kernel_layout(gate, dt, bf16)
    fwc = (fw.t() if bf16 else fw).to(dt).contiguous()
    fbc = fb.float().contiguous()
    out = torch.empty_like(x)
    if x.numel():
        ptrs = (ctypes.c_void_p * 6)
        KERNEL.launch(x.data_ptr(), None if gg is None else gg.data_ptr(),
                      ptrs(*[t.data_ptr() for t in tw_]),
                      ptrs(*[t.data_ptr() for t in gw_]),
                      fwc.data_ptr(), fbc.data_ptr(), out.data_ptr(),
                      b, h, w, c, ACTS.index(act), int(post_act), int(bf16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
