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
and biases b0 (3, C/2), b1 (3, C/2), b2 (3, C).  The kernel reads them in
a layout of its own (``kernel_weights``), which the module that owns the
weights builds once and passes as ``prepared=``.  bf16 runs every product
on the tensor cores in bf16, fp32 as 3xTF32 (``tf32.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import CudaKernel
from .nhwc import conv1x1, conv3x3
from .remat import fused_primal_plain_grad, needs_grad
from .tf32 import chunked_hi_lo
from .win_attn import _up16, core_matrices

KERNEL = CudaKernel("gate_chain.cu", "rgba_gate_chain", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
ACTS = ("relu", "gelu_erf", "gelu_tanh")
MAX_CHANNELS = 192   # the widest instantiation of csrc/gate_chain.cu: HP 96
CHUNK_K = 64         # k per weight chunk of the bf16 kernel's ring
HP32 = (16, 32, 40, 48, 64, 80, 96)   # the fp32 kernel's instantiations
# The fp32 kernel keeps h1 in the 3x3's accumulators, whose lane holds
# channels 2q, 2q + 1 of each 8, and reads them as the TF32 A fragment's k
# = q, q + 4: k 8j + p of the following 1x1 is channel 8j + H1_ORDER[p].
H1_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def padded_half(c: int, dtype) -> int:
    """HP, the kernel's width of the C/2-wide products: C/2 rounded up to
    16 in bf16 (the k16 step) and to an instantiation in ``HP32`` in fp32
    (a multiple of 8, the k8 step: 40 at C = 80 takes no padding)."""
    if dtype == torch.bfloat16:
        return _up16(c // 2)
    return next(hp for hp in HP32 if hp >= c // 2)


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


def chunked_core(w):
    """(..., n, k) -> (..., n * k): the bf16 kernel's stream of one weight
    matrix, chunks of CHUNK_K k (the last may be shorter), each in wgmma's
    K-major core-matrix order (``core_matrices``), one after the other;
    n and k multiples of 8."""
    k = w.shape[-1]
    return torch.cat([core_matrices(w[..., k0:k0 + CHUNK_K]).flatten(-4)
                      for k0 in range(0, k, CHUNK_K)], dim=-1)


def mma_weights(cw: GateChainWeights, dtype=torch.bfloat16):
    """One chain's matrices as the kernel multiplies them, [out][in] and
    zero padded, before the chunked layout: with half = C/2 and hp =
    ``padded_half(C, dtype)``, w0 (3, hp, C); w1 (3, hp, 9 * hp) with k =
    (tap, ci); w2 (3, nb, hp, hp), nb = ceil(C / hp) n-blocks of the C
    outputs, in fp32 its k in ``H1_ORDER`` within each 8."""
    c, half = cw.w0.shape[1], cw.w0.shape[2]
    hp = padded_half(c, dtype)
    nb = -(-c // hp)
    w0 = F.pad(cw.w0.transpose(1, 2), (0, 0, 0, hp - half))
    w1 = F.pad(cw.w1.reshape(3, 9, half, half),
               (0, hp - half, 0, hp - half)).permute(0, 3, 1, 2)
    w2 = F.pad(cw.w2.transpose(1, 2), (0, hp - half, 0, nb * hp - c))
    if dtype != torch.bfloat16:
        w2 = w2[..., h1_order(hp)]
    return w0, w1.reshape(3, hp, 9 * hp), w2.reshape(3, nb, hp, hp)


def h1_order(hp: int) -> torch.Tensor:
    """Channel of each k of the fp32 kernel's h1 product (``H1_ORDER``)."""
    return torch.tensor([8 * j + p for j in range(hp // 8) for p in H1_ORDER])


class GateKernelWeights(NamedTuple):
    """Everything the kernel reads besides x and g, in the layout of one
    dtype (``kernel_weights``): each chain as (w0, b0, w1, b1, w2, b2) and
    the final 1x1.  The weights are ``mma_weights`` and fw [out][in] (nb,
    hp, C): in bf16 as ``chunked_core`` streams, (3, hp * K) per matrix; in
    fp32 as ``tf32.chunked_hi_lo`` streams (chunks of 16 k, each its TF32
    hi then lo in core matrices of 8 x 4), (3, 2 * hp * K), each element
    fp32.  Biases are fp32."""
    trunk: tuple
    gate: tuple
    fw: torch.Tensor
    fb: torch.Tensor


def kernel_weights(trunk: GateChainWeights, gate: GateChainWeights, fw, fb,
                   dtype) -> GateKernelWeights:
    """The gate's weights -> the layout the kernel reads for activations
    of ``dtype``."""
    bf16 = dtype == torch.bfloat16

    def stream(w):
        return chunked_core(w.to(dtype)) if bf16 else chunked_hi_lo(w.float())

    def chain(cw):
        ws = [stream(w) for w in mma_weights(cw, dtype)]
        ws[2] = ws[2].reshape(3, -1)
        bs = [cw.b0, cw.b1, cw.b2]
        return tuple(t for w, b in zip(ws, bs)
                     for t in (w.contiguous(), b.float().contiguous()))
    c = fw.shape[0]
    hp = padded_half(c, dtype)
    nb = -(-c // hp)
    fwk = stream(F.pad(fw.t(), (0, 0, 0, nb * hp - c)).reshape(nb, hp, c))
    return GateKernelWeights(chain(trunk), chain(gate), fwk.contiguous(),
                             fb.float().contiguous())


def fused_gate_chain(x, g, trunk: GateChainWeights, gate: GateChainWeights,
                     fw, fb, act: str, post_act: bool,
                     prepared: GateKernelWeights | None = None):
    """x: (B, H, W, C) NHWC, fp32 or bf16; g: the same shape or None (g =
    x); fw (C, C) [in, out], fb (C,).  Returns x's shape and dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    ``prepared``: the weights' ``kernel_weights`` for x's dtype, which the
    kernel then reads instead of laying the weights out again on every
    call.  Tensors that need a gradient get it from ``gate_chain_plain``."""
    if act not in ACTS:
        raise ValueError(f"fused_gate_chain: act {act!r} not in {ACTS}")
    diff = (x, g, trunk, gate, fw, fb)
    if needs_grad((x, g, *trunk, *gate, fw, fb)):
        return fused_primal_plain_grad(
            lambda *a: fused_gate_chain(*a, act, post_act, prepared),
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
    step = 16 if bf16 else 8
    if c % step:
        raise ValueError(f"fused_gate_chain: {dt} needs C % {step} == 0 (the "
                         f"tensor-core K step), got C={c}")
    gg = None if g is None else g.to(dt).contiguous()
    xc = x
    if x.data_ptr() % 16:               # 16-byte copies of pixel rows
        xc = x.clone()
    if gg is not None and gg.data_ptr() % 16:
        gg = gg.clone()
    hp = padded_half(c, dt)
    if prepared is None:
        prepared = kernel_weights(trunk, gate, fw, fb, dt)
    elif (prepared.fw.dtype != dt or prepared.fw.device != x.device
          or prepared.fw.numel() != (-(-c // hp) * hp * c * (1 if bf16 else 2))):
        raise ValueError("fused_gate_chain: prepared weights do not match "
                         "x's dtype, device or width")
    out = torch.empty_like(xc)
    if x.numel():
        ptrs = (ctypes.c_void_p * 6)
        KERNEL.launch(xc.data_ptr(), None if gg is None else gg.data_ptr(),
                      ptrs(*[t.data_ptr() for t in prepared.trunk]),
                      ptrs(*[t.data_ptr() for t in prepared.gate]),
                      prepared.fw.data_ptr(), prepared.fb.data_ptr(),
                      out.data_ptr(), b, h, w, c, ACTS.index(act),
                      int(post_act), int(bf16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
