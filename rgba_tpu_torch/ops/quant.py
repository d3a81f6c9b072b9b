"""Dynamic W8A8 int8 convolution for serving (port of ``rgba_tpu/ops/quant.py``).

The JAX package's recipe, step for step:

  * weights: a symmetric scale per output channel, max|w| / 127 over the
    input channels and taps (floored at 1e-12);
  * activations: one symmetric scale for the whole tensor, max|x| / 127
    over the whole batch (floored at 1e-12), computed on the fly;
  * ``round`` (half to even in both libraries), clip to [-127, 127], int8;
  * the integer convolution accumulates in int32;
  * dequantize ``acc.float() * (sx * sw)``, in that order, cast to the
    output dtype; the caller adds the bias afterwards in the compute dtype
    (``policy_conv``), as the JAX ``Conv`` does.

The integer product is ``torch._int_mm`` (int8 x int8 -> int32; cuBLASLt on
the card) over an im2col of the quantized activation in NHWC order: a
library call, as the JAX package leaves this convolution to XLA.  The
im2col is built from ``Tensor.unfold`` views of the zero-padded int8
tensor, which take any dtype.  ``_int_mm`` takes more than 16 rows and K
and N multiples of 8, and cuBLASLt's int8 product on the H100 refuses an N
of 40 (``CUBLAS_STATUS_NOT_SUPPORTED``): the channels are padded with zeros
to a multiple of 8, K and the output channels to multiples of 16, and a
short product gets zero rows; each padding adds exact zeros, sliced off
after.  The im2col is
built a few images at a time (at most ``IM2COL_BYTES`` a chunk), so a
full-resolution 5x5 convolution never holds a multi-GB matrix.

A transposed convolution is the JAX package's input-dilated convolution
with the flipped kernel.  int32 sums are exact in any order, so it runs as
stride^2 output phases instead: output rows s*m + r take the taps q = r + p
(mod s) of the undilated input, a stride-1 convolution of at most
ceil(k / s) taps a side (3x3 for k=5, s=2) whose accumulators are the
dilated convolution's, without multiplying the inserted zeros.

Under ``torch.profiler`` the stages run in spans (``utils/trace.span``)
named ``int8.quantize``, ``int8.im2col``, ``int8.int_mm`` and
``int8.dequantize``, whose device time ``chip_smoke.py`` reads; without
the profiler they are not opened.

Serving only: ``round`` has no gradient, and the per-tensor activation
scale couples every image to its batchmates, so the int8 branch never runs
one image at a time (``ops.conv.per_image``) and the codec, which pins
fp32, never takes it.
"""

from __future__ import annotations

import torch

from ..utils.trace import span

_EPS = 1e-12
QMAX = 127
IM2COL_BYTES = 1 << 30      # the largest im2col chunk, in bytes


def quantize_activation(x):
    """(int8 x, fp32 scale): one symmetric scale for the whole tensor."""
    scale = torch.clamp_min(x.abs().amax().float() / 127.0, _EPS)
    xq = torch.round(x.float() / scale).clamp_(-QMAX, QMAX)
    return xq.to(torch.int8), scale


def quantize_weight(w, transposed: bool = False):
    """(int8 w, fp32 scale per output channel) of a weight in torch layout:
    Conv (O, I, kh, kw), ConvTranspose (I, O, kh, kw)."""
    wf = w.float()
    dims = (0, 2, 3) if transposed else (1, 2, 3)
    scale = torch.clamp_min(wf.abs().amax(dim=dims, keepdim=True) / 127.0,
                            _EPS)
    wq = torch.round(wf / scale).clamp_(-QMAX, QMAX).to(torch.int8)
    return wq, scale.reshape(-1)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_crop(x, top: int, bottom: int, left: int, right: int, channels: int):
    """NHWC x with zero rows and columns added (negative: cut off) and its
    channels zero-padded to ``channels``."""
    b, h, w, c = x.shape
    x = x[:, max(0, -top):h - max(0, -bottom), max(0, -left):w - max(0, -right)]
    top, bottom, left, right = (max(0, v) for v in (top, bottom, left, right))
    if (top, bottom, left, right, channels) == (0, 0, 0, 0, c):
        return x
    out = x.new_zeros((b, x.shape[1] + top + bottom, x.shape[2] + left + right,
                       channels))
    out[:, top:top + x.shape[1], left:left + x.shape[2], :c] = x
    return out


def _conv_phase(xq, wk, stride: int, pads, emit):
    """The int32 accumulators of a convolution of NHWC int8 ``xq`` with the
    int8 kernel ``wk`` (kh, kw, C, O), ``pads`` (top, bottom, left, right)
    (negative: rows or columns cut off), as ``_int_mm`` over the im2col, a
    chunk of images at a time: ``emit(b0, b1, acc)`` with acc (b1 - b0, Ho,
    Wo, O) int32."""
    b, h, w, c = xq.shape
    kh, kw, _, o = wk.shape
    cp = _up(c, 8)
    k = kh * kw * cp
    kp, op = _up(k, 16), _up(o, 16)
    wmat = wk.new_zeros((kp, op))
    wmat[:k].view(kh, kw, cp, op)[:, :, :c, :o] = wk
    # (K, N) in column-major order, as cuBLASLt's int8 product takes it
    wmat = wmat.t().contiguous().t()
    ho = (h + pads[0] + pads[1] - kh) // stride + 1
    wo = (w + pads[2] + pads[3] - kw) // stride + 1
    per = max(1, IM2COL_BYTES // max(1, ho * wo * kp))
    for b0 in range(0, b, per):
        b1 = min(b, b0 + per)
        with span("int8.im2col"):
            xp = _pad_crop(xq[b0:b1], *pads, cp)
            if kh == kw == stride == 1:
                src = xp
            else:
                # (n, Ho, Wo, C, kh, kw) -> rows of (kh, kw, C)
                src = xp.unfold(1, kh, stride).unfold(2, kw, stride) \
                    .permute(0, 1, 2, 4, 5, 3)
            rows = (b1 - b0) * ho * wo
            if kp == k and rows > 16:
                a = src.reshape(rows, k).contiguous()
            else:
                a = xp.new_zeros((max(rows, 17), kp))
                a[:rows, :k].view(src.shape).copy_(src)
        with span("int8.int_mm"):
            acc = torch._int_mm(a, wmat)[:rows, :o]
        emit(b0, b1, acc.reshape(b1 - b0, ho, wo, o))


def _phase_taps(k: int, s: int, p: int, r: int):
    """Taps of output phase r of a transposed convolution along one axis:
    (tap indexes as the phase's stride-1 kernel reads them, pad before)."""
    q0 = (r + p) % s
    taps = list(range(q0, k, s))
    d = (r + p - q0) // s
    return taps[::-1], len(taps) - 1 - d


def _accumulate(xq, wq, stride: int, padding: int, transposed: bool,
                out_shape, emit):
    """emit(b0, b1, rows, cols, acc) for every chunk and phase of the int8
    convolution of ``xq`` (B, C, H, W) with ``wq`` in torch layout, whose
    output is ``out_shape`` (B, Ho, Wo, O): acc holds output[b0:b1, rows,
    cols] as NHWC int32."""
    x = xq.permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    k, s, p = wq.shape[2], stride, padding
    _, ho, wo, _ = out_shape
    if not transposed:
        wk = wq.permute(2, 3, 1, 0)                  # (kh, kw, I, O)
        _conv_phase(x, wk, s, (p, p, p, p),
                    lambda b0, b1, acc: emit(b0, b1, slice(None), slice(None),
                                             acc))
        return
    wk = wq.permute(2, 3, 0, 1)                      # (kh, kw, I, O)
    for rh in range(s):
        taps_h, lo_h = _phase_taps(k, s, p, rh)
        mh = -(-(ho - rh) // s)
        for rw in range(s):
            taps_w, lo_w = _phase_taps(k, s, p, rw)
            mw = -(-(wo - rw) // s)
            if mh <= 0 or mw <= 0 or not taps_h or not taps_w:
                continue
            kern = wk[taps_h][:, taps_w]
            hi_h = mh - 1 + len(taps_h) - lo_h - h
            hi_w = mw - 1 + len(taps_w) - lo_w - w
            rows, cols = slice(rh, None, s), slice(rw, None, s)
            _conv_phase(x, kern, 1, (lo_h, hi_h, lo_w, hi_w),
                        lambda b0, b1, acc, r=rows, c=cols: emit(b0, b1, r, c,
                                                                 acc))


def _output(xq, wq, transposed: bool, stride: int, padding: int,
            output_padding: int):
    """The output's (B, Ho, Wo, O) without running the convolution."""
    b, _, h, w = xq.shape
    k = wq.shape[2]
    if transposed:
        ho = (h - 1) * stride - 2 * padding + k + output_padding
        wo = (w - 1) * stride - 2 * padding + k + output_padding
        return b, ho, wo, wq.shape[1]
    return (b, (h + 2 * padding - k) // stride + 1,
            (w + 2 * padding - k) // stride + 1, wq.shape[0])


def int8_accumulate(xq, wq, stride: int = 1, padding: int = 0,
                    transposed: bool = False, output_padding: int = 0):
    """The int32 accumulators, (B, Ho, Wo, O) NHWC, of the convolution of
    int8 ``xq`` (B, C, H, W) with int8 ``wq`` in torch layout (Conv, or
    ConvTranspose with ``transposed``): the sums the JAX package's integer
    ``conv_general_dilated`` gives, exactly."""
    out = xq.new_zeros(_output(xq, wq, transposed, stride, padding,
                               output_padding), dtype=torch.int32)

    def emit(b0, b1, rows, cols, acc):
        out[b0:b1, rows, cols] = acc
    _accumulate(xq, wq, stride, padding, transposed, out.shape, emit)
    return out


def int8_conv(x, weight, stride: int = 1, padding: int = 0,
              transposed: bool = False, output_padding: int = 0,
              out_dtype=None):
    """The dynamic W8A8 convolution of x (B, C, H, W) with ``weight`` in
    torch layout, no bias: (B, O, Ho, Wo) in ``out_dtype`` (x's by
    default), a view of NHWC memory (channels_last)."""
    out_dtype = out_dtype or x.dtype
    with span("int8.quantize"):
        xq, sx = quantize_activation(x)
        wq, sw = quantize_weight(weight, transposed)
        scale = sx * sw
    # a transposed convolution with stride > k leaves output phases no tap
    # reaches: zeros, as the input-dilated convolution gives them
    new = torch.zeros if transposed and stride > weight.shape[2] else \
        torch.empty
    out = new(_output(xq, wq, transposed, stride, padding, output_padding),
              dtype=out_dtype, device=x.device)

    def emit(b0, b1, rows, cols, acc):
        with span("int8.dequantize"):
            out[b0:b1, rows, cols] = (acc.float() * scale).to(out_dtype)
    _accumulate(xq, wq, stride, padding, transposed, out.shape, emit)
    return out.permute(0, 3, 1, 2)


def policy_conv(x, weight, bias, policy, stride: int = 1, padding: int = 0,
                transposed: bool = False, output_padding: int = 0):
    """A call site's convolution under ``policy.int8_conv``: x cast to the
    compute dtype, the int8 convolution, then the bias added in the compute
    dtype.  The one place the recipe is applied, for ``Conv``,
    ``ConvTranspose`` and the plain gate-chain and DSE convolutions; it
    refuses a policy without the flag, so no caller reaches a float
    convolution through it."""
    if not policy.int8_conv:
        raise ValueError("policy_conv is the int8 route: the policy has "
                         "int8_conv=False")
    dt = policy.compute_dtype
    y = int8_conv(x.to(dt), weight, stride, padding, transposed,
                  output_padding, out_dtype=dt)
    return y + bias.to(dt).reshape(1, -1, 1, 1)
