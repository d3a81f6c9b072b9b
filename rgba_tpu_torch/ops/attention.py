"""Masked window attention, the paper's core op, and the gate blocks
around it (port of ``rgba_tpu/ops/attention.py``).

Windows of alpha-empty pixels output exactly 0 before the residual add
(the reference's ``remove_zero_windows``).  With ``policy.fused_win_attn``
the attention runs in the CUDA kernel ``ops/kernels/win_attn.py``, which
takes the shifted-window mask as region ids and the gate as ``alive``;
otherwise the additive-bias formulation below runs in PyTorch.  With
``policy.fused_gate_chain`` the whole gate, x + trunk(x) * sigmoid(1x1(
chain(g))), of ``WinGateAttention`` and ``SimplifiedAttention`` runs in the
CUDA kernel ``ops/kernels/gate_chain.py``, with the parameters of the same
modules (the state-dict keys do not change).  Under autograd each kernel
site runs its kernel in the forward and takes its gradients from the
module's own plain path, a pure function of the weights
(``ops/kernels/remat.py``), as the JAX modules do.

Under height sharding (``parallel/spatial.py``) the cyclic shift over H
is a ring shift across the bands (the shift over W stays a roll), each
band's windows take their region ids from the whole image's rows of the
band, and a gate runs on its band with 3 rows of each neighbour (one per
3x3 convolution of a chain; none past the image's edges, where each layer
pads itself), whose result's band rows are kept.

Module and parameter names follow the reference's state-dict keys
(``attn.attn.qkv``, ``conv_a.0.conv.0``, ``trunk_ResBlock1.conv1`` ...).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..core import init
from ..core.precision import Policy
from ..parallel import spatial
from .conv import Conv, GELU, conv2d
from .kernels import gate_chain as gck
from .kernels.cache import cached_layout
from .kernels.gate_chain import (GateChainWeights, activation,
                                 fused_gate_chain)
from .kernels.nhwc import hwio3x3, io1x1
from .kernels.remat import fused_primal_plain_grad
from .kernels.win_attn import fused_window_attention, kernel_weights
from .window import (relative_position_index, swin_attention_bias,
                     swin_region_ids, window_alive, window_partition,
                     window_reverse)


class WindowAttention(nn.Module):
    """W-MSA over (nWB, N, C) token windows with relative-position bias."""

    def __init__(self, dim: int, window_size: int, num_heads: int = 8, *,
                 policy: Policy, device, generator):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.policy = policy
        self.relative_position_bias_table = init.truncated_normal(
            ((2 * window_size - 1) ** 2, num_heads), 0.02, generator, device)
        self.qkv = torch.nn.utils.skip_init(nn.Linear, dim, 3 * dim,
                                            device=device)
        self.proj = torch.nn.utils.skip_init(nn.Linear, dim, dim,
                                             device=device)
        # JAX keeps (in, out) kernels drawn with lecun_normal; torch Linear
        # stores (out, in), so draw in JAX's layout and transpose
        self.qkv.weight = nn.Parameter(init.lecun_normal(
            (dim, 3 * dim), dim, generator, device).data.t().contiguous())
        self.qkv.bias = init.zeros((3 * dim,), device)
        self.proj.weight = nn.Parameter(init.lecun_normal(
            (dim, dim), dim, generator, device).data.t().contiguous())
        self.proj.bias = init.zeros((dim,), device)
        idx = torch.from_numpy(relative_position_index(window_size).reshape(-1))
        self.register_buffer("relative_position_index", idx.to(device),
                             persistent=False)
        self._kernel_cache = (None, None)   # (key, (AttnWeights, rel_bias))

    def rel_bias(self):
        """(nh, N, N) fp32 gather of the bias table."""
        n = self.window_size ** 2
        rb = self.relative_position_bias_table[self.relative_position_index]
        return rb.reshape(n, n, self.num_heads).permute(2, 0, 1).float()

    def kernel_inputs(self, dtype):
        """The kernel's weight layout for ``dtype`` and the contiguous
        rel_bias, built once and kept until a parameter is written or
        moved (its version or storage changes; inference tensors keep no
        version, so only a move counts for them)."""
        params = (self.qkv.weight, self.qkv.bias, self.proj.weight,
                  self.proj.bias, self.relative_position_bias_table)
        return cached_layout(self, params, dtype, lambda: (
            kernel_weights(self.qkv.weight.t(), self.qkv.bias,
                           self.proj.weight.t(), self.proj.bias,
                           self.num_heads, dtype),
            self.rel_bias().contiguous()))

    def _dense(self, x, wqkv, bqkv, wproj, bproj, rel_bias, bias=None):
        """The plain formulation on explicit weights in torch layout
        ([out][in]); x: (nWB, N, C) in the compute dtype."""
        nwb, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        scale = hd ** -0.5
        dt = self.policy.compute_dtype
        qkv = F.linear(x, wqkv.to(dt), bqkv.to(dt))
        q = qkv[..., :c].reshape(nwb, n, nh, hd)
        k = qkv[..., c:2 * c].reshape(nwb, n, nh, hd)
        v = qkv[..., 2 * c:].reshape(nwb, n, nh, hd)
        # fp32 accumulates scores in fp32; bf16 keeps them bf16 (the softmax
        # itself still reduces in fp32)
        attn = torch.einsum("wnhd,wmhd->whnm", q * scale, k)
        attn = attn + rel_bias[None].to(attn.dtype)
        if bias is not None:
            nw = bias.shape[0]
            attn = attn.reshape(nwb // nw, nw, nh, n, n) + \
                bias[None, :, None].to(attn.dtype)
            attn = attn.reshape(nwb, nh, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(dt)
        out = torch.einsum("whnm,wmhd->wnhd", attn, v).to(dt)
        return F.linear(out.reshape(nwb, n, c), wproj.to(dt), bproj.to(dt))

    def forward(self, x, bias=None, fused=None):
        """x: (nWB, N, C).  ``bias``: optional (nW, N, N) additive shifted-
        window mask, tiled over the batch.  ``fused=(region, alive)`` routes
        through the kernel: region (nWB, N) int32, alive (nWB, 1)."""
        dt = self.policy.compute_dtype
        if fused is None:
            return self._dense(x.to(dt), self.qkv.weight, self.qkv.bias,
                               self.proj.weight, self.proj.bias,
                               self.rel_bias(), bias)
        region, alive = fused
        wts, rel_bias = self.kernel_inputs(dt)
        if torch.is_grad_enabled():
            rel_bias = self.rel_bias()        # differentiable to the table

        def plain(t, wq, bq, wp, bp, rb):
            """The dense path above with the kernel's mask and gate: -100
            wherever two tokens' region ids differ, times alive."""
            mask = torch.where(region[:, :, None] == region[:, None, :],
                               0.0, -100.0)
            out = self._dense(t, wq.t(), bq, wp.t(), bp, rb, mask)
            return out * alive[:, :, None].to(dt)

        return fused_primal_plain_grad(
            lambda t, *w: fused_window_attention(
                t, region, alive, *w, num_heads=self.num_heads, prepared=wts),
            plain,
            (x.to(dt).contiguous(), self.qkv.weight.t(), self.qkv.bias,
             self.proj.weight.t(), self.proj.bias, rel_bias))


class MaskedWinBlock(nn.Module):
    """Swin block gated by a per-pixel alpha: alpha rolls with x under the
    cyclic shift, windows whose alpha sums to 0 output exactly 0, and the
    unshifted input is added back."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0, *, policy: Policy, device, generator):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.policy = policy
        self.attn = WindowAttention(dim, window_size, num_heads,
                                    policy=policy, device=device,
                                    generator=generator)
        # (kind, h, w, b, device, band offset, image height) -> region ids
        # or bias tensors
        self._masks = {}

    def _static(self, kind: str, h: int, w: int, b: int, device,
                offset: int = 0, global_h: int = 0):
        """Region ids or the additive bias of the shifted windows of a band
        of ``h`` rows at row ``offset`` of an image of ``global_h`` rows
        (the whole image by default), kept per shape and band (not while
        the forward is traced: a traced tensor must not outlive its
        trace)."""
        key = (kind, h, w, b, device, offset, global_h)
        if key in self._masks:
            return self._masks[key]
        ws, ss = self.window_size, self.shift_size
        if kind == "region":
            t = torch.from_numpy(swin_region_ids(h, w, ws, ss, offset,
                                                 global_h))
            t = t.to(device).repeat(b, 1)
        else:
            t = torch.from_numpy(swin_attention_bias(h, w, ws, ss, offset,
                                                     global_h))
            t = t.to(device)
        if not torch.compiler.is_compiling():
            self._masks[key] = t
        return t

    def forward(self, x, alpha=None):
        """x: (B, C, H, W); alpha: (B, 1, H, W) alpha at this scale, or None
        for the unmasked Swin twin."""
        b, c, h, w = x.shape
        ws, ss = self.window_size, self.shift_size
        if h % ws:
            raise ValueError(f"a band of {h} rows does not hold whole "
                             f"windows of {ws}")
        band = (b, x.device, spatial.band_offset(h), spatial.global_height(h))
        shortcut = x
        xh = x.permute(0, 2, 3, 1)
        ah = None if alpha is None else alpha.permute(0, 2, 3, 1)
        if ss > 0:
            xh = torch.roll(spatial.roll(xh, -ss, 1), -ss, 2)
            if ah is not None:
                ah = torch.roll(spatial.roll(ah, -ss, 1), -ss, 2)
        tokens = window_partition(xh, ws).reshape(-1, ws * ws, c)
        alive = None if ah is None else window_alive(window_partition(ah, ws))

        if self.policy.fused_win_attn:
            region = self._static("region", h, w, *band)
            gate = (alive if alive is not None else
                    torch.ones(tokens.shape[0], device=x.device))
            attn = self.attn(tokens, fused=(region, gate[:, None]))
        else:
            bias = (self._static("bias", h, w, *band) if ss > 0
                    else None)
            attn = self.attn(tokens, bias)
            if alive is not None:
                attn = attn * alive[:, None, None].to(attn.dtype)
        out = window_reverse(attn.reshape(-1, ws, ws, c), ws, h, w)
        if ss > 0:
            out = torch.roll(spatial.roll(out, ss, 1), ss, 2)
        return shortcut + out.permute(0, 3, 1, 2)


def _bottleneck(dim: int, policy, device, generator):
    """1x1 C->C/2, GELU, 3x3, GELU, 1x1 C/2->C (convs at 0, 2, 4)."""
    kw = dict(policy=policy, device=device, generator=generator)
    return nn.Sequential(Conv(dim, dim // 2, 1, 1, **kw), GELU(policy),
                         Conv(dim // 2, dim // 2, 3, 1, **kw), GELU(policy),
                         Conv(dim // 2, dim, 1, 1, **kw))


def bottleneck_block(x, p, policy: Policy, act: str, post_act: bool):
    """x + 1x1(act(3x3(act(1x1(x))))), then act if ``post_act``, as a pure
    function of the three convs' (weight, bias) pairs p in torch layout."""
    y = activation(conv2d(x, p[0], p[1], policy), act)
    y = activation(conv2d(y, p[2], p[3], policy, padding=1), act)
    y = x + conv2d(y, p[4], p[5], policy)
    return activation(y, act) if post_act else y


def gate_plain(x, g, p, policy: Policy, act: str, post_act: bool):
    """The plain gate x + trunk(x) * sigmoid(1x1(chain(g))) (g = x when
    None) as a pure function of the gate's 38 conv parameters: three trunk
    blocks, three gate blocks (six tensors each) and the final 1x1."""
    t, a = x, x if g is None else g
    for i in range(0, 18, 6):
        t = bottleneck_block(t, p[i:i + 6], policy, act, post_act)
        a = bottleneck_block(a, p[18 + i:24 + i], policy, act, post_act)
    return x + t * torch.sigmoid(conv2d(a, p[36], p[37], policy))


def gate_kernel_weights(p):
    """The same 38 parameters as the gate-chain kernel takes them: (trunk,
    gate, final (C, C) [in, out], final bias), each chain's blocks stacked
    into (in, out) weights and fp32 biases."""
    def chain(q):
        blocks = [q[i:i + 6] for i in range(0, 18, 6)]
        return GateChainWeights(
            torch.stack([io1x1(b[0]) for b in blocks]),
            torch.stack([b[1] for b in blocks]).float(),
            torch.stack([hwio3x3(b[2]) for b in blocks]),
            torch.stack([b[3] for b in blocks]).float(),
            torch.stack([io1x1(b[4]) for b in blocks]),
            torch.stack([b[5] for b in blocks]).float())
    return chain(p[:18]), chain(p[18:36]), io1x1(p[36]), p[37]


CHAIN_HALO = 3    # one row for each 3x3 convolution of a gate's chain


class _Gate(nn.Module):
    """What the two gate modules share: the plain gate and the kernel route
    over ``gate_parameters()``, with the module's ``act`` and ``post_act``."""
    _kernel_cache = (None, None)   # (key, GateKernelWeights)

    def gate_chain_weights(self):
        return gate_kernel_weights(self.gate_parameters())

    def kernel_layout(self, dtype):
        """The kernel's layout of the gate's weights for ``dtype``
        (``gate_chain.kernel_weights``), built once and kept until a
        parameter is written or moved (an optimizer step bumps its
        version)."""
        params = self.gate_parameters()
        return cached_layout(self, params, dtype, lambda: gck.kernel_weights(
            *gate_kernel_weights(params), dtype))

    def banded(self, x, g=None):
        """The gate, through the kernel or the plain chain as the policy
        routes it, on x's band (the whole image outside a height-sharding
        scope) with ``CHAIN_HALO`` rows of each neighbour band."""
        run = self.gate_kernel if self.policy.fused_gate_chain else self.gate
        h = x.shape[-2]
        xe, top = spatial.extend(x, CHAIN_HALO)
        ge = None if g is None else spatial.extend(g, CHAIN_HALO)[0]
        return spatial.crop(run(xe, ge), top, h)

    def gate(self, x, g=None):
        """The plain gate around g (the attention output, or x itself)."""
        return gate_plain(x, g, self.gate_parameters(), self.policy,
                          self.act, self.post_act)

    def gate_kernel(self, x, g=None):
        """The gate through the kernel, on NHWC views of NCHW
        (channels_last) tensors.  The differentiable inputs are x, g and the
        gate's parameters; their gradients come from ``gate_plain``."""
        dt = self.policy.compute_dtype
        act, post_act = self.act, self.post_act
        prepared = self.kernel_layout(dt) if x.is_cuda else None

        def rows(t):
            return (None if t is None
                    else t.to(dt).permute(0, 2, 3, 1).contiguous())

        def nchw(t):
            return None if t is None else t.permute(0, 3, 1, 2)

        def fused(xr, gr, *ps):
            return fused_gate_chain(xr, gr, *gate_kernel_weights(ps), act,
                                    post_act, prepared)

        def plain(xr, gr, *ps):
            return rows(gate_plain(nchw(xr), nchw(gr), ps, self.policy, act,
                                   post_act))

        return nchw(fused_primal_plain_grad(
            fused, plain, (rows(x), rows(g), *self.gate_parameters())))


class ResidualUnit(nn.Module):
    """gelu(x + conv1x1(gelu(conv3x3(gelu(conv1x1(x))))))."""

    def __init__(self, dim: int, *, policy: Policy, device, generator):
        super().__init__()
        self.policy = policy
        self.conv = _bottleneck(dim, policy, device, generator)

    def forward(self, x):
        return bottleneck_block(x, list(self.parameters()), self.policy,
                                self.policy.gelu_kind, True)


class WinGateAttention(_Gate):
    """out = x + conv_a(x) * sigmoid(conv_b(masked_win_attn(x, alpha)))."""
    post_act = True

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.policy = policy
        conv_a = [ResidualUnit(dim, **kw) for _ in range(3)]
        self.attn = MaskedWinBlock(dim, num_heads, window_size, shift_size,
                                   **kw)
        conv_b = [ResidualUnit(dim, **kw) for _ in range(3)]
        conv_b.append(Conv(dim, dim, 1, 1, **kw))
        self.conv_a = nn.Sequential(*conv_a)
        self.conv_b = nn.Sequential(*conv_b)

    @property
    def act(self) -> str:
        return self.policy.gelu_kind

    def gate_parameters(self):
        """The parameters of conv_a, then conv_b (not the attention's)."""
        return [*self.conv_a.parameters(), *self.conv_b.parameters()]

    def forward(self, x, alpha=None):
        return self.banded(x, self.attn(x, alpha))


class ResBlock(nn.Module):
    """x + conv3(relu(conv2(relu(conv1(x)))))."""

    def __init__(self, dim: int, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.policy = policy
        self.conv1 = Conv(dim, dim // 2, 1, 1, **kw)
        self.conv2 = Conv(dim // 2, dim // 2, 3, 1, **kw)
        self.conv3 = Conv(dim // 2, dim, 1, 1, **kw)

    def forward(self, x):
        return bottleneck_block(x, list(self.parameters()), self.policy,
                                "relu", False)


class SimplifiedAttention(_Gate):
    """The mask codec's convolutional gate: x + sigmoid(attn(x)) * trunk(x)."""
    act, post_act = "relu", False

    def __init__(self, dim: int, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.policy = policy
        self.trunk_ResBlock1 = ResBlock(dim, **kw)
        self.trunk_ResBlock2 = ResBlock(dim, **kw)
        self.trunk_ResBlock3 = ResBlock(dim, **kw)
        self.attention_ResBlock1 = ResBlock(dim, **kw)
        self.attention_ResBlock2 = ResBlock(dim, **kw)
        self.attention_ResBlock3 = ResBlock(dim, **kw)
        self.conv1 = Conv(dim, dim, 1, 1, **kw)

    def gate_parameters(self):
        """Trunk blocks, attention blocks, conv1: the registration order."""
        return list(self.parameters())

    def forward(self, x):
        return self.banded(x)
