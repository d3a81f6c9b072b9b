"""The mixed Transformer-CNN codec's blocks (Liu, Sun, Katto, CVPR 2023;
LIC_TCM's ``models/tcm.py``): the Swin transformer block, the
``ConvTransBlock`` that splits its channels between a CNN branch and a
transformer branch, and ``SWAtten``, the attention of the entropy head.
Module names follow LIC_TCM's state-dict keys (``msa.embedding_layer``,
``msa.relative_position_params``, ``trans_block.ln1``, ``conv1_1``,
``non_local_block.block_1``, ``conv_a.0.conv.0`` ...).

* ``WMSA``: window multi-head self-attention over NHWC tokens, ``dim /
  head_dim`` heads, scale ``head_dim ** -0.5``, qkv ``Linear(dim, 3 dim)``
  (q heads, then k, then v), a (2w - 1)^2 relative-position table per head
  and an output ``Linear(dim, dim)``.  The shifted form rolls by -w/2
  before and +w/2 after and keeps token pairs of one shifted region apart
  from the others.  Every window is alive.  With ``policy.fused_win_attn``
  it runs in the window-attention kernel (``ops/kernels/win_attn.py``),
  which takes the shifted windows as ``window.py``'s region ids; otherwise
  in that kernel's plain version.  Both add -100 between two regions where
  the published code fills -inf: a softmax weight of the other region
  moves by under e^-100.
* ``Block``: x + WMSA(LN(x)), then x + Linear(4 dim -> dim)(GELU(Linear(dim
  -> 4 dim)(LN(x)))), on NHWC tensors.
* ``ConvTransBlock`` on 2N channels: a 1x1 convolution split into N + N,
  ``conv_x + ResidualBlock(conv_x)`` and ``Block(trans_x)``, merged by a
  1x1 convolution and added to x.
* ``SWAtten(c)``: u = conv1x1(c -> 128)(x), z = Block_SW(Block_W(u)), out =
  conv1x1(128 -> c)(u + conv_a(u) * sigmoid(conv_b(z))), conv_a three
  compressai ``ResidualUnit``s (ReLU, post-activation) and conv_b three and
  a 1x1.  The gate runs through the gate-chain kernel with
  ``policy.fused_gate_chain`` (``ops/attention._Gate``).

Inside ``batch_invariant_scope`` (the codec's device steps) a transformer
block runs each image alone, as the convolutions do: the linears' and the
LayerNorms' kernels are chosen by the number of rows, and the encoder and
the decoder of the entropy head must compute the same bits in any batch.

Under a profiler the blocks run in spans (``utils/trace.py``):
``tcm.convtrans`` around a ``ConvTransBlock``, ``tcm.swin`` around each
transformer ``Block``, ``tcm.swatten`` around a ``SWAtten``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import init
from ..core.precision import Policy
from ..utils.trace import span
from .attention import _Gate, bottleneck_block, cached_layout
from .conv import Conv, per_image
from .kernels.win_attn import (fused_window_attention, kernel_weights,
                               window_attention_plain)
from .residual import ResidualBlock
from .window import (relative_position_index, swin_region_ids,
                     window_partition, window_reverse)


class Linear(nn.Module):
    """``nn.Linear``'s parameters (torch's init, drawn from ``generator``)
    computing in the policy's dtype."""

    def __init__(self, cin: int, cout: int, *, policy: Policy, device,
                 generator):
        super().__init__()
        self.policy = policy
        self.weight = init.uniform_fan_in((cout, cin), cin, generator, device)
        self.bias = init.uniform_fan_in((cout,), cin, generator, device)

    def forward(self, x):
        dt = self.policy.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dim)`` (eps 1e-5, weight 1, bias 0) computing in the
    policy's dtype."""

    def __init__(self, dim: int, *, policy: Policy, device):
        super().__init__()
        self.policy = policy
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = init.zeros((dim,), device)

    def forward(self, x):
        dt = self.policy.compute_dtype
        return F.layer_norm(x.to(dt), self.weight.shape, self.weight.to(dt),
                            self.bias.to(dt), 1e-5)


class WMSA(nn.Module):
    def __init__(self, dim: int, head_dim: int, window_size: int,
                 shifted: bool, *, policy: Policy, device, generator):
        super().__init__()
        if dim % head_dim:
            raise ValueError(f"WMSA: dim {dim} is not a multiple of the head "
                             f"dim {head_dim}")
        kw = dict(policy=policy, device=device, generator=generator)
        self.window_size, self.shifted = window_size, shifted
        self.num_heads = dim // head_dim
        self.policy = policy
        self.embedding_layer = Linear(dim, 3 * dim, **kw)
        self.relative_position_params = init.truncated_normal(
            (self.num_heads, 2 * window_size - 1, 2 * window_size - 1), 0.02,
            generator, device)
        self.linear = Linear(dim, dim, **kw)
        idx = torch.from_numpy(relative_position_index(window_size).reshape(-1))
        self.register_buffer("relative_position_index", idx.to(device),
                             persistent=False)
        self._kernel_cache = (None, None)   # (key, (AttnWeights, rel_bias))
        self._masks = {}                    # (h, w, b, device) -> tensors

    def rel_bias(self):
        """(heads, N, N) fp32: table[p_i - p_j] per head."""
        n = self.window_size ** 2
        t = self.relative_position_params.reshape(self.num_heads, -1)
        return t[:, self.relative_position_index].reshape(
            self.num_heads, n, n).float()

    def _weights(self):
        """qkv and output projection as the kernel takes them: (in, out)."""
        e, p = self.embedding_layer, self.linear
        return e.weight.t(), e.bias, p.weight.t(), p.bias

    def kernel_inputs(self, dtype):
        """The kernel's weight layout for ``dtype`` and the contiguous
        rel_bias, kept until a parameter is written or moved."""
        e, p = self.embedding_layer, self.linear
        params = (e.weight, e.bias, p.weight, p.bias,
                  self.relative_position_params)
        return cached_layout(self, params, dtype, lambda: (
            kernel_weights(*self._weights(), self.num_heads, dtype),
            self.rel_bias().contiguous()))

    def _region_alive(self, h: int, w: int, b: int, device):
        """The windows' region ids (zeros unshifted) and their all-alive
        gate, kept per shape (not while the forward is traced)."""
        key = (h, w, b, device)
        if key in self._masks:
            return self._masks[key]
        ws = self.window_size
        ss = ws // 2 if self.shifted else 0
        region = torch.from_numpy(swin_region_ids(h, w, ws, ss)).to(device)
        region = region.repeat(b, 1)
        out = region, torch.ones(region.shape[0], 1, device=device)
        if not torch.compiler.is_compiling():
            self._masks[key] = out
        return out

    def forward(self, x):
        """x: (B, H, W, C) NHWC, H and W multiples of the window."""
        b, h, w, c = x.shape
        ws = self.window_size
        if h % ws or w % ws:
            raise ValueError(f"WMSA: {h}x{w} tokens do not hold whole "
                             f"windows of {ws}")
        ss = ws // 2 if self.shifted else 0
        x = x.to(self.policy.compute_dtype)
        if ss:
            x = torch.roll(x, (-ss, -ss), (1, 2))
        tokens = window_partition(x, ws).reshape(-1, ws * ws, c).contiguous()
        region, alive = self._region_alive(h, w, b, x.device)
        if self.policy.fused_win_attn:
            prepared, rel_bias = self.kernel_inputs(tokens.dtype)
            if torch.is_grad_enabled():
                rel_bias = self.rel_bias()    # differentiable to the table
            out = fused_window_attention(
                tokens, region, alive, *self._weights(), rel_bias,
                self.num_heads, prepared=prepared if tokens.is_cuda else None)
        else:
            out = window_attention_plain(tokens, region, alive,
                                         *self._weights(), self.rel_bias(),
                                         self.num_heads)
        out = window_reverse(out.reshape(-1, ws, ws, c), ws, h, w)
        if ss:
            out = torch.roll(out, (ss, ss), (1, 2))
        return out


class Block(nn.Module):
    def __init__(self, dim: int, head_dim: int, window_size: int,
                 shifted: bool, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.policy = policy
        self.ln1 = LayerNorm(dim, policy=policy, device=device)
        self.msa = WMSA(dim, head_dim, window_size, shifted, **kw)
        self.ln2 = LayerNorm(dim, policy=policy, device=device)
        self.mlp = nn.Sequential(Linear(dim, 4 * dim, **kw), nn.GELU(),
                                 Linear(4 * dim, dim, **kw))

    def _forward(self, x):
        x = x.to(self.policy.compute_dtype)
        x = x + self.msa(self.ln1(x))
        hidden = self.policy.gelu(self.mlp[0](self.ln2(x)))
        return x + self.mlp[2](hidden)

    def forward(self, x):
        """x: (B, H, W, C) NHWC."""
        with span("tcm.swin"):
            return per_image(self._forward, x)


class SwinBlock(nn.Module):
    """A W block, then an SW block, on NCHW tensors larger than a window
    on each side (the published code pads smaller ones; this raises)."""

    def __init__(self, dim: int, head_dim: int, window_size: int, *,
                 policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.window_size = window_size
        self.block_1 = Block(dim, head_dim, window_size, False, **kw)
        self.block_2 = Block(dim, head_dim, window_size, True, **kw)

    def forward(self, x):
        h, w = x.shape[-2:]
        if h <= self.window_size or w <= self.window_size:
            raise ValueError(f"SwinBlock: a latent of {h}x{w} is not larger "
                             f"than the window {self.window_size}")
        t = self.block_2(self.block_1(x.permute(0, 2, 3, 1)))
        return t.permute(0, 3, 1, 2)


class ConvTransBlock(nn.Module):
    def __init__(self, dim: int, head_dim: int, window_size: int,
                 shifted: bool, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.dim = dim
        self.conv1_1 = Conv(2 * dim, 2 * dim, 1, 1, **kw)
        self.conv1_2 = Conv(2 * dim, 2 * dim, 1, 1, **kw)
        self.conv_block = ResidualBlock(dim, **kw)
        self.trans_block = Block(dim, head_dim, window_size, shifted, **kw)

    def forward(self, x):
        """x: (B, 2 dim, H, W)."""
        with span("tcm.convtrans"):
            conv_x, trans_x = torch.split(self.conv1_1(x), self.dim, dim=1)
            conv_x = self.conv_block(conv_x) + conv_x
            trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1))
            return x + self.conv1_2(torch.cat(
                (conv_x, trans_x.permute(0, 3, 1, 2)), dim=1))


class ResidualUnit(nn.Module):
    """compressai's ``AttentionBlock`` unit: relu(x + conv1x1(relu(conv3x3(
    relu(conv1x1(x, C -> C/2))))))."""

    def __init__(self, dim: int, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.policy = policy
        self.conv = nn.Sequential(Conv(dim, dim // 2, 1, 1, **kw), nn.ReLU(),
                                  Conv(dim // 2, dim // 2, 3, 1, **kw),
                                  nn.ReLU(), Conv(dim // 2, dim, 1, 1, **kw))

    def forward(self, x):
        return bottleneck_block(x, list(self.parameters()), self.policy,
                                "relu", True)


class SWAtten(_Gate):
    act, post_act = "relu", True

    def __init__(self, dim: int, inter_dim: int = 128, head_dim: int = 16,
                 window_size: int = 8, *, policy: Policy, device, generator):
        super().__init__()
        kw = dict(policy=policy, device=device, generator=generator)
        self.policy = policy
        self.conv_a = nn.Sequential(*[ResidualUnit(inter_dim, **kw)
                                      for _ in range(3)])
        self.conv_b = nn.Sequential(*[ResidualUnit(inter_dim, **kw)
                                      for _ in range(3)],
                                    Conv(inter_dim, inter_dim, 1, 1, **kw))
        self.non_local_block = SwinBlock(inter_dim, head_dim, window_size,
                                         **kw)
        self.in_conv = Conv(dim, inter_dim, 1, 1, **kw)
        self.out_conv = Conv(inter_dim, dim, 1, 1, **kw)

    def gate_parameters(self):
        """The parameters of conv_a, then conv_b (not the transformer's)."""
        return [*self.conv_a.parameters(), *self.conv_b.parameters()]

    def forward(self, x):
        with span("tcm.swatten"):
            u = self.in_conv(x)
            return self.out_conv(self.banded(u, self.non_local_block(u)))
