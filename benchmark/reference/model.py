"""The plain reference of the RGBA codec: both codecs and their entropy
models in float32 PyTorch, with no kernel, cache, sharding or precision
policy.  It follows the paper's reference model
(``models/AutoEncoderRGB_Journal.py``: N=192, M=80, 10 slices, 8 heads;
``models/AutoEncoderMask_Journal.py``: M=80, 5 slices) and keeps its
state-dict keys, so one state dict loads here and into the program.

Tensors are NCHW and float32 between the layers.  The convolutions and
the attention's products compute in their module's ``dtype``, float32
unless ``RGBAModel(dtype=)`` says otherwise; callers set TF32 (``tf32``
in ``reference/outputs.py``).

Departures from the published description: none in the math.  GELU is
the exact erf form.  Each window of the masked attention is computed
whole and multiplied by its gate, as the reference's
``remove_zero_windows`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

N, M = 192, 80
HYPER_CH = (320, 288, 256, 224, 192)
Z_CH = 192
MAX_SUPPORT = 5
SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9
_REPARAM = 2.0 ** -18
_PEDESTAL = _REPARAM ** 2


class Conv(nn.Module):
    """Conv2d, padding k // 2; weight (O, I, k, k)."""
    dtype = torch.float32

    def __init__(self, cin, cout, k=5, stride=2):
        super().__init__()
        self.stride, self.padding = stride, k // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding).float()


class ConvT(nn.Module):
    """ConvTranspose2d; weight (I, O, k, k)."""
    dtype = torch.float32

    def __init__(self, cin, cout, k=5, stride=2, padding=None,
                 output_padding=None):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.output_padding = (stride - 1 if output_padding is None
                               else output_padding)
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride, self.padding,
                                  self.output_padding).float()


class GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x)


def subpel(cin, cout, r=2):
    return nn.Sequential(Conv(cin, cout * r * r, 3, 1), nn.PixelShuffle(r))


def lower_bound(x, bound):
    return torch.clamp_min(x, bound)


class GDN(nn.Module):
    """y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2); the inverse
    multiplies."""
    dtype = torch.float32

    def __init__(self, c, inverse=False, beta_min=1e-6):
        super().__init__()
        self.inverse, self.beta_min = inverse, beta_min
        self.beta = nn.Parameter(torch.empty(c))
        self.gamma = nn.Parameter(torch.empty(c, c))

    def forward(self, x):
        beta = lower_bound(self.beta, (self.beta_min + _PEDESTAL) ** 0.5) ** 2 \
            - _PEDESTAL
        gamma = lower_bound(self.gamma, _REPARAM) ** 2 - _PEDESTAL
        dt = self.dtype
        norm = F.conv2d((x * x).to(dt), gamma[:, :, None, None].to(dt),
                        beta.to(dt)).float()
        return x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))


# ----------------------------------------------------------- attention

def relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return torch.from_numpy(rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1])


def shift_mask(h, w, ws, ss):
    """(nW, N, N) additive mask of the shifted windows: -100 between two
    tokens of different regions."""
    img = np.zeros((h, w), np.float32)
    if ss > 0:
        cuts = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
        for i, (a, b) in enumerate((a, b) for a in cuts for b in cuts):
            img[a, b] = i
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return torch.from_numpy(np.where(win[:, None, :] != win[:, :, None],
                                     -100.0, 0.0).astype(np.float32))


def windows(x, ws):
    """(B, H, W, C) -> (B * nH * nW, ws * ws, C), row-major windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unwindows(t, ws, b, h, w):
    c = t.shape[-1]
    t = t.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, c)


class WindowAttention(nn.Module):
    dtype = torch.float32

    def __init__(self, dim, ws, heads=8):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, t, mask):
        """t (nWB, N, C); mask (nW, N, N) or None."""
        nwb, n, c = t.shape
        nh, hd, dt = self.heads, c // self.heads, self.dtype
        qkv = F.linear(t.to(dt), self.qkv.weight.to(dt), self.qkv.bias.to(dt))
        q, k, v = qkv.reshape(nwb, n, 3, nh, hd).unbind(2)
        att = torch.einsum("wnhd,wmhd->whnm", q * hd ** -0.5, k).float()
        idx = relative_position_index(self.ws).to(t.device).reshape(-1)
        rel = self.relative_position_bias_table[idx].reshape(n, n, nh)
        att = att + rel.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            att = (att.reshape(nwb // nw, nw, nh, n, n)
                   + mask.to(att)[None, :, None]).reshape(nwb, nh, n, n)
        out = torch.einsum("whnm,wmhd->wnhd", torch.softmax(att, -1).to(dt), v)
        return F.linear(out.reshape(nwb, n, c), self.proj.weight.to(dt),
                        self.proj.bias.to(dt)).float()


class MaskedWinBlock(nn.Module):
    """Shifted-window attention gated by the alpha: a window whose alpha
    sums to 0 outputs 0; the input is added back."""

    def __init__(self, dim, heads, ws, ss):
        super().__init__()
        self.ws, self.ss = ws, ss
        self.attn = WindowAttention(dim, ws, heads)

    def forward(self, x, alpha):
        b, c, h, w = x.shape
        ws, ss = self.ws, self.ss
        xh, ah = x.permute(0, 2, 3, 1), alpha.permute(0, 2, 3, 1)
        if ss:
            xh = torch.roll(xh, (-ss, -ss), (1, 2))
            ah = torch.roll(ah, (-ss, -ss), (1, 2))
        alive = (windows(ah, ws).sum((1, 2)) != 0).to(x.dtype)
        mask = shift_mask(h, w, ws, ss).to(x.device) if ss else None
        out = self.attn(windows(xh, ws), mask) * alive[:, None, None]
        out = unwindows(out, ws, b, h, w)
        if ss:
            out = torch.roll(out, (ss, ss), (1, 2))
        return x + out.permute(0, 3, 1, 2)


class ResidualUnit(nn.Module):
    """gelu(x + 1x1(gelu(3x3(gelu(1x1(x))))))."""

    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Sequential(Conv(dim, dim // 2, 1, 1), GELU(),
                                  Conv(dim // 2, dim // 2, 3, 1), GELU(),
                                  Conv(dim // 2, dim, 1, 1))

    def forward(self, x):
        return F.gelu(x + self.conv(x))


class WinGateAttention(nn.Module):
    """x + conv_a(x) * sigmoid(conv_b(masked_win_attn(x, alpha)))."""

    def __init__(self, dim, heads, ws, ss):
        super().__init__()
        self.conv_a = nn.Sequential(*[ResidualUnit(dim) for _ in range(3)])
        self.attn = MaskedWinBlock(dim, heads, ws, ss)
        self.conv_b = nn.Sequential(*[ResidualUnit(dim) for _ in range(3)],
                                    Conv(dim, dim, 1, 1))

    def forward(self, x, alpha):
        return x + self.conv_a(x) * torch.sigmoid(self.conv_b(
            self.attn(x, alpha)))


class ResBlock(nn.Module):
    """x + conv3(relu(conv2(relu(conv1(x)))))."""

    def __init__(self, dim):
        super().__init__()
        self.conv1 = Conv(dim, dim // 2, 1, 1)
        self.conv2 = Conv(dim // 2, dim // 2, 3, 1)
        self.conv3 = Conv(dim // 2, dim, 1, 1)

    def forward(self, x):
        return x + self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))


class SimplifiedAttention(nn.Module):
    """x + trunk(x) * sigmoid(conv1(attention(x)))."""

    def __init__(self, dim):
        super().__init__()
        for part in ("trunk", "attention"):
            for i in (1, 2, 3):
                setattr(self, f"{part}_ResBlock{i}", ResBlock(dim))
        self.conv1 = Conv(dim, dim, 1, 1)

    def forward(self, x):
        t, a = x, x
        for i in (1, 2, 3):
            t = getattr(self, f"trunk_ResBlock{i}")(t)
            a = getattr(self, f"attention_ResBlock{i}")(a)
        return x + t * torch.sigmoid(self.conv1(a))


class EnhancementBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = Conv(f, f, 3, 1)
        self.conv2 = Conv(f, f, 3, 1)


class DSE(nn.Module):
    """1x1 in, three residual 3x3 blocks, long skip, 1x1 out, identity
    skip; ReLU, or LeakyReLU 0.01 in the mask decoder."""

    def __init__(self, cio, leaky=False, f=32):
        super().__init__()
        self.leaky = leaky
        self.input_conv = Conv(cio, f, 1, 1)
        self.enh1, self.enh2, self.enh3 = (EnhancementBlock(f)
                                           for _ in range(3))
        self.output_conv = Conv(f, cio, 1, 1)

    def forward(self, x):
        first = y = self.input_conv(x)
        for blk in (self.enh1, self.enh2, self.enh3):
            z = blk.conv1(y)
            z = F.leaky_relu(z, 0.01) if self.leaky else F.relu(z)
            y = y + blk.conv2(z)
        return self.output_conv(y + first) + x


# ------------------------------------------------------------- entropy

class EntropyBottleneck(nn.Module):
    """Factorized prior of z (Balle et al. 2018, appendix 6.1)."""

    FILTERS = (3, 3, 3, 3)

    def __init__(self, c=Z_CH):
        super().__init__()
        fs = (1,) + self.FILTERS + (1,)
        for i in range(len(self.FILTERS) + 1):
            self.register_parameter(f"_matrix{i}", nn.Parameter(
                torch.empty(c, fs[i + 1], fs[i])))
            self.register_parameter(f"_bias{i}", nn.Parameter(
                torch.empty(c, fs[i + 1], 1)))
            if i < len(self.FILTERS):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.empty(c, fs[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(c, 1, 3))

    def logits(self, v):
        for i in range(len(self.FILTERS) + 1):
            v = torch.bmm(F.softplus(getattr(self, f"_matrix{i}")), v) + \
                getattr(self, f"_bias{i}")
            if i < len(self.FILTERS):
                v = v + torch.tanh(getattr(self, f"_factor{i}")) * torch.tanh(v)
        return v

    def medians(self):
        return self.quantiles[:, 0, 1]

    def forward(self, z):
        """(z_hat, likelihoods) of round(z - median) + median."""
        b, c, h, w = z.shape
        z_hat = torch.round(z - self.medians().reshape(1, c, 1, 1)) + \
            self.medians().reshape(1, c, 1, 1)
        v = z_hat.permute(1, 0, 2, 3).reshape(c, 1, -1)
        lo, up = self.logits(v - 0.5), self.logits(v + 0.5)
        s = -torch.sign(lo + up)
        lik = torch.abs(torch.sigmoid(s * up) - torch.sigmoid(s * lo))
        lik = lower_bound(lik, LIKELIHOOD_BOUND)
        return z_hat, lik.reshape(c, b, h, w).permute(1, 0, 2, 3)


def gaussian_likelihood(sym, scale):
    """Mass of the integer bin ``sym`` under N(0, scale)."""
    scale = lower_bound(scale, SCALE_BOUND)
    v = torch.abs(sym)
    cdf = lambda t: 0.5 * torch.special.erfc(-t * 2 ** -0.5)  # noqa: E731
    return lower_bound(cdf((0.5 - v) / scale) - cdf((-0.5 - v) / scale),
                       LIKELIHOOD_BOUND)


def bits(lik):
    """Bits of a likelihood tensor, each symbol clamped to [0, 50]."""
    return torch.clamp(-torch.log(lik + 1e-10) / math.log(2.0), 0.0, 50.0)


def slice_transform(cin, cout):
    return nn.Sequential(Conv(cin, 224, 3, 1), GELU(), Conv(224, 128, 3, 1),
                         GELU(), Conv(128, cout, 3, 1))


class ChannelARPrior(nn.Module):
    """Hyperprior with a channel-autoregressive head of ``slices`` slices,
    each conditioned on at most five decoded slices."""

    def __init__(self, m, slices):
        super().__init__()
        self.slices = slices
        sw = m // slices
        layers, cin = [], m
        for i, (c, s) in enumerate(zip(HYPER_CH, (2, 1, 2, 1, 2))):
            layers += [Conv(cin, c, 3, s)] + ([GELU()] if i < 4 else [])
            cin = c
        self.h_a = nn.Sequential(*layers)

        def h_s():
            return nn.Sequential(subpel(Z_CH, 192), GELU(),
                                 Conv(192, 224, 3, 1), GELU(),
                                 subpel(224, 256), GELU(),
                                 Conv(256, 288, 3, 1), GELU(),
                                 subpel(288, m))
        self.h_mean_s, self.h_scale_s = h_s(), h_s()
        support = [m + min(i, MAX_SUPPORT) * sw for i in range(slices)]
        self.cc_mean_transforms = nn.ModuleList(
            slice_transform(c, sw) for c in support)
        self.cc_scale_transforms = nn.ModuleList(
            slice_transform(c, sw) for c in support)
        self.lrp_transforms = nn.ModuleList(
            slice_transform(c + sw, sw) for c in support)
        self.entropy_bottleneck = EntropyBottleneck()

    def entropy(self, y):
        """Hard-quantized latents, as the bitstream carries them:
        dict(y_hat, y_bits, z_bits) with per-symbol bits."""
        z_hat, z_lik = self.entropy_bottleneck(self.h_a(y))
        lm, ls = self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        sw = y.shape[1] // self.slices
        y_hats, y_bits = [], []
        for i in range(self.slices):
            support = y_hats[:MAX_SUPPORT]
            mu = self.cc_mean_transforms[i](torch.cat([lm] + support, 1))
            scale = self.cc_scale_transforms[i](torch.cat([ls] + support, 1))
            sym = torch.round(y[:, i * sw:(i + 1) * sw] - mu)
            y_bits.append(bits(gaussian_likelihood(sym, scale)))
            y_hat = sym + mu
            y_hat = y_hat + 0.5 * torch.tanh(self.lrp_transforms[i](
                torch.cat([lm] + support + [y_hat], 1)))
            y_hats.append(y_hat)
        return {"y_hat": torch.cat(y_hats, 1), "y_bits": torch.cat(y_bits, 1),
                "z_bits": bits(z_lik)}


class AnalysisTransform(nn.Module):
    def __init__(self):
        super().__init__()
        self.x1, self.gdn1 = Conv(3, N), GDN(N)
        self.x2, self.gdn2 = Conv(N, N), GDN(N)
        self.attention1 = WinGateAttention(N, 8, 8, 4)
        self.x3, self.gdn3 = Conv(N, N), GDN(N)
        self.x4 = Conv(N, M, 1, 1)
        self.attention2 = WinGateAttention(M, 8, 4, 2)

    def forward(self, x, a2, a3):
        y = self.attention1(self.gdn2(self.x2(self.gdn1(self.x1(x)))), a2)
        return self.attention2(self.x4(self.gdn3(self.x3(y))), a3)


class SynthesisTransform(nn.Module):
    def __init__(self):
        super().__init__()
        self.attention1 = WinGateAttention(M, 8, 4, 2)
        self.x1, self.igdn1 = Conv(M, N, 1, 1), GDN(N, True)
        self.x2, self.igdn2 = ConvT(N, N), GDN(N, True)
        self.attention2 = WinGateAttention(N, 8, 8, 4)
        self.x3, self.igdn3 = ConvT(N, N), GDN(N, True)
        self.x4 = ConvT(N, 3)
        self.dse = DSE(3)

    def forward(self, y, a2, a3):
        x = self.igdn2(self.x2(self.igdn1(self.x1(self.attention1(y, a3)))))
        x = self.attention2(x, a2)
        return self.dse(self.x4(self.igdn3(self.x3(x))))


class RGBCodec(ChannelARPrior):
    def __init__(self):
        super().__init__(M, 10)
        self.Encoder = AnalysisTransform()
        self.Decoder = SynthesisTransform()


class MaskCodec(ChannelARPrior):
    def __init__(self):
        super().__init__(M, 5)
        self.EncoderMask = nn.Sequential(
            Conv(1, N), GDN(N), Conv(N, N), GDN(N), SimplifiedAttention(N),
            Conv(N, N), GDN(N), Conv(N, M, 1, 1), SimplifiedAttention(M))
        self.DecoderMask = nn.Sequential(
            SimplifiedAttention(M), ConvT(M, N, 1, 1, 0, 0), GDN(N, True),
            ConvT(N, N), GDN(N, True), SimplifiedAttention(N),
            ConvT(N, N), GDN(N, True), ConvT(N, 1), DSE(1, leaky=True))


class RGBAModel(nn.Module):
    """Both codecs under the program's state-dict prefixes.  ``dtype``: the
    type the convolutions and the attention's products compute in (the
    rest, and every entropy computation, stays float32)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.mask_codec = MaskCodec()
        self.rgb_codec = RGBCodec()
        self.set_dtype(dtype)

    def set_dtype(self, dtype) -> None:
        for mod in self.modules():
            if isinstance(mod, (Conv, ConvT, GDN, WindowAttention)):
                mod.dtype = dtype


def pyramid(alpha, levels=3):
    """[H/2, H/4, H/8] 3x3 stride-2 average pools (padding counted)."""
    out, x = [], alpha
    for _ in range(levels):
        x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
        out.append(x)
    return out


def constraint_rgb(mask):
    """A 0 pixel whose 8 neighbours are all 1 becomes 1; a positive pixel
    whose 8 neighbours are all 0 becomes 0.  The neighbour sum is exact
    adds, not a convolution, so the == tests are exact."""
    h, w = mask.shape[-2:]
    p = F.pad(mask, (1, 1, 1, 1))
    ns = torch.zeros_like(mask)
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                ns = ns + p[..., dy:dy + h, dx:dx + w]
    mask = torch.where((mask == 0) & (ns == 8), torch.ones_like(mask), mask)
    return torch.where((mask > 0) & (ns == 0), torch.zeros_like(mask), mask)


def round8(a):
    """Clip to [0, 1] and round to 8 bits."""
    return torch.round(torch.clamp(a, 0.0, 1.0) * 255.0) / 255.0
