"""The plain reference of TCM, the mixed Transformer-CNN image codec (Liu,
Sun, Katto, "Learned Image Compression with Mixed Transformer-CNN
Architectures", CVPR 2023; https://github.com/jmliu206/LIC_TCM/blob/main/
models/tcm.py), in float32 PyTorch with torch's own modules: no kernel,
cache, policy or batching scheme.  It keeps LIC_TCM's state-dict keys, so
one state dict loads here and into the program's ``models/tcm.py``.  It
imports nothing of the program and nothing of the rest of the benchmark,
so a test can load this file by its path.

The defaults are the published large model: N=128, M=320, config (2, 2,
2, 2, 2, 2), head dims (8, 16, 32, 32, 16, 8), windows of 8 (4 in the
hyper transforms), 5 slices with at most 5 support slices, SWAtten of 128
channels with head dim 16.

Departures from the published code:

* ``SwinBlock`` raises on a latent no larger than its window, where the
  published code pads it (and never crops the padding back); the
  benchmark's shapes never take that branch.
* The compressai pieces it needs (GDN, EntropyBottleneck, the Gaussian
  conditional's likelihood) are written out here in their eval form: z is
  rounded around the bottleneck's medians, y around the slice means, and
  each likelihood is bounded below by 1e-9, as compressai does.
* ``entropy`` and ``codec`` give the code length of the hard-quantized
  latents, the bits the bitstream carries, where the published ``forward``
  gives the noise-relaxed likelihoods of training.

The shifted windows mask other regions with -inf and GELU is the exact erf
form, as published.  TF32 is off while ``codec`` runs unless its caller
asks for it (``tf32=True``: the benchmark's lower-precision control).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
import torch.nn.functional as F

SCALE_BOUND = 0.11
LIKELIHOOD_BOUND = 1e-9
Z_CH = 192
_REPARAM = 2.0 ** -18
_PEDESTAL = _REPARAM ** 2


def conv(cin, cout, k=3, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2)


def conv1x1(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 1, stride)


def subpel_conv3x3(cin, cout, r=1):
    return nn.Sequential(nn.Conv2d(cin, cout * r * r, 3, padding=1),
                         nn.PixelShuffle(r))


def lower_bound(x, bound):
    return torch.clamp_min(x, bound)


class GDN(nn.Module):
    """compressai's GDN: y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2),
    the inverse multiplies; beta and gamma stored reparameterized."""

    def __init__(self, c, inverse=False, beta_min=1e-6):
        super().__init__()
        self.inverse, self.beta_min = inverse, beta_min
        self.beta = nn.Parameter(torch.ones(c))
        self.gamma = nn.Parameter(0.1 * torch.eye(c))

    def forward(self, x):
        beta = lower_bound(self.beta, (self.beta_min + _PEDESTAL) ** 0.5) ** 2 \
            - _PEDESTAL
        gamma = lower_bound(self.gamma, _REPARAM) ** 2 - _PEDESTAL
        norm = F.conv2d(x * x, gamma[:, :, None, None], beta)
        return x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, cin, cout, stride=2):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, stride)
        self.leaky_relu = nn.LeakyReLU()
        self.conv2 = conv(cout, cout, 3)
        self.gdn = GDN(cout)
        self.skip = conv1x1(cin, cout, stride)

    def forward(self, x):
        out = self.gdn(self.conv2(self.leaky_relu(self.conv1(x))))
        return out + self.skip(x)


class ResidualBlockUpsample(nn.Module):
    def __init__(self, cin, cout, upsample=2):
        super().__init__()
        self.subpel_conv = subpel_conv3x3(cin, cout, upsample)
        self.leaky_relu = nn.LeakyReLU()
        self.conv = conv(cout, cout, 3)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = subpel_conv3x3(cin, cout, upsample)

    def forward(self, x):
        out = self.igdn(self.conv(self.leaky_relu(self.subpel_conv(x))))
        return out + self.upsample(x)


class ResidualBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = conv(c, c, 3)
        self.leaky_relu = nn.LeakyReLU()
        self.conv2 = conv(c, c, 3)

    def forward(self, x):
        out = self.leaky_relu(self.conv2(self.leaky_relu(self.conv1(x))))
        return out + x


# ---------------------------------------------------------- transformer

class WMSA(nn.Module):
    """Window (or, ``type='SW'``, shifted-window) multi-head self-attention
    over (B, H, W, C) tokens."""

    def __init__(self, dim, head_dim, window_size, type="W"):
        super().__init__()
        self.head_dim, self.window_size, self.type = head_dim, window_size, type
        self.n_heads = dim // head_dim
        self.scale = head_dim ** -0.5
        self.embedding_layer = nn.Linear(dim, 3 * dim)
        self.relative_position_params = nn.Parameter(torch.zeros(
            self.n_heads, 2 * window_size - 1, 2 * window_size - 1))
        self.linear = nn.Linear(dim, dim)

    def relative_embedding(self):
        ws = self.window_size
        cord = torch.tensor([[i, j] for i in range(ws) for j in range(ws)])
        rel = cord[:, None, :] - cord[None, :, :] + ws - 1
        return self.relative_position_params[:, rel[:, :, 0], rel[:, :, 1]]

    def generate_mask(self, hw, ww, p, shift, device):
        """True between two tokens of one shifted window that lie in
        different regions of the rolled image."""
        mask = torch.zeros(hw, ww, p, p, p, p, dtype=torch.bool,
                           device=device)
        s = p - shift
        mask[-1, :, :s, :, s:, :] = True
        mask[-1, :, s:, :, :s, :] = True
        mask[:, -1, :, :s, :, s:] = True
        mask[:, -1, :, s:, :, :s] = True
        return mask.reshape(1, 1, hw * ww, p * p, p * p)

    def forward(self, x):
        p = self.window_size
        if self.type != "W":
            x = torch.roll(x, (-(p // 2), -(p // 2)), dims=(1, 2))
        b, h, w, c = x.shape
        hw, ww = h // p, w // p
        x = x.reshape(b, hw, p, ww, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hw * ww, p * p, c)
        qkv = self.embedding_layer(x).reshape(b, hw * ww, p * p,
                                              3 * self.n_heads, self.head_dim)
        q, k, v = qkv.permute(3, 0, 1, 2, 4).chunk(3, dim=0)
        sim = torch.einsum("hbwpc,hbwqc->hbwpq", q, k) * self.scale
        sim = sim + self.relative_embedding()[:, None, None]
        if self.type != "W":
            sim = sim.masked_fill(
                self.generate_mask(hw, ww, p, p // 2, x.device),
                float("-inf"))
        probs = F.softmax(sim, dim=-1)
        out = torch.einsum("hbwij,hbwjc->hbwic", probs, v)
        out = out.permute(1, 2, 3, 0, 4).reshape(b, hw * ww, p * p, c)
        out = self.linear(out)
        out = out.reshape(b, hw, ww, p, p, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, c)
        if self.type != "W":
            out = torch.roll(out, (p // 2, p // 2), dims=(1, 2))
        return out


class Block(nn.Module):
    def __init__(self, dim, head_dim, window_size, type="W"):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window_size, type)
        self.ln2 = nn.LayerNorm(dim)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(),
                                 nn.Linear(4 * dim, dim))

    def forward(self, x):
        x = x + self.msa(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ConvTransBlock(nn.Module):
    def __init__(self, conv_dim, trans_dim, head_dim, window_size, type="W"):
        super().__init__()
        self.conv_dim, self.trans_dim = conv_dim, trans_dim
        self.trans_block = Block(trans_dim, head_dim, window_size, type)
        self.conv1_1 = conv1x1(conv_dim + trans_dim, conv_dim + trans_dim)
        self.conv1_2 = conv1x1(conv_dim + trans_dim, conv_dim + trans_dim)
        self.conv_block = ResidualBlock(conv_dim)

    def forward(self, x):
        conv_x, trans_x = torch.split(self.conv1_1(x),
                                      (self.conv_dim, self.trans_dim), dim=1)
        conv_x = self.conv_block(conv_x) + conv_x
        trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1))
        res = self.conv1_2(torch.cat((conv_x, trans_x.permute(0, 3, 1, 2)), 1))
        return x + res


class SwinBlock(nn.Module):
    def __init__(self, dim, head_dim, window_size):
        super().__init__()
        self.window_size = window_size
        self.block_1 = Block(dim, head_dim, window_size, "W")
        self.block_2 = Block(dim, head_dim, window_size, "SW")

    def forward(self, x):
        if min(x.shape[-2:]) <= self.window_size:
            raise ValueError("the published code pads a latent no larger "
                             "than its window; the reference does not")
        t = self.block_2(self.block_1(x.permute(0, 2, 3, 1)))
        return t.permute(0, 3, 1, 2)


class ResidualUnit(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.conv = nn.Sequential(conv1x1(n, n // 2), nn.ReLU(),
                                  conv(n // 2, n // 2, 3), nn.ReLU(),
                                  conv1x1(n // 2, n))
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.conv(x) + x)


class SWAtten(nn.Module):
    """compressai's AttentionBlock of ``inter_dim`` channels with a Swin
    pair as its non-local block, between two 1x1 convolutions."""

    def __init__(self, dim, head_dim=16, window_size=8, inter_dim=128):
        super().__init__()
        self.conv_a = nn.Sequential(*[ResidualUnit(inter_dim)
                                      for _ in range(3)])
        self.conv_b = nn.Sequential(*[ResidualUnit(inter_dim)
                                      for _ in range(3)],
                                    conv1x1(inter_dim, inter_dim))
        self.non_local_block = SwinBlock(inter_dim, head_dim, window_size)
        self.in_conv = conv1x1(dim, inter_dim)
        self.out_conv = conv1x1(inter_dim, dim)

    def forward(self, x):
        x = self.in_conv(x)
        out = self.conv_a(x) * torch.sigmoid(self.conv_b(
            self.non_local_block(x)))
        return self.out_conv(out + x)


# --------------------------------------------------------------- entropy

class EntropyBottleneck(nn.Module):
    """compressai's factorized prior of z, in its eval form."""

    FILTERS = (3, 3, 3, 3)

    def __init__(self, c=Z_CH):
        super().__init__()
        fs = (1,) + self.FILTERS + (1,)
        for i in range(len(self.FILTERS) + 1):
            self.register_parameter(f"_matrix{i}", nn.Parameter(
                torch.zeros(c, fs[i + 1], fs[i])))
            self.register_parameter(f"_bias{i}", nn.Parameter(
                torch.zeros(c, fs[i + 1], 1)))
            if i < len(self.FILTERS):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.zeros(c, fs[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.zeros(c, 1, 3))

    def logits(self, v):
        for i in range(len(self.FILTERS) + 1):
            v = torch.matmul(F.softplus(getattr(self, f"_matrix{i}")), v) + \
                getattr(self, f"_bias{i}")
            if i < len(self.FILTERS):
                v = v + torch.tanh(getattr(self, f"_factor{i}")) * torch.tanh(v)
        return v

    def forward(self, z):
        """(z_hat, likelihoods) of round(z - median) + median."""
        b, c, h, w = z.shape
        med = self.quantiles[:, 0, 1].reshape(1, c, 1, 1)
        z_hat = torch.round(z - med) + med
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
    """Bits of each symbol of a likelihood tensor, clamped to [0, 50]."""
    return torch.clamp(-torch.log(lik + 1e-10) / math.log(2.0), 0.0, 50.0)


def slice_transform(cin, cout):
    return nn.Sequential(conv(cin, 224), nn.GELU(), conv(224, 128), nn.GELU(),
                         conv(128, cout))


# ------------------------------------------------------------------ model

class TCM(nn.Module):
    def __init__(self, config=(2, 2, 2, 2, 2, 2), head_dim=(8, 16, 32, 32,
                 16, 8), N=128, M=320, num_slices=5, max_support_slices=5,
                 window_size=8, hyper_window=4, hyper_head_dim=32,
                 atten_dim=128, atten_head_dim=16):
        super().__init__()
        self.num_slices, self.max_support_slices = num_slices, max_support_slices
        ws = window_size

        def stage(n, hd, w):
            return [ConvTransBlock(N, N, hd, w, "W" if not i % 2 else "SW")
                    for i in range(n)]

        self.g_a = nn.Sequential(
            ResidualBlockWithStride(3, 2 * N, 2), *stage(config[0], head_dim[0], ws),
            ResidualBlockWithStride(2 * N, 2 * N, 2), *stage(config[1], head_dim[1], ws),
            ResidualBlockWithStride(2 * N, 2 * N, 2), *stage(config[2], head_dim[2], ws),
            conv(2 * N, M, 3, 2))
        self.g_s = nn.Sequential(
            ResidualBlockUpsample(M, 2 * N, 2), *stage(config[3], head_dim[3], ws),
            ResidualBlockUpsample(2 * N, 2 * N, 2), *stage(config[4], head_dim[4], ws),
            ResidualBlockUpsample(2 * N, 2 * N, 2), *stage(config[5], head_dim[5], ws),
            subpel_conv3x3(2 * N, 3, 2))
        self.h_a = nn.Sequential(
            ResidualBlockWithStride(M, 2 * N, 2),
            *stage(config[0], hyper_head_dim, hyper_window),
            conv(2 * N, Z_CH, 3, 2))
        self.h_mean_s = nn.Sequential(
            ResidualBlockUpsample(Z_CH, 2 * N, 2),
            *stage(config[3], hyper_head_dim, hyper_window),
            subpel_conv3x3(2 * N, M, 2))
        self.h_scale_s = nn.Sequential(
            ResidualBlockUpsample(Z_CH, 2 * N, 2),
            *stage(config[3], hyper_head_dim, hyper_window),
            subpel_conv3x3(2 * N, M, 2))
        sw = M // num_slices
        widths = [M + sw * min(i, max_support_slices) for i in range(num_slices)]
        self.atten_mean = nn.ModuleList(nn.Sequential(SWAtten(
            c, atten_head_dim, ws, atten_dim)) for c in widths)
        self.atten_scale = nn.ModuleList(nn.Sequential(SWAtten(
            c, atten_head_dim, ws, atten_dim)) for c in widths)
        self.cc_mean_transforms = nn.ModuleList(
            slice_transform(c, sw) for c in widths)
        self.cc_scale_transforms = nn.ModuleList(
            slice_transform(c, sw) for c in widths)
        self.lrp_transforms = nn.ModuleList(
            slice_transform(c + sw, sw) for c in widths)
        self.entropy_bottleneck = EntropyBottleneck(Z_CH)

    def entropy(self, y):
        """Hard-quantized latents, as the bitstream carries them: dict(y_hat,
        y_bits, z_bits, means, scales) with per-symbol bits."""
        z_hat, z_lik = self.entropy_bottleneck(self.h_a(y))
        lm, ls = self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        h, w = y.shape[2:]
        y_hats, y_bits, mus, scales = [], [], [], []
        for i, y_slice in enumerate(y.chunk(self.num_slices, 1)):
            support = y_hats[:self.max_support_slices]
            ms = self.atten_mean[i](torch.cat([lm] + support, 1))
            mu = self.cc_mean_transforms[i](ms)[:, :, :h, :w]
            ss = self.atten_scale[i](torch.cat([ls] + support, 1))
            scale = self.cc_scale_transforms[i](ss)[:, :, :h, :w]
            sym = torch.round(y_slice - mu)
            y_bits.append(bits(gaussian_likelihood(sym, scale)))
            y_hat = sym + mu
            y_hat = y_hat + 0.5 * torch.tanh(
                self.lrp_transforms[i](torch.cat([ms, y_hat], 1)))
            y_hats.append(y_hat)
            mus.append(mu)
            scales.append(scale)
        return {"y_hat": torch.cat(y_hats, 1), "y_bits": torch.cat(y_bits, 1),
                "z_bits": bits(z_lik), "means": torch.cat(mus, 1),
                "scales": torch.cat(scales, 1)}

    def forward(self, x):
        """x (B, 3, H, W) in [0, 1] -> dict(y, y_hat, x_hat, bpp): bpp the
        code length of the hard-quantized latents per pixel."""
        y = self.g_a(x)
        ent = self.entropy(y)
        b, _, h, w = x.shape
        nbits = ent["y_bits"].sum() + ent["z_bits"].sum()
        return {"y": y, "y_hat": ent["y_hat"], "x_hat": self.g_s(ent["y_hat"]),
                "bpp": nbits / (b * h * w)}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for convolutions and matrix products while the block
    runs."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@torch.no_grad()
def codec(model, image_u8, block: int = 16, tf32_on: bool = False) -> dict:
    """The round trip of opaque uint8 NHWC RGB images whose sides are
    multiples of 64, ``block`` images at a time.  Returns "rgb" (B, H, W, 3)
    uint8 (the decoded image clipped to [0, 1], times 255, rounded) and
    "bits" (B,) float64: each image's code length under the entropy
    models."""
    b, h, w, _ = image_u8.shape
    if h % 64 or w % 64:
        raise ValueError("the reference codes sides that are multiples of 64")
    outs, est = [], []
    with tf32(tf32_on):
        for s in range(0, b, block):
            x = image_u8[s:s + block].float().permute(0, 3, 1, 2) / 255.0
            ent = model.entropy(model.g_a(x))
            x_hat = torch.clamp(model.g_s(ent["y_hat"]), 0.0, 1.0)
            outs.append(torch.round(x_hat.permute(0, 2, 3, 1) * 255.0)
                        .to(torch.uint8))
            est.append((ent["y_bits"].sum((1, 2, 3)) +
                        ent["z_bits"].sum((1, 2, 3))).double())
    return {"rgb": torch.cat(outs), "bits": torch.cat(est)}
