"""Hyperprior + channel-wise autoregressive entropy head (port of
``rgba_tpu/models/hyperprior.py``).

* h_a: conv3x3 chain M->320->288->256->224->192, strides 2/1/2/1/2;
* h_mean_s / h_scale_s: subpel/conv chain 192->...->M, x8 upsample;
* cc_mean / cc_scale / lrp transforms: per-slice conv3x3 stacks that
  condition each slice's (mu, sigma) on the hyper latents and at most
  ``max_support_slices`` decoded slices; latent-residual prediction
  0.5 * tanh(.).

A codec may bring its own hyper transforms (``hyper=(h_a, h_mean_s,
h_scale_s)``) and per-slice support transforms (``support=(atten_mean,
atten_scale)``, the mixed Transformer-CNN codec's ``SWAtten``): the mean and
scale supports then pass through them before the cc transforms, and the lrp
transform reads the transformed mean support.  Without them the support is
the concatenation itself, as in the reference.

The codecs subclass ``ChannelARPrior``, so these modules sit at the top
of the codec's state dict (``h_a.0.weight``, ``cc_mean_transforms.0.0.weight``,
``entropy_bottleneck._matrix0``) as in the reference.

Height sharding: the JAX module's ``data_sharding`` pins the whole head to
batch-only sharding, because z (y/8) collapses below any band.  Here, inside
``parallel.spatial.space_scope``, ``entropy_forward`` gathers y over the
``space`` axis, runs the hyper path and the channel-AR slices on the whole
latent on every rank of the space group (the training noise, drawn for the
whole y, is the same on each), and hands back y_hat's band rows.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import Policy
from ..entropy.bottleneck import EntropyBottleneck
from ..entropy.gaussian import GaussianConditional
from ..ops.conv import Conv, GELU, SubpelConv
from ..parallel import spatial
from ..ops.math import ste_round

HYPER_CH = (320, 288, 256, 224, 192)
Z_CHANNELS = 192


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def _hyper_analysis(m: int, policy, device, generator):
    kw = dict(policy=policy, device=device, generator=generator)
    layers, cin = [], m
    for i, (c, s) in enumerate(zip(HYPER_CH, (2, 1, 2, 1, 2))):
        layers.append(Conv(cin, c, 3, s, **kw))
        if i < len(HYPER_CH) - 1:
            layers.append(GELU(policy))
        cin = c
    return nn.Sequential(*layers)


def _hyper_synthesis(m: int, policy, device, generator):
    kw = dict(policy=policy, device=device, generator=generator)
    return nn.Sequential(
        SubpelConv(Z_CHANNELS, 192, 2, **kw), GELU(policy),
        Conv(192, 224, 3, 1, **kw), GELU(policy),
        SubpelConv(224, 256, 2, **kw), GELU(policy),
        Conv(256, 288, 3, 1, **kw), GELU(policy),
        SubpelConv(288, m, 2, **kw))


def _slice_transform(cin: int, cout: int, policy, device, generator):
    kw = dict(policy=policy, device=device, generator=generator)
    return nn.Sequential(Conv(cin, 224, 3, 1, **kw), GELU(policy),
                         Conv(224, 128, 3, 1, **kw), GELU(policy),
                         Conv(128, cout, 3, 1, **kw))


class ChannelARPrior(nn.Module):
    """The entropy head over a latent y (B, M, H, W)."""

    def __init__(self, latent_channels: int, num_slices: int,
                 max_support_slices: int = 5, *, policy: Policy, device,
                 generator, hyper=None, support=None):
        super().__init__()
        m = latent_channels
        self.latent_channels, self.num_slices = m, num_slices
        self.max_support_slices = max_support_slices
        self.policy = policy
        sw = m // num_slices
        args = (policy, device, generator)
        if hyper is None:
            self.h_a = _hyper_analysis(m, *args)
            self.h_mean_s = _hyper_synthesis(m, *args)
            self.h_scale_s = _hyper_synthesis(m, *args)
        else:
            self.h_a, self.h_mean_s, self.h_scale_s = hyper
        self.atten_mean = self.atten_scale = None
        if support is not None:
            self.atten_mean, self.atten_scale = support
        support = [m + min(i, max_support_slices) * sw
                   for i in range(num_slices)]
        self.cc_mean_transforms = nn.ModuleList(
            _slice_transform(cin, sw, *args) for cin in support)
        self.cc_scale_transforms = nn.ModuleList(
            _slice_transform(cin, sw, *args) for cin in support)
        self.lrp_transforms = nn.ModuleList(
            _slice_transform(cin + sw, sw, *args) for cin in support)
        self.entropy_bottleneck = EntropyBottleneck(
            Z_CHANNELS, device=device, generator=generator)
        self.gaussian = GaussianConditional()

    # ------------------------------------------------------------ pieces
    # shared by entropy_forward and the bitstream codec (eval/codec_io.py),
    # so both compute (mu, scale, lrp) through one code path

    def hyper_encode(self, y):
        return self.h_a(y)

    def hyper_decode(self, z_hat):
        return self.h_mean_s(z_hat), self.h_scale_s(z_hat)

    def slice_stats(self, latent_means, latent_scales, support, index: int,
                    y_hw):
        """(mu, scale, mean support) of slice ``index`` given the decoded
        support slices.  The mean support is the hyper means and the
        support slices, through ``atten_mean[index]`` where the codec has
        a support transform; ``slice_lrp`` takes it.  The conv inputs are
        channels_last whatever their parts were, so the encoder and the
        decoder, which build them in separate calls, run the same
        convolution kernels on them."""
        h, w = y_hw
        mean_in = _channels_last(torch.cat([latent_means] + support, dim=1))
        scale_in = _channels_last(torch.cat([latent_scales] + support, dim=1))
        if self.atten_mean is not None:
            mean_in = _channels_last(self.atten_mean[index](mean_in))
            scale_in = _channels_last(self.atten_scale[index](scale_in))
        mu = self.cc_mean_transforms[index](mean_in)
        scale = self.cc_scale_transforms[index](scale_in)
        return mu[:, :, :h, :w], scale[:, :, :h, :w], mean_in

    def slice_lrp(self, mean_support, y_hat_slice, index: int):
        """0.5 tanh(lrp(mean support, y_hat)) of slice ``index``; the mean
        support as ``slice_stats`` returned it."""
        lrp_in = torch.cat([mean_support, y_hat_slice], dim=1)
        return 0.5 * torch.tanh(
            self.lrp_transforms[index](_channels_last(lrp_in)))

    def bottleneck_round(self, z, training: bool = False, generator=None):
        return self.entropy_bottleneck(z, training=training,
                                       generator=generator)

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()

    def entropy_forward(self, y, gate=None, training: bool = False,
                        generator=None):
        """Training or eval entropy pass over y (B, M, H, W).

        Returns dict(y_hat, y_likelihoods, z_likelihoods, means, scales).
        gate: optional (B, 1, H, W) {0, 1} alpha-rate gate; where it is 0
        the symbol is pinned to 0 (y_hat = mu + lrp) at likelihood 1.  A
        serving and eval knob: None in training.
        training: the likelihoods are those of the noise-relaxed latents;
        ``generator`` supplies all the noise, z first, then slice by slice.
        Under height sharding y and gate are bands: y_hat comes back as the
        band's rows, the rest for the whole latent (see the module
        docstring).
        """
        mesh = spatial.current()
        if mesh is None:
            return self._entropy(y, gate, training, generator)
        y = spatial.gather_rows(y.float())
        gate = None if gate is None else spatial.gather_rows(gate)
        with spatial.suspended():
            out = self._entropy(y, gate, training, generator)
        out["y_hat"] = spatial.scatter_rows(out["y_hat"], mesh=mesh)
        return out

    def _entropy(self, y, gate, training, generator):
        y = y.float()
        b, m, h, w = y.shape
        z = self.hyper_encode(y)
        z_hat, z_lik = self.bottleneck_round(z.float(), training, generator)
        latent_means, latent_scales = self.hyper_decode(z_hat)
        latent_means, latent_scales = latent_means.float(), latent_scales.float()

        sw = m // self.num_slices
        y_hat_slices, liks, mus, scales = [], [], [], []
        for i in range(self.num_slices):
            y_slice = y[:, i * sw:(i + 1) * sw]
            support = y_hat_slices[:self.max_support_slices]
            mu, scale, mean_support = self.slice_stats(
                latent_means, latent_scales, support, i, (h, w))
            lik = self.gaussian.likelihood(y_slice, scale, mu, training,
                                           generator)
            if gate is not None:
                lik = torch.where(gate > 0, lik, torch.ones_like(lik))
                y_hat = ste_round((y_slice - mu) * gate) + mu
            else:
                y_hat = ste_round(y_slice - mu) + mu
            y_hat = y_hat + self.slice_lrp(mean_support, y_hat, i)
            y_hat_slices.append(y_hat)
            liks.append(lik)
            mus.append(mu)
            scales.append(scale)
        return {
            "y_hat": torch.cat(y_hat_slices, dim=1),
            "y_likelihoods": torch.cat(liks, dim=1),
            "z_likelihoods": z_lik,
            "means": torch.cat(mus, dim=1),
            "scales": torch.cat(scales, dim=1),
        }

    def forward(self, y, gate=None, training: bool = False, generator=None):
        return self.entropy_forward(y, gate, training, generator)
