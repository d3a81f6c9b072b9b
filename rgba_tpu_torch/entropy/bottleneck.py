"""Factorized-prior entropy bottleneck over the hyper-latent z (port of
``rgba_tpu/entropy/bottleneck.py``; Ballé et al. 2018, appendix 6.1).

The per-channel CDF is a chain of K+1 monotone layers,
logits_{k+1} = softplus(M_k) @ logits_k + b_k [+ tanh(a_k) * tanh(...)];
an integer bin's likelihood is CDF(v+0.5) - CDF(v-0.5), taken with the
sign trick.  Parameter names follow compressai (``_matrix0``, ``quantiles``).
``cdf_tables`` builds the codec's per-channel CDF rows on the host, in fp32
on the CPU.  All math is fp32.

``F.softplus`` returns x itself above its threshold of 20, where
log1p(exp(x)) - x < 2.1e-9: below fp32 resolution of x.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.math import lower_bound, ste_round
from .cdf import build_cdf_rows

_LIKELIHOOD_BOUND = 1e-9


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, filters=(3, 3, 3, 3),
                 init_scale: float = 10.0, *, device, generator):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        fs = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            v = math.log(math.expm1(1 / scale / fs[i + 1]))
            self.register_parameter(f"_matrix{i}", nn.Parameter(torch.full(
                (channels, fs[i + 1], fs[i]), v, device=device)))
            bias = torch.empty(channels, fs[i + 1], 1).uniform_(
                -0.5, 0.5, generator=generator)
            self.register_parameter(f"_bias{i}", nn.Parameter(bias.to(device)))
            if i < len(self.filters):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.zeros(channels, fs[i + 1], 1, device=device)))
        q = torch.tensor([-init_scale, 0.0, init_scale], device=device)
        self.quantiles = nn.Parameter(q.reshape(1, 1, 3).repeat(channels, 1, 1))

    def _logits_cumulative(self, inputs, params=None):
        """inputs: (C, 1, N) -> logits of the cumulative at those points;
        params: the module's parameters by name, or copies of them."""
        p = dict(self.named_parameters()) if params is None else params
        logits = inputs
        for i in range(len(self.filters) + 1):
            logits = torch.bmm(F.softplus(p[f"_matrix{i}"]), logits) + \
                p[f"_bias{i}"]
            if i < len(self.filters):
                logits = logits + torch.tanh(p[f"_factor{i}"]) * torch.tanh(logits)
        return logits

    def _likelihood(self, v):
        lower = self._logits_cumulative(v - 0.5)
        upper = self._logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def medians(self):
        return self.quantiles[:, 0, 1]

    @torch.no_grad()
    def cdf_tables(self) -> dict:
        """Integer CDF tables of the z coder: quantized_cdfs (C, L),
        cdf_lengths (C,), offsets (C,), medians (C,) and pmf_length (C,).
        The pmf is sampled between the quantiles around each median; the
        logits run in fp32 on the CPU whatever the module's device."""
        medians = self.medians().float().cpu().numpy()
        quantiles = self.quantiles.float().cpu().numpy()
        minima = np.maximum(
            np.ceil(medians - quantiles[:, 0, 0]).astype(np.int32), 0)
        maxima = np.maximum(
            np.ceil(quantiles[:, 0, 2] - medians).astype(np.int32), 0)
        pmf_start = medians - minima
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())
        samples = np.arange(max_length, dtype=np.float32)[None, :] + \
            pmf_start[:, None]
        v = torch.from_numpy(samples.reshape(self.channels, 1, -1)).float()

        cpu = {k: p.detach().float().cpu() for k, p in self.named_parameters()}
        lower = self._logits_cumulative(v - 0.5, cpu)
        upper = self._logits_cumulative(v + 0.5, cpu)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        tail = torch.sigmoid(lower[:, 0, :1]) + torch.sigmoid(-upper[:, 0, -1:])
        cdfs, cdf_lengths = build_cdf_rows(pmf[:, 0, :].numpy(), pmf_length,
                                           tail[:, 0].numpy())
        return {"quantized_cdfs": cdfs, "cdf_lengths": cdf_lengths,
                "offsets": -minima, "medians": medians,
                "pmf_length": pmf_length}

    def forward(self, z):
        """Eval forward.  z: (B, C, H, W) -> (z_hat, likelihoods): the
        likelihoods of round(z - median) + median, and z_hat the
        straight-through rounding around the medians."""
        z = z.float()
        b, c, h, w = z.shape
        med = self.medians().reshape(1, c, 1, 1)
        perturbed = torch.round(z - med) + med
        v = perturbed.permute(1, 0, 2, 3).reshape(c, 1, -1)
        lik = lower_bound(self._likelihood(v), _LIKELIHOOD_BOUND)
        lik = lik.reshape(c, b, h, w).permute(1, 0, 2, 3)
        return ste_round(z - med) + med, lik
