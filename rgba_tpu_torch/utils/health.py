"""The card's health canary (port of ``rgba_tpu/utils/health.py``).

A bf16 n^3 matrix product has no project code in it, so its TF/s measures
the environment: the card, its clocks and power limit, its neighbours.  A
benchmark record carries it, and a rate below ``DEGRADED_BELOW`` of
``HEALTHY_TFS`` marks the record as taken on a degraded card.

``HEALTHY_TFS`` is the canary's reading on an NVIDIA H100 80GB HBM3 with a
700 W power limit (``chip_smoke.py``'s first phase, ``PERF.md``), not the
TPU's 173.  ``other_tpu_clients`` (the JAX module's check for other clients
of a remote TPU runtime) is not ported: a CUDA card has no such runtime.
"""

from __future__ import annotations

import time

import torch

from ..core.precision import resolve_device
from .benchmark import device_time

HEALTHY_TFS = 793.6  # the canary on an NVIDIA H100 80GB HBM3, 700 W limit
DEGRADED_BELOW = 0.6  # fraction of HEALTHY_TFS


def chip_health(n: int = 8192, iters: int = 16, device=None) -> dict:
    """bf16 n^3 ``torch.matmul`` TF/s and the ms of one host fetch of a
    scalar, measured in this process on ``device`` (``cuda`` unless the
    caller passes another)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    # two distinct operand pairs, in turns
    mats = [tuple(torch.randn(n, n, generator=g, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
            for _ in range(2)]
    sec = device_time(torch.matmul, mats, iters=iters, warmup=2)
    tflops = 2 * n ** 3 / sec / 1e12

    one = torch.matmul(*mats[0])
    one[0, 0].item()
    t0 = time.perf_counter()
    for _ in range(4):
        one[0, 0].item()
    sync_ms = (time.perf_counter() - t0) / 4 * 1e3

    frac = tflops / HEALTHY_TFS
    return {"matmul_tflops": round(tflops, 1),
            "sync_ms": round(sync_ms, 3),
            "healthy_frac": round(frac, 3),
            "degraded": frac < DEGRADED_BELOW}
