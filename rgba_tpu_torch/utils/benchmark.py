"""Device timing (port of ``rgba_tpu/utils/benchmark.py``).

On the card: CUDA events around ``iters`` calls enqueued back to back on
distinct inputs, one synchronize at the end and none inside the loop, so
the mean covers the device's work and not the host's wait for it.  With
``hold_cycles`` the card first spins that many cycles
(``torch.cuda._sleep``) while the host enqueues the calls, so a call
shorter than its own launch work is timed on the device, not the host's
gaps between launches.  On the CPU, ``time.perf_counter`` around the same
loop.  The JAX version's host-fetch protocol was a workaround for a remote
TPU runtime and is not ported.

The module imports nothing of the package, so ``chip_smoke.py --base`` can
load this checkout's file to time another checkout's kernels with it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch


def _device_of(inputs: Sequence[tuple]) -> Optional[torch.device]:
    for args in inputs:
        for a in args:
            if isinstance(a, torch.Tensor):
                return a.device
    return None


def device_time(fn: Callable, inputs: Sequence[tuple], iters: int = 20,
                warmup: int = 1, device=None, hold_cycles: int = 0) -> float:
    """Mean seconds per call of fn(*inputs[i % len(inputs)]).  The device
    is ``device``, else that of the first tensor in ``inputs``, else
    ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device(device if device is not None
                       else _device_of(inputs) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_time: CUDA is not available; pass "
                           "device='cpu' to time on the CPU")
    for w in range(warmup):
        fn(*inputs[w % len(inputs)])
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
