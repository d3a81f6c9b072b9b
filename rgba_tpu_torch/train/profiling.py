"""Tracing and per-step timing (port of ``rgba_tpu/train/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and device activity) of the
    block into ``log_dir/trace.json`` (Chrome trace format); yields the
    profiler, whose ``key_averages()`` sums device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock per-step timing with an exponential moving average.  The
    caller synchronizes the device before ``stop`` where it wants device
    work included."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        yield
        self.stop()
