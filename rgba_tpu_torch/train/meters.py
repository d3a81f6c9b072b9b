"""Windowed and weighted running averages (port of
``rgba_tpu/train/meters.py``)."""

from __future__ import annotations

from collections import deque


class WeightedMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.sum = 0.0
        self.avg = 0.0
        self.val = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.count += n
        self.sum += val * n
        self.avg = self.sum / max(self.count, 1)


class AverageMeter:
    """Ring-buffer average over the last ``length`` updates (all, if 0)."""

    def __init__(self, length: int = 0):
        self.length = length
        self.reset()

    def reset(self):
        self.history = deque(maxlen=self.length if self.length > 0 else None)
        self.val = 0.0
        self.avg = 0.0

    def update(self, val: float):
        self.val = float(val)
        self.history.append(self.val)
        self.avg = sum(self.history) / len(self.history)
