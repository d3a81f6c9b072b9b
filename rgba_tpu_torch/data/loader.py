"""Threaded prefetching batch loader, numpy and threads only (port of
``rgba_tpu/data/loader.py``).

Host-side sample loading runs in a thread pool while the previous batch is
on the device; batches are dicts of stacked numpy arrays.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def _stack(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class BatchLoader:
    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 2, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(f"{self.seed}:{self.epoch}").shuffle(order)
        epoch = self.epoch
        self.epoch += 1

        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def fetch(idx):
            if hasattr(self.dataset, "get"):
                try:
                    return self.dataset.get(idx, epoch_seed=epoch)
                except TypeError:
                    return self.dataset.get(idx)
            return self.dataset[idx]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """False once the consumer has gone away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for batch_idx in batches:
                        if not put(_stack(list(ex.map(fetch, batch_idx)))):
                            return
                put(None)
            except Exception as e:           # raised in the consumer, below
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
