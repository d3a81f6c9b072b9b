"""Batches pipelined through the codec (port of ``rgba_tpu/eval/pipeline.py``).

Within one batch the codec alternates between device work (transforms,
slice statistics) and host work (C++ rANS, fetches), a hard dependency of
channel autoregression; across batches the two are independent, so one
batch's host rANS and fetches can run under the next batch's device work.

``PipelinedCodec`` runs whole encodes and decodes on ``depth`` worker
threads.  One CUDA stream, as in the JAX package ("one client, one
stream"): every worker enqueues on the caller's current stream (the
default stream unless the caller set another), so the card runs the work
in enqueue order and no tensor crosses streams.  The ctypes rANS calls
release the GIL and a fetch blocks only its own thread, so ``depth=2``
keeps one batch's host work under another's device work.  Each worker
enters its own inference mode (the codec's scopes do; it is per thread),
and the process-wide precision flags are counted across threads
(``core/precision.py``).  Results are byte- and bit-identical to the
serial loop: threads change only when work is enqueued.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Sequence

import numpy as np

from .codec_io import caller_stream


class PipelinedCodec:
    """An ``RGBAFileCodec`` behind a depth-bounded batch pipeline.  depth=2:
    one batch in host code or transfer, one in device compute; more only
    queues on the one stream."""

    def __init__(self, codec, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.codec = codec
        self.depth = depth
        self._pool = ThreadPoolExecutor(max_workers=depth)

    def encode_stream(self, batches: Iterable[tuple],
                      **kw) -> Iterator[List[bytes]]:
        """batches: (images, alphas) pairs; yields each batch's container
        blobs, in order.  Keyword arguments go to ``encode_batch``."""
        yield from self._run(batches,
                             lambda ba: self.codec.encode_batch(*ba, **kw))

    def decode_stream(self, blob_batches: Iterable[Sequence[bytes]],
                      output: str = "float32", **kw) -> Iterator[np.ndarray]:
        """blob_batches: lists of blobs; yields (B, H, W, 4) arrays, in
        order.  Keyword arguments (``interleave=``, ``max_slices=``) go to
        ``decode_batch``."""
        yield from self._run(blob_batches,
                             lambda bl: self.codec.decode_batch(
                                 list(bl), output=output, **kw))

    def roundtrip_stream(self, batches: Iterable[tuple],
                         output: str = "float32",
                         stream_format: str = "v64") -> Iterator[tuple]:
        """Encode and decode each batch, pipelined; yields (blobs, rgba):
        the serving loop's shape, a full encode + decode per request
        batch."""
        def step(ba):
            blobs = self.codec.encode_batch(*ba, stream_format=stream_format)
            return blobs, self.codec.decode_batch(blobs, output=output)
        yield from self._run(batches, step)

    def _run(self, items: Iterable, fn) -> Iterator:
        """Submit up to ``depth`` items ahead; yield the results in order."""
        on_stream = caller_stream(getattr(self.codec, "device", None))

        def work(item):
            with on_stream():
                return fn(item)

        pending: list = []
        it = iter(items)
        try:
            while True:
                while len(pending) < self.depth:
                    try:
                        pending.append(self._pool.submit(work, next(it)))
                    except StopIteration:
                        for f in pending:
                            yield f.result()
                        return
                yield pending.pop(0).result()
        finally:
            for f in pending:
                f.cancel()

    def close(self):
        self._pool.shutdown(wait=False)

