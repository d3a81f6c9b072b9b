"""Shape-bucket ladder for serving images of many sizes (the port's own copy
of ``rgba_tpu/eval/buckets.py``, numpy free and with the same tie-breaking,
so both packages pick the same ladder for the same sizes).

An image is coded on a /64-aligned canvas; a bucket is a larger canvas that
several sizes share (``RGBAFileCodec.encode_batch(..., bucket=)``), so
images of different sizes can go through one batch of one shape.  The
extra canvas is transparent padding recorded nowhere: the container keeps
the original (h, w) and the decoder crops back.  Transparent padding costs
few bits in the masked codecs (none of the latent cells the rate gate
closes), so the ladder trades a bounded bpp overhead for fewer distinct
batch shapes.  The JAX package buys fewer compiled executables with it;
the port compiles nothing per shape, and gains batches that mix sizes and
its per-shape caches (the codec's lane step tensors) that stay few.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

Shape = Tuple[int, int]


def pad64(h: int, w: int) -> Shape:
    """The minimal /64-aligned canvas for an (h, w) image."""
    return (-(-h // 64) * 64, -(-w // 64) * 64)


def choose_buckets(sizes: Iterable[Shape],
                   max_waste: float = 0.3) -> Dict[Shape, Shape]:
    """Map each (h, w) input size to a /64-aligned bucket canvas.

    Greedy from the largest padded shape down: a size folds into an
    existing bucket when the bucket covers it and the extra padded area
    (bucket area / its own minimal padded area - 1) stays within
    ``max_waste``, the smallest such bucket winning; otherwise its own
    minimal /64 canvas becomes a new bucket.  Deterministic in the set of
    sizes (ties broken by shape).  max_waste=0 gives one bucket per
    distinct padded shape.
    """
    max_waste = max(0.0, float(max_waste))
    mapping: Dict[Shape, Shape] = {}
    buckets: List[Shape] = []
    distinct = sorted({(int(h), int(w)) for h, w in sizes},
                      key=lambda s: (pad64(*s)[0] * pad64(*s)[1], s),
                      reverse=True)
    for h, w in distinct:
        ph, pw = pad64(h, w)
        own = ph * pw
        best = None
        for bh, bw in buckets:
            if bh >= ph and bw >= pw and bh * bw <= own * (1 + max_waste):
                if best is None or bh * bw < best[0] * best[1]:
                    best = (bh, bw)
        if best is None:
            best = (ph, pw)
            buckets.append(best)
        mapping[(h, w)] = best
    return mapping


def pad_batch(items: list, batch: int) -> tuple:
    """Pad ``items`` to a multiple of ``batch`` by repeating the last item;
    returns (chunks, real_counts): chunks of exactly ``batch`` items and how
    many of each are real, so a ragged tail runs at the full batch size."""
    chunks, real = [], []
    for i in range(0, len(items), batch):
        ch = list(items[i:i + batch])
        real.append(len(ch))
        ch += [ch[-1]] * (batch - len(ch))
        chunks.append(ch)
    return chunks, real
