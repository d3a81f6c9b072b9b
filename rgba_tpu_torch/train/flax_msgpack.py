"""Read the JAX package's checkpoints: a decoder of the msgpack subset that
``flax.serialization.to_bytes`` writes, numpy and the standard library only.

The subset: maps, arrays, str, bin, ints, floats, nil and bool, and two
extension types of flax (``flax/serialization.py``):

  * ext 1, an ndarray: its payload is itself msgpack, (shape, dtype name,
    C-order bytes);
  * ext 3, a numpy scalar: the same payload, unpacked to a scalar.

A ``bfloat16`` leaf is read as uint16 and viewed as ``torch.bfloat16``
(numpy has no bfloat16).  Arrays flax cut into chunks
(``__msgpack_chunked_array__`` nodes, leaves above its ``MAX_CHUNK_SIZE``)
are joined again, so ``restore`` returns the nested dict that
``flax.serialization.msgpack_restore`` returns.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

# first byte -> (struct format, width) of a fixed-width scalar
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1),
            0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4),
            0xd3: (">q", 8)}
# first byte -> width of the length that follows
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, width: int) -> int:
        return struct.unpack(_LEN[width], self.take(width))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _SCALARS:
            fmt, width = _SCALARS[b]
            return struct.unpack(fmt, self.take(width))[0]
        if b in _STR:
            return str(self.take(self.length(_STR[b])), "utf-8")
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b])))
        if b in _ARRAY:
            return [self.value() for _ in range(self.length(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.length(_MAP[b]))
        if b in _EXT or b in _FIXEXT:
            n = self.length(_EXT[b]) if b in _EXT else _FIXEXT[b]
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset "
                         f"flax checkpoints use")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(payload: bytes):
    shape, dtype, buf = unpackb(payload)
    if dtype == "bfloat16":
        flat = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    raise ValueError(f"msgpack extension type {code} is not one flax writes "
                     f"for array checkpoints")


def unpackb(data: bytes):
    """One msgpack object from ``data``, flax's extension types decoded."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         f"object")
    return out


def _unchunk(node):
    if not isinstance(node, dict):
        return node
    if CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore(data)`` returns."""
    return _unchunk(unpackb(data))


def is_msgpack_map(head: bytes, size: int) -> bool:
    """A msgpack map starts with 0x80-0x8f (fixmap) or 0xde / 0xdf.  A
    pickle, which older ``torch.save`` files are, starts with 0x80 and its
    protocol number, so 0x80 counts only as a whole (empty) file."""
    if not head:
        return False
    b = head[0]
    return 0x81 <= b <= 0x8f or b in (0xde, 0xdf) or (b == 0x80 and size == 1)
