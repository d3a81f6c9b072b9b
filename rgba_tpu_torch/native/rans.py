"""ctypes bindings for the host rANS coder ``native/rans.cpp``.

Port of ``rgba_tpu/native/rans.py`` (the 64-bit streams, "v64"): the card
produces int32 symbols and CDF-row indexes, and this module turns them into
bytes on the CPU and back.  ``RansDecoder`` streams one byte string slice
by slice for the channel-autoregressive decode.  ``encode_lanes`` /
``decode_lanes`` code the lane format ("lanes32": L interleaved 32-bit
rANS lanes per image, see ``entropy/device_rans.py``), which the card
decodes itself (``ops/kernels/rans_decode.py``).

g++ builds the library at first use into ``<repo>/build/native/`` under a
name that carries a digest of the source, the flags and the host CPU's
feature flags (``-march=native``).  It writes a temporary file and renames
it, so processes that build at once never load a half-written library.  A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("rans.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    return BUILD_DIR / f"librans-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library if it is missing; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rans_pmf_to_quantized_cdf.restype = ctypes.c_int
        lib.rans_pmf_to_quantized_cdf.argtypes = [f32p, ctypes.c_int,
                                                  ctypes.c_int, u32p]
        lib.rans_encode_with_indexes.restype = ctypes.c_int64
        lib.rans_encode_with_indexes.argtypes = [
            i32p, i32p, ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_int,
            i32p, i32p, u8p, ctypes.c_int64]
        lib.rans_decoder_new.restype = ctypes.c_void_p
        lib.rans_decoder_new.argtypes = [u8p, ctypes.c_int64]
        lib.rans_decoder_free.restype = None
        lib.rans_decoder_free.argtypes = [ctypes.c_void_p]
        lib.rans_decode_stream.restype = ctypes.c_int
        lib.rans_decode_stream.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i32p]
        lib.rans_decode_with_indexes.restype = ctypes.c_int
        lib.rans_decode_with_indexes.argtypes = [
            u8p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, ctypes.c_int,
            ctypes.c_int, i32p, i32p, i32p]
        i64p = ctypes.POINTER(ctypes.c_int64)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.rans32_encode_lanes.restype = ctypes.c_int64
        lib.rans32_encode_lanes.argtypes = [
            i32p, i32p, u8p, i64p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, i32p, ctypes.c_int, i32p, i32p, u16p,
            ctypes.c_int64, i32p]
        lib.rans32_decode_lanes.restype = ctypes.c_int
        lib.rans32_decode_lanes.argtypes = [
            u16p, i32p, i32p, u8p, i64p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, i32p, ctypes.c_int, i32p, i32p, i32p]
        _lib = lib
        return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _tables(cdfs, cdf_lengths, offsets):
    """Validated int32 tables: every index must address a row, which the
    C++ coder does not check."""
    cdfs, cdf_lengths, offsets = _i32(cdfs), _i32(cdf_lengths), _i32(offsets)
    if cdfs.ndim != 2 or cdf_lengths.shape != (cdfs.shape[0],) or \
            offsets.shape != (cdfs.shape[0],):
        raise ValueError(f"CDF tables do not match: cdfs {cdfs.shape}, "
                         f"lengths {cdf_lengths.shape}, offsets {offsets.shape}")
    return cdfs, cdf_lengths, offsets


def _check_indexes(indexes, rows: int):
    if indexes.size and (indexes.min() < 0 or indexes.max() >= rows):
        raise ValueError(f"CDF index out of range [0, {rows})")


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    lib = _get_lib()
    pmf = np.ascontiguousarray(pmf, dtype=np.float32)
    out = np.zeros(pmf.shape[0] + 1, dtype=np.uint32)
    rc = lib.rans_pmf_to_quantized_cdf(
        _ptr(pmf, ctypes.c_float), pmf.shape[0], precision,
        _ptr(out, ctypes.c_uint32))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed: {rc}")
    return out


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    lib = _get_lib()
    symbols = _i32(symbols).ravel()
    indexes = _i32(indexes).ravel()
    cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
    if symbols.shape != indexes.shape:
        raise ValueError(f"{symbols.size} symbols but {indexes.size} indexes")
    _check_indexes(indexes, cdfs.shape[0])
    cap = max(4096, symbols.size * 8 + 64)
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.rans_encode_with_indexes(
        _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32),
        symbols.size, _ptr(cdfs, ctypes.c_int32), cdfs.shape[0],
        cdfs.shape[1], _ptr(cdf_lengths, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32), _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError("rans encode buffer overflow")
    return out[:n].tobytes()


def decode_with_indexes(data: bytes, indexes, cdfs, cdf_lengths,
                        offsets) -> np.ndarray:
    lib = _get_lib()
    indexes = _i32(indexes)
    shape = indexes.shape
    flat = indexes.ravel()
    cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
    _check_indexes(flat, cdfs.shape[0])
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(flat.size, dtype=np.int32)
    rc = lib.rans_decode_with_indexes(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(flat, ctypes.c_int32),
        flat.size, _ptr(cdfs, ctypes.c_int32), cdfs.shape[0], cdfs.shape[1],
        _ptr(cdf_lengths, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"rans decode failed: {rc}")
    return out.reshape(shape)


def _segments(seg_ends, n: int) -> np.ndarray:
    seg_ends = np.ascontiguousarray(seg_ends, dtype=np.int64).ravel()
    if seg_ends.size == 0 or seg_ends[-1] != n or \
            (np.diff(seg_ends, prepend=0) < 0).any():
        raise ValueError(f"segment ends {seg_ends.tolist()[:8]} must rise "
                         f"to the symbol count {n}")
    return seg_ends


def _alive(alive, n: int):
    """uint8 alive mask (or None) and its ctypes pointer."""
    if alive is None:
        return None, None
    alive = np.ascontiguousarray(alive, dtype=np.uint8).ravel()
    if alive.size != n:
        raise ValueError(f"{alive.size} alive flags for {n} symbols")
    return alive, _ptr(alive, ctypes.c_uint8)


def encode_lanes(symbols, indexes, seg_ends, lanes: int, cdfs, cdf_lengths,
                 offsets, alive=None) -> tuple:
    """Encode one flat symbol sequence, cut into segments at ``seg_ends``,
    into ``lanes`` interleaved 32-bit rANS lanes.  Within a segment,
    position p goes to lane p % lanes; positions whose ``alive`` flag is 0
    are not coded.  Returns (words uint16, lane_nwords int32): every lane's
    words in decode order, lane after lane, and each lane's word count."""
    lib = _get_lib()
    symbols = _i32(symbols).ravel()
    indexes = _i32(indexes).ravel()
    cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
    if symbols.shape != indexes.shape:
        raise ValueError(f"{symbols.size} symbols but {indexes.size} indexes")
    if lanes < 1:
        raise ValueError(f"lanes must be at least 1, got {lanes}")
    _check_indexes(indexes, cdfs.shape[0])
    seg_ends = _segments(seg_ends, symbols.size)
    alive, alive_p = _alive(alive, symbols.size)
    cap = symbols.size * 3 + 4 * lanes + 64
    out = np.zeros(cap, dtype=np.uint16)
    lane_nwords = np.zeros(lanes, dtype=np.int32)
    n = lib.rans32_encode_lanes(
        _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32),
        alive_p, _ptr(seg_ends, ctypes.c_int64), seg_ends.size,
        symbols.size, lanes, _ptr(cdfs, ctypes.c_int32), cdfs.shape[1],
        _ptr(cdf_lengths, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
        _ptr(out, ctypes.c_uint16), cap, _ptr(lane_nwords, ctypes.c_int32))
    if n == -1:
        raise RuntimeError("rans32 encode buffer overflow")
    if n < 0:
        raise RuntimeError(f"rans32_encode_lanes failed: {n}")
    return out[:n].copy(), lane_nwords


def decode_lanes(words, lane_nwords, indexes, seg_ends, cdfs, cdf_lengths,
                 offsets, alive=None) -> np.ndarray:
    """Decode a lane stream on the host (the C++ twin of the card's
    decoder); positions whose ``alive`` flag is 0 decode as 0.  Each lane
    reads no word past its own end."""
    lib = _get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint16).ravel()
    lane_nwords = _i32(lane_nwords).ravel()
    indexes = _i32(indexes)
    shape = indexes.shape
    flat = indexes.ravel()
    cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
    _check_indexes(flat, cdfs.shape[0])
    if lane_nwords.size < 1 or lane_nwords.min() < 2 or \
            int(lane_nwords.sum()) > words.size:
        raise ValueError(f"lane word counts (sum {int(lane_nwords.sum())}, "
                         f"each at least 2) do not fit {words.size} words")
    seg_ends = _segments(seg_ends, flat.size)
    alive, alive_p = _alive(alive, flat.size)
    out = np.zeros(flat.size, dtype=np.int32)
    rc = lib.rans32_decode_lanes(
        _ptr(words, ctypes.c_uint16), _ptr(lane_nwords, ctypes.c_int32),
        _ptr(flat, ctypes.c_int32), alive_p,
        _ptr(seg_ends, ctypes.c_int64), seg_ends.size, flat.size,
        lane_nwords.size, _ptr(cdfs, ctypes.c_int32), cdfs.shape[1],
        _ptr(cdf_lengths, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"rans32_decode_lanes failed: {rc}")
    return out.reshape(shape)


class RansDecoder:
    """Streaming decoder over one byte string (decode_stream per slice).
    Holds native state: close() it, or use it as a context manager."""

    def __init__(self, data: bytes):
        self._lib = _get_lib()
        self._buf = np.frombuffer(data, dtype=np.uint8)
        self._handle = self._lib.rans_decoder_new(
            _ptr(self._buf, ctypes.c_uint8), self._buf.size)

    def decode_stream(self, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
        if not self._handle:
            raise RuntimeError("RansDecoder is closed")
        indexes = _i32(indexes)
        shape = indexes.shape
        flat = indexes.ravel()
        cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
        _check_indexes(flat, cdfs.shape[0])
        out = np.zeros(flat.size, dtype=np.int32)
        rc = self._lib.rans_decode_stream(
            self._handle, _ptr(flat, ctypes.c_int32), flat.size,
            _ptr(cdfs, ctypes.c_int32), cdfs.shape[0], cdfs.shape[1],
            _ptr(cdf_lengths, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
            _ptr(out, ctypes.c_int32))
        if rc != 0:
            raise RuntimeError(f"rans decode_stream failed: {rc}")
        return out.reshape(shape)

    def close(self):
        if self._handle:
            self._lib.rans_decoder_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
