"""Lane-format rANS decode of one segment: the CUDA kernel
``csrc/rans_decode.cu`` and its plain version.

Port of ``rgba_tpu/entropy/device_rans.py::decode_segment`` (a ``lax.scan``
program).  CPU tensors take the plain version
(``entropy/device_rans.decode_segment``); CUDA tensors launch the kernel,
which updates the lane state and pointer in place, so they stay on the
card from one segment to the next.  The kernel reads its CDF rows from
shared memory, staged from the compact layout of the rows the segment
addresses (``entropy/device_rans.segment_tables``).
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ...entropy.device_rans import SMEM_BUDGET, segment_tables
from ...entropy.device_rans import decode_segment as rans_decode_plain
from .build import CudaKernel

KERNEL = CudaKernel("rans_decode.cu", "rgba_rans_decode", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])

__all__ = ["KERNEL", "all_rows_layout", "rans_decode", "rans_decode_plain",
           "staged_layout"]

# tables passed without "compact": the layout of all their rows, built once
# per cdfs tensor (again when one of the three tables is replaced or
# changed in place), by id(cdfs), dropped when that tensor is freed
_ALL_ROWS: dict = {}


def _want(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"rans_decode: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"rans_decode: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rans_decode: {name} must be contiguous")


def all_rows_layout(tables: dict) -> dict:
    """The compact layout of all the rows of ``tables``, built from a host
    copy of them the first time and kept with their cdfs tensor."""
    cdfs = tables["cdfs"]
    key = tuple((id(tables[k]), tables[k]._version)
                for k in ("cdfs", "max_values", "offsets"))
    hit = _ALL_ROWS.get(id(cdfs))
    if hit is None or hit[0] != key:
        if hit is None:
            weakref.finalize(cdfs, _ALL_ROWS.pop, id(cdfs), None)
        hit = (key, segment_tables(tables)["compact"])
        _ALL_ROWS[id(cdfs)] = hit
    return hit[1]


def staged_layout(tables: dict, kernel: str, staged) -> dict:
    """The compact layout a kernel stages: ``tables["compact"]`` (made by
    ``segment_tables``), else ``all_rows_layout(tables)``.
    ``staged(layout)`` gives the bytes the kernel copies to shared memory;
    more than SMEM_BUDGET raises, as does a blob that is not 16-byte
    aligned uint8 on the tables' device."""
    layout = tables.get("compact")
    if layout is None:
        try:
            layout = all_rows_layout(tables)
        except ValueError as e:
            raise ValueError(f"{kernel}: {e}") from None
    blob = layout["blob"]
    if blob.dtype != torch.uint8 or blob.dim() != 1 or \
            not blob.is_contiguous() or blob.data_ptr() % 16 or \
            blob.device != tables["cdfs"].device:
        raise ValueError(f"{kernel}: the compact layout's blob must be a "
                         f"16-byte aligned uint8 vector on the tables' device")
    need = staged(layout)
    if need > SMEM_BUDGET or need > blob.numel():
        raise ValueError(f"{kernel}: the compact layout stages {need} bytes "
                         f"of shared memory; the kernel sizes for at most "
                         f"{SMEM_BUDGET} (and the blob holds {blob.numel()})")
    return layout


def _decode_bytes(layout: dict) -> int:
    return (layout["info_bytes"] + layout["starts_bytes"] +
            layout["buckets_bytes"])


def rans_decode(tables: dict, words, state, ptr, indexes, active, lane_end,
                inverse=None):
    """Decode one segment; arguments and result as
    ``entropy.device_rans.decode_segment``: (symbols (T, B, L) int32,
    state, ptr).  On the card, ``state`` (int64) and ``ptr`` (int32) are
    updated in place and returned; ``tables`` may carry the compact layout
    of the rows the segment addresses (``segment_tables``), else the
    layout of all rows is used (``all_rows_layout``, built once); the
    indexes must address rows of it (the kernel does not check them).  ``inverse`` speeds up the plain version;
    the kernel does not read it."""
    if words.device.type == "cpu":
        return rans_decode_plain(tables, words, state, ptr, indexes, active,
                                 lane_end, inverse)
    if words.device.type != "cuda":
        raise ValueError(f"rans_decode: unsupported device {words.device}")
    lanes_shape = tuple(state.shape)
    steps = indexes.shape[0]
    _want(words, "words", torch.int16)
    if words.numel() == 0:
        raise ValueError("rans_decode: no words")
    _want(state, "state", torch.int64)
    _want(ptr, "ptr", torch.int32, lanes_shape)
    _want(lane_end, "lane_end", torch.int32, lanes_shape)
    _want(indexes, "indexes", torch.int32, (steps,) + lanes_shape)
    _want(active, "active", torch.bool, (steps,) + lanes_shape)
    cdfs = tables["cdfs"]
    tensors = [words, state, ptr, lane_end, indexes, active, cdfs]
    if any(t.device != words.device for t in tensors):
        raise ValueError("rans_decode: all inputs must be on the words' device")
    layout = staged_layout(tables, "rans_decode", _decode_bytes)
    syms = torch.empty(indexes.shape, dtype=torch.int32, device=words.device)
    lanes_total = state.numel()
    if steps and lanes_total:
        head = layout["info_bytes"] + layout["starts_bytes"]
        r0, r1 = layout["rows"]
        KERNEL.launch(
            words.data_ptr(), words.numel(), state.data_ptr(), ptr.data_ptr(),
            lane_end.data_ptr(), indexes.data_ptr(), active.data_ptr(),
            layout["blob"].data_ptr(), head, layout["info_bytes"],
            head + layout["rcp_bytes"], layout["buckets_bytes"], r0, r1 - r0,
            syms.data_ptr(), steps, lanes_total,
            torch.cuda.current_stream(words.device).cuda_stream)
    return syms, state, ptr
