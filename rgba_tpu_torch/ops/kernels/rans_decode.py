"""Lane-format rANS decode of one segment: the CUDA kernel
``csrc/rans_decode.cu`` and its plain version.

Port of ``rgba_tpu/entropy/device_rans.py::decode_segment`` (a ``lax.scan``
program).  CPU tensors take the plain version
(``entropy/device_rans.decode_segment``); CUDA tensors launch the kernel,
which updates the lane state and pointer in place, so they stay on the
card from one segment to the next.
"""

from __future__ import annotations

import ctypes

import torch

from ...entropy.device_rans import decode_segment as rans_decode_plain
from .build import CudaKernel

KERNEL = CudaKernel("rans_decode.cu", "rgba_rans_decode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

__all__ = ["KERNEL", "rans_decode", "rans_decode_plain"]


def _want(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"rans_decode: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"rans_decode: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rans_decode: {name} must be contiguous")


def rans_decode(tables: dict, words, state, ptr, indexes, active, lane_end,
                inverse=None):
    """Decode one segment; arguments and result as
    ``entropy.device_rans.decode_segment``: (symbols (T, B, L) int32,
    state, ptr).  On the card, ``state`` (int64) and ``ptr`` (int32) are
    updated in place and returned; the indexes must address rows of the
    tables (the kernel does not check them)."""
    if words.device.type == "cpu":
        return rans_decode_plain(tables, words, state, ptr, indexes, active,
                                 lane_end, inverse)
    if words.device.type != "cuda":
        raise ValueError(f"rans_decode: unsupported device {words.device}")
    lanes_shape = tuple(state.shape)
    steps = indexes.shape[0]
    _want(words, "words", torch.int16)
    _want(state, "state", torch.int64)
    _want(ptr, "ptr", torch.int32, lanes_shape)
    _want(lane_end, "lane_end", torch.int32, lanes_shape)
    _want(indexes, "indexes", torch.int32, (steps,) + lanes_shape)
    _want(active, "active", torch.bool, (steps,) + lanes_shape)
    cdfs, maxv, offs = tables["cdfs"], tables["max_values"], tables["offsets"]
    _want(cdfs, "cdfs", torch.int32)
    if cdfs.dim() != 2:
        raise ValueError("rans_decode: cdfs must be (rows, cols)")
    rows = cdfs.shape[0]
    _want(maxv, "max_values", torch.int32, (rows,))
    _want(offs, "offsets", torch.int32, (rows,))
    si = val = None
    if inverse is not None:
        si, val = inverse["si"], inverse["val"]
        _want(si, "inverse si", torch.int32)
        _want(val, "inverse val", torch.int32)
        if si.numel() % (1 << 16) or 2 * val.numel() != si.numel():
            raise ValueError("rans_decode: the inverse tables must hold "
                             "whole rows (2^16 si and 2^15 val entries each)")
    tensors = [words, state, ptr, lane_end, indexes, active, cdfs, maxv, offs]
    tensors += [t for t in (si, val) if t is not None]
    if any(t.device != words.device for t in tensors):
        raise ValueError("rans_decode: all inputs must be on the words' device")
    syms = torch.empty(indexes.shape, dtype=torch.int32, device=words.device)
    lanes_total = state.numel()
    if steps and lanes_total:
        KERNEL.launch(
            words.data_ptr(), state.data_ptr(), ptr.data_ptr(),
            lane_end.data_ptr(), indexes.data_ptr(), active.data_ptr(),
            cdfs.data_ptr(), cdfs.shape[1], maxv.data_ptr(), offs.data_ptr(),
            0 if si is None else si.data_ptr(),
            0 if val is None else val.data_ptr(), syms.data_ptr(), steps,
            lanes_total, torch.cuda.current_stream(words.device).cuda_stream)
    return syms, state, ptr
