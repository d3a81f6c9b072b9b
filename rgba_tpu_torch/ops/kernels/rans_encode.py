"""Lane-format rANS encode of one segment: the CUDA kernel
``csrc/rans_encode.cu`` and its plain version.

Port of ``rgba_tpu/entropy/device_rans.py::encode_segment`` (a reverse
``lax.scan`` program).  CPU tensors take the plain version
(``entropy/device_rans.encode_segment``); CUDA tensors launch the kernel,
which updates the lane state, the write pointer and the word buffer in
place, so they stay on the card from one segment to the next.  The flush
and reversal (``entropy/device_rans.finish_lanes``) is tensor indexing on
either device.  The kernel reads its CDF rows and their reciprocals from
shared memory, staged from the compact layout of the rows the segment
addresses (``entropy/device_rans.segment_tables``).
"""

from __future__ import annotations

import ctypes

import torch

from ...entropy.device_rans import encode_segment as rans_encode_plain
from .build import CudaKernel
from .rans_decode import staged_layout

KERNEL = CudaKernel("rans_encode.cu", "rgba_rans_encode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])

# the types the kernel reads and widens itself (the codec's uint8 y rows,
# int16 z rows and int16 symbols, or int32)
INDEX_DTYPES = (torch.uint8, torch.int16, torch.int32)
SYMBOL_DTYPES = (torch.int16, torch.int32)

__all__ = ["KERNEL", "rans_encode", "rans_encode_plain"]


def _want(t, name, dtype, shape=None):
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"rans_encode: {name} must be one of {dtypes}, got "
                        f"{t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"rans_encode: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rans_encode: {name} must be contiguous")


def rans_encode(tables: dict, state, wptr, out_words, indexes, symbols,
                active):
    """Encode one segment; arguments and result as
    ``entropy.device_rans.encode_segment``: (state, wptr, out_words).  On
    the card all three are updated in place and returned; ``tables`` may
    carry the compact layout of the rows the segment addresses
    (``segment_tables``), else the layout of all rows is used
    (``rans_decode.all_rows_layout``, built once); the indexes (uint8,
    int16 or int32) must address rows of it (the kernel does not check
    them), the symbols are int16 or int32."""
    if state.device.type == "cpu":
        return rans_encode_plain(tables, state, wptr, out_words, indexes,
                                 symbols, active)
    if state.device.type != "cuda":
        raise ValueError(f"rans_encode: unsupported device {state.device}")
    lanes_shape = tuple(state.shape)
    steps = indexes.shape[0]
    _want(state, "state", torch.int64)
    _want(wptr, "wptr", torch.int32, lanes_shape)
    _want(out_words, "out_words", torch.int32)
    if tuple(out_words.shape[:-1]) != lanes_shape or out_words.shape[-1] < 1:
        raise ValueError(f"rans_encode: out_words has shape "
                         f"{tuple(out_words.shape)}, expected "
                         f"{lanes_shape} + (budget,)")
    _want(indexes, "indexes", INDEX_DTYPES, (steps,) + lanes_shape)
    _want(symbols, "symbols", SYMBOL_DTYPES, (steps,) + lanes_shape)
    _want(active, "active", torch.bool, (steps,) + lanes_shape)
    tensors = (wptr, out_words, indexes, symbols, active, tables["cdfs"])
    if any(t.device != state.device for t in tensors):
        raise ValueError("rans_encode: all inputs must be on the state's "
                         "device")
    layout = staged_layout(tables, "rans_encode", _encode_bytes)
    lanes_total = state.numel()
    if steps and lanes_total:
        r0, r1 = layout["rows"]
        KERNEL.launch(
            state.data_ptr(), wptr.data_ptr(), out_words.data_ptr(),
            out_words.shape[-1], indexes.data_ptr(), indexes.element_size(),
            symbols.data_ptr(), symbols.element_size(), active.data_ptr(),
            layout["blob"].data_ptr(), _encode_bytes(layout),
            layout["info_bytes"], layout["starts_bytes"], r0, r1 - r0, steps,
            lanes_total, torch.cuda.current_stream(state.device).cuda_stream)
    return state, wptr, out_words


def _encode_bytes(layout: dict) -> int:
    return layout["info_bytes"] + layout["starts_bytes"] + layout["rcp_bytes"]
