"""Kernel weight layouts kept on the module that owns the weights."""

from __future__ import annotations

import torch


def param_key(params) -> tuple:
    """Storage and version of each parameter: a cache built from them holds
    until one is written or moved (inference tensors keep no version, so
    only a move counts for them)."""
    return tuple((p.data_ptr(), -1 if p.is_inference() else p._version)
                 for p in params)


def cached_layout(module, params, dtype, build):
    """``build()``, a kernel's layout of ``params`` for ``dtype``, kept on
    ``module._kernel_cache`` until a parameter is written or moved
    (``param_key``).  While the forward is traced (``torch.export``) the
    layout is computed from the parameters in the graph and not cached:
    the traced parameters have no storage, and a layout captured from the
    eager weights would go stale in the artifact.  A layout built while
    this thread captures a CUDA graph (a codec step whose first, eager
    call ran on another worker but had not yet kept its layout) is not
    kept either: a captured kernel runs only at replay, so it is memory of
    the graph's pool that the graph fills when it replays, and that a
    capture which fails never fills."""
    if torch.compiler.is_compiling():
        with torch.no_grad():
            return build()
    key = (dtype, *param_key(params))
    cached = module._kernel_cache    # one read: another thread may fill it
    if cached[0] != key:
        with torch.no_grad():
            layout = build()
        if params[0].is_cuda and torch.cuda.is_current_stream_capturing():
            return layout
        cached = (key, layout)
        module._kernel_cache = cached
    return cached[1]
