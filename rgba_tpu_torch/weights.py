"""Carry JAX (flax) parameter trees into the port's modules.

The port's state-dict keys are the reference's torch keys, so this is the
inverse of ``rgba_tpu/train/torch_import.py``: each flax path maps to its
torch key, and the layout goes back to torch's:

  * Conv kernel   HWIO -> (O, I, kh, kw)   transpose(3, 2, 0, 1)
  * Deconv kernel HWIO -> (I, O, kh, kw)   transpose(2, 3, 0, 1)
    (the JAX module flips the kernel at call time; torch's transposed
    conv does the same, so no flip here)
  * Linear kernel (I, O) -> (O, I)
  * GDN beta/gamma, biases, entropy-bottleneck parameters: verbatim.

Buffers (relative-position index, masks) are rebuilt by the modules, not
loaded.  This module keeps its own copy of the mapping: the port imports
nothing from ``rgba_tpu``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

CONV, DECONV, LINEAR, RAW = "conv", "deconv", "linear", "raw"


def _leaf(leaf: str) -> str:
    return "weight" if leaf == "kernel" else "bias"


def _win_gate_map(rest: str):
    m = re.fullmatch(r"conv_([ab])(\d)/conv(\d)/(kernel|bias)", rest)
    if m:
        ab, i, j, leaf = m.groups()
        return f"conv_{ab}.{i}.conv.{int(j) * 2}.{_leaf(leaf)}", CONV
    m = re.fullmatch(r"conv_b3/(kernel|bias)", rest)
    if m:
        return f"conv_b.3.{_leaf(m.group(1))}", CONV
    if rest == "attn/attn/relative_position_bias_table":
        return "attn.attn.relative_position_bias_table", RAW
    m = re.fullmatch(r"attn/attn/(qkv|proj)_(kernel|bias)", rest)
    if m:
        which, leaf = m.groups()
        return (f"attn.attn.{which}.{_leaf(leaf)}",
                LINEAR if leaf == "kernel" else RAW)
    raise KeyError(rest)


def _simp_attn_map(rest: str):
    m = re.fullmatch(r"((?:trunk|attention)_ResBlock\d)/conv(\d)/(kernel|bias)",
                     rest)
    if m:
        block, j, leaf = m.groups()
        return f"{block}.conv{j}.{_leaf(leaf)}", CONV
    m = re.fullmatch(r"conv1/(kernel|bias)", rest)
    if m:
        return f"conv1.{_leaf(m.group(1))}", CONV
    raise KeyError(rest)


def _dse_map(rest: str):
    m = re.fullmatch(r"(input_conv|output_conv)/(kernel|bias)", rest)
    if m:
        return f"{m.group(1)}.{_leaf(m.group(2))}", CONV
    m = re.fullmatch(r"enh(\d)/conv(\d)/(kernel|bias)", rest)
    if m:
        i, j, leaf = m.groups()
        return f"enh{i}.conv{j}.{_leaf(leaf)}", CONV
    raise KeyError(rest)


_HYPER_SYN = {"up0": "0.0", "conv1": "2", "up2": "4.0", "conv3": "6",
              "up4": "8.0"}


def _prior_map(rest: str):
    m = re.fullmatch(r"h_a/conv(\d)/(kernel|bias)", rest)
    if m:
        return f"h_a.{int(m.group(1)) * 2}.{_leaf(m.group(2))}", CONV
    m = re.fullmatch(r"(h_mean_s|h_scale_s)/(up0|conv1|up2|conv3|up4)"
                     r"(?:/conv)?/(kernel|bias)", rest)
    if m:
        which, stage, leaf = m.groups()
        return f"{which}.{_HYPER_SYN[stage]}.{_leaf(leaf)}", CONV
    m = re.fullmatch(r"(cc_mean_transforms|cc_scale_transforms|lrp_transforms)"
                     r"_(\d+)/conv(\d)/(kernel|bias)", rest)
    if m:
        which, i, j, leaf = m.groups()
        return f"{which}.{i}.{int(j) * 2}.{_leaf(leaf)}", CONV
    m = re.fullmatch(r"entropy_bottleneck/(matrix|bias|factor)(\d)", rest)
    if m:
        return f"entropy_bottleneck._{m.group(1)}{m.group(2)}", RAW
    if rest == "entropy_bottleneck/quantiles":
        return "entropy_bottleneck.quantiles", RAW
    raise KeyError(rest)


def path_to_key_rgb(path: str):
    """'encoder/x1/kernel'-style flax path of RGBCodec -> (torch key, kind)."""
    top, _, rest = path.partition("/")
    if top in ("encoder", "decoder"):
        prefix = "Encoder" if top == "encoder" else "Decoder"
        m = re.fullmatch(r"x(\d)/(kernel|bias)", rest)
        if m:
            k = int(m.group(1))
            kind = CONV if top == "encoder" or k == 1 else DECONV
            return f"{prefix}.x{k}.{_leaf(m.group(2))}", kind
        m = re.fullmatch(r"(i?gdn\d)/(beta|gamma)", rest)
        if m:
            return f"{prefix}.{m.group(1)}.{m.group(2)}", RAW
        m = re.fullmatch(r"attention(\d)/(.*)", rest)
        if m:
            sub, kind = _win_gate_map(m.group(2))
            return f"{prefix}.attention{m.group(1)}.{sub}", kind
        m = re.fullmatch(r"dse/(.*)", rest)
        if m and top == "decoder":
            sub, kind = _dse_map(m.group(1))
            return f"Decoder.dse.{sub}", kind
    if top == "prior":
        return _prior_map(rest)
    raise KeyError(path)


def path_to_key_mask(path: str):
    """Flax path of MaskCodec -> (torch key, kind); the sequential index
    is the number in the flax layer name (conv0, gdn1, ..., dse9)."""
    top, _, rest = path.partition("/")
    if top in ("encoder", "decoder"):
        prefix = "EncoderMask" if top == "encoder" else "DecoderMask"
        m = re.fullmatch(r"(conv|deconv)(\d)/(kernel|bias)", rest)
        if m:
            kind = CONV if m.group(1) == "conv" else DECONV
            return f"{prefix}.{m.group(2)}.{_leaf(m.group(3))}", kind
        m = re.fullmatch(r"i?gdn(\d)/(beta|gamma)", rest)
        if m:
            return f"{prefix}.{m.group(1)}.{m.group(2)}", RAW
        m = re.fullmatch(r"attn(\d)/(.*)", rest)
        if m:
            sub, kind = _simp_attn_map(m.group(2))
            return f"{prefix}.{m.group(1)}.{sub}", kind
        m = re.fullmatch(r"dse(\d)/(.*)", rest)
        if m:
            sub, kind = _dse_map(m.group(2))
            return f"{prefix}.{m.group(1)}.{sub}", kind
    if top == "prior":
        return _prior_map(rest)
    raise KeyError(path)


def _to_torch_layout(value: np.ndarray, kind: str, is_kernel: bool):
    if not is_kernel or kind == RAW:
        return value
    if kind == CONV:
        return value.transpose(3, 2, 0, 1)
    if kind == DECONV:
        return value.transpose(2, 3, 0, 1)
    return value.transpose(1, 0)          # LINEAR


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


_MAPPERS = {"rgb": path_to_key_rgb, "mask": path_to_key_mask}


def state_dict_from_jax(tree, kind: str) -> dict:
    """Flax param tree (nested dicts of arrays) -> the port's state dict
    (torch key -> fp32 CPU tensor).  kind: 'rgb' (RGBCodec), 'mask'
    (MaskCodec) or 'pipeline' (RGBAPipeline: {'mask_codec', 'rgb_codec'})."""
    if kind == "pipeline":
        sd = {}
        for sub, sub_kind in (("mask_codec", "mask"), ("rgb_codec", "rgb")):
            for k, v in state_dict_from_jax(tree[sub], sub_kind).items():
                sd[f"{sub}.{k}"] = v
        return sd
    mapper = _MAPPERS[kind]
    sd = {}
    for path, value in _flat(tree):
        key, tkind = mapper(path)
        if key in sd:
            raise KeyError(f"{path} maps to {key} twice")
        if torch.is_tensor(value):        # a bfloat16 leaf (flax_msgpack)
            value = value.float().numpy()
        arr = np.asarray(value, dtype=np.float32)
        arr = _to_torch_layout(arr, tkind, path.endswith("kernel"))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_jax_params(module: torch.nn.Module, tree, kind: str) -> None:
    """Load a flax param tree into ``module`` with ``strict=True``."""
    module.load_state_dict(state_dict_from_jax(tree, kind), strict=True)
