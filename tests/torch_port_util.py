"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Weights go from a port module to the JAX module it replaces through the
JAX package's own importer layout (rgba_tpu/train/torch_import.py), so a
parity test also checks that the port's parameter names and layouts are
the reference's.  Data moves between the frameworks as numpy arrays.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from rgba_tpu.train.torch_import import CONV, DECONV, LINEAR, RAW, _transform

KEY = jax.random.PRNGKey(0)


def flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def torch_sd(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def jax_params_from_torch(module, template, mapper):
    """Param tree shaped like ``template`` holding ``module``'s weights;
    mapper(flax path) -> (torch key, kind) as in torch_import."""
    sd = torch_sd(module)

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        key, kind = mapper(prefix)
        out = _transform(np.asarray(sd[key], np.float32), kind,
                         prefix.endswith("kernel"))
        assert out.shape == tuple(np.shape(node)), (prefix, out.shape)
        return out

    return walk(template)


def leaf_mapper(table):
    """Mapper for small modules: {flax path: (torch key, kind)}."""
    return lambda path: table[path]


def conv_mapper(prefix_torch="", kind=CONV):
    def mapper(path):
        leaf = path.rsplit("/", 1)[-1]
        return f"{prefix_torch}{'weight' if leaf == 'kernel' else 'bias'}", kind
    return mapper


def window_attention_mapper(prefix_flax="", prefix_torch=""):
    table = {
        "relative_position_bias_table": ("relative_position_bias_table", RAW),
        "qkv_kernel": ("qkv.weight", LINEAR), "qkv_bias": ("qkv.bias", RAW),
        "proj_kernel": ("proj.weight", LINEAR), "proj_bias": ("proj.bias", RAW),
    }

    def mapper(path):
        key, kind = table[path[len(prefix_flax):]]
        return prefix_torch + key, kind
    return mapper


def nhwc(t):
    """Port NCHW tensor -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def nchw(a):
    """NHWC numpy -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


__all__ = ["CONV", "DECONV", "LINEAR", "RAW", "KEY", "flat_paths",
           "torch_sd", "jax_params_from_torch", "leaf_mapper", "conv_mapper",
           "window_attention_mapper", "nhwc", "nchw", "close"]
