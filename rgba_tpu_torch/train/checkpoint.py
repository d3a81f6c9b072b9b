"""Step-named checkpoints with the reference's resume semantics (port of
``rgba_tpu/train/checkpoint.py``).

* files: ``<dir>/iter_<N>.ckpt``, a ``torch.save`` of the module's state
  dict (the reference's names are ``iter_<N>.pth.tar``);
* the step is recovered by parsing the filename;
* rotating snapshots: keep only the latest until ``keep_after``, then keep
  everything;
* loads are partial-tolerant: only keys present on both sides with the
  same shape are restored;
* reference torch checkpoints (``.pth.tar``/``.pth``/``.pt``) load through
  the same call: the port's state-dict keys are the reference's;
* so do the JAX package's ``iter_<N>.ckpt`` files, flax msgpack of the
  parameter tree under the same name: ``load_checkpoint`` tells the two
  formats apart by their first bytes, decodes the msgpack without flax
  (``flax_msgpack.py``) and maps the tree through
  ``weights.state_dict_from_jax``.  The port writes ``torch.save`` only.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..weights import state_dict_from_jax
from . import flax_msgpack


def save_checkpoint(state_dict: dict, directory: str, step: int,
                    prefix: str = "iter_") -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}{step}.ckpt")
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def save_rotating(state_dict: dict, directory: str, step: int, interval: int,
                  keep_after: int, prefix: str = "iter_") -> str:
    """Rotating snapshot: delete the previous one unless past keep_after."""
    path = save_checkpoint(state_dict, directory, step, prefix)
    if step <= keep_after:
        prev = os.path.join(directory, f"{prefix}{step - interval}.ckpt")
        if os.path.isfile(prev):
            os.remove(prev)
    return path


TORCH_SUFFIXES = (".pth.tar", ".pth", ".pt")


def jax_kind(module: torch.nn.Module) -> str:
    """The ``weights.state_dict_from_jax`` kind of a JAX tree for
    ``module``: "mask", "rgb" or "pipeline"."""
    from ..models.mask_codec import MaskCodec
    from ..models.pipeline import RGBAPipeline
    from ..models.rgb_codec import RGBCodec
    for cls, kind in ((MaskCodec, "mask"), (RGBCodec, "rgb"),
                      (RGBAPipeline, "pipeline")):
        if isinstance(module, cls):
            return kind
    raise TypeError(f"no JAX parameter tree maps onto a "
                    f"{type(module).__name__}")


def read_state_dict(module: torch.nn.Module, path: str) -> dict:
    """The state dict a checkpoint file holds, keyed as ``module``'s: a
    ``torch.save`` file (the port's, or a reference ``.pth.tar`` whose
    weights may sit under ``"state_dict"`` with DataParallel's
    ``module.`` prefix) or the JAX package's flax msgpack."""
    with open(path, "rb") as f:
        head = f.read(4)
    if flax_msgpack.is_msgpack_map(head, os.path.getsize(path)):
        with open(path, "rb") as f:
            tree = flax_msgpack.restore(f.read())
        return state_dict_from_jax(tree, jax_kind(module))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if path.endswith(TORCH_SUFFIXES):
        if isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return sd


def load_checkpoint(module: torch.nn.Module, path: str) -> list:
    """Restore ``module`` from ``path`` (any format ``read_state_dict``
    reads) and return the module's keys that the file did not supply
    (missing, or of another shape)."""
    sd = read_state_dict(module, path)
    own = module.state_dict()
    usable = {k: v for k, v in sd.items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
    module.load_state_dict(usable, strict=False)
    return sorted(set(own) - set(usable))


def step_from_path(path: str) -> int:
    """iter_<N> filename parse; 0 if absent."""
    m = re.search(r"iter_(\d+)\.", os.path.basename(path))
    return int(m.group(1)) if m else 0


def latest_checkpoint(directory: str, prefix: str = "iter_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = re.match(rf"{re.escape(prefix)}(\d+)\.ckpt$", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best
