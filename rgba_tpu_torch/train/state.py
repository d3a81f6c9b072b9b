"""Optimizers and train state with the reference's semantics (port of
``rgba_tpu/train/state.py``).

* Adam(base_lr) with the piecewise-constant step decay of ``TrainConfig``;
* gradient VALUE clamp to [-5, 5] before Adam (a clamp, not a norm clip);
* the entropy bottleneck's ``quantiles`` are excluded from the main
  optimizer and trained by a separate aux Adam on ``aux_loss`` (the
  compressai convention; the reference's training never steps them: set
  ``aux_lr=0`` for strict parity).  The aux step runs after the main
  update, on the updated parameters.

``torch.optim.Adam`` with its defaults is optax's ``adam``: b1 0.9, b2
0.999, eps 1e-8 added outside the square root after bias correction, no
weight decay.  A step updates the module's parameters in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.config import TrainConfig


def is_quantiles(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "quantiles"


def lr_schedule_fn(cfg: TrainConfig) -> Callable[[int], float]:
    """The piecewise-constant schedule as a function of the step (the twin
    of the JAX package's jittable schedule; equals ``cfg.lr_at``)."""
    return cfg.lr_at


@dataclasses.dataclass
class CodecTrainState:
    """A codec, its two optimizers and the count of steps taken."""
    module: torch.nn.Module
    opt: torch.optim.Optimizer
    aux_opt: torch.optim.Optimizer
    step: int = 0


def make_optimizers(cfg: TrainConfig, module: torch.nn.Module):
    """(main Adam over everything but the quantiles, aux Adam over the
    quantiles)."""
    main = [p for n, p in module.named_parameters() if not is_quantiles(n)]
    aux = [p for n, p in module.named_parameters() if is_quantiles(n)]
    return (torch.optim.Adam(main, lr=cfg.lr_at(0)),
            torch.optim.Adam(aux, lr=cfg.aux_lr if cfg.aux_lr > 0 else 1e-3))


def make_train_state(cfg: TrainConfig, module: torch.nn.Module,
                     step: int = 0) -> CodecTrainState:
    opt, aux_opt = make_optimizers(cfg, module)
    return CodecTrainState(module, opt, aux_opt, step)


def make_train_step(cfg: TrainConfig, loss_fn,
                    aux_loss_fn: Optional[Callable]):
    """Build the train step.

    loss_fn(module, batch, generator) -> (rd_loss, metrics dict)
    aux_loss_fn(module) -> scalar (the bottleneck's quantile loss) or None

    step_fn(state, batch, generator, forward=None, grads=None) updates
    ``state`` in place and returns the metrics (tensors on the module's
    device, with ``rd_loss`` and, when the aux optimizer runs,
    ``aux_loss``).  ``forward`` is what the loss calls in place of
    ``state.module`` (its ``DistributedDataParallel`` wrapper, which
    all-reduces the gradients during the backward, before the clamp, as the
    JAX step's psum comes before it).  A dict passed as ``grads`` receives
    a copy of each parameter's gradient as the clamp finds it.
    """
    run_aux = aux_loss_fn is not None and cfg.aux_lr > 0
    schedule = lr_schedule_fn(cfg)

    def step_fn(state: CodecTrainState, batch, generator, forward=None,
                grads: Optional[dict] = None):
        main = [p for g in state.opt.param_groups for p in g["params"]]
        for g in state.opt.param_groups:
            g["lr"] = schedule(state.step)
        state.module.zero_grad(set_to_none=True)
        rd, metrics = loss_fn(forward or state.module, batch, generator)
        rd.backward()
        if grads is not None:
            grads.update({n: p.grad.detach().clone()
                          for n, p in state.module.named_parameters()
                          if p.grad is not None})
        torch.nn.utils.clip_grad_value_(main, cfg.grad_clip)
        state.opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}

        if run_aux:
            state.module.zero_grad(set_to_none=True)
            aux = aux_loss_fn(state.module)
            aux.backward()
            state.aux_opt.step()
            metrics["aux_loss"] = aux.detach()

        state.step += 1
        metrics["rd_loss"] = rd.detach()
        return metrics

    return step_fn
