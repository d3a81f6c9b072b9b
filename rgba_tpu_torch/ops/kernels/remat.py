"""Make the CUDA kernels trainable (port of
``rgba_tpu/ops/pallas/remat_vjp.py::fused_primal_xla_grad``).

The forward is the kernel; the backward is autograd over the plain
formulation, recomputed from the saved *inputs*.  Nothing intermediate is
kept between forward and backward, so the kernel's forward keeps its memory
profile and the backward costs one extra plain forward.  The returned
gradients are the exact gradients of the plain formulation at the same
inputs; the kernel's output differs from the plain one only by rounding
(held by the kernel checks), which a first-order optimizer cannot tell from
the rounding noise it already absorbs.

The JAX package has no backward kernel either: its training takes the
gradients of the XLA formulation in the same way.
"""

from __future__ import annotations

import torch


def needs_grad(tensors) -> bool:
    """Autograd is recording and one of ``tensors`` (None entries allowed)
    takes part in it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _flatten(args):
    """Tensors, None and one level of tuples of tensors -> (flat list,
    spec); ``_unflatten(flat, spec)`` gives the arguments back."""
    flat, spec = [], []
    for a in args:
        if isinstance(a, tuple):
            flat.extend(a)
            spec.append((type(a), len(a)))
        else:
            flat.append(a)
            spec.append(None)
    return flat, spec


def _unflatten(flat, spec):
    out, i = [], 0
    for s in spec:
        if s is None:
            out.append(flat[i])
            i += 1
        else:
            kind, n = s
            part = flat[i:i + n]
            out.append(kind(*part) if hasattr(kind, "_fields") else kind(part))
            i += n
    return out


class _FusedPrimalPlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fused_fn, plain_fn, spec, *flat):
        # autograd is off inside forward: the wrapper launches its kernel
        ctx.plain_fn, ctx.spec = plain_fn, spec
        ctx.save_for_backward(*flat)
        return fused_fn(*_unflatten(flat, spec))

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain_fn(*_unflatten(inputs, ctx.spec))
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g,
                                             allow_unused=True))
        return (None, None, None,
                *(next(grads) if n else None for n in needs))


def fused_primal_plain_grad(fused_fn, plain_fn, args):
    """``fused_fn(*args)`` with gradients from ``plain_fn(*args)``.

    args: the differentiable inputs, each a tensor, None, or a tuple of
    tensors (a ``GateChainWeights``).  Integer and gate operands (region
    ids, the alive gate) and static options are closed over by the
    callables.  Both callables map the same inputs to one tensor of one
    shape and dtype.  Without a gradient to record this is just
    ``fused_fn(*args)``.
    """
    flat, spec = _flatten(args)
    if not needs_grad(flat):
        return fused_fn(*args)
    return _FusedPrimalPlainGrad.apply(fused_fn, plain_fn, spec, *flat)
