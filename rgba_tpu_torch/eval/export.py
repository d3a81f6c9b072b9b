"""Serving artifacts with ``torch.export`` (port of ``rgba_tpu/eval/export.py``).

Export a serving forward once, ship the file, and run it in any process
with PyTorch: no model code, module tree or checkpoint loading at serve
time, and no drift between the program that was validated and the one
that serves.

  * The hand-written kernels are operators,
    ``torch.ops.rgba_tpu_torch.{win_attn, gdn, gate_chain, dse}``
    (``ops/kernels``), so an artifact of a kernel-routed model holds them:
    the counterpart of the JAX export's ``tpu_custom_call``.  A process that
    loads such an artifact imports ``rgba_tpu_torch.ops.kernels``, which
    registers them, and nothing else of the package.  ``allow_custom_ops=
    False`` refuses to export them (the JAX flag ``allow_tpu_custom_calls``).
  * The shapes are static: export one artifact per serving geometry (for
    example batch 16 at 512x768); another shape is refused at call time.
  * ``bundle_params=True`` keeps the weights in the artifact; with False
    the parameters are the first runtime argument (a dict name -> tensor,
    ``torch.func.functional_call``), so one program serves many weights.
  * An artifact records its policy's compute dtype: ``load_artifact``
    calls it under ``precision_scope`` (fp32 needs TF32 off at call time,
    and an artifact does not carry the process's flags).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Sequence

import torch
from torch import nn

KERNEL_NAMESPACE = "rgba_tpu_torch"
_DTYPE_FILE = "compute_dtype"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_KERNEL_FLAGS = ("fused_win_attn", "fused_gdn", "fused_gate_chain",
                 "fused_dse")


@dataclasses.dataclass
class Artifact:
    """An exported program and the compute dtype of the policy it ran."""
    program: torch.export.ExportedProgram
    compute_dtype: str = "float32"
    _module: Any = dataclasses.field(default=None, repr=False)

    def kernel_ops(self) -> list:
        """The names of the port's kernel operators the program calls."""
        return _kernel_ops(self.program)

    def __call__(self, *args):
        from ..core.precision import Policy, precision_scope
        policy = Policy(compute_dtype=_DTYPES[self.compute_dtype])
        if self._module is None:
            self._module = self.program.module()
        with torch.inference_mode(), precision_scope(policy):
            return self._module(*args)


def _kernel_ops(program) -> list:
    """Every graph of the program, nested ones too (a ``no_grad`` region
    is a subgraph of its own)."""
    return sorted({str(n.target) for gm in program.graph_module.modules()
                   if isinstance(gm, torch.fx.GraphModule)
                   for n in gm.graph.nodes if n.op == "call_function"
                   and str(n.target).startswith(KERNEL_NAMESPACE + ".")})


class _Callable(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_function(fn: Callable, example_args: Sequence[Any],
                    allow_custom_ops: bool = True,
                    compute_dtype: str = "float32") -> Artifact:
    """Export ``fn(*example_args)`` (an ``nn.Module`` or a function of
    tensors) at the example's shapes, traced without autograd (a serving
    program; ``Artifact`` calls it in inference mode).
    ``allow_custom_ops=False`` raises ``ValueError`` naming the kernel
    operators the program would call."""
    mod = fn if isinstance(fn, nn.Module) else _Callable(fn)
    with torch.no_grad():
        program = torch.export.export(mod, tuple(example_args))
    # the program would keep the example (for an unbundled artifact, a
    # copy of every weight) and save it with itself
    program.example_inputs = None
    ops = _kernel_ops(program)
    if ops and not allow_custom_ops:
        raise ValueError(f"the program calls the kernel operators {ops}; "
                         f"pass allow_custom_ops=True to export them")
    return Artifact(program, compute_dtype)


class _Serving(nn.Module):
    """``model(*batch)`` (``training=False`` for the codecs, which take
    it); with ``params`` first when they are a runtime argument.  The model
    is held outside the module's state, so an unbundled artifact carries no
    weights."""

    def __init__(self, model, bundle_params: bool):
        super().__init__()
        if bundle_params:
            self.model = model
        else:
            self.__dict__["_model"] = model
        self.bundle_params = bundle_params
        self.kw = ({"training": False} if "training" in
                   inspect.signature(model.forward).parameters else {})

    def forward(self, *args):
        if self.bundle_params:
            return self.model(*args, **self.kw)
        params, batch = args[0], args[1:]
        return torch.func.functional_call(self._model, params, batch,
                                          self.kw)


def _kernel_routes(model) -> list:
    """The kernel flags that are on in any policy of ``model``'s modules."""
    flags = set()
    for m in model.modules():
        policy = getattr(m, "policy", None)
        flags.update(f for f in _KERNEL_FLAGS if getattr(policy, f, False))
    return sorted(flags)


def export_serving_forward(model, example_batch, bundle_params: bool = True,
                           allow_custom_ops: bool = True) -> Artifact:
    """Export a serving forward ``model(*example_batch)`` of
    ``RGBAPipeline`` (NHWC masked input and alpha), ``RGBCodec`` or
    ``MaskCodec`` (NCHW, ``training=False``), on the example's device and
    shapes.  ``bundle_params=False`` makes the parameters the first runtime
    argument: call the artifact with ``(dict(model.named_parameters()),
    *batch)``.  ``allow_custom_ops=False`` refuses a model whose policy
    routes through a kernel, naming the flags."""
    routes = _kernel_routes(model)
    if routes and not allow_custom_ops:
        raise ValueError(f"the model's policy routes through the kernels "
                         f"{routes}; pass allow_custom_ops=True to export "
                         f"their operators")
    args = tuple(example_batch)
    if not bundle_params:
        args = (dict(model.named_parameters()),) + args
    dtype = str(model.policy.compute_dtype).removeprefix("torch.")
    return export_function(_Serving(model, bundle_params), args,
                           allow_custom_ops=allow_custom_ops,
                           compute_dtype=dtype)


def save_artifact(artifact: Artifact, path: str) -> int:
    """Write ``artifact`` to ``path`` (``torch.export.save``, the compute
    dtype in its extra files); returns the byte size."""
    import os
    torch.export.save(artifact.program, path,
                      extra_files={_DTYPE_FILE: artifact.compute_dtype})
    return os.path.getsize(path)


def load_artifact(path: str) -> Artifact:
    """Read an artifact; call it with the exported arguments.  Registers
    the kernel operators first (``rgba_tpu_torch.ops.kernels``)."""
    from ..ops import kernels  # noqa: F401  (registers the operators)
    extra = {_DTYPE_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return Artifact(program, extra[_DTYPE_FILE] or "float32")
