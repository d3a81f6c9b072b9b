"""Dtype and kernel-routing policy: fp32 parameters, optional bf16 activations.

Port of ``rgba_tpu/core/precision.py``.  The JAX policy pins
``Precision.HIGHEST`` for fp32 parity because TPU dots default to bf16
passes; the CUDA twin is TF32, which cuDNN convolutions use by default.
``precision_scope`` turns TF32 off for fp32 policies while a forward runs.

Routing flags name the hand-written CUDA kernels of ``ops/kernels``:
``fused_win_attn``, ``fused_gdn``, ``fused_gate_chain`` and ``fused_dse``.
They serve and train: under autograd a routed op runs its kernel in the
forward and takes its gradients from the plain formulation
(``ops/kernels/remat.py``).  Training keeps fp32 parameters and explicit
casts (``cast_in``): no autocast, no gradient scaling.  ``int8_conv``
(serving only, as in the JAX package) runs every ``Conv``,
``ConvTranspose`` and plain gate-chain and DSE convolution as the dynamic
W8A8 convolution of ``ops/quant.py``; it has no gradient, and no training
or parity policy sets it.  ``packed_dse`` is a TPU lane layout of the same
math and computes the plain DSE here; as in the JAX package it wins over
``fused_dse`` when the batch divides by 4, so a policy that wants the DSE
kernel sets ``packed_dse=False``.  Parameters are always fp32 and the
entropy math always runs in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32
    # kernel routing (ops/kernels), in serving and in training
    fused_win_attn: bool = False
    fused_gdn: bool = False
    fused_gate_chain: bool = False
    fused_dse: bool = False
    packed_dse: bool = False
    # serving only: dynamic W8A8 convolutions (ops/quant.py); round has no
    # gradient, so never set in training
    int8_conv: bool = False

    @property
    def exact(self) -> bool:
        return self.compute_dtype == torch.float32

    @property
    def gelu_kind(self) -> str:
        """The GELU flavour as the conv-chain kernel names it."""
        return "gelu_erf" if self.exact else "gelu_tanh"

    def cast_in(self, x):
        return x.to(self.compute_dtype)

    def gelu(self, x):
        """Exact erf GELU in fp32, tanh approximation in bf16."""
        return F.gelu(x, approximate="none" if self.exact else "tanh")


# The flags below are process-wide, while scopes open and close on any
# thread (PipelinedCodec runs whole encodes and decodes on two workers).
# Each scope kind is counted under one lock: the first scope to open saves
# the flags and sets them, later ones only count, and the last to close
# restores them, so no thread closes the flags another still runs under.
_LOCK = threading.Lock()
_OPEN = {"tf32_off": 0, "deterministic": 0, "batch_invariant": 0}
_SAVED: dict = {}


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_tf32_flags(flags):
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _cudnn_flags():
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


def _set_cudnn_flags(flags):
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


_FLAGS = {"tf32_off": (_tf32_flags, _set_tf32_flags, (False, False)),
          "deterministic": (_cudnn_flags, _set_cudnn_flags, (True, False))}


@contextlib.contextmanager
def _counted(kind: str):
    """One scope of ``kind``, counted across threads (see above)."""
    flags = _FLAGS.get(kind)
    with _LOCK:
        if _OPEN[kind] == 0 and flags is not None:
            _SAVED[kind] = flags[0]()
            flags[1](flags[2])
        _OPEN[kind] += 1
    try:
        yield
    finally:
        with _LOCK:
            _OPEN[kind] -= 1
            if _OPEN[kind] == 0 and flags is not None:
                flags[1](_SAVED.pop(kind))


def precision_scope(policy: Policy):
    """TF32 off for fp32 policies (the twin of the JAX HIGHEST pin) while
    any such scope is open, on any thread; the flags come back when the
    last one closes.  A bf16 policy changes nothing."""
    return _counted("tf32_off") if policy.exact else contextlib.nullcontext()


def deterministic_scope():
    """Deterministic cuDNN algorithms without autotuning while any such
    scope is open, on any thread (the codec's encoder and decoder must
    compute the same indexes)."""
    return _counted("deterministic")


def batch_invariant_scope():
    """Inside it an image's result must not depend on the batch it runs in:
    the codec's encoder and decoder recompute the CDF indexes apart, and a
    blob must decode the same alone or in any batch.  cuDNN (and oneDNN on
    the CPU) picks a convolution's algorithm by the batch size, and two
    algorithms sum in different orders, so the convolutions
    (``ops.conv.per_image``) then run each image on its own, on every
    thread while any such scope is open."""
    return _counted("batch_invariant")


def batch_invariant() -> bool:
    return _OPEN["batch_invariant"] > 0


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)
# serving: bf16 + the fused window-attention kernel
SERVE_POLICY = Policy(compute_dtype=torch.bfloat16, fused_win_attn=True,
                      packed_dse=True)
# int8 serving: SERVE_POLICY with dynamic W8A8 convolutions
SERVE_INT8_POLICY = dataclasses.replace(SERVE_POLICY, int8_conv=True)


def policy_from_str(name: str) -> Policy:
    if name in ("bfloat16", "bf16"):
        return BF16_POLICY
    if name in ("float32", "fp32"):
        return DEFAULT_POLICY
    if name in ("serve", "serving"):
        return SERVE_POLICY
    if name in ("serve-int8", "int8"):
        return SERVE_INT8_POLICY
    raise ValueError(f"unknown compute dtype: {name}")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never falls back
    to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
