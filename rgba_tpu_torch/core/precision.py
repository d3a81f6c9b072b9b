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
casts (``cast_in``): no autocast, no gradient scaling.  The JAX flag ``int8_conv`` has no port yet, so the
policy has no such field.  ``packed_dse`` is a TPU lane layout of the same
math and computes the plain DSE here; as in the JAX package it wins over
``fused_dse`` when the batch divides by 4, so a policy that wants the DSE
kernel sets ``packed_dse=False``.  Parameters are always fp32 and the
entropy math always runs in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses

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


@contextlib.contextmanager
def precision_scope(policy: Policy):
    """TF32 off for fp32 policies (the twin of the JAX HIGHEST pin); the
    previous flags come back on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if policy.exact:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


_BATCH_INVARIANT = [0]      # open batch_invariant_scope()s, any thread


@contextlib.contextmanager
def batch_invariant_scope():
    """Inside it an image's result must not depend on the batch it runs in:
    the codec's encoder and decoder recompute the CDF indexes apart, and a
    blob must decode the same alone or in any batch.  cuDNN (and oneDNN on
    the CPU) picks a convolution's algorithm by the batch size, and two
    algorithms sum in different orders, so the convolutions
    (``ops.conv.per_image``) then run each image on its own."""
    _BATCH_INVARIANT[0] += 1
    try:
        yield
    finally:
        _BATCH_INVARIANT[0] -= 1


def batch_invariant() -> bool:
    return _BATCH_INVARIANT[0] > 0


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)
# serving: bf16 + the fused window-attention kernel
SERVE_POLICY = Policy(compute_dtype=torch.bfloat16, fused_win_attn=True,
                      packed_dse=True)


def policy_from_str(name: str) -> Policy:
    if name in ("bfloat16", "bf16"):
        return BF16_POLICY
    if name in ("float32", "fp32"):
        return DEFAULT_POLICY
    if name in ("serve", "serving"):
        return SERVE_POLICY
    raise ValueError(f"unknown compute dtype: {name}")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never falls back
    to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
