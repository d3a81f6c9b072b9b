"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each module pairs a wrapper (CUDA tensors: launch the kernel or raise) with
the plain version of the same function (CPU tensors, and the reference the
kernel is held against on the card).  The four conv-path kernels launch
through operators, ``torch.ops.rgba_tpu_torch.{win_attn, gdn, gate_chain,
dse}``, which importing this package registers: that is all a process
needs to load and run a ``torch.export`` artifact that holds them.
"""

from . import dse, gate_chain, gdn, win_attn  # noqa: F401  (register the ops)
