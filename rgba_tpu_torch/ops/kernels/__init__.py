"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each module pairs a wrapper (CUDA tensors: launch the kernel or raise) with
the plain version of the same function (CPU tensors, and the reference the
kernel is held against on the card).
"""
