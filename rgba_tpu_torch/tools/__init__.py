"""The trained-weight workflow (twins of the JAX package's ``tools/``
files of the same names): the training, resume and RD-sweep proofs and
the probes that load their checkpoints.  Each runs as ``python -m
rgba_tpu_torch.tools.<name>``, on ``cuda`` unless ``--device cpu`` is
given, and writes under ``--outdir``."""
