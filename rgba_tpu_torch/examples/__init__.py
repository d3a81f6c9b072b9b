"""Runnable examples (``python -m rgba_tpu_torch.examples.<name>``)."""
