"""PyTorch + CUDA port of the RGBA learned image codec for one NVIDIA H100.

Layout mirrors the JAX package ``rgba_tpu`` module by module (``core/``,
``ops/``, ``ops/kernels/`` + ``csrc/``, ``entropy/``, ``models/``,
``data/``) so each port can be read next to the module it replaces.  This
package imports torch and numpy only; it never imports JAX or ``rgba_tpu``.

Entry point of the serving path: ``rgba_tpu_torch.models.pipeline.RGBAPipeline``.
Modules run on ``cuda`` unless the caller passes ``device="cpu"``; without
CUDA and without an explicit ``"cpu"`` they raise.
"""
