"""codec_mfu, for every cell (``.bulk``, ``.request``, ...): the model's
operations in the window's encodes and decodes (``work.codec_flops``,
counted from the shapes and the live windows) over the window's seconds,
as a share of the H100's dense TF32 peak (495 TFLOP/s): the highest rate
an fp32-input product runs at."""

import work


def read(run):
    if not run.calls:
        return None
    flops = run.loop.flops(run, [c[0] for c in run.calls])
    return 100.0 * flops / run.window_s / work.PEAK_TF32
