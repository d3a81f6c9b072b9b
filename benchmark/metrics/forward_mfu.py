"""forward_mfu: the model's operations in the window's forwards
(``work.forward_flops``, counted from the shapes and the live windows)
over the window's seconds, as a share of the H100's dense bf16 peak
(989 TFLOP/s)."""

import work


def read(run):
    if not run.calls:
        return None
    flops = run.loop.flops(run, [c[0] for c in run.calls])
    return 100.0 * flops / run.window_s / work.PEAK_BF16
