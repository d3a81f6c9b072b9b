"""win_attn_roofline: the bound of the window's launches of the win_attn
kernel (the loop's ``kernel_bounds``: the larger of its operations over
the peak and its bytes over the memory rate, per call) over their device
time in the trace (every activity named ``win_attn_*kernel``, in any
namespace), in %.  Nothing to read where the trace has no such launch or
the loop counts no bound for it."""

import re

NAME = re.compile(r"(^|[ :])win_attn_\w*kernel\b")


def read(run):
    if run.trace is None or not hasattr(run.loop, "kernel_bounds"):
        return None
    bound = run.loop.kernel_bounds(run).get("win_attn")
    t = sum(s for n, s in run.trace["by_name"].items() if NAME.search(n))
    if not bound or t <= 0:
        return None
    return 100.0 * bound * len(run.calls) / t
