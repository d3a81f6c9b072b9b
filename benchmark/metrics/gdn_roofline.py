"""gdn_roofline: the bound of the window's launches of the gdn
kernel (the loop's ``kernel_bounds``: the larger of its operations over
the peak and its bytes over the memory rate, per call) over their device
time in the trace (every activity named ``gdn_*kernel``, in any
namespace), in %.  Nothing to read where the trace has no such launch or
the loop counts no bound for it."""

import re

NAME = re.compile(r"(^|[ :])gdn_\w*kernel\b")


def read(run):
    if run.trace is None or not hasattr(run.loop, "kernel_bounds"):
        return None
    bound = run.loop.kernel_bounds(run).get("gdn")
    t = sum(s for n, s in run.trace["by_name"].items() if NAME.search(n))
    if not bound or t <= 0:
        return None
    return 100.0 * bound * len(run.calls) / t
