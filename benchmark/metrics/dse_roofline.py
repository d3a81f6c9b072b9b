"""dse_roofline: the bound of the window's launches of the dse
kernel (``work.forward_kernel_bounds``: the larger of its operations over
the bf16 peak and its bytes over the memory rate, per call) over their
device time in the trace (every activity named ``dse_*kernel``, in
any namespace), in %.  Nothing to read where the trace has no such
launch."""

import re

NAME = re.compile(r"(^|[ :])dse_\w*kernel\b")


def read(run):
    if run.trace is None or not hasattr(run.loop, "kernel_bounds"):
        return None
    t = sum(s for n, s in run.trace["by_name"].items()
            if NAME.search(n))
    if t <= 0:
        return None
    bound = run.loop.kernel_bounds(run)["dse"] * len(run.calls)
    return 100.0 * bound / t
