"""gate_chain_roofline: the bound of the window's launches of the gate_chain
kernel (``work.forward_kernel_bounds``: the larger of its operations over
the bf16 peak and its bytes over the memory rate, per call) over their
device time in the trace (every activity named ``gate_chain_*kernel``, in
any namespace), in %.  Nothing to read where the trace has no such
launch."""

import re

NAME = re.compile(r"(^|[ :])gate_chain_\w*kernel\b")


def read(run):
    if run.trace is None or not hasattr(run.loop, "kernel_bounds"):
        return None
    t = sum(s for n, s in run.trace["by_name"].items()
            if NAME.search(n))
    if t <= 0:
        return None
    bound = run.loop.kernel_bounds(run)["gate_chain"] * len(run.calls)
    return 100.0 * bound / t
