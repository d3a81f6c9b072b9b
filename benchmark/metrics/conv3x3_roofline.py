"""conv3x3_roofline: the bound of the window's 3x3 stride-1 convolutions
of the TCM codec (``conv3x3_work.bound_s``: each launch's larger of its
operations over the TF32 peak and its bytes over the memory rate, per
call) over the device time of the launches named ``conv3x3_*kernel`` in
the trace (in any namespace), in %.  Nothing to read for a loop other
than ``codec_tcm``, or where the trace has no such launch."""

import re

NAME = re.compile(r"(^|[ :])conv3x3_\w*kernel\b")


def read(run):
    if run.trace is None or run.traffic.get("loop") != "codec_tcm":
        return None
    t = sum(s for n, s in run.trace["by_name"].items() if NAME.search(n))
    if t <= 0:
        return None
    import conv3x3_work
    tr = run.traffic
    bound = conv3x3_work.bound_s(run.config["model"], tr["batch"],
                                 tr["height"], tr["width"])
    return 100.0 * bound * len(run.calls) / t
