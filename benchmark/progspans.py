"""The program's own spans of a run's window (``rgba_tpu_torch/utils/
trace.py``), which the program records only while a profiler runs, so
only in a traced run.  Each ``RGBAFileCodec`` call is a root
(``container.encode_batch``, ``container.decode_batch``); the spans under a
root are its leaves: ``<kind>.fetch``, ``<kind>.upload`` and
``<kind>.rans``, which never overlap on one thread.  A root's own time is
its duration less its leaves'.  The readers under ``metrics/`` divide by
the window's calls (``run.calls``).
"""

from __future__ import annotations


def window(run):
    """(roots, leaves) of the spans whose root lies inside the window, from
    the first call's start to the last call's end: lists of (name,
    start_ns, end_ns, span_id, parent_id, request_id); the leaves are the
    roots' direct children.  None where the program recorded no such span:
    an untraced run, or a program without ``utils/trace.py``."""
    if not run.calls:
        return None
    try:
        from rgba_tpu_torch.utils import trace
    except ImportError:
        return None
    lo, hi = run.calls[0][1], run.calls[-1][2]
    recorded = trace.spans()
    roots = [s for s in recorded
             if s[4] is None and lo <= s[1] and s[2] <= hi]
    if not roots:
        return None
    ids = {s[3] for s in roots}
    return roots, [s for s in recorded if s[4] in ids]


def ms(spans) -> float:
    return sum(s[2] - s[1] for s in spans) / 1e6


def per_call_ms(run, suffixes: tuple):
    """Mean milliseconds a call spent in the leaves named ``*.<suffix>``."""
    found = window(run)
    if found is None:
        return None
    leaves = [s for s in found[1] if s[0].rsplit(".", 1)[-1] in suffixes]
    return ms(leaves) / len(run.calls)
