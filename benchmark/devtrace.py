"""Reading the device trace of a window: ``torch.profiler`` with CUDA
activity only (kernels, copies and sets, from CUPTI), so the host's
operators are not recorded and cost nothing.  The benchmark's own host
spans (``Run.spans``, on the wall clock as the trace is) say what the host
was doing in each gap of the device.
"""

from __future__ import annotations

import collections


def profiler(cuda: bool = True):
    """The window's profiler: CUDA activity only (the CPU's where there is
    no card, which records no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every device activity of the trace."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        if e.duration_ns() <= 0:
            continue
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def union_ns(events, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which some device activity ran."""
    busy, end = 0, lo
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def gaps(events, lo: int, hi: int) -> list:
    """(start_ns, end_ns) of each interval of [lo, hi] with no device
    activity."""
    out, end = [], lo
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(events, spans, lo: int, hi: int, top: int = 10) -> dict:
    """The window's busy and window seconds, device seconds by name (the
    ``top`` longest), and the idle seconds by the host span in which each
    idle stretch began ("between calls" outside every span)."""
    by_name = collections.Counter()
    for name, s, e in events:
        by_name[name] += (min(e, hi) - max(s, lo)) / 1e9
    idle = collections.Counter()
    ordered = sorted(spans, key=lambda sp: sp[1])
    k = 0
    for a, b in gaps(events, lo, hi):
        while k < len(ordered) and ordered[k][2] <= a:
            k += 1
        inside = [n for n, s, e in ordered[k:k + 2] if s <= a < e]
        idle[inside[0] if inside else "between calls"] += (b - a) / 1e9
    return {"busy_s": union_ns(events, lo, hi) / 1e9,
            "window_s": (hi - lo) / 1e9,
            "by_name": dict(by_name),
            "device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}
