"""The program's spans: host work between two boundaries, recorded only
while a profiler runs.

``span(name)`` marks a stretch of host work.  Without a ``torch.profiler``
running it costs one check of the profiler's flag and returns a shared
null context: no clock is read, nothing is allocated.  While a profiler
runs it opens ``torch.profiler.record_function(name)``, so the span shows
in any exported timeline beside the kernels, and appends
``(name, start_ns, end_ns, span_id, parent_id, request_id)`` to an
in-memory ring of the newest ``MAX_SPANS`` spans, which ``spans()`` reads.

Both stamps are ``time.time_ns()``, the clock of the profiler's device
events (kineto's timestamps are wall-clock nanoseconds), so a span lines
up with the device activity recorded while it was open.  Parent and
request come from a stack per thread: a span opened with none open on its
thread is a root, its id the request id of every span under it.  A span
must close on the thread and in the frame that opened it; the codec's
decode chains are generators driven in turn on one thread, so no span is
held open across their ``yield``.

The codec's spans (``eval/container.py``, ``eval/codec_io.py``; ``kind``
is ``rgb``, ``mask`` or ``container``):

  * ``container.encode_batch``, ``container.decode_batch``: the roots, one
    per call;
  * ``<kind>.fetch``: each place the host waits for device tensors to
    reach it (one span where it fetches several in a row);
  * ``<kind>.upload``: each copy of host arrays to the device (a
    synchronous copy: the host also waits for the work queued before it);
  * ``<kind>.rans``: each call into the host rANS coder
    (``native/rans.py``), around the thread pool's whole fan-out, on the
    calling thread; the pool's workers open no span.

``trace(log_dir)`` captures a Chrome trace of a block, host and device, in
which these spans and the kernels share one timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 17     # ~50 a single-image round trip: minutes of requests

_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "start", "id", "parent", "request", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.id = next(_IDS)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self.start = time.time_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        end = time.time_ns()
        _LOCAL.stack.pop()
        _SPANS.append((self.name, self.start, end, self.id, self.parent,
                       self.request))
        return False


def span(name: str):
    """A context manager around host work named ``name``: recorded while a
    profiler runs, a shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans() -> list:
    """The recorded spans, oldest first, as (name, start_ns, end_ns,
    span_id, parent_id, request_id); parent_id is None for a root.  The
    record is not drained."""
    return list(_SPANS)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and device activity) of the
    block into ``log_dir/trace.json`` (Chrome trace format); yields the
    profiler, whose ``key_averages()`` sums device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
