"""CUDA graphs of the codec's device steps (``CodecIO``).

A device step is the device work between two host touches: an encode
pass, a decode chain's first step, one serial slice step, the tail step,
the synthesis transform.  Dispatched from Python, one step launches ~100
to ~1000 kernels, and at batch 1 the host dispatches them more slowly than
the card runs them.  ``StepGraphs.run(key, fn, inputs)`` runs ``fn(*inputs)``
and returns its tensors; on a CUDA device:

  * the first call of a key runs ``fn`` eagerly, as without graphs: it
    warms cuDNN's plan cache, the kernels' attributes, the modules' weight
    layouts and the lazily built tables;
  * the second call captures ``fn`` into a CUDA graph over static copies
    of the inputs (nothing runs during a capture), then replays it;
  * every later call copies its inputs into the static ones (host arrays
    inside the codec's ``<kind>.upload`` span), replays the graph (inside
    a ``<kind>.replay`` span, the launch alone) and returns copies of the
    static outputs.

The key is the caller's (the step and its Python parameters: slice index,
k, tail, deadzone) with the shape, dtype and strides of every input, so a
new shape, batch or gate is a new key.  The replay is the eager call's work
bit for bit: the same kernels and cuDNN plans, captured inside the
caller's scopes (``CodecIO._scope``).

Ownership.  The graphs of every codec on a device share one memory pool
(``CudaGraphs``), so one graph's intermediates may lie where another keeps
its outputs.  A replay therefore hands back copies of the outputs, and the
copy-in, replay and copy-out of one call run one call at a time on the
device, after the previous replay's on any stream (an event), so
interleaved chains, pipelined worker threads and callers on other streams
never see another call's buffers.  PyTorch captures one graph at a time in
a process (``_CAPTURE_LOCK``), and a synchronous copy made by another
thread during a capture invalidates it (seen with ``PipelinedCodec``'s two
workers): that key then runs eagerly, counted in ``fallbacks``.

Launch counts.  A kernel launched during a capture runs only when the
graph replays: ``ops/kernels/build.recording`` keeps those launches, and
each replay adds them to the kernels' counts, so ``CudaKernel.launches``
counts what ran, as without graphs.

Off the card (``backend`` gives None) every call runs eagerly.  A capture
that raises leaves its key eager (``fallbacks``).  A codec holds at most
``MAX_KEYS`` keys, the least recently used dropped first; ``clear`` drops
them all (``CodecIO.set_params``: a graph reads the weights and the
layouts made from them where they were at its capture).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import warnings

import numpy as np
import torch

from ..ops.kernels import build
from ..utils.trace import span

MAX_KEYS = 32           # the steps of three image shapes through one codec
_CAPTURE_LOCK = threading.Lock()
_NEW = object()         # a key not seen yet
_FAILED = object()      # a key whose capture raised: eager from now on


class CudaGraphs:
    """Capture and replay on one CUDA device, shared by every codec there:
    the graphs in one pool (a new one after ``reset``, which a codec calls
    when it holds no graph: PyTorch frees a pool whose graphs are gone, and
    a pool id is not used again), all captured on one side stream (the
    allocator reuses a pool's free blocks only on the stream that freed
    them, so one capture reuses what the captures before it freed)."""

    def __init__(self, device):
        self.device = device
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()
        self._done = None       # recorded after the newest replay's copies

    def reset(self):
        self._pool = None

    def capture(self, fn, inputs):
        """(graph, outputs) of ``fn(*inputs)`` captured on a side stream;
        the outputs are the graph's static tensors, written by each
        replay.  Device-wide work of another thread meanwhile (a device
        synchronization) invalidates a capture, which then raises."""
        with _CAPTURE_LOCK:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = tuple(fn(*inputs))
                finally:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        self._abandon()
                        raise
        return graph, outputs

    def _abandon(self):
        """After a capture that failed to end: PyTorch then leaves the
        capture stream's allocations routed to the pool, so end that here,
        and start a new pool for the next capture."""
        with contextlib.suppress(RuntimeError):
            torch._C._cuda_endAllocateToPool(self.device.index, self._pool)
        self._pool = None

    @contextlib.contextmanager
    def ordered(self):
        """One replay's copies in, launch and copies out: one caller at a
        time, on the current stream after the previous replay's copies
        out on any stream, since another graph's replay may write where
        this one keeps its outputs."""
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            yield
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(stream)


_BACKENDS: dict = {}
_BACKENDS_LOCK = threading.Lock()


def backend(device):
    """How steps on ``device`` are captured: the device's ``CudaGraphs`` on
    a CUDA device, None (eager) elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with _BACKENDS_LOCK:
        if device not in _BACKENDS:
            _BACKENDS[device] = CudaGraphs(device)
        return _BACKENDS[device]


def _signature(inputs) -> tuple:
    return tuple(None if a is None else
                 ("host", a.shape, a.dtype.str) if isinstance(a, np.ndarray)
                 else (tuple(a.shape), a.dtype, a.stride())
                 for a in inputs)


class _Step:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.launches = outputs, launches


class StepGraphs:
    """The captured steps of one codec on ``device`` (see the module
    docstring); ``captures``, ``replays`` and ``fallbacks`` count them.
    ``backend`` None runs every step eagerly."""

    def __init__(self, device, upload_span: str, replay_span: str):
        self.device = torch.device(device)
        self.backend = backend(self.device)
        self._upload_span, self._replay_span = upload_span, replay_span
        self._steps: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.captures = self.replays = self.fallbacks = 0

    def clear(self):
        with self._lock:
            self._steps.clear()
            if self.backend is not None:
                self.backend.reset()

    def keys(self) -> list:
        """The keys held, least recently used first."""
        with self._lock:
            return list(self._steps)

    def run(self, key, fn, inputs) -> tuple:
        """``fn(*inputs)`` as a tuple of tensors.  ``inputs``: device
        tensors, host arrays (in the dtype the device tensor takes) or
        None; ``fn`` gets host arrays as device tensors."""
        if self.backend is not None:
            key = (key, _signature(inputs))
            with self._lock:
                step = self._steps.pop(key, _NEW)
                if step is None:          # its second call
                    step = self._capture(fn, inputs)
                self._steps[key] = None if step is _NEW else step
                while len(self._steps) > MAX_KEYS:
                    self._steps.popitem(last=False)
                    if not any(isinstance(v, _Step)
                               for v in self._steps.values()):
                        self.backend.reset()
                if isinstance(step, _Step):
                    return self._replay(step, inputs)
        return tuple(fn(*self._eager_inputs(inputs)))

    def _eager_inputs(self, inputs) -> list:
        if not any(isinstance(a, np.ndarray) for a in inputs):
            return list(inputs)
        with span(self._upload_span):
            return [torch.from_numpy(a).to(self.device)
                    if isinstance(a, np.ndarray) else a for a in inputs]

    def _capture(self, fn, inputs):
        static = [None if a is None else
                  torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                              device=self.device)
                  if isinstance(a, np.ndarray) else torch.empty_like(a)
                  for a in inputs]
        try:
            with build.recording() as launches:
                graph, outputs = self.backend.capture(fn, static)
        except RuntimeError as e:
            self.fallbacks += 1
            warnings.warn(f"{self._replay_span}: capturing a step failed, it "
                          f"runs eagerly: {e}", RuntimeWarning)
            return _FAILED
        self.captures += 1
        return _Step(graph, static, outputs, launches)

    def _replay(self, step: _Step, inputs) -> tuple:
        with self.backend.ordered():
            host = [(s, a) for s, a in zip(step.inputs, inputs)
                    if isinstance(a, np.ndarray)]
            if host:
                with span(self._upload_span):
                    for s, a in host:
                        s.copy_(torch.from_numpy(a))
            for s, a in zip(step.inputs, inputs):
                if torch.is_tensor(a):
                    s.copy_(a)
            with span(self._replay_span):
                step.graph.replay()
            outputs = tuple(o.clone() for o in step.outputs)
        self.replays += 1
        build.count(step.launches)
        return outputs
