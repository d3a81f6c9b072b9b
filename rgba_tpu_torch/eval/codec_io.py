"""Real bitstream encode/decode for both codecs (port of
``rgba_tpu/eval/codec_io.py``).

The card runs the analysis transform, the hyper path, the per-slice
(mu, scale) convolutions, symbol quantization and CDF-row indexes; the
host's C++ rANS coder (``native/rans.py``) turns symbols into bytes and
back, one stream per image on a thread pool.  Decoding is a chain:

  * z is decoded on the host, the card runs the hyper decode and slice 0's
    stats; then each slice's finish (y = sym + mu + lrp) and the next
    slice's stats go in one step, so the host fetches one index tensor per
    slice for the whole batch;
  * the tail is parallel: with ``max_support_slices`` = 5, slices 5..9 of
    the RGB codec all condition on exactly slices 0..4, so one stats step
    and one index fetch cover the whole tail (6 round trips instead of 10).
    ``tail_parallel=False`` keeps the serial chain; both give identical y.

``decompress_chain`` is a generator that yields after each step it puts on
the card, so ``drive_chains`` can run the mask and RGB chains together;
``decompress_chains`` cuts a batch into ``interleave`` sub-batch chains, so
one sub-batch's host rANS and index fetch run under another's device step
(``interleave=None`` picks 2 for batches of 4, 6 and 8, as the JAX package
does).  The encode overlaps the same way: the second half of the batch's
symbols and indexes is fetched on a worker thread while the host codes the
first half.

The slice chain carries each slice's mean support (``slice_stats``: the
hyper means and the decoded support slices, through the model's per-slice
attention where it has one, as TCM's ``SWAtten``) on the card from the
step of its stats to the step of its finish, where the lrp reads it.

Encoder and decoder recompute (mu, scale) in separate calls, and the
indexes must agree bit for bit, so every device step runs in fp32 with
TF32 off, deterministic cuDNN algorithms and no autotuning (``_scope``),
and both sides build the slice-stat inputs through the same functions.

Serving options, as in the JAX package:

  * ``rate_gate``: latent cells whose /8 alpha pool is 0 code no symbol;
    the encoder's gate ships with the stream and the decoder reads those
    cells as symbol 0 (y = mu + lrp);
  * ``deadzone`` widens the quantizer's zero bin (encoder only);
  * ``max_slices=k`` decodes the first k slices and mean-fills the rest
    (y = mu + lrp): a preview from the same stream, bit-identical to a full
    decode in its first k slices; k = 0 reads no y bytes;
  * ``set_params`` loads new weights and rebuilds the tables made from
    them;
  * ``stream_format="lanes32"``: one stream per image, z and every y slice
    in L interleaved 32-bit rANS lanes (``entropy/device_rans.py``), coded
    on the host and decoded on the card by ``decompress_device``: the
    whole channel-AR chain runs there, the lane state staying on the card
    between the launches of the decode kernel (``ops/kernels/rans_decode``),
    so nothing crosses to the host until the result.  With
    ``RGBA_TPU_DEVICE_ENCODE=1`` (read at each call, the JAX package's
    switch) the card codes the lanes too (``ops/kernels/rans_encode``, one
    launch per segment) and only the finished words cross; a lane that
    overflows its word budget makes the card code the segments again with
    room for the longest lane, to the same bytes.

Worker threads (``eval/pipeline.PipelinedCodec``) enqueue on the caller's
CUDA stream (``caller_stream``), and the codec's lazily built caches fill
under a lock.

Under a profiler the host's waits run in spans (``utils/trace.py``):
``<kind>.fetch`` where device tensors come to the host, ``<kind>.upload``
where host arrays go to the device, ``<kind>.rans`` around each fan-out of
the host rANS coder; each closes before its decode step yields.  The
lazily built tables' copies, made once, open none; a sharded codec's shard
threads record their spans as requests of their own.

Batch-sharded serving (``sharding=batch_sharding(mesh)``, ``parallel/
mesh.py``): each device of the mesh holds a replica of the model (the
codec's own model on its own device, copies elsewhere; ``set_params``
updates them all).  ``compress_batch`` and the v64 decode cut the batch
into the mesh's equal shards, run each shard's device steps on its device
from a thread of its own, on the caller's stream of that device, and
gather the results in batch order; the host rANS is unchanged.  Images are
independent and the codec's steps do not depend on the batch (``_scope``),
so the streams are bit-identical to unsharded ones.  As in the JAX
package, the decode chain is not interleaved under sharding and the lane
(v3) decode refuses it.  A batch the mesh does not divide raises.

CUDA graphs (``eval/step_graphs.py``).  On a CUDA device each device
step runs through ``StepGraphs``: the encode pass (``_compress_tensors``),
a decode chain's first step (the hyper decode and slice 0's stats, or the
mean-fill when k = 0), each serial slice step (slice i's finish, then the
next stats, the tail's stats or the mean-fill), the tail step and
``decode_image``.  A step's key is its name and parameters (slice i, k,
tail, deadzone) with the shape, dtype and strides of its inputs (batch,
latent or image size, a gate or none).  A key's first call runs eagerly
and warms what the step builds lazily; its second captures a CUDA graph
and replays it; later calls copy the host arrays into the graph's static
inputs inside the ``<kind>.upload`` span and replay the graph, one launch
in a ``<kind>.replay`` span in place of the step's hundreds.  A replay
hands back copies of its outputs, and its copies and launch run one
replay at a time on the device, so interleaved chains of one key,
``PipelinedCodec``'s workers and every other caller own each output they
get.  The blobs and
images are the eager path's, byte for byte.  Off the card, and on a
sharded codec's replicas (their shard threads run at once), every step
runs eagerly; the lane decode's and lane encode's own steps
(``decompress_device_latent``, ``_lane_compress_device``) run eagerly
too.  ``set_params`` drops the graphs; ``graphs.captures``, ``.replays``
and ``.fallbacks`` count them.

Not ported: the JAX package's split fetch of the encode (its second half
fetched under the first half's host coding: on the H100 the whole fetch is
too short for it to pay, ``PERF.md``).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.precision import (batch_invariant_scope, deterministic_scope,
                              precision_scope)
from ..entropy import device_rans
from ..entropy.gaussian import GaussianConditional, get_scale_table
from ..native import rans
from ..ops.kernels import rans_decode as _rd
from ..ops.kernels import rans_encode as _re
from ..ops.mask_pyramid import mask_pyramid
from ..utils.trace import span
from .step_graphs import StepGraphs

_MAX_CODING_THREADS = 8
STREAM_FORMATS = ("v64", "lanes32")

_INVERSE_LOCK = threading.Lock()
_GAUSS_INVERSE: dict = {}    # table digest -> build_inverse (numpy)
_INVERSE_ON: dict = {}       # (table digest, device) -> tensors


def _gauss_inverse(gc, device) -> dict:
    """build_inverse of the Gaussian CDF rows on ``device`` (the CPU: the
    plain decode's gathers), cached per process by the rows' content (the
    25 MB inverse is the same for every codec that uses one scale
    table)."""
    h = hashlib.sha256()
    for a in (gc.quantized_cdfs, gc.cdf_lengths):
        h.update(np.ascontiguousarray(a, np.int32).tobytes())
    key = h.hexdigest()
    with _INVERSE_LOCK:
        if key not in _GAUSS_INVERSE:
            _GAUSS_INVERSE[key] = device_rans.build_inverse(
                gc.quantized_cdfs, gc.cdf_lengths)
        dkey = (key, str(device))
        if dkey not in _INVERSE_ON:
            _INVERSE_ON[dkey] = {k: torch.from_numpy(v).to(device)
                                 for k, v in _GAUSS_INVERSE[key].items()}
        return _INVERSE_ON[dkey]


def drive_chains(chains: Sequence) -> List:
    """Round-robin decode-chain generators to completion; returns their
    results (StopIteration values) in order.  Each chain yields right after
    putting work on the card, so one chain's host rANS runs while another's
    device step computes.  Interleaving only reorders when independent work
    is enqueued, so results equal serial driving.  If one chain raises, the
    others are closed, which frees their native decoders."""
    outs: List = [None] * len(chains)
    live = list(enumerate(chains))
    try:
        while live:
            still = []
            for i, ch in live:
                try:
                    next(ch)
                    still.append((i, ch))
                except StopIteration as e:
                    outs[i] = e.value
            live = still
    finally:
        for _, ch in live:
            ch.close()
    return outs


def caller_stream(device):
    """A context factory that puts a worker thread on the calling thread's
    current CUDA stream of ``device``, where the caller's device work went
    (a thread starts on the default stream); a no-op off the card."""
    if device is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.current_stream(device)
    return lambda: torch.cuda.stream(stream)


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    """(B, C, H, W) -> (B, H, W, C), the stream order."""
    return t.permute(0, 2, 3, 1)


def _to_host(t) -> np.ndarray:
    """(B, C, H, W) device tensor -> NHWC int32 numpy, the stream order."""
    return _nhwc(t).cpu().numpy().astype(np.int32)


class CodecIO:
    """A codec model with its entropy tables and the device steps of the
    bitstream codec.  model: the port's RGBCodec or TCM (kind "rgb") or
    MaskCodec (kind "mask"), on the device it runs on, with the policy it
    runs with (the codec's contract is fp32).  The alpha pyramid gates the
    RGBCodec's transforms (``gated``); TCM's take none, so its codec codes
    opaque images without a mask and refuses ``rate_gate``.  rate_gate: the default of
    ``compress_batch`` (RGB codec only); the decoder takes each stream's
    gate from the stream."""

    LANES_DEFAULT = 128

    def __init__(self, model, kind: str = "rgb", rate_gate: bool = False,
                 sharding=None):
        if kind not in ("rgb", "mask"):
            raise ValueError(f"kind must be 'rgb' or 'mask', got {kind!r}")
        self.model = model.eval()
        self.kind = kind
        self._span_fetch, self._span_upload, self._span_rans = (
            f"{kind}.{s}" for s in ("fetch", "upload", "rans"))
        # "paper": the RGBA paper's codecs, whose RGB transforms the alpha
        # pyramid gates; "tcm": the mixed Transformer-CNN codec of opaque
        # images (models/tcm.py), whose transforms take no alpha
        self.architecture = getattr(model, "architecture", "paper")
        self.gated = kind == "rgb" and self.architecture == "paper"
        self.rate_gate = bool(rate_gate) and self.gated
        self.device = next(model.parameters()).device
        self.num_slices = model.num_slices
        # slices >= max_support all condition on exactly the first
        # max_support decoded slices: that makes the decode tail parallel
        self.max_support = model.max_support_slices
        self.gc = GaussianConditional(get_scale_table())
        self.gc.update()
        self._steps_cache: dict = {}
        self._cache_lock = threading.RLock()   # the lazily built caches
        self.last_lane_encode = None    # the device lane encode's last budget
        self._build_tables()
        self.graphs = StepGraphs(self.device, self._span_upload,
                                 f"{kind}.replay")
        self._pool = ThreadPoolExecutor(max_workers=_MAX_CODING_THREADS)
        self.sharding = sharding
        self._replicas = None
        if sharding is not None:
            if not sharding.batch_sharded:
                raise ValueError("CodecIO(sharding=) takes a batch sharding "
                                 "(parallel.mesh.batch_sharding)")
            self._replicas = [
                CodecIO(self.model if i == 0 and d == self.device
                        else copy.deepcopy(self.model).to(d), kind, rate_gate)
                for i, d in enumerate(sharding.mesh.devices)]
            for r in self._replicas:
                r.graphs.backend = None
            self._shard_pool = ThreadPoolExecutor(
                max_workers=sharding.mesh.size)

    def close(self):
        self.graphs.clear()
        self._pool.shutdown()
        if self._replicas is not None:
            self._shard_pool.shutdown()
            for r in self._replicas:
                r.close()

    def _shard_futures(self, n: int, fn) -> List:
        """fn(replica, batch slice) for each shard of a batch of n, each on a
        thread of its own, on the caller's stream of the replica's device:
        the futures, in batch order."""
        streams = [caller_stream(r.device) for r in self._replicas]

        def run(i, sl):
            with streams[i]():
                return fn(self._replicas[i], sl)
        return [self._shard_pool.submit(run, i, sl)
                for i, sl in enumerate(self.sharding.slices(n))]

    def _shards(self, n: int, fn) -> List:
        return [f.result() for f in self._shard_futures(n, fn)]

    def _gather(self, parts, device: bool):
        """Shards' outputs in batch order: on the codec's device, or host
        arrays."""
        if not device:
            return np.concatenate(parts)
        with torch.inference_mode():
            return torch.cat([p.to(self.device) for p in parts])

    def _build_tables(self):
        """The tables made from the weights: the z bottleneck's CDF tables
        and medians; the lane tables are rebuilt at their next use."""
        self.eb_tables = self.model.entropy_bottleneck.cdf_tables()
        self._medians = torch.from_numpy(self.eb_tables["medians"]).to(
            self.device).reshape(1, -1, 1, 1)
        self._lane_state = None

    def set_params(self, state_dict=None):
        """Load new weights, a state dict of ``model`` (for example
        ``weights.state_dict_from_jax`` of a JAX tree), and rebuild the
        tables made from them.  With no argument, only rebuild them, after
        the model's weights changed in place (``load_state_dict``, a
        training step): until then the codec codes with the old tables and
        replays the graphs captured with the old weights' layouts.  Drops
        the graphs: their next calls run eagerly, then capture again."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self._build_tables()
        self.graphs.clear()
        for r in self._replicas or ():
            if r.model is not self.model:
                r.model.load_state_dict(self.model.state_dict(), strict=True)
            r._build_tables()

    @contextlib.contextmanager
    def _scope(self):
        """One device step: inference mode, the policy's precision (TF32
        off in fp32), deterministic cuDNN algorithms without autotuning,
        and each image's result independent of its batch.  The flags are
        process-wide and counted across threads (``core/precision.py``)."""
        with torch.inference_mode(), precision_scope(self.model.policy), \
                deterministic_scope(), batch_invariant_scope():
            yield

    def _nchw(self, a):
        """NHWC host array or tensor -> fp32 NCHW (channels_last) on the
        codec's device."""
        if torch.is_tensor(a) and a.device == self.device:
            t = a
        else:
            with span(self._span_upload):
                t = torch.as_tensor(a, device=self.device)
        if t.dtype == torch.uint8:
            t = t.float() / 255.0
        return t.float().permute(0, 3, 1, 2)

    def _slices(self, max_slices) -> int:
        n = self.num_slices
        return n if max_slices is None else max(0, min(int(max_slices), n))

    # ------------------------------------------------- shared device steps

    def _stats(self, lm, ls, support, i: int):
        """(mu, CDF-row index, mean support) of slice i; ``_finish`` takes
        the mean support (the model's ``slice_stats``)."""
        h, w = lm.shape[2], lm.shape[3]
        mu, scale, ms = self.model.slice_stats(lm, ls, support, i, (h, w))
        return mu, self.gc.build_indexes(scale), ms

    def _finish(self, ms, sym, mu, i: int):
        """y_hat of slice i from its symbols: sym + mu + lrp (of the mean
        support ``ms`` and sym + mu); sym None is symbol 0 everywhere (mu +
        lrp)."""
        y = _cl(mu if sym is None else sym.float() + mu)
        return y + self.model.slice_lrp(ms, y, i)

    def _fill(self, lm, ls, y_hats: list, start: int):
        """Mean-fill slices start..n-1 (symbol 0: y = mu + lrp), appended
        to ``y_hats``: the preview's tail, and what a rate-gated cell
        gets."""
        for i in range(start, self.num_slices):
            mu, _, ms = self._stats(lm, ls, y_hats[:self.max_support], i)
            y_hats.append(self._finish(ms, None, mu, i))

    def _hyper(self, z_hat):
        lm, ls = self.model.hyper_decode(_cl(z_hat))
        return _cl(lm.float()), _cl(ls.float())

    # -------------------------------------------------------------- encode

    def _compress_device(self, lead, mask=None, gate=None,
                         deadzone: float = 0.0):
        """``_compress_tensors`` fetched whole: int32 host arrays."""
        return self._fetch_int32(
            self._compress_tensors(lead, mask, gate, deadzone))

    def _fetch_int32(self, tensors) -> tuple:
        """Device tensors -> int32 host arrays, in one wait."""
        with span(self._span_fetch):
            return tuple(t.cpu().numpy().astype(np.int32) for t in tensors)

    def _compress_tensors(self, lead, mask=None, gate=None,
                          deadzone: float = 0.0):
        """One pass on the card: symbols (int16) and CDF-row indexes (uint8)
        of every slice, stacked (S, B, H, W, sw), and the z symbols (B, zh,
        zw, 192) int16, as tensors on the card in the streams' NHWC order.
        gate: (B, 1, H, W) bool, cells where it is False carry symbol 0;
        deadzone > 0: sym = sign(r) max(floor(|r| + 0.5 - deadzone), 0).
        One step of ``graphs``."""
        dz = float(deadzone)
        with self._scope():
            return self.graphs.run(
                ("encode", dz), functools.partial(self._encode_pass,
                                                  deadzone=dz),
                (lead, mask, gate))

    def _encode_pass(self, lead, mask, gate, deadzone: float):
        if self.gated:
            me = mask_pyramid(mask)
            y = self.model.encode_latent(lead, me[1], me[2])
        else:
            y = self.model.encode_latent(lead)
        y = _cl(y.float())
        m = y.shape[1]
        z = self.model.hyper_encode(y).float()
        z_sym = torch.round(z - self._medians)
        lm, ls = self._hyper(z_sym + self._medians)
        sw = m // self.num_slices
        y_hats, syms, idxs = [], [], []
        for i in range(self.num_slices):
            support = y_hats[:self.max_support]
            mu, index, ms = self._stats(lm, ls, support, i)
            r = y[:, i * sw:(i + 1) * sw] - mu
            if deadzone > 0.0:
                # the stream and y_hat carry the same symbols, so the
                # decoder's support stays in step
                sym = torch.sign(r) * torch.clamp_min(
                    torch.floor(torch.abs(r) + 0.5 - deadzone), 0.0)
            else:
                sym = torch.round(r)
            if gate is not None:
                sym = sym * gate.float()
            y_hats.append(self._finish(ms, sym, mu, i))
            # int16 / uint8 halve the fetch: symbols stay far inside
            # int16, and the table has 64 rows
            syms.append(sym.to(torch.int16))
            idxs.append(index.to(torch.uint8))
        return (torch.stack([_nhwc(s) for s in syms]),
                torch.stack([_nhwc(t) for t in idxs]),
                _nhwc(z_sym.to(torch.int16)).contiguous())

    def compress_batch(self, image=None, mask=None, rate_gate=None,
                       deadzone: float = 0.0, stream_format: str = "v64",
                       lanes: Optional[int] = None) -> List[dict]:
        """Batched compress: one device pass for all images, then B
        independent rANS streams coded on host threads.  image (B, H, W, 3)
        and mask (B, H, W, 1), NHWC, host arrays or tensors, H and W
        multiples of 64; the RGB codec's mask is the (decoded) alpha that
        gates its encoder.

        rate_gate (RGB only; None takes the constructor's): cells whose /8
        pool of the mask is 0 are not coded; the gate ((lh, lw, 1) bool)
        ships in each result as "gate".  deadzone > 0 widens the zero bin
        by that much on each side.  stream_format "v64" returns one
        {"strings": [y, z], "shape": (zh, zw)} per image; "lanes32" one
        {"format": "lanes32", "lanes": L, "stream": bytes, "shape"} that
        ``decompress_device`` decodes on the card (L: ``lanes``, or at most
        ``LANES_DEFAULT`` picked from the symbol count, as the JAX
        package does, so the bytes agree).  With
        ``RGBA_TPU_DEVICE_ENCODE=1`` the card codes the lane streams
        (``_lane_compress_device``); the bytes are the host coder's."""
        if stream_format not in STREAM_FORMATS:
            raise ValueError(f"stream_format must be one of {STREAM_FORMATS}, "
                             f"got {stream_format!r}")
        if self._replicas is not None:
            lead = image if self.kind == "rgb" else mask
            parts = self._shards(len(lead), lambda r, sl: r.compress_batch(
                image=None if image is None else image[sl],
                mask=None if mask is None else mask[sl],
                rate_gate=rate_gate, deadzone=deadzone,
                stream_format=stream_format, lanes=lanes))
            return [c for part in parts for c in part]
        if rate_gate and self.kind == "rgb" and not self.gated:
            raise ValueError(f"rate_gate: the {self.architecture} codec's "
                             f"transforms take no alpha")
        rg = self.rate_gate if rate_gate is None else (
            bool(rate_gate) and self.gated)
        dz = float(deadzone)
        gate = gate_host = None
        if self.kind == "rgb":
            x = self._nchw(image)
            m = self._nchw(mask) if self.gated else None
            if rg:
                # the encoder's gate is the one truth: it ships with the
                # stream, the decoder never derives it again
                with self._scope():
                    gate = mask_pyramid(m)[2] > 0
                with span(self._span_fetch):
                    gate_host = _nhwc(gate).cpu().numpy()
            dev = self._compress_tensors(x, m, gate, dz)
        else:
            dev = self._compress_tensors(self._nchw(mask), deadzone=dz)
        y_syms, _, z_sym = dev
        batch = z_sym.shape[0]
        shape = (int(z_sym.shape[1]), int(z_sym.shape[2]))
        n_slices, _, lh, lw, sw = y_syms.shape
        z_n, s_n = int(z_sym[0].numel()), lh * lw * sw
        lanes32 = stream_format == "lanes32"
        if lanes32:
            lanes = self._lane_count(z_n + n_slices * s_n, lanes)
            if os.environ.get("RGBA_TPU_DEVICE_ENCODE", "0") == "1":
                return self._lane_compress_device(dev, gate, gate_host, lanes)
        y_syms, y_idxs, z_sym = self._fetch_int32(dev)

        def alive_of(b):
            return None if gate_host is None else np.broadcast_to(
                gate_host[b][None], (n_slices, lh, lw, sw)).ravel()

        if lanes32:
            z_off = self._lane_tables()["merged"]["z_row_offset"]
            z_idx = device_rans.z_channel_indexes(*shape, z_sym.shape[-1]) \
                + z_off
            seg_ends = z_n + s_n * np.arange(n_slices + 1, dtype=np.int64)

            def one(b):
                sym = np.concatenate([z_sym[b].ravel(), y_syms[:, b].ravel()])
                idx = np.concatenate([z_idx, y_idxs[:, b].ravel()])
                alive = alive_of(b)
                if alive is not None:
                    alive = np.concatenate([np.ones(z_n, bool), alive])
                return self._lane_blob(sym, idx, seg_ends, lanes, shape,
                                       alive, None if gate_host is None
                                       else gate_host[b])
        else:
            t = self.eb_tables
            z_indexes = np.broadcast_to(
                np.arange(z_sym.shape[-1], dtype=np.int32),
                z_sym.shape[1:]).ravel()

            def one(b):
                z_string = rans.encode_with_indexes(
                    z_sym[b].ravel(), z_indexes, t["quantized_cdfs"],
                    t["cdf_lengths"], t["offsets"])
                # slice-major order: the decoder reads slice 0 first
                syms_b, idxs_b = y_syms[:, b].ravel(), y_idxs[:, b].ravel()
                alive = alive_of(b)
                if alive is not None:
                    syms_b, idxs_b = syms_b[alive], idxs_b[alive]
                y_string = rans.encode_with_indexes(
                    syms_b, idxs_b, self.gc.quantized_cdfs,
                    self.gc.cdf_lengths, self.gc.offsets)
                out = {"strings": [y_string, z_string], "shape": shape}
                if gate_host is not None:
                    out["gate"] = gate_host[b]
                return out

        with span(self._span_rans):
            return list(self._pool.map(one, range(batch)))

    def _lane_count(self, n_total: int, lanes: Optional[int]) -> int:
        """``lanes``, or the JAX package's pick: one lane per 512 symbols,
        a power of two in [8, LANES_DEFAULT].  The count is part of the
        bytes."""
        return lanes or min(self.LANES_DEFAULT, max(
            8, 1 << int(np.log2(max(n_total // 512, 8)))))

    # ------------------------------------------------------- lane streams

    def _lane_tables(self) -> dict:
        """The lane coder's tables: the Gaussian rows, then the z rows at
        ``z_row_offset`` with their columns padded to a multiple of 64 (the
        JAX package's layout), as numpy ("merged") and as tensors on the
        codec's device with the kernels' compact layout of the rows the y
        slices address ("y") and of the z rows ("z"); on the CPU also the
        Gaussian rows' inverse tables, which the plain decode gathers from
        (the kernels do not read them, so they are not put on the card)."""
        with self._cache_lock:
            if self._lane_state is None:
                self._lane_state = self._build_lane_state()
            return self._lane_state

    def _build_lane_state(self) -> dict:
        g = device_rans.pack_tables(self.gc.quantized_cdfs,
                                    self.gc.cdf_lengths, self.gc.offsets)
        t = self.eb_tables
        zc = int(np.asarray(t["quantized_cdfs"]).shape[1])
        z = device_rans.pack_tables(t["quantized_cdfs"], t["cdf_lengths"],
                                    t["offsets"], pad_cols=-(-zc // 64) * 64)
        merged = device_rans.merge_tables(g, z)
        tables = {k: torch.from_numpy(merged[k]).to(self.device)
                  for k in ("cdfs", "max_values", "offsets")}
        z_off, rows = merged["z_row_offset"], merged["cdfs"].shape[0]
        return {
            "merged": merged,
            "y": device_rans.segment_tables(tables, (0, z_off)),
            "z": device_rans.segment_tables(tables, (z_off, rows)),
            "inverse": (_gauss_inverse(self.gc, self.device)
                        if self.device.type == "cpu" else None),
        }

    def _lane_blob(self, sym_flat, idx_flat, seg_ends, lanes, shape,
                   alive=None, gate=None) -> dict:
        m = self._lane_tables()["merged"]
        words, lane_nwords = rans.encode_lanes(
            sym_flat, idx_flat, seg_ends, lanes, m["cdfs"],
            m["max_values"] + 2, m["offsets"], alive=alive)
        out = {"format": "lanes32", "lanes": lanes,
               "stream": device_rans.split_stream(words, lane_nwords),
               "shape": shape}
        if gate is not None:
            out["gate"] = gate
        return out

    def _all_active(self, n: int, batch: int, lanes: int):
        """(T, B, L) active flags of an ungated segment of n symbols: every
        step but the tail's padding."""
        key = ("active", n, batch, lanes)
        with self._cache_lock:
            if key not in self._steps_cache:
                t = -(-n // lanes)
                act = (torch.arange(t * lanes, device=self.device) < n)
                self._steps_cache[key] = act.reshape(t, 1, lanes).expand(
                    t, batch, lanes).contiguous()
            return self._steps_cache[key]

    def _z_indexes(self, zh: int, zw: int, batch: int, lanes: int):
        key = ("z", zh, zw, batch, lanes)
        with self._cache_lock:
            if key not in self._steps_cache:
                c = self.eb_tables["quantized_cdfs"].shape[0]
                idx = device_rans.z_channel_indexes(zh, zw, c) + \
                    self._lane_tables()["merged"]["z_row_offset"]
                flat = torch.from_numpy(idx).to(self.device)[None]
                self._steps_cache[key] = device_rans.to_steps(
                    flat.expand(batch, -1), lanes)
            return self._steps_cache[key]

    def _lane_compress_device(self, dev, gate, gate_host, lanes: int):
        """The device route of ``compress_batch(stream_format="lanes32")``
        (port of the JAX package's ``_lane_compress_device`` and
        ``_build_lane_encode_fn``).  The symbols and indexes of
        ``_compress_tensors`` stay on the card, in their own types; the lane
        encode kernel codes the segments in encode order, the reverse of the
        decode order (y slice S-1 down to 0, then z), one launch per
        segment, the lane state, pointer and words staying on the card
        between launches; then ``finish_lanes`` and one fetch of the words
        actually used.  Rate-gated cells are inactive steps.  Each lane has
        a budget of max(64, (n // L) // 2 + 16) words for n symbols (8 coded
        bits a symbol, the JAX formula).  The budget is not part of the
        bytes: if a lane overflows it, the pointers have counted every word
        all the same, and the segments are coded again on the card with
        room for the longest lane.  ``last_lane_encode`` keeps the budget,
        the largest lane and the second pass's budget, if any."""
        y_syms, y_idxs, z_sym = dev
        n_slices, batch, lh, lw, sw = y_syms.shape
        zh, zw = int(z_sym.shape[1]), int(z_sym.shape[2])
        z_n, s_n = int(z_sym[0].numel()), lh * lw * sw
        budget = max(64, ((z_n + n_slices * s_n) // lanes) // 2 + 16)
        st = self._lane_tables()

        def steps(t, n):
            return device_rans.to_steps(t.reshape(batch, n), lanes)

        def encode(act, budget):
            state, wptr, out = device_rans.init_encode((batch,), lanes, budget,
                                                       self.device)
            for i in reversed(range(n_slices)):
                state, wptr, out = _re.rans_encode(
                    st["y"], state, wptr, out, steps(y_idxs[i], s_n),
                    steps(y_syms[i], s_n), act)
            state, wptr, out = _re.rans_encode(
                st["z"], state, wptr, out,
                self._z_indexes(zh, zw, batch, lanes),
                steps(z_sym, z_n), self._all_active(z_n, batch, lanes))
            words, nwords, overflow = device_rans.finish_lanes(state, wptr, out)
            with span(self._span_fetch):
                return words, nwords.cpu().numpy(), bool(overflow)

        with self._scope():
            act = self._all_active(s_n, batch, lanes)
            if gate is not None:
                act = device_rans.to_steps(_nhwc(gate).expand(
                    batch, lh, lw, sw).reshape(batch, s_n), lanes, fill=False)
            words, nwords, overflow = encode(act, budget)
            longest = int(nwords.max()) - 2
            rerun = None
            if overflow:
                # room for every word of the longest lane
                rerun = (longest // 64 + 1) * 64
                words, nwords, again = encode(act, rerun)
                if again:
                    raise RuntimeError(f"lane encode: {rerun} words overflowed "
                                       f"again (longest lane {longest})")
            self.last_lane_encode = {"lanes": lanes, "budget": budget,
                                     "max_nwords": longest + 2,
                                     "overflow": overflow,
                                     "rerun_budget": rerun}
            used = min(int(words.shape[-1]), -(-int(nwords.max()) // 64) * 64)
            with span(self._span_fetch):
                words = words[:, :, :used].cpu().numpy()

        def one(b):
            # each lane's words in decode order, lane after lane
            flat = words[b][np.arange(used) < nwords[b][:, None]]
            out = {"format": "lanes32", "lanes": lanes,
                   "stream": device_rans.split_stream(flat.astype(np.uint16),
                                                      nwords[b]),
                   "shape": (zh, zw)}
            if gate_host is not None:
                out["gate"] = gate_host[b]
            return out

        return list(self._pool.map(one, range(batch)))

    def decompress_device_latent(self, compressed: Sequence[dict],
                                 max_slices: Optional[int] = None):
        """Decode lane-format streams on the card: z segment (row search)
        -> hyper decode -> per slice: stats, CDF-row indexes, the segment's
        symbols, y = sym + mu + lrp -> mean-fill of slices
        >= max_slices.  One launch of the decode kernel per segment (1 + k);
        the lane state and pointer stay on the card between them.  Returns
        y_hat (B, M, H/8, W/8), a device tensor."""
        if self._replicas is not None:
            raise NotImplementedError(
                "the lane-format (v3) decode is not wired for batch-sharded "
                "serving, as in the JAX package: decode v64 streams on a "
                "sharded codec")
        zh, zw = compressed[0]["shape"]
        lanes = compressed[0].get("lanes")
        for i, c in enumerate(compressed):
            if c.get("format") != "lanes32" or tuple(c["shape"]) != (zh, zw) \
                    or c["lanes"] != lanes:
                raise ValueError(f"stream {i}: decompress_device requires "
                                 f"same-shaped lanes32 streams")
        gated = ["gate" in c for c in compressed]
        if any(gated) and not all(gated):
            raise ValueError("decompress_device: either every stream carries "
                             "its rate gate or none does")
        k = self._slices(max_slices)
        flat, base, end = device_rans.pack_streams(
            [device_rans.parse_stream(c["stream"], lanes) for c in compressed],
            lanes)
        st = self._lane_tables()
        b, s = len(compressed), self.max_support
        with self._scope():
            with span(self._span_upload):
                words = device_rans.words_tensor(flat, self.device)
                lane_end = torch.from_numpy(end).to(self.device)
                lane_base = torch.from_numpy(base).to(self.device)
            state, ptr = device_rans.init_lanes(words, lane_base)
            c_z = self.eb_tables["quantized_cdfs"].shape[0]
            z_n = zh * zw * c_z
            syms, state, ptr = _rd.rans_decode(
                st["z"], words, state, ptr,
                self._z_indexes(zh, zw, b, lanes),
                self._all_active(z_n, b, lanes), lane_end)
            z_sym = device_rans.from_steps(syms, z_n).reshape(
                b, zh, zw, c_z).permute(0, 3, 1, 2)
            lm, ls = self._hyper(z_sym.float() + self._medians)
            h, w = lm.shape[2], lm.shape[3]
            gate = None
            if gated[0]:
                gate = np.stack([np.asarray(c["gate"], bool).reshape(h, w, 1)
                                 for c in compressed])
                with span(self._span_upload):
                    gate = torch.from_numpy(gate).to(self.device)
            y_hats: List = []
            for i in range(k):
                mu, index, ms = self._stats(lm, ls, y_hats[:s], i)
                sw = index.shape[1]
                n_i = h * w * sw
                idx = device_rans.to_steps(
                    index.permute(0, 2, 3, 1).reshape(b, n_i), lanes)
                if gate is None:
                    act = self._all_active(n_i, b, lanes)
                else:
                    act = device_rans.to_steps(
                        gate.expand(b, h, w, sw).reshape(b, n_i), lanes,
                        fill=False)
                syms, state, ptr = _rd.rans_decode(
                    st["y"], words, state, ptr, idx, act, lane_end,
                    inverse=st["inverse"])
                sym = device_rans.from_steps(syms, n_i).reshape(
                    b, h, w, sw).permute(0, 3, 1, 2)
                y_hats.append(self._finish(ms, sym, mu, i))
            self._fill(lm, ls, y_hats, k)
            return torch.cat(y_hats, dim=1)

    def decompress_device(self, compressed: Sequence[dict], mask=None,
                          max_slices: Optional[int] = None):
        """Decode lane-format streams wholly on the card (see
        ``decompress_device_latent``), then the synthesis transform, gated
        by the mask pyramid of ``mask`` (the decoded alpha, RGB codec).
        Returns the NHWC reconstruction as a device tensor.  On the card it
        launches the CUDA decode kernel or raises; there is no other route."""
        if self.gated and mask is None:
            raise ValueError("the RGB codec's decompress_device needs "
                             "mask= (the decoded alpha)")
        y_hat = self.decompress_device_latent(compressed, max_slices)
        return self.decode_image(y_hat, mask=mask, device=True)

    # -------------------------------------------------------------- decode

    def _decode_slice(self, dec, idx, alive=None):
        """One slice's symbols from one image's stream; cells whose alive
        flag is False are not in the stream and decode as 0."""
        if alive is None:
            return dec.decode_stream(idx, self.gc.quantized_cdfs,
                                     self.gc.cdf_lengths, self.gc.offsets)
        out = np.zeros(idx.size, np.int32)
        out[alive] = dec.decode_stream(
            idx.ravel()[alive], self.gc.quantized_cdfs, self.gc.cdf_lengths,
            self.gc.offsets)
        return out.reshape(idx.shape)

    # The decode chain's device steps, each one step of ``graphs``; the
    # symbols come as NHWC int16 device tensors.

    def _first_step(self, z_sym, k: int):
        """The hyper decode; then slice 0's (mu, uint8 index, mean
        support), or with k = 0 every slice mean-filled."""
        lm, ls = self._hyper(z_sym.permute(0, 3, 1, 2).float()
                             + self._medians)
        if k:
            mu, index, ms = self._stats(lm, ls, [], 0)
            return lm, ls, mu, index.to(torch.uint8), ms
        y_hats: List = []
        self._fill(lm, ls, y_hats, 0)
        return tuple(y_hats)

    def _slice_step(self, sym, lm, ls, mu, ms, *support, i: int, serial: int,
                    tail: int, k: int):
        """Slice i's y from its symbols, its mu and its mean support ``ms``
        (support: the decoded slices up to ``max_support``); then slice
        i + 1's (mu, uint8 index, mean support), or the tail's mus, mean
        supports and stacked uint8 indexes, or the mean-filled slices
        k..n-1.  The mean support of a slice is made once, in the step of
        its stats, and carried on the card to the step of its finish."""
        s = self.max_support
        y = self._finish(ms, sym.permute(0, 3, 1, 2), mu, i)
        y_hats = [*support, y]
        if i + 1 < serial:
            mu, index, ms = self._stats(lm, ls, y_hats[:s], i + 1)
            return y, mu, index.to(torch.uint8), ms
        if tail:
            stats = [self._stats(lm, ls, y_hats[:s], j)
                     for j in range(s, self.num_slices)]
            return (y, *[m for m, _, _ in stats], *[ms for _, _, ms in stats],
                    torch.stack([ix.to(torch.uint8)
                                 for _, ix, _ in stats[:tail]]))
        self._fill(lm, ls, y_hats, k)
        return (y, *y_hats[len(support) + 1:])

    def _tail_step(self, syms, *rest, tail: int):
        """The tail slices' y: rest is each tail slice's mu, then each one's
        mean support; syms (tail, B, H, W, sw) the first ``tail`` slices'
        symbols, the others symbol 0."""
        s, n = self.max_support, len(rest) // 2
        return tuple(self._finish(
            ms, syms[j].permute(0, 3, 1, 2) if j < tail else None, mu, s + j)
            for j, (mu, ms) in enumerate(zip(rest[:n], rest[n:])))

    def decompress_chain(self, compressed: Sequence[dict], gate_host=None,
                         max_slices: Optional[int] = None,
                         tail_parallel: bool = True):
        """Generator form of the decode slice loop for a batch of
        same-shaped v64 streams: yields right after each device step,
        returns the device-resident y_hat (B, M, H/8, W/8) as its
        StopIteration value.  gate_host: (B, lh, lw, 1) bool, the encoder's
        rate gate of each stream.  max_slices: decode the first k slices
        and mean-fill the rest.  tail_parallel: see the module docstring.
        On a sharded codec the chain starts each shard's chain on its
        replica (driven to its end on a thread), yields once and gathers
        the shards' y_hat."""
        if self._replicas is not None:
            return (yield from self._sharded_chain(compressed, gate_host,
                                                   max_slices, tail_parallel))
        batch = len(compressed)
        zh, zw = compressed[0]["shape"]
        if any(tuple(c["shape"]) != (zh, zw) for c in compressed):
            raise ValueError("decompress requires same-shaped streams")
        k = self._slices(max_slices)
        t = self.eb_tables
        c = t["quantized_cdfs"].shape[0]
        z_indexes = np.broadcast_to(np.arange(c, dtype=np.int32),
                                    (1, zh, zw, c))

        def decode_z(b):
            return rans.decode_with_indexes(
                compressed[b]["strings"][1], z_indexes, t["quantized_cdfs"],
                t["cdf_lengths"], t["offsets"])

        with span(self._span_rans):
            z_sym = np.concatenate(list(self._pool.map(decode_z,
                                                       range(batch))))
            # k = 0 reads no y bytes
            decoders = [rans.RansDecoder(cc["strings"][0])
                        for cc in compressed] if k else []
        s = self.max_support
        tail = k - s if tail_parallel and k > s else 0
        serial = k - tail
        alives: List = [None] * batch
        y_hats: List = []
        # native decoder state is freed when the chain ends, raises, or is
        # closed by drive_chains after a sibling chain raised
        try:
            with self._scope():
                out = self.graphs.run(
                    ("first", k, tail),
                    functools.partial(self._first_step, k=k),
                    (np.ascontiguousarray(z_sym, np.int16),))
            if k:
                lm, ls, mu, index, ms = out
            else:
                y_hats.extend(out)
            yield
            for i in range(serial):
                with span(self._span_fetch):
                    idx_np = _to_host(index)
                if gate_host is not None and alives[0] is None:
                    lh, lw, sw = idx_np.shape[1:]
                    alives = [np.broadcast_to(
                        np.asarray(gate_host[b], bool).reshape(lh, lw, 1),
                        (lh, lw, sw)).ravel() for b in range(batch)]
                with span(self._span_rans):
                    syms = list(self._pool.map(
                        lambda b: self._decode_slice(
                            decoders[b], idx_np[b:b + 1], alives[b]),
                        range(batch)))
                with self._scope():
                    out = self.graphs.run(
                        ("slice", k, tail, i),
                        functools.partial(self._slice_step, i=i,
                                          serial=serial, tail=tail, k=k),
                        (np.ascontiguousarray(np.concatenate(syms), np.int16),
                         lm, ls, mu, ms, *y_hats[:s]))
                y_hats.append(out[0])
                if i + 1 < serial:
                    mu, index, ms = out[1:]
                elif tail:
                    tail_stats, idx_tail = out[1:-1], out[-1]
                else:
                    y_hats.extend(out[1:])
                yield
            if tail:
                # one fetch for the tail slices' indexes; each image's
                # stream decodes its whole tail back to back on a thread
                with span(self._span_fetch):
                    idxs_np = np.stack([_to_host(ix) for ix in idx_tail])

                def decode_tail(b):
                    return np.stack([self._decode_slice(
                        decoders[b], idxs_np[j, b:b + 1], alives[b])
                        for j in range(tail)])

                with span(self._span_rans):
                    syms = list(self._pool.map(decode_tail, range(batch)))
                tail_syms = np.concatenate(syms, axis=1)  # (tail, B, ...)
                with self._scope():
                    y_hats.extend(self.graphs.run(
                        ("tail", k, tail),
                        functools.partial(self._tail_step, tail=tail),
                        (np.ascontiguousarray(tail_syms, np.int16),
                         *tail_stats)))
                yield
            with self._scope():
                return torch.cat(y_hats, dim=1)
        finally:
            for dec in decoders:
                dec.close()

    def _sharded_chain(self, compressed, gate_host, max_slices,
                       tail_parallel):
        compressed = list(compressed)

        def chain(r, sl):
            return drive_chains([r.decompress_chain(
                compressed[sl], None if gate_host is None else gate_host[sl],
                max_slices, tail_parallel)])[0]
        futures = self._shard_futures(len(compressed), chain)
        yield
        return self._gather([f.result() for f in futures], device=True)

    def _gate_of(self, compressed: Sequence[dict], mask, rate_gate: bool):
        """The rate gate of each stream, (B, lh, lw, 1) bool, or None.  A
        stream's gate is the one it carries; every stream must carry one
        or none.  Only when none does and the caller passes rate_gate=True
        is it derived from ``mask`` (safe only for streams coded from that
        same mask); the constructor's ``rate_gate`` never applies here, so
        ungated streams are never read as gated."""
        has = ["gate" in c for c in compressed]
        if all(has):
            return np.stack([np.asarray(c["gate"], bool) for c in compressed])
        if any(has):
            missing = has.index(False)
            raise ValueError(f"stream {missing} carries no rate gate while "
                             f"others do")
        if not (rate_gate and self.gated):
            return None
        if mask is None:
            raise ValueError("rate-gated streams without a gate need mask=")
        with self._scope():
            gate = mask_pyramid(self._nchw(mask))[2] > 0
        with span(self._span_fetch):
            return gate.permute(0, 2, 3, 1).cpu().numpy()

    def decode_image(self, y_hat, mask=None, device: bool = False):
        """Synthesis transform of a decoded latent (gated by the mask
        pyramid of ``mask`` for the RGB codec), clipped to [0, 1]; NHWC,
        a device tensor with device=True, else a host array."""
        if self._replicas is not None:
            return self._gather(self._shards(len(y_hat), lambda r, sl: (
                r.decode_image(y_hat[sl].to(r.device),
                               None if mask is None else mask[sl], device))),
                device)
        with self._scope():
            m = self._nchw(mask) if self.gated else None
            x, = self.graphs.run(("image",), self._image, (y_hat, m))
            if device:
                return x
            with span(self._span_fetch):
                return x.cpu().numpy()

    def _image(self, y_hat, mask):
        """``decode_image``'s device step: NHWC, clipped to [0, 1]."""
        if self.gated:
            md = mask_pyramid(mask)
            x = self.model.decode_latent(y_hat, md[1], md[2])
        else:
            x = self.model.decode_latent(y_hat)
        return (torch.clamp(x, 0.0, 1.0).permute(0, 2, 3, 1),)

    def decompress_chains(self, compressed: Sequence[dict], gate_host=None,
                          max_slices: Optional[int] = None,
                          interleave: Optional[int] = None,
                          tail_parallel: bool = True) -> List:
        """The batch cut into up to ``interleave`` contiguous sub-batches,
        one ``decompress_chain`` each (their results, concatenated in
        order, are the batch's y_hat); each chain gets its slice of
        ``gate_host``.  Driven together (``drive_chains``), one
        sub-batch's host rANS and index fetch run under another's device
        step.  interleave=None picks 2 for batches of 4, 6 and 8 and 1
        otherwise, as the JAX package does (equal sub-batches of at least
        2).  The results equal interleave=1 exactly: no image's result
        depends on its batch (``_scope``).  A sharded codec
        takes 1, as the JAX package does (the mesh splits the batch)."""
        batch = len(compressed)
        if self._replicas is not None:
            interleave = 1
        elif interleave is None:
            interleave = 2 if batch in (4, 6, 8) else 1
        groups = [slice(0, batch)]
        if interleave > 1 and batch >= 2:
            cuts = np.linspace(0, batch, min(int(interleave), batch) + 1)
            cuts = cuts.astype(int)
            groups = [slice(int(a), int(b))
                      for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
        compressed = list(compressed)
        return [self.decompress_chain(
                    compressed[g],
                    gate_host=None if gate_host is None else gate_host[g],
                    max_slices=max_slices, tail_parallel=tail_parallel)
                for g in groups]

    def _decode_latent(self, compressed, mask, rate_gate, max_slices,
                       tail_parallel, interleave):
        compressed = list(compressed)
        gate_host = self._gate_of(compressed, mask, rate_gate)
        parts = drive_chains(self.decompress_chains(
            compressed, gate_host, max_slices, interleave, tail_parallel))
        if len(parts) == 1:
            return parts[0]
        with torch.inference_mode():
            return torch.cat(parts, dim=0)

    def decompress_batch(self, compressed: Sequence[dict], mask=None,
                         device: bool = False, rate_gate: bool = False,
                         max_slices: Optional[int] = None,
                         tail_parallel: bool = True,
                         interleave: Optional[int] = None):
        """Batched decompress of same-shaped v64 streams: the slice loop
        runs once for the whole batch (in ``interleave`` sub-batch chains
        driven together, see ``decompress_chains``), then the synthesis
        transform.  Rate-gated streams decode with the gate they carry;
        rate_gate=True derives it from ``mask`` for streams that carry none
        (see ``_gate_of``).  max_slices=k gives the preview."""
        y_hat = self._decode_latent(compressed, mask, rate_gate, max_slices,
                                    tail_parallel, interleave)
        return self.decode_image(y_hat, mask=mask, device=device)

    def decompress_batch_with_latent(self, compressed: Sequence[dict],
                                     mask=None, rate_gate: bool = False,
                                     max_slices: Optional[int] = None,
                                     tail_parallel: bool = True,
                                     interleave: Optional[int] = None):
        """decompress_batch that also returns the decoded latent y_hat
        (host arrays: NHWC x_hat, NCHW y_hat)."""
        y_hat = self._decode_latent(compressed, mask, rate_gate, max_slices,
                                    tail_parallel, interleave)
        x_hat = self.decode_image(y_hat, mask=mask)
        with span(self._span_fetch):
            return x_hat, y_hat.float().cpu().numpy()

    def compress(self, image=None, mask=None) -> dict:
        """One image: RGB compress(image, mask), mask codec compress(mask=)."""
        lead = image if self.kind == "rgb" else mask
        if lead.shape[0] != 1:
            raise ValueError("compress expects batch 1; use compress_batch")
        return self.compress_batch(image=image, mask=mask)[0]

    def decompress(self, compressed: dict, mask=None) -> np.ndarray:
        return self.decompress_batch([compressed], mask=mask)
