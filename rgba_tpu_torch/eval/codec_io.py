"""Real bitstream encode/decode for both codecs (port of
``rgba_tpu/eval/codec_io.py``, the v64 host-coded streams).

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
the card, so ``drive_chains`` can run the mask and RGB chains together.

Encoder and decoder recompute (mu, scale) in separate calls, and the
indexes must agree bit for bit, so every device step runs in fp32 with
TF32 off, deterministic cuDNN algorithms and no autotuning (``_scope``),
and both sides build the slice-stat inputs through the same functions.

Not ported yet: the rate gate, the deadzone quantizer, progressive
``max_slices``, the lane format (``lanes32``, on-device rANS),
``interleave`` > 1 and ``set_params``.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.precision import batch_invariant_scope, precision_scope
from ..entropy.gaussian import GaussianConditional, get_scale_table
from ..native import rans
from ..ops.mask_pyramid import mask_pyramid

_MAX_CODING_THREADS = 8


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


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _to_host(t) -> np.ndarray:
    """(B, C, H, W) device tensor -> NHWC int32 numpy, the stream order."""
    return t.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32)


class CodecIO:
    """A codec model with its entropy tables and the device steps of the
    bitstream codec.  model: the port's RGBCodec (kind "rgb") or MaskCodec
    (kind "mask"), on the device it runs on, with the policy it runs with
    (the codec's contract is fp32)."""

    def __init__(self, model, kind: str = "rgb"):
        if kind not in ("rgb", "mask"):
            raise ValueError(f"kind must be 'rgb' or 'mask', got {kind!r}")
        self.model = model.eval()
        self.kind = kind
        self.device = next(model.parameters()).device
        self.num_slices = model.num_slices
        # slices >= max_support all condition on exactly the first
        # max_support decoded slices: that makes the decode tail parallel
        self.max_support = model.max_support_slices
        self.gc = GaussianConditional(get_scale_table())
        self.gc.update()
        self.eb_tables = model.entropy_bottleneck.cdf_tables()
        self._medians = torch.from_numpy(self.eb_tables["medians"]).to(
            self.device).reshape(1, -1, 1, 1)
        self._pool = ThreadPoolExecutor(max_workers=_MAX_CODING_THREADS)

    def close(self):
        self._pool.shutdown()

    @contextlib.contextmanager
    def _scope(self):
        """One device step: inference mode, the policy's precision (TF32
        off in fp32), deterministic cuDNN algorithms without autotuning,
        and each image's result independent of its batch."""
        cudnn = torch.backends.cudnn
        saved = (cudnn.deterministic, cudnn.benchmark)
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            with torch.inference_mode(), precision_scope(self.model.policy), \
                    batch_invariant_scope():
                yield
        finally:
            cudnn.deterministic, cudnn.benchmark = saved

    def _nchw(self, a):
        """NHWC host array or tensor -> fp32 NCHW (channels_last) on the
        codec's device."""
        t = torch.as_tensor(a, device=self.device)
        if t.dtype == torch.uint8:
            t = t.float() / 255.0
        return t.float().permute(0, 3, 1, 2)

    # ------------------------------------------------- shared device steps

    def _stats(self, lm, ls, support, i: int):
        """(mu, CDF-row index) of slice i."""
        h, w = lm.shape[2], lm.shape[3]
        mu, scale = self.model.slice_stats(lm, ls, support, i, (h, w))
        return mu, self.gc.build_indexes(scale)

    def _finish(self, lm, support, sym, mu, i: int):
        """y_hat of slice i from its symbols: sym + mu + lrp."""
        y = _cl(sym.float() + mu)
        return y + self.model.slice_lrp(lm, support, y, i)

    def _hyper(self, z_hat):
        lm, ls = self.model.hyper_decode(_cl(z_hat))
        return _cl(lm.float()), _cl(ls.float())

    # -------------------------------------------------------------- encode

    def _compress_device(self, lead, mask=None):
        """One pass on the card: symbols and indexes of every slice, stacked
        (S, B, H, W, sw), and the z symbols (B, zh, zw, 192), on the host."""
        with self._scope():
            if self.kind == "rgb":
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
                mu, index = self._stats(lm, ls, support, i)
                sym = torch.round(y[:, i * sw:(i + 1) * sw] - mu)
                y_hats.append(self._finish(lm, support, sym, mu, i))
                # int16 / uint8 halve the fetch: symbols stay far inside
                # int16, and the table has 64 rows
                syms.append(sym.to(torch.int16))
                idxs.append(index.to(torch.uint8))
            return (np.stack([_to_host(s) for s in syms]),
                    np.stack([_to_host(t) for t in idxs]),
                    _to_host(z_sym.to(torch.int16)))

    def compress_batch(self, image=None, mask=None) -> List[dict]:
        """Batched compress: one device pass for all images, then B
        independent rANS streams coded on host threads.  image (B, H, W, 3)
        and mask (B, H, W, 1), NHWC, host arrays or tensors, H and W
        multiples of 64; the RGB codec's mask is the (decoded) alpha that
        gates its encoder.  Returns one {"strings": [y, z], "shape":
        (zh, zw)} per image."""
        if self.kind == "rgb":
            y_syms, y_idxs, z_sym = self._compress_device(
                self._nchw(image), self._nchw(mask))
        else:
            y_syms, y_idxs, z_sym = self._compress_device(self._nchw(mask))
        t = self.eb_tables
        shape = (int(z_sym.shape[1]), int(z_sym.shape[2]))
        z_indexes = np.broadcast_to(np.arange(z_sym.shape[-1], dtype=np.int32),
                                    z_sym.shape[1:]).ravel()

        def one(b):
            z_string = rans.encode_with_indexes(
                z_sym[b].ravel(), z_indexes, t["quantized_cdfs"],
                t["cdf_lengths"], t["offsets"])
            # slice-major order: the decoder reads slice 0 first
            y_string = rans.encode_with_indexes(
                y_syms[:, b].ravel(), y_idxs[:, b].ravel(),
                self.gc.quantized_cdfs, self.gc.cdf_lengths, self.gc.offsets)
            return {"strings": [y_string, z_string], "shape": shape}

        return list(self._pool.map(one, range(z_sym.shape[0])))

    # -------------------------------------------------------------- decode

    def _decode_slice(self, dec, idx):
        return dec.decode_stream(idx, self.gc.quantized_cdfs,
                                 self.gc.cdf_lengths, self.gc.offsets)

    def _upload(self, syms: np.ndarray):
        """NHWC int symbols -> int16 NCHW (channels_last) on the device."""
        t = torch.from_numpy(np.ascontiguousarray(syms, np.int16))
        return t.to(self.device).permute(0, 3, 1, 2)

    def decompress_chain(self, compressed: Sequence[dict],
                         tail_parallel: bool = True):
        """Generator form of the decode slice loop for a batch of
        same-shaped streams: yields right after each device step, returns
        the device-resident y_hat (B, M, H/8, W/8) as its StopIteration
        value.  tail_parallel: see the module docstring."""
        batch = len(compressed)
        zh, zw = compressed[0]["shape"]
        if any(tuple(c["shape"]) != (zh, zw) for c in compressed):
            raise ValueError("decompress requires same-shaped streams")
        t = self.eb_tables
        c = t["quantized_cdfs"].shape[0]
        z_indexes = np.broadcast_to(np.arange(c, dtype=np.int32),
                                    (1, zh, zw, c))

        def decode_z(b):
            return rans.decode_with_indexes(
                compressed[b]["strings"][1], z_indexes, t["quantized_cdfs"],
                t["cdf_lengths"], t["offsets"])

        z_sym = np.concatenate(list(self._pool.map(decode_z, range(batch))))
        decoders = [rans.RansDecoder(cc["strings"][0]) for cc in compressed]
        n, s = self.num_slices, self.max_support
        tail = n - s if tail_parallel and n > s else 0
        serial = n - tail
        y_hats: List = []
        # native decoder state is freed when the chain ends, raises, or is
        # closed by drive_chains after a sibling chain raised
        try:
            with self._scope():
                z_hat = self._upload(z_sym).float() + self._medians
                lm, ls = self._hyper(z_hat)
                mu, index = self._stats(lm, ls, [], 0)
                index = index.to(torch.uint8)
            yield
            for i in range(serial):
                idx_np = _to_host(index)
                syms = list(self._pool.map(
                    lambda b: self._decode_slice(decoders[b],
                                                 idx_np[b:b + 1]),
                    range(batch)))
                with self._scope():
                    sym = self._upload(np.concatenate(syms))
                    y_prev = self._finish(lm, y_hats[:s], sym, mu, i)
                    y_hats.append(y_prev)
                    if i + 1 < serial:
                        mu, index = self._stats(lm, ls, y_hats[:s], i + 1)
                        index = index.to(torch.uint8)
                    elif tail:
                        tail_stats = [self._stats(lm, ls, y_hats[:s], j)
                                      for j in range(s, n)]
                        idx_tail = torch.stack(
                            [ix.to(torch.uint8) for _, ix in tail_stats])
                yield
            if tail:
                # one fetch for every tail slice's indexes; each image's
                # stream decodes its whole tail back to back on a thread
                idxs_np = np.stack([_to_host(ix) for ix in idx_tail])

                def decode_tail(b):
                    return np.stack([self._decode_slice(
                        decoders[b], idxs_np[j, b:b + 1]) for j in range(tail)])

                syms = list(self._pool.map(decode_tail, range(batch)))
                tail_syms = np.concatenate(syms, axis=1)  # (tail, B, ...)
                with self._scope():
                    sup = y_hats[:s]
                    for j, (mu_j, _) in enumerate(tail_stats):
                        y_hats.append(self._finish(
                            lm, sup, self._upload(tail_syms[j]), mu_j, s + j))
                yield
            with self._scope():
                return torch.cat(y_hats, dim=1)
        finally:
            for dec in decoders:
                dec.close()

    def decode_image(self, y_hat, mask=None, device: bool = False):
        """Synthesis transform of a decoded latent (gated by the mask
        pyramid of ``mask`` for the RGB codec), clipped to [0, 1]; NHWC,
        a device tensor with device=True, else a host array."""
        with self._scope():
            if self.kind == "rgb":
                md = mask_pyramid(self._nchw(mask))
                x = self.model.decode_latent(y_hat, md[1], md[2])
            else:
                x = self.model.decode_latent(y_hat)
            x = torch.clamp(x, 0.0, 1.0).permute(0, 2, 3, 1)
            return x if device else x.cpu().numpy()

    def decompress_batch(self, compressed: Sequence[dict], mask=None,
                         device: bool = False, tail_parallel: bool = True):
        """Batched decompress of same-shaped streams: the slice loop runs
        once for the whole batch, then the synthesis transform."""
        (y_hat,) = drive_chains([self.decompress_chain(
            list(compressed), tail_parallel=tail_parallel)])
        return self.decode_image(y_hat, mask=mask, device=device)

    def decompress_batch_with_latent(self, compressed: Sequence[dict],
                                     mask=None, tail_parallel: bool = True):
        """decompress_batch that also returns the decoded latent y_hat
        (host arrays: NHWC x_hat, NCHW y_hat)."""
        (y_hat,) = drive_chains([self.decompress_chain(
            list(compressed), tail_parallel=tail_parallel)])
        return (self.decode_image(y_hat, mask=mask),
                y_hat.float().cpu().numpy())

    def compress(self, image=None, mask=None) -> dict:
        """One image: RGB compress(image, mask), mask codec compress(mask=)."""
        lead = image if self.kind == "rgb" else mask
        if lead.shape[0] != 1:
            raise ValueError("compress expects batch 1; use compress_batch")
        return self.compress_batch(image=image, mask=mask)[0]

    def decompress(self, compressed: dict, mask=None) -> np.ndarray:
        return self.decompress_batch([compressed], mask=mask)
