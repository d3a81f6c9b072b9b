#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts, and is right, on one GPU.

    python3 chip_smoke.py [--batch 16] [--iters 5]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), nvcc, g++ and PyTorch built for CUDA.  Phases, each fatal on
failure:

1. card and build: prints the card's name and power limit (nvidia-smi),
   builds every CUDA kernel of the port from ``rgba_tpu_torch/csrc`` (one
   nvcc per source, all started together) and, beside them, the host rANS
   coder from ``rgba_tpu_torch/native/rans.cpp`` with g++; then the card's
   health canary (``utils/health.chip_health``: bf16 8192^3
   ``torch.matmul`` TF/s by CUDA events, a host fetch's ms, the share of
   the healthy rate);
2. kernels: each conv kernel at the main paths' shapes (batch 16, 512x768), in
   fp32 and bf16, against its plain PyTorch version on the same inputs
   within the printed tolerance (attention also fed a zeroed and a
   transposed rel_bias, which that check must fail); times the kernel
   (its weights laid out once, as the owning module keeps them, GDN's
   gamma_t too; the layout's own time is printed beside), the plain
   version, one
   PyTorch library call of the same function (a yardstick the port never
   calls) and the bound (the larger of bytes over 3.35 TB/s and operations
   over the H100 SXM peak for their type: bf16 at 989 TFLOP/s, fp32 as
   3xTF32 at 3 x operations / 495 TFLOP/s, with the bound at the CUDA
   cores' 67 TFLOP/s printed beside); then the codec's 3x3 stride-1
   kernel (``conv3x3_cases``) at TCM's and the paper codec's shapes
   (batch 16 at H/2, H/4, H/8 and a slice transform's H/16; the paper's
   slice transforms at H/8; the sticker's, batch 1 at 64x64) under the
   codec's flags: within twice cuDNN's per-image fp32 error of a float64
   convolution (the same with the taps mirrored must fail), image 0 alone
   the same bits as in the batch, and its ms against the per-image cuDNN
   route it replaces, one cuDNN call over the batch and the bound;
3. forward: ``RGBAPipeline`` at batch 16, 512x768, bf16 with all four
   kernels on: shapes, finiteness, the launch count of each kernel in one
   forward, images/s (kernels on, then off, twice each), one profiled
   forward (device time by kernel, device busy share); images/s and the
   launch counts of the default serving route (``SERVE_POLICY``: bf16 with
   the attention kernel only) on the same weights; then fp32 with the
   kernels on against fp32 with them off (TF32 off) on x_hat and bpp;
   then ``SERVE_INT8_POLICY`` (dynamic W8A8 convolutions, ``ops/quant.py``)
   on the same weights: shapes, finiteness, 4 attention launches; the
   int32 accumulators of the first convolution of each geometry on the
   path (5x5 s2, the 5x5 s2 deconvolution, 3x3, 1x1, the 1- and
   3-channel inputs and outputs) equal to the float64 convolution of the
   same int8 operands, and each convolution's ms against cuDNN's bf16
   convolution of the same shape, with its bound (int8 at 1979 TOP/s);
   x_hat within 0.08 relative L2 of the fp32 forward (the JAX package's
   gate), and the same forward with the weight scale left out of the
   dequantize, which must fail it; img/s of serve-int8, ``SERVE_POLICY``
   and bf16 with all kernels by ``utils/benchmark.device_time``, in turns;
   one profiled int8 forward, its device ms by stage (quantize, im2col,
   ``torch._int_mm``, dequantize, the rest);
4. codec: ``RGBAFileCodec`` over two ``CodecIO`` at batch 16, 512x768,
   fp32 with all four kernels on, uint8 RGBA in and out: launch counts of
   one encode + decode, byte-identical re-encode, blob 0 alone and the
   first 8 blobs decoded apart against their decode in the batch (the same
   uint8), the decoded RGB against
   the fp32 RGB codec forward on the same masked input and decoded alpha,
   real bpp from the blob bytes, encode / decode / round-trip images/s
   (the four kernels on, then off, twice each; the conv3x3 kernel, which
   has no switch, runs in both: 214 launches an encode, 155 a decode) and
   one profiled round trip.  Then
   the serving options on the same codec: lane streams (container version
   3, decoded on the card by the ``rans_decode`` kernel): launches of one
   encode and of one decode (1 + 10 RGB and 1 + 5 mask ``rans_decode``),
   byte-identical re-encode, blob 0 alone against the batch, the decode
   equal to the v64 decode of the same images; the kernel against the
   plain ``decode_segment`` on the RGB z segment and the first y slice
   (symbols, state and pointer bit for bit), every RGB stream against the
   host C++ ``decode_lanes``, and a stream with one flipped word, which
   must decode differently; the kernel's ms per launch with its bound,
   the plain version's and the host coder's; decode images/s of v3
   against v64 and one profiled v3 decode.  Rate-gated containers
   (version 2): byte-identical re-encode, blob 0 alone, real bpp beside
   version 1's.  Previews at max_slices 0, 5 and 10 (10 equal to the full
   decode, 5 the same for v3 as for v64).  The throughput options:
   ``PipelinedCodec`` round trips (depth 2) of 2 batches from seeds 10-11
   against the serial loop (depth 1), v64 and v3, byte-identical blobs,
   equal decodes and the same launches per batch, images/s of each;
   ``decode_batch`` of 8 blobs with interleave 1 and 2 (equal, images/s);
   a bucketed encode of the 496x752 images on a 576x832 canvas (decodes to
   496x752, re-encodes byte for byte, blob 0 alone as in the batch, bpp
   beside the minimal canvas's); the v64 encode's whole-batch fetch of
   symbols and indexes (ms) beside the encode's wall.  The device lane
   encode (``RGBA_TPU_DEVICE_ENCODE=1``, the ``rans_encode`` kernel): (a)
   on the model with the encoders' gain at 3 (under the word budget): blobs
   byte-identical to the host coder's, 17 launches (1 + 10 RGB, 1 + 5
   mask), no overflow, every segment's state, pointer and words equal to
   the plain ``encode_segment``, every RGB stream equal to the host C++
   ``encode_lanes``, a changed symbol changes the words; the kernel's ms
   per launch (RGB y slice 0 and z) with its bound, the plain version's
   and the host coder's, v3 encode images/s of the device and host
   routes; (b) on the live weights (21 bpp): the RGB lanes overflow their
   budget and the card codes the segments again with room for the
   longest lane (11 launches more, 6 more if the mask codec's lanes
   overflow too), to the host coder's bytes;
5. eval and CLI entry points, at the Kodak size (512x768), full width, on
   the live weights saved with the port's ``save_checkpoint``: a synthetic
   Kodak tree of 8 images; ``evaluate_kodak(real_codec=True)`` with all
   four kernels on (fp32) and with them off (the launches of one eval step,
   4 / 12 / 8 / 2, of one image's encode + decode, 4 / 15 / 10 / 3, and of
   the whole eval, which adds the RGB forward that codec_err reads; the
   conv3x3 kernel on both routes, 369 an encode + decode, 102 the forward;
   the
   averages on against off: bpp 1e-4 relative, PSNR and psnr_real 0.01 dB,
   MS-SSIM 1e-4; codec_err by ``eval.kodak.hold_codec_err``: below 6e-3
   on average, and <= 1e-5 on each route or, where a value within fp32
   noise of a rounding boundary rounded apart in the eval step's forward
   and the codec, each image's decoded RGB within one 8-bit level of the
   forward on the container's inputs and within 1e-5 of it but for a bulk
   (mean |d| <= 1e-4, at most 0.1% of the values off by more than 1e-3),
   and its decoded alpha against the eval step's (mean |d| <= 1e-3, at
   most 5% of the pixels off by more than 1e-3: a desynced stream moves
   most); the time per
   image of the eval step and of the codec); ``cli.codec`` encode-dir / decode-dir
   of 16 RGBA PNGs at ``-b 8``, v64 and lanes32 (every blob equal to
   ``encode_batch``'s, every PNG to the JAX CLI's pixels of
   ``decode_batch``'s float decode, clipped, times 255 and truncated,
   2 x 17 ``rans_decode`` launches in the lanes32 decode-dir, 2 x 255 /
   2 x 155 ``conv3x3`` in the v64 / lanes32 one; img/s of each
   command); ``cli.train_rgb``: 2 steps from a config in a temporary
   directory, ``iter_2.ckpt``, read back by ``--test`` over the tree;
   ``torch.export`` of the bf16 ``RGBAPipeline`` at batch 16, under
   ``SERVE_POLICY`` and with all four kernels: saved, loaded and run in a
   fresh process that imports only ``rgba_tpu_torch.ops.kernels`` (x_hat
   within the bf16 gate of eager, 2^-5 x max(1, max|x_hat|), bpp 1e-3
   relative; the same artifact with one weight moved must fail that gate;
   the kernels' launches of one call), and img/s of eager against the
   exported program in this process, in turns;
6. train: the full-width codecs on synthetic 256x256 RGBA at batch 8
   (train_lambda 1024, aux_lr 1e-3, no curriculum).  First each kernel
   against its plain version, as in phase 2, at the shapes this path gives
   it (GDN M=131072; attention 512 windows of N=64 and of N=16; the gate
   chain at 64x64 and 32x32; the DSE at 256x256 with cio 3 and with cio 1
   and LeakyReLU), in bf16 and fp32.  fp32, TF32 off: one training loss and
   its gradients with the kernels on against off, on the same weights and
   noise seed, for ``RGBCodec`` and ``MaskCodec`` (loss within 1e-4
   relative; per parameter mean |dg| <= 1e-4 * mean |g| + 1e-7; at most 2
   latents that the two routes round to different integers; every gradient
   present and finite; the plain route's gap to its own second run, cuDNN's
   unordered sums, is printed beside), with the launch counts of one forward + backward
   (the forward's, none more in backward).  bf16: ``RGBTrainer`` and
   ``MaskTrainer`` take 20 steps through ``Trainer.train`` with the
   kernels on and with them off on the same data; every loss finite, the
   mean of the last 5 below the mean of the first 5; the losses of steps
   1-3 within 1% of each other for both trainers and the RGB final losses
   within 5% (the mask codec's later steps are too rough for that: its
   final gap is printed); launches per run; steps/s and images/s (through
   ``Trainer.train``, and compute only) and peak memory of each run; one
   profiled RGB step with the kernels off, for the device time the two
   routes take; 20 fp32 ``MaskTrainer`` steps with the kernels on and off
   (the loss gap of each step printed, steps 1-3 held to 1%).  After the
   last bf16 step the stepped ``WindowAttention``
   modules must hold the kernel layout of their new weights and agree with
   their plain path (a stale layout would train silently wrong).  Then one
   profiled RGB step, and its forward and backward apart;
7. data parallel: ``parallel.distributed.initialize()`` from torchrun's
   variables at world size 1 over NCCL; 3 bf16 ``RGBTrainer`` steps
   (batch 8, 256x256) under ``DistributedDataParallel`` against the same
   steps without it (losses within 1e-6 relative; the plain run's gap to
   its own second run printed) (the dry run's ranks against a single
   process run in phase 8, banded);
   ``RGBAFileCodec`` over two ``CodecIO(sharding=)`` on a two-replica mesh
   of cuda:0 (fp32, kernels on, batch 16, 512x768): blobs byte-identical
   to the unsharded codec's, the decode equal, twice the codec's kernel
   launches, enc+dec img/s of both (one card shows correctness, not
   scaling).
8. height sharding (``parallel/spatial.py``), two ranks on cuda:0: the
   probes of the transports (NCCL refuses two ranks on one device; gloo's
   send and recv of CUDA tensors, which the exchange therefore stages
   through the host); each conv kernel against its plain version at the
   shapes a band and its halo give it (the first band of S=2 and an
   interior band of S=4: gate chains on 67 / 35 and 38 / 22 rows, the DSE
   on 262 and 140, the attention on a band's windows with the band's and
   the last band's region ids, GDN on a band's pixels), bf16 and fp32;
   ``RGBAPipeline`` with all four kernels on bands of 256 rows (S=2, batch
   8 per rank, 512x768, the forward's live weights) on two gloo ranks
   against the unbanded pipeline: bf16 x_hat within the bf16 gate, fp32
   within the bulk gate and bpp 1e-4, 4 / 12 / 8 / 2 launches per rank;
   per-rank peak memory against the unbanded run, bytes and host seconds
   of the exchanges per forward, img/s of the space group (one card shows
   correctness, not scaling), one profiled banded forward; then one fp32
   ``RGBTrainer`` step with the kernels on over the two ranks (batch 4,
   256x256) against one process (``dryrun_multichip``'s bounds, 4 / 6 /
   4 / 1 launches per rank).
9. the trained-weight workflow (``rgba_tpu_torch/tools/_common.py``):
   ``MaskTrainer`` and ``RGBTrainer`` (bf16, all four kernels on, lambda
   1024) take 100 steps each at batch 8, 256x256, on 32 synthetic images
   held on the card (launches 0 / 6 / 4 / 1 and 4 / 6 / 4 / 1 per step;
   the mean loss of the last 10 steps below that of the first 10); the
   crash-resume check of each (checkpoint, one step on a fixed batch with
   a seeded noise generator, a fresh trainer loading the checkpoint takes
   the same step: losses within 1e-4 relative); then the trained pair in
   the fp32 codec: ``evaluate_kodak(real_codec=True)`` over 2 synthetic
   512x768 images (bpp, real_bpp, psnr, psnr_real, codec_err; 0.5 x bpp <
   real_bpp < 1.5 x bpp + 0.1, ``tools/full_workflow_proof.check_point``;
   codec_err by the eval phase's rules; 2 x
   (4 / 12 / 8 / 2 + 4 / 15 / 10 / 3 + 4 / 6 / 4 / 1) launches) and a
   byte-identical re-encode of both images.

The line before the last is one JSON object with every kernel's numbers
(the four conv kernels' headline cases are bf16 forward shapes; the
``rans_decode`` entry's are the first y slice of the v3 RGB decode, the
``rans_encode`` entry's that of the device v3 encode, the ``conv3x3``
entry's TCM's H/2 256->256 at batch 16);
the last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.

    python3 chip_smoke.py --only space [--iters 3]
    python3 chip_smoke.py --only workflow

builds the kernels and runs phase 8 or phase 9 alone (its result, not the
ok line).

    python3 chip_smoke.py --base DIR [--iters 20]

compares the kernels of another checkout DIR (for example a parent commit
unpacked with ``git archive``) with this one's on the same card: each
tree builds its kernels and runs its own ``gdn_cases``,
``attention_cases``, ``gate_chain_cases`` and ``dse_cases`` (the main
paths' shapes, bf16 and fp32), and times its ``rans_decode`` and
``rans_encode`` on the RGB z segment, on y slice 0 and on the 11 RGB
segments back to back that this tree records from a v3 decode and a
device v3 encode (``rans_ab_inputs``, the same inputs for both trees,
each launch held to the recorded outputs bit for bit), in a process of
its own, in turns base, head, head, base; both trees are timed with this
tree's ``_time_ms``, and the rANS cases also without holding the card
(``hold=False``, so that the host's gaps between launches count).  It
prints each case's kernel time per turn (about 8 minutes with the
builds).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_BF16 = 989e12                   # dense bf16 tensor cores
PEAK_TF32 = 495e12                   # dense TF32 tensor cores
PEAK_FP32_CUDA_CORES = 67e12         # fp32 outside the tensor cores
BF16_TOL = 2.0 ** -5                 # x max|ref|: 4 bf16 ulps at the largest value
FP32_TOL = 2e-5                      # atol = rtol, as the CPU parity tests


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


HOLD_CYCLES = 50_000_000   # ~25 ms of the card spinning (torch.cuda._sleep)


@functools.lru_cache(maxsize=None)
def _device_time():
    """This checkout's ``device_time`` (``rgba_tpu_torch/utils/benchmark.py``,
    which imports nothing of the package), loaded from its file: ``--base``
    times another checkout's kernels with it, and that checkout's package
    may have none."""
    path = REPO / "rgba_tpu_torch" / "utils" / "benchmark.py"
    spec = importlib.util.spec_from_file_location("_smoke_benchmark", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_time


def _time_ms(torch, fn, iters: int, hold: bool = True) -> float:
    """Mean device time of fn() over `iters` calls after two warm-ups, by
    ``device_time`` (CUDA events, one synchronize at the end).  With
    ``hold`` the card is held busy while the host enqueues the calls, so a
    kernel shorter than its launch's host work is timed, not the host;
    without it the gaps between launches count too."""
    return 1e3 * _device_time()(fn, [()], iters=iters, warmup=2,
                                device="cuda",
                                hold_cycles=HOLD_CYCLES if hold else 0)


# The rANS kernels' chain bound: a lane's steps depend on each other through
# its state, so a segment takes at least its longest lane's active steps
# times the shortest dependent path of one step, at the card's top SM
# clock.  The paths, read from csrc/rans_{decode,encode}.cu with Hopper's
# latencies (an integer ALU op or multiply 4 cycles, a shared-memory load
# 29): decode, the cum mask, bucket index and address (3 ops), the bucket
# load, the frequency (2), the state multiply-add (1), the renorm compare
# and select (2); encode, the renorm compare and select (2), the quotient's
# __umulhi, subtract, shift, add and shift (5), the state multiply-add (1).
ALU_CYCLES, LDS_CYCLES = 4, 29
RANS_CHAIN_CYCLES = {"rans_decode": 8 * ALU_CYCLES + LDS_CYCLES,
                     "rans_encode": 8 * ALU_CYCLES}


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def _chain_bound(act, kernel: str) -> dict:
    """The chain bound of one segment launch: ``act`` (T, B, L) its active
    flags."""
    steps = int(act.sum(0).max())
    clock = _max_sm_clock_hz()
    cycles = RANS_CHAIN_CYCLES[kernel]
    return {"chain_bound_ms": steps * cycles / clock * 1e3,
            "chain_steps": steps, "chain_cycles_per_step": cycles,
            "sm_clock_mhz": clock / 1e6}


def _bound(nbytes: float, flops: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for their type.  fp32
    operations run on the tensor cores as 3xTF32 (three TF32 products per
    fp32 product, as all four kernels take them), so their
    bound is 3 x operations / 495 TFLOP/s (``bound_3xtf32_ms``); the bound
    at the CUDA cores' 67 TFLOP/s is kept beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3

    def larger(t_ops):
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    if dtype == "bfloat16":
        t, by = larger(flops / PEAK_BF16 * 1e3)
        return {"bound_ms": t, "bound_by": by}
    t, by = larger(3.0 * flops / PEAK_TF32 * 1e3)
    return {"bound_ms": t, "bound_by": by, "bound_3xtf32_ms": t,
            "bound_cuda_cores_ms": larger(flops / PEAK_FP32_CUDA_CORES * 1e3)[0]}


def _bound_text(res: dict) -> str:
    text = f"bound_ms {res['bound_ms']:.4f} ({res['bound_by']})"
    if "bound_3xtf32_ms" in res:
        text += (f" [3xTF32 on the tensor cores; CUDA cores "
                 f"{res['bound_cuda_cores_ms']:.4f}]")
    return text


def _within(torch, got, want, dtype: str):
    """(within tolerance, max_abs_err, max_rel_err, the tolerance)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = max(1.0, float(want.abs().max()))
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    if dtype == "float32":
        ok = bool((err <= FP32_TOL + FP32_TOL * want.abs()).all())
        tol = f"{FP32_TOL:g} + {FP32_TOL:g}*|ref|"
    else:
        ok = max_abs <= BF16_TOL * scale
        tol = f"{BF16_TOL * scale:.4g}"
    return ok, max_abs, max_rel, tol


def _check(torch, got, want, dtype: str, what: str) -> dict:
    ok, max_abs, max_rel, tol = _within(torch, got, want, dtype)
    print(f"  {what}: max_abs_err {max_abs:.3g} max_rel_err {max_rel:.3g} "
          f"tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def _must_differ(torch, got, want, dtype: str, what: str) -> None:
    """The check above must fail a kernel fed a wrong input: else it could
    not see that input go missing or astray."""
    ok, max_abs, _, tol = _within(torch, got, want, dtype)
    print(f"  {what}: max_abs_err {max_abs:.3g} tol {tol} -> "
          f"{'FAIL (the check cannot see it)' if ok else 'seen'}")
    if ok:
        raise AssertionError(f"{what}: within tolerance of the right output")


def gdn_cases(torch, batch: int, iters: int, h: int = 512, w: int = 768):
    """GDN at a path's largest site (H/2 of batch h x w images, C=192)."""
    from rgba_tpu_torch.ops.kernels import gdn as k
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    c = 192
    m = batch * (h // 2) * (w // 2)
    cases = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        x = torch.randn(m, c, generator=g).to(dev, dt)
        gt = (0.1 * torch.eye(c) + 1e-3 * torch.rand(c, c, generator=g)).to(dev)
        beta = (1.0 + 0.1 * torch.rand(c, generator=g)).to(dev)
        gt_dt, beta_dt = gt.to(dt), beta.to(dt)
        # gamma_t's kernel layout, which the GDN module builds once
        prep = k.kernel_weights(gt, dt)
        for inverse in (False, True):
            what = f"fused_gdn {'inverse ' if inverse else ''}M={m} C={c} {dtype}"
            res = _check(torch, k.fused_gdn(x, gt, beta, inverse, prep),
                         k.gdn_plain(x, gt, beta, inverse), dtype, what)

            def library():
                n = torch.addmm(beta_dt, x * x, gt_dt)
                return x * (torch.sqrt(n) if inverse else torch.rsqrt(n))

            nbytes = 2 * m * c * es + c * c * es + 4 * c
            res.update(
                shape=f"M={m},C={c},{'inverse' if inverse else 'forward'}",
                dtype=dtype,
                ms=_time_ms(torch, lambda: k.fused_gdn(x, gt, beta, inverse, prep),
                            iters),
                layout_ms=_time_ms(torch, lambda: k.kernel_weights(gt, dt), iters),
                plain_ms=_time_ms(torch, lambda: k.gdn_plain(x, gt, beta, inverse), iters),
                library_ms=_time_ms(torch, library, iters),
                **_bound(nbytes, 2.0 * m * c * c, dtype))
            print(f"    ms {res['ms']:.4f} (gamma layout, once per weights: "
                  f"{res['layout_ms']:.4f}) plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} {_bound_text(res)}")
            cases.append(res)
        del x
    return cases


def attention_cases(torch, batch: int, iters: int, h: int = 512,
                    w: int = 768):
    """Window attention at both shapes of a path over batch h x w images,
    with the shifted region ids and the alive gate that its alpha gives."""
    import torch.nn.functional as F
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.ops import window
    from rgba_tpu_torch.ops.kernels import win_attn as k
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    alpha = torch.from_numpy(
        synthetic_rgba_batch(batch, h, w, seed=0)["alpha"]).to(dev)
    pyr = mask_pyramid(alpha.permute(0, 3, 1, 2))
    cases = []
    # (level, window, shift, C): H/4 8x8 windows at C=192, H/8 4x4 at C=80
    for level, ws, ss, c in ((1, 8, 4, 192), (2, 4, 2, 80)):
        a = torch.roll(pyr[level].permute(0, 2, 3, 1), (-ss, -ss), (1, 2))
        lh, lw = a.shape[1:3]
        alive = window.window_alive(window.window_partition(a, ws))[:, None]
        region = torch.from_numpy(window.swin_region_ids(lh, lw, ws, ss)).to(
            dev).repeat(batch, 1)
        nw, n, nh = alive.shape[0], ws * ws, 8
        n_alive = int(alive.sum())
        print(f"  windows at C={c}: {nw}, alive {n_alive} "
              f"({100.0 * n_alive / nw:.1f}%)")
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            es = torch.tensor([], dtype=dt).element_size()
            args = [torch.randn(nw, n, c, generator=g).to(dev, dt), region,
                    alive,
                    (torch.randn(c, 3 * c, generator=g) / c ** 0.5).to(dev, dt),
                    (0.1 * torch.randn(3 * c, generator=g)).to(dev),
                    (torch.randn(c, c, generator=g) / c ** 0.5).to(dev, dt),
                    (0.1 * torch.randn(c, generator=g)).to(dev),
                    torch.randn(nh, n, n, generator=g).to(dev)]
            what = f"fused_window_attention nW={nw} N={n} C={c} {dtype}"
            # the weights' kernel layout, which WindowAttention builds once
            wts = k.kernel_weights(*args[3:7], nh, dt)
            want = k.window_attention_plain(*args, num_heads=nh)
            res = _check(torch, k.fused_window_attention(
                *args, num_heads=nh, prepared=wts), want, dtype, what)
            # rel_bias at unit scale moves the output by far more than the
            # tolerance: a kernel that drops or transposes it fails the check
            rb = args[-1]
            for wrong, t in (("zeroed", torch.zeros_like(rb)),
                             ("transposed", rb.transpose(1, 2).contiguous())):
                _must_differ(torch, k.fused_window_attention(
                    *args[:-1], t, num_heads=nh), want, dtype,
                    f"  the same with rel_bias {wrong}")
            tokens, _, _, wq, bq, wp, bp, rb = args
            mask = (rb[None] + torch.where(
                region[:, None, :, None] != region[:, None, None, :],
                -100.0, 0.0)).to(dt)
            bq_dt, bp_dt = bq.to(dt), bp.to(dt)

            def library():
                qkv = torch.matmul(tokens, wq) + bq_dt
                qkv = qkv.reshape(nw, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
                o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                                   attn_mask=mask)
                o = o.transpose(1, 2).reshape(nw, n, c)
                return (torch.matmul(o, wp) + bp_dt) * alive.to(dt)[:, :, None]

            flops = n_alive * (2.0 * n * c * 3 * c + 4.0 * n * n * c
                               + 2.0 * n * c * c)
            nbytes = (n_alive * n * c * es + nw * n * c * es + n_alive * n * 4
                      + nw * 4 + 4 * c * c * es + 16 * c + nh * n * n * 4)
            res.update(
                shape=f"nW={nw},N={n},C={c},heads={nh},alive={n_alive}",
                dtype=dtype,
                ms=_time_ms(torch, lambda: k.fused_window_attention(
                    *args, num_heads=nh, prepared=wts), iters),
                layout_ms=_time_ms(torch, lambda: k.kernel_weights(
                    *args[3:7], nh, dt), iters),
                plain_ms=_time_ms(torch, lambda: k.window_attention_plain(
                    *args, num_heads=nh), iters),
                library_ms=_time_ms(torch, library, iters),
                **_bound(nbytes, flops, dtype))
            print(f"    ms {res['ms']:.4f} (weight layout, once per weights: "
                  f"{res['layout_ms']:.4f}) plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} {_bound_text(res)}")
            cases.append(res)
    return cases


def _bias_noise(torch, module, seed: int) -> None:
    """Random init leaves conv biases at 0: seeded noise exercises them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.add_((0.1 * torch.randn(p.shape, generator=g)).to(p.device))


def _cl(torch, t):
    return t.contiguous(memory_format=torch.channels_last)


def gate_chain_cases(torch, batch: int, iters: int, height: int = 512,
                     width: int = 768):
    """The gate chain at both sites of a path over batch height x width
    images (C=192 at H/4, C=80 at H/8) in both flavours: WinGate (GELU, post-act, separate g) and
    Simplified (ReLU, g = x).  The library yardstick is the module's own
    path with the kernel flag off (cuDNN convs)."""
    from rgba_tpu_torch.core.precision import Policy, precision_scope
    from rgba_tpu_torch.ops import attention as att
    from rgba_tpu_torch.ops.kernels import gate_chain as k

    dev = torch.device("cuda")
    cases = []
    for c, h, w in ((192, height // 4, width // 4),
                    (80, height // 8, width // 8)):
        for flavour in ("wingate", "simplified"):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                es = torch.tensor([], dtype=dt).element_size()
                policy = Policy(compute_dtype=dt)
                gen = torch.Generator().manual_seed(3)
                kw = dict(policy=policy, device=dev, generator=gen)
                if flavour == "wingate":
                    m = att.WinGateAttention(c, 8, 8, 0, **kw)
                    act, post = policy.gelu_kind, True
                else:
                    m = att.SimplifiedAttention(c, **kw)
                    act, post = "relu", False
                _bias_noise(torch, m, 4)
                x = _cl(torch, torch.randn(batch, c, h, w, generator=gen)
                        .to(dev, dt))
                g = (_cl(torch, torch.randn(batch, c, h, w, generator=gen)
                         .to(dev, dt)) if flavour == "wingate" else None)
                # fp32: TF32 off, so the cuDNN yardstick is full fp32 too
                with torch.inference_mode(), precision_scope(policy):
                    wts = m.gate_chain_weights()
                    prep = m.kernel_layout(dt)     # once per weights
                    xr = x.permute(0, 2, 3, 1).contiguous()
                    gr = None if g is None else g.permute(0, 2, 3, 1).contiguous()
                    args = (xr, gr, *wts, act, post)
                    what = (f"fused_gate_chain {flavour} B={batch} {h}x{w} "
                            f"C={c} {dtype}")
                    res = _check(torch, k.fused_gate_chain(*args, prep),
                                 k.gate_chain_plain(*args), dtype, what)

                    if flavour == "wingate":
                        def library():
                            return x + m.conv_a(x) * torch.sigmoid(m.conv_b(g))
                    else:
                        def library():
                            return m(x)
                    pix = batch * h * w
                    flops = pix * 41.0 * c * c
                    nweights = 2 * 3 * (c * c + 9 * c * c / 4) + c * c
                    nbytes = ((3 if g is not None else 2) * pix * c * es
                              + nweights * es + 4 * (2 * 3 * (2 * c) + c))
                    res.update(
                        shape=f"{flavour},B={batch},{h}x{w},C={c}",
                        dtype=dtype,
                        ms=_time_ms(torch, lambda: k.fused_gate_chain(
                            *args, prep), iters),
                        layout_ms=_time_ms(torch, lambda: k.kernel_weights(
                            *wts, dt), iters),
                        plain_ms=_time_ms(torch, lambda: k.gate_chain_plain(
                            *args), iters),
                        library_ms=_time_ms(torch, library, iters),
                        **_bound(nbytes, flops, dtype))
                print(f"    ms {res['ms']:.4f} (weight layout, once per weights: "
                      f"{res['layout_ms']:.4f}) plain_ms {res['plain_ms']:.4f} "
                      f"library_ms {res['library_ms']:.4f} {_bound_text(res)}")
                cases.append(res)
                del m, x, g, args, prep
    return cases


def dse_cases(torch, batch: int, iters: int, h: int = 512, w: int = 768):
    """The DSE tail at full resolution (batch h x w images): cio=3 ReLU (RGB decoder)
    and cio=1 LeakyReLU (mask decoder).  Library yardstick: the module's
    plain path (cuDNN convs)."""
    from rgba_tpu_torch.core.precision import Policy, precision_scope
    from rgba_tpu_torch.ops.enhance import DSE
    from rgba_tpu_torch.ops.kernels import dse as k

    dev = torch.device("cuda")
    cases = []
    for cio, leaky in ((3, False), (1, True)):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            es = torch.tensor([], dtype=dt).element_size()
            gen = torch.Generator().manual_seed(5)
            policy = Policy(compute_dtype=dt)
            m = DSE(cio, leaky=leaky, policy=policy, device=dev, generator=gen)
            _bias_noise(torch, m, 6)
            x = _cl(torch, torch.rand(batch, cio, h, w, generator=gen)
                    .to(dev, dt))
            with torch.inference_mode(), precision_scope(policy):
                args = (x.permute(0, 2, 3, 1).contiguous(), *m.kernel_weights())
                prep = m.kernel_layout(dt)         # once per weights
                what = f"fused_dse B={batch} {h}x{w} cio={cio} {dtype}"
                res = _check(torch, k.fused_dse(*args, leaky=leaky,
                                                prepared=prep),
                             k.dse_plain(*args, leaky=leaky), dtype, what)
                pix = batch * h * w
                flops = pix * (4.0 * cio * 32 + 6 * 2.0 * 9 * 32 * 32)
                nbytes = (2 * pix * cio * es + (2 * cio * 32 + 6 * 9 * 1024) * es
                          + 4 * (32 + 6 * 32 + cio))
                res.update(
                    shape=f"cio={cio},B={batch},{h}x{w}", dtype=dtype,
                    ms=_time_ms(torch, lambda: k.fused_dse(
                        *args, leaky=leaky, prepared=prep), iters),
                    layout_ms=_time_ms(torch, lambda: k.kernel_weights(
                        *args[1:], dt), iters),
                    plain_ms=_time_ms(torch, lambda: k.dse_plain(
                        *args, leaky=leaky), iters),
                    library_ms=_time_ms(torch, lambda: m(x), iters),
                    **_bound(nbytes, flops, dtype))
            print(f"    ms {res['ms']:.4f} (weight layout, once per weights: "
                  f"{res['layout_ms']:.4f}) plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} {_bound_text(res)}")
            cases.append(res)
            del m, x, args, prep
    return cases


# (what, batch, H, W, Cin, Cout) of the 3x3 stride-1 convolutions the
# codecs run on the conv3x3 kernel: TCM at 512x768 (g_a / g_s at H/2, H/4
# and H/8, a subpel convolution, g_s's last, a slice transform at H/16),
# the paper codec's slice transforms at H/8 (512x768) and the sticker's
# first slice transform (batch 1, 512x512); batch None is --batch
CONV3X3_SHAPES = (
    ("tcm H/2 256", None, 256, 384, 256, 256),
    ("tcm H/2 128", None, 256, 384, 128, 128),
    ("tcm H/4 256", None, 128, 192, 256, 256),
    ("tcm H/8 256", None, 64, 96, 256, 256),
    ("tcm H/4 subpel", None, 128, 192, 256, 1024),
    ("tcm H/2 out 12", None, 256, 384, 256, 12),
    ("tcm slice H/16", None, 32, 48, 576, 224),
    ("paper slice in", None, 64, 96, 120, 224),
    ("paper slice mid", None, 64, 96, 224, 128),
    ("paper slice out", None, 64, 96, 128, 8),
    ("sticker slice in", 1, 64, 64, 120, 224),
)


def conv3x3_cases(torch, batch: int, iters: int):
    """The 3x3 stride-1 fp32 kernel (``ops/kernels/conv3x3.py``) at the
    codecs' shapes (``CONV3X3_SHAPES``), under the codec's flags (TF32
    off, deterministic cuDNN, ``batch_invariant_scope``).  Held, on the
    first two images, to a float64 convolution within twice the error of
    what it replaces, cuDNN's fp32 convolution one image at a time
    (``per_image(F.conv2d)``); the same check must fail the kernel fed
    the weights with their taps mirrored; image 0 alone must give the
    bits it gives in the batch.  Times the kernel (its weights laid out
    once, as ``Conv`` keeps them; the layout's own time beside), the
    per-image cuDNN route it replaces (plain_ms), one cuDNN call over the
    whole batch (library_ms, a yardstick the codec never calls) and the
    bound."""
    import torch.nn.functional as F
    from rgba_tpu_torch.core.precision import (DEFAULT_POLICY,
                                               batch_invariant_scope,
                                               deterministic_scope,
                                               precision_scope)
    from rgba_tpu_torch.ops.conv import per_image
    from rgba_tpu_torch.ops.kernels import conv3x3 as k

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    cases = []
    with torch.inference_mode(), precision_scope(DEFAULT_POLICY), \
            deterministic_scope(), batch_invariant_scope():
        for what, b, h, w, ci, co in CONV3X3_SHAPES:
            b = batch if b is None else b
            x = _cl(torch, torch.randn(b, ci, h, w, device=dev, generator=g))
            wt = torch.randn(co, ci, 3, 3, device=dev,
                             generator=g) / (9 * ci) ** 0.5
            bias = 0.1 * torch.randn(co, device=dev, generator=g)
            prep = k.kernel_weights(wt)                # once per weights
            name = f"conv3x3 {what} B={b} {h}x{w} {ci}->{co} float32"
            got = k.conv3x3(x, wt, bias, prep)
            cudnn = per_image(lambda t: F.conv2d(t, wt, bias, 1, 1), x)
            n = min(b, 2)
            ref = F.conv2d(x[:n].double(), wt.double(), bias.double(), 1, 1)
            err = float((got[:n].double() - ref).abs().max())
            err_cudnn = float((cudnn[:n].double() - ref).abs().max())
            ok = err <= 2.0 * err_cudnn
            print(f"  {name}: max_abs_err vs float64 {err:.3g}, cuDNN's "
                  f"{err_cudnn:.3g} (tol 2x cuDNN's) -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: further from float64 than "
                                     f"twice cuDNN's error")
            mirrored = k.conv3x3(x[:n], wt, bias,
                                 k.kernel_weights(wt.flip(-1)))
            wrong = float((mirrored.double() - ref).abs().max())
            blind = wrong <= 2.0 * err_cudnn
            print(f"    the same with the taps mirrored: max_abs_err "
                  f"{wrong:.3g} -> "
                  f"{'FAIL (the check cannot see it)' if blind else 'seen'}")
            if blind:
                raise AssertionError(f"{name}: mirrored taps within "
                                     f"tolerance")
            if not torch.equal(k.conv3x3(x[:1], wt, bias, prep), got[:1]):
                raise AssertionError(f"{name}: image 0 alone differs from "
                                     f"image 0 in the batch")
            del ref, mirrored, cudnn
            flops = 2.0 * b * h * w * co * 9 * ci
            nbytes = 4 * (b * h * w * (ci + co) + 2 * 9 * ci * co + co)
            res = dict(
                shape=f"{what},B={b},{h}x{w},{ci}->{co}", dtype="float32",
                max_abs_err=err, cudnn_max_abs_err=err_cudnn,
                ms=_time_ms(torch, lambda: k.conv3x3(x, wt, bias, prep),
                            iters),
                layout_ms=_time_ms(torch, lambda: k.kernel_weights(wt),
                                   iters),
                plain_ms=_time_ms(torch, lambda: per_image(
                    lambda t: F.conv2d(t, wt, bias, 1, 1), x), iters),
                library_ms=_time_ms(torch, lambda: F.conv2d(
                    x, wt, bias, 1, 1), iters),
                tf32_bound_ms=flops / PEAK_TF32 * 1e3,
                **_bound(nbytes, flops, "float32"))
            print(f"    ms {res['ms']:.4f} (weight layout, once per weights: "
                  f"{res['layout_ms']:.4f}) per-image cuDNN (plain_ms) "
                  f"{res['plain_ms']:.4f} library_ms {res['library_ms']:.4f} "
                  f"{_bound_text(res)}; operations at the TF32 peak "
                  f"{res['tf32_bound_ms']:.4f} ms, "
                  f"{100.0 * res['tf32_bound_ms'] / res['ms']:.1f}% of it")
            cases.append(res)
            del x, got, prep
    return cases


def _liven(torch, pipe, seed: int = 1, gain: float = 10.0) -> None:
    """Random init leaves the latents within one quantization bin of the
    prior's mean (std ~0.05) and x_hat below 0, so every rate is the same
    constant and the clipped output is all 0.  Seeded bias noise, the DSE
    output biases at 0.5 and a gain of 10 on both encoders' last 1x1 conv
    give latents that span several bins, rates that depend on them and
    x_hat inside [0, 1]: the checks below then compare something."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith(".bias"):
                p.add_((0.02 * torch.randn(p.shape, generator=g)).to(p.device))
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(gain)
        pipe.mask_codec.EncoderMask[7].weight.mul_(gain)


def profile_run(torch, fn, what: str, top: int = 15, spans=()) -> dict:
    """One call of fn under torch.profiler: device time by kernel and the
    share of the call's wall time the device was busy.  The profiler's own
    overhead lengthens the wall time, so the share is a lower bound.
    ``spans``: names of ``record_function`` ranges whose device time (the
    kernels launched inside them) is returned under "spans"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): an aten op's device time
    # is the sum of its kernels', so counting both would count twice
    cuda = torch.autograd.DeviceType.CUDA
    # (an optimizer's step is annotated on the device timeline as well: its
    # span covers its kernels, which are counted themselves)
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")),
                  key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    print(f"  profiled {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100.0 * busy_ms / wall_ms:.1f}%)")
    for name, count, ms in rows[:top]:
        print(f"    {ms:9.3f} ms {100.0 * ms / max(busy_ms, 1e-9):5.1f}% "
              f"x{count:<4d} {name[:90]}")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "top": [{"name": n, "calls": c, "ms": m} for n, c, m in rows[:top]]}
    if spans:
        cpu = torch.autograd.DeviceType.CPU
        out["spans"] = {e.key: e.device_time_total / 1e3
                        for e in prof.key_averages()
                        if e.key in spans and e.device_type == cpu}
    return out


KERNEL_NAMES = ("fused_window_attention", "fused_gdn", "fused_gate_chain",
                "fused_dse", "rans_decode", "rans_encode", "conv3x3")
CONV_KERNELS = KERNEL_NAMES[:4]


def _launch_counts(attn, gdn, gate_chain, dse, rans=0, rans_encode=0,
                   conv3x3=0):
    return dict(zip(KERNEL_NAMES, (attn, gdn, gate_chain, dse, rans,
                                   rans_encode, conv3x3)))


# The conv3x3 kernel runs only inside the codec's steps
# (``batch_invariant_scope``), once per ``Conv`` call of its class whatever
# the batch, with the four kernels on or off (their plain paths keep
# cuDNN): in the paper's codec 214 calls an encode and 155 a decode (the
# RGB and mask slice transforms, 9 a slice step, and the hyper syntheses'
# stride-1 layers), 102 in an RGB codec forward under the codec's scope
# (the Kodak eval's codec_err reference); a v64 decode of 4, 6 or 8 images
# runs the RGB decode as two chains (``interleave=None`` picks 2), each
# with its own hyper synthesis and slice steps: 100 more
CONV3X3_ENCODE, CONV3X3_DECODE, CONV3X3_RGB_FORWARD = 214, 155, 102
CONV3X3_RGB_CHAIN = 100
CONV3X3_CODEC = CONV3X3_ENCODE + CONV3X3_DECODE
FORWARD_LAUNCHES = _launch_counts(4, 12, 8, 2)
SERVE_LAUNCHES = _launch_counts(4, 0, 0, 0)
CODEC_LAUNCHES = _launch_counts(4, 15, 10, 3, conv3x3=CONV3X3_CODEC)
# the codec with the four kernels off: the conv3x3 kernel still runs
CODEC_FOUR_OFF_LAUNCHES = _launch_counts(0, 0, 0, 0, conv3x3=CONV3X3_CODEC)
# lane streams (v3): the mask decode inside the encode takes 1 + 5 rANS
# segments, the decode 1 + 10 (RGB) and 1 + 5 (mask)
LANE_ENCODE_RANS, LANE_DECODE_RANS = 6, 17
LANE_LAUNCHES = _launch_counts(4, 15, 10, 3,
                               LANE_ENCODE_RANS + LANE_DECODE_RANS,
                               conv3x3=CONV3X3_CODEC)
# the device lane encode of a v3 container (RGBA_TPU_DEVICE_ENCODE=1): 1 + 10
# RGB and 1 + 5 mask segments
LANE_ENCODE_SEGMENTS = 17
ENCODE_GAIN = 3.0   # encode_phase (a): the encoders' gain (_liven's is 10)
# one training forward + backward (the backward launches no kernel)
MAX_FLIPS = 2      # latents the two fp32 routes may round apart (train phase)
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS = 8, 256, 20


def _kernels():
    from rgba_tpu_torch.ops.kernels import (conv3x3, dse, gate_chain, gdn,
                                            rans_decode, rans_encode,
                                            win_attn)
    return dict(zip(KERNEL_NAMES, (win_attn.KERNEL, gdn.KERNEL,
                                   gate_chain.KERNEL, dse.KERNEL,
                                   rans_decode.KERNEL, rans_encode.KERNEL,
                                   conv3x3.KERNEL)))


def _all_kernels(policy):
    """``policy`` with the four conv kernels on (``packed_dse`` off so the
    DSE kernel runs), as the trained-weight tools run it."""
    from rgba_tpu_torch.tools._common import all_kernels
    return all_kernels(policy)


def _step_launches(kind: str) -> dict:
    """One training step's launches (the backward launches none), the
    tools' tables (``rgba_tpu_torch/tools/_common.py``), no rANS."""
    from rgba_tpu_torch.tools import _common as wf
    return dict(_launch_counts(0, 0, 0, 0),
                **(wf.RGB_STEP_LAUNCHES if kind == "rgb"
                   else wf.MASK_STEP_LAUNCHES))


def _reset_launches():
    for kern in _kernels().values():
        kern.launches = 0


def _read_launches(want: dict, what: str) -> dict:
    got = {name: kern.launches for name, kern in _kernels().items()}
    print(f"  launches in {what}: {got}")
    if got != want:
        raise AssertionError(f"{what}: expected launches {want}, got {got}")
    return got


def path_phase(torch, batch: int, iters: int) -> dict:
    from rgba_tpu_torch.core.precision import (BF16_POLICY, DEFAULT_POLICY,
                                               SERVE_POLICY)
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.models.pipeline import RGBAPipeline

    t0 = time.perf_counter()
    pipe = RGBAPipeline(_all_kernels(BF16_POLICY), seed=0)
    _liven(torch, pipe)
    state = pipe.state_dict()
    datas = [synthetic_rgba_batch(batch, 512, 768, seed=s) for s in range(2)]
    ins = [(torch.from_numpy(d["masked_image"]).cuda(),
            torch.from_numpy(d["alpha"]).cuda()) for d in datas]
    print(f"  set-up (weights, data) {time.perf_counter() - t0:.1f} s")

    pipe(*ins[1])                                   # warm-up (cuDNN set-up)
    torch.cuda.synchronize()
    _reset_launches()
    out = pipe(*ins[0])
    torch.cuda.synchronize()
    launches = _read_launches(FORWARD_LAUNCHES, "one forward")
    shapes = {"x_hat": (batch, 512, 768, 3), "recon_mask": (batch, 512, 768, 1)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key} shape {tuple(out[key].shape)} != {shape}")
    for key, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{key} is not finite")
    x_mean, x_std = float(out["x_hat"].mean()), float(out["x_hat"].std())
    print(f"  bpp {float(out['bpp']):.6f} (rgb {float(out['bpp_rgb']):.6f}, "
          f"mask {float(out['bpp_mask']):.6f}); x_hat mean {x_mean:.6f} "
          f"std {x_std:.6f}")
    if not (0.0 < x_mean < 1.0 and x_std > 0.0 and float(out["bpp_rgb"]) > 0):
        raise AssertionError("degenerate output: x_hat constant or rate 0")

    def img_per_s(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(iters):
            p(*ins[i % 2])
        torch.cuda.synchronize()
        return batch * iters / (time.perf_counter() - t)

    plain = RGBAPipeline(BF16_POLICY, seed=0)
    plain.load_state_dict(state)
    plain(*ins[1])
    # the default serving route: bf16, the attention kernel only
    serve = RGBAPipeline(SERVE_POLICY, seed=0)
    serve.load_state_dict(state)
    serve(*ins[1])
    torch.cuda.synchronize()
    _reset_launches()
    serve(*ins[0])
    torch.cuda.synchronize()
    serve_launches = _read_launches(SERVE_LAUNCHES, "one serving forward")
    fwd = {}
    for name, p in (("bf16 all kernels", pipe), ("bf16 plain", plain),
                    ("bf16 serve", serve), ("bf16 all kernels again", pipe),
                    ("bf16 plain again", plain), ("bf16 serve again", serve)):
        fwd[name] = img_per_s(p)
        print(f"  forward {name}: {fwd[name]:.3f} img/s "
              f"(batch {batch}, 512x768, {iters} iters)")
    profile = profile_run(torch, lambda: pipe(*ins[0]), "forward")
    del plain, pipe, serve

    # fp32, kernels on vs off, TF32 off (precision_scope): x_hat and bpp
    fp32_on = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    fp32_off = RGBAPipeline(DEFAULT_POLICY, seed=0)
    fp32_on.load_state_dict(state)
    fp32_off.load_state_dict(state)
    a, b = fp32_on(*ins[0]), fp32_off(*ins[0])
    bulk = _bulk_agreement(a["x_hat"], b["x_hat"], "fp32 kernels on vs off")
    bpp_rel = abs(float(a["bpp"]) - float(b["bpp"])) / abs(float(b["bpp"]))
    print(f"  fp32 bpp {float(a['bpp']):.7f} vs {float(b['bpp']):.7f} "
          f"(rel {bpp_rel:.3g})")
    if not (bulk["ok"] and bpp_rel <= 1e-4):
        raise AssertionError("fp32 pipeline with kernels disagrees with plain")
    return {"launches": launches, "serve_launches": serve_launches,
            "img_per_s": fwd, "profile": profile,
            "fp32_x_hat_max_abs": bulk["max_abs"],
            "fp32_x_hat_mean_abs": bulk["mean_abs"], "fp32_bpp_rel": bpp_rel}


def _bulk_agreement(a, b, what: str) -> dict:
    """A latent within fp32 noise of a half integer may round the other way
    and move x_hat locally; the bulk must agree: mean |d| <= 1e-4 and at
    most 1e-3 of the values off by more than 1e-3."""
    d = (a.float() - b.float()).abs()
    far = float((d > 1e-3).float().mean())
    out = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "share_above_1e-3": far}
    out["ok"] = out["mean_abs"] <= 1e-4 and far <= 1e-3
    print(f"  {what}: x_hat max_abs {out['max_abs']:.3g} mean_abs "
          f"{out['mean_abs']:.3g} share>1e-3 {far:.3g}")
    return out


def codec_phase(torch, batch: int, iters: int) -> dict:
    """The bitstream codec, fp32 with all four kernels on, against itself
    with them off and against the fp32 forward.  The conv3x3 kernel runs
    in the codec's steps on both routes."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid

    h, w = 512, 768
    t0 = time.perf_counter()
    on = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    _liven(torch, on)
    off = RGBAPipeline(DEFAULT_POLICY, seed=0)
    off.load_state_dict(on.state_dict())
    codecs = {p: RGBAFileCodec(CodecIO(m.rgb_codec, "rgb"),
                               CodecIO(m.mask_codec, "mask"))
              for p, m in (("on", on), ("off", off))}
    # 8-bit edges: uint8 RGBA in, uint8 RGBA out, as a serving user sends
    datas = [{k: np.round(v * 255.0).astype(np.uint8) for k, v in
              synthetic_rgba_batch(batch, h, w, seed=s).items()}
             for s in range(2)]
    print(f"  set-up (weights, tables, data) {time.perf_counter() - t0:.1f} s")
    codec = codecs["on"]
    img, alpha = datas[0]["image"], datas[0]["alpha"]

    t = time.perf_counter()
    blobs = codec.encode_batch(img, alpha)                  # warm-up
    codec.decode_batch(blobs, output="uint8")
    print(f"  first round trip (warm-up) {time.perf_counter() - t:.1f} s")

    _reset_launches()
    blobs = codec.encode_batch(img, alpha)
    rgba = codec.decode_batch(blobs, output="uint8")
    launches = _read_launches(CODEC_LAUNCHES, "one encode + decode")
    if rgba.shape != (batch, h, w, 4) or rgba.dtype != np.uint8:
        raise AssertionError(f"decode gave {rgba.shape} {rgba.dtype}")
    if codec.encode_batch(img, alpha) != blobs:
        raise AssertionError("re-encoding the same batch changed the bytes")
    print("  re-encode byte-identical: yes")
    # an image's decode must not depend on the batch it is decoded in
    for n in sorted({1, min(8, batch)}):
        part = codec.decode_batch(blobs[:n], output="uint8")
        if not np.array_equal(part, rgba[:n]):
            raise AssertionError(f"the first {n} blobs decoded apart differ "
                                 f"from their decode in the batch")
        print(f"  the first {n} blob(s) decoded apart: the same uint8 RGBA as "
              f"in the batch of {batch}")
    nbytes = sum(len(b) for b in blobs)
    bpp = nbytes * 8.0 / (batch * h * w)
    print(f"  real bpp {bpp:.6f} ({nbytes} bytes for {batch} images)")

    # the decoded RGB against the fp32 RGB codec forward on the same masked
    # input and decoded alpha (the reference round-trip check: 1e-5)
    dec = codec.decode_batch(blobs, output="float32")
    rgb_io = codec.rgb_io
    with rgb_io._scope():
        recon = torch.from_numpy(dec[..., 3:]).cuda().permute(0, 3, 1, 2)
        x = torch.from_numpy(img).cuda().float().permute(0, 3, 1, 2) / 255.0
        masked = torch.where(recon > 0, x, recon)
        fwd = rgb_io.model(masked, recon, recon, mask_pyramid(recon))
        want = torch.clamp(fwd["x_hat"], 0.0, 1.0).permute(0, 2, 3, 1)
    got = torch.from_numpy(dec[..., :3]).cuda()
    err0 = float((got[0] - want[0]).abs().max())
    print(f"  decoded RGB vs forward, image 0: max_abs {err0:.3g} (tol 1e-5)")
    bulk = _bulk_agreement(got, want, "decoded RGB vs forward, batch")
    forward_match = {"image0_max_abs": err0, "bulk": bulk,
                     "criterion": "max_abs <= 1e-5"}
    if err0 > 1e-5:
        forward_match["criterion"] = "bulk"
        print("  image 0 is off by more than 1e-5: a latent within fp32 noise "
              "of a half integer rounded the other way in the forward's "
              "own call; holding the batch to the bulk criterion instead")
        if not bulk["ok"]:
            raise AssertionError("decoded RGB disagrees with the forward")

    def rates(name, c, d):
        t = time.perf_counter()
        bl = c.encode_batch(d["image"], d["alpha"])
        te = time.perf_counter() - t
        t = time.perf_counter()
        c.decode_batch(bl, output="uint8")
        td = time.perf_counter() - t
        r = {"encode": batch / te, "decode": batch / td,
             "round_trip": batch / (te + td)}
        print(f"  codec {name}: encode {r['encode']:.3f} decode "
              f"{r['decode']:.3f} enc+dec {r['round_trip']:.3f} img/s "
              f"(batch {batch}, 512x768, fp32, conv3x3 on)")
        return r

    img_s = {}
    for rep in ("", " again"):
        for which in ("on", "off"):
            name = f"four kernels {which}{rep}"
            if which == "off" and not rep:
                rates("four kernels off (warm-up)", codecs["off"], datas[1])
            img_s[name] = rates(name, codecs[which], datas[(len(img_s)) % 2])
    profile = profile_run(torch, lambda: codec.decode_batch(
        codec.encode_batch(img, alpha), output="uint8"), "round trip")
    print("codec serving options (same codec, same images):")
    lanes = lane_phase(torch, codec, img, alpha, blobs, dec, iters)
    options = options_phase(torch, codec, img, alpha, blobs, dec)
    gated = gated_phase(torch, codec, img, alpha)
    print("codec throughput options (same codec):")
    throughput = throughput_phase(torch, codec, img, blobs)
    print("device lane encode (RGBA_TPU_DEVICE_ENCODE=1):")
    encode = encode_phase(torch, codec, img, alpha, iters)
    for c in codecs.values():
        c.rgb_io.close()
        c.mask_io.close()
    return {"launches": launches, "bpp": bpp, "bytes": nbytes,
            "forward_match": forward_match, "img_per_s": img_s,
            "profile": profile, "lanes": lanes, "options": options,
            "gated": gated, "throughput": throughput, "encode": encode}


@contextlib.contextmanager
def _recorded_segments(torch):
    """Keeps every ``rans_decode`` call's inputs (the lane state and pointer
    as they were before it) and outputs while the block runs."""
    from rgba_tpu_torch.ops.kernels import rans_decode as rd
    calls, wrapped = [], rd.rans_decode

    def record(tables, words, state, ptr, idx, act, lane_end, inverse=None):
        before = (state.clone(), ptr.clone())
        syms, st, pt = wrapped(tables, words, state, ptr, idx, act, lane_end,
                               inverse=inverse)
        calls.append({"tables": tables, "words": words, "state": before[0],
                      "ptr": before[1], "idx": idx, "act": act,
                      "lane_end": lane_end, "inverse": inverse, "syms": syms,
                      "state_out": st.clone(), "ptr_out": pt.clone()})
        return syms, st, pt

    rd.rans_decode = record
    try:
        yield calls
    finally:
        rd.rans_decode = wrapped


def _segment_bound(torch, call) -> dict:
    """Bytes one segment's decode must move, each once: the indexes (4 B),
    active flags (1 B) and symbols (4 B) of every position; the lane state
    (8 B) and pointer (4 B), read and written, and its end (4 B); the
    stream words the lanes consume (2 B); and the CDF rows the active
    positions address, at their length, with their max value and offset.
    The kernel's own tables (the compact layout each block stages, the
    buckets' copies of entries) are its design, not the function's, so
    they are not charged.  Bound by bytes: the work is a few integer
    operations per symbol.  Beside it the chain bound (``_chain_bound``)."""
    n_pos = call["idx"].numel()
    lanes = call["state"].numel()
    act = call["act"].bool()
    active = int(act.sum())
    words = int((call["ptr_out"] - call["ptr"]).sum())
    rows = torch.unique(call["idx"][act]).long()
    row_entries = int((call["tables"]["max_values"].long()[rows] + 2).sum())
    table_bytes = 4.0 * row_entries + 8.0 * rows.numel()
    nbytes = 9.0 * n_pos + 28.0 * lanes + 2.0 * words + table_bytes
    res = _bound(nbytes, 0.0, "float32")
    return {"bound_ms": res["bound_ms"], "bound_by": "bytes",
            "bytes": nbytes, "table_bytes": table_bytes,
            "rows": int(rows.numel()), "active_symbols": active,
            "shape": list(call["idx"].shape), "words_read": words,
            **_chain_bound(act, "rans_decode")}


def _replay(torch, calls, fn, words=None):
    """Decode the recorded segments again with ``fn`` from the first one's
    lane state (and ``words``, if given); returns each segment's
    (symbols, state, ptr)."""
    state, ptr = calls[0]["state"].clone(), calls[0]["ptr"].clone()
    out = []
    for c in calls:
        syms, state, ptr = fn(c["tables"], c["words"] if words is None
                              else words, state, ptr, c["idx"], c["act"],
                              c["lane_end"], inverse=c["inverse"])
        out.append((syms, state.clone(), ptr.clone()))
    return out


def lane_phase(torch, codec, img, alpha, blobs_v64, dec_v64, iters) -> dict:
    """Container version 3: lane streams, decoded on the card by the
    rans_decode kernel, held to the plain decode_segment, the host C++
    decoder and the v64 decode of the same images."""
    import numpy as np
    from rgba_tpu_torch.entropy import device_rans as dr
    from rgba_tpu_torch.eval.container import unpack_rgba
    from rgba_tpu_torch.native import rans
    from rgba_tpu_torch.ops.kernels import rans_decode as rd

    batch = img.shape[0]
    t = time.perf_counter()
    blobs = codec.encode_batch(img, alpha, stream_format="lanes32")  # warm-up
    codec.decode_batch(blobs)
    print(f"  v3 first round trip (warm-up) {time.perf_counter() - t:.1f} s")
    _reset_launches()
    blobs = codec.encode_batch(img, alpha, stream_format="lanes32")
    enc = {n: k.launches for n, k in _kernels().items()}
    with _recorded_segments(torch) as calls:
        dec = codec.decode_batch(blobs, output="float32")
    torch.cuda.synchronize()
    total = {n: k.launches for n, k in _kernels().items()}
    dec_only = {n: total[n] - enc[n] for n in KERNEL_NAMES}
    print(f"  launches in one v3 encode: {enc}; in its decode: {dec_only}")
    if total != LANE_LAUNCHES or dec_only["rans_decode"] != LANE_DECODE_RANS \
            or len(calls) != LANE_DECODE_RANS:
        raise AssertionError(f"v3 encode + decode: expected launches "
                             f"{LANE_LAUNCHES} ({LANE_DECODE_RANS} rans_decode "
                             f"in the decode), got {total}, {dec_only}")
    if codec.encode_batch(img, alpha, stream_format="lanes32") != blobs:
        raise AssertionError("re-encoding the v3 batch changed the bytes")
    print("  v3 re-encode byte-identical: yes")
    if not np.array_equal(codec.decode_batch(blobs[:1]), dec[:1]):
        raise AssertionError("v3 blob 0 decoded alone differs from the batch")
    print("  v3 blob 0 decoded alone: the same RGBA as in the batch")
    if not np.array_equal(dec, dec_v64):
        raise AssertionError("the v3 decode differs from the v64 decode of "
                             "the same images")
    print("  v3 decode equal to the v64 decode of the same images: yes")
    nbytes = sum(len(b) for b in blobs)
    bpp = nbytes * 8.0 / (batch * img.shape[1] * img.shape[2])
    print(f"  v3 real bpp {bpp:.6f} ({nbytes} bytes; v64 "
          f"{sum(len(b) for b in blobs_v64)} bytes)")

    # the kernel against the plain version: the RGB z segment (row search)
    # and its first y slice (the Gaussian rows), on the recorded inputs
    rgb = calls[-11:]                   # the mask chain decodes first
    checks, errs = {}, {}
    for name, call in (("z", rgb[0]), ("y slice 0", rgb[1])):
        def args():         # the kernel updates the lane state in place
            return (call["tables"], call["words"], call["state"].clone(),
                    call["ptr"].clone(), call["idx"], call["act"],
                    call["lane_end"])
        kern = rd.rans_decode(*args(), inverse=call["inverse"])
        plain = rd.rans_decode_plain(*args(), inverse=call["inverse"])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(kern, plain)) and \
            torch.equal(kern[0], call["syms"])
        errs[name] = int((kern[0].long() - plain[0].long()).abs().max())
        lay = call["tables"]["compact"]
        print(f"  rans_decode {name} ({tuple(call['idx'].shape)} steps x "
              f"images x lanes; rows {lay['rows'][0]}-{lay['rows'][1]} in "
              f"shared memory, buckets of 2^{lay['min_shift']}-2^"
              f"{lay['max_shift']} cums; plain: "
              f"{'inverse tables' if call['inverse'] is not None else 'row search'}): "
              f"symbols, state, pointer equal to the plain decode_segment: "
              f"{'yes' if same else 'NO'} (symbols max_abs_err {errs[name]})")
        if not same:
            raise AssertionError(f"rans_decode {name} differs from plain")
        checks[name] = _segment_bound(torch, call)

    # every RGB stream against the host C++ decoder
    metas = [unpack_rgba(b) for b in blobs]
    zh, zw = metas[0]["rgb"]["shape"]
    sizes = [zh * zw * 192] + [zh * zw * 64 * 8] * 10
    seg_ends = np.cumsum(sizes)
    tables = codec.rgb_io._lane_tables()["merged"]
    host_ms = 0.0
    for b, m in enumerate(metas):
        words, lnw = dr.parse_stream(m["rgb"]["stream"], m["rgb"]["lanes"])
        idx = np.concatenate([dr.from_steps(c["idx"][:, b], n).cpu().numpy()
                              for c, n in zip(rgb, sizes)])
        want = np.concatenate([dr.from_steps(c["syms"][:, b], n).cpu().numpy()
                               for c, n in zip(rgb, sizes)])
        t = time.perf_counter()
        host = rans.decode_lanes(words, lnw, idx, seg_ends, tables["cdfs"],
                                 tables["max_values"] + 2, tables["offsets"])
        host_ms += (time.perf_counter() - t) * 1e3
        if not np.array_equal(host, want):
            raise AssertionError(f"rans_decode of RGB stream {b} differs from "
                                 f"the host decode_lanes")
    print(f"  every RGB stream: the kernel's symbols equal the host C++ "
          f"decode_lanes ({batch} streams of {int(seg_ends[-1])} symbols; "
          f"host {host_ms:.3f} ms on one thread)")

    # a flipped word must change the symbols (and kernel and plain agree on
    # the corrupt stream: no lane reads past its end)
    bad = rgb[0]["words"].clone()
    bad[int(rgb[0]["ptr"][0, 0])] ^= 0x2AAA     # lane 0's first renorm word
    flipped = _replay(torch, rgb, rd.rans_decode, bad)
    changed = sum(int((f[0] != c["syms"]).sum()) for f, c in zip(flipped, rgb))
    plain_z = rd.rans_decode_plain(
        rgb[0]["tables"], bad, rgb[0]["state"].clone(), rgb[0]["ptr"].clone(),
        rgb[0]["idx"], rgb[0]["act"], rgb[0]["lane_end"])
    agree = all(torch.equal(a, b) for a, b in zip(flipped[0], plain_z))
    print(f"  one flipped stream word: {changed} symbols change (must be > 0); "
          f"kernel and plain agree on the corrupt z segment: "
          f"{'yes' if agree else 'NO'}")
    if not changed or not agree:
        raise AssertionError("the flipped-word check failed")

    # times: every launch starts from its own copy of the lane state, made
    # before the clock starts, so the events time the kernel alone
    def kernel_fn(call, n):
        fresh = [(call["state"].clone(), call["ptr"].clone())
                 for _ in range(n + 2)]          # _time_ms warms up twice

        def run():
            st, pt = fresh.pop()
            rd.rans_decode(call["tables"], call["words"], st, pt, call["idx"],
                           call["act"], call["lane_end"],
                           inverse=call["inverse"])
        return run

    for name, call in (("z", rgb[0]), ("y slice 0", rgb[1])):
        c = checks[name]
        c["ms"] = _time_ms(torch, kernel_fn(call, iters * 4), iters * 4)
        c["plain_ms"] = _time_ms(torch, lambda: rd.rans_decode_plain(
            call["tables"], call["words"], call["state"].clone(),
            call["ptr"].clone(), call["idx"], call["act"], call["lane_end"],
            inverse=call["inverse"]), 1)
        print(f"  rans_decode {name}: kernel {c['ms']:.4f} ms, plain "
              f"{c['plain_ms']:.3f} ms, {_bound_text(c)} ({c['bytes'] / 1e6:.3f}"
              f" MB, of which {c['table_bytes'] / 1e6:.3f} MB the {c['rows']} "
              f"CDF rows addressed; {c['active_symbols']} symbols), "
              f"{100.0 * c['bound_ms'] / c['ms']:.2f}% of the bound; chain "
              f"bound {c['chain_bound_ms']:.4f} ms ({c['chain_steps']} steps x "
              f"{c['chain_cycles_per_step']} cycles at {c['sm_clock_mhz']:.0f}"
              f" MHz), {100.0 * c['chain_bound_ms'] / c['ms']:.1f}% of it; "
              f"library: none")
    chain_ms = _time_ms(torch, lambda: _replay(torch, rgb, rd.rans_decode),
                        iters)
    print(f"  the 11 RGB segments back to back: {chain_ms:.3f} ms on the card "
          f"against {host_ms:.3f} ms for the host C++ decode_lanes of the "
          f"same {batch} streams")

    _reset_launches()
    preview = codec.decode_batch(blobs, max_slices=5)
    k5 = _kernels()["rans_decode"].launches
    if k5 != 12 or not np.array_equal(
            preview, codec.decode_batch(blobs_v64, max_slices=5)):
        raise AssertionError(f"v3 preview max_slices=5: {k5} rans_decode "
                             f"launches (want 1 + 5 RGB, 1 + 5 mask) or not "
                             f"the v64 preview")
    print("  v3 preview max_slices=5: 12 rans_decode launches, equal to the "
          "v64 preview")

    def rate(blob_list):
        t = time.perf_counter()
        codec.decode_batch(blob_list, output="uint8")
        return batch / (time.perf_counter() - t)

    rates = {}
    for rep in ("", " again"):
        for name, bl in (("v3", blobs), ("v64", blobs_v64)):
            rates[name + rep] = rate(bl)
            print(f"  decode {name}{rep}: {rates[name + rep]:.3f} img/s "
                  f"(batch {batch}, 512x768, fp32, uint8 out)")
    profile = profile_run(torch, lambda: codec.decode_batch(
        blobs, output="uint8"), "v3 decode", top=10)
    y0 = checks["y slice 0"]
    return {"launches": dec_only["rans_decode"], "encode_launches": enc,
            "decode_launches": dec_only,
            "bpp": bpp, "bytes": nbytes, "segments": checks,
            "rgb_chain_ms": chain_ms, "host_decode_lanes_ms": host_ms,
            "flipped_word_symbols_changed": changed,
            "decode_img_per_s": rates, "profile": profile,
            "max_abs_err": float(max(errs.values())), "ms": y0["ms"],
            "plain_ms": y0["plain_ms"],
            "bound_ms": y0["bound_ms"], "bound_by": y0["bound_by"]}


def options_phase(torch, codec, img, alpha, blobs_v64, dec_v64) -> dict:
    """Rate-gated containers (version 2) and the progressive preview."""
    import numpy as np
    from rgba_tpu_torch.eval.container import unpack_rgba

    batch, h, w = img.shape[:3]
    blobs = codec.encode_batch(img, alpha, rate_gate=True)
    if codec.encode_batch(img, alpha, rate_gate=True) != blobs:
        raise AssertionError("re-encoding the v2 batch changed the bytes")
    full = codec.decode_batch(blobs, output="uint8")
    if not np.array_equal(codec.decode_batch(blobs[:1], output="uint8"),
                          full[:1]):
        raise AssertionError("v2 blob 0 decoded alone differs from the batch")
    gate = np.stack([unpack_rgba(b)["rgb"]["gate"] for b in blobs])
    n2, n1 = sum(map(len, blobs)), sum(map(len, blobs_v64))
    bpp2, bpp1 = n2 * 8.0 / (batch * h * w), n1 * 8.0 / (batch * h * w)
    print(f"  v2 (rate gate): re-encode byte-identical, blob 0 alone as in "
          f"the batch; {100.0 * float(1 - gate.mean()):.2f}% of the latent "
          f"cells gated; real bpp {bpp2:.6f} ({n2} bytes) against v1 "
          f"{bpp1:.6f} ({n1} bytes)")
    previews = {}
    for k in (0, 5, 10):
        got = codec.decode_batch(blobs_v64, max_slices=k)
        diff = float(np.abs(got[..., :3] - dec_v64[..., :3]).mean())
        same = np.array_equal(got, dec_v64)
        if (k == 10) != same:
            raise AssertionError(f"preview k={k}: equal to the full decode: "
                                 f"{same}")
        previews[k] = {"mean_abs_rgb_vs_full": diff}
        print(f"  preview max_slices={k}: mean |RGB - full decode| {diff:.6f}"
              + (" (equal to the full decode)" if same else ""))
    return {"v2_bpp": bpp2, "v2_bytes": n2, "v1_bpp": bpp1, "v1_bytes": n1,
            "gated_share": float(1 - gate.mean()), "previews": previews}


def _cut_images(img, alpha):
    """The images less 16 rows and columns (512x768 -> 496x752), the first
    half of the batch opaque."""
    import numpy as np
    h, w = img.shape[1] - 16, img.shape[2] - 16
    img_c = np.ascontiguousarray(img[:, :h, :w])
    alpha_c = np.array(alpha[:, :h, :w])
    alpha_c[:img.shape[0] // 2] = 255
    return img_c, alpha_c


def gated_phase(torch, codec, img, alpha) -> dict:
    """The rate gate where cells really close.  The images lose 16 rows
    and columns (512x768 -> 496x752), so the /64 grid pads them with 16
    transparent pixels (the /8 gate pools 7 pixels around a cell), and the
    first half of the batch is
    opaque, so its decoded alpha is exactly 1 inside and 0 in the padding.
    Version 2 (the host decodes the alive cells) and version 3 (the
    kernel's active flags come from the shipped gate): each re-encodes to
    the same bytes and decodes a blob alone as in the batch, and the two
    decode to the same RGBA."""
    import numpy as np
    from rgba_tpu_torch.eval.container import unpack_rgba

    img_c, alpha_c = _cut_images(img, alpha)
    batch, h, w = img_c.shape[:3]
    res, decs, gates = {}, {}, {}
    for name, fmt, rans_want in (("v2", "v64", 0),
                                 ("v3", "lanes32", LANE_DECODE_RANS)):
        def encode():
            return codec.encode_batch(img_c, alpha_c, rate_gate=True,
                                      stream_format=fmt)
        blobs = encode()
        if encode() != blobs:
            raise AssertionError(f"re-encoding the gated {name} batch "
                                 f"changed the bytes")
        gate = np.stack([unpack_rgba(b)["rgb"]["gate"] for b in blobs])
        share = float(1.0 - gate.mean())
        if share <= 0.0:
            raise AssertionError(f"gated {name}: no latent cell is gated")
        _reset_launches()
        dec = codec.decode_batch(blobs, output="float32")
        k = _kernels()["rans_decode"].launches
        if k != rans_want or dec.shape != (batch, h, w, 4) \
                or not np.isfinite(dec).all():
            raise AssertionError(f"gated {name} decode: {k} rans_decode "
                                 f"launches (want {rans_want}), shape "
                                 f"{dec.shape}")
        for i in (0, batch - 1):
            if not np.array_equal(codec.decode_batch(blobs[i:i + 1]),
                                  dec[i:i + 1]):
                raise AssertionError(f"gated {name} blob {i} decoded alone "
                                     f"differs from the batch")
        n = sum(map(len, blobs))
        res[name] = {"gated_share": share, "bytes": n,
                     "bpp": n * 8.0 / (batch * h * w),
                     "rans_decode_launches": k}
        decs[name], gates[name] = dec, gate
        print(f"  gated {name} ({batch} x {h}x{w}, half opaque): "
              f"{100.0 * share:.2f}% of the latent cells gated; re-encode "
              f"byte-identical; blobs 0 and {batch - 1} alone as in the "
              f"batch; {k} rans_decode launches; real bpp "
              f"{res[name]['bpp']:.6f} ({n} bytes)")
    if not np.array_equal(gates["v2"], gates["v3"]) or \
            not np.array_equal(decs["v2"], decs["v3"]):
        raise AssertionError("the gated v3 decode differs from the gated v2 "
                             "decode of the same images")
    print("  gated v3 decode equal to the gated v2 decode: yes (same gate)")
    return res


STREAM_BATCHES = 2   # batches of the pipelined round trips


def throughput_phase(torch, codec, img, blobs_v64) -> dict:
    """The codec's throughput options on the live codec: PipelinedCodec
    (depth 2) round trips against the serial loop (depth 1), v64 and v3;
    decode with interleave 1 and 2; a bucketed encode; the encode's
    whole-batch fetch against its wall."""
    import numpy as np
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.eval.container import unpack_rgba
    from rgba_tpu_torch.eval.pipeline import PipelinedCodec

    batch, h, w = img.shape[:3]
    t = time.perf_counter()
    batches = []
    for s in range(STREAM_BATCHES):
        d = synthetic_rgba_batch(batch, h, w, seed=10 + s)
        batches.append((np.round(d["image"] * 255.0).astype(np.uint8),
                        np.round(d["alpha"] * 255.0).astype(np.uint8)))
    print(f"  {STREAM_BATCHES} batches of {batch} (seeds 10-"
          f"{9 + STREAM_BATCHES}) made in {time.perf_counter() - t:.1f} s")
    per_batch = {"v64": CODEC_LAUNCHES, "lanes32": LANE_LAUNCHES}
    res = {}
    for fmt in ("v64", "lanes32"):
        runs = {}
        for depth in (1, 2):
            pipe = PipelinedCodec(codec, depth=depth)
            _reset_launches()
            t = time.perf_counter()
            out = list(pipe.roundtrip_stream(iter(batches), output="uint8",
                                             stream_format=fmt))
            wall = time.perf_counter() - t
            pipe.close()
            launches = {n: k.launches for n, k in _kernels().items()}
            n = STREAM_BATCHES
            want = {k: n * v for k, v in per_batch[fmt].items()}
            if launches != want:
                raise AssertionError(f"{fmt} depth {depth}: launches "
                                     f"{launches}, want {n} x {per_batch[fmt]}")
            runs[depth] = {"out": out, "img_per_s": n * batch / wall,
                           "wall_s": wall}
            print(f"  roundtrip_stream {fmt} depth {depth}: "
                  f"{runs[depth]['img_per_s']:.3f} img/s ({n} x {batch}, "
                  f"{h}x{w}, fp32, uint8 out; {wall:.3f} s); launches {n} x "
                  f"the serial round trip's")
        for (b1, r1), (b2, r2) in zip(runs[1]["out"], runs[2]["out"]):
            if b1 != b2 or not np.array_equal(r1, r2):
                raise AssertionError(f"{fmt}: the pipelined round trip "
                                     f"differs from the serial loop")
        print(f"  {fmt}: pipelined blobs byte-identical and decodes equal "
              f"to the serial loop's")
        res[fmt] = {f"depth{d}_img_per_s": runs[d]["img_per_s"]
                    for d in (1, 2)}

    # interleaved decode chains
    blobs = blobs_v64[:8]
    outs, rates = {}, {}
    for g in (1, 2, 2, 1):
        t = time.perf_counter()
        outs[g] = codec.decode_batch(blobs, output="uint8", interleave=g)
        rates.setdefault(g, []).append(len(blobs) / (time.perf_counter() - t))
    if not np.array_equal(codec.decode_batch(blobs, interleave=1),
                          codec.decode_batch(blobs, interleave=2)):
        raise AssertionError("interleave=2 decodes differently from 1")
    for g in (1, 2):
        print(f"  decode_batch of 8 blobs, interleave={g}: "
              + " / ".join(f"{r:.3f}" for r in rates[g])
              + " img/s (float32 decodes of 1 and 2 exactly equal)")
    res["interleave_img_per_s"] = {str(g): rates[g] for g in (1, 2)}

    # a bucketed encode of the cut images, on the minimal canvas grown by 64
    # each way (576x832 for 496x752)
    img_c, alpha_c = _cut_images(*batches[0])
    bucket = (-(-img_c.shape[1] // 64) * 64 + 64,
              -(-img_c.shape[2] // 64) * 64 + 64)
    bl = codec.encode_batch(img_c, alpha_c, bucket=bucket)
    if codec.encode_batch(img_c, alpha_c, bucket=bucket) != bl:
        raise AssertionError("re-encoding the bucketed batch changed the bytes")
    metas = [unpack_rgba(b) for b in bl]
    dec = codec.decode_batch(bl, output="uint8")
    if dec.shape != img_c.shape[:3] + (4,) or \
            metas[0]["rgb"]["shape"] != (bucket[0] // 64, bucket[1] // 64):
        raise AssertionError(f"bucketed decode {dec.shape}, z shape "
                             f"{metas[0]['rgb']['shape']}")
    if not np.array_equal(codec.decode_batch(bl[:1], output="uint8"), dec[:1]):
        raise AssertionError("bucketed blob 0 decoded alone differs")
    plain = codec.encode_batch(img_c, alpha_c)
    npx = img_c.shape[0] * img_c.shape[1] * img_c.shape[2]
    bpp_b = sum(map(len, bl)) * 8.0 / npx
    bpp_p = sum(map(len, plain)) * 8.0 / npx
    print(f"  bucket {bucket} of {img_c.shape[1]}x{img_c.shape[2]} (half "
          f"opaque): decodes to {dec.shape[1:3]}, re-encode byte-identical, "
          f"blob 0 alone as in the batch; bpp {bpp_b:.6f} against "
          f"{bpp_p:.6f} on the minimal canvas")
    res["bucket"] = {"bucket": list(bucket), "bpp": bpp_b,
                     "bpp_minimal": bpp_p}

    # the v64 encode's one fetch of the whole batch (both codecs' symbols
    # and indexes to int32 host arrays) against the encode's wall: the most
    # a fetch split under the host coding could hide is half of it
    img0, alpha0 = batches[0]
    rgb_io, mask_io = codec.rgb_io, codec.mask_io
    dev = (rgb_io._compress_tensors(rgb_io._nchw(img0), rgb_io._nchw(alpha0))
           + mask_io._compress_tensors(mask_io._nchw(alpha0)))
    torch.cuda.synchronize()
    fetch_ms = []
    for _ in range(3):
        t = time.perf_counter()
        host = [a.cpu().numpy().astype(np.int32) for a in dev]
        fetch_ms.append((time.perf_counter() - t) * 1e3)
    nbytes = sum(a.numel() * a.element_size() for a in dev)
    enc_ms = []
    for _ in range(2):
        t = time.perf_counter()
        codec.encode_batch(img0, alpha0)
        enc_ms.append((time.perf_counter() - t) * 1e3)
    print(f"  v64 encode's whole-batch fetch ({nbytes / 1e6:.3f} MB on the "
          f"card, {sum(a.nbytes for a in host) / 1e6:.3f} MB as int32): "
          + " / ".join(f"{x:.3f}" for x in fetch_ms) + " ms, against "
          + " / ".join(f"{x:.3f}" for x in enc_ms) + " ms for the encode")
    res["fetch"] = {"bytes": nbytes, "fetch_ms": fetch_ms,
                    "encode_ms": enc_ms}
    return res


@contextlib.contextmanager
def _recorded_encodes(torch):
    """Keeps every ``rans_encode`` call's inputs (the lane state, pointer
    and words as they were before it) and outputs while the block runs."""
    from rgba_tpu_torch.ops.kernels import rans_encode as re_
    calls, wrapped = [], re_.rans_encode

    def record(tables, state, wptr, out, idx, sym, act):
        before = (state.clone(), wptr.clone(), out.clone())
        st, wp, ow = wrapped(tables, state, wptr, out, idx, sym, act)
        calls.append({"tables": tables, "state": before[0],
                      "wptr": before[1], "out": before[2], "idx": idx,
                      "sym": sym, "act": act, "state_out": st.clone(),
                      "wptr_out": wp.clone(), "out_out": ow.clone()})
        return st, wp, ow

    re_.rans_encode = record
    try:
        yield calls
    finally:
        re_.rans_encode = wrapped


def _encode_bound(torch, call) -> dict:
    """Bytes one segment's encode must move, each once: the indexes and
    symbols of every position in the types the path holds them in (uint8
    and int16 for a y slice, int32 and int16 for z) and its active flags
    (1 B); the lane state (8 B) and pointer (4 B), read and written; the
    16-bit words it emits (2 B); the CDF entries the active positions
    address (start and next, 4 B each) and their rows' max value and
    offset."""
    t = call["tables"]
    act = call["act"]
    idx = call["idx"].long()[act]
    maxv = t["max_values"].long()[idx]
    value = call["sym"].long()[act] - t["offsets"].long()[idx]
    value = torch.where((value < 0) | (value >= maxv), maxv, value)
    base = idx * t["cdfs"].shape[1] + value
    entries = int(torch.unique(torch.cat([base, base + 1])).numel())
    rows = int(torch.unique(idx).numel())
    words = int((call["wptr_out"] - call["wptr"]).sum())
    lanes = call["state"].numel()
    escapes = int((value == maxv).sum())
    per_step = call["idx"].element_size() + call["sym"].element_size() + 1
    nbytes = float(per_step * call["idx"].numel()) + 24.0 * lanes + \
        2.0 * words + 4.0 * entries + 8.0 * rows
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "words_emitted": words, "entries": entries,
            "rows": rows, "escapes": escapes,
            "active_symbols": int(act.sum()),
            "shape": list(call["idx"].shape),
            "dtypes": [str(call["idx"].dtype), str(call["sym"].dtype)],
            **_chain_bound(act, "rans_encode")}


def encode_phase(torch, live, img, alpha, iters) -> dict:
    """The device lane encode.  (a) Under budget: the codec with the
    encoders' gain at ENCODE_GAIN (same seed, bias noise and DSE bias):
    byte-identical to the host coder, 17 launches, no overflow, every
    segment bit for bit against the plain version, a changed symbol
    changes the words; times.  (b) The live codec (21 bpp): the RGB lanes
    overflow their budget, and the card codes the segments again with room
    for the longest lane, to the host coder's bytes."""
    import os
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.entropy import device_rans as dr
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.native import rans
    from rgba_tpu_torch.ops.kernels import rans_encode as re_

    batch, h, w = img.shape[:3]
    model = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    _liven(torch, model, gain=ENCODE_GAIN)
    codec = RGBAFileCodec(CodecIO(model.rgb_codec, "rgb"),
                          CodecIO(model.mask_codec, "mask"))

    def encode(c, route):
        os.environ["RGBA_TPU_DEVICE_ENCODE"] = route
        try:
            return c.encode_batch(img, alpha, stream_format="lanes32")
        finally:
            os.environ["RGBA_TPU_DEVICE_ENCODE"] = "0"

    host = encode(codec, "0")                   # warm-up, and the bytes
    encode(codec, "1")
    _reset_launches()
    with _recorded_encodes(torch) as calls:
        dev = encode(codec, "1")
    torch.cuda.synchronize()
    launches = _kernels()["rans_encode"].launches
    infos = {k: getattr(codec, f"{k}_io").last_lane_encode
             for k in ("rgb", "mask")}
    bpp = sum(map(len, dev)) * 8.0 / (batch * h * w)
    for k, i in infos.items():
        print(f"  (a) {k}: {i['lanes']} lanes, budget {i['budget']} words, "
              f"largest lane {i['max_nwords'] - 2} words "
              f"({'OVERFLOW' if i['overflow'] else 'within'})")
    print(f"  (a) encoder gain {ENCODE_GAIN:g}: v3 real bpp {bpp:.6f}; "
          f"{launches} rans_encode launches (want {LANE_ENCODE_SEGMENTS})")
    if launches != LANE_ENCODE_SEGMENTS or len(calls) != LANE_ENCODE_SEGMENTS \
            or any(i["overflow"] for i in infos.values()):
        raise AssertionError("the device encode under budget: wrong launch "
                             "count or an overflow")
    if dev != host:
        raise AssertionError("the device encode's blobs differ from the host "
                             "coder's")
    print("  (a) RGBA_TPU_DEVICE_ENCODE=1 blobs byte-identical to =0: yes")

    # every segment against the plain version, from the same inputs
    worst = 0
    for i, c in enumerate(calls):
        plain = re_.rans_encode_plain(c["tables"], c["state"].clone(),
                                      c["wptr"].clone(), c["out"].clone(),
                                      c["idx"], c["sym"], c["act"])
        got = (c["state_out"], c["wptr_out"], c["out_out"])
        diffs = [int((a.long() - b.long()).abs().max()) for a, b in
                 zip(got, plain)]
        worst = max(worst, *diffs)
        if any(diffs):
            raise AssertionError(f"rans_encode segment {i} differs from the "
                                 f"plain version: {diffs}")
    print(f"  (a) all {len(calls)} segments: state, pointer and words equal "
          f"to the plain encode_segment (max |d| {worst})")

    # the mask codec encodes first (5 y slices, z), then the RGB codec: y
    # slice 9 down to 0, then z
    rgb = calls[-11:]
    y0, z = rgb[9], rgb[10]

    # a changed symbol must change the finished words (the last steps coded
    # may change only the final state, the first two words of each lane)
    def finished(st, wp, ow):
        return dr.finish_lanes(st, wp, ow)[0]
    sym = y0["sym"].clone()
    sym[5, -1, 7] += 1
    changed = re_.rans_encode(y0["tables"], y0["state"].clone(),
                              y0["wptr"].clone(), y0["out"].clone(),
                              y0["idx"], sym, y0["act"])
    torch.cuda.synchronize()
    if torch.equal(finished(*changed), finished(
            y0["state_out"], y0["wptr_out"], y0["out_out"])):
        raise AssertionError("a changed symbol left the words unchanged")
    print("  (a) one symbol changed in y slice 0: the words change")

    # times: each launch from its own copies of the lane state and words,
    # made before the clock starts
    segs = {}
    for name, c in (("y slice 0", y0), ("z", z)):
        res = _encode_bound(torch, c)
        n = iters * 4
        fresh = [(c["state"].clone(), c["wptr"].clone(), c["out"].clone())
                 for _ in range(n + 2)]

        def run():
            s_, w_, o_ = fresh.pop()
            re_.rans_encode(c["tables"], s_, w_, o_, c["idx"], c["sym"],
                            c["act"])
        res["ms"] = _time_ms(torch, run, n)
        res["plain_ms"] = _time_ms(torch, lambda: re_.rans_encode_plain(
            c["tables"], c["state"].clone(), c["wptr"].clone(),
            c["out"].clone(), c["idx"], c["sym"], c["act"]), 1)
        segs[name] = res
        print(f"  rans_encode {name} ({tuple(c['idx'].shape)} steps x images "
              f"x lanes, {res['active_symbols']} symbols, {res['escapes']} "
              f"escapes, {res['words_emitted']} words): kernel "
              f"{res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms, "
              f"{_bound_text(res)} ({res['bytes'] / 1e6:.3f} MB), "
              f"{100.0 * res['bound_ms'] / res['ms']:.2f}% of the bound; "
              f"chain bound {res['chain_bound_ms']:.4f} ms "
              f"({res['chain_steps']} steps x {res['chain_cycles_per_step']} "
              f"cycles at {res['sm_clock_mhz']:.0f} MHz), "
              f"{100.0 * res['chain_bound_ms'] / res['ms']:.1f}% of it; "
              f"library: none")

    # the host C++ coder on the same 16 RGB streams (its symbols as the
    # kernel took them), and its bytes against the kernel's words
    rgb_calls = rgb[::-1]               # z, y 0..9: decode order
    lanes = infos["rgb"]["lanes"]
    n_z = int(codec.rgb_io.eb_tables["quantized_cdfs"].shape[0]) * \
        (h // 64) * (w // 64)
    sizes = [n_z] + [(h // 8) * (w // 8) * 8] * 10
    seg_ends = np.cumsum(sizes)
    m = codec.rgb_io._lane_tables()["merged"]
    words, nwords, _ = dr.finish_lanes(z["state_out"], z["wptr_out"],
                                       z["out_out"])
    words, nwords = words.cpu().numpy(), nwords.cpu().numpy()
    host_ms = 0.0
    for b in range(batch):
        def flat(key):
            return np.concatenate([dr.from_steps(c[key][:, b], n).cpu()
                                   .numpy() for c, n in zip(rgb_calls, sizes)])
        sym_b, idx_b, act_b = flat("sym"), flat("idx"), flat("act")
        t = time.perf_counter()
        hw, lnw = rans.encode_lanes(sym_b, idx_b, seg_ends, lanes, m["cdfs"],
                                    m["max_values"] + 2, m["offsets"],
                                    alive=act_b)
        host_ms += (time.perf_counter() - t) * 1e3
        mine = words[b][np.arange(words.shape[-1]) < nwords[b][:, None]]
        if not (np.array_equal(nwords[b], lnw) and np.array_equal(mine, hw)):
            raise AssertionError(f"RGB stream {b}: kernel words differ from "
                                 f"the host encode_lanes")
    print(f"  (a) every RGB stream: the kernel's words equal the host C++ "
          f"encode_lanes ({batch} streams of {int(seg_ends[-1])} symbols; "
          f"host {host_ms:.3f} ms on one thread)")
    def chain():
        # the 11 segments in their order, the lane state passed on, from
        # one copy of the first one's (a word buffer of ~17 MB at batch 16)
        c0 = rgb[0]
        st, wp, ow = (c0[k].clone() for k in ("state", "wptr", "out"))
        for c in rgb:
            st, wp, ow = re_.rans_encode(c["tables"], st, wp, ow, c["idx"],
                                         c["sym"], c["act"])
    chain_ms = _time_ms(torch, chain, iters)
    print(f"  the 11 RGB segments back to back: {chain_ms:.3f} ms on the "
          f"card against {host_ms:.3f} ms for the host C++ encode_lanes of "
          f"the same {batch} streams")

    rates = {}
    for route in ("1", "0", "0", "1"):
        t = time.perf_counter()
        encode(codec, route)
        rates.setdefault("device" if route == "1" else "host", []).append(
            batch / (time.perf_counter() - t))
    print(f"  v3 encode img/s (batch {batch}, {h}x{w}, fp32): device route "
          + " / ".join(f"{r:.3f}" for r in rates["device"]) + ", host route "
          + " / ".join(f"{r:.3f}" for r in rates["host"]))

    # (b) the live weights overflow the budget: the card codes the segments
    # again with room for the longest lane, to the host coder's bytes
    want = encode(live, "0")
    _reset_launches()
    got = encode(live, "1")
    k = _kernels()["rans_encode"].launches
    over = {n: getattr(live, f"{n}_io").last_lane_encode
            for n in ("rgb", "mask")}
    passes = {n: 2 if i["overflow"] else 1 for n, i in over.items()}
    k_want = 11 * passes["rgb"] + 6 * passes["mask"]
    for n, i in over.items():
        print(f"  (b) live weights (encoder gain 10), {n}: budget "
              f"{i['budget']} words, largest lane {i['max_nwords'] - 2} "
              f"words -> " + (f"overflow, coded again on the card with "
                              f"{i['rerun_budget']} words" if i["overflow"]
                              else "no overflow"))
    print(f"  (b) {k} rans_encode launches (want {k_want}); bytes equal to "
          f"=0: {'yes' if got == want else 'NO'}")
    if not over["rgb"]["overflow"] or k != k_want or got != want:
        raise AssertionError("(b): the overflowing encode did not code again "
                             "on the card to the host coder's bytes")
    rates_b = {}
    for route in ("1", "0", "0", "1"):
        t = time.perf_counter()
        encode(live, route)
        rates_b.setdefault("device" if route == "1" else "host", []).append(
            batch / (time.perf_counter() - t))
    print(f"  (b) v3 encode img/s at 21 bpp: device route (two passes) "
          + " / ".join(f"{r:.3f}" for r in rates_b["device"]) + ", host route "
          + " / ".join(f"{r:.3f}" for r in rates_b["host"]))
    del codec, model
    return {"launches": launches, "max_abs_err": float(worst),
            "bpp": bpp, "lanes": infos, "segments": segs,
            "rgb_chain_ms": chain_ms, "host_encode_lanes_ms": host_ms,
            "encode_img_per_s": rates, "overflow_case": over,
            "overflow_launches": k, "overflow_img_per_s": rates_b,
            "ms": segs["y slice 0"]["ms"],
            "plain_ms": segs["y slice 0"]["plain_ms"],
            "bound_ms": segs["y slice 0"]["bound_ms"]}


# the eval step launches what one forward does (FORWARD_LAUNCHES); the
# real-codec branch adds one encode + decode and the RGB codec forward it
# checks the decode against (4 attention, 6 GDN, 4 gate chains, 1 DSE, and
# conv3x3, which runs in the codec's scope)
CODEC_FORWARD_LAUNCHES = _launch_counts(4, 6, 4, 1,
                                        conv3x3=CONV3X3_RGB_FORWARD)
CODEC_FORWARD_FOUR_OFF = _launch_counts(0, 0, 0, 0,
                                        conv3x3=CONV3X3_RGB_FORWARD)
EVAL_HW, EVAL_IMAGES, CLI_BATCH, EXPORT_BATCH = (512, 768), 8, 4, 16
EVAL_GATES = {"bpp": 1e-4, "psnr": 0.01, "msssim": 1e-4, "psnr_real": 0.01}

# loads exported artifacts in a process that imports nothing of the
# package but its kernel operators, runs each, and runs it again with one
# weight perturbed (the check below must see that)
EXPORT_WORKER = """
import json, sys, time, torch
import rgba_tpu_torch.ops.kernels as kernels
inputs, jobs = sys.argv[1], json.loads(sys.argv[2])
x, a = torch.load(inputs)
ks = (kernels.win_attn.KERNEL, kernels.gdn.KERNEL,
      kernels.gate_chain.KERNEL, kernels.dse.KERNEL)
results = []
for path, out_path in jobs:
    program = torch.export.load(path)
    module = program.module()

    def run(x, a, module=module):
        with torch.inference_mode():
            return module(x, a)
    run(x, a)
    torch.cuda.synchronize()
    for k in ks:
        k.launches = 0
    out = run(x, a)
    torch.cuda.synchronize()
    launches = [k.launches for k in ks]
    t = time.perf_counter()
    for _ in range(3):
        run(x, a)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 3 * 1e3
    with torch.no_grad():
        program.state_dict["model.rgb_codec.Decoder.dse.output_conv.bias"].add_(0.25)
    bad = run(x, a, program.module())
    torch.save({"good": {k: v.float().cpu() for k, v in out.items()},
                "bad": {k: v.float().cpu() for k, v in bad.items()}}, out_path)
    results.append({"launches": launches, "ms": ms})
mods = sorted(m for m in sys.modules if m.startswith("rgba_tpu")
              and not m.startswith("rgba_tpu_torch.ops.kernels")
              and m not in ("rgba_tpu_torch", "rgba_tpu_torch.ops"))
print("RESULT " + json.dumps({"modules": mods, "results": results}))
"""


def _rgba_dir(root: str, tree: str) -> str:
    """The Kodak tree's images and masks as RGBA PNGs, the codec CLI's
    input."""
    import numpy as np
    from rgba_tpu_torch.data import png
    from rgba_tpu_torch.data.datasets import KodakDataset
    os.makedirs(root, exist_ok=True)
    ds = KodakDataset(tree)
    for img, anno in zip(ds.img_paths, ds.anno_paths):
        rgba = np.concatenate([png.load(img, "RGB"),
                               png.load(anno, "L")[..., None]], -1)
        png.write_png(os.path.join(root, os.path.basename(img)), rgba)
    return root


def _sum_launches(*counts):
    return {n: sum(c[n] for c in counts) for n in KERNEL_NAMES}


def _kodak_eval(torch, tree: str, ckpt: dict) -> dict:
    """evaluate_kodak(real_codec=True) with all four kernels on (fp32) and
    with them off, on the live weights.  The conv3x3 kernel runs in the
    codec's steps on both routes (it has no switch): "off" holds the four
    kernels against their plain paths, not the codec's 3x3 convolutions
    against cuDNN (``conv3x3_cases`` does that)."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.data.datasets import KodakDataset
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.eval.kodak import evaluate_kodak, make_eval_step
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.train.checkpoint import load_checkpoint

    item = KodakDataset(tree).get(0)
    out = {}
    for route, policy in (("on", _all_kernels(DEFAULT_POLICY)),
                          ("off", DEFAULT_POLICY)):
        pipe = RGBAPipeline(policy, seed=5)
        for codec_name, m in (("rgb", pipe.rgb_codec),
                              ("mask", pipe.mask_codec)):
            if load_checkpoint(m, ckpt[codec_name]):
                raise AssertionError(f"{codec_name} checkpoint incomplete")
        rgb, mask = pipe.rgb_codec, pipe.mask_codec
        codec = RGBAFileCodec(CodecIO(rgb, "rgb"), CodecIO(mask, "mask"))
        step = make_eval_step(rgb, mask)
        # warm-up, and the launches of one eval step and of one encode +
        # decode of one image
        step(item["masked_image"][None], item["alpha"][None])
        codec.decode(codec.encode(item["image"][None], item["alpha"][None]))
        torch.cuda.synchronize()
        per = {}
        _reset_launches()
        {k: v.cpu() for k, v in step(item["masked_image"][None],
                                    item["alpha"][None]).items()}
        per["step"] = _read_launches(
            FORWARD_LAUNCHES if route == "on" else _launch_counts(0, 0, 0, 0),
            f"one eval step, four kernels {route}")
        _reset_launches()
        codec.decode(codec.encode(item["image"][None], item["alpha"][None]))
        per["codec"] = _read_launches(
            CODEC_LAUNCHES if route == "on" else CODEC_FOUR_OFF_LAUNCHES,
            f"one image's encode + decode, four kernels {route}")
        n = EVAL_IMAGES
        want = _sum_launches(*(n * (
            [FORWARD_LAUNCHES, CODEC_LAUNCHES, CODEC_FORWARD_LAUNCHES]
            if route == "on" else [CODEC_FOUR_OFF_LAUNCHES,
                                   CODEC_FORWARD_FOUR_OFF])))
        _reset_launches()
        t = time.perf_counter()
        avg = evaluate_kodak(rgb, mask, tree, real_codec=True, codec=codec)
        wall = time.perf_counter() - t
        per["evaluate_kodak"] = _read_launches(
            want, f"evaluate_kodak of {n} images, four kernels {route}")
        print(f"  kodak eval, four kernels {route} (conv3x3 on): time "
              f"{avg['time'] * 1e3:.3f} "
              f"ms/image (eval step), codec {avg['codec_time'] * 1e3:.3f} "
              f"ms/image (encode + decode), wall {wall:.2f} s for {n}; bpp "
              f"{avg['bpp']:.6f} PSNR {avg['psnr']:.6f} MS-SSIM "
              f"{avg['msssim']:.6f} real bpp {avg['real_bpp']:.6f} "
              f"psnr_real {avg['psnr_real']:.6f} codec_err "
              f"{avg['codec_err']:.3g}")
        if not all(np.isfinite(v) for v in avg.values()):
            raise AssertionError(f"four kernels {route}: an average is "
                                 f"not finite")
        per_image = _hold_codec_err(codec, tree, avg["codec_err"])
        out[route] = {"avg": avg, "wall_s": wall, "launches": per,
                      "codec_err_parts": per_image}
        codec.rgb_io.close()
        codec.mask_io.close()
        del pipe, rgb, mask, codec, step
    on, off = out["on"]["avg"], out["off"]["avg"]
    gaps = {"bpp": abs(on["bpp"] - off["bpp"]) / abs(off["bpp"]),
            "psnr": abs(on["psnr"] - off["psnr"]),
            "msssim": abs(on["msssim"] - off["msssim"]),
            "psnr_real": abs(on["psnr_real"] - off["psnr_real"])}
    print("  kernels on against off: " + ", ".join(
        f"{k} {v:.3g} (tol {EVAL_GATES[k]:g})" for k, v in gaps.items()))
    for k, v in gaps.items():
        if not v <= EVAL_GATES[k]:
            raise AssertionError(f"kodak eval: {k} on against off {v} > "
                                 f"{EVAL_GATES[k]}")
    out["gaps"] = gaps
    return out


def _hold_codec_err(codec, tree: str, codec_err: float):
    """``eval.kodak.hold_codec_err``, each image's parts printed: codec_err
    above 1e-5 is a value at a rounding boundary rounded apart in the eval
    step's forward and the codec (laid out and summed apart)."""
    from rgba_tpu_torch.eval import kodak
    parts = kodak.hold_codec_err(codec, tree, codec_err)
    print(f"  codec_err {codec_err:.3g} (tol {kodak.CODEC_ERR_AVG_MAX:g} on "
          f"average, {kodak.CODEC_ERR_MAX:g} or each image's parts)")
    for p in parts or ():
        rgb, alpha = p["rgb"], p["alpha"]
        print(f"    image {p['image']}: RGB max_abs {rgb['max_abs']:.3g} "
              f"(tol {kodak.RGB_LEVEL:.3g}) mean_abs {rgb['mean_abs']:.3g} "
              f"share>1e-3 {rgb['share_above_1e-3']:.3g}; alpha max_abs "
              f"{alpha['max_abs']:.3g} mean_abs {alpha['mean_abs']:.3g} "
              f"(tol {kodak.ALPHA_MEAN_MAX:g}) share>1e-3 "
              f"{alpha['share_above_1e-3']:.3g} "
              f"(tol {kodak.ALPHA_SHARE_MAX:g}) -> ok")
    return parts


def _codec_cli(torch, rgba: str, work: str, ckpt: dict) -> dict:
    """``cli.codec`` encode-dir / decode-dir, v64 and lanes32, against
    ``encode_batch`` and the JAX CLI's pixels of ``decode_batch``'s float
    decode (clipped, times 255, truncated)."""
    import glob
    import numpy as np
    from rgba_tpu_torch.cli import codec as cli
    from rgba_tpu_torch.data import png

    weights = ["-r", ckpt["rgb"], "-m", ckpt["mask"]]
    paths = sorted(glob.glob(os.path.join(rgba, "*.png")))
    c = cli._load_codecs(ckpt["rgb"], ckpt["mask"])
    out = {}
    for fmt in ("v64", "lanes32"):
        enc, dec = os.path.join(work, f"enc_{fmt}"), os.path.join(work, f"dec_{fmt}")
        t = time.perf_counter()
        cli.main(["encode-dir", rgba, enc, "-b", str(CLI_BATCH),
                  "--stream-format", fmt] + weights)
        t_enc = time.perf_counter() - t
        _reset_launches()
        t = time.perf_counter()
        cli.main(["decode-dir", enc, dec, "-b", str(CLI_BATCH)] + weights)
        t_dec = time.perf_counter() - t
        batches = len(paths) // CLI_BATCH
        want = _launch_counts(0, 0, 0, 0,
                              batches * LANE_DECODE_RANS if fmt == "lanes32"
                              else 0, conv3x3=batches * (
                                  CONV3X3_DECODE + (CONV3X3_RGB_CHAIN
                                                    if fmt == "v64" else 0)))
        launches = _read_launches(want, f"decode-dir of {len(paths)} {fmt} "
                                        f"blobs")
        for b0 in range(0, len(paths), CLI_BATCH):
            chunk = paths[b0:b0 + CLI_BATCH]
            x = np.stack([png.load(p, "RGBA") for p in chunk]).astype(
                np.float32) / 255.0
            blobs = c.encode_batch(x[..., :3], x[..., 3:], stream_format=fmt)
            pixels = (np.clip(c.decode_batch(blobs), 0, 1) * 255).astype(
                np.uint8)
            for p, blob, px in zip(chunk, blobs, pixels):
                stem = os.path.splitext(os.path.basename(p))[0]
                with open(os.path.join(enc, stem + ".rgbc"), "rb") as f:
                    if f.read() != blob:
                        raise AssertionError(f"{fmt}: the CLI's {stem}.rgbc "
                                             f"is not encode_batch's")
                if not np.array_equal(
                        png.load(os.path.join(dec, stem + ".png"), "RGBA"), px):
                    raise AssertionError(f"{fmt}: the CLI's {stem}.png is not "
                                         f"the truncated float decode")
        out[fmt] = {"encode_img_per_s": len(paths) / t_enc,
                    "decode_img_per_s": len(paths) / t_dec,
                    "launches_decode": launches}
        print(f"  codec CLI {fmt}: encode-dir {out[fmt]['encode_img_per_s']:.3f}"
              f" img/s, decode-dir {out[fmt]['decode_img_per_s']:.3f} img/s "
              f"({len(paths)} images, -b {CLI_BATCH}, weights loaded in each "
              f"command); blobs = encode_batch's, PNGs = the float decode "
              f"truncated, as the JAX CLI writes them")
    c.rgb_io.close()
    c.mask_io.close()
    return out


def _train_cli(torch, rgba: str, tree: str, work: str, ckpt: dict) -> dict:
    """``cli.train_rgb``: 2 steps from a config, then ``--test`` on the
    checkpoint it wrote (inside ``work``: the CLI writes checkpoints/ and
    outputKodak/ under the working directory)."""
    import numpy as np
    from rgba_tpu_torch.cli import train_rgb

    cfg = os.path.join(work, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"tot_epoch": 10, "tot_step": 2, "train_lambda": 1024,
                   "batch_size": 2, "print_freq": 1,
                   "save_model_freq": 10 ** 9}, f)
    here = os.getcwd()
    os.chdir(work)
    try:
        t = time.perf_counter()
        train_rgb.main(["--config", cfg, "-n", "smoke", "--train-coco", rgba,
                        "--train-p3m", "", "-pm", ckpt["mask"],
                        "--kodak", os.path.join(work, "nokodak")])
        t_train = time.perf_counter() - t
        written = os.path.join(work, "checkpoints", "smoke", "iter_2.ckpt")
        if not os.path.isfile(written):
            raise AssertionError("train_rgb wrote no iter_2.ckpt")
        avg = train_rgb.main(["--test", "-p", written, "-pm", ckpt["mask"],
                              "--kodak", tree])
        n_out = len(os.listdir(os.path.join(work, "outputKodak")))
    finally:
        os.chdir(here)
    if not all(np.isfinite(avg[k]) for k in ("bpp", "psnr", "msssim")):
        raise AssertionError(f"train_rgb --test: averages {avg}")
    if n_out != EVAL_IMAGES:
        raise AssertionError(f"train_rgb --test wrote {n_out} images")
    print(f"  train_rgb CLI: 2 steps in {t_train:.2f} s (set-up included), "
          f"iter_2.ckpt read back by --test: bpp {avg['bpp']:.6f} PSNR "
          f"{avg['psnr']:.6f} over {n_out} images")
    return {"train_s": t_train, "test_avg": avg}


def _exports(torch, state: dict, work: str, iters: int) -> dict:
    """The bf16 ``RGBAPipeline`` at batch 16 under ``SERVE_POLICY`` and
    with all four kernels: exported, saved, and run in one fresh process
    that imports only ``rgba_tpu_torch.ops.kernels``; then img/s of eager
    against the exported program here, in turns (the same program the
    fresh process loaded; its own img/s is printed beside)."""
    from rgba_tpu_torch.core.precision import BF16_POLICY, SERVE_POLICY
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.eval.export import (export_serving_forward,
                                            save_artifact)
    from rgba_tpu_torch.models.pipeline import RGBAPipeline

    d = synthetic_rgba_batch(EXPORT_BATCH, *EVAL_HW, seed=40)
    x = torch.from_numpy(d["masked_image"]).cuda()
    a = torch.from_numpy(d["alpha"]).cuda()
    inputs = os.path.join(work, "export_in.pt")
    torch.save((x, a), inputs)
    routes = {}
    for name, policy in (("serve", SERVE_POLICY),
                         ("all_kernels", _all_kernels(BF16_POLICY))):
        pipe = RGBAPipeline(policy, seed=0)
        pipe.load_state_dict(state)
        eager = pipe(x, a)
        torch.cuda.synchronize()
        t = time.perf_counter()
        art = export_serving_forward(pipe, (x, a))
        t_export = time.perf_counter() - t
        path = os.path.join(work, f"{name}.pt2")
        routes[name] = {"pipe": pipe, "art": art, "eager": eager,
                        "path": path,
                        "result": os.path.join(work, f"{name}_out.pt"),
                        "export_s": t_export, "ops": art.kernel_ops(),
                        "bytes": save_artifact(art, path),
                        "want": [(FORWARD_LAUNCHES if policy.fused_gdn
                                  else SERVE_LAUNCHES)[k]
                                 for k in CONV_KERNELS]}
    jobs = [[r["path"], r["result"]] for r in routes.values()]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_WORKER, inputs,
                           json.dumps(jobs)], capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    t_fresh = time.perf_counter() - t
    res = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not res:
        raise AssertionError(f"the artifacts failed in a fresh process:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    fresh = json.loads(res[-1][len("RESULT "):])
    print(f"  fresh process: {t_fresh:.1f} s for both artifacts; modules of "
          f"the package it imported besides the kernels: {fresh['modules']}")
    if fresh["modules"]:
        raise AssertionError(f"the fresh process imported {fresh['modules']}")
    out = {}
    for (name, r), got in zip(routes.items(), fresh["results"]):
        outs = torch.load(r["result"])
        ref = r["eager"]["x_hat"].float().cpu()
        tol = BF16_TOL * max(1.0, float(ref.abs().max()))

        def gate(o):
            err = float((o["x_hat"] - ref).abs().max())
            rel = (abs(float(o["bpp"]) - float(r["eager"]["bpp"]))
                   / float(r["eager"]["bpp"]))
            return err, rel, err <= tol and rel <= 1e-3

        err, rel, ok = gate(outs["good"])
        berr, brel, bok = gate(outs["bad"])
        print(f"  export {name}: {r['export_s']:.1f} s, "
              f"{r['bytes'] / 2 ** 20:.1f} MiB, ops {r['ops']}; in the fresh "
              f"process: x_hat max_abs {err:.3g} (tol {tol:.4g}), bpp rel "
              f"{rel:.3g} (tol 1e-3) -> {'ok' if ok else 'FAIL'}; with one "
              f"weight moved: x_hat max_abs {berr:.3g}, bpp rel {brel:.3g} "
              f"-> {'FAIL (the check cannot see it)' if bok else 'seen'}")
        if not ok:
            raise AssertionError(f"{name}: the artifact disagrees with eager")
        if bok:
            raise AssertionError(f"{name}: a perturbed artifact passed")
        launches = dict(zip(CONV_KERNELS, got["launches"]))
        print(f"  launches of one {name} artifact call in the fresh "
              f"process: {launches}")
        if got["launches"] != r["want"]:
            raise AssertionError(f"{name}: the artifact launched "
                                 f"{got['launches']}, not {r['want']}")
        art, pipe = r["art"], r["pipe"]
        art(x, a)

        def img_per_s(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                fn(x, a)
            torch.cuda.synchronize()
            return EXPORT_BATCH * iters / (time.perf_counter() - t)

        rates = {turn: img_per_s(pipe if turn.startswith("eager") else art)
                 for turn in ("eager", "artifact", "artifact again",
                              "eager again")}
        fresh_rate = EXPORT_BATCH / got["ms"] * 1e3
        print(f"  {name} img/s: " + ", ".join(f"{k} {v:.3f}"
                                              for k, v in rates.items())
              + f" (batch {EXPORT_BATCH}, {EVAL_HW[0]}x{EVAL_HW[1]}; in the "
              f"fresh process {fresh_rate:.3f})")
        out[name] = {"export_s": r["export_s"], "bytes": r["bytes"],
                     "ops": r["ops"], "x_hat_max_abs": err, "bpp_rel": rel,
                     "perturbed_max_abs": berr, "launches": launches,
                     "img_per_s": rates, "fresh_img_per_s": fresh_rate}
    out["fresh_process_s"] = t_fresh
    return out


def eval_phase(torch, iters: int) -> dict:
    """The eval and CLI entry points at the Kodak size (512x768), full
    width, on the live weights."""
    import tempfile
    from rgba_tpu_torch.core.precision import BF16_POLICY
    from rgba_tpu_torch.data.synthetic import write_synthetic_kodak_tree
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.train.checkpoint import save_checkpoint

    out, secs = {}, {}
    with tempfile.TemporaryDirectory() as work:
        t = time.perf_counter()
        tree = os.path.join(work, "kodak")
        write_synthetic_kodak_tree(tree, EVAL_IMAGES, *EVAL_HW, seed=0)
        rgba = _rgba_dir(os.path.join(work, "rgba"), tree)
        live = RGBAPipeline(BF16_POLICY, seed=0)
        _liven(torch, live)
        state = live.state_dict()
        ckpt = {k: save_checkpoint(getattr(live, f"{k}_codec").state_dict(),
                                   os.path.join(work, k), 2)
                for k in ("rgb", "mask")}
        del live
        secs["set_up"] = time.perf_counter() - t
        for part, fn in (("kodak", lambda: _kodak_eval(torch, tree, ckpt)),
                         ("codec_cli", lambda: _codec_cli(torch, rgba, work,
                                                          ckpt)),
                         ("train_cli", lambda: _train_cli(torch, rgba, tree,
                                                          work, ckpt)),
                         ("export", lambda: _exports(torch, state, work,
                                                     iters))):
            t = time.perf_counter()
            out[part] = fn()
            secs[part] = time.perf_counter() - t
    print("  eval phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in secs.items()))
    out["seconds"] = secs
    return out


class _SynthDataset:
    """Synthetic RGBA samples by index, as the trainers' loader reads them;
    drawn once (0.07 s a sample), so that the loader is not what a run's
    steps/s measures."""

    def __init__(self, n: int, hw: int):
        from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
        self.samples = [{k: v[0] for k, v in
                         synthetic_rgba_batch(1, hw, hw, seed=i).items()}
                        for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def get(self, idx, epoch_seed=0):
        return self.samples[idx]


class _Curve:
    """Stands in for a TensorBoard writer: with print_freq = cal_step = 1
    ``Trainer.train`` hands it every step's rd_loss; it also keeps the time
    at which each arrived."""

    def __init__(self):
        self.losses, self.times = [], []

    def add_scalar(self, tag, value, step):
        if tag == "rd_loss":
            self.losses.append(float(value))
            self.times.append(time.perf_counter())


def _train_gradients(torch, kind: str, want_launches: dict) -> dict:
    """fp32: the training loss and every gradient of one codec with the
    kernels on against off, same weights, same noise seed."""
    from rgba_tpu_torch.core.config import TrainConfig
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY, precision_scope
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.models.mask_codec import MaskCodec
    from rgba_tpu_torch.models.rgb_codec import RGBCodec
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid
    from rgba_tpu_torch.train.loops import _mask_loss_fn, _rgb_loss_fn

    dev = torch.device("cuda")
    cfg = TrainConfig(train_lambda=1024)
    cls, loss_fn = ((RGBCodec, _rgb_loss_fn(cfg)) if kind == "rgb"
                    else (MaskCodec, _mask_loss_fn(cfg)))
    d = synthetic_rgba_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, seed=3)
    batch = {k: torch.from_numpy(d[k]).to(dev).permute(0, 3, 1, 2)
             for k in ("masked_image", "alpha")}
    models = {}
    for which, policy in (("on", _all_kernels(DEFAULT_POLICY)),
                          ("off", DEFAULT_POLICY)):
        models[which] = cls(policy=policy, device=dev,
                            generator=torch.Generator().manual_seed(0))
    _bias_noise(torch, models["on"], 7)
    # Random init leaves every latent inside the bin of 0.  A gain of 3 on
    # the encoder's last 1x1 conv puts a share of them in the bins of +-1
    # (the std of y_hat is printed) and keeps them clear of the half
    # integers, where the two routes may round apart.
    with torch.no_grad():
        (models["on"].Encoder.x4 if kind == "rgb"
         else models["on"].EncoderMask[7]).weight.mul_(3.0)
    models["off"].load_state_dict(models["on"].state_dict())

    def y_hat(model):
        noise = torch.Generator(device=dev).manual_seed(11)
        with torch.no_grad(), precision_scope(model.policy):
            a = batch["alpha"]
            out = (model(batch["masked_image"], a, a, mask_pyramid(a),
                         training=True, generator=noise) if kind == "rgb"
                   else model(a, training=True, generator=noise))
        return out["y_hat"]

    # A latent within fp32 noise of a half integer may round the other way
    # under the other route; it then moves a patch of x_hat and, through
    # it, every gradient a little.  At this gain none should; at most
    # MAX_FLIPS are let through, and the tolerances below stay as they are.
    y_on = y_hat(models["on"])
    dy = (y_on - y_hat(models["off"])).abs()
    flips = int((dy > 0.5).sum())
    print(f"  {kind}: y_hat std {float(y_on.std()):.4f}, "
          f"{100.0 * float((y_on.abs() > 0.5).float().mean()):.1f}% outside "
          f"the bin of 0; {flips} of {dy.numel()} latents round differently "
          f"with the kernels on and off (at most {MAX_FLIPS})")
    if flips > MAX_FLIPS:
        raise AssertionError(f"{kind}: {flips} latents round differently "
                             f"with the kernels on and off")

    # "off again" repeats the plain route on the same model: cuDNN's
    # backward sums in no fixed order, so the plain gradients differ from
    # themselves, and that floor is printed beside each group's gap
    res = {}
    for which, model in (*models.items(), ("off again", models["off"])):
        model.zero_grad(set_to_none=True)
        noise = torch.Generator(device=dev).manual_seed(11)
        with precision_scope(model.policy):
            _reset_launches()
            rd, _ = loss_fn(model, batch, noise)
            torch.cuda.synchronize()
            fwd = {n: k.launches for n, k in _kernels().items()}
            rd.backward()
            torch.cuda.synchronize()
        if which == "on":
            if fwd != want_launches:
                raise AssertionError(f"{kind} training forward: expected "
                                     f"launches {want_launches}, got {fwd}")
            launches = _read_launches(want_launches,
                                      f"one {kind} forward + backward")
        res[which] = (float(rd.detach()),
                      {n: p.grad for n, p in model.named_parameters()})
    (l_on, g_on), (l_off, g_off) = res["on"], res["off"]
    loss_rel = abs(l_on - l_off) / abs(l_off)
    print(f"  {kind} fp32 training loss kernels on {l_on:.6f} off {l_off:.6f} "
          f"(rel {loss_rel:.3g}, tol 1e-4)")
    groups, bad = {}, []
    for name, g in g_on.items():
        if name.endswith("quantiles"):      # the RD loss never reaches them
            continue
        ref = g_off[name]
        if g is None or ref is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{kind}: gradient of {name} missing or "
                                 f"not finite")
        diff = float((g - ref).abs().mean())
        floor = float((res["off again"][1][name] - ref).abs().mean())
        mean_g = float(ref.abs().mean())
        tol = 1e-4 * mean_g + 1e-7
        top = name.split(".")[0]
        worst = groups.setdefault(top, [0.0, 0, "", 0.0, 0.0])
        worst[1] += 1
        worst[4] = max(worst[4], floor / tol)
        if diff / tol >= worst[0]:
            worst[0], worst[2], worst[3] = diff / tol, name, mean_g
        if diff > tol:
            bad.append((name, diff, tol))
    for top, (ratio, count, name, mean_g, floor) in groups.items():
        print(f"    {top}: {count} gradients, worst mean|dg| / tol "
              f"{ratio:.3g} ({name}, mean|g| {mean_g:.3g}); plain against "
              f"itself {floor:.3g}")
    if loss_rel > 1e-4 or bad:
        raise AssertionError(f"{kind} fp32 training with kernels disagrees "
                             f"with plain: loss rel {loss_rel:.3g}, "
                             f"gradients off: {bad[:5]}")
    return {"loss_on": l_on, "loss_off": l_off, "loss_rel": loss_rel,
            "latents_rounded_differently": flips, "launches": launches,
            "worst_grad_ratio": max(g[0] for g in groups.values()),
            "worst_plain_against_itself": max(g[4] for g in groups.values())}


def _make_trainer(torch, kind: str, kernels: bool, tmp: str,
                  dtype: str = "bfloat16"):
    """A trainer at the full width in ``dtype``, with every kernel on or
    none."""
    from rgba_tpu_torch.core.config import TrainConfig
    from rgba_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY
    from rgba_tpu_torch.models.mask_codec import MaskCodec
    from rgba_tpu_torch.models.rgb_codec import RGBCodec
    from rgba_tpu_torch.train.loops import MaskTrainer, RGBTrainer

    cfg = TrainConfig(train_lambda=1024, batch_size=TRAIN_BATCH, cal_step=1,
                      print_freq=1, tot_step=TRAIN_STEPS, aux_lr=1e-3,
                      curriculum_step=0, snapshot_freq=10 ** 9,
                      save_model_freq=10 ** 9, compute_dtype=dtype,
                      image_size=TRAIN_SIZE)
    model = None
    if kernels:     # cfg.compute_dtype alone gives the plain policy
        policy = BF16_POLICY if dtype == "bfloat16" else DEFAULT_POLICY
        model = (RGBCodec if kind == "rgb" else MaskCodec)(
            policy=_all_kernels(policy), device=torch.device("cuda"),
            generator=torch.Generator().manual_seed(cfg.seed))
    return (RGBTrainer if kind == "rgb" else MaskTrainer)(
        cfg, f"{tmp}/{kind}_{dtype}_{'on' if kernels else 'off'}", model=model)


def _train_run(torch, trainer, dataset, name: str, compute_steps: int = 10):
    """TRAIN_STEPS steps of ``trainer`` through ``Trainer.train`` (loader,
    one host sync a step for the meters), then ``compute_steps`` more
    through ``Trainer.step`` on one host batch with a single sync at the
    end."""
    from rgba_tpu_torch.data.loader import BatchLoader

    steps = TRAIN_STEPS
    loader = BatchLoader(dataset, batch_size=TRAIN_BATCH, shuffle=False,
                         num_workers=4)
    state = trainer.init_state()
    curve = _Curve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    trainer.train(loader, state, tb_writer=curve, max_steps=steps)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _kernels().items()}
    peak = torch.cuda.max_memory_allocated()
    losses = curve.losses
    if state.step != steps or len(losses) != steps:
        raise AssertionError(f"{name}: {state.step} steps, {len(losses)} losses")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: a loss is not finite: {losses}")
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    # the first two steps load libraries and set cuDNN up
    warm = 2
    rate = (steps - 1 - warm) / (curve.times[-1] - curve.times[warm])
    compute = float("nan")
    if compute_steps:
        host = _host_batch(dataset, trainer.batch_keys)
        t = time.perf_counter()
        for _ in range(compute_steps):
            trainer.step(state, host)
        torch.cuda.synchronize()
        compute = compute_steps / (time.perf_counter() - t)
    print(f"  {name}: rd {losses[0]:.3f} -> {losses[-1]:.3f} (first 5 "
          f"{head:.3f}, last 5 {tail:.3f}); {rate:.3f} steps/s, "
          f"{rate * TRAIN_BATCH:.2f} img/s through Trainer.train; "
          f"{compute:.3f} steps/s, {compute * TRAIN_BATCH:.2f} img/s compute "
          f"only; peak memory {peak / 2 ** 30:.3f} GiB (batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}, {trainer.cfg.compute_dtype}, {steps} "
          f"steps)")
    if not tail < head:
        raise AssertionError(f"{name}: the loss did not descend")
    return state, {"losses": losses, "steps_per_s": rate,
                   "img_per_s": rate * TRAIN_BATCH,
                   "compute_steps_per_s": compute,
                   "compute_img_per_s": compute * TRAIN_BATCH,
                   "peak_memory_bytes": peak, "launches": launches}


def _host_batch(dataset, keys) -> dict:
    """The dataset's first batch, as the loader stacks it."""
    import numpy as np
    return {k: np.stack([dataset.get(i)[k] for i in range(TRAIN_BATCH)])
            for k in keys}


def _attention_layouts(torch, model) -> list:
    """The bf16 kernel layout of every window attention's qkv weights."""
    from rgba_tpu_torch.ops.attention import MaskedWinBlock
    return [m.attn.kernel_inputs(torch.bfloat16)[0].wqkv.clone()
            for m in model.modules() if isinstance(m, MaskedWinBlock)]


def _stale_layout_check(torch, model, before: list) -> dict:
    """After the optimizer's in-place updates every ``WindowAttention``
    must hand the kernel the layout of its *new* weights, and its kernel
    route must agree with its plain path on them."""
    import dataclasses as dc
    from rgba_tpu_torch.ops.attention import MaskedWinBlock
    from rgba_tpu_torch.ops.kernels.win_attn import kernel_weights

    blocks = [m for m in model.modules() if isinstance(m, MaskedWinBlock)]
    g = torch.Generator().manual_seed(9)
    worst = 0.0
    with torch.inference_mode():
        for blk, old in zip(blocks, before):
            a = blk.attn
            cached, _ = a.kernel_inputs(torch.bfloat16)
            fresh = kernel_weights(a.qkv.weight.t(), a.qkv.bias,
                                   a.proj.weight.t(), a.proj.bias,
                                   a.num_heads, torch.bfloat16)
            if not all(torch.equal(c, f) for c, f in zip(cached, fresh)):
                raise AssertionError("a stepped WindowAttention still holds "
                                     "the kernel layout of its old weights")
            if torch.equal(cached.wqkv, old):
                raise AssertionError("the steps did not move the attention "
                                     "weights: the check compares nothing")
            size = 8 * blk.window_size
            x = torch.randn(2, a.dim, size, size, generator=g).cuda()
            alpha = (torch.rand(2, 1, size, size, generator=g) > 0.3).float().cuda()
            on = blk(x, alpha)
            blk.policy = a.policy = dc.replace(blk.policy, fused_win_attn=False)
            off = blk(x, alpha)
            blk.policy = a.policy = dc.replace(blk.policy, fused_win_attn=True)
            ok, max_abs, _, tol = _within(torch, on, off, "bfloat16")
            worst = max(worst, max_abs)
            print(f"  stepped attention C={a.dim} N={blk.window_size ** 2}: "
                  f"layout fresh, kernel vs plain max_abs {max_abs:.3g} "
                  f"tol {tol} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("stepped attention: kernel route "
                                     "disagrees with the plain path")
    return {"blocks": len(blocks), "max_abs_err": worst}


def train_phase(torch) -> dict:
    import tempfile
    from rgba_tpu_torch.core.precision import precision_scope

    steps = TRAIN_STEPS
    out = {"batch": TRAIN_BATCH, "size": TRAIN_SIZE, "steps": steps,
           "gradients": {kind: _train_gradients(torch, kind,
                                                _step_launches(kind))
                         for kind in ("rgb", "mask")}}
    dataset = _SynthDataset(4 * TRAIN_BATCH, TRAIN_SIZE)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the main path: both trainers with the kernels on
        for kind in ("rgb", "mask"):
            per_step = _step_launches(kind)
            trainer = _make_trainer(torch, kind, True, tmp)
            layouts = _attention_layouts(torch, trainer.model)
            state, runs[f"{kind}_on"] = _train_run(
                torch, trainer, dataset, f"{kind} trainer, kernels on")
            want = {n: steps * c for n, c in per_step.items()}
            if runs[f"{kind}_on"]["launches"] != want:
                raise AssertionError(
                    f"{kind} trainer: expected launches {want}, got "
                    f"{runs[f'{kind}_on']['launches']}")
            print(f"  launches in {steps} {kind} steps: {want}")
            if kind == "rgb":
                out["stale_layout"] = _stale_layout_check(
                    torch, trainer.model, layouts)
                host = _host_batch(dataset, trainer.batch_keys)
                out["profile_step"] = profile_run(
                    torch, lambda: trainer.step(state, host),
                    "RGB train step (kernels on)", top=12)
                dev_batch = trainer.device_batch(host)
                holder = {}

                def forward():
                    trainer.model.zero_grad(set_to_none=True)
                    with precision_scope(trainer.model.policy):
                        holder["rd"], _ = trainer.loss_fn(
                            trainer.model, dev_batch, trainer.noise)

                out["profile_forward"] = profile_run(
                    torch, forward, "its forward", top=8)
                out["profile_backward"] = profile_run(
                    torch, lambda: holder["rd"].backward(),
                    "its backward", top=8)
            del trainer, state
        for kind in ("rgb", "mask"):
            trainer = _make_trainer(torch, kind, False, tmp)
            state, runs[f"{kind}_off"] = _train_run(
                torch, trainer, dataset, f"{kind} trainer, kernels off")
            if any(runs[f"{kind}_off"]["launches"].values()):
                raise AssertionError("a kernel launched with the flags off")
            if kind == "rgb":
                # steps/s follow the host's pace, which moves from call to
                # call; the device's share of a step is read here
                host = _host_batch(dataset, trainer.batch_keys)
                out["profile_step_off"] = profile_run(
                    torch, lambda: trainer.step(state, host),
                    "RGB train step (kernels off)", top=6)
            del trainer, state
    # Both routes start from the same weights, data and noise seed, so their
    # first losses must agree.  The RGB codec's steps are smooth enough to
    # hold the final losses together as well.  The mask codec's are not:
    # from the fourth step on its loss falls tenfold with spikes, and runs
    # that differ in rounding alone end far apart; its final gap is printed.
    for kind in ("rgb", "mask"):
        on, off = runs[f"{kind}_on"]["losses"], runs[f"{kind}_off"]["losses"]
        first = max(abs(a - b) / abs(b) for a, b in zip(on[:3], off[:3]))
        final = abs(on[-1] - off[-1]) / max(abs(off[-1]), 1e-6)
        out[f"{kind}_first_steps_gap"], out[f"{kind}_final_gap"] = first, final
        print(f"  {kind} losses, kernels on against off: steps 1-3 "
              f"{[round(v, 3) for v in on[:3]]} / "
              f"{[round(v, 3) for v in off[:3]]}, largest gap {first:.5f} "
              f"(tol 0.01); final gap {final:.4f}"
              + (" (tol 0.05)" if kind == "rgb" else " (reported, not held)"))
        if first >= 0.01:
            raise AssertionError(f"{kind}: the first losses with the kernels "
                                 f"on and off differ by {first}")
    if out["rgb_final_gap"] >= 0.05:
        raise AssertionError(f"rgb: final losses differ by "
                             f"{out['rgb_final_gap']}")
    out["mask_fp32"] = _mask_fp32_split(torch, dataset)
    out["runs"] = runs
    # each trainer's kernels-on run: counts set to 0 before, read after
    out["launches_train"] = {
        n: {"rgb": runs["rgb_on"]["launches"][n],
            "mask": runs["mask_on"]["launches"][n], "steps": steps}
        for n in KERNEL_NAMES}
    return out


def _mask_fp32_split(torch, dataset) -> dict:
    """20 fp32 ``MaskTrainer`` steps with the kernels on and off, the same
    weights, data and noise: the loss gap of every step is printed.  On the
    CPU the port tracks the JAX package as closely as JAX tracks itself
    from a one-ulp nudge (tests/test_torch_port_mask_steps.py); here the
    first three steps are held to 1%, as in bf16, and the rest shows where
    the two routes' fp32 rounding grows apart."""
    import tempfile
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("on", "off"):
            trainer = _make_trainer(torch, "mask", which == "on", tmp, "float32")
            _, runs[which] = _train_run(
                torch, trainer, dataset, f"mask trainer fp32, kernels {which}",
                compute_steps=0)
            del trainer
    want = {n: TRAIN_STEPS * c for n, c in _step_launches("mask").items()}
    if runs["on"]["launches"] != want or any(runs["off"]["launches"].values()):
        raise AssertionError(f"mask fp32 launches: on {runs['on']['launches']},"
                             f" off {runs['off']['launches']}")
    on, off = runs["on"]["losses"], runs["off"]["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(on, off)]
    print("  mask fp32 losses, kernels on against off, gap per step: "
          + " ".join(f"{g:.2e}" for g in gaps))
    if max(gaps[:3]) >= 0.01:
        raise AssertionError(f"mask fp32: the first losses with the kernels on "
                             f"and off differ by {max(gaps[:3])}")
    return {"losses_on": on, "losses_off": off, "gaps": gaps,
            "launches": runs["on"]["launches"]}


# ------------------------------------------------------------------ slice 12

PEAK_INT8 = 1979e12                  # dense int8 tensor-core operations/s
INT8_REL_TOL = 0.08    # x_hat against fp32: the JAX package's gate (tests/test_quant.py)
PARALLEL_STEPS = 3
PARALLEL_LOSS_RTOL = 1e-6


def health_phase(torch) -> dict:
    """The card's health canary (``utils/health.chip_health``): bf16
    8192^3 ``torch.matmul`` TF/s and the ms of one host fetch."""
    from rgba_tpu_torch.utils import health

    card = _card_line()
    out = health.chip_health()
    print(f"  chip_health: {out['matmul_tflops']} TF/s (bf16 8192^3 "
          f"torch.matmul, CUDA events), host fetch {out['sync_ms']} ms, "
          f"healthy_frac {out['healthy_frac']} of HEALTHY_TFS "
          f"{health.HEALTHY_TFS}, degraded {out['degraded']}; card {card}")
    if not (math.isfinite(out["matmul_tflops"]) and out["matmul_tflops"] > 0):
        raise AssertionError(f"chip_health gave no rate: {out}")
    return dict(out, healthy_tfs=health.HEALTHY_TFS, card=card)


def _int8_geometry(weight, stride: int, transposed: bool) -> str:
    k = weight.shape[2]
    cin, cout = ((weight.shape[0], weight.shape[1]) if transposed
                 else (weight.shape[1], weight.shape[0]))
    name = f"{'deconv' if transposed else 'conv'}{k}x{k}s{stride}"
    if cin < 8:
        name += f"_in{cin}"
    if cout < 8:
        name += f"_out{cout}"
    return name


@contextlib.contextmanager
def _recorded_int8(torch):
    """Keeps the arguments of the first int8 convolution of each geometry
    (kernel size, stride, direction, a narrow input or output) that runs
    while the block does."""
    from rgba_tpu_torch.ops import conv

    seen = {}
    run = conv.policy_conv

    def record(x, weight, bias, policy, stride=1, padding=0,
               transposed=False, output_padding=0):
        key = _int8_geometry(weight, stride, transposed)
        if key not in seen:
            seen[key] = dict(x=x.to(policy.compute_dtype).detach().clone(),
                             weight=weight.detach().clone(),
                             bias=bias.detach().clone(), stride=stride,
                             padding=padding, transposed=transposed,
                             output_padding=output_padding)
        return run(x, weight, bias, policy, stride, padding, transposed,
                   output_padding)
    conv.policy_conv = record
    try:
        yield seen
    finally:
        conv.policy_conv = run


def _int8_conv_case(torch, key: str, c: dict, iters: int) -> dict:
    """One recorded int8 convolution: its int32 accumulators (the first two
    images, their own scale) against the float64 convolution of the same
    int8 operands, exact below 2^53; its time at the path's shape against
    cuDNN's bf16 convolution of the same shape, and its bound."""
    import torch.nn.functional as F
    from rgba_tpu_torch.ops import quant

    x, w, s, p, tr, op = (c[k] for k in ("x", "weight", "stride", "padding",
                                          "transposed", "output_padding"))
    xq, _ = quant.quantize_activation(x[:2])
    wq, _ = quant.quantize_weight(w, tr)
    acc = quant.int8_accumulate(xq, wq, s, p, tr, op)
    xd, wd = xq.double(), wq.double()
    exact = (F.conv_transpose2d(xd, wd, stride=s, padding=p,
                                output_padding=op) if tr
             else F.conv2d(xd, wd, stride=s, padding=p))
    diff = float((acc.permute(0, 3, 1, 2).double() - exact).abs().max())
    wb, bb = w.to(torch.bfloat16), c["bias"].to(torch.bfloat16)

    def library():
        if tr:
            return F.conv_transpose2d(x, wb, bb, s, p, op)
        return F.conv2d(x, wb, bb, s, p)
    out = library()
    ms = _time_ms(torch, lambda: quant.int8_conv(x, w, s, p, tr, op), iters)
    lib_ms = _time_ms(torch, library, iters)
    b, cin, h, wd_ = x.shape
    cout = w.shape[1] if tr else w.shape[0]
    k = w.shape[2]
    macs = (b * h * wd_ * cin * cout * k * k if tr
            else out.numel() * cin * k * k)
    nbytes = 2 * x.numel() + 2 * out.numel() + 4 * w.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_INT8 * 1e3
    res = {"shape": f"{tuple(x.shape)} -> {tuple(out.shape)}",
           "acc_max_abs_diff": diff, "ms": ms, "bf16_cudnn_ms": lib_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  int8 {key} {res['shape']}: int32 accumulators vs float64 "
          f"max |d| {diff:g}; {ms:.4f} ms vs bf16 cuDNN {lib_ms:.4f} ms, "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    if diff != 0.0:
        raise AssertionError(f"int8 {key}: the int32 accumulators are not "
                             f"the exact sums")
    return res


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def int8_phase(torch, batch: int, iters: int) -> dict:
    """``SERVE_INT8_POLICY`` (bf16, dynamic W8A8 convolutions, the
    attention kernel) on the forward phase's live weights, batch x 512x768:
    shapes, finiteness, the attention kernel's launches, the exact int32
    sums of one convolution of each geometry, x_hat against the fp32
    forward (and a dequantize without the weight scale, which must fail
    that gate), img/s against ``SERVE_POLICY`` and bf16 with all kernels
    by ``device_time`` in turns, one profiled forward."""
    from rgba_tpu_torch.core.precision import (BF16_POLICY, DEFAULT_POLICY,
                                               SERVE_INT8_POLICY,
                                               SERVE_POLICY)
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.ops import quant

    t0 = time.perf_counter()
    fp32 = RGBAPipeline(DEFAULT_POLICY, seed=0)
    _liven(torch, fp32)
    state = fp32.state_dict()
    pipes = {"serve-int8": RGBAPipeline(SERVE_INT8_POLICY, seed=0),
             "serve": RGBAPipeline(SERVE_POLICY, seed=0),
             "bf16 all kernels": RGBAPipeline(_all_kernels(BF16_POLICY),
                                              seed=0)}
    for p in pipes.values():
        p.load_state_dict(state)
    datas = [synthetic_rgba_batch(batch, 512, 768, seed=s) for s in range(2)]
    ins = [(torch.from_numpy(d["masked_image"]).cuda(),
            torch.from_numpy(d["alpha"]).cuda()) for d in datas]
    print(f"  set-up {time.perf_counter() - t0:.1f} s")
    int8 = pipes["serve-int8"]
    int8(*ins[1])                                     # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    with _recorded_int8(torch) as convs:
        out = int8(*ins[0])
    torch.cuda.synchronize()
    launches = _read_launches(SERVE_LAUNCHES, "one serve-int8 forward")
    for key, shape in (("x_hat", (batch, 512, 768, 3)),
                       ("recon_mask", (batch, 512, 768, 1))):
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key} shape {tuple(out[key].shape)}")
    for key, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"serve-int8 {key} is not finite")
    print(f"  {len(convs)} geometries of int8 convolution in one forward: "
          f"{', '.join(sorted(convs))}")
    cases = {key: _int8_conv_case(torch, key, c, iters)
             for key, c in sorted(convs.items())}
    del convs

    ref = fp32(*ins[0])
    rel = _rel_l2(out["x_hat"], ref["x_hat"])
    bpp = (float(out["bpp"]), float(ref["bpp"]))
    print(f"  x_hat serve-int8 vs fp32: relative L2 {rel:.5f} (gate "
          f"{INT8_REL_TOL}); bpp {bpp[0]:.5f} vs {bpp[1]:.5f}")
    if not rel < INT8_REL_TOL:
        raise AssertionError(f"serve-int8 x_hat {rel} off the fp32 forward")
    # the gate must see a broken dequantize: the weight scale left out (a
    # NaN fails the gate too); per-tensor weight scales are printed beside
    quantize_weight = quant.quantize_weight

    def variant(fn):
        quant.quantize_weight = fn
        try:
            return _rel_l2(int8(*ins[0])["x_hat"], ref["x_hat"])
        finally:
            quant.quantize_weight = quantize_weight

    def tensor_scale(w, tr=False):
        s = torch.clamp_min(w.float().abs().amax() / 127.0, 1e-12)
        wq = torch.round(w.float() / s).clamp_(-127, 127).to(torch.int8)
        return wq, s.expand(w.shape[1] if tr else w.shape[0])

    broken = variant(lambda w, tr=False: (quantize_weight(w, tr)[0], torch.ones(
        w.shape[1] if tr else w.shape[0], device=w.device)))
    seen = not broken < INT8_REL_TOL
    per_tensor = variant(tensor_scale)
    print(f"  the weight scale left out: relative L2 {broken:.5f} -> "
          f"{'seen' if seen else 'FAIL (not seen)'}; per-tensor weight "
          f"scales: relative L2 {per_tensor:.5f}")
    if not seen:
        raise AssertionError("the x_hat gate cannot see a broken dequantize")
    del ref, fp32

    dtime = _device_time()
    img_s = {}
    for rep in ("", " again"):
        for name, p in pipes.items():
            sec = dtime(p, ins, iters=iters, warmup=1, device="cuda")
            img_s[name + rep] = batch / sec
            print(f"  forward {name}{rep}: {batch / sec:.3f} img/s (batch "
                  f"{batch}, 512x768, device_time over {iters} calls)")
    spans = ("int8.quantize", "int8.im2col", "int8.int_mm",
             "int8.dequantize")
    profile = profile_run(torch, lambda: int8(*ins[0]), "serve-int8 forward",
                          spans=spans)
    parts = {k: profile["spans"].get(k, 0.0) for k in spans}
    parts["rest"] = profile["device_busy_ms"] - sum(parts.values())
    print("  serve-int8 forward device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    del pipes, int8
    return {"launches": launches, "x_hat_rel_l2": rel,
            "weight_scale_left_out_rel_l2": broken,
            "per_tensor_weight_scale_rel_l2": per_tensor, "bpp": bpp[0],
            "bpp_fp32": bpp[1], "convs": cases, "img_per_s": img_s,
            "profile": profile, "device_ms": parts}


def parallel_phase(torch, batch: int) -> dict:
    """``initialize()`` at world size 1 over NCCL; PARALLEL_STEPS bf16
    ``RGBTrainer`` steps under ``DistributedDataParallel`` against the same
    steps without it (and the plain run again, its own gap); a sharded
    ``RGBAFileCodec`` round trip on a
    two-replica mesh of cuda:0 against the unsharded codec."""
    import numpy as np
    import tempfile
    import torch.distributed as dist
    from rgba_tpu_torch.core.config import TrainConfig
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY, deterministic_scope
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.parallel.distributed import initialize, process_count
    from rgba_tpu_torch.parallel.launch import free_port
    from rgba_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from rgba_tpu_torch.train.loops import RGBTrainer

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    initialize()
    if not (dist.is_initialized() and dist.get_backend() == "nccl"
            and process_count() == 1):
        raise AssertionError("initialize() made no NCCL group of one")
    print(f"  initialize(): backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}")
    cfg = TrainConfig(train_lambda=1024, batch_size=TRAIN_BATCH, aux_lr=1e-3,
                      compute_dtype="bfloat16")
    steps = [{k: d[k] for k in ("masked_image", "alpha", "image")}
             for d in (synthetic_rgba_batch(TRAIN_BATCH, TRAIN_SIZE,
                                            TRAIN_SIZE, seed=20 + i)
                       for i in range(PARALLEL_STEPS))]
    losses = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, dp in (("plain", False), ("ddp", True),
                         ("plain again", False)):
            trainer = RGBTrainer(cfg, tmp, data_parallel=dp)
            state = trainer.init_state()
            with deterministic_scope():
                losses[name] = [float(trainer.step(state, b)["rd_loss"])
                                for b in steps]
            del trainer, state
    gaps = {k: max(abs(a - b) / abs(b) for a, b in
                   zip(losses[k], losses["plain"]))
            for k in ("ddp", "plain again")}
    print(f"  {PARALLEL_STEPS} bf16 RGBTrainer steps (batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}): plain {losses['plain']}, ddp "
          f"{losses['ddp']}; largest relative gap ddp {gaps['ddp']:.3g} "
          f"(gate {PARALLEL_LOSS_RTOL:g}), plain's own {gaps['plain again']:.3g}")
    if not gaps["ddp"] <= PARALLEL_LOSS_RTOL:
        raise AssertionError("the DDP steps differ from the plain steps")

    h, w = 512, 768
    on = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    _liven(torch, on)
    sh = batch_sharding(make_mesh(devices=["cuda:0", "cuda:0"]))
    codecs = {name: RGBAFileCodec(CodecIO(on.rgb_codec, "rgb", sharding=s),
                                  CodecIO(on.mask_codec, "mask", sharding=s))
              for name, s in (("unsharded", None), ("sharded", sh))}
    d = {k: np.round(v * 255.0).astype(np.uint8) for k, v in
         synthetic_rgba_batch(batch, h, w, seed=0).items()}
    img, alpha = d["image"], d["alpha"]
    out = {}
    for name, c in codecs.items():
        c.decode_batch(c.encode_batch(img, alpha), output="uint8")  # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        blobs = c.encode_batch(img, alpha)
        dec = c.decode_batch(blobs, output="uint8")
        out[name] = (blobs, dec, {n: k.launches
                                  for n, k in _kernels().items()})
    if out["sharded"][0] != out["unsharded"][0]:
        raise AssertionError("the sharded codec's blobs differ")
    if not np.array_equal(out["sharded"][1], out["unsharded"][1]):
        raise AssertionError("the sharded codec's decode differs")
    want = {n: 2 * v for n, v in CODEC_LAUNCHES.items()}
    print(f"  sharded round trip (2 replicas on cuda:0, batch {batch}, "
          f"512x768, fp32, kernels on): blobs byte-identical, decode equal; "
          f"launches {out['sharded'][2]}")
    if out["sharded"][2] != want:
        raise AssertionError(f"sharded launches {out['sharded'][2]}, "
                             f"expected {want}")
    rates = {}
    for name in ("unsharded", "sharded", "sharded again", "unsharded again"):
        c = codecs[name.split()[0]]
        t = time.perf_counter()
        c.decode_batch(c.encode_batch(img, alpha), output="uint8")
        rates[name] = batch / (time.perf_counter() - t)
        print(f"  codec {name}: enc+dec {rates[name]:.3f} img/s (one card: "
              f"correctness, not scaling)")
    for c in codecs.values():
        c.rgb_io.close()
        c.mask_io.close()
    dist.destroy_process_group()
    return {"losses": losses, "loss_gaps": gaps,
            "sharded_launches": out["sharded"][2],
            "sharded_img_per_s": rates}


# ------------------------------------------------------------ space phase

SPACE = 2                  # bands of the phase's height sharding
SPACE_BATCH = 8            # images per process (both ranks hold all 8)
SPACE_HW = (512, 768)
SPACE_TRAIN = (4, 256)     # batch, size of the banded training step
# the kernels' shapes on a band and its halo: (rows of the band at the
# kernel's scale, rows its op adds on each side) for the first band of
# S=2 and an interior band of S=4 at 512x768
SPACE_BAND_ROWS = {"first of 2": (0, 2), "interior of 4": (1, 4)}


def _probe_all_reduce(mesh):
    """A probe rank: one all-reduce of a CUDA tensor over its group."""
    import torch
    import torch.distributed as dist
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t.sum())


def _probe_p2p(mesh):
    """A probe rank: rank 0 sends a CUDA tensor to rank 1, which receives
    it into a CUDA tensor, over the group's backend as it is (no staging)."""
    import torch
    import torch.distributed as dist
    t = torch.arange(1024, dtype=torch.float32, device="cuda")
    if dist.get_rank() == 0:
        dist.send(t, 1)
        return True
    got = torch.zeros_like(t)
    dist.recv(got, 0)
    torch.cuda.synchronize()
    return bool(torch.equal(got, t))


def _probes(torch) -> dict:
    """Both probes, run at once, two ranks each on cuda:0: what each
    returned, or how it failed."""
    from rgba_tpu_torch.parallel.launch import Ranks
    with Ranks("chip_smoke:_probe_all_reduce", 2, device="cuda",
               backend="nccl") as nccl, \
            Ranks("chip_smoke:_probe_p2p", 2, device="cuda",
                  backend="gloo") as gloo:
        out = {}
        for what, r in (("nccl two ranks on cuda:0", nccl),
                        ("gloo send/recv of CUDA tensors", gloo)):
            try:
                out[what] = f"ran: {r.join(timeout=90)}"
            except (RuntimeError, TimeoutError) as e:
                lines = [ln for ln in str(e).splitlines() if "rror" in ln
                         or "Duplicate" in ln]
                out[what] = "refused: " + (lines[-1].strip()[:300] if lines
                                           else str(e).splitlines()[0])
    return out


def band_kernel_cases(torch, batch: int) -> dict:
    """Each conv kernel against its plain version at the shapes a band and
    its halo give it (SPACE_BAND_ROWS), bf16 and fp32: the gate chain on
    the band + 3 rows of each neighbour at H/4 (C=192) and H/8 (C=80), the
    DSE on the band + 6 at full resolution (cio 3 and 1), the attention
    on the band's windows with the band's region ids (the last band's
    carry the wrap) and alive gates, GDN on the band's pixels at H/2."""
    from rgba_tpu_torch.core.precision import Policy, precision_scope
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.ops import attention as att
    from rgba_tpu_torch.ops import window
    from rgba_tpu_torch.ops.enhance import DSE
    from rgba_tpu_torch.ops.kernels import dse as kd
    from rgba_tpu_torch.ops.kernels import gate_chain as kg
    from rgba_tpu_torch.ops.kernels import gdn as kgdn
    from rgba_tpu_torch.ops.kernels import win_attn as ka
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid

    dev = torch.device("cuda")
    h, w = SPACE_HW
    alpha = torch.from_numpy(synthetic_rgba_batch(batch, h, w, seed=0)
                             ["alpha"]).to(dev).permute(0, 3, 1, 2)
    pyr = mask_pyramid(alpha)
    out = {name: [] for name in CONV_KERNELS}
    for band, (index, space) in SPACE_BAND_ROWS.items():
        first = index == 0
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            policy = Policy(compute_dtype=dt)
            gen = torch.Generator().manual_seed(21)
            kw = dict(policy=policy, device=dev, generator=gen)
            with torch.inference_mode(), precision_scope(policy):
                for scale, c in ((4, 192), (8, 80)):
                    rows = h // scale // space
                    ext = rows + (1 if first else 2) * att.CHAIN_HALO
                    for flavour in ("wingate", "simplified"):
                        m = (att.WinGateAttention(c, 8, 8, 0, **kw)
                             if flavour == "wingate"
                             else att.SimplifiedAttention(c, **kw))
                        _bias_noise(torch, m, 22)
                        act, post = ((policy.gelu_kind, True)
                                     if flavour == "wingate" else ("relu", False))
                        x = torch.randn(batch, ext, w // scale, c,
                                        generator=gen).to(dev, dt)
                        g = (torch.randn(batch, ext, w // scale, c,
                                         generator=gen).to(dev, dt)
                             if flavour == "wingate" else None)
                        args = (x, g, *m.gate_chain_weights(), act, post)
                        what = (f"fused_gate_chain {flavour} {band} band "
                                f"B={batch} {ext}x{w // scale} C={c} {dtype}")
                        res = _check(torch, kg.fused_gate_chain(
                            *args, m.kernel_layout(dt)),
                            kg.gate_chain_plain(*args), dtype, what)
                        out["fused_gate_chain"].append(dict(
                            res, shape=f"{flavour},{band},{ext}x{w // scale},"
                            f"C={c}", dtype=dtype))
                        del m, x, g, args
                rows = h // space
                ext = rows + (1 if first else 2) * 6
                for cio, leaky in ((3, False), (1, True)):
                    m = DSE(cio, leaky=leaky, **kw)
                    _bias_noise(torch, m, 23)
                    x = torch.rand(batch, ext, w, cio, generator=gen).to(dev, dt)
                    args = (x, *m.kernel_weights())
                    what = (f"fused_dse {band} band B={batch} {ext}x{w} "
                            f"cio={cio} {dtype}")
                    res = _check(torch, kd.fused_dse(
                        *args, leaky=leaky, prepared=m.kernel_layout(dt)),
                        kd.dse_plain(*args, leaky=leaky), dtype, what)
                    out["fused_dse"].append(dict(
                        res, shape=f"cio={cio},{band},{ext}x{w}", dtype=dtype))
                    del m, x, args
                # the attention: this band's windows, region ids and gates
                for level, ws, ss, c in ((1, 8, 4, 192), (2, 4, 2, 80)):
                    lv = pyr[level]
                    lh, lw = lv.shape[-2:]
                    rows = lh // space
                    for which, idx in (("", index), (" last", space - 1)):
                        a = torch.roll(lv.permute(0, 2, 3, 1), (-ss, -ss),
                                       (1, 2))[:, idx * rows:(idx + 1) * rows]
                        alive = window.window_alive(
                            window.window_partition(a, ws))[:, None]
                        region = torch.from_numpy(window.swin_region_ids(
                            rows, lw, ws, ss, idx * rows, lh)).to(dev).repeat(
                                batch, 1)
                        nw, n, nh = alive.shape[0], ws * ws, 8
                        args = [torch.randn(nw, n, c, generator=gen).to(dev, dt),
                                region, alive,
                                (torch.randn(c, 3 * c, generator=gen)
                                 / c ** 0.5).to(dev, dt),
                                (0.1 * torch.randn(3 * c, generator=gen)).to(dev),
                                (torch.randn(c, c, generator=gen)
                                 / c ** 0.5).to(dev, dt),
                                (0.1 * torch.randn(c, generator=gen)).to(dev),
                                torch.randn(nh, n, n, generator=gen).to(dev)]
                        tag = f"{band}{which}"
                        what = (f"fused_window_attention {tag} band nW={nw} "
                                f"N={n} C={c} {dtype}")
                        res = _check(torch, ka.fused_window_attention(
                            *args, num_heads=nh, prepared=ka.kernel_weights(
                                *args[3:7], nh, dt)),
                            ka.window_attention_plain(*args, num_heads=nh),
                            dtype, what)
                        out["fused_window_attention"].append(dict(
                            res, shape=f"{tag},nW={nw},N={n},C={c}",
                            dtype=dtype))
                m = batch * (h // 2 // space) * (w // 2)
                x = torch.randn(m, 192, generator=gen).to(dev, dt)
                gt = (0.1 * torch.eye(192) + 1e-3 * torch.rand(
                    192, 192, generator=gen)).to(dev)
                beta = (1.0 + 0.1 * torch.rand(192, generator=gen)).to(dev)
                res = _check(torch, kgdn.fused_gdn(
                    x, gt, beta, False, kgdn.kernel_weights(gt, dt)),
                    kgdn.gdn_plain(x, gt, beta, False), dtype,
                    f"fused_gdn {band} band M={m} C=192 {dtype}")
                out["fused_gdn"].append(dict(res, shape=f"{band},M={m}",
                                             dtype=dtype))
                del x
    return out


def space_rank(mesh, state_path: str, batch: int, iters: int) -> dict:
    """One rank of the phase's banded forwards (``launch.Ranks`` calls it,
    two on cuda:0 over gloo): ``RGBAPipeline`` with all four kernels, bf16
    and fp32, on this rank's band of the phase's images; launches, peak
    memory, bytes and host seconds of the exchanges per forward, img/s of
    the space group, one profiled bf16 forward."""
    import torch
    from rgba_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.parallel import spatial

    state = torch.load(state_path, map_location="cpu")
    d = synthetic_rgba_batch(batch, *SPACE_HW, seed=0)
    rows = mesh.band_slice(SPACE_HW[0])
    x = torch.from_numpy(d["masked_image"][:, rows]).cuda()
    a = torch.from_numpy(d["alpha"][:, rows]).cuda()
    out = {}
    for name, policy in (("bf16", BF16_POLICY), ("fp32", DEFAULT_POLICY)):
        pipe = RGBAPipeline(_all_kernels(policy), seed=0)
        pipe.load_state_dict(state)
        with spatial.space_scope(mesh):
            pipe(x, a)                                  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            _reset_launches()
            spatial.traffic.reset()
            t = time.perf_counter()
            r = pipe(x, a)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            res = {"x_hat": r["x_hat"].float().cpu(),
                   "recon_mask": r["recon_mask"].cpu(),
                   **{k: float(r[k]) for k in ("bpp", "bpp_rgb", "bpp_mask",
                                               "mse_loss")},
                   "launches": {n: k.launches for n, k in _kernels().items()},
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "resident_bytes": resident,
                   "traffic": spatial.traffic.as_dict(), "wall_s": wall}
            res["exchange_share"] = res["traffic"]["seconds"] / wall
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                pipe(x, a)
            torch.cuda.synchronize()
            res["img_per_s"] = batch * iters / (time.perf_counter() - t)
            if name == "bf16":
                spatial.traffic.reset()
                res["profile"] = profile_run(torch, lambda: pipe(x, a),
                                             "banded forward", top=8)
                res["profile"]["exchange_s"] = spatial.traffic.seconds
        out[name] = res
        del pipe
        torch.cuda.empty_cache()
    return out


def space_phase(torch, iters: int) -> dict:
    """Height sharding (``parallel/spatial.py``) on one card: the
    transports' probes, the kernels at band shapes, the banded pipeline on
    two ranks of cuda:0 over gloo against the unbanded one, and a banded
    fp32 training step against one process."""
    import tempfile
    from rgba_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.parallel.dryrun import dryrun_multichip
    from rgba_tpu_torch.parallel.launch import Ranks

    probes = _probes(torch)
    for k, v in probes.items():
        print(f"  probe, {k}: {v}")
    print(f"  transport: {SPACE} ranks on cuda:0 over gloo; halo and shift "
          f"rows staged through the host (gloo's send/recv address host "
          f"memory), gathers and sums on CUDA tensors by gloo")
    print(f"  kernels at band + halo shapes (batch {SPACE_BATCH}, "
          f"{SPACE_HW[0]}x{SPACE_HW[1]}):")
    band_cases = band_kernel_cases(torch, SPACE_BATCH)

    d = synthetic_rgba_batch(SPACE_BATCH, *SPACE_HW, seed=0)
    x = torch.from_numpy(d["masked_image"]).cuda()
    a = torch.from_numpy(d["alpha"]).cuda()
    whole = {}
    with tempfile.TemporaryDirectory() as tmp:
        state_path = os.path.join(tmp, "state.pt")
        for name, policy in (("bf16", BF16_POLICY), ("fp32", DEFAULT_POLICY)):
            pipe = RGBAPipeline(_all_kernels(policy), seed=0)
            if name == "bf16":
                _liven(torch, pipe)
                torch.save(pipe.state_dict(), state_path)
            else:
                pipe.load_state_dict(torch.load(state_path))
            pipe(x, a)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            r = pipe(x, a)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            t = time.perf_counter()
            for _ in range(iters):
                pipe(x, a)
            torch.cuda.synchronize()
            whole[name] = {"x_hat": r["x_hat"].float(), "bpp": float(r["bpp"]),
                           "peak_bytes": peak, "resident_bytes": resident,
                           "img_per_s": SPACE_BATCH * iters
                           / (time.perf_counter() - t)}
            del pipe, r
        del x, a
        torch.cuda.empty_cache()
        t = time.perf_counter()
        with Ranks("chip_smoke:space_rank", SPACE, space=SPACE,
                   device="cuda", backend="gloo",
                   args=(state_path, SPACE_BATCH, iters)) as ranks:
            bands = ranks.join(timeout=600)
        print(f"  {SPACE} banded ranks: {time.perf_counter() - t:.1f} s "
              f"with their start")
    out = {"probes": probes, "band_cases": band_cases}
    for name in ("bf16", "fp32"):
        ref = whole[name]
        got = torch.cat([b[name]["x_hat"] for b in bands], dim=1).cuda()
        bpp = [b[name]["bpp"] for b in bands]
        bpp_rel = max(abs(v - ref["bpp"]) / abs(ref["bpp"]) for v in bpp)
        print(f"  {name} banded (S={SPACE}) vs unbanded, batch "
              f"{SPACE_BATCH}, {SPACE_HW[0]}x{SPACE_HW[1]}, all four kernels:")
        if name == "bf16":
            ok, max_abs, _, tol = _within(torch, got, ref["x_hat"], "bfloat16")
            print(f"    x_hat max_abs {max_abs:.3g} (tol {tol}); bpp "
                  f"{bpp} vs {ref['bpp']:.7f} (rel {bpp_rel:.3g})")
            gate = {"max_abs": max_abs, "ok": ok}
        else:
            gate = _bulk_agreement(got, ref["x_hat"], "    fp32 banded vs unbanded")
            print(f"    bpp {bpp} vs {ref['bpp']:.7f} (rel {bpp_rel:.3g}, "
                  f"gate 1e-4)")
            gate["ok"] = gate["ok"] and bpp_rel <= 1e-4
        per_rank = []
        for s, b in enumerate(bands):
            r = b[name]
            launches = {k: v for k, v in r["launches"].items()}
            tr = r["traffic"]
            print(f"    rank {s}: launches {launches}; peak "
                  f"{r['peak_bytes'] / 2**30:.3f} GiB, of it above the "
                  f"resident weights and inputs "
                  f"{(r['peak_bytes'] - r['resident_bytes']) / 2**30:.3f} "
                  f"(unbanded {ref['peak_bytes'] / 2**30:.3f}, "
                  f"{(ref['peak_bytes'] - ref['resident_bytes']) / 2**30:.3f});"
                  f" halo and shift bytes "
                  f"sent {tr['p2p_bytes']}, gather and sum bytes "
                  f"{tr['collective_bytes']}; exchanges "
                  f"{1e3 * tr['seconds']:.3f} ms of a {1e3 * r['wall_s']:.3f} "
                  f"ms forward ({100 * r['exchange_share']:.1f}%)")
            if launches != FORWARD_LAUNCHES:
                raise AssertionError(f"{name} banded forward, rank {s}: "
                                     f"launches {launches}, expected "
                                     f"{FORWARD_LAUNCHES}")
            per_rank.append({k: r[k] for k in (
                "launches", "peak_bytes", "resident_bytes", "traffic", "wall_s",
                "exchange_share", "img_per_s", "bpp", "bpp_rgb", "bpp_mask",
                "mse_loss")})
        print(f"    img/s banded {bands[0][name]['img_per_s']:.3f} (the space "
              f"group) vs unbanded {ref['img_per_s']:.3f} (one card: "
              f"correctness, not scaling)")
        if not gate["ok"]:
            raise AssertionError(f"{name} banded pipeline differs from the "
                                 f"unbanded one")
        out[name] = {"gate": gate, "bpp_rel": bpp_rel, "ranks": per_rank,
                     "unbanded": {k: ref[k] for k in (
                         "bpp", "peak_bytes", "resident_bytes", "img_per_s")}}
    prof = bands[0]["bf16"]["profile"]
    out["profile"] = prof
    print(f"  profiled banded bf16 forward, rank 0: exchanges "
          f"{1e3 * prof['exchange_s']:.3f} ms of {prof['wall_ms']:.3f} ms "
          f"wall ({100 * 1e3 * prof['exchange_s'] / prof['wall_ms']:.1f}%)")
    t = time.perf_counter()
    b, size = SPACE_TRAIN
    dry = dryrun_multichip(SPACE, device="cuda", space=SPACE, backend="gloo",
                           kernels=True, batch=b, size=size)
    print(f"  banded fp32 RGBTrainer step, kernels on (S={SPACE}, batch {b}, "
          f"{size}x{size}) vs one process: loss rel {dry['loss_rel']:.3g}, "
          f"worst parameter at {dry['grad_worst_ratio']:.3g} of its bound "
          f"({dry['grad_worst_param']}; max |dg| at "
          f"{dry['grad_worst_max_ratio']:.3g}); launches per rank "
          f"{dry['launches']}, {time.perf_counter() - t:.1f} s")
    want = {k: _step_launches("rgb")[k] for k in CONV_KERNELS}
    if dry["launches"] != want:
        raise AssertionError(f"banded step launches {dry['launches']}, "
                             f"expected {want}")
    out["train"] = dry
    return out


WORKFLOW_STEPS = 100         # bf16 steps of each trainer (phase 9)
WORKFLOW_IMAGES = 2          # of the real-codec eval, at EVAL_HW


def workflow_phase(torch) -> dict:
    """The trained-weight workflow (``rgba_tpu_torch/tools``): both
    trainers trained WORKFLOW_STEPS steps with the four kernels on, the
    crash-resume check of each, then the trained pair through the real
    codec: ``evaluate_kodak(real_codec=True)`` over 2 synthetic 512x768
    images and a byte-identical re-encode."""
    import tempfile
    import numpy as np
    from rgba_tpu_torch.data.datasets import KodakDataset
    from rgba_tpu_torch.tools import _common as wf
    from rgba_tpu_torch.tools.full_workflow_proof import check_point

    steps, out = WORKFLOW_STEPS, {"steps": WORKFLOW_STEPS,
                                  "batch": TRAIN_BATCH, "size": TRAIN_SIZE}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        data = wf.synth_data(4 * TRAIN_BATCH, TRAIN_SIZE, "cuda")
        ck, launches = {}, {}
        for kind, name in (("mask", "mask"), ("rgb", "rgb_1024")):
            _reset_launches()
            run = wf.train_one(name, kind, 1024, steps, work, data=data,
                               batch_size=TRAIN_BATCH, log_every=50)
            launches[kind] = _read_launches(
                {n: steps * c for n, c in _step_launches(kind).items()},
                f"{steps} {kind} steps")
            rd = [p["rd_loss"] for p in run["curve"]]
            head, tail = sum(rd[:10]) / 10, sum(rd[-10:]) / 10
            print(f"  {kind}: rd {rd[0]:.3f} -> {rd[-1]:.3f} (first 10 "
                  f"{head:.3f}, last 10 {tail:.3f}), "
                  f"{run['steps_per_s']:.3f} steps/s at batch {TRAIN_BATCH}")
            if not all(math.isfinite(v) for v in rd) or not tail < head:
                raise AssertionError(f"{kind}: the loss did not descend")
            batch = {k: data[k][:TRAIN_BATCH]
                     for k in run["trainer"].batch_keys}
            parity = wf.resume_parity(kind, run, batch)
            print(f"  {kind} crash-resume: rel {parity['rel']:.3g} "
                  f"(tol {wf.RESUME_RTOL:g})")
            if not parity["rel"] <= wf.RESUME_RTOL:
                raise AssertionError(f"{kind}: the resumed step's loss "
                                     f"differs by {parity['rel']}")
            out[kind] = {"first_rd": rd[0], "last_rd": rd[-1],
                         "first_10": head, "last_10": tail,
                         "steps_per_s": run["steps_per_s"],
                         "resume": parity}
            ck[kind] = wf.latest_checkpoint(run["ckdir"])
            del run
        del data
        tree = wf.kodak_tree(work, WORKFLOW_IMAGES, EVAL_HW)
        codec = wf.make_codec("cuda")
        try:
            _reset_launches()
            point = wf.eval_point(codec, tree, ck["rgb"], ck["mask"])
            launches["eval"] = _read_launches(
                dict(_launch_counts(0, 0, 0, 0, conv3x3=WORKFLOW_IMAGES * (
                    CONV3X3_CODEC + CONV3X3_RGB_FORWARD)), **{
                    n: WORKFLOW_IMAGES * c
                    for n, c in wf.EVAL_IMAGE_LAUNCHES.items()}),
                f"evaluate_kodak of {WORKFLOW_IMAGES} images")
            print("  trained pair, real codec: " + ", ".join(
                f"{k} {point[k]:.6g}" for k in ("bpp", "real_bpp", "psnr",
                                                "psnr_real", "msssim",
                                                "codec_err")))
            parts = check_point(codec, tree, point)
            print(f"  real bpp within (0.5 x bpp, 1.5 x bpp + 0.1); "
                  f"codec_err {point['codec_err']:.3g} held"
                  + (f", {len(parts)} images' parts within a rounded tie"
                     if parts else ""))
            ds = KodakDataset(tree)
            items = [ds.get(i) for i in range(len(ds))]
            img = np.stack([it["image"] for it in items])
            alpha = np.stack([it["alpha"] for it in items])
            blobs = codec.encode_batch(img, alpha)
            if codec.encode_batch(img, alpha) != blobs:
                raise AssertionError("trained pair: a re-encode differs")
            print(f"  re-encode of {len(blobs)} blobs byte-identical, "
                  f"{sum(map(len, blobs))} bytes")
        finally:
            codec.rgb_io.close()
            codec.mask_io.close()
    out.update(point=point, codec_err_parts=parts, launches=launches,
               seconds=time.perf_counter() - t)
    # per kernel: both trainers' runs and the eval, each counted from 0
    out["launches_workflow"] = {
        n: {"rgb_steps": launches["rgb"][n], "mask_steps": launches["mask"][n],
            "eval": launches["eval"][n]} for n in KERNEL_NAMES}
    return out


# runs in either checkout, through that checkout's own chip_smoke.py, its
# cases timed by this checkout's _time_ms (argv[1] this file)
AB_WORKER = """
import importlib.util, json, sys, torch
import chip_smoke as cs
from rgba_tpu_torch.ops.kernels import build
spec = importlib.util.spec_from_file_location("head_smoke", sys.argv[1])
head = importlib.util.module_from_spec(spec)
spec.loader.exec_module(head)
cs._time_ms = head._time_ms
build.build_all(list(cs._kernels().values()))
batch, iters = int(sys.argv[2]), int(sys.argv[3])
cases = []
for fn in (cs.gdn_cases, cs.attention_cases, cs.gate_chain_cases,
           cs.dse_cases):
    cases += [dict(c, kernel=fn.__name__) for c in fn(torch, batch, iters)]
print("RESULT " + json.dumps(cases))
"""

# runs in either checkout on the inputs ``rans_ab_inputs`` saved: that
# checkout's rans_decode / rans_encode wrappers, each timed run from its own
# copy of the lane state made before the clock starts, timed by this
# checkout's _time_ms (argv[1] this file) with the card held and without;
# a tree whose device_rans has ``segment_tables`` gets the layout of each
# segment's row group, as its CodecIO passes it (an older tree reads the
# dense inverse tables of the y rows)
AB_RANS_WORKER = """
import importlib.util, json, sys, torch
from rgba_tpu_torch.entropy import device_rans as dr
from rgba_tpu_torch.ops.kernels import build, rans_decode as rd
from rgba_tpu_torch.ops.kernels import rans_encode as re_
spec = importlib.util.spec_from_file_location("head_smoke", sys.argv[1])
head = importlib.util.module_from_spec(spec)
spec.loader.exec_module(head)
build.build_all([rd.KERNEL, re_.KERNEL])
data = torch.load(sys.argv[2])
iters = int(sys.argv[3])
tables = {k: v.cuda() for k, v in data["tables"].items()}
inverse = {k: v.cuda() for k, v in data["inverse"].items()}
groups = {}

def segment(seg):
    rows = tuple(seg["rows"])
    if rows not in groups:
        groups[rows] = (dr.segment_tables(tables, rows)
                        if hasattr(dr, "segment_tables") else tables)
    return dict(seg, tables=groups[rows],
                inverse=inverse if seg["y"] else None,
                **{k: seg[k].cuda() for k in seg["inputs"]})

out = []
for c in data["cases"]:
    segs = [segment(seg) for seg in c["segments"]]
    n = iters if len(segs) > 1 else 4 * iters
    fresh = [{k: c[k].cuda() for k in c["carries"]} for _ in range(2 * n + 5)]
    if c["kernel"] == "rans_decode":
        words, lane_end = c["words"].cuda(), c["lane_end"].cuda()
        def run():
            f = fresh.pop()
            st, pt, syms = f["state"], f["ptr"], []
            for s in segs:
                y, st, pt = rd.rans_decode(s["tables"], words, st, pt,
                                           s["idx"], s["act"], lane_end,
                                           inverse=s["inverse"])
                syms.append(y)
            return syms + [st, pt]
    else:
        def run():
            f = fresh.pop()
            st, wp, ow = f["state"], f["wptr"], f["out"]
            for s in segs:
                st, wp, ow = re_.rans_encode(s["tables"], st, wp, ow,
                                             s["idx"], s["sym"], s["act"])
            return [st, wp, ow]
    got = run()
    torch.cuda.synchronize()
    equal = len(got) == len(c["want"]) and all(
        torch.equal(g.cpu(), w) for g, w in zip(got, c["want"]))
    out.append({"kernel": c["kernel"], "dtype": "int", "shape": c["name"],
                "ms": head._time_ms(torch, run, n),
                "unheld_ms": head._time_ms(torch, run, n, hold=False),
                "max_abs_err": 0.0 if equal else float("inf")})
print("RESULT " + json.dumps(out))
"""


def rans_ab_inputs(torch, batch: int, path: Path) -> None:
    """The RGB segments of a v3 decode (the live weights of the codec
    phase, ~21 bpp) and of a device v3 encode (encoder gain ENCODE_GAIN,
    every lane within its budget), batch ``batch``, 512x768, recorded
    through this tree's codec (plain convolutions) and saved to ``path``
    for ``AB_RANS_WORKER``: for each kernel the z segment and y slice 0
    alone and the 11 segments back to back, each case with its segments'
    inputs, the lane state before its first and the outputs it must give."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.entropy import device_rans as dr
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.models.pipeline import RGBAPipeline

    data = {k: np.round(v * 255.0).astype(np.uint8) for k, v in
            synthetic_rgba_batch(batch, 512, 768, seed=0).items()}
    img, alpha = data["image"], data["alpha"]
    cases, saved = [], {}
    for kernel, gain in (("rans_decode", 10.0), ("rans_encode", ENCODE_GAIN)):
        model = RGBAPipeline(DEFAULT_POLICY, seed=0)
        _liven(torch, model, gain=gain)
        codec = RGBAFileCodec(CodecIO(model.rgb_codec, "rgb"),
                              CodecIO(model.mask_codec, "mask"))
        m = codec.rgb_io._lane_tables()["merged"]
        z_off, n_rows = m["z_row_offset"], m["cdfs"].shape[0]
        saved = {"tables": {k: torch.from_numpy(m[k]) for k in
                            ("cdfs", "max_values", "offsets")},
                 "inverse": {k: torch.from_numpy(v) for k, v in
                             dr.build_inverse(m["cdfs"][:z_off],
                                              m["max_values"][:z_off] + 2)
                             .items()}}

        def seg(c, keys):
            y = int(c["idx"].max()) < z_off
            return {"rows": (0, z_off) if y else (z_off, n_rows), "y": y,
                    "inputs": keys, **{k: c[k].cpu() for k in keys}}
        if kernel == "rans_decode":
            blobs = codec.encode_batch(img, alpha, stream_format="lanes32")
            with _recorded_segments(torch) as calls:
                codec.decode_batch(blobs)
            rgb = calls[-11:]
            if any(c["words"].data_ptr() != rgb[0]["words"].data_ptr() or
                   not torch.equal(c["lane_end"], rgb[0]["lane_end"])
                   for c in rgb):
                raise AssertionError("rans_ab_inputs: the RGB segments do "
                                     "not share one stream")
            for name, part in (("z", rgb[:1]), ("y slice 0", rgb[1:2]),
                               ("11 RGB segments", rgb)):
                cases.append({
                    "kernel": kernel, "name": name,
                    "segments": [seg(c, ("idx", "act")) for c in part],
                    "carries": ("state", "ptr"),
                    **{k: part[0][k].cpu() for k in ("state", "ptr")},
                    **{k: rgb[0][k].cpu() for k in ("words", "lane_end")},
                    "want": [c["syms"].cpu() for c in part] +
                            [part[-1]["state_out"].cpu(),
                             part[-1]["ptr_out"].cpu()]})
        else:
            os.environ["RGBA_TPU_DEVICE_ENCODE"] = "1"
            try:
                with _recorded_encodes(torch) as calls:
                    codec.encode_batch(img, alpha, stream_format="lanes32")
            finally:
                os.environ["RGBA_TPU_DEVICE_ENCODE"] = "0"
            if codec.rgb_io.last_lane_encode["overflow"]:
                raise AssertionError("rans_ab_inputs: the encode overflowed")
            rgb = calls[-11:]              # y slices 9 .. 0, then z
            for name, part in (("y slice 0", rgb[9:10]), ("z", rgb[10:]),
                               ("11 RGB segments", rgb)):
                cases.append({
                    "kernel": kernel, "name": name,
                    "segments": [seg(c, ("idx", "sym", "act")) for c in part],
                    "carries": ("state", "wptr", "out"),
                    **{k: part[0][k].cpu() for k in ("state", "wptr", "out")},
                    "want": [part[-1][k].cpu() for k in
                             ("state_out", "wptr_out", "out_out")]})
        codec.rgb_io.close()
        codec.mask_io.close()
    torch.save({"cases": cases, **saved}, path)


def ab_phase(torch, base: Path, batch: int, iters: int) -> dict:
    """Each tree's kernels in a process of its own, in turns base, head,
    head, base: the four conv kernels' own cases and the two rANS kernels
    on the inputs ``rans_ab_inputs`` recorded here, all timed by this
    tree's ``_time_ms``."""
    import tempfile
    head = Path(__file__).resolve().parent
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "rans_inputs.pt"
        t = time.perf_counter()
        rans_ab_inputs(torch, batch, inputs)
        print(f"  rANS inputs recorded in {time.perf_counter() - t:.1f} s")
        timer = str(head / "chip_smoke.py")
        workers = [(AB_WORKER, [timer, str(batch), str(iters)]),
                   (AB_RANS_WORKER, [timer, str(inputs), str(iters)])]
        for name, tree in (("base", base), ("head", head), ("head", head),
                           ("base", base)):
            cases = []
            for code, args in workers:
                proc = subprocess.run(
                    [sys.executable, "-c", code, *args], cwd=tree,
                    env=dict(os.environ, PYTHONPATH=str(tree)),
                    capture_output=True, text=True, timeout=900)
                res = [ln for ln in proc.stdout.splitlines()
                       if ln.startswith("RESULT ")]
                if proc.returncode or not res:
                    raise RuntimeError(f"the kernels of {tree} failed:\n"
                                       f"{proc.stdout[-3000:]}\n"
                                       f"{proc.stderr[-3000:]}")
                cases += json.loads(res[-1][len("RESULT "):])
            for c in cases:
                unheld = (f", card not held {c['unheld_ms']:.4f}"
                          if "unheld_ms" in c else "")
                print(f"  {name} {c['kernel']} {c['dtype']} {c['shape']}: ms "
                      f"{c['ms']:.4f}{unheld} (max_abs_err "
                      f"{c['max_abs_err']:.3g})")
                if c["kernel"].startswith("rans") and c["max_abs_err"]:
                    raise AssertionError(f"{name} {c['kernel']} {c['shape']}: "
                                         f"not the recorded outputs")
            turns.append({"tree": name, "cases": cases})
    return {"base": str(base), "batch": batch, "iters": iters,
            "turns": turns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--base", type=Path, default=None,
                    help="another checkout whose kernels to time against "
                         "this one's")
    ap.add_argument("--only", choices=("space", "workflow"), default=None,
                    help="build, then run this phase alone (a quick check; "
                         "prints its result, not the ok line)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the host lane coder, unless a phase asks for the device encode
    import os
    os.environ["RGBA_TPU_DEVICE_ENCODE"] = "0"
    try:
        from rgba_tpu_torch.native import rans
        from rgba_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the rgba_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    if args.base is not None:
        print(f"the kernels, {args.base} against this tree:")
        report = ab_phase(torch, args.base.resolve(), args.batch,
                          args.iters)
        print(card)
        print(json.dumps(report))
        return 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        rans_build = pool.submit(rans.build)       # g++ beside the nvccs
        logs = build.build_all(list(_kernels().values()))
        print(f"rANS library {rans_build.result().name}")
    print(f"kernel and rANS build {time.perf_counter() - t0:.1f} s")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")

    phase_s = {"build": time.perf_counter() - t0}
    if args.only is not None:
        print(f"{args.only} phase alone:")
        alone = (space_phase(torch, args.iters) if args.only == "space"
                 else workflow_phase(torch))
        print(f"phase seconds: build {phase_s['build']:.1f}, {args.only} "
              f"{time.perf_counter() - t0 - phase_s['build']:.1f}")
        print(card)
        print(json.dumps({args.only: alone}))
        return 0
    t = time.perf_counter()
    print("card health:")
    health = health_phase(torch)
    phase_s["health"] = time.perf_counter() - t
    t = time.perf_counter()
    print("kernels at the main paths' shapes:")
    res = {"fused_gdn": gdn_cases(torch, args.batch, args.iters),
           "fused_window_attention": attention_cases(torch, args.batch,
                                                     args.iters),
           "fused_gate_chain": gate_chain_cases(torch, args.batch, args.iters),
           "fused_dse": dse_cases(torch, args.batch, args.iters),
           "conv3x3": conv3x3_cases(torch, args.batch, args.iters)}
    phase_s["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    print("forward path:")
    path = path_phase(torch, args.batch, args.iters)
    phase_s["forward"] = time.perf_counter() - t
    t = time.perf_counter()
    print("serve-int8 forward (dynamic W8A8 convolutions):")
    int8 = int8_phase(torch, args.batch, args.iters)
    phase_s["int8"] = time.perf_counter() - t
    t = time.perf_counter()
    print("codec path:")
    codec = codec_phase(torch, args.batch, args.iters)
    phase_s["codec"] = time.perf_counter() - t
    t = time.perf_counter()
    print("eval and CLI entry points (Kodak size, 512x768):")
    evals = eval_phase(torch, args.iters)
    phase_s["eval"] = time.perf_counter() - t
    t = time.perf_counter()
    print(f"kernels at the train path's shapes (batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}):")
    size = (TRAIN_BATCH, args.iters, TRAIN_SIZE, TRAIN_SIZE)
    for name, cases in (("fused_gdn", gdn_cases),
                        ("fused_window_attention", attention_cases),
                        ("fused_gate_chain", gate_chain_cases),
                        ("fused_dse", dse_cases)):
        res[name] += cases(torch, *size)
    print("train path:")
    train = train_phase(torch)
    phase_s["train"] = time.perf_counter() - t
    t = time.perf_counter()
    print("data parallel (torch.distributed, one card):")
    parallel = parallel_phase(torch, args.batch)
    phase_s["parallel"] = time.perf_counter() - t
    t = time.perf_counter()
    print("height sharding (two ranks on cuda:0 over gloo):")
    space = space_phase(torch, args.iters)
    phase_s["space"] = time.perf_counter() - t
    t = time.perf_counter()
    print(f"trained-weight workflow ({WORKFLOW_STEPS} bf16 steps of each "
          f"trainer, batch {TRAIN_BATCH}, {TRAIN_SIZE}x{TRAIN_SIZE}):")
    workflow = workflow_phase(torch)
    phase_s["workflow"] = time.perf_counter() - t
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()))

    meta = {
        "fused_window_attention": ("rgba_tpu_torch/csrc/win_attn.cu",
                                   "rgba_tpu/ops/pallas/win_attn.py:66",
                                   "nW=%d,N=64" % (args.batch * 384)),
        "fused_gdn": ("rgba_tpu_torch/csrc/gdn.cu",
                      "rgba_tpu/ops/pallas/gdn.py:48", "M="),
        "fused_gate_chain": ("rgba_tpu_torch/csrc/gate_chain.cu",
                             "rgba_tpu/ops/pallas/gate_chain.py:201",
                             "wingate,B=%d,128x192" % args.batch),
        "fused_dse": ("rgba_tpu_torch/csrc/dse.cu",
                      "rgba_tpu/ops/pallas/dse.py:135", "cio=3"),
    }

    def headline_case(name, dtype):
        _, _, headline = meta[name]
        return next(c for c in res[name] if c["shape"].startswith(headline)
                    and c["dtype"] == dtype)

    def entry(name):
        source, replaces, _ = meta[name]
        h = headline_case(name, "bfloat16")
        # the codec's path runs fp32: its case at the main path's shape,
        # with the launches of one encode + decode
        f = headline_case(name, "float32")
        fp32 = {k: f[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                  "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "bound_3xtf32_ms",
                                  "bound_cuda_cores_ms")}
        fp32["launches"] = codec["launches"][name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "status": "ported",
                "launches": path["launches"][name],
                "launches_codec": codec["launches"][name],
                "launches_train": train["launches_train"][name],
                "launches_eval": evals["kodak"]["on"]["launches"]
                ["evaluate_kodak"][name],
                "launches_export": evals["export"]["all_kernels"]["launches"]
                [name],
                # per rank: a banded bf16 forward and a banded fp32 step
                "launches_space": space["bf16"]["ranks"][0]["launches"][name],
                "launches_space_train": space["train"]["launches"][name],
                "launches_workflow": workflow["launches_workflow"][name],
                "band_cases": space["band_cases"][name],
                "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                "shape": h["shape"], "dtype": h["dtype"], "fp32": fp32,
                "cases": res[name]}

    lanes = codec["lanes"]

    def rans_entry():
        # the v3 RGB decode's first y slice; launches of one v3 decode
        y0, z = lanes["segments"]["y slice 0"], lanes["segments"]["z"]
        return {"name": "rans_decode", "route": "cuda",
                "source": "rgba_tpu_torch/csrc/rans_decode.cu",
                "replaces": "rgba_tpu/entropy/device_rans.py:118",
                "status": "ported", "launches": lanes["launches"],
                "launches_forward": path["launches"]["rans_decode"],
                "launches_codec_v1": codec["launches"]["rans_decode"],
                "launches_train": train["launches_train"]["rans_decode"],
                "launches_workflow": workflow["launches_workflow"]["rans_decode"],
                "launches_cli_decode_dir": evals["codec_cli"]["lanes32"]
                ["launches_decode"]["rans_decode"],
                "max_abs_err": lanes["max_abs_err"], "ms": y0["ms"],
                "plain_ms": y0["plain_ms"],
                "bound_ms": y0["bound_ms"], "bound_by": "bytes",
                "chain_bound_ms": y0["chain_bound_ms"],
                "library_ms": None,
                "shape": "y slice 0, (steps, images, lanes) = %s"
                         % (tuple(y0["shape"]),),
                "dtype": "int32 indexes, int16 words", "z_segment": z,
                "rgb_chain_ms": lanes["rgb_chain_ms"],
                "host_decode_lanes_ms": lanes["host_decode_lanes_ms"]}

    enc = codec["encode"]

    def rans_encode_entry():
        # the device v3 encode's RGB y slice 0; launches of one container
        # encode with RGBA_TPU_DEVICE_ENCODE=1
        y0, z = enc["segments"]["y slice 0"], enc["segments"]["z"]
        return {"name": "rans_encode", "route": "cuda",
                "source": "rgba_tpu_torch/csrc/rans_encode.cu",
                "replaces": "rgba_tpu/entropy/device_rans.py:272",
                "status": "ported", "launches": enc["launches"],
                "launches_forward": path["launches"]["rans_encode"],
                "launches_codec_v1": codec["launches"]["rans_encode"],
                "launches_train": train["launches_train"]["rans_encode"],
                "launches_workflow": workflow["launches_workflow"]["rans_encode"],
                "max_abs_err": enc["max_abs_err"], "ms": y0["ms"],
                "plain_ms": y0["plain_ms"], "bound_ms": y0["bound_ms"],
                "bound_by": "bytes", "chain_bound_ms": y0["chain_bound_ms"],
                "library_ms": None,
                "shape": "y slice 0, (steps, images, lanes) = %s"
                         % (tuple(y0["shape"]),),
                "dtype": "uint8 indexes, int16 symbols", "z_segment": z,
                "rgb_chain_ms": enc["rgb_chain_ms"],
                "host_encode_lanes_ms": enc["host_encode_lanes_ms"]}

    def conv3x3_entry():
        # TCM's largest shape; launches of one paper-codec encode + decode
        h = res["conv3x3"][0]
        return {"name": "conv3x3", "route": "cuda",
                "source": "rgba_tpu_torch/csrc/conv3x3.cu",
                "replaces": None, "status": "added (the JAX package leaves "
                "convolutions to XLA)",
                "launches_forward": path["launches"]["conv3x3"],
                "launches_codec": codec["launches"]["conv3x3"],
                "launches_train": train["launches_train"]["conv3x3"],
                "launches_eval": evals["kodak"]["on"]["launches"]
                ["evaluate_kodak"]["conv3x3"],
                "launches_eval_four_off": evals["kodak"]["off"]["launches"]
                ["evaluate_kodak"]["conv3x3"],
                "launches_cli_decode_dir": evals["codec_cli"]["v64"]
                ["launches_decode"]["conv3x3"],
                "launches_workflow": workflow["launches_workflow"]["conv3x3"],
                **{k: h[k] for k in ("max_abs_err", "cudnn_max_abs_err",
                                     "ms", "layout_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "bound_3xtf32_ms", "bound_cuda_cores_ms",
                                     "tf32_bound_ms", "shape", "dtype")},
                "cases": res["conv3x3"]}

    line = {
        "kernels": [entry(name) for name in CONV_KERNELS] + [
            rans_entry(), rans_encode_entry(), conv3x3_entry()],
        "pending": [],
        "path": {k: v for k, v in path.items() if k != "launches"},
        "codec": {k: v for k, v in codec.items()
                  if k not in ("launches", "lanes", "encode")},
        "encode": {k: v for k, v in enc.items() if k != "segments"},
        "lanes": {k: v for k, v in lanes.items() if k != "segments"},
        "train": {k: v for k, v in train.items() if k != "launches_train"},
        "eval": evals,
        "health": health,
        "int8": int8,
        "parallel": parallel,
        "space": {k: v for k, v in space.items() if k != "band_cases"},
        "workflow": {k: v for k, v in workflow.items()
                     if k != "launches_workflow"},
        "phase_seconds": phase_s,
    }
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
