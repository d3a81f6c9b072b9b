#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts, and is right, on one GPU.

    python3 chip_smoke.py [--batch 16] [--iters 5]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), nvcc, g++ and PyTorch built for CUDA.  Phases, each fatal on
failure:

1. card and build: prints the card's name and power limit (nvidia-smi),
   builds every CUDA kernel of the port from ``rgba_tpu_torch/csrc`` (one
   nvcc per source, all started together) and, beside them, the host rANS
   coder from ``rgba_tpu_torch/native/rans.cpp`` with g++;
2. kernels: each kernel at the main paths' shapes (batch 16, 512x768), in
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
   cores' 67 TFLOP/s printed beside);
3. forward: ``RGBAPipeline`` at batch 16, 512x768, bf16 with all four
   kernels on: shapes, finiteness, the launch count of each kernel in one
   forward, images/s (kernels on, then off, twice each), one profiled
   forward (device time by kernel, device busy share); images/s and the
   launch counts of the default serving route (``SERVE_POLICY``: bf16 with
   the attention kernel only) on the same weights; then fp32 with the
   kernels on against fp32 with them off (TF32 off) on x_hat and bpp;
4. codec: ``RGBAFileCodec`` over two ``CodecIO`` at batch 16, 512x768,
   fp32 with all four kernels on, uint8 RGBA in and out: launch counts of
   one encode + decode, byte-identical re-encode, blob 0 alone and the
   first 8 blobs decoded apart against their decode in the batch (the same
   uint8), the decoded RGB against
   the fp32 RGB codec forward on the same masked input and decoded alpha,
   real bpp from the blob bytes, encode / decode / round-trip images/s
   (kernels on, then off, twice each) and one profiled round trip.  Then
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
   ``PipelinedCodec`` round trips (depth 2) of 4 batches from seeds 10-13
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
   averages on against off: bpp 1e-4 relative, PSNR and psnr_real 0.01 dB,
   MS-SSIM 1e-4; codec_err <= 1e-5 on each route, or, where a value
   within fp32 noise of a rounding boundary rounded apart in the eval
   step's forward and the codec, each image's decoded RGB within 1e-5 of
   the forward on the container's inputs (or its bulk) and its decoded
   alpha against the eval step's (mean |d| <= 1e-3, at most 5% of the
   pixels off by more than 1e-3: a desynced stream moves most); the time per
   image of the eval step and of the codec); ``cli.codec`` encode-dir / decode-dir
   of 16 RGBA PNGs at ``-b 8``, v64 and lanes32 (every blob equal to
   ``encode_batch``'s, every PNG to ``decode_batch(output="uint8")``'s,
   2 x 17 ``rans_decode`` launches in the lanes32 decode-dir; img/s of each
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
   profiled RGB step, and its forward and backward apart.

The line before the last is one JSON object with every kernel's numbers
(the four conv kernels' headline cases are bf16 forward shapes; the
``rans_decode`` entry's are the first y slice of the v3 RGB decode, the
``rans_encode`` entry's that of the device v3 encode);
the last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.

    python3 chip_smoke.py --base DIR [--iters 20]

compares all four kernels of another checkout DIR (for example a parent
commit unpacked with ``git archive``) with this one's on the same card:
each tree builds its four kernels and runs its own ``gdn_cases``,
``attention_cases``, ``gate_chain_cases`` and ``dse_cases`` (the main
paths' shapes, bf16 and fp32) in a process of its own, in turns base,
head, head, base; it prints each case's kernel time per turn.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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


def _time_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls after two warm-ups,
    with CUDA events."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def profile_run(torch, fn, what: str, top: int = 15) -> dict:
    """One call of fn under torch.profiler: device time by kernel and the
    share of the call's wall time the device was busy.  The profiler's own
    overhead lengthens the wall time, so the share is a lower bound."""
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top": [{"name": n, "calls": c, "ms": m} for n, c, m in rows[:top]]}


KERNEL_NAMES = ("fused_window_attention", "fused_gdn", "fused_gate_chain",
                "fused_dse", "rans_decode", "rans_encode")
CONV_KERNELS = KERNEL_NAMES[:4]


def _launch_counts(attn, gdn, gate_chain, dse, rans=0, rans_encode=0):
    return dict(zip(KERNEL_NAMES, (attn, gdn, gate_chain, dse, rans,
                                   rans_encode)))


FORWARD_LAUNCHES = _launch_counts(4, 12, 8, 2)
SERVE_LAUNCHES = _launch_counts(4, 0, 0, 0)
CODEC_LAUNCHES = _launch_counts(4, 15, 10, 3)
# lane streams (v3): the mask decode inside the encode takes 1 + 5 rANS
# segments, the decode 1 + 10 (RGB) and 1 + 5 (mask)
LANE_ENCODE_RANS, LANE_DECODE_RANS = 6, 17
LANE_LAUNCHES = _launch_counts(4, 15, 10, 3,
                               LANE_ENCODE_RANS + LANE_DECODE_RANS)
# the device lane encode of a v3 container (RGBA_TPU_DEVICE_ENCODE=1): 1 + 10
# RGB and 1 + 5 mask segments
LANE_ENCODE_SEGMENTS = 17
ENCODE_GAIN = 3.0   # encode_phase (a): the encoders' gain (_liven's is 10)
# one training forward + backward (the backward launches no kernel)
MAX_FLIPS = 2      # latents the two fp32 routes may round apart (train phase)
RGB_STEP_LAUNCHES = _launch_counts(4, 6, 4, 1)
MASK_STEP_LAUNCHES = _launch_counts(0, 6, 4, 1)
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS = 8, 256, 20


def _kernels():
    from rgba_tpu_torch.ops.kernels import (dse, gate_chain, gdn, rans_decode,
                                            rans_encode, win_attn)
    return dict(zip(KERNEL_NAMES, (win_attn.KERNEL, gdn.KERNEL,
                                   gate_chain.KERNEL, dse.KERNEL,
                                   rans_decode.KERNEL, rans_encode.KERNEL)))


def _all_kernels(policy):
    return dataclasses.replace(policy, fused_win_attn=True, fused_gdn=True,
                               fused_gate_chain=True, fused_dse=True,
                               packed_dse=False)


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
    with them off and against the fp32 forward."""
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
              f"(batch {batch}, 512x768, fp32)")
        return r

    img_s = {}
    for rep in ("", " again"):
        for which in ("on", "off"):
            name = f"kernels {which}{rep}"
            if which == "off" and not rep:
                rates("kernels off (warm-up)", codecs["off"], datas[1])
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
    The dense inverse tables and the row search's reads are the kernel's
    own design, not the function's, so they are not charged.  Bound by
    bytes: the work is a few integer operations per symbol."""
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
            "shape": list(call["idx"].shape), "words_read": words}


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
    # and its first y slice (inverse tables), on the recorded inputs
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
        print(f"  rans_decode {name} ({tuple(call['idx'].shape)} steps x "
              f"images x lanes, {'inverse tables' if call['inverse'] is not None else 'row search'}): "
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
              f"{100.0 * c['bound_ms'] / c['ms']:.2f}% of the bound, "
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
    for s in range(4):
        d = synthetic_rgba_batch(batch, h, w, seed=10 + s)
        batches.append((np.round(d["image"] * 255.0).astype(np.uint8),
                        np.round(d["alpha"] * 255.0).astype(np.uint8)))
    print(f"  4 batches of {batch} (seeds 10-13) made in "
          f"{time.perf_counter() - t:.1f} s")
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
            want = {n: 4 * v for n, v in per_batch[fmt].items()}
            if launches != want:
                raise AssertionError(f"{fmt} depth {depth}: launches "
                                     f"{launches}, want 4 x {per_batch[fmt]}")
            runs[depth] = {"out": out, "img_per_s": 4 * batch / wall,
                           "wall_s": wall}
            print(f"  roundtrip_stream {fmt} depth {depth}: "
                  f"{runs[depth]['img_per_s']:.3f} img/s (4 x {batch}, "
                  f"{h}x{w}, fp32, uint8 out; {wall:.3f} s); launches 4 x "
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
            "dtypes": [str(call["idx"].dtype), str(call["sym"].dtype)]}


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
              f"{100.0 * res['bound_ms'] / res['ms']:.2f}% of the bound, "
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
    chain_ms = _time_ms(torch, lambda: [re_.rans_encode(
        c["tables"], c["state"].clone(), c["wptr"].clone(), c["out"].clone(),
        c["idx"], c["sym"], c["act"]) for c in rgb], iters)
    print(f"  the 11 RGB segments (each from a copy of its inputs): "
          f"{chain_ms:.3f} ms on the card against {host_ms:.3f} ms for the "
          f"host C++ encode_lanes of the same {batch} streams")

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
# checks the decode against (4 attention, 6 GDN, 4 gate chains, 1 DSE)
CODEC_FORWARD_LAUNCHES = _launch_counts(4, 6, 4, 1)
EVAL_HW, EVAL_IMAGES, CLI_BATCH, EXPORT_BATCH = (512, 768), 8, 4, 16
EVAL_GATES = {"bpp": 1e-4, "psnr": 0.01, "msssim": 1e-4, "psnr_real": 0.01}
CODEC_ERR_MAX = 1e-5
# codec_err above CODEC_ERR_MAX (_codec_err_parts): the decoded alpha
# against the eval step's, a quarter of an 8-bit level on average and at
# most 5% of the pixels off
ALPHA_MEAN_MAX, ALPHA_SHARE_MAX = 1e-3, 0.05

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
    with them off, on the live weights."""
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
            f"one eval step, kernels {route}")
        _reset_launches()
        codec.decode(codec.encode(item["image"][None], item["alpha"][None]))
        per["codec"] = _read_launches(
            CODEC_LAUNCHES if route == "on" else _launch_counts(0, 0, 0, 0),
            f"one image's encode + decode, kernels {route}")
        n = EVAL_IMAGES
        want = (_sum_launches(*(n * [FORWARD_LAUNCHES, CODEC_LAUNCHES,
                                     CODEC_FORWARD_LAUNCHES]))
                if route == "on" else _launch_counts(0, 0, 0, 0))
        _reset_launches()
        t = time.perf_counter()
        avg = evaluate_kodak(rgb, mask, tree, real_codec=True, codec=codec)
        wall = time.perf_counter() - t
        per["evaluate_kodak"] = _read_launches(
            want, f"evaluate_kodak of {n} images, kernels {route}")
        print(f"  kodak eval, kernels {route}: time {avg['time'] * 1e3:.3f} "
              f"ms/image (eval step), codec {avg['codec_time'] * 1e3:.3f} "
              f"ms/image (encode + decode), wall {wall:.2f} s for {n}; bpp "
              f"{avg['bpp']:.6f} PSNR {avg['psnr']:.6f} MS-SSIM "
              f"{avg['msssim']:.6f} real bpp {avg['real_bpp']:.6f} "
              f"psnr_real {avg['psnr_real']:.6f} codec_err "
              f"{avg['codec_err']:.3g}")
        if not all(np.isfinite(v) for v in avg.values()):
            raise AssertionError(f"kernels {route}: an average is not finite")
        per_image = None
        if avg["codec_err"] > CODEC_ERR_MAX:
            per_image = _codec_err_parts(torch, tree, step, codec)
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


def _codec_err_parts(torch, tree: str, step, codec) -> list:
    """codec_err above 1e-5: a value within fp32 noise of a rounding
    boundary (a latent's half integer, or an 8-bit level of the decoded
    alpha) rounded apart in two computations of the same values (the eval
    step's forward and the codec's encode and decode, laid out and summed
    apart).  Each image's parts are then held: the decoded RGB against the
    forward on the container's own inputs within 1e-5, or its bulk
    (``_bulk_agreement``), and the decoded alpha against the eval step's:
    mean |d| <= ALPHA_MEAN_MAX and at most ALPHA_SHARE_MAX of the pixels
    off by more than 1e-3.  A latent rounded apart changes its symbol, and
    the channel-AR chain moves the slices after it a little: a patch of
    the alpha by a few levels (on the CPU, 1.3% of a 192x256 image by up
    to 5 levels); a desynced stream moves most of the image."""
    import numpy as np
    from rgba_tpu_torch.data.datasets import KodakDataset
    from rgba_tpu_torch.eval.kodak import _codec_forward

    print("  codec_err above 1e-5: a value at a rounding boundary rounded "
          "apart in the eval step's forward and the codec; holding each "
          "image's parts:")
    ds = KodakDataset(tree)
    parts = []
    for i in range(len(ds)):
        item = ds.get(i)
        ref = step(item["masked_image"][None], item["alpha"][None])
        rgba = codec.decode(codec.encode(item["image"][None],
                                         item["alpha"][None]))
        rm = rgba[..., 3:]
        x_fwd = _codec_forward(codec.rgb_io,
                               np.where(rm > 0, item["image"][None], rm), rm)
        got = torch.from_numpy(rgba)
        rgb_err = float(np.abs(rgba[..., :3] - x_fwd).max())
        rgb = (rgb_err <= CODEC_ERR_MAX or _bulk_agreement(
            got[..., :3], torch.from_numpy(x_fwd),
            f"image {i} decoded RGB vs forward")["ok"])
        d = (got[..., 3:] - ref["recon_mask"].cpu()).abs()
        alpha = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
                 "share_above_1e-3": float((d > 1e-3).float().mean())}
        alpha["ok"] = (alpha["mean_abs"] <= ALPHA_MEAN_MAX
                       and alpha["share_above_1e-3"] <= ALPHA_SHARE_MAX)
        print(f"    image {i}: RGB max_abs {rgb_err:.3g}; alpha max_abs "
              f"{alpha['max_abs']:.3g} mean_abs {alpha['mean_abs']:.3g} "
              f"(tol {ALPHA_MEAN_MAX:g}) share>1e-3 "
              f"{alpha['share_above_1e-3']:.3g} (tol {ALPHA_SHARE_MAX:g}) -> "
              f"{'ok' if rgb and alpha['ok'] else 'FAIL'}")
        if not (rgb and alpha["ok"]):
            raise AssertionError(f"image {i}: the decode disagrees with the "
                                 f"forward beyond a rounded tie")
        parts.append({"rgb_max_abs": rgb_err, "alpha": alpha})
    return parts


def _codec_cli(torch, rgba: str, work: str, ckpt: dict) -> dict:
    """``cli.codec`` encode-dir / decode-dir, v64 and lanes32, against
    ``encode_batch`` / ``decode_batch(output="uint8")``."""
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
                              else 0)
        launches = _read_launches(want, f"decode-dir of {len(paths)} {fmt} "
                                        f"blobs")
        for b0 in range(0, len(paths), CLI_BATCH):
            chunk = paths[b0:b0 + CLI_BATCH]
            x = np.stack([png.load(p, "RGBA") for p in chunk]).astype(
                np.float32) / 255.0
            blobs = c.encode_batch(x[..., :3], x[..., 3:], stream_format=fmt)
            pixels = c.decode_batch(blobs, output="uint8")
            for p, blob, px in zip(chunk, blobs, pixels):
                stem = os.path.splitext(os.path.basename(p))[0]
                with open(os.path.join(enc, stem + ".rgbc"), "rb") as f:
                    if f.read() != blob:
                        raise AssertionError(f"{fmt}: the CLI's {stem}.rgbc "
                                             f"is not encode_batch's")
                if not np.array_equal(
                        png.load(os.path.join(dec, stem + ".png"), "RGBA"), px):
                    raise AssertionError(f"{fmt}: the CLI's {stem}.png is not "
                                         f"decode_batch's uint8")
        out[fmt] = {"encode_img_per_s": len(paths) / t_enc,
                    "decode_img_per_s": len(paths) / t_dec,
                    "launches_decode": launches}
        print(f"  codec CLI {fmt}: encode-dir {out[fmt]['encode_img_per_s']:.3f}"
              f" img/s, decode-dir {out[fmt]['decode_img_per_s']:.3f} img/s "
              f"({len(paths)} images, -b {CLI_BATCH}, weights loaded in each "
              f"command); blobs = encode_batch's, PNGs = decode_batch's uint8")
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
           "gradients": {"rgb": _train_gradients(torch, "rgb",
                                                 RGB_STEP_LAUNCHES),
                         "mask": _train_gradients(torch, "mask",
                                                  MASK_STEP_LAUNCHES)}}
    dataset = _SynthDataset(4 * TRAIN_BATCH, TRAIN_SIZE)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the main path: both trainers with the kernels on
        for kind, per_step in (("rgb", RGB_STEP_LAUNCHES),
                               ("mask", MASK_STEP_LAUNCHES)):
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
    want = {n: TRAIN_STEPS * c for n, c in MASK_STEP_LAUNCHES.items()}
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


# runs in either checkout, through that checkout's own chip_smoke.py
AB_WORKER = """
import json, sys, torch
import chip_smoke as cs
from rgba_tpu_torch.ops.kernels import build
build.build_all(list(cs._kernels().values()))
batch, iters = int(sys.argv[1]), int(sys.argv[2])
cases = []
for fn in (cs.gdn_cases, cs.attention_cases, cs.gate_chain_cases,
           cs.dse_cases):
    cases += [dict(c, kernel=fn.__name__) for c in fn(torch, batch, iters)]
print("RESULT " + json.dumps(cases))
"""


def ab_phase(base: Path, batch: int, iters: int) -> dict:
    import os
    head = Path(__file__).resolve().parent
    turns = []
    for name, tree in (("base", base), ("head", head), ("head", head),
                       ("base", base)):
        proc = subprocess.run(
            [sys.executable, "-c", AB_WORKER, str(batch), str(iters)],
            cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
            capture_output=True, text=True, timeout=900)
        res = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not res:
            raise RuntimeError(f"the kernels of {tree} failed:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        cases = json.loads(res[-1][len("RESULT "):])
        for c in cases:
            print(f"  {name} {c['kernel']} {c['dtype']} {c['shape']}: ms "
                  f"{c['ms']:.4f} (max_abs_err {c['max_abs_err']:.3g})")
        turns.append({"tree": name, "cases": cases})
    return {"base": str(base), "batch": batch, "iters": iters, "turns": turns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--base", type=Path, default=None,
                    help="another checkout whose four kernels to time "
                         "against this one's")
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
        print(f"the four kernels, {args.base} against this tree:")
        report = ab_phase(args.base.resolve(), args.batch, args.iters)
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
    t = time.perf_counter()
    print("kernels at the main paths' shapes:")
    res = {"fused_gdn": gdn_cases(torch, args.batch, args.iters),
           "fused_window_attention": attention_cases(torch, args.batch,
                                                     args.iters),
           "fused_gate_chain": gate_chain_cases(torch, args.batch, args.iters),
           "fused_dse": dse_cases(torch, args.batch, args.iters)}
    phase_s["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    print("forward path:")
    path = path_phase(torch, args.batch, args.iters)
    phase_s["forward"] = time.perf_counter() - t
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
                "launches_cli_decode_dir": evals["codec_cli"]["lanes32"]
                ["launches_decode"]["rans_decode"],
                "max_abs_err": lanes["max_abs_err"], "ms": y0["ms"],
                "plain_ms": y0["plain_ms"],
                "bound_ms": y0["bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "shape": "y slice 0, (steps, images, lanes) = %s"
                         % (tuple(y0["shape"]),),
                "dtype": "uint8 indexes, int16 symbols", "z_segment": z,
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
                "max_abs_err": enc["max_abs_err"], "ms": y0["ms"],
                "plain_ms": y0["plain_ms"], "bound_ms": y0["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "shape": "y slice 0, (steps, images, lanes) = %s"
                         % (tuple(y0["shape"]),),
                "dtype": "uint8 indexes, int16 symbols", "z_segment": z,
                "rgb_chain_ms": enc["rgb_chain_ms"],
                "host_encode_lanes_ms": enc["host_encode_lanes_ms"]}

    line = {
        "kernels": [entry(name) for name in CONV_KERNELS] + [rans_entry(),
                                                            rans_encode_entry()],
        "pending": [],
        "path": {k: v for k, v in path.items() if k != "launches"},
        "codec": {k: v for k, v in codec.items()
                  if k not in ("launches", "lanes", "encode")},
        "encode": {k: v for k, v in enc.items() if k != "segments"},
        "lanes": {k: v for k, v in lanes.items() if k != "segments"},
        "train": {k: v for k, v in train.items() if k != "launches_train"},
        "eval": evals,
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
