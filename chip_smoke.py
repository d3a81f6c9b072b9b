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
   (attention with its weights laid out once, as ``WindowAttention``
   keeps them), the plain version, one
   PyTorch library call of the same function (a yardstick the port never
   calls) and the bound (the larger of bytes over 3.35 TB/s and operations
   over the H100 SXM peak for their type);
3. forward: ``RGBAPipeline`` at batch 16, 512x768, bf16 with all four
   kernels on: shapes, finiteness, the launch count of each kernel in one
   forward, images/s (kernels on, then off, twice each), one profiled
   forward (device time by kernel, device busy share); images/s and the
   launch counts of the default serving route (``SERVE_POLICY``: bf16 with
   the attention kernel only) on the same weights; then fp32 with the
   kernels on against fp32 with them off (TF32 off) on x_hat and bpp;
4. codec: ``RGBAFileCodec`` over two ``CodecIO`` at batch 16, 512x768,
   fp32 with all four kernels on, uint8 RGBA in and out: launch counts of
   one encode + decode, byte-identical re-encode, the decoded RGB against
   the fp32 RGB codec forward on the same masked input and decoded alpha,
   real bpp from the blob bytes, encode / decode / round-trip images/s
   (kernels on, then off, twice each) and one profiled round trip;
5. train: the full-width codecs on synthetic 256x256 RGBA at batch 8
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
   routes take.  After the last step the stepped ``WindowAttention``
   modules must hold the kernel layout of their new weights and agree with
   their plain path (a stale layout would train silently wrong).  Then one
   profiled RGB step, and its forward and backward apart.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.

    python3 chip_smoke.py --base DIR [--iters 20]

compares the window-attention and GDN kernels of another checkout DIR
(for example a parent commit unpacked with ``git archive``) with this one's
on the same card: each tree builds its two kernels and runs its own
``gdn_cases`` and ``attention_cases`` in a process of its own, in turns
base, head, head, base; it prints each case's kernel time per turn.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,    # dense bf16 tensor cores
              "float32": 67e12}      # fp32 outside the tensor cores (TF32 off)
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


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        for inverse in (False, True):
            what = f"fused_gdn {'inverse ' if inverse else ''}M={m} C={c} {dtype}"
            res = _check(torch, k.fused_gdn(x, gt, beta, inverse),
                         k.gdn_plain(x, gt, beta, inverse), dtype, what)

            def library():
                n = torch.addmm(beta_dt, x * x, gt_dt)
                return x * (torch.sqrt(n) if inverse else torch.rsqrt(n))

            nbytes = 2 * m * c * es + c * c * es + 4 * c
            bound, by = _bound(nbytes, 2.0 * m * c * c, dtype)
            res.update(
                shape=f"M={m},C={c},{'inverse' if inverse else 'forward'}",
                dtype=dtype,
                ms=_time_ms(torch, lambda: k.fused_gdn(x, gt, beta, inverse), iters),
                plain_ms=_time_ms(torch, lambda: k.gdn_plain(x, gt, beta, inverse), iters),
                library_ms=_time_ms(torch, library, iters),
                bound_ms=bound, bound_by=by)
            print(f"    ms {res['ms']:.4f} plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} bound_ms {bound:.4f} ({by})")
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
            bound, by = _bound(nbytes, flops, dtype)
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
                bound_ms=bound, bound_by=by)
            print(f"    ms {res['ms']:.4f} (weight layout, once per weights: "
                  f"{res['layout_ms']:.4f}) plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} bound_ms {bound:.4f} ({by})")
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
                    xr = x.permute(0, 2, 3, 1).contiguous()
                    gr = None if g is None else g.permute(0, 2, 3, 1).contiguous()
                    args = (xr, gr, *wts, act, post)
                    what = (f"fused_gate_chain {flavour} B={batch} {h}x{w} "
                            f"C={c} {dtype}")
                    res = _check(torch, k.fused_gate_chain(*args),
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
                    bound, by = _bound(nbytes, flops, dtype)
                    res.update(
                        shape=f"{flavour},B={batch},{h}x{w},C={c}",
                        dtype=dtype,
                        ms=_time_ms(torch, lambda: k.fused_gate_chain(*args),
                                    iters),
                        plain_ms=_time_ms(torch, lambda: k.gate_chain_plain(
                            *args), iters),
                        library_ms=_time_ms(torch, library, iters),
                        bound_ms=bound, bound_by=by)
                print(f"    ms {res['ms']:.4f} plain_ms {res['plain_ms']:.4f} "
                      f"library_ms {res['library_ms']:.4f} bound_ms "
                      f"{bound:.4f} ({by})")
                cases.append(res)
                del m, x, g, args
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
                what = f"fused_dse B={batch} {h}x{w} cio={cio} {dtype}"
                res = _check(torch, k.fused_dse(*args, leaky=leaky),
                             k.dse_plain(*args, leaky=leaky), dtype, what)
                pix = batch * h * w
                flops = pix * (4.0 * cio * 32 + 6 * 2.0 * 9 * 32 * 32)
                nbytes = (2 * pix * cio * es + (2 * cio * 32 + 6 * 9 * 1024) * es
                          + 4 * (32 + 6 * 32 + cio))
                bound, by = _bound(nbytes, flops, dtype)
                res.update(
                    shape=f"cio={cio},B={batch},{h}x{w}", dtype=dtype,
                    ms=_time_ms(torch, lambda: k.fused_dse(*args, leaky=leaky),
                                iters),
                    plain_ms=_time_ms(torch, lambda: k.dse_plain(
                        *args, leaky=leaky), iters),
                    library_ms=_time_ms(torch, lambda: m(x), iters),
                    bound_ms=bound, bound_by=by)
            print(f"    ms {res['ms']:.4f} plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} bound_ms {bound:.4f} "
                  f"({by})")
            cases.append(res)
            del m, x, args
    return cases


def _liven(torch, pipe, seed: int = 1) -> None:
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
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
        pipe.mask_codec.EncoderMask[7].weight.mul_(10.0)


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
                "fused_dse")
FORWARD_LAUNCHES = {"fused_window_attention": 4, "fused_gdn": 12,
                    "fused_gate_chain": 8, "fused_dse": 2}
SERVE_LAUNCHES = {"fused_window_attention": 4, "fused_gdn": 0,
                  "fused_gate_chain": 0, "fused_dse": 0}
CODEC_LAUNCHES = {"fused_window_attention": 4, "fused_gdn": 15,
                  "fused_gate_chain": 10, "fused_dse": 3}
# one training forward + backward (the backward launches no kernel)
MAX_FLIPS = 2      # latents the two fp32 routes may round apart (train phase)
RGB_STEP_LAUNCHES = {"fused_window_attention": 4, "fused_gdn": 6,
                     "fused_gate_chain": 4, "fused_dse": 1}
MASK_STEP_LAUNCHES = {"fused_window_attention": 0, "fused_gdn": 6,
                      "fused_gate_chain": 4, "fused_dse": 1}
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS = 8, 256, 20


def _kernels():
    from rgba_tpu_torch.ops.kernels import dse, gate_chain, gdn, win_attn
    return dict(zip(KERNEL_NAMES, (win_attn.KERNEL, gdn.KERNEL,
                                   gate_chain.KERNEL, dse.KERNEL)))


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
    for c in codecs.values():
        c.rgb_io.close()
        c.mask_io.close()
    return {"launches": launches, "bpp": bpp, "bytes": nbytes,
            "forward_match": forward_match, "img_per_s": img_s,
            "profile": profile}


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


def _make_trainer(torch, kind: str, kernels: bool, tmp: str):
    """A bf16 trainer at the full width, with every kernel on or none."""
    from rgba_tpu_torch.core.config import TrainConfig
    from rgba_tpu_torch.core.precision import BF16_POLICY
    from rgba_tpu_torch.models.mask_codec import MaskCodec
    from rgba_tpu_torch.models.rgb_codec import RGBCodec
    from rgba_tpu_torch.train.loops import MaskTrainer, RGBTrainer

    cfg = TrainConfig(train_lambda=1024, batch_size=TRAIN_BATCH, cal_step=1,
                      print_freq=1, tot_step=TRAIN_STEPS, aux_lr=1e-3,
                      curriculum_step=0, snapshot_freq=10 ** 9,
                      save_model_freq=10 ** 9, compute_dtype="bfloat16",
                      image_size=TRAIN_SIZE)
    model = None
    if kernels:     # cfg.compute_dtype alone gives the plain bf16 policy
        model = (RGBCodec if kind == "rgb" else MaskCodec)(
            policy=_all_kernels(BF16_POLICY), device=torch.device("cuda"),
            generator=torch.Generator().manual_seed(cfg.seed))
    return (RGBTrainer if kind == "rgb" else MaskTrainer)(
        cfg, f"{tmp}/{kind}_{'on' if kernels else 'off'}", model=model)


def _train_run(torch, trainer, dataset, name: str):
    """TRAIN_STEPS steps of ``trainer`` through ``Trainer.train`` (loader,
    one host sync a step for the meters), then 10 more through
    ``Trainer.step`` on one host batch with a single sync at the end."""
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
    host = _host_batch(dataset, trainer.batch_keys)
    t = time.perf_counter()
    for _ in range(10):
        trainer.step(state, host)
    torch.cuda.synchronize()
    compute = 10 / (time.perf_counter() - t)
    print(f"  {name}: rd {losses[0]:.3f} -> {losses[-1]:.3f} (first 5 "
          f"{head:.3f}, last 5 {tail:.3f}); {rate:.3f} steps/s, "
          f"{rate * TRAIN_BATCH:.2f} img/s through Trainer.train; "
          f"{compute:.3f} steps/s, {compute * TRAIN_BATCH:.2f} img/s compute "
          f"only; peak memory {peak / 2 ** 30:.3f} GiB (batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}, bf16, {steps} steps)")
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
    out["runs"] = runs
    # each trainer's kernels-on run: counts set to 0 before, read after
    out["launches_train"] = {
        n: {"rgb": runs["rgb_on"]["launches"][n],
            "mask": runs["mask_on"]["launches"][n], "steps": steps}
        for n in KERNEL_NAMES}
    return out


# runs in either checkout, through that checkout's own chip_smoke.py
AB_WORKER = """
import json, sys, torch
import chip_smoke as cs
from rgba_tpu_torch.ops.kernels import build, gdn, win_attn
build.build_all([gdn.KERNEL, win_attn.KERNEL])
batch, iters = int(sys.argv[1]), int(sys.argv[2])
cases = cs.gdn_cases(torch, batch, iters) + cs.attention_cases(torch, batch,
                                                               iters)
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
            print(f"  {name} {c['dtype']} {c['shape']}: ms {c['ms']:.4f} "
                  f"(max_abs_err {c['max_abs_err']:.3g})")
        turns.append({"tree": name, "cases": cases})
    return {"base": str(base), "batch": batch, "iters": iters, "turns": turns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--base", type=Path, default=None,
                    help="another checkout whose attention and GDN kernels "
                         "to time against this one's")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
        print(f"attention and GDN kernels, {args.base} against this tree:")
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

    print("kernels at the main paths' shapes:")
    res = {"fused_gdn": gdn_cases(torch, args.batch, args.iters),
           "fused_window_attention": attention_cases(torch, args.batch,
                                                     args.iters),
           "fused_gate_chain": gate_chain_cases(torch, args.batch, args.iters),
           "fused_dse": dse_cases(torch, args.batch, args.iters)}
    print("forward path:")
    path = path_phase(torch, args.batch, args.iters)
    print("codec path:")
    codec = codec_phase(torch, args.batch, args.iters)
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

    def entry(name):
        source, replaces, headline = meta[name]
        cases = res[name]
        h = next(c for c in cases if c["shape"].startswith(headline)
                 and c["dtype"] == "bfloat16")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "status": "ported",
                "launches": path["launches"][name],
                "launches_codec": codec["launches"][name],
                "launches_train": train["launches_train"][name],
                "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                "shape": h["shape"], "dtype": h["dtype"], "cases": cases}

    line = {
        "kernels": [entry(name) for name in KERNEL_NAMES],
        "pending": [],
        "path": {k: v for k, v in path.items() if k != "launches"},
        "codec": {k: v for k, v in codec.items() if k != "launches"},
        "train": {k: v for k, v in train.items() if k != "launches_train"},
    }
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
