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
   (kernels on, then off, twice each) and one profiled round trip.

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


def gdn_cases(torch, batch: int, iters: int):
    """GDN at the main path's largest site (H/2 of 512x768, C=192)."""
    from rgba_tpu_torch.ops.kernels import gdn as k
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    c = 192
    m = batch * 256 * 384
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


def attention_cases(torch, batch: int, iters: int):
    """Window attention at both main-path shapes, with the shifted region
    ids and the alive gate that the path's alpha gives."""
    import torch.nn.functional as F
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.ops import window
    from rgba_tpu_torch.ops.kernels import win_attn as k
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    alpha = torch.from_numpy(
        synthetic_rgba_batch(batch, 512, 768, seed=0)["alpha"]).to(dev)
    pyr = mask_pyramid(alpha.permute(0, 3, 1, 2))
    cases = []
    # (level, window, shift, C): H/4 8x8 windows at C=192, H/8 4x4 at C=80
    for level, ws, ss, c in ((1, 8, 4, 192), (2, 4, 2, 80)):
        a = torch.roll(pyr[level].permute(0, 2, 3, 1), (-ss, -ss), (1, 2))
        h, w = a.shape[1:3]
        alive = window.window_alive(window.window_partition(a, ws))[:, None]
        region = torch.from_numpy(window.swin_region_ids(h, w, ws, ss)).to(
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


def gate_chain_cases(torch, batch: int, iters: int):
    """The gate chain at both main-path sites (C=192 at H/4, C=80 at H/8 of
    512x768) in both flavours: WinGate (GELU, post-act, separate g) and
    Simplified (ReLU, g = x).  The library yardstick is the module's own
    path with the kernel flag off (cuDNN convs)."""
    from rgba_tpu_torch.core.precision import Policy, precision_scope
    from rgba_tpu_torch.ops import attention as att
    from rgba_tpu_torch.ops.kernels import gate_chain as k

    dev = torch.device("cuda")
    cases = []
    for c, h, w in ((192, 128, 192), (80, 64, 96)):
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


def dse_cases(torch, batch: int, iters: int):
    """The DSE tail at full resolution (512x768): cio=3 ReLU (RGB decoder)
    and cio=1 LeakyReLU (mask decoder).  Library yardstick: the module's
    plain path (cuDNN convs)."""
    from rgba_tpu_torch.core.precision import Policy, precision_scope
    from rgba_tpu_torch.ops.enhance import DSE
    from rgba_tpu_torch.ops.kernels import dse as k

    dev = torch.device("cuda")
    h, w = 512, 768
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
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
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
                "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                "shape": h["shape"], "dtype": h["dtype"], "cases": cases}

    line = {
        "kernels": [entry(name) for name in KERNEL_NAMES],
        "pending": [],
        "path": {k: v for k, v in path.items() if k != "launches"},
        "codec": {k: v for k, v in codec.items() if k != "launches"},
    }
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
