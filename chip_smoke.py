#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts, and is right, on one GPU.

    python3 chip_smoke.py [--batch 16] [--iters 5]

Run from the repository root on a machine with an NVIDIA Hopper card
(sm_90a), nvcc and PyTorch built for CUDA.  Phases, each fatal on failure:

1. card and build: prints the card's name and power limit (nvidia-smi) and
   builds every CUDA kernel of the port from ``rgba_tpu_torch/csrc``, one
   nvcc per source, all started together;
2. kernels: each kernel at the main path's shapes (batch 16, 512x768), in
   fp32 and bf16, against its plain PyTorch version on the same inputs
   within the printed tolerance; times the kernel, the plain version, one
   PyTorch library call of the same function (a yardstick the port never
   calls) and the bound (the larger of bytes over 3.35 TB/s and operations
   over the H100 SXM peak for their type);
3. path: ``RGBAPipeline`` forward at batch 16, 512x768, serve policy with
   the GDN kernel on: shapes, finiteness, the launch count of each kernel
   in one forward, forward images/s (kernels on, then off, twice each),
   one profiled forward (device time by kernel, device busy share); then
   fp32 with the kernels on against fp32 with them off (TF32 off) on
   x_hat and bpp.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

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


def _check(torch, got, want, dtype: str, what: str) -> dict:
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
    print(f"  {what}: max_abs_err {max_abs:.3g} max_rel_err {max_rel:.3g} "
          f"tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


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
                    (0.02 * torch.randn(nh, n, n, generator=g)).to(dev)]
            what = f"fused_window_attention nW={nw} N={n} C={c} {dtype}"
            res = _check(torch, k.fused_window_attention(*args, num_heads=nh),
                         k.window_attention_plain(*args, num_heads=nh),
                         dtype, what)
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
                    *args, num_heads=nh), iters),
                plain_ms=_time_ms(torch, lambda: k.window_attention_plain(
                    *args, num_heads=nh), iters),
                library_ms=_time_ms(torch, library, iters),
                bound_ms=bound, bound_by=by)
            print(f"    ms {res['ms']:.4f} plain_ms {res['plain_ms']:.4f} "
                  f"library_ms {res['library_ms']:.4f} bound_ms {bound:.4f} ({by})")
            cases.append(res)
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


def profile_forward(torch, pipe, inputs, top: int = 15) -> dict:
    """One forward under torch.profiler: device time by kernel and the
    share of the forward's wall time the device was busy.  The profiler's
    own overhead lengthens the wall time, so the share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe(*inputs)
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
    print(f"  profiled forward: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100.0 * busy_ms / wall_ms:.1f}%)")
    for name, count, ms in rows[:top]:
        print(f"    {ms:9.3f} ms {100.0 * ms / max(busy_ms, 1e-9):5.1f}% "
              f"x{count:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top": [{"name": n, "calls": c, "ms": m} for n, c, m in rows[:top]]}


def path_phase(torch, batch: int, iters: int) -> dict:
    from rgba_tpu_torch.core.precision import (BF16_POLICY, DEFAULT_POLICY,
                                               SERVE_POLICY)
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    from rgba_tpu_torch.ops.kernels import gdn, win_attn

    serve_gdn = dataclasses.replace(SERVE_POLICY, fused_gdn=True)
    t0 = time.perf_counter()
    pipe = RGBAPipeline(serve_gdn, seed=0)
    _liven(torch, pipe)
    state = pipe.state_dict()
    datas = [synthetic_rgba_batch(batch, 512, 768, seed=s) for s in range(2)]
    ins = [(torch.from_numpy(d["masked_image"]).cuda(),
            torch.from_numpy(d["alpha"]).cuda()) for d in datas]
    print(f"  set-up (weights, data) {time.perf_counter() - t0:.1f} s")

    pipe(*ins[1])                                   # warm-up (cuDNN set-up)
    torch.cuda.synchronize()
    for kern in (win_attn.KERNEL, gdn.KERNEL):
        kern.launches = 0
    out = pipe(*ins[0])
    torch.cuda.synchronize()
    launches = {"fused_window_attention": win_attn.KERNEL.launches,
                "fused_gdn": gdn.KERNEL.launches}
    print(f"  launches in one forward: {launches}")
    if launches != {"fused_window_attention": 4, "fused_gdn": 12}:
        raise AssertionError(f"expected 4 attention and 12 GDN launches, "
                             f"got {launches}")
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
    fwd = {}
    for name, p in (("serve+gdn kernels", pipe), ("bf16 plain", plain),
                    ("serve+gdn kernels again", pipe), ("bf16 plain again", plain)):
        fwd[name] = img_per_s(p)
        print(f"  forward {name}: {fwd[name]:.3f} img/s "
              f"(batch {batch}, 512x768, {iters} iters)")
    profile = profile_forward(torch, pipe, ins[0])
    del plain

    # fp32, kernels on vs off, TF32 off (precision_scope): x_hat and bpp
    fp32_on = RGBAPipeline(dataclasses.replace(
        DEFAULT_POLICY, fused_win_attn=True, fused_gdn=True), seed=0)
    fp32_off = RGBAPipeline(DEFAULT_POLICY, seed=0)
    fp32_on.load_state_dict(state)
    fp32_off.load_state_dict(state)
    a, b = fp32_on(*ins[0]), fp32_off(*ins[0])
    d = (a["x_hat"] - b["x_hat"]).abs()
    far = float((d > 1e-3).float().mean())
    bpp_rel = abs(float(a["bpp"]) - float(b["bpp"])) / abs(float(b["bpp"]))
    print(f"  fp32 kernels on vs off: x_hat max_abs {float(d.max()):.3g} "
          f"mean_abs {float(d.mean()):.3g} share>1e-3 {far:.3g}; "
          f"bpp {float(a['bpp']):.7f} vs {float(b['bpp']):.7f} "
          f"(rel {bpp_rel:.3g})")
    # a latent within fp32 noise of a half integer may round the other way
    # and move x_hat locally; the bulk must agree
    if not (float(d.mean()) <= 1e-4 and far <= 1e-3 and bpp_rel <= 1e-4):
        raise AssertionError("fp32 pipeline with kernels disagrees with plain")
    return {"launches": launches, "img_per_s": fwd, "profile": profile,
            "fp32_x_hat_max_abs": float(d.max()),
            "fp32_x_hat_mean_abs": float(d.mean()), "fp32_bpp_rel": bpp_rel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from rgba_tpu_torch.ops.kernels import build, gdn, win_attn
    except ImportError as e:
        print(f"chip_smoke: the rgba_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all([win_attn.KERNEL, gdn.KERNEL])
    print(f"kernel build {time.perf_counter() - t0:.1f} s")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")

    print("kernels at the main path's shapes:")
    gdn_res = gdn_cases(torch, args.batch, args.iters)
    attn_res = attention_cases(torch, args.batch, args.iters)
    print("path:")
    path = path_phase(torch, args.batch, args.iters)

    def entry(name, source, replaces, cases, headline):
        h = next(c for c in cases if c["shape"].startswith(headline)
                 and c["dtype"] == "bfloat16")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "status": "ported",
                "launches": path["launches"][name],
                "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": h["bound_by"], "library_ms": h["library_ms"],
                "shape": h["shape"], "dtype": h["dtype"], "cases": cases}

    line = {
        "kernels": [
            entry("fused_window_attention", "rgba_tpu_torch/csrc/win_attn.cu",
                  "rgba_tpu/ops/pallas/win_attn.py:66", attn_res,
                  "nW=%d,N=64" % (args.batch * 384)),
            entry("fused_gdn", "rgba_tpu_torch/csrc/gdn.cu",
                  "rgba_tpu/ops/pallas/gdn.py:48", gdn_res, "M="),
        ],
        "pending": [
            {"name": "fused_gate_chain", "status": "pending",
             "replaces": "rgba_tpu/ops/pallas/gate_chain.py:201"},
            {"name": "fused_dse", "status": "pending",
             "replaces": "rgba_tpu/ops/pallas/dse.py:135"},
        ],
        "path": {k: v for k, v in path.items() if k != "launches"},
    }
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
