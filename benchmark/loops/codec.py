"""Window loop of the bitstream codec: a closed loop of one client, each
call ``RGBAFileCodec.encode_batch`` of a batch of uint8 RGBA images held
on the host, then ``decode_batch(output="uint8")`` of its blobs.  The
traffic names the batch, the image size and how many distinct batches
the client cycles through, all made from the seed.

What is compared, once the window has closed and the program is freed:
every call's decoded RGBA against the reference's round trip of the same
images (``reference/outputs.codec``), and every call's bytes against the
reference's estimate of the code length.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import program
import work
from reference import model as ref
from reference import outputs as refout


def setup(ctx) -> None:
    t, dev = ctx.traffic, ctx.device
    program.build_kernels(dev)
    ctx.state_dict = work.make_state(ctx.seed, ctx.config["gains"], dev)
    pipe = program.pipeline(ctx.config["route"], ctx.state_dict, dev)
    ctx.program = {"pipe": pipe, "codec": program.codec(pipe)}
    b, n = t["batch"], t["distinct"]
    imgs = work.make_images(ctx.seed, b * n, t["height"], t["width"], dev)
    ctx.inputs = [(imgs["image"][i * b:(i + 1) * b].cpu().numpy(),
                   imgs["alpha"][i * b:(i + 1) * b].cpu().numpy())
                  for i in range(n)]
    ctx.outputs = []
    for _ in range(t.get("warmup", 2)):
        run_call(ctx, ctx.program, 0)


def run_call(ctx, prog, i: int) -> dict:
    """Encode and decode the call's batch; returns its host spans (ns of
    the wall clock), bytes and decoded uint8 RGBA."""
    image, alpha = ctx.inputs[i % len(ctx.inputs)]
    fmt = ctx.traffic.get("stream_format", "v64")
    t0 = time.time_ns()
    blobs = prog["codec"].encode_batch(image, alpha, stream_format=fmt)
    t1 = time.time_ns()
    rgba = prog["codec"].decode_batch(blobs, output="uint8")
    t2 = time.time_ns()
    return {"spans": [("encode", t0, t1), ("decode", t1, t2)],
            "nbytes": sum(len(b) for b in blobs), "rgba": rgba,
            "images": len(blobs)}


def call(ctx, i: int) -> dict:
    out = run_call(ctx, ctx.program, i)
    ctx.outputs.append((i % len(ctx.inputs), out["rgba"], out["nbytes"]))
    return {"spans": out["spans"], "images": out["images"]}


def free(ctx) -> None:
    program.close_codec(ctx.program["codec"])
    ctx.program = None


def reference(ctx, tf32: bool = False) -> dict:
    """The reference's decoded RGBA (on the device) and estimated bits of
    each distinct batch, computed in float32 (``tf32``: with TF32 on, the
    control)."""
    model = ref.RGBAModel().to(ctx.device).eval()
    model.load_state_dict(ctx.state_dict)
    out = {}
    with refout.tf32(tf32):
        for j in sorted({j for j, _, _ in ctx.outputs}):
            image, alpha = (torch.from_numpy(a).to(ctx.device)
                            for a in ctx.inputs[j])
            out[j] = refout.codec(model, image, alpha,
                                  ctx.traffic.get("ref_block", 16))
    del model
    return out


def compare(ctx, got, want) -> dict:
    """The numbers that may be compared (the configuration's ``limits``
    say which are): the share of decoded RGB values more than one 8-bit
    level off the reference's, their mean distance in levels, the share of
    alpha values off at all and by more than one level, and the largest
    gap between a call's bytes and the reference's estimate of its code
    length, as a share of the estimate."""
    n = {"rgb_far": 0, "rgb_levels": 0, "rgb": 0, "alpha_off": 0,
         "alpha_far": 0, "alpha": 0}
    rate_gap = 0.0
    for j, rgba, nbytes in got:
        r = want[j]["rgba"]
        d = (torch.as_tensor(rgba).to(r.device).short() - r.short()).abs()
        rgb, alpha = d[..., :3], d[..., 3]
        n["rgb_far"] += int((rgb > 1).sum())
        n["rgb_levels"] += int(rgb.sum(dtype=torch.int64))
        n["rgb"] += rgb.numel()
        n["alpha_off"] += int((alpha > 0).sum())
        n["alpha_far"] += int((alpha > 1).sum())
        n["alpha"] += alpha.numel()
        est = float(want[j]["bits"].sum()) / 8.0
        rate_gap = max(rate_gap, abs(nbytes - est) / est)
    return {"rgb_far_share": n["rgb_far"] / max(n["rgb"], 1),
            "rgb_mean_levels": n["rgb_levels"] / max(n["rgb"], 1),
            "alpha_off_share": n["alpha_off"] / max(n["alpha"], 1),
            "alpha_far_share": n["alpha_far"] / max(n["alpha"], 1),
            "rate_gap": rate_gap}


def check(ctx) -> dict:
    ctx.reference = reference(ctx)
    return compare(ctx, ctx.outputs, ctx.reference)


def control(ctx) -> dict:
    """The control's numbers: the reference with TF32 on, in the program's
    place (its estimate stands in for the bytes)."""
    low = reference(ctx, tf32=True)
    got = [(j, low[j]["rgba"].cpu().numpy(), float(low[j]["bits"].sum()) / 8)
           for j in low]
    return compare(ctx, got, ctx.reference)


def flops(ctx, calls: list) -> float:
    """Model FLOPs of the given calls' round trips (``work.codec_flops``),
    gated by the reference's decoded alpha of each batch."""
    per = {}
    for j in set(calls):
        alpha = ctx.reference[j]["rgba"][..., 3:].permute(0, 3, 1, 2)
        alpha = alpha.float() / 255.0
        coded = sum(1 for a in ctx.inputs[j][1] if not np.all(a == 255))
        per[j] = work.codec_flops(alpha, coded)
    return float(sum(per[j] for j in calls))


def call_input(ctx, i: int) -> int:
    return i % len(ctx.inputs)
