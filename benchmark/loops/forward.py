"""Window loop of the eval forward: a closed loop of ``RGBAPipeline`` on
batches held on the device, each call's three rates fetched to the host
as an evaluation does.  The traffic names the batch, the image size and
how many distinct batches the loop cycles through, all made from the
seed.

What is compared, once the window has closed and the program is freed:
every call's rates against the reference's forward of the same batch,
and the whole outputs (x_hat, the decoded alpha) of ``keep`` calls drawn
from the seed (reservoir sampling over the window's calls, so the
outputs stay on the device without a copy).
"""

from __future__ import annotations

import random
import time

import torch

import program
import work
from reference import model as ref
from reference import outputs as refout

RATES = ("bpp", "bpp_rgb", "bpp_mask")


def setup(ctx) -> None:
    t, dev = ctx.traffic, ctx.device
    program.build_kernels(dev)
    ctx.state_dict = work.make_state(ctx.seed, ctx.config["gains"], dev)
    ctx.program = {"pipe": program.pipeline(ctx.config["route"],
                                            ctx.state_dict, dev)}
    b, n = t["batch"], t["distinct"]
    imgs = work.make_images(ctx.seed, b * n, t["height"], t["width"], dev)
    alpha = imgs["alpha"].float() / 255.0
    ctx.inputs = [(imgs["masked_image"][i * b:(i + 1) * b],
                   alpha[i * b:(i + 1) * b]) for i in range(n)]
    ctx.rates, ctx.kept = [], []
    ctx.sampler = random.Random(ctx.seed)
    for _ in range(t.get("warmup", 2)):
        run_call(ctx, ctx.program["pipe"], 0)


def run_call(ctx, pipe, i: int):
    x, a = ctx.inputs[i % len(ctx.inputs)]
    t0 = time.time_ns()
    out = pipe(x, a)
    t1 = time.time_ns()
    rates = torch.stack([out[k].float() for k in RATES]).cpu().tolist()
    t2 = time.time_ns()
    return out, rates, [("forward", t0, t1), ("fetch", t1, t2)]


def call(ctx, i: int) -> dict:
    out, rates, spans = run_call(ctx, ctx.program["pipe"], i)
    j = i % len(ctx.inputs)
    ctx.rates.append((j, rates))
    keep = ctx.traffic.get("keep", 4)
    item = (j, out["x_hat"], out["recon_mask"])
    if len(ctx.kept) < keep:
        ctx.kept.append(item)
    else:
        slot = ctx.sampler.randrange(len(ctx.rates))
        if slot < keep:
            ctx.kept[slot] = item
    return {"spans": spans, "images": x_len(ctx, j)}


def x_len(ctx, j: int) -> int:
    return int(ctx.inputs[j][0].shape[0])


def free(ctx) -> None:
    ctx.program = None


def reference(ctx) -> tuple:
    """The reference's forward of each distinct batch in float32 (TF32 off),
    and again with the convolutions and the attention's products in
    bfloat16: the yardstick of what bf16 arithmetic alone moves on this
    seed's weights."""
    model = ref.RGBAModel().to(ctx.device).eval()
    model.load_state_dict(ctx.state_dict)
    out, yard = {}, {}
    block = ctx.traffic.get("ref_block", 16)
    with refout.tf32(False):
        for j in sorted({j for j, _ in ctx.rates}):
            out[j] = refout.forward(model, *ctx.inputs[j], block)
        model.set_dtype(torch.bfloat16)
        for j in sorted({j for j, _, _ in ctx.kept}):
            yard[j] = refout.forward(model, *ctx.inputs[j], block)["x_hat"]
    del model
    return out, yard


def compare(ctx, rates, kept) -> dict:
    """The numbers that may be compared (the configuration's ``limits``
    say which are), each the worst call, against the reference
    (``ctx.reference``) and its bf16 yardstick (``ctx.yardstick``).  The
    seeds' weights differ by an order of magnitude in how far rounding
    moves x_hat, so x_hat's error is given in units of what bf16
    arithmetic moves on the same weights: ``far4_vs_bf16``, the share of
    x_hat values more than 4e-3 (about one 8-bit level) off, over the
    same share of the yardstick's; ``q99_vs_bf16``, the 99th percentile
    of |x_hat - the reference's| over the yardstick's.  Besides, the
    rates' largest relative gap and the share of decoded alpha values
    more than one 8-bit level off."""
    want, yard = ctx.reference, ctx.yardstick
    out = {"far4_vs_bf16": 0.0, "q99_vs_bf16": 0.0, "rate_rel_gap": 0.0,
           "alpha_far_share": 0.0}
    for j, got in rates:
        for k, g in zip(RATES, got):
            r = float(want[j][k])
            out["rate_rel_gap"] = max(out["rate_rel_gap"],
                                      abs(g - r) / max(abs(r), 1e-12))
    for j, x_hat, recon in kept:
        r = want[j]
        dx = (x_hat.float() - r["x_hat"]).abs().flatten()
        dy = (yard[j] - r["x_hat"]).abs().flatten()
        share = float((dx > 4e-3).float().mean())
        base = max(float((dy > 4e-3).float().mean()), 1e-6)
        out["far4_vs_bf16"] = max(out["far4_vs_bf16"], share / base)
        at = int(0.99 * dx.numel())
        q = float(dx.sort().values[at]) / max(
            float(dy.sort().values[at]), 1e-9)
        out["q99_vs_bf16"] = max(out["q99_vs_bf16"], q)
        levels = torch.round((recon.float() - r["recon_mask"]).abs() * 255.0)
        out["alpha_far_share"] = max(out["alpha_far_share"],
                                     float((levels > 1).float().mean()))
    return out


def check(ctx) -> dict:
    ctx.reference, ctx.yardstick = reference(ctx)
    return compare(ctx, ctx.rates, ctx.kept)


def control(ctx) -> dict:
    """The control's numbers: the program's own int8 path
    (``configs``' ``control_route``) on the same weights and batches."""
    pipe = program.pipeline(ctx.config["control_route"], ctx.state_dict,
                            ctx.device)
    rates, kept = [], []
    for j in sorted(ctx.yardstick):
        out, r, _ = run_call(ctx, pipe, j)
        rates.append((j, r))
        kept.append((j, out["x_hat"], out["recon_mask"]))
    del pipe
    return compare(ctx, rates, kept)


def flops(ctx, calls: list) -> float:
    """Model FLOPs of the given calls' forwards (``work.forward_flops``):
    the analysis gated by the batch's alpha, the synthesis by the
    reference's decoded alpha."""
    per = {}
    for j in set(calls):
        a = ctx.inputs[j][1].permute(0, 3, 1, 2)
        recon = ctx.reference[j]["recon_mask"].permute(0, 3, 1, 2)
        per[j] = work.forward_flops(a, recon)
    return float(sum(per[j] for j in calls))


def kernel_bounds(ctx) -> dict:
    """Seconds of the bound of one call's launches of each kernel."""
    t = ctx.traffic
    return work.forward_kernel_bounds(t["batch"], t["height"], t["width"])


def call_input(ctx, i: int) -> int:
    return i % len(ctx.inputs)
