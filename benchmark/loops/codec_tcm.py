"""Window loop of the bitstream codec over TCM, the mixed Transformer-CNN
codec of opaque images (``rgba_tpu_torch/models/tcm.py``): a closed loop
of one client, each call ``RGBAFileCodec.encode_batch`` of a batch of
opaque uint8 RGBA images held on the host (no mask stream), then
``decode_batch(output="uint8")`` of its blobs.  The traffic names the
batch, the image size and how many distinct batches the client cycles
through, all made from the seed (``tcm_work.make_images``); the
configuration's ``model`` gives the widths.

What is compared, once the window has closed and the program is freed:
every call's decoded RGB against the reference's round trip of the same
images (``reference/tcm.codec``), every call's bytes against the
reference's code length, and every decoded alpha against 255.
"""

from __future__ import annotations

import torch

import program
import tcm_work
from loops import codec as paper
from reference import tcm as ref


def build(ctx):
    """The program: TCM under the route's policy with the run's state
    dict, and the container codec over it."""
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.models.tcm import TCM
    widths = {k: tuple(v) if isinstance(v, list) else v
              for k, v in ctx.config["model"].items()}
    model = TCM(policy=program.policy(ctx.config["route"]), device=ctx.device,
                generator=torch.Generator().manual_seed(0), **widths)
    model.load_state_dict(ctx.state_dict, strict=True)
    return {"model": model.eval(),
            "codec": RGBAFileCodec(CodecIO(model, "rgb"))}


def setup(ctx) -> None:
    from rgba_tpu_torch.models import tcm  # noqa: F401  (fails at once without TCM)
    t, dev = ctx.traffic, ctx.device
    program.build_kernels(dev)
    ctx.state_dict = tcm_work.make_state(ctx.seed, ctx.config["model"],
                                         ctx.config["gains"], dev)
    ctx.program = build(ctx)
    b, n = t["batch"], t["distinct"]
    imgs = tcm_work.make_images(ctx.seed, b * n, t["height"], t["width"], dev)
    ctx.inputs = [(imgs["image"][i * b:(i + 1) * b].cpu().numpy(),
                   imgs["alpha"][i * b:(i + 1) * b].cpu().numpy())
                  for i in range(n)]
    ctx.outputs = []
    for _ in range(t.get("warmup", 2)):
        paper.run_call(ctx, ctx.program, 0)


def call(ctx, i: int) -> dict:
    out = paper.run_call(ctx, ctx.program, i)
    ctx.outputs.append((i % len(ctx.inputs), out["rgba"], out["nbytes"]))
    return {"spans": out["spans"], "images": out["images"]}


def free(ctx) -> None:
    ctx.program["codec"].rgb_io.close()
    ctx.program = None


def reference(ctx, tf32: bool = False) -> dict:
    """The reference's decoded RGB (on the device) and code length of each
    distinct batch, in float32 (``tf32``: with TF32 on, the control)."""
    model = tcm_work.model(ctx.config["model"]).to(ctx.device).eval()
    model.load_state_dict(ctx.state_dict)
    out = {}
    for j in sorted({j for j, _, _ in ctx.outputs}):
        image = torch.from_numpy(ctx.inputs[j][0]).to(ctx.device)
        out[j] = ref.codec(model, image, ctx.traffic.get("ref_block", 4),
                           tf32_on=tf32)
    del model
    return out


def compare(ctx, got, want) -> dict:
    """The numbers that may be compared (the configuration's ``limits``
    say which are): the share of decoded RGB values more than one 8-bit
    level off the reference's and their mean distance in levels, the share
    of decoded alpha values that are not 255, and the largest gap between
    a call's bytes and the reference's code length, as a share of it."""
    n = {"rgb_far": 0, "rgb_levels": 0, "rgb": 0, "alpha_off": 0,
         "alpha": 0}
    rate_gap = 0.0
    for j, rgba, nbytes in got:
        r = want[j]["rgb"]
        rgba = torch.as_tensor(rgba).to(r.device)
        d = (rgba[..., :3].short() - r.short()).abs()
        n["rgb_far"] += int((d > 1).sum())
        n["rgb_levels"] += int(d.sum(dtype=torch.int64))
        n["rgb"] += d.numel()
        n["alpha_off"] += int((rgba[..., 3] != 255).sum())
        n["alpha"] += rgba[..., 3].numel()
        est = float(want[j]["bits"].sum()) / 8.0
        rate_gap = max(rate_gap, abs(nbytes - est) / est)
    return {"rgb_far_share": n["rgb_far"] / max(n["rgb"], 1),
            "rgb_mean_levels": n["rgb_levels"] / max(n["rgb"], 1),
            "alpha_off_share": n["alpha_off"] / max(n["alpha"], 1),
            "rate_gap": rate_gap}


def check(ctx) -> dict:
    ctx.reference = reference(ctx)
    return compare(ctx, ctx.outputs, ctx.reference)


def control(ctx) -> dict:
    """The control's numbers: the reference with TF32 on, in the program's
    place, its alpha 255 (its code length stands in for the bytes)."""
    low = reference(ctx, tf32=True)
    got = []
    for j in low:
        rgb = low[j]["rgb"]
        alpha = torch.full_like(rgb[..., :1], 255)
        got.append((j, torch.cat([rgb, alpha], -1),
                    float(low[j]["bits"].sum()) / 8))
    return compare(ctx, got, ctx.reference)


def _shape(ctx):
    t = ctx.traffic
    return t["batch"], t["height"], t["width"]


def flops(ctx, calls: list) -> float:
    """Model FLOPs of the given calls' round trips (``tcm_work.codec_flops``;
    every window is alive, so each call of a batch costs the same)."""
    return float(len(calls) * tcm_work.codec_flops(ctx.config["model"],
                                                   *_shape(ctx)))


def kernel_bounds(ctx) -> dict:
    """Seconds of the bound of one call's launches of each hand-written
    kernel (``tcm_work.kernel_bounds``)."""
    return tcm_work.kernel_bounds(ctx.config["model"], *_shape(ctx))


def call_input(ctx, i: int) -> int:
    return i % len(ctx.inputs)
