"""What the trained-weight tools share (each of the JAX package's
``tools/*.py`` carries its own copy of it).

* ``prepare``: the device (``cuda`` unless the caller asks for the CPU)
  and, on the card, every kernel of the path built at once (one nvcc per
  source) beside the host rANS coder;
* ``synth_data``: ``DATA_N`` synthetic 256x256 RGBA images made once and
  held on the device; each training batch is gathered from them there;
* ``train_one``: one codec trained to a step budget, resumable from the
  latest ``iter_<N>.ckpt`` of its directory (params only, the reference's
  semantics), checkpointed every ``CKPT_EVERY`` steps (the latest kept);
* ``resume_parity``: the crash-resume check (save, fresh trainer, load,
  one step on the same batch with the same noise seed);
* ``make_codec`` / ``eval_point``: one ``RGBAFileCodec`` over two
  ``CodecIO``, loaded with each model's checkpoints in turn, then
  ``evaluate_kodak(real_codec=True, codec=...)``;
* ``write_points``: ``rd_points.json`` and ``QUALITY.json`` with the JAX
  tool's keys;
* ``load_trained`` / ``trained_codec``: the weights of a trained pair,
  which the probes load.

Trainers (bf16) and the codec (fp32) run with the four conv kernels on
(``fused_win_attn``, ``fused_gdn``, ``fused_gate_chain``, ``fused_dse``;
``packed_dse`` off so the DSE kernel runs).  On the card each training
step and each evaluated image must launch them as the path does
(``RGB_STEP_LAUNCHES``, ``MASK_STEP_LAUNCHES``, ``EVAL_IMAGE_LAUNCHES``;
a run's steps are counted in sum, and its first step alone), else the
tool raises; on the CPU the wrappers take their plain versions
and launch nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.precision import DEFAULT_POLICY, policy_from_str, resolve_device
from ..data.synthetic import synthetic_rgba_batch, write_synthetic_kodak_tree
from ..eval.codec_io import CodecIO
from ..eval.container import RGBAFileCodec
from ..eval.kodak import evaluate_kodak
from ..models.mask_codec import MaskCodec
from ..models.rgb_codec import RGBCodec
from ..ops.kernels import dse, gate_chain, gdn, rans_decode, win_attn
from ..train.checkpoint import (latest_checkpoint, load_checkpoint,
                                save_checkpoint, step_from_path)
from ..train.loops import MaskTrainer, RGBTrainer

LAMBDAS = (256, 1024, 4096)
MASK_LAMBDA = 1024
MSSSIM_LAMBDA = 64       # the scale at which 1 - MS-SSIM trades against bpp
# distinct synthetic images held on the device: 20k steps at batch 16 over
# 128 images memorize them (the JAX sweep's eval bpp rose 0.38 -> 1.00)
DATA_N = 512
CKPT_EVERY = 1000
RESUME_RTOL = 1e-4       # the crash-resume check on the card (bf16 steps)
EVAL_IMAGES, EVAL_HW = 4, (512, 768)

CONV_KERNELS = {"fused_window_attention": win_attn.KERNEL,
                "fused_gdn": gdn.KERNEL,
                "fused_gate_chain": gate_chain.KERNEL,
                "fused_dse": dse.KERNEL}
# one training step (the backward launches no kernel)
RGB_STEP_LAUNCHES = dict(zip(CONV_KERNELS, (4, 6, 4, 1)))
MASK_STEP_LAUNCHES = dict(zip(CONV_KERNELS, (0, 6, 4, 1)))
# one image of evaluate_kodak(real_codec=True): the eval step (4 / 12 / 8 /
# 2), the encode + decode (4 / 15 / 10 / 3) and the RGB codec forward that
# codec_err reads (4 / 6 / 4 / 1)
EVAL_IMAGE_LAUNCHES = dict(zip(CONV_KERNELS, (12, 33, 22, 6)))

DATA_NOTE = ("synthetic (data/synthetic.py; no real COCO/P3M/Kodak images): "
             "absolute PSNR/MS-SSIM levels are not comparable to the "
             "paper's; RD ordering and real-vs-estimated bpp agreement are "
             "the claims")


def _ts() -> str:
    return time.strftime("%H:%M:%S")


def log(msg: str) -> None:
    print(f"[{_ts()}] {msg}", flush=True)


def tool_parser(doc: str) -> argparse.ArgumentParser:
    """The flags every tool takes: ``--device`` and ``--outdir``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--outdir", default="build/proofs",
                    help="checkpoints, the Kodak tree and the JSON results")
    return ap


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def prepare(device=None) -> torch.device:
    """The tools' device; on the card, print it and build every kernel the
    tools launch (one nvcc per source, all started together) and the host
    rANS coder before the first step."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..native import rans
        from ..ops.kernels import build
        log(f"device {torch.cuda.get_device_name(dev)}; {card()}")
        t = time.perf_counter()
        build.build_all(list(CONV_KERNELS.values()) + [rans_decode.KERNEL])
        rans.build()
        log(f"kernels and rANS coder built in {time.perf_counter() - t:.1f} s")
    else:
        log("device cpu: the kernels' plain versions, no launch")
    return dev


def reset_launches() -> None:
    for k in (*CONV_KERNELS.values(), rans_decode.KERNEL):
        k.launches = 0


def launches() -> dict:
    out = {n: k.launches for n, k in CONV_KERNELS.items()}
    out["rans_decode"] = rans_decode.KERNEL.launches
    return out


def check_launches(device: torch.device, per_unit: dict, units: int,
                   what: str) -> dict:
    """Print the launches since ``reset_launches`` and, on the card, raise
    unless the conv kernels launched ``units`` x ``per_unit``."""
    got = launches()
    print(f"  launches in {what}: {got}", flush=True)
    want = {n: units * c for n, c in per_unit.items()}
    if device.type == "cuda" and {n: got[n] for n in want} != want:
        raise AssertionError(f"{what}: expected launches {want}, got {got}")
    return got


def all_kernels(policy):
    return dataclasses.replace(policy, fused_win_attn=True, fused_gdn=True,
                               fused_gate_chain=True, fused_dse=True,
                               packed_dse=False)


def synth_data(n: int = DATA_N, hw: int = 256, device=None) -> dict:
    """``n`` synthetic images (the JAX sweep's: batches of 16 from seeds 0,
    16, 32, ...) as NHWC fp32 tensors on the device, made once: one copy
    to the card instead of one a step (~1.8 MB an image at 256x256)."""
    dev = resolve_device(device)
    keys = ("masked_image", "alpha", "image")
    chunks = {k: [] for k in keys}
    for i in range(0, n, 16):
        b = synthetic_rgba_batch(min(16, n - i), hw, hw, seed=i)
        for k in keys:
            chunks[k].append(b[k])
    return {k: torch.from_numpy(np.concatenate(v)).to(dev)
            for k, v in chunks.items()}


def lazy_data(device, n: int = DATA_N):
    """A function that makes ``synth_data(n)`` at its first call and hands
    the same tensors back at every later one (a tool whose models are all
    trained already makes none)."""
    made = {}

    def get() -> dict:
        if not made:
            made.update(synth_data(n, device=device))
        return made
    return get


def make_trainer(kind: str, cfg: TrainConfig, ckdir: str, device):
    """A trainer whose codec runs the four kernels (``cfg.compute_dtype``'s
    policy with every kernel flag on)."""
    dev = resolve_device(device)
    cls, model_cls = ((RGBTrainer, RGBCodec) if kind == "rgb"
                      else (MaskTrainer, MaskCodec))
    model = model_cls(policy=all_kernels(policy_from_str(cfg.compute_dtype)),
                      device=dev,
                      generator=torch.Generator().manual_seed(cfg.seed))
    return cls(cfg, ckdir, model=model, device=dev)


def _load(module, path: str) -> None:
    missing = load_checkpoint(module, path)
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} of "
                         f"{type(module).__name__}'s tensors: {missing[:5]}")


def _save_latest(module, ckdir: str, step: int) -> str:
    """Checkpoint ``module`` at ``step`` and delete the older ones."""
    path = save_checkpoint(module.state_dict(), ckdir, step)
    for name in os.listdir(ckdir):
        old = os.path.join(ckdir, name)
        if name.startswith("iter_") and name.endswith(".ckpt") and old != path:
            os.remove(old)
    return path


def train_one(name: str, kind: str, lam: float, steps: int, outdir: str,
              distortion: str = "mse", *, data: dict, batch_size: int = 16,
              dtype: str = "bfloat16", ckpt_every: int = CKPT_EVERY,
              log_every: int = 400) -> dict:
    """Train ``kind`` ("rgb" or "mask") at ``lam`` to ``steps`` steps in
    ``<outdir>/<name>_ck``, from its latest checkpoint if there is one (a
    model already at its budget is not trained again).  Each batch is
    ``batch_size`` images of ``data`` (``synth_data``'s dict, or a function
    that makes it, called only when the model trains) drawn on the host
    from a seeded ``RandomState`` and gathered on the device; the noise
    generator is seeded with ``lam`` + the first step.

    Returns {"ckdir", "start", "steps", "trainer", "state", "curve" (one
    {"step", "rd_loss", "bpp", "mse"} a step), "seconds", "steps_per_s"};
    "trainer" and "state" are None when nothing was trained."""
    ckdir = os.path.join(outdir, f"{name}_ck")
    out = {"ckdir": ckdir, "trainer": None, "state": None, "curve": [],
           "steps": steps}
    latest = latest_checkpoint(ckdir)
    start = step_from_path(latest) if latest else 0
    out["start"] = start
    if start >= steps:
        log(f"{name}: already trained to {start}, reused")
        return out
    if callable(data):
        data = data()
    device = data["alpha"].device
    cfg = TrainConfig(train_lambda=lam, batch_size=batch_size, cal_step=1,
                      tot_step=steps, aux_lr=1e-3, curriculum_step=0,
                      snapshot_freq=10 ** 9, save_model_freq=10 ** 9,
                      compute_dtype=dtype, distortion=distortion)
    trainer = make_trainer(kind, cfg, ckdir, device)
    if latest:
        _load(trainer.model, latest)
        log(f"{name}: resuming from step {start}")
    state = trainer.init_state(step=start)
    trainer.noise.manual_seed(int(lam) + start)
    idx_rng = np.random.RandomState(1000 + int(lam) + start)
    n = len(data["alpha"])
    per_step = RGB_STEP_LAUNCHES if kind == "rgb" else MASK_STEP_LAUNCHES
    pending = []

    def flush():
        keys = ("rd_loss", "bpp", "mse_loss")
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for _, m in pending]).cpu().tolist()
        for (i, _), (rd, bpp, mse) in zip(pending, vals):
            out["curve"].append({"step": i, "rd_loss": rd, "bpp": bpp,
                                 "mse": mse})
        pending.clear()

    reset_launches()
    t0 = time.perf_counter()
    for i in range(start, steps):
        idx = torch.from_numpy(idx_rng.randint(0, n, size=batch_size))
        batch = {k: data[k][idx.to(device)] for k in trainer.batch_keys}
        pending.append((i, trainer.step(state, batch)))
        if i == start:      # a route off shows at once, not after the run
            check_launches(device, per_step, 1, f"{name}'s first step")
        if len(pending) == 25 or i == steps - 1:
            flush()
        if (i + 1) % log_every == 0 or i == steps - 1:
            c = out["curve"][-1]
            log(f"{name} step {c['step']}: rd={c['rd_loss']:.3f} "
                f"bpp={c['bpp']:.4f} mse={c['mse']:.6f}")
        if (i + 1) % ckpt_every == 0 and i + 1 < steps:
            _save_latest(trainer.model, ckdir, i + 1)
    _save_latest(trainer.model, ckdir, steps)
    secs = time.perf_counter() - t0
    check_launches(device, per_step, steps - start,
                   f"{name}'s steps {start}..{steps}")
    out.update(trainer=trainer, state=state, seconds=secs,
               steps_per_s=(steps - start) / secs)
    log(f"{name}: steps {start}..{steps} in {secs:.1f} s "
        f"({out['steps_per_s']:.3f} steps/s, batch {batch_size})")
    return out


def resume_parity(kind: str, run: dict, batch: dict, seed: int = 99) -> dict:
    """The crash-resume check of a ``train_one`` result: checkpoint the
    trained params, take one step on ``batch`` with the noise generator
    seeded with ``seed`` (the reference loss), then build a fresh trainer,
    load the checkpoint, and take the same step.  A step's loss comes from
    the incoming params, so a faithful round trip reproduces it (the Adam
    moments restart fresh, the reference's semantics, and do not reach
    it).  Returns the two losses and their relative gap."""
    trainer, state = run["trainer"], run["state"]
    path = save_checkpoint(trainer.model.state_dict(), run["ckdir"],
                           state.step)
    trainer.noise.manual_seed(seed)
    ref = float(trainer.step(state, batch)["rd_loss"])
    fresh = make_trainer(kind, trainer.cfg, run["ckdir"],
                         trainer.device)
    _load(fresh.model, latest_checkpoint(run["ckdir"]))
    resumed_at = step_from_path(path)
    state2 = fresh.init_state(step=resumed_at)
    fresh.noise.manual_seed(seed)
    loss = float(fresh.step(state2, batch)["rd_loss"])
    rel = abs(loss - ref) / max(abs(ref), 1e-6)
    log(f"{kind} resume parity at step {resumed_at}: pre-crash {ref:.6f} "
        f"resumed {loss:.6f} (rel {rel:.3g})")
    return {"step": resumed_at, "pre_crash": ref, "resumed": loss,
            "rel": rel}


def kodak_tree(outdir: str, n_images: int = EVAL_IMAGES,
               hw: tuple = EVAL_HW) -> str:
    """A synthetic Kodak-layout tree of ``n_images`` (seeds 0...) under
    ``outdir``, written unless it is there."""
    root = os.path.join(outdir, f"kodak_{n_images}x{hw[0]}x{hw[1]}")
    if not os.path.exists(os.path.join(root, "ImageSets", "mask.txt")):
        write_synthetic_kodak_tree(root, n_images, *hw)
    return root


def make_codec(device) -> RGBAFileCodec:
    """The fp32 codec (the bitstream's contract) with the four kernels on,
    over seeded weights that ``eval_point`` replaces."""
    dev = resolve_device(device)
    policy = all_kernels(DEFAULT_POLICY)
    g = torch.Generator().manual_seed(0)
    return RGBAFileCodec(
        CodecIO(RGBCodec(policy=policy, device=dev, generator=g), "rgb"),
        CodecIO(MaskCodec(policy=policy, device=dev, generator=g), "mask"))


def eval_point(codec: RGBAFileCodec, tree: str, rgb_ckpt: str,
               mask_ckpt: str, real_codec: bool = True) -> dict:
    """Load the two checkpoints (the port's or the JAX package's
    ``iter_<N>.ckpt``) into ``codec``'s models and evaluate them over the
    Kodak tree at ``tree``, with the real bitstream (``evaluate_kodak``
    re-points the codec's tables at the new weights, ``set_params``).
    Returns the averages rounded to 6 decimals and the RGB checkpoint's
    step."""
    rgb, mask = codec.rgb_io.model, codec.mask_io.model
    _load(rgb, rgb_ckpt)
    _load(mask, mask_ckpt)
    n = len(open(os.path.join(tree, "ImageSets", "mask.txt")).read().split())
    reset_launches()
    avg = evaluate_kodak(rgb, mask, tree, real_codec=real_codec,
                         codec=codec if real_codec else None)
    if real_codec:
        check_launches(codec.device, EVAL_IMAGE_LAUNCHES, n,
                       f"evaluate_kodak of {n} images (eval step, encode + "
                       f"decode, codec forward)")
    point = {k: round(float(v), 6) for k, v in avg.items()}
    point["step"] = step_from_path(rgb_ckpt)
    return point


def write_points(outdir: str, points: dict, runs: dict,
                 tree_shape: tuple = (EVAL_IMAGES, *EVAL_HW)) -> None:
    """``rd_points.json`` (the points as evaluated) and ``QUALITY.json``
    (each point with its lambda, distortion and real-vs-estimated bpp gap,
    and the card it ran on), each replaced atomically."""
    def dump(name, obj):
        path = os.path.join(outdir, name)
        with open(path + ".tmp", "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(path + ".tmp", path)

    dump("rd_points.json", points)
    n, h, w = tree_shape
    qual = {"generated_by": "rgba_tpu_torch/tools/rd_sweep_proof.py",
            "data": DATA_NOTE,
            "eval": {"images": n, "height": h, "width": w,
                     "real_bitstream": True},
            "device": card() if torch.cuda.is_available() else "cpu",
            "points": {}}
    for name, p in sorted(points.items()):
        _, lam, _, dist = runs.get(name, ("rgb", None, 0, "mse"))
        row = dict(p, **{"lambda": lam, "distortion": dist})
        if "real_bpp" in p and p.get("bpp"):
            row["real_vs_est_bpp_pct"] = round(
                (p["real_bpp"] - p["bpp"]) / p["real_bpp"] * 100, 3)
        qual["points"][name] = row
    dump("QUALITY.json", qual)


def load_trained(lam: float, outdir: str) -> dict:
    """The ``RGBAPipeline`` state dict of the trained pair under
    ``outdir``: the mask codec's latest checkpoint and that of the RGB
    codec trained at ``lam`` (``rd_sweep_proof`` or ``train_pair``)."""
    sd = {}
    for sub, name in (("mask_codec", "mask"), ("rgb_codec", f"rgb_{lam}")):
        ck = latest_checkpoint(os.path.join(outdir, f"{name}_ck"))
        if ck is None:
            raise FileNotFoundError(
                f"no {name} checkpoint under {outdir}: run "
                f"`python -m rgba_tpu_torch.tools.train_pair --lam {lam} "
                f"--outdir {outdir}` (or rd_sweep_proof) first")
        log(f"{sub}: {ck}")
        sd.update({f"{sub}.{k}": v for k, v in torch.load(
            ck, map_location="cpu", weights_only=True).items()})
    return sd


def trained_codec(lam: float, outdir: str, device) -> RGBAFileCodec:
    """``make_codec`` holding the trained pair's weights."""
    sd = load_trained(lam, outdir)
    codec = make_codec(device)
    for io, sub in ((codec.rgb_io, "rgb_codec"), (codec.mask_io, "mask_codec")):
        io.set_params({k[len(sub) + 1:]: v for k, v in sd.items()
                       if k.startswith(sub + ".")})
    return codec


def masked_psnr(x: np.ndarray, x_hat: np.ndarray, alpha: np.ndarray) -> float:
    """PSNR over the pixels whose alpha is above 0."""
    m = np.broadcast_to((alpha > 0).astype(np.float64), x.shape)
    mse = float((((x - x_hat) * m) ** 2).sum() / max(m.sum(), 1.0))
    return 10 * np.log10(1.0 / max(mse, 1e-12))
