"""Training loops for both codecs (port of ``rgba_tpu/train/loops.py``).

RD loss = lambda * distortion + bpp, Adam on value-clamped gradients, LR
step decay, windowed meters, periodic rotating snapshots and full
checkpoints, and with ``image_dump_dir`` a PNG of the first image's
reconstruction at every snapshot.  The RGB loop keeps the curriculum:
before ``curriculum_step`` the input is the full image with an all-ones
mask, and the GT mask gates the decoder.

One process drives one GPU: a batch moves to the device with one
non-blocking copy per array, and the step runs eagerly.  With a kernel flag
of the policy on, the forward of that op is the CUDA kernel and its
gradients come from the plain formulation (``ops/kernels/remat.py``).

Data parallel (the JAX trainer's ``data`` mesh): with a
``torch.distributed`` group of more than one process
(``parallel/distributed.initialize``, for example under ``torchrun``), the
model is wrapped in ``DistributedDataParallel`` and each rank steps on its
``local_batch_slice`` of the global batch that every rank's loader yields.
The gradients are all-reduced (mean) before the clamp and the two Adams,
as the JAX step's psum comes before its clamp; the entropy bottleneck's
quantiles, which only the aux loss reaches (a function of the parameters
alone, the same on every rank), are left out of the all-reduce.  Each rank
draws the noise of the whole global batch from the shared seed and keeps
its slice, so a step does not depend on the number of ranks (the JAX
package's noise on a global array does not depend on its sharding).  The
losses are means over images (the masked MSE, 1 - MS-SSIM) or sums over
the batch's pixels divided by their count (bpp), so the mean over equal
shards is the global batch's; the metrics a step returns are averaged
over the ranks.  Only rank 0 writes snapshots, image dumps and logs.

Height sharding (the JAX trainer's ``mesh=`` with a ``space`` axis): with
``mesh=make_process_mesh(space=S)`` each rank steps on its data shard's
band of rows inside ``parallel.spatial.space_scope``.  The step's losses
are the whole shard's on every rank of a space group; a rank's backward of
that replicated loss gives S times its share of the gradient
(``parallel/spatial.py``), and DDP's mean over all S x D ranks leaves the
mean over the ``data`` axis: the single process's gradient.  The noise is
drawn for the data axis's global batch at the whole latent's height (the
entropy head runs on the whole latent).  The MS-SSIM distortion does not
split into bands and raises there.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..core.config import TrainConfig
from ..core.precision import policy_from_str, precision_scope, resolve_device
from ..data.png import write_png
from ..metrics.ms_ssim import masked_ms_ssim
from ..models.mask_codec import MaskCodec
from ..models.rgb_codec import RGBCodec
from ..ops.mask_pyramid import mask_pyramid
from ..parallel import spatial
from ..parallel.distributed import (data_axis, local_batch_slice,
                                    process_count, process_index)
from .checkpoint import save_checkpoint, save_rotating
from .meters import AverageMeter
from .state import (CodecTrainState, is_quantiles, make_train_state,
                    make_train_step)

logger = logging.getLogger("rgba_tpu_torch")

_METRIC_KEYS = ("mse_loss", "bpp", "bpp_y", "bpp_z")


def _mask_loss_fn(cfg: TrainConfig):
    """loss_fn(model, batch, generator): batch["alpha"] is (B, 1, H, W)."""
    def loss_fn(model, batch, generator):
        out = model(batch["alpha"], training=True, generator=generator)
        rd = cfg.train_lambda * out["mse_loss"] + out["bpp"]
        return rd, {k: out[k] for k in _METRIC_KEYS}
    return loss_fn


def _rgb_loss_fn(cfg: TrainConfig):
    """loss_fn(model, batch, generator): batch["masked_image"] (B, 3, H, W)
    and batch["alpha"] (B, 1, H, W); the GT alpha also gates the decoder."""
    if cfg.distortion not in ("mse", "msssim"):
        raise ValueError(f"unknown distortion: {cfg.distortion!r}")

    def loss_fn(model, batch, generator):
        mask = batch["alpha"]
        out = model(batch["masked_image"], mask, mask, mask_pyramid(mask),
                    training=True, generator=generator)
        if cfg.distortion == "msssim":
            if spatial.current() is not None:
                raise ValueError("the MS-SSIM distortion does not split "
                                 "into bands of rows")
            # 1 - masked MS-SSIM over the alpha-visible region (it reduces
            # to the plain MS-SSIM for all-ones masks); the metric is NHWC
            def nhwc(t):
                return t.permute(0, 2, 3, 1)
            distortion = 1.0 - masked_ms_ssim(
                nhwc(batch["masked_image"]), nhwc(out["x_hat"]), nhwc(mask),
                data_range=1.0)
        else:
            distortion = out["mse_loss"]
        rd = cfg.train_lambda * distortion + out["bpp"]
        return rd, {k: out[k] for k in _METRIC_KEYS}
    return loss_fn


class Trainer:
    """Shared machinery for both codecs.  ``device`` defaults to ``cuda``
    and raises without CUDA unless the caller passes ``"cpu"``.
    ``data_parallel`` (None: when a process group of more than one process
    exists) wraps the model in ``DistributedDataParallel``; True also runs
    a group of one that way.  ``mesh``: a ``ProcessMesh`` whose ``data``
    axis cuts the batch and whose ``space`` axis cuts image height (see the
    module docstring); without one, every process is on the data axis."""

    # the batch arrays (NHWC numpy) that a step reads
    batch_keys = ("masked_image", "alpha", "image")

    def __init__(self, model_cls, cfg: TrainConfig, loss_fn, save_path: str,
                 model=None, device=None, snapshot_keep_after: int = 1_495_000,
                 image_dump_dir: str = "",
                 data_parallel: Optional[bool] = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        world = process_count()
        if cfg.num_devices > 0 and cfg.num_devices != world:
            raise ValueError(
                f"num_devices={cfg.num_devices} with {world} process(es): "
                f"here one process drives one device, so num_devices must "
                f"equal the process group's size (or be 0).  The JAX trainer "
                f"instead builds a data axis of gcd(batch_size, num_devices) "
                f"devices inside one process, which has no counterpart here")
        n_data = data_axis(mesh)[0]
        if cfg.batch_size % n_data:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide "
                             f"over {n_data} processes")
        self.data_parallel = world > 1 if data_parallel is None \
            else bool(data_parallel)
        if self.data_parallel and not dist.is_initialized():
            raise RuntimeError("data_parallel needs a process group "
                               "(parallel.distributed.initialize)")
        if self.data_parallel and self.device.type == "cuda" \
                and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.is_main = process_index() == 0
        self.cfg = cfg
        self.save_path = save_path
        self.snapshot_keep_after = snapshot_keep_after
        self.image_dump_dir = image_dump_dir
        if model is None:
            # cfg.compute_dtype selects the training policy; an explicitly
            # passed model keeps its own
            model = model_cls(policy=policy_from_str(cfg.compute_dtype),
                              device=self.device,
                              generator=torch.Generator().manual_seed(cfg.seed))
        if model.policy.int8_conv:
            raise ValueError("int8_conv is a serving policy: round has no "
                             "gradient")
        self.model = model
        self.forward_module = model
        if self.data_parallel:
            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
                model, [n for n, _ in model.named_parameters()
                        if is_quantiles(n)])
            self.forward_module = DistributedDataParallel(
                model, device_ids=None if self.device.type == "cpu"
                else [self.device.index], broadcast_buffers=False)
        self.loss_fn = loss_fn
        self._step_fn = make_train_step(cfg, loss_fn, lambda m: m.aux_loss())
        # all of the training noise, in draw order
        self.noise = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def init_state(self, step: int = 0) -> CodecTrainState:
        self.model.train()
        return make_train_state(self.cfg, self.model, step=step)

    def device_batch(self, batch: dict) -> dict:
        """The step's arrays as NCHW fp32 tensors on the device (views of
        NHWC memory, which is channels_last).  A host array is copied;
        a tensor (for example a batch gathered on the device) is moved
        only if it lies elsewhere."""
        out = {}
        for k in self.batch_keys:
            if k in batch:
                t = batch[k]
                if not isinstance(t, torch.Tensor):
                    t = torch.as_tensor(np.asarray(t), dtype=torch.float32)
                    if self.device.type == "cuda":
                        t = t.pin_memory()
                out[k] = t.to(self.device, torch.float32,
                              non_blocking=True).permute(0, 3, 1, 2)
        return out

    def noise_source(self):
        """Where the step's training noise comes from: the trainer's
        generator, or in data parallel a draw of the data axis's global
        batch's noise from it, of which this rank keeps its slice."""
        if not self.data_parallel:
            return self.noise
        n, r = data_axis(self.mesh)

        def draw(shape):
            b = shape[0]
            full = torch.rand((b * n, *shape[1:]), generator=self.noise,
                              device=self.device) - 0.5
            return full[b * r:b * (r + 1)]
        return draw

    def step(self, state: CodecTrainState, batch: dict,
             grads: Optional[dict] = None) -> dict:
        """One optimizer step on a host batch (in data parallel, the global
        batch: this rank takes its slice, and its band under height
        sharding); returns the metrics, averaged over the ranks.
        ``grads``: see ``make_train_step``."""
        if self.data_parallel:
            batch = {k: v[local_batch_slice(len(v), self.mesh)]
                     for k, v in batch.items() if k in self.batch_keys}
        if self.mesh is not None and self.mesh.space > 1:
            batch = {k: v[:, self.mesh.band_slice(v.shape[1])]
                     for k, v in batch.items() if k in self.batch_keys}
        with precision_scope(self.model.policy), \
                spatial.space_scope(self.mesh):
            m = self._step_fn(state, self.device_batch(batch),
                              self.noise_source(), self.forward_module, grads)
        if self.data_parallel:
            keys = sorted(m)
            t = torch.stack([m[k].float() for k in keys])
            dist.all_reduce(t)
            m = dict(zip(keys, t / process_count()))
        return m

    def train(self, loader, state: CodecTrainState, tb_writer=None,
              eval_fn: Callable[[int, CodecTrainState], None] = None,
              max_steps: Optional[int] = None) -> CodecTrainState:
        cfg = self.cfg
        meters = {k: AverageMeter(cfg.print_freq)
                  for k in ("elapsed", "loss", "psnr", "bpp", "bpp_y",
                            "bpp_z", "mse")}
        tot = max_steps if max_steps is not None else cfg.tot_step
        # the epoch follows from the resumed step, as in the reference
        try:
            steps_per_epoch = len(loader)
        except TypeError:
            steps_per_epoch = 0
        epoch = state.step // steps_per_epoch if steps_per_epoch > 0 else 0
        while state.step < tot:
            for batch in loader:
                t0 = time.time()
                m = self.step(state, batch)
                step = state.step

                if step % cfg.cal_step == 0:
                    m = {k: float(v) for k, v in m.items()}   # waits for the device
                    mse = m["mse_loss"]
                    meters["elapsed"].update(time.time() - t0)
                    meters["loss"].update(m["rd_loss"])
                    meters["bpp"].update(m["bpp"])
                    meters["bpp_y"].update(m["bpp_y"])
                    meters["bpp_z"].update(m["bpp_z"])
                    meters["mse"].update(mse)
                    meters["psnr"].update(
                        10 * math.log10(1.0 / mse) if mse > 0 else 100.0)
                if step % cfg.print_freq == 0 and self.is_main:
                    lr = cfg.lr_at(step)
                    if tb_writer is not None:
                        tb_writer.add_scalar("lr", lr, step)
                        tb_writer.add_scalar("rd_loss", meters["loss"].avg, step)
                        tb_writer.add_scalar("psnr", meters["psnr"].avg, step)
                        tb_writer.add_scalar("bpp", meters["bpp"].avg, step)
                    logger.info(
                        " | ".join([
                            f"Step [{step}/{tot}={step / tot * 100:.2f}%]",
                            f"Epoch {epoch}",
                            f"Time {meters['elapsed'].val:.3f} ({meters['elapsed'].avg:.3f})",
                            f"Lr {lr}",
                            f"Total Loss {meters['loss'].val:.3f} ({meters['loss'].avg:.3f})",
                            f"PSNR {meters['psnr'].val:.3f} ({meters['psnr'].avg:.3f})",
                            f"Bpp {meters['bpp'].val:.5f} ({meters['bpp'].avg:.5f})",
                            f"Bpp_feature {meters['bpp_y'].val:.5f} ({meters['bpp_y'].avg:.5f})",
                            f"Bpp_z {meters['bpp_z'].val:.5f} ({meters['bpp_z'].avg:.5f})",
                            f"MSE {meters['mse'].val:.5f} ({meters['mse'].avg:.5f})",
                        ]))
                if step % cfg.snapshot_freq == 0 and self.is_main:
                    save_rotating(self.model.state_dict(), self.save_path,
                                  step, cfg.snapshot_freq,
                                  self.snapshot_keep_after)
                    if self.image_dump_dir:
                        self._dump_images(batch, step)
                if step % cfg.save_model_freq == 0 and self.is_main:
                    save_checkpoint(self.model.state_dict(), self.save_path,
                                    step)
                    if eval_fn is not None:
                        eval_fn(step, state)
                if step >= tot:
                    break
            epoch += 1
        if self.is_main:
            save_checkpoint(self.model.state_dict(), self.save_path,
                            state.step)
        return state

    def _dump_images(self, batch: dict, step: int) -> None:
        """Reconstruction snapshots, ``<image_dump_dir>/<step><name>.png``
        (the reference's periodic image dumps)."""
        os.makedirs(self.image_dump_dir, exist_ok=True)
        for suffix, arr in self._render_recon(batch).items():
            arr8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(self.image_dump_dir, f"{step}{suffix}.png"),
                      arr8)

    def _render_recon(self, batch: dict) -> dict:
        """{file suffix: (H, W, C) array in [0, 1]} of the first image of
        a host batch, through an eval forward of the model."""
        raise NotImplementedError

    def _eval_forward(self, fn):
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad(), precision_scope(self.model.policy):
                return fn()
        finally:
            self.model.train(was_training)


class MaskTrainer(Trainer):
    batch_keys = ("alpha",)

    def __init__(self, cfg: TrainConfig, save_path: str, model=None,
                 device=None, image_dump_dir: str = "",
                 data_parallel: Optional[bool] = None, mesh=None):
        super().__init__(MaskCodec, cfg, _mask_loss_fn(cfg), save_path,
                         model=model, device=device,
                         snapshot_keep_after=595_000,
                         image_dump_dir=image_dump_dir,
                         data_parallel=data_parallel, mesh=mesh)

    def _render_recon(self, batch):
        m = self.device_batch({"alpha": batch["alpha"][:1]})["alpha"]
        recon = self._eval_forward(lambda: torch.clamp(
            self.model(m, training=False)["x_hat"], 0, 1))
        return {"mask": recon[0].permute(1, 2, 0).cpu().numpy()}


class RGBTrainer(Trainer):
    batch_keys = ("masked_image", "alpha")

    def __init__(self, cfg: TrainConfig, save_path: str, model=None,
                 device=None, image_dump_dir: str = "",
                 data_parallel: Optional[bool] = None, mesh=None):
        super().__init__(RGBCodec, cfg, _rgb_loss_fn(cfg), save_path,
                         model=model, device=device,
                         snapshot_keep_after=1_495_000,
                         image_dump_dir=image_dump_dir,
                         data_parallel=data_parallel, mesh=mesh)

    def _render_recon(self, batch):
        d = self.device_batch({k: batch[k][:1]
                               for k in ("masked_image", "alpha")})
        x, m = d["masked_image"], d["alpha"]
        recon = self._eval_forward(lambda: torch.clamp(self.model(
            x, m, m, mask_pyramid(m), training=False)["x_hat"], 0, 1))
        recon = recon[0].permute(1, 2, 0).cpu().numpy()
        alpha = np.asarray(batch["alpha"][0], np.float32)
        return {"image": np.concatenate([recon, alpha], axis=-1),
                "mask": alpha}

    def train(self, loader, state, tb_writer=None, eval_fn=None,
              max_steps=None):
        """Wraps the loader with the curriculum: before curriculum_step the
        full image replaces the masked input and the mask is all ones."""
        cfg = self.cfg

        class CurriculumLoader:
            def __init__(self, inner):
                self.inner = inner
                self.step = state.step

            def __iter__(self):
                for batch in self.inner:
                    self.step += 1
                    if self.step < cfg.curriculum_step:
                        batch = dict(batch)
                        batch["masked_image"] = batch["image"]
                        batch["alpha"] = np.ones_like(batch["alpha"])
                    yield batch

            def __len__(self):
                return len(self.inner)

        return super().train(CurriculumLoader(loader), state, tb_writer,
                             eval_fn, max_steps)
