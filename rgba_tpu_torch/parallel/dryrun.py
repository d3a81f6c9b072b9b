"""The multi-rank dry run: the port of the JAX package's
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` runs ONE ``RGBTrainer`` step (fp32, the full-width
codec, ``batch`` images of ``size`` x ``size``) over ``n`` ranks of a
``torch.distributed`` group, each a process of its own
(``parallel/launch.py``): gloo processes on the CPU with ``device="cpu"``,
NCCL ranks on ``n`` cards otherwise, or gloo ranks that share cards with
``backend="gloo"``.  For even n >= 4 the ranks form the JAX dry run's 2-D
mesh, ``space`` 2 by ``data`` n / 2 (``mesh.make_process_mesh``): each rank
steps on a band of rows of its data shard (``parallel/spatial.py``); for
smaller n every rank is on the data axis.  Beside them one more process
takes the same step alone on the whole batch.  The ranks' all-reduced
gradients (as the clamp finds them) must equal the single process's
within 1e-5 * mean|g| + 1e-7 per parameter (mean |dg|, the measure of
``chip_smoke.py``'s gradient checks; the largest |dg| is reported beside
it), and the loss within 1e-6 relative; anything else raises.  The
entropy bottleneck's quantiles are left out: only the aux optimizer steps
them, on a loss of the parameters alone, and the all-reduce skips them
(``train/loops.py``).

Two faults the check must see:

- ``shard_noise=True``: each rank draws the noise of its own shard only,
  from the shared seed (the rank's images then get another image's noise);
- ``zero_halo=True``: every band is padded with zero rows instead of its
  neighbours' (height sharding only).

    python -m rgba_tpu_torch.parallel.dryrun 4 --device cpu [--zero-halo]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from ..core.precision import resolve_device
from .launch import Ranks

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7    # x mean|g|, per parameter
LOSS_RTOL = 1e-6


def default_space(n_devices: int) -> int:
    """The JAX dry run's space axis: 2 for even n >= 4, else 1."""
    return 2 if n_devices >= 4 and n_devices % 2 == 0 else 1


def _zero_halos() -> None:
    """The fault: every band's halo rows are zeros."""
    from . import spatial

    def zeros(mesh, x, above, below, dim):
        s, n = mesh.space_index, mesh.space
        return (x.new_zeros(spatial._rows_shape(x, dim, above))
                if s > 0 and above else None,
                x.new_zeros(spatial._rows_shape(x, dim, below))
                if s < n - 1 and below else None)
    spatial.halo_rows = zeros


def rank_step(mesh, device: str, batch: int, size: int, kernels: bool,
              data_parallel: bool, shard_noise: bool = False,
              zero_halo: bool = False):
    """One process of the dry run (``launch.Ranks`` calls it): a step on
    this rank's part of the batch, under DDP with ``data_parallel`` (the
    single process: the whole batch alone).  Returns rank 0's loss and
    gradients, None elsewhere."""
    import torch.distributed as dist
    from ..core.config import TrainConfig
    from ..core.precision import policy_from_str
    from ..data.synthetic import synthetic_rgba_batch
    from ..models.rgb_codec import RGBCodec
    from ..ops.kernels import dse, gate_chain, gdn, win_attn
    from ..train.loops import RGBTrainer

    if zero_halo:
        _zero_halos()
    cfg = TrainConfig(train_lambda=1024, batch_size=batch, aux_lr=1e-3,
                      tot_step=1, compute_dtype="float32")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    model = None
    if kernels:
        policy = dataclasses.replace(
            policy_from_str("float32"), fused_win_attn=True, fused_gdn=True,
            fused_gate_chain=True, fused_dse=True, packed_dse=False)
        model = RGBCodec(policy=policy, device=dev,
                         generator=torch.Generator().manual_seed(cfg.seed))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = RGBTrainer(cfg, tmp, model=model, device=dev,
                             data_parallel=data_parallel, mesh=mesh)
        if shard_noise:
            # the fault the check must see: noise drawn for the shard alone
            trainer.noise_source = lambda: trainer.noise
        data = synthetic_rgba_batch(batch, size, size, seed=0)
        state = trainer.init_state()
        grads: dict = {}
        m = trainer.step(state, {k: data[k] for k in trainer.batch_keys},
                         grads=grads)
    if dist.get_rank():
        return None
    kernels = {"fused_window_attention": win_attn, "fused_gdn": gdn,
               "fused_gate_chain": gate_chain, "fused_dse": dse}
    return {"rd_loss": float(m["rd_loss"]),
            "grads": {k: v.cpu() for k, v in grads.items()},
            "launches": {k: v.KERNEL.launches for k, v in kernels.items()}}


def _compare(dp: dict, one: dict) -> dict:
    """The ranks' step against the single process's: the worst parameter's
    mean |dg| over its bound (and the largest max |dg| over the same
    bound), the loss's relative gap."""
    worst, name, worst_max = 0.0, None, 0.0
    for k, g1 in one["grads"].items():
        if k.rsplit(".", 1)[-1] == "quantiles":
            continue
        d = (dp["grads"][k] - g1).abs()
        bound = GRAD_RTOL * float(g1.abs().mean()) + GRAD_ATOL
        worst_max = max(worst_max, float(d.max()) / bound)
        if float(d.mean()) / bound > worst:
            worst, name = float(d.mean()) / bound, k
    loss_rel = abs(dp["rd_loss"] - one["rd_loss"]) / abs(one["rd_loss"])
    return {"rd_loss": dp["rd_loss"], "rd_loss_single": one["rd_loss"],
            "loss_rel": loss_rel, "grad_worst_ratio": worst,
            "grad_worst_param": name, "grad_worst_max_ratio": worst_max,
            "params": len(one["grads"])}


def dryrun_multichip(n_devices: int, device=None, batch: int = 8,
                     size: int = 64, shard_noise: bool = False,
                     zero_halo: bool = False, space: int = None,
                     backend: str = None, kernels: bool = False,
                     timeout: float = 600.0) -> dict:
    """One ``RGBTrainer`` step over ``n_devices`` ranks (``space`` bands by
    n / space data shards; ``default_space`` when None) against the same
    step in one process (see the module docstring).  ``kernels``: the
    model routes through the four CUDA kernels.  Returns the comparison;
    raises AssertionError when the step differs."""
    dev = resolve_device(device)
    space = default_space(n_devices) if space is None else space
    if dev.type == "cuda" and backend in (None, "nccl") \
            and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) over NCCL needs "
                           f"{n_devices} cards, the machine has "
                           f"{torch.cuda.device_count()}")
    if n_devices % space or batch % (n_devices // space):
        raise ValueError(f"batch {batch} and {n_devices} ranks do not form "
                         f"a mesh of {space} bands")
    if zero_halo and space == 1:
        raise ValueError("zero_halo needs a space axis of 2 or more")
    common = (dev.type, batch, size, kernels)
    fn = "rgba_tpu_torch.parallel.dryrun:rank_step"
    with Ranks(fn, n_devices, space=space, device=dev.type, backend=backend,
               args=(*common, True, shard_noise, zero_halo)) as ranks, \
            Ranks(fn, 1, device=dev.type, backend=backend,
                  args=(*common, False)) as single:
        dp = ranks.join(timeout)[0]
        one = single.join(timeout)[0]
    res = _compare(dp, one)
    res.update(n_devices=n_devices, space=space, device=str(dev),
               batch=batch, size=size, launches=dp["launches"])
    if res["grad_worst_ratio"] > 1.0 or res["loss_rel"] > LOSS_RTOL:
        raise AssertionError(
            f"dryrun_multichip({n_devices}): the {space} x "
            f"{n_devices // space} step differs from the single process's: "
            f"loss rel {res['loss_rel']:.3g}, {res['grad_worst_param']} "
            f"mean |dg| at {res['grad_worst_ratio']:.3g} x its bound")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--space", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--shard-noise", action="store_true")
    ap.add_argument("--zero-halo", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n_devices, args.device, args.batch,
                           args.size, args.shard_noise, args.zero_halo,
                           args.space, args.backend, args.kernels))


if __name__ == "__main__":
    main()
