"""Data-parallel dry run: the data-parallel half of the JAX package's
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` runs ONE ``RGBTrainer`` step (fp32, the full-width
codec, ``batch`` images of ``size`` x ``size``) over ``n`` ranks of a
``torch.distributed`` group, each a process of its own: gloo processes on
the CPU with ``device="cpu"``, NCCL ranks on ``n`` cards otherwise.  Beside
them one more process takes the same step alone on the whole batch.  The
ranks' all-reduced gradients (as the clamp finds them) must equal the
single process's within 1e-5 * mean|g| + 1e-7 per parameter (mean |dg|,
the measure of ``chip_smoke.py``'s gradient checks; the largest |dg| is
reported beside it), and the mean loss within 1e-6 relative; anything
else raises.  The entropy bottleneck's quantiles are left out: only the
aux optimizer steps them, on a loss of the parameters alone, and the
all-reduce skips them (``train/loops.py``).

``shard_noise=True`` makes each rank draw the noise of its own shard only,
from the shared seed (the rank's images then get another image's noise):
the check must fail, which shows that it can see the noise go astray.

The JAX dry run's 2-D (``space``, ``data``) mesh, which shards image height
as well, is not here: height sharding is the next slice of the port.

    python -m rgba_tpu_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..core.precision import resolve_device

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7    # x mean|g|, per parameter
LOSS_RTOL = 1e-6
_ROOT = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _step(world: int, rank: int, port: int, device: str, batch: int,
          size: int, shard_noise: bool, out: str) -> None:
    """One process of the dry run: rank ``rank`` of ``world`` (world 0:
    the single process on the whole batch).  Rank 0 and the single process
    save the loss and the gradients to ``out``."""
    from ..core.config import TrainConfig
    from ..data.synthetic import synthetic_rgba_batch
    from ..train.loops import RGBTrainer
    from .distributed import initialize

    if world:
        initialize(f"localhost:{port}", world, rank, device=device)
    cfg = TrainConfig(train_lambda=1024, batch_size=batch, aux_lr=1e-3,
                      tot_step=1, compute_dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = RGBTrainer(cfg, tmp, device=device,
                             data_parallel=bool(world))
        if shard_noise:
            # the fault the check must see: noise drawn for the shard alone
            trainer.noise_source = lambda: trainer.noise
        data = synthetic_rgba_batch(batch, size, size, seed=0)
        state = trainer.init_state()
        grads: dict = {}
        m = trainer.step(state, {k: data[k] for k in trainer.batch_keys},
                         grads=grads)
        if rank == 0:
            torch.save({"rd_loss": float(m["rd_loss"]),
                        "grads": {k: v.cpu() for k, v in grads.items()}}, out)
    if world:
        torch.distributed.destroy_process_group()


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
                     timeout: float = 600.0) -> dict:
    """One data-parallel ``RGBTrainer`` step over ``n_devices`` ranks
    against the same step in one process (see the module docstring).
    Returns the comparison; raises AssertionError when the step differs."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                           f"{n_devices} cards, the machine has "
                           f"{torch.cuda.device_count()}")
    if batch % n_devices:
        raise ValueError(f"batch {batch} does not divide over {n_devices}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "2")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = {w: os.path.join(tmp, f"world{w}.pt") for w in (n_devices, 0)}
        procs = []
        try:
            for world, ranks in ((n_devices, range(n_devices)), (0, [0])):
                for rank in ranks:
                    cmd = [sys.executable, "-m", "rgba_tpu_torch.parallel.dryrun",
                           "--world", str(world), "--rank", str(rank),
                           "--port", str(port), "--device", dev.type,
                           "--batch", str(batch), "--size", str(size),
                           "--out", outs[world]]
                    if shard_noise and world:
                        cmd.append("--shard-noise")
                    procs.append(subprocess.Popen(
                        cmd, env=env, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            # a rank that hung (its peer died during set-up) must not
            # outlive the run
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"dry-run process failed "
                                   f"({p.returncode}):\n{log[-4000:]}")
        dp, one = (torch.load(outs[w]) for w in (n_devices, 0))
    res = _compare(dp, one)
    res.update(n_devices=n_devices, device=str(dev), batch=batch, size=size)
    if res["grad_worst_ratio"] > 1.0 or res["loss_rel"] > LOSS_RTOL:
        raise AssertionError(
            f"dryrun_multichip({n_devices}): the data-parallel step differs "
            f"from the single process's: loss rel {res['loss_rel']:.3g}, "
            f"{res['grad_worst_param']} mean |dg| at "
            f"{res['grad_worst_ratio']:.3g} x its bound")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--shard-noise", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.world is not None:
        _step(args.world, args.rank, args.port, args.device, args.batch,
              args.size, args.shard_noise, args.out)
        return
    print(dryrun_multichip(args.n_devices or 2, args.device, args.batch,
                           args.size, args.shard_noise))


if __name__ == "__main__":
    main()
