"""Data parallelism of the PyTorch port on the CPU (``parallel/``,
``train/loops.py``): the mesh and its shards, the process group over gloo
in two processes (launched as ``tests/test_distributed.py`` launches its
workers: a free port, a timeout per process, killed on a hang, two threads
each), and ``dryrun_multichip(2)``: one ``RGBTrainer`` step over two ranks
against the same step in one process.

Tolerances: the all-reduced gradients within 1e-5 * mean|g| + 1e-7 per
parameter (mean |dg|), the loss within 1e-6 relative
(``parallel/dryrun.py``).  A rank that draws the noise of its shard alone
must fail that check.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core.config import TrainConfig  # noqa: E402
from rgba_tpu_torch.parallel import distributed as tdist  # noqa: E402
from rgba_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from rgba_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,  # noqa: E402
                                          replicated_sharding, shard_batch)
from rgba_tpu_torch.train.loops import RGBTrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import torch
import torch.distributed as dist
from rgba_tpu_torch.parallel.distributed import (global_mesh, initialize,
                                                 local_batch_slice,
                                                 process_count, process_index)

pid = int(sys.argv[1])
initialize(coordinator_address="localhost:%(port)d", num_processes=2,
           process_id=pid, device="cpu")
initialize(coordinator_address="localhost:1", num_processes=2,
           process_id=pid, device="cpu")          # idempotent
assert process_count() == 2 and process_index() == pid
assert dist.get_backend() == "gloo"
mesh = global_mesh()
assert mesh.size == 2 and all(d.type == "cpu" for d in mesh.devices), mesh
t = torch.full((4, 2), float(pid + 1))     # this process's shard
dist.all_reduce(t)
assert bool((t == 3.0).all()), t
total = torch.tensor(float(t.sum()))
assert float(total) == 4 * 2 * 3, float(total)
assert local_batch_slice(8) == slice(4 * pid, 4 * pid + 4)
print("WORKER_OK", pid, float(total), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_shard_batch_and_local_slice():
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis_names == ("data",)
    batch = {"alpha": np.arange(8 * 3).reshape(8, 3)}
    out = shard_batch(mesh, batch)["alpha"]
    assert [t.tolist() for t in out] == [batch["alpha"][:4].tolist(),
                                         batch["alpha"][4:].tolist()]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, {"alpha": np.zeros((3, 1))})
    # a replicated sharding puts the whole batch on every device
    assert [t.shape[0] for t in replicated_sharding(mesh).put(np.zeros((3, 2)))] \
        == [3, 3]
    assert batch_sharding(mesh).slices(6) == [slice(0, 3), slice(3, 6)]
    assert make_mesh(1, devices=["cpu", "cpu"]).size == 1
    # no group: one process holds the whole batch
    assert tdist.process_count() == 1
    assert tdist.local_batch_slice(8) == slice(0, 8)
    tdist.initialize()                      # no arguments, no torchrun: no-op
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tdist.initialize(num_processes=2)   # never quietly one process


def test_trainer_num_devices_rule(tmp_path):
    """num_devices must be 0 or the group's size (the JAX trainer's gcd
    rule has no counterpart), and the group's size must divide the batch."""
    cfg = TrainConfig(batch_size=8, num_devices=2, compute_dtype="float32")
    with pytest.raises(ValueError, match="gcd"):
        RGBTrainer(cfg, str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        RGBTrainer(TrainConfig(batch_size=8), str(tmp_path), device="cpu",
                   data_parallel=True)
    cfg = TrainConfig(compute_dtype="serve-int8")
    with pytest.raises(ValueError, match="serving policy"):
        RGBTrainer(cfg, str(tmp_path), device="cpu")


def test_two_process_all_reduce(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % {"port": _free_port()})
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i} 24.0" in out, out


def test_dryrun_multichip_two_ranks_equal_one_process():
    res = dryrun_multichip(2, device="cpu", timeout=300)
    assert res["n_devices"] == 2 and res["params"] > 400
    assert res["grad_worst_ratio"] <= 1.0 and res["loss_rel"] <= 1e-6
    assert np.isfinite(res["rd_loss"])


def test_dryrun_shard_only_noise_fails_the_check():
    with pytest.raises(AssertionError, match="differs"):
        dryrun_multichip(2, device="cpu", shard_noise=True, timeout=300)
