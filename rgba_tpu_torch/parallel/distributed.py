"""The process group of a data-parallel job (port of
``rgba_tpu/parallel/distributed.py``).

The JAX package initializes ``jax.distributed`` and builds one global mesh
whose gradient all-reduce XLA inserts.  Here each process drives one
device, the processes form a ``torch.distributed`` group (NCCL between
cards, gloo on the CPU), and ``DistributedDataParallel`` all-reduces the
gradients (``train/loops.py``).  Usage, one process per card, for example
under ``torchrun --nproc_per_node=N``:

    from rgba_tpu_torch.parallel.distributed import initialize
    initialize()              # reads RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT

A single process (no torchrun environment, no arguments) makes no group:
``initialize`` is then a no-op.  It is idempotent.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.precision import resolve_device
from .mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` for this process: rank
    ``process_id`` of ``num_processes``, the group's store at
    ``coordinator_address`` ("host:port"), or with no arguments torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.  NCCL on
    ``cuda`` (the default; the process takes card ``LOCAL_RANK``, or its
    rank modulo the cards), gloo when ``device="cpu"``.  A no-op when a
    group exists, or when there are neither arguments nor a torchrun
    environment; anything else that is missing raises."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if "WORLD_SIZE" not in env:
            return
        try:
            num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        except KeyError as e:
            raise RuntimeError(f"initialize: WORLD_SIZE is set but {e} is "
                               f"not") from None
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    if dist.get_world_size() != int(num_processes):
        raise RuntimeError(f"initialize: a group of {dist.get_world_size()} "
                           f"processes, {num_processes} asked")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh() -> Mesh:
    """The data mesh over the job: the device each rank drives (its card
    under NCCL, the CPU under gloo), in rank order; without a group, the
    current card."""
    if not dist.is_initialized():
        resolve_device(None)
        return make_mesh(devices=[torch.device("cuda",
                                               torch.cuda.current_device())])
    dev = "cpu" if dist.get_backend() != "nccl" else \
        f"cuda:{torch.cuda.current_device()}"
    devs = [None] * dist.get_world_size()
    dist.all_gather_object(devs, dev)
    return make_mesh(devices=devs)


def data_axis(mesh=None) -> tuple:
    """(size, index) of the axis that cuts the batch: a ``ProcessMesh``'s
    ``data`` axis, or without one every process of the group."""
    if mesh is not None:
        return mesh.data, mesh.data_index
    return process_count(), process_index()


def local_batch_slice(global_batch: int, mesh=None) -> slice:
    """The slice of a global batch this process steps on:
    slice(per * i, per * (i + 1)), per = global_batch / n, for the data
    axis's size n and index i (``data_axis``).  A batch the axis does not
    divide raises."""
    n, i = data_axis(mesh)
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"over {n} processes")
    per = global_batch // n
    return slice(per * i, per * (i + 1))
