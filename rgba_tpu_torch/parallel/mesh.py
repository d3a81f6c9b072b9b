"""A data mesh and batch sharding (port of ``rgba_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` over one ``data`` axis,
and a batch sharded on it is one global array whose shards XLA places.
PyTorch has no global array: here a mesh is the list of devices on the
``data`` axis, and a sharded batch is one tensor per device, the batch cut
into equal contiguous shards in mesh order.  ``CodecIO(sharding=)`` serves
a batch that way within one process (a model replica on each device);
training across processes uses ``torch.distributed`` instead
(``parallel/distributed.py``), one process per card.

A mesh may name one device more than once: two replicas on one card run
the sharded path where a single card is all there is.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices on the ``data`` axis, in order."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a placement: ``spec`` ("data",) cuts the leading (batch)
    axis over the mesh; () puts a whole copy on every device."""
    mesh: Mesh
    spec: Tuple[str, ...] = ("data",)

    @property
    def batch_sharded(self) -> bool:
        return self.spec == ("data",)

    def slices(self, batch: int) -> list:
        """The mesh's shards of a batch of ``batch``: equal contiguous
        slices, in mesh order.  A batch the axis does not divide raises,
        as the JAX package's ``device_put`` does."""
        n = self.mesh.size
        if not self.batch_sharded:
            return [slice(0, batch)] * n
        if batch % n:
            raise ValueError(f"a batch of {batch} does not divide the data "
                             f"axis of {n} devices")
        per = batch // n
        return [slice(i * per, (i + 1) * per) for i in range(n)]

    def put(self, x) -> list:
        """``x`` (a tensor or an array, batch first) as one tensor per mesh
        device: its shard, or with a replicated spec a whole copy."""
        t = torch.as_tensor(x)
        return [t[s].to(d) for s, d in zip(self.slices(t.shape[0]),
                                          self.mesh.devices)]


def make_mesh(num_devices: int = 0, devices: Sequence = None) -> Mesh:
    """The first ``num_devices`` (all if 0) of ``devices``, or of the
    process's CUDA devices.  Never a CPU mesh unless ``devices`` names the
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices=['cpu', ...] for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = num_devices if num_devices > 0 else len(devs)
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devs)} given")
    return Mesh(tuple(devs[:n]))


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """A host batch dict cut along the data axis: {key: [one tensor per
    mesh device]}.  Raises when the batch does not divide the axis."""
    sh = batch_sharding(mesh)
    return {k: sh.put(v) for k, v in batch.items()}
