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

``ProcessMesh`` is the JAX dry run's 2-D (``space``, ``data``) mesh over the
processes of a ``torch.distributed`` group: rank r sits at space index
r // D and data index r % D (D = world / S), as ``devs.reshape(2, n // 2)``
places devices there.  The ``space`` axis cuts image height into bands
(``parallel/spatial.py``), the ``data`` axis the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.distributed as dist


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


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place on a (``space``, ``data``) mesh of processes and
    the groups of its two axes."""
    space: int                  # S: bands of the image
    data: int                   # D: shards of the batch
    space_index: int
    data_index: int
    space_group: object         # the ranks of this data index, band order
    data_group: object          # the ranks of this space index
    space_ranks: Tuple[int, ...]
    data_ranks: Tuple[int, ...]
    space_backend: str

    def data_slice(self, batch: int) -> slice:
        """This rank's shard of a global batch of ``batch``."""
        if batch % self.data:
            raise ValueError(f"a batch of {batch} does not divide the data "
                             f"axis of {self.data}")
        per = batch // self.data
        return slice(per * self.data_index, per * (self.data_index + 1))

    def band_slice(self, height: int) -> slice:
        """This rank's band of an image of ``height`` rows."""
        if height % self.space:
            raise ValueError(f"a height of {height} does not divide into "
                             f"{self.space} bands")
        per = height // self.space
        return slice(per * self.space_index, per * (self.space_index + 1))


def make_process_mesh(space: int = 1) -> ProcessMesh:
    """The (``space``, ``data``) mesh over the process group: S = ``space``
    bands, D = world / S.  Every rank of the group calls it (the axes'
    groups are made collectively, in one order)."""
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs a process group "
                           "(parallel.distributed.initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if space < 1 or world % space:
        raise ValueError(f"a space axis of {space} does not divide "
                         f"{world} processes")
    data = world // space
    columns = [tuple(s * data + d for s in range(space)) for d in range(data)]
    rows = [tuple(s * data + d for d in range(data)) for s in range(space)]
    space_groups = [dist.new_group(list(r)) for r in columns]
    data_groups = [dist.new_group(list(r)) for r in rows]
    s, d = divmod(rank, data)
    return ProcessMesh(space, data, s, d, space_groups[d], data_groups[s],
                       columns[d], rows[s],
                       dist.get_backend(space_groups[d]))
