"""Device mesh and sharding helpers (counterpart of
``terrain_diffusion_tpu.parallel.mesh``).

The port keeps JAX's two kinds of parallelism over one 1-D ``"data"`` axis:

- **serving**: tile parallelism in one process.  A ``Mesh`` is an ordered
  tuple of ``torch.device`` slots; ``WorldPipeline(mesh=)`` splits each
  stage's padded tile batch over the slots, runs each chunk on its slot's
  replica of the model and gathers the results in order.  The tiles are
  independent, so there is no collective, as in JAX.  A device may fill
  several slots (JAX's forced host device count): two slots on ``cuda:0``
  or eight on ``cpu`` test the split-and-gather logic on one device.
- **training**: data parallelism, one process per card over
  ``torch.distributed`` (``parallel/distributed.py``).  In a process group
  the mesh has one slot per rank, and ``shard_batch`` gives this process
  its rows of the global batch.

JAX's ``batch_pspec`` (a ``PartitionSpec``) has no counterpart: the port
names the split axis by ``Mesh.axis`` and no caller needs more.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """An ordered tuple of device slots over one named axis.  ``group`` is
    True for the mesh of a process group, where this process holds slot
    ``rank``; otherwise this process holds every slot."""

    def __init__(self, devices, axis: str = "data", group: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.group = group

    @classmethod
    def from_devices(cls, devices, axis: str = "data") -> "Mesh":
        """A one-process mesh over ``devices`` (repeats allowed), e.g.
        ``Mesh.from_devices(["cpu"] * 8)``."""
        return cls(devices, axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.group else 0

    def distinct(self) -> list:
        """The mesh's devices, each once, in slot order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        kind = "process group" if self.group else "one process"
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r}, {kind})"


def _rank_device(rank: int) -> torch.device:
    """A rank's device in a process group: its own card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """In a process group, one slot per rank (``n_devices``, if given, must
    be the world size).  Otherwise the visible CUDA devices, or the first
    ``n_devices`` of them; a CPU mesh is made only when asked for
    (``Mesh.from_devices``)."""
    if in_process_group():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"a process-group mesh has one slot per rank ({world}), "
                             f"not {n_devices}")
        return Mesh([_rank_device(r) for r in range(world)], axis, group=True)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is visible: make a CPU mesh with "
                           "Mesh.from_devices(['cpu'] * n)")
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"{n} devices asked for, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


class Rows(NamedTuple):
    """Rows [start, stop) of a global batch of ``total``: this process's
    shard, or all of it where the batch is replicated."""
    total: int
    start: int
    stop: int

    @property
    def sharded(self) -> bool:
        return self.stop - self.start < self.total

    def take(self, t):
        """t's rows, for a tensor drawn at the global batch's leading size."""
        return t[self.start:self.stop]


def local_rows(mesh: Mesh | None, n: int) -> Rows:
    """This process's rows of a leading size ``n``: its equal share in a
    process group whose size divides ``n``, else all ``n`` (replicated, as
    JAX replicates a leaf the mesh size does not divide)."""
    if mesh is None or not mesh.group or n % mesh.size:
        return Rows(n, 0, n)
    per = n // mesh.size
    return Rows(n, mesh.rank * per, (mesh.rank + 1) * per)


def take_rows(tree, rows: Rows):
    """Every array leaf of ``tree`` (drawn at the global batch's leading
    size) cut to ``rows``; other leaves as they are."""
    return _map(lambda x: x if _leading(x) is None else rows.take(x), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leading(x) -> int | None:
    shape = np.shape(x) if isinstance(x, (np.ndarray, torch.Tensor)) else ()
    return shape[0] if len(shape) >= 1 else None


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x).to(device)
    return x


def shard_batch(mesh: Mesh, batch):
    """Split every array leaf of ``batch`` along its leading (batch) axis;
    a leaf whose leading size the slot count does not divide is replicated.

    In a process group: this rank's rows, leaves kept as they are (numpy
    stays numpy).  In one process: a list with one shard per slot, each
    leaf a tensor on its slot's device."""
    n = mesh.size
    if mesh.group:
        return _map(lambda x: x if _leading(x) is None
                    else local_rows(mesh, _leading(x)).take(x), batch)
    shards = []
    for i, dev in enumerate(mesh.devices):
        def put(x, i=i, dev=dev):
            lead = _leading(x)
            if lead is None or lead % n:
                return _to(x, dev)
            per = lead // n
            return _to(x[i * per:(i + 1) * per], dev)

        shards.append(_map(put, batch))
    return shards


def replicate(mesh: Mesh, obj):
    """One copy of a module (or a tree of tensors) per slot, made once per
    distinct device: slots on the same device share one copy, and a device
    the object already lies on takes the object itself.  In a process
    group: the object on this rank's device."""
    def on(dev):
        if isinstance(obj, nn.Module):
            current = next(iter(obj.parameters()), None)
            if current is None or current.device == dev:
                return obj
            return copy.deepcopy(obj).to(dev)
        return _map(lambda x: _to(x, dev), obj)

    if mesh.group:
        return on(mesh.devices[mesh.rank])
    copies = {dev: on(dev) for dev in mesh.distinct()}
    return [copies[dev] for dev in mesh.devices]

