"""The cluster-topology layer: a mesh is a ``torch.distributed`` group.

The PyTorch port of ``mmlspark_tpu.parallel.mesh``. The JAX package shards
rows over a device mesh inside one process, and across processes each
process holds its own rows. PyTorch's idiom is one process per GPU, so in
the port a mesh shard is a rank: the :class:`Mesh` record holds a process
group (NCCL on the card, gloo on the CPU), this process's rank in it, its
world size, the rank's device and the ``data`` axis name. Without an
initialised default group the mesh has one rank: this process.

``MODEL_AXIS`` is kept as a name only: nothing on the port's path shards
over it, so a mesh shape may give it size 1 and no more.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """One 1-D ``data`` mesh: ``group`` (None = the default group, or no
    group at all when ``torch.distributed`` is not initialised), this
    process's ``rank`` in it, the ``size`` of the group and the rank's
    ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: ``spec`` names the mesh axis each
    tensor axis is split over (None = whole on every rank); ``()`` is
    replicated. The port's stand-in for ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: tuple


_default_mesh: Optional[Mesh] = None


def _rank_device() -> torch.device:
    """The card this process drives (``cuda:<current device>``); raises
    without a card, as every entry point of the port does."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to make_mesh"
        )
    return torch.device("cuda", torch.cuda.current_device())


def group_rank_size(group: Any = None) -> tuple:
    """(rank, world size) of this process in ``group`` (None = the default
    group); (0, 1) when ``torch.distributed`` is not initialised."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def make_mesh(shape: Optional[dict] = None, group: Any = None,
              device: "str | torch.device | None" = None) -> Mesh:
    """Build the mesh of ``group`` (None = the default group). ``shape``
    maps axis name -> size as in the JAX package: ``data`` may be -1
    (inferred) or the world size, ``model`` only 1. ``device``: the rank's
    device, default its card."""
    rank, size = group_rank_size(group)
    if shape:
        unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        if shape.get(MODEL_AXIS, 1) != 1:
            raise ValueError("the port shards over the data axis only: model axis size must be 1")
        want = shape.get(DATA_AXIS, -1)
        if want not in (-1, size):
            raise ValueError(f"mesh shape {shape} != {size} ranks")
    dev = _rank_device() if device is None else torch.device(device)
    return Mesh(group=group, rank=rank, size=size, device=dev)


def get_mesh() -> Mesh:
    """The process-wide default mesh (created on first use, on the card)."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def device_count() -> int:
    """Devices of the default group: one per rank."""
    return group_rank_size()[1]


def local_device_count() -> int:
    """Devices this process drives: one (a rank is one device)."""
    return 1


def cluster_summary(mesh: Optional[Mesh] = None) -> dict:
    """Topology report (the ``ClusterUtil.getExecutors`` analogue). With
    more than one rank the host names are all-gathered (a collective:
    every rank must call it)."""
    mesh = mesh or get_mesh()
    here = (socket.gethostname(), mesh.device.index or 0)
    if mesh.size > 1:
        seen: list = [None] * mesh.size
        dist.all_gather_object(seen, here, group=mesh.group)
    else:
        seen = [here]
    return {
        "platform": mesh.device.type,
        "num_devices": mesh.size,
        "num_hosts": len({h for h, _ in seen}),
        "host_devices": {str(r): [i] for r, (_, i) in enumerate(seen)},
        "process_index": mesh.rank,
    }


def data_sharding(mesh: Mesh, ndim: int, axis: str = DATA_AXIS) -> Sharding:
    """Axis 0 (batch) split over ``axis``, the rest whole."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
