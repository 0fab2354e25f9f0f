"""Device meshes: the substrate of the distributed solve.

Counterpart of the JAX package's ``parallel/mesh.py``.  A :class:`Mesh`
is a 1-D row of shards (axis ``"rows"``) with the comm that moves data
between them (``parallel.comm``):

* a mesh whose devices repeat ONE device - ``devices=["cuda:0"] * 4``, or
  ``[torch.device("cpu")] * 4`` in the tests - holds its P shards in
  this process, stacked (``StackedComm``): P shards on one card, or on
  the host;
* with ``torch.distributed`` initialized and no device list, the mesh is
  the process group, one rank per device (``ProcessGroupComm``).

``devices=None`` otherwise means every CUDA device, and without a card
it raises (the device rule).  Several distinct devices in one process
are a multi-card mesh, which is not built in the port yet (ROADMAP A10
residue: the multi-card peer-table lane).  The two-axis pencil mesh
``make_mesh_2d`` is not ported yet either.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from .comm import ProcessGroupComm, StackedComm

ROWS_AXIS = "rows"
COLS_AXIS = "cols"


class Mesh:
    """A 1-D mesh: ``devices`` (a numpy object array of
    ``torch.device``, one per shard, as ``jax.sharding.Mesh.devices``),
    ``axis_names`` and the ``comm`` its collectives run on.  ``device``
    is the device this process's shards live on."""

    def __init__(self, devices, axis_names, comm) -> None:
        self.devices = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i] = d
        self.axis_names = tuple(axis_names)
        self.comm = comm

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.comm.kind}, {self.size} x {self.device}, "
                f"axis_names={self.axis_names})")


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = ROWS_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 1-D mesh over the first ``n_devices`` of ``devices``.

    ``devices=None``: the ``torch.distributed`` process group when one is
    initialized (one rank per device; ``n_devices`` must then be None or
    the world size), else every CUDA device (raising without a card).
    A list that repeats one device gives a stacked mesh of that many
    shards in this process."""
    import torch.distributed as dist

    if devices is None and dist.is_available() and dist.is_initialized():
        comm = ProcessGroupComm()
        if n_devices not in (None, comm.n_shards):
            raise ValueError(
                f"requested {n_devices} devices, the process group has "
                f"{comm.n_shards} ranks")
        ranks = [comm.device] * comm.n_shards
        return Mesh(ranks, (axis_name,), comm)
    if devices is None:
        resolve_device(None)          # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} available")
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got "
                         f"{n_devices}")
    devices = devices[:n_devices]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"a mesh over several devices in one process ({devices}) is "
            f"the multi-card lane, not ported yet (ROADMAP A10 residue); "
            f"repeat one device for a stacked mesh, or run one process "
            f"per device under torch.distributed")
    return Mesh(devices, (axis_name,), StackedComm(n_devices, devices[0]))


def make_mesh_2d(
    shape: Sequence[int],
    axis_names: Sequence[str] = (ROWS_AXIS, COLS_AXIS),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Not ported yet: the pencil decomposition's 2-D mesh."""
    raise NotImplementedError(
        "make_mesh_2d (the pencil decomposition) is not ported yet "
        "(ROADMAP A10 residue: pencil meshes)")


class RowSharding:
    """What ``row_sharding`` names: a vector's leading axis split over
    ``mesh``'s ``axis_name`` (the ``NamedSharding(mesh, P(axis))``
    counterpart)."""

    def __init__(self, mesh: Mesh, axis_name: str = ROWS_AXIS) -> None:
        if axis_name not in mesh.axis_names:
            raise ValueError(f"axis {axis_name!r} is not an axis of the "
                             f"mesh {mesh.axis_names}")
        self.mesh = mesh
        self.axis_name = axis_name


def row_sharding(mesh: Mesh, axis_name: str = ROWS_AXIS) -> RowSharding:
    """Sharding that splits a vector's leading dim across the mesh."""
    return RowSharding(mesh, axis_name)


def shard_vector(x, mesh: Mesh, axis_name: str = ROWS_AXIS) -> torch.Tensor:
    """Place a global vector row-partitioned onto the mesh: on the
    mesh's device, and this process's part of it (all of it on a
    stacked mesh, the rank's block on a process group).  Its leading
    extent must divide over the shards."""
    row_sharding(mesh, axis_name)
    if isinstance(x, torch.Tensor):
        x = x.to(mesh.device)
    else:
        x = torch.as_tensor(np.asarray(x), device=mesh.device)
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading extent {x.shape[0]} does not divide "
                         f"over {mesh.size} shards")
    return mesh.comm.local_vector(x)
