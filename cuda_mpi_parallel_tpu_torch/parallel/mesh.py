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
residue: the multi-card peer-table lane).

``make_mesh_2d`` builds the pencil decomposition's ``sx x sy`` mesh on
the same two backends: ``devices`` is then an ``(sx, sy)`` array, shard
(or rank) ``i * sy + j`` at ``(i, j)``, and each axis name resolves to
an ``AxisComm`` view (``parallel.comm``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from .comm import AxisComm, ProcessGroupComm, StackedComm

ROWS_AXIS = "rows"
COLS_AXIS = "cols"


class Mesh:
    """A mesh: ``devices`` (a numpy object array of ``torch.device``, one
    per shard, as ``jax.sharding.Mesh.devices``: shape ``(P,)``, or
    ``(sx, sy)`` for a 2-D mesh), ``axis_names`` and the ``comm`` its
    collectives run on.  ``device`` is the device this process's shards
    live on."""

    def __init__(self, devices, axis_names, comm) -> None:
        shape = np.shape(devices) if isinstance(devices, np.ndarray) \
            else (len(devices),)
        self.devices = np.empty(shape, dtype=object)
        for i, d in enumerate(np.ravel(np.asarray(devices, dtype=object))):
            self.devices.flat[i] = d
        self.axis_names = tuple(axis_names)
        self.comm = comm

    @functools.cached_property
    def axis_comms(self) -> dict:
        """Each axis name's comm: the mesh comm on a 1-D mesh, an
        ``AxisComm`` view of it along each axis of a 2-D mesh."""
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: self.comm}
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a mesh with axes {self.axis_names} needs a device array "
                f"of {len(self.axis_names)} dimensions, got shape "
                f"{self.devices.shape}")
        return {name: AxisComm(self.comm, self.devices.shape, i)
                for i, name in enumerate(self.axis_names)}

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        shape = " x ".join(str(n) for n in self.devices.shape)
        return (f"Mesh({self.comm.kind}, {shape} x {self.device}, "
                f"axis_names={self.axis_names})")


def _stacked_comm(devices) -> StackedComm:
    """The comm of a mesh whose devices repeat one device; several
    distinct devices in one process are the multi-card lane."""
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"a mesh over several devices in one process ({devices}) is "
            f"the multi-card lane, not ported yet (ROADMAP A10 residue); "
            f"repeat one device for a stacked mesh, or run one process "
            f"per device under torch.distributed")
    return StackedComm(len(devices), devices[0])


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
    return Mesh(devices, (axis_name,), _stacked_comm(devices))


def make_mesh_2d(
    shape: Sequence[int],
    axis_names: Sequence[str] = (ROWS_AXIS, COLS_AXIS),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2-D mesh (pencil decomposition: two partitioned grid axes).

    ``shape = (sx, sy)`` needs ``sx * sy`` devices, laid out as
    ``devices[:sx * sy]`` reshaped to ``(sx, sy)``.  ``devices=None``: the
    ``torch.distributed`` process group when one is initialized (its
    world size must be ``sx * sy``; rank ``r`` sits at ``(r // sy, r %
    sy)``), else every CUDA device (raising without a card).  A list
    that repeats one device gives a stacked mesh of ``sx * sy`` shards in
    this process."""
    shape = tuple(shape)
    if len(shape) != 2:
        raise ValueError(f"a 2-D mesh needs shape (sx, sy), got {shape}")
    sx, sy = (int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
        raise ValueError(f"a 2-D mesh needs two distinct axis names, got "
                         f"{axis_names}")
    if sx < 1 or sy < 1:
        raise ValueError(f"a mesh needs at least one device, got {sx}x{sy}")
    flat = make_mesh(devices=devices)
    group = flat.comm.kind == "distributed"
    if group and sx * sy != flat.size:
        raise ValueError(f"requested {sx}x{sy} devices, the process group "
                         f"has {flat.size} ranks")
    if sx * sy > flat.size:
        raise ValueError(
            f"requested {sx}x{sy} devices, only {flat.size} available")
    comm = flat.comm if group else StackedComm(sx * sy, flat.device)
    return Mesh(flat.devices[:sx * sy].reshape(sx, sy), axis_names, comm)


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
