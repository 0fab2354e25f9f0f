"""Multi-process execution: one process per device over
``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``.  The JAX
package runs one controller per host under ``jax.distributed``; the
port runs one process per device under ``torch.distributed``, NCCL
between cards and gloo on the CPU.  Nothing in the solver changes -
``solve_distributed``'s per-shard body is the same; only mesh
construction and array ingestion are process-aware:

* ``initialize()`` wraps ``torch.distributed.init_process_group``.
* ``global_mesh()`` builds the 1-D mesh over the process group, one rank
  per device.
* ``shard_vector_global()`` takes each process's contiguous slice of a
  vector to the rows its shard owns, without any host holding the whole
  vector.

Single-process behaviour is unchanged: each helper degrades to its
single-process equivalent, so the same script runs on one card or on
many.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from .mesh import ROWS_AXIS, Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the process group (a no-op if this process already has).

    ``coordinator_address`` is the ``host:port`` of the rank-0 process
    (or a ``torch.distributed`` init URL, ``"file://..."``),
    ``num_processes`` the world size and ``process_id`` this process's
    rank; without a coordinator the launcher's environment
    (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, as
    ``torchrun`` sets them) is read.  ``device``: ``None`` joins over
    NCCL and binds the process to card ``process_id % device_count``
    (the card is the default); ``"cpu"`` joins over gloo.

    Degradations, as in the JAX package: a second call is a no-op, and
    with no coordinator to find and ``num_processes in (None, 1)`` the
    call is a no-op too, so the same script runs unchanged on one
    process.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                        "WORLD_SIZE", "RANK"))
    if coordinator_address is None and not env:
        if num_processes in (None, 1):
            return        # one process, nothing to rendezvous with
        raise ValueError(
            f"initialize: num_processes={num_processes} needs a "
            f"coordinator_address (or MASTER_ADDR/MASTER_PORT/WORLD_SIZE/"
            f"RANK in the environment)")
    dev = resolve_device(device)
    if coordinator_address is None:
        num_processes = int(os.environ["WORLD_SIZE"]) \
            if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) \
            if process_id is None else process_id
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "initialize: a coordinator_address needs num_processes "
                "and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id)


def process_info() -> tuple:
    """(process_index, process_count) of this process: its rank and the
    world size, ``(0, 1)`` outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis_name: str = ROWS_AXIS) -> Mesh:
    """1-D mesh over every rank of the process group (every CUDA device
    of this process outside one)."""
    from .mesh import make_mesh

    return make_mesh(axis_name=axis_name)


def shard_vector_global(
    local_data,
    global_length: int,
    mesh: Mesh,
    axis_name: str = ROWS_AXIS,
) -> torch.Tensor:
    """This process's part of a row-sharded global vector, from its
    slice.

    Each process passes the contiguous slice of the global vector its
    shards own (``global_length / process_count`` rows, in rank order)
    and gets the rows of its shards on the mesh's device, in the layout
    ``shard_vector`` gives (all of it on a stacked mesh of one process);
    no host holds the whole vector.  ``mesh.comm.global_vector`` of the
    result assembles the global vector on each device, the form the
    solvers take."""
    from .mesh import row_sharding

    row_sharding(mesh, axis_name)
    n_dev = mesh.size
    if global_length % n_dev:
        raise ValueError(
            f"global_length {global_length} must divide evenly over "
            f"{n_dev} devices (pad the system first)")
    if not isinstance(local_data, torch.Tensor):
        local_data = torch.as_tensor(np.asarray(local_data))
    index, n_proc = process_info()
    if n_proc == 1:
        if local_data.shape[0] != global_length:
            raise ValueError(
                f"single-process shard_vector_global needs the full "
                f"vector: got {local_data.shape[0]} of {global_length}")
        offset = 0
    else:
        per_proc = global_length // n_proc
        if local_data.shape[0] != per_proc:
            raise ValueError(
                f"process {index} holds {local_data.shape[0]} rows, "
                f"expected {per_proc} (= {global_length} / {n_proc})")
        offset = index * per_proc
    per_dev = global_length // n_dev
    blocks = []
    for s in mesh.comm.shard_ids:
        start, stop = _translate_to_local(
            (slice(s * per_dev, (s + 1) * per_dev),), offset,
            global_length, local_data.shape[0])
        blocks.append(local_data[start:stop])
    return torch.cat(blocks).to(mesh.device)


def _translate_to_local(index, offset: int, global_length: int,
                        local_length: int):
    """Translate one shard's GLOBAL row slice into this process's local
    slice bounds.

    ``index`` is a 1-tuple of slices (``None`` endpoints mean the array
    bounds).  A process's shards' rows always fall inside ``[offset,
    offset + local_length)`` when the mesh is in process order -
    violations raise rather than silently feeding a shard the wrong
    rows.
    """
    (sl,) = index
    start = (sl.start or 0) - offset
    stop = (sl.stop if sl.stop is not None else global_length) - offset
    if start < 0 or stop > local_length or stop <= start:
        raise ValueError(
            f"device slice [{sl.start}:{sl.stop}] is outside this "
            f"process's rows [{offset}:{offset + local_length}] - the "
            f"mesh's devices are not in process-contiguous order")
    return start, stop


__all__ = ["global_mesh", "initialize", "process_info",
           "shard_vector_global"]
