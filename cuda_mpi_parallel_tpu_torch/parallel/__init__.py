"""Distributed execution: meshes, row partitioning, halo exchange and the
psum/ppermute/all_gather collectives of ``parallel.comm`` - the port of
the JAX package's ``parallel`` package.

A mesh is P shards of one device in this process (``make_mesh(devices=
["cuda:0"] * P)``, or ``["cpu"] * P`` on the host) or one rank per
device of a ``torch.distributed`` process group.  ``solve_distributed``
runs the single-device CG loop as the per-shard body;
``solve_distributed_resident`` runs the whole solve as one launch of the
hand kernel B12 (P shards as P groups of one cooperative launch);
``solve_distributed_streaming`` runs the fused passes B3/B4 per shard
with the neighbour rows as halos.

Not ported yet, each raising and naming its ROADMAP item:
``solve_distributed_df64``, ``solve_distributed_streaming_df64``,
``solve_distributed_many``/``ManyRHSDispatcher``/``solve_sequence``,
the pencil mesh (``make_mesh_2d``, ``DistStencil3DPencil``), the
shift-ELL ring operators and ``multihost``.
"""

from .comm import ProcessGroupComm, StackedComm, shard_map
from .dist_cg import (
    cache_key_parts,
    clear_solver_cache,
    solve_distributed,
)
from .exchange import (
    GatherSchedule,
    accepts_gather,
    build_gather_schedule,
    choose_exchange,
)
from .halo import (
    exchange_halo,
    exchange_halo_axis,
    neighbor_shift_perms,
    rotation_perm,
    validate_permutation,
)
from .mesh import (
    COLS_AXIS,
    ROWS_AXIS,
    Mesh,
    make_mesh,
    make_mesh_2d,
    row_sharding,
    shard_vector,
)
from .operators import (
    DistCSR,
    DistCSRGather,
    DistCSRRing,
    DistShiftELLDF64Ring,
    DistShiftELLRing,
    DistStencil2D,
    DistStencil3D,
    DistStencil3DPencil,
)
from .resident import solve_distributed_resident
from .streaming import solve_distributed_streaming
from .partition import (
    PartitionedCSR,
    RingPartitionedCSR,
    pad_vector,
    padded_size,
    partition_csr,
    ring_partition_csr,
)

__all__ = [
    "COLS_AXIS",
    "ROWS_AXIS",
    "DistCSR",
    "DistCSRGather",
    "DistCSRRing",
    "DistShiftELLDF64Ring",
    "DistShiftELLRing",
    "DistStencil2D",
    "DistStencil3D",
    "DistStencil3DPencil",
    "GatherSchedule",
    "Mesh",
    "PartitionedCSR",
    "ProcessGroupComm",
    "RingPartitionedCSR",
    "StackedComm",
    "accepts_gather",
    "build_gather_schedule",
    "cache_key_parts",
    "choose_exchange",
    "clear_solver_cache",
    "exchange_halo",
    "exchange_halo_axis",
    "make_mesh",
    "make_mesh_2d",
    "neighbor_shift_perms",
    "pad_vector",
    "padded_size",
    "partition_csr",
    "ring_partition_csr",
    "rotation_perm",
    "row_sharding",
    "shard_map",
    "shard_vector",
    "solve_distributed",
    "solve_distributed_resident",
    "solve_distributed_streaming",
    "validate_permutation",
]
