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
with the neighbour rows as halos.  The f64 lane: ``solve_distributed_df64``
runs the ``solver.df64`` recurrence on float64 slabs
(``DistStencilDF64``: B1/B2 in double), its dots reduced over the mesh;
``solve_distributed_streaming_df64`` runs B6/B7 per shard with halos.
Assembled CSR on ``csr_comm="ring-shiftell"``, and in the f64 lane,
rotates the x-blocks around the ring with each step's slabs one launch
of the hand SpMV (``DistShiftELLRing``: B8; ``DistShiftELLDF64Ring``:
B9).

The pencil decomposition: ``make_mesh_2d`` builds an ``sx x sy`` mesh
(each axis name a view of its axis, ``parallel.comm.AxisComm``), on
which ``solve_distributed`` and ``solve_distributed_df64`` run a
``Stencil3D`` as ``DistStencil3DPencil`` blocks (multigrid included).
``multihost`` joins the ``torch.distributed`` process group and feeds
each process's slice of a vector to its shard, as the JAX package's
``multihost`` does over ``jax.distributed``.

``solve_distributed_many`` (and ``ManyRHSDispatcher``, partitioned
once for many dispatches) solves a column stack on the CSR
allgather/gather lanes with ``solver.many.cg_many`` as the per-shard
body: one exchange and one psum per inner product per iteration for all
``k`` columns.  ``deflate=``/``basis=`` (Krylov recycling) ride the same
lanes of ``solve_distributed``.

``plan=`` (a ``balance.PartitionPlan``, or ``"auto"`` to run the
planner) reorders and re-splits the rows of an assembled CSR system on
every CSR lane - ``solve_distributed``'s allgather, gather, ring and
ring shift-ELL schedules, ``solve_distributed_many``/
``ManyRHSDispatcher`` and the f64 ring of ``solve_distributed_df64`` -
and ``x`` comes back in the caller's row order.

``solve_sequence`` solves one CSR system several times, fitting the
planner's machine model to each measured solve (``telemetry.calibrate``)
and re-planning the next solve on the fit.
"""

from . import multihost
from .comm import AxisComm, ProcessGroupComm, StackedComm, shard_map
from .df64 import DistStencilDF64, solve_distributed_df64
from .dist_cg import (
    ManyRHSDispatcher,
    SequenceEntry,
    SequenceResult,
    cache_key_parts,
    clear_solver_cache,
    solve_distributed,
    solve_distributed_many,
    solve_sequence,
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
from .streaming import (
    solve_distributed_streaming,
    solve_distributed_streaming_df64,
)
from .partition import (
    PartitionedCSR,
    RingPartitionedCSR,
    pad_vector,
    padded_size,
    partition_csr,
    ring_partition_csr,
)

__all__ = [
    "AxisComm",
    "COLS_AXIS",
    "ROWS_AXIS",
    "DistCSR",
    "DistCSRGather",
    "DistCSRRing",
    "DistShiftELLDF64Ring",
    "DistShiftELLRing",
    "DistStencil2D",
    "DistStencilDF64",
    "DistStencil3D",
    "DistStencil3DPencil",
    "GatherSchedule",
    "ManyRHSDispatcher",
    "Mesh",
    "PartitionedCSR",
    "ProcessGroupComm",
    "RingPartitionedCSR",
    "SequenceEntry",
    "SequenceResult",
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
    "multihost",
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
    "solve_distributed_df64",
    "solve_distributed_many",
    "solve_distributed_resident",
    "solve_distributed_streaming",
    "solve_distributed_streaming_df64",
    "solve_sequence",
    "validate_permutation",
]
