"""Solvers: the general CG loop, the fused streaming engine and the
one-launch resident engine, each in f32 and in the f64 lane; the
many-RHS tier (``many``: masked batched and block CG over column
stacks) and Krylov recycling (``recycle``: the basis ring, the harvest
and the deflated lane)."""

from .cg import CGCheckpoint, CGResult, cg, solve
from .df64 import DF64CGResult, DF64Checkpoint, cg_df64
from .many import CGBatchResult, cg_many, solve_many, stack_columns
from .recycle import (
    BasisConfig,
    HarvestError,
    RecycleMismatch,
    RecycleSpace,
    harvest_space,
    recycled_sequence,
)
from .resident import (
    cg_resident,
    cg_resident_df64,
    resident_eligible,
    supports_resident,
    supports_resident_df64,
)
from .status import CGStatus
from .streaming import (
    cg_streaming,
    cg_streaming_df64,
    streaming_eligible,
    supports_streaming_df64,
    supports_streaming_op,
)

__all__ = ["BasisConfig", "CGBatchResult", "CGCheckpoint", "CGResult",
           "CGStatus", "DF64CGResult", "DF64Checkpoint", "HarvestError",
           "RecycleMismatch", "RecycleSpace", "cg", "cg_df64", "cg_many",
           "cg_resident", "cg_resident_df64", "cg_streaming",
           "cg_streaming_df64", "harvest_space", "recycled_sequence",
           "resident_eligible", "solve", "solve_many", "stack_columns",
           "streaming_eligible", "supports_resident", "supports_resident_df64",
           "supports_streaming_df64", "supports_streaming_op"]
