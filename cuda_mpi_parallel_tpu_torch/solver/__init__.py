"""Solvers: the general CG loop, the fused streaming engine and the
one-launch resident engine, each in f32 and in the f64 lane."""

from .cg import CGCheckpoint, CGResult, cg, solve
from .df64 import DF64CGResult, DF64Checkpoint, cg_df64
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

__all__ = ["CGCheckpoint", "CGResult", "CGStatus", "DF64CGResult",
           "DF64Checkpoint", "cg", "cg_df64", "cg_resident", "cg_resident_df64", "cg_streaming",
           "cg_streaming_df64", "resident_eligible", "solve",
           "streaming_eligible", "supports_resident", "supports_resident_df64",
           "supports_streaming_df64", "supports_streaming_op"]
