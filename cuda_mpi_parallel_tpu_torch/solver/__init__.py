"""Solvers: the general CG loop, the fused streaming engine and the
one-launch resident engine."""

from .cg import CGResult, cg, solve
from .resident import cg_resident, resident_eligible, supports_resident
from .status import CGStatus
from .streaming import cg_streaming, streaming_eligible, supports_streaming_op

__all__ = ["CGResult", "CGStatus", "cg", "cg_resident", "cg_streaming",
           "resident_eligible", "solve", "streaming_eligible",
           "supports_resident", "supports_streaming_op"]
