"""Solvers: the general CG loop and the fused streaming engine."""

from .cg import CGResult, cg, solve
from .status import CGStatus
from .streaming import cg_streaming, streaming_eligible, supports_streaming_op

__all__ = ["CGResult", "CGStatus", "cg", "cg_streaming", "solve",
           "streaming_eligible", "supports_streaming_op"]
