"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``, ``csrc/``) and
their wrappers: the port's counterpart of the JAX package's
``ops/pallas``.  Each wrapper runs its plain PyTorch twin on a CPU
tensor and launches its kernel on a CUDA tensor, counting the launch in
:data:`LAUNCHES`."""

from ._build import LAUNCHES, build_info, reset_launches
from .fused_cg import (
    fused_cg_pass_a,
    fused_cg_pass_a_plain,
    fused_cg_pass_b,
    fused_cg_pass_b_plain,
    supports_streaming,
)
from .stencil import (
    stencil2d_apply,
    stencil2d_apply_plain,
    stencil3d_apply,
    stencil3d_apply_plain,
)

__all__ = [
    "LAUNCHES",
    "build_info",
    "fused_cg_pass_a",
    "fused_cg_pass_a_plain",
    "fused_cg_pass_b",
    "fused_cg_pass_b_plain",
    "reset_launches",
    "stencil2d_apply",
    "stencil2d_apply_plain",
    "stencil3d_apply",
    "stencil3d_apply_plain",
    "supports_streaming",
]
