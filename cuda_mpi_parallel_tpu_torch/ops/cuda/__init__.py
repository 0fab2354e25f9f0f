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
from .resident import (
    cg_resident_2d,
    cg_resident_3d,
    cg_resident_plain,
    supports_resident_2d,
    supports_resident_3d,
    vmem_bytes,
)
from .spmv import pack_sliced_ell, shift_ell_matvec, shift_ell_matvec_plain
from .stencil import (
    stencil2d_apply,
    stencil2d_apply_plain,
    stencil3d_apply,
    stencil3d_apply_plain,
)

__all__ = [
    "LAUNCHES",
    "build_info",
    "cg_resident_2d",
    "cg_resident_3d",
    "cg_resident_plain",
    "fused_cg_pass_a",
    "fused_cg_pass_a_plain",
    "fused_cg_pass_b",
    "fused_cg_pass_b_plain",
    "pack_sliced_ell",
    "reset_launches",
    "shift_ell_matvec",
    "shift_ell_matvec_plain",
    "stencil2d_apply",
    "stencil2d_apply_plain",
    "stencil3d_apply",
    "stencil3d_apply_plain",
    "supports_resident_2d",
    "supports_resident_3d",
    "supports_streaming",
    "vmem_bytes",
]
