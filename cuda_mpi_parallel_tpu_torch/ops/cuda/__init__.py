"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``, ``csrc/``) and
their wrappers: the port's counterpart of the JAX package's
``ops/pallas``.  Each wrapper runs its plain PyTorch twin on a CPU
tensor and launches its kernel on a CUDA tensor, counting the launch in
:data:`LAUNCHES` under the JAX function's name (the resident cg1
kernel under ``cg_resident_cg1``).  The f64 lane's kernels (B6, B7, B9,
B11) are the f32 kernels instantiated in float64.  B12
(``resident_dist``) runs every shard of a stacked mesh in one launch."""

from ._build import LAUNCHES, build_info, reset_launches
from .fused_cg import (
    fused_cg_pass_a,
    fused_cg_pass_a_df64,
    fused_cg_pass_a_plain,
    fused_cg_pass_b,
    fused_cg_pass_b_df64,
    fused_cg_pass_b_plain,
    fused_cheb_step,
    fused_cheb_step_plain,
    supports_streaming,
)
from .resident import (
    cg_resident_2d,
    cg_resident_3d,
    cg_resident_cg1_plain,
    cg_resident_df64_2d,
    cg_resident_df64_3d,
    cg_resident_df64_plain,
    cg_resident_plain,
    supports_resident_2d,
    supports_resident_3d,
    supports_resident_df64_2d,
    supports_resident_df64_3d,
    vmem_bytes,
)
from .resident_dist import (
    cg_resident_dist,
    cg_resident_dist_plain,
    supports_resident_dist,
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
    "cg_resident_cg1_plain",
    "cg_resident_df64_2d",
    "cg_resident_df64_3d",
    "cg_resident_df64_plain",
    "cg_resident_dist",
    "cg_resident_dist_plain",
    "cg_resident_plain",
    "fused_cg_pass_a",
    "fused_cg_pass_a_df64",
    "fused_cg_pass_a_plain",
    "fused_cg_pass_b",
    "fused_cg_pass_b_df64",
    "fused_cg_pass_b_plain",
    "fused_cheb_step",
    "fused_cheb_step_plain",
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
    "supports_resident_df64_2d",
    "supports_resident_df64_3d",
    "supports_resident_dist",
    "supports_streaming",
    "vmem_bytes",
]
