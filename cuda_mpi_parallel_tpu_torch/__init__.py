"""cuda_mpi_parallel_tpu_torch: the PyTorch/CUDA port of
``cuda_mpi_parallel_tpu`` for NVIDIA Hopper (H100).

The same surface as the JAX package - a caller switches by changing the
import - with the Pallas TPU kernels replaced by hand-written CUDA C++
kernels for ``sm_90a`` (``csrc/``, built by ``nvcc`` at first use) and
XLA's work by plain torch.  Entry points run on the card unless the
operator is built with ``device="cpu"``.

Public API surface::

    from cuda_mpi_parallel_tpu_torch import (
        cg, solve, cg_streaming, cg_resident, CGStatus, CGCheckpoint,
        CSRMatrix, ELLMatrix, JacobiPreconditioner, ChebyshevPreconditioner,
        BlockJacobiPreconditioner,
        cg_df64, cg_streaming_df64, cg_resident_df64, DF64CGResult,
        DF64Checkpoint, ShiftELLDF64Matrix)
    from cuda_mpi_parallel_tpu_torch.models import fem, poisson, random_spd
    from cuda_mpi_parallel_tpu_torch.solver.minres import minres, minres_df64

This package imports neither ``jax`` nor the JAX package.
"""

from . import models
from .models.operators import (
    CSRMatrix,
    DenseOperator,
    ELLMatrix,
    IdentityOperator,
    JacobiPreconditioner,
    LinearOperator,
    ShiftELLDF64Matrix,
    ShiftELLMatrix,
    Stencil2D,
    Stencil3D,
)
from .models.precond import (
    BlockJacobiPreconditioner,
    ChebyshevPreconditioner,
    estimate_lmax,
)
from .solver.cg import CGCheckpoint, CGResult, cg, solve
from .solver.df64 import DF64CGResult, DF64Checkpoint, cg_df64
from .solver.resident import (
    cg_resident,
    cg_resident_df64,
    supports_resident,
    supports_resident_df64,
)
from .solver.status import CGStatus
from .solver.streaming import (
    cg_streaming,
    cg_streaming_df64,
    supports_streaming_df64,
    supports_streaming_op,
)

__all__ = [
    "BlockJacobiPreconditioner",
    "CGCheckpoint",
    "CGResult",
    "CGStatus",
    "CSRMatrix",
    "ChebyshevPreconditioner",
    "DF64CGResult",
    "DF64Checkpoint",
    "DenseOperator",
    "ELLMatrix",
    "IdentityOperator",
    "JacobiPreconditioner",
    "LinearOperator",
    "ShiftELLDF64Matrix",
    "ShiftELLMatrix",
    "Stencil2D",
    "Stencil3D",
    "cg",
    "cg_df64",
    "cg_resident",
    "cg_resident_df64",
    "cg_streaming",
    "cg_streaming_df64",
    "estimate_lmax",
    "models",
    "solve",
    "supports_resident",
    "supports_resident_df64",
    "supports_streaming_df64",
    "supports_streaming_op",
]
