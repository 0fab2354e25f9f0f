"""cuda_mpi_parallel_tpu_torch: the PyTorch/CUDA port of
``cuda_mpi_parallel_tpu`` for NVIDIA Hopper (H100).

The same surface as the JAX package - a caller switches by changing the
import - with the Pallas TPU kernels replaced by hand-written CUDA C++
kernels for ``sm_90a`` (``csrc/``, built by ``nvcc`` at first use) and
XLA's work by plain torch.  Entry points run on the card unless the
operator is built with ``device="cpu"``.

Public API surface::

    from cuda_mpi_parallel_tpu_torch import (
        cg, solve, cg_streaming, cg_resident, CGStatus)
    from cuda_mpi_parallel_tpu_torch.models import poisson

This package imports neither ``jax`` nor the JAX package.
"""

from . import models
from .models.operators import (
    CSRMatrix,
    DenseOperator,
    IdentityOperator,
    LinearOperator,
    ShiftELLMatrix,
    Stencil2D,
    Stencil3D,
)
from .solver.cg import CGResult, cg, solve
from .solver.resident import cg_resident, supports_resident
from .solver.status import CGStatus
from .solver.streaming import cg_streaming, supports_streaming_op

__all__ = [
    "CGResult",
    "CGStatus",
    "CSRMatrix",
    "DenseOperator",
    "IdentityOperator",
    "LinearOperator",
    "ShiftELLMatrix",
    "Stencil2D",
    "Stencil3D",
    "cg",
    "cg_resident",
    "cg_streaming",
    "models",
    "solve",
    "supports_resident",
    "supports_streaming_op",
]
