"""Problem/operator families: the data layer (reference: hardcoded system
at ``CUDACG.cu:74-117``; here: operator types + generators)."""

from . import fem, mmio, poisson, random_spd
from .operators import (
    CSRMatrix,
    DenseOperator,
    DIAMatrix,
    ELLMatrix,
    IdentityOperator,
    JacobiPreconditioner,
    LinearOperator,
    ShiftELLDF64Matrix,
    ShiftELLMatrix,
    Stencil2D,
    Stencil3D,
)
from .precond import (
    BlockJacobiPreconditioner,
    ChebyshevPreconditioner,
    estimate_lmax,
)

__all__ = [
    "BlockJacobiPreconditioner",
    "CSRMatrix",
    "ChebyshevPreconditioner",
    "DIAMatrix",
    "DenseOperator",
    "ELLMatrix",
    "IdentityOperator",
    "JacobiPreconditioner",
    "LinearOperator",
    "ShiftELLDF64Matrix",
    "ShiftELLMatrix",
    "Stencil2D",
    "Stencil3D",
    "estimate_lmax",
    "fem",
    "mmio",
    "poisson",
    "random_spd",
]
