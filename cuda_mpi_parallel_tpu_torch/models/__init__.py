"""Problem/operator families: the data layer (reference: hardcoded system
at ``CUDACG.cu:74-117``; here: operator types + generators)."""

from . import poisson
from .operators import (
    CSRMatrix,
    DenseOperator,
    IdentityOperator,
    LinearOperator,
    Stencil2D,
    Stencil3D,
)

__all__ = [
    "CSRMatrix",
    "DenseOperator",
    "IdentityOperator",
    "LinearOperator",
    "Stencil2D",
    "Stencil3D",
    "poisson",
]
