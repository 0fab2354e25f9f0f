"""Compute primitives: BLAS-1 and SpMV in plain torch (the JAX package
leaves these to XLA), and the hand kernels under ``ops.cuda``."""

from . import blas1, chebyshev, spmv

__all__ = ["blas1", "chebyshev", "spmv"]
