"""Level-1 vector operations in plain torch.

Counterpart of the JAX package's ``ops/blas1.py`` (``dot``,
``norm2_sq``, ``axpy``, ``xpby``).  Scalars stay 0-d tensors on the
vectors' device, so the solver loop never copies one to the host
between its convergence checks.  The distributed (``axis_name``),
many-RHS and compensated forms come with later slices (ROADMAP A2).
"""
from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product x . y as a 0-d tensor (grids are flattened, as
    ``jnp.vdot`` does)."""
    return torch.dot(x.reshape(-1), y.reshape(-1))


def norm2_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared 2-norm ||x||^2 (what the CG recurrence consumes)."""
    return dot(x, x)


def axpy(alpha: torch.Tensor, x: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x  (``cublasDaxpy``, ``CUDACG.cu:314,321,347``)."""
    return y + alpha * x


def xpby(x: torch.Tensor, beta: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """x + beta * y - the CG direction update."""
    return x + beta * y
