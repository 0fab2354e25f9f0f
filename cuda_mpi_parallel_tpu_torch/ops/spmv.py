"""Sparse and dense matrix-vector products in plain torch.

Counterpart of the JAX package's ``ops/spmv.py`` (``csr_row_indices``,
``csr_matvec``, ``dense_matvec``, ``csr_diagonal``).  The CSR product is
a sorted-segment sum over ``indptr`` (``torch.segment_reduce``), not
``index_add_``: on CUDA the latter adds with float atomics, whose order -
and so whose result - changes from run to run.
"""
from __future__ import annotations

import torch


def csr_row_indices(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand a CSR ``indptr`` into per-entry row ids (COO row array)."""
    ids = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, ids, right=True) - 1).to(torch.int32)


def csr_matvec(data: torch.Tensor, indices: torch.Tensor,
               indptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in CSR form (``cusparseSpMV(..., alpha=1,
    beta=0)`` at ``CUDACG.cu:288``); empty rows give 0."""
    return torch.segment_reduce(data * x[indices], "sum", offsets=indptr)


def csr_diagonal(data: torch.Tensor, indices: torch.Tensor,
                 rows: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """diag(A) from CSR (duplicates summed, absent entries 0)."""
    on_diag = torch.where(indices == rows, data, torch.zeros_like(data))
    return torch.segment_reduce(on_diag, "sum", offsets=indptr)


def dense_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for dense A."""
    return a @ x
