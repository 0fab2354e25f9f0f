"""Sparse and dense matrix-vector products in plain torch.

Counterpart of the JAX package's ``ops/spmv.py`` (``csr_row_indices``,
``csr_matvec``, ``ell_matvec``, ``dense_matvec``, ``dia_matvec``,
``csr_diagonal``), with its arguments:
the CSR forms take the per-entry row ids ``rows`` and ``n_rows``.  The
product is a sorted-segment sum (``torch.segment_reduce``) over segment
offsets found in the sorted ``rows`` by ``searchsorted``, not
``index_add_``: on CUDA the latter adds with float atomics, whose order -
and so whose result - changes from run to run.  ``rows`` must be sorted
ascending, as a CSR matrix's are (the distributed operators sort their
padded row blocks once, stably, when they are built).
"""
from __future__ import annotations

import torch


def csr_row_indices(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand a CSR ``indptr`` into per-entry row ids (COO row array)."""
    ids = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, ids, right=True) - 1).to(torch.int32)


def _segment_offsets(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``indptr`` of sorted row ids: the first entry of each row 0..n_rows
    (entries with a row id >= n_rows fall past the last segment)."""
    bounds = torch.arange(n_rows + 1, dtype=rows.dtype, device=rows.device)
    return torch.searchsorted(rows, bounds)


def csr_matvec(data: torch.Tensor, indices: torch.Tensor, rows: torch.Tensor,
               x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y = A @ x for A in CSR form with per-entry row ids ``rows`` (sorted)
    (``cusparseSpMV(..., alpha=1, beta=0)`` at ``CUDACG.cu:288``); empty
    rows give 0."""
    return torch.segment_reduce(data * x[indices.long()], "sum",
                                offsets=_segment_offsets(rows, n_rows))


def csr_diagonal(data: torch.Tensor, indices: torch.Tensor,
                 rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """diag(A) from CSR (duplicates summed, absent entries 0)."""
    on_diag = torch.where(indices == rows, data, torch.zeros_like(data))
    return torch.segment_reduce(on_diag, "sum",
                                offsets=_segment_offsets(rows, n_rows))


def ell_matvec(vals: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in padded ELL form: a gather and a row sum.

    ``vals``/``cols`` have shape ``(n_rows, k)``; padding entries carry
    ``val == 0`` (their column index is arbitrary but in range), so the
    row sum is exact without masking.
    """
    return (vals * x[cols.long()]).sum(dim=1)


def dense_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for dense A."""
    return a @ x


def dia_matvec(bands: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in DIA (diagonal) form: ``y[i] += bands[d, i] *
    x[i + offsets[d]]``, one statically shifted multiply-add per diagonal
    with zero fill out of range.  ``offsets`` is a tuple of ints; the
    band entries whose column falls out of range must be zero."""
    y = torch.zeros_like(x)
    for d, k in enumerate(offsets):
        if k == 0:
            xs = x
        elif k > 0:
            xs = torch.cat([x[k:], x.new_zeros(k)])
        else:
            xs = torch.cat([x.new_zeros(-k), x[:k]])
        y = y + bands[d] * xs
    return y
