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

The many-RHS forms (``csr_matmat``, ``ell_matmat``, ``dia_matmat``) take
an ``(n, k)`` column stack and return one, column-major (``(k, n)``
storage seen as ``(n, k)``); column ``j`` is the matvec of column ``j``
bit for bit.  Each is one sweep of the matrix for all ``k`` columns: the
CSR form lays the ``k`` columns' products end to end and takes ONE
segment sum over ``k`` copies of the row offsets, the same 1-D reduction
the matvec makes, so every row sums its entries in the matvec's order.
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


def csr_matmat(data: torch.Tensor, indices: torch.Tensor, rows: torch.Tensor,
               x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Y = A @ X for a column stack ``X (n, k)``: each column's products
    ``data * X[indices, j]`` laid end to end, and one segment sum over
    the ``k`` columns' copies of the row offsets (a last segment a column
    takes its entries past ``n_rows``, so no column reads into the
    next)."""
    k = x.shape[1]
    nnz = data.shape[0]
    xt = x.t()                                   # (k, n)
    prod = data[None, :] * xt[:, indices.long()]  # (k, nnz)
    offs = _segment_offsets(rows, n_rows)         # (n_rows + 1,)
    starts = torch.arange(k, dtype=offs.dtype, device=offs.device) * nnz
    flat = torch.cat([(offs[None, :] + starts[:, None]).reshape(-1),
                      offs.new_full((1,), k * nnz)])
    y = torch.segment_reduce(prod.reshape(-1), "sum", offsets=flat)
    return y.reshape(k, n_rows + 1)[:, :n_rows].contiguous().t()


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


def ell_matmat(vals: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in padded ELL form for a column stack ``X (n, k)``: the
    ``k`` columns' gathers stacked row after row and one row sum, the
    matvec's reduction over ``k`` times the rows."""
    k = x.shape[1]
    n_rows, width = vals.shape
    xt = x.t()                                    # (k, n)
    prod = vals[None] * xt[:, cols.long()]        # (k, n_rows, width)
    return prod.reshape(k * n_rows, width).sum(dim=1) \
        .reshape(k, n_rows).t()


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


def dia_matmat(bands: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in DIA form for a column stack ``X (n, k)``: the
    matvec's shifted multiply-adds over all ``k`` columns at once
    (elementwise, so each column is its matvec bit for bit)."""
    xt = x.t().contiguous()                       # (k, n)
    y = torch.zeros_like(xt)
    for d, s in enumerate(offsets):
        if s == 0:
            xs = xt
        elif s > 0:
            xs = torch.cat([xt[:, s:], xt.new_zeros((xt.shape[0], s))],
                           dim=1)
        else:
            xs = torch.cat([xt.new_zeros((xt.shape[0], -s)), xt[:, :s]],
                           dim=1)
        y = y + bands[d][None, :] * xs
    return y.t()
