"""Linear operators: the port's data-structure layer.

Counterpart of the JAX package's ``models/operators.py``: frozen
dataclasses holding tensors on one device, each exposing ``matvec`` /
``__matmul__`` / ``diagonal``.

* ``DenseOperator``  - dense A, ``a @ x``.
* ``CSRMatrix``      - general sparsity, gather + sorted-segment sum (the
  layout of the reference's hardcoded system, ``CUDACG.cu:94-117``), with
  the host-side reordering tools (``bandwidth``, ``rcm_permutation``,
  ``permuted``: numpy and ``scipy.sparse.csgraph``).
* ``ELLMatrix``      - rows padded to a common width: a gather and a row
  sum in plain torch.
* ``DIAMatrix``      - banded storage, one shifted multiply-add per
  diagonal in plain torch.
* ``ShiftELLMatrix`` - assembled sparsity at kernel speed: the hand SpMV
  B8 (``ops/cuda/spmv.py``) over a sliced-ELL layout built from CSR
  (B9 when its values are float64).
* ``ShiftELLDF64Matrix`` - the f64 lane's assembled operator: f64 values
  on B9, for ``solver.df64.cg_df64`` (``matvec_df``, not ``matvec``).
* ``Stencil2D/3D``   - matrix-free 5-point / 7-point Poisson (Dirichlet):
  ``backend="pallas"`` runs the hand kernel (B1/B2, ``ops/cuda``),
  ``"xla"`` the plain torch shifted adds, ``"auto"`` picks by size.
* ``IdentityOperator`` - M = I.
* ``JacobiPreconditioner`` - M^-1 = diag(A)^-1 (BASELINE config #3); the
  polynomial and block preconditioners are in ``models/precond.py``.

Device rule: constructors take ``device=None``, meaning ``"cuda"``;
``device="cpu"`` is the only way onto the host.  A format converted from
a CSR matrix lands on that matrix's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import df64, spmv
from ..ops.cuda import spmv as hk_spmv
from ..ops.cuda import stencil as hk


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _on(value, device, dtype=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


class LinearOperator:
    """Abstract symmetric-positive-(semi)definite operator interface."""

    shape: Tuple[int, int]

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to a column stack ``(n, k)`` -> ``(n, k)``, one column
        at a time."""
        return torch.stack([self.matvec(x[:, j]) for j in range(x.shape[1])],
                           dim=1)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        raise NotImplementedError

    def to_dense(self) -> torch.Tensor:
        """Materialize (small problems / tests only)."""
        return self.matmat(torch.eye(self.shape[1], dtype=self.dtype,
                                     device=self.device))


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense matrix operator."""

    a: torch.Tensor

    @classmethod
    def create(cls, a, dtype=None, device=None) -> "DenseOperator":
        dtype = None if dtype is None else torch_dtype(dtype)
        return cls(a=_on(a, resolve_device(device), dtype))

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        return spmv.dense_matvec(self.a, x)

    def matmat(self, x):
        return self.a @ x

    def diagonal(self):
        return torch.diagonal(self.a)

    def to_dense(self):
        return self.a


@dataclasses.dataclass(frozen=True)
class CSRMatrix(LinearOperator):
    """CSR sparse matrix: 0-based int32 ``indices``/``indptr`` as in the
    reference's ``h_csrColIndA``/``h_csrRowPtrA`` (``CUDACG.cu:94-117``),
    plus per-entry row ids ``rows`` computed once at construction."""

    data: torch.Tensor     # (nnz,)
    indices: torch.Tensor  # (nnz,) int32 column indices
    indptr: torch.Tensor   # (n_rows+1,) int32
    rows: torch.Tensor     # (nnz,) int32 row ids (derived)
    shape: Tuple[int, int]

    @classmethod
    def from_arrays(cls, data, indices, indptr, shape=None,
                    device=None) -> "CSRMatrix":
        device = resolve_device(device)
        data = _on(data, device)
        indices = _on(indices, device, torch.int32)
        indptr = _on(indptr, device, torch.int32)
        n_rows = indptr.shape[0] - 1
        if shape is None:
            shape = (n_rows, n_rows)
        rows = spmv.csr_row_indices(indptr, data.shape[0])
        return cls(data=data, indices=indices, indptr=indptr, rows=rows,
                   shape=tuple(int(s) for s in shape))

    @classmethod
    def from_scipy(cls, mat, dtype=None, device=None) -> "CSRMatrix":
        """A scipy sparse matrix as CSR, its arrays as scipy holds them."""
        csr = mat.tocsr()
        data = csr.data if dtype is None else csr.data.astype(
            _dtype_name(torch_dtype(dtype)))
        return cls.from_arrays(data, csr.indices, csr.indptr, csr.shape,
                               device=device)

    @classmethod
    def from_dense(cls, a, tol: float = 0.0, device=None) -> "CSRMatrix":
        """The entries of dense ``a`` with ``|a_ij| > tol``, row by row."""
        a = np.asarray(a)
        mask = np.abs(a) > tol
        indptr = np.concatenate(
            [[0], np.cumsum(mask.sum(axis=1))]).astype(np.int32)
        rows_np, cols_np = np.nonzero(mask)
        return cls.from_arrays(a[rows_np, cols_np], cols_np.astype(np.int32),
                               indptr, a.shape, device=device)

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n: int, dtype=None, device=None) -> "CSRMatrix":
        """Sort COO triplets into canonical CSR (row-major, ascending
        columns); duplicates are kept and summed by ``matvec``."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        if dtype is not None:
            vals = vals.astype(_dtype_name(torch_dtype(dtype)))
        return cls.from_arrays(vals, cols.astype(np.int32), indptr, (n, n),
                               device=device)

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def matvec(self, x):
        return spmv.csr_matvec(self.data, self.indices, self.rows, x,
                               self.shape[0])

    def diagonal(self):
        return spmv.csr_diagonal(self.data, self.indices, self.rows,
                                 self.shape[0])

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.rows.long(), self.indices.long()),
                              self.data, accumulate=True)

    def to_shiftell(self, h: int | None = None,
                    kc: int = 8) -> "ShiftELLMatrix":
        """This matrix on the hand SpMV (see ``ShiftELLMatrix``).  ``h``
        and ``kc`` are the JAX package's sheet geometry, TPU layout: they
        are checked and otherwise ignored (``_layout_hints``)."""
        return ShiftELLMatrix.from_csr(self, h=h, kc=kc)

    def to_shiftell_df64(self, h: int | None = None,
                         kc: int = 8) -> "ShiftELLDF64Matrix":
        """This matrix on the f64 SpMV B9, for ``solver.df64.cg_df64``
        (the reference's ``CUDA_R_64F`` CSR configuration,
        ``CUDACG.cu:216,288``).  The values are this matrix's, in
        float64: f32-stored data is exact but carries no more bits.
        ``h``/``kc`` as for :meth:`to_shiftell`."""
        return ShiftELLDF64Matrix.from_csr(self, h=h, kc=kc)

    def bandwidth(self) -> int:
        """max |i - j| over stored entries (host side)."""
        rows = self.rows.cpu().numpy().astype(np.int64)
        cols = self.indices.cpu().numpy().astype(np.int64)
        return int(np.abs(rows - cols).max()) if rows.size else 0

    def rcm_permutation(self) -> np.ndarray:
        """Reverse Cuthill-McKee ordering (perm[new] = old), which narrows
        the band of ``P A P^T`` (host side, ``scipy.sparse.csgraph``).
        Assumes a symmetric sparsity pattern."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        m = sp.csr_matrix(
            (self.data.cpu().numpy(), self.indices.cpu().numpy(),
             self.indptr.cpu().numpy()), shape=self.shape)
        return np.ascontiguousarray(
            reverse_cuthill_mckee(m, symmetric_mode=True), dtype=np.int32)

    def permuted(self, perm: np.ndarray) -> "CSRMatrix":
        """Symmetric permutation ``P A P^T`` (rows and columns reordered),
        on this matrix's device.  The permuted system ``A' x' = b'`` with
        ``b' = b[perm]`` gives ``x[perm] = x'``."""
        perm = np.asarray(perm)
        n = self.shape[0]
        if perm.shape != (n,):
            raise ValueError(f"permutation shape {perm.shape} != ({n},)")
        if not np.array_equal(np.sort(perm), np.arange(n)):
            raise ValueError("perm is not a permutation of range(n)")
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        return CSRMatrix.from_coo(inv[self.rows.cpu().numpy()],
                                  inv[self.indices.cpu().numpy()],
                                  self.data.cpu().numpy(), n,
                                  device=self.device)

    def to_ell(self, width: int | None = None) -> "ELLMatrix":
        """Padded ELL (host-side packing; see ``ELLMatrix``).  ``width``
        defaults to the longest row and may not be shorter."""
        indptr = self.indptr.cpu().numpy().astype(np.int64)
        counts = np.diff(indptr)
        longest = int(counts.max()) if counts.size else 0
        if width is not None and longest > width:
            raise ValueError(f"ELL width {width} < max row nnz {longest}")
        k = longest if width is None else int(width)
        n = self.shape[0]
        rows = self.rows.cpu().numpy().astype(np.int64)
        slot = np.arange(rows.size, dtype=np.int64) - indptr[rows]
        data = self.data.cpu().numpy()
        vals = np.zeros((n, k), dtype=data.dtype)
        cols = np.zeros((n, k), dtype=np.int32)
        vals[rows, slot] = data
        cols[rows, slot] = self.indices.cpu().numpy()
        dev = self.device
        return ELLMatrix(vals=torch.as_tensor(vals, device=dev),
                         cols=torch.as_tensor(cols, device=dev),
                         shape=tuple(self.shape))

    def to_dia(self, max_diags: int = 512) -> "DIAMatrix":
        """DIA form (see ``DIAMatrix``)."""
        return DIAMatrix.from_csr(self, max_diags=max_diags)


@dataclasses.dataclass(frozen=True)
class ELLMatrix(LinearOperator):
    """Padded ELL layout ``(n_rows, k)``: each row's entries in CSR order,
    then zero-valued padding with column 0.  The matvec is a gather and a
    row sum in plain torch (``ops.spmv.ell_matvec``)."""

    vals: torch.Tensor  # (n_rows, k)
    cols: torch.Tensor  # (n_rows, k) int32
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def matvec(self, x):
        return spmv.ell_matvec(self.vals, self.cols, x)

    def diagonal(self):
        row_ids = torch.arange(self.shape[0], dtype=self.cols.dtype,
                               device=self.cols.device)[:, None]
        return torch.where(self.cols == row_ids, self.vals,
                           torch.zeros_like(self.vals)).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class DIAMatrix(LinearOperator):
    """DIA (diagonal) format for banded matrices: ``bands[d, i] = A[i, i +
    offsets[d]]``, zero where ``i + offsets[d]`` is out of range.  The
    matvec is one shifted multiply-add per diagonal in plain torch
    (``ops.spmv.dia_matvec``); storage and work grow with the number of
    diagonals, so scattered sparsity stays in CSR/ELL (or is narrowed
    first with ``CSRMatrix.rcm_permutation``)."""

    bands: torch.Tensor       # (n_diags, n)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, a: CSRMatrix, max_diags: int = 512) -> "DIAMatrix":
        """Convert a CSR matrix on the host (duplicate entries summed);
        refuses one that populates more than ``max_diags`` diagonals."""
        rows = a.rows.cpu().numpy().astype(np.int64)
        cols = a.indices.cpu().numpy().astype(np.int64)
        data = a.data.cpu().numpy()
        offs = np.unique(cols - rows)
        if offs.size > max_diags:
            raise ValueError(
                f"matrix populates {offs.size} diagonals > max_diags="
                f"{max_diags}; DIA would be denser than ELL - keep CSR/ELL "
                f"(or RCM-reorder first)")
        n = a.shape[0]
        bands = np.zeros((offs.size, n), dtype=data.dtype)
        didx = np.searchsorted(offs, cols - rows)  # offs is sorted-unique
        np.add.at(bands, (didx, rows), data)
        return cls(bands=torch.as_tensor(bands, device=a.device),
                   offsets=tuple(int(k) for k in offs),
                   shape=tuple(a.shape))

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self):
        return self.bands.device

    def matvec(self, x):
        return spmv.dia_matvec(self.bands, self.offsets, x)

    def diagonal(self):
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)


def _layout_hints(h, kc) -> None:
    """Check the JAX shift-ELL's sheet geometry arguments: ``h`` (rows
    per sheet, None = chosen) and ``kc`` (columns per chunk).  They shape
    the TPU's layout only; the Hopper sliced-ELL layout (slices of 32
    rows, ``ops.cuda.spmv.pack_sliced_ell``) has no counterpart, so valid
    values are accepted and change nothing."""
    if h is not None and (isinstance(h, bool) or int(h) != h or h < 1):
        raise ValueError(f"h must be None or a positive int, got {h!r}")
    if isinstance(kc, bool) or int(kc) != kc or kc < 1:
        raise ValueError(f"kc must be a positive int, got {kc!r}")


@dataclasses.dataclass(frozen=True)
class ShiftELLMatrix(LinearOperator):
    """An assembled matrix on the hand SpMV B8 - the port of the JAX
    package's shift-ELL format, the counterpart of the reference's
    ``cusparseSpMV`` over CSR (``CUDACG.cu:288``).

    The name and API are the JAX package's; the layout inside is Hopper's
    sliced ELL (``ops.cuda.spmv.pack_sliced_ell``): rows in slices of 32,
    each slice padded to its longest row, values and int32 columns
    slot-major so a warp reads 32 consecutive entries per slot.  The
    matvec adds each row's entries in CSR order.  ``diag`` is kept from
    the CSR (the layout loses O(1) access to it).
    """

    vals: torch.Tensor       # (n_slots,) 0 in padding slots
    cols: torch.Tensor       # (n_slots,) int32, -1 in padding slots
    slice_ptr: torch.Tensor  # (ceil(n / 32) + 1,) int64
    diag: torch.Tensor       # (n,)
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, a: CSRMatrix, h: int | None = None,
                 kc: int = 8) -> "ShiftELLMatrix":
        """Pack ``a`` on the host (numpy, once) and place the arrays on
        ``a``'s device.  ``h``/``kc``: the JAX sheet geometry, checked and
        ignored (``_layout_hints``)."""
        _layout_hints(h, kc)
        n = a.shape[0]
        packed = hk_spmv.pack_sliced_ell(
            a.indptr.cpu().numpy(), a.indices.cpu().numpy(),
            a.data.cpu().numpy(), n)
        dev = a.device
        return cls(vals=torch.as_tensor(packed.vals, device=dev),
                   cols=torch.as_tensor(packed.cols, device=dev),
                   slice_ptr=torch.as_tensor(packed.slice_ptr, device=dev),
                   diag=a.diagonal(), shape=tuple(a.shape))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def matvec(self, x):
        return hk_spmv.shift_ell_matvec(x, self.vals, self.cols,
                                        self.slice_ptr, self.shape[0])

    def diagonal(self):
        return self.diag


@dataclasses.dataclass(frozen=True)
class ShiftELLDF64Matrix:
    """An assembled matrix on the f64 SpMV B9 - the port of the JAX
    package's double-float shift-ELL format, f64-class assembled SpMV
    (the reference's ``cusparseSpMV`` over ``CUDA_R_64F`` CSR,
    ``CUDACG.cu:216,288``).

    The JAX class keeps its values as ``(hi, lo)`` f32 planes because a
    TPU has no f64; here they are float64, in the same sliced-ELL layout
    as ``ShiftELLMatrix``.  The API is the JAX one: ``matvec_df`` takes
    and returns an ``(hi, lo)`` pair, ``diagonal_df`` gives diag(A) as a
    pair, and ``matvec`` raises - like the JAX class this is NOT a
    ``LinearOperator``, so the f32 solvers refuse it.  ``matvec64`` is
    the product on float64 vectors, what ``solver.df64`` calls.
    """

    vals: torch.Tensor       # (n_slots,) float64, 0 in padding slots
    cols: torch.Tensor       # (n_slots,) int32, -1 in padding slots
    slice_ptr: torch.Tensor  # (ceil(n / 32) + 1,) int64
    diag: torch.Tensor       # (n,) float64
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, a: CSRMatrix, h: int | None = None,
                 kc: int = 8) -> "ShiftELLDF64Matrix":
        """Pack ``a``'s values in float64 on the host (numpy, once) and
        place the arrays on ``a``'s device.  ``h``/``kc`` as for
        ``ShiftELLMatrix.from_csr``."""
        _layout_hints(h, kc)
        n = a.shape[0]
        packed = hk_spmv.pack_sliced_ell(
            a.indptr.cpu().numpy(), a.indices.cpu().numpy(),
            a.data.cpu().numpy().astype(np.float64), n)
        dev = a.device
        return cls(vals=torch.as_tensor(packed.vals, device=dev),
                   cols=torch.as_tensor(packed.cols, device=dev),
                   slice_ptr=torch.as_tensor(packed.slice_ptr, device=dev),
                   diag=spmv.csr_diagonal(a.data.double(), a.indices, a.rows,
                                          n),
                   shape=tuple(a.shape))

    @classmethod
    def from_shiftell(cls, a: ShiftELLMatrix) -> "ShiftELLDF64Matrix":
        """Lift a ``ShiftELLMatrix`` to float64: the values stay what they
        were, the products and sums are float64."""
        return cls(vals=a.vals.double(), cols=a.cols, slice_ptr=a.slice_ptr,
                   diag=a.diag.double(), shape=tuple(a.shape))

    @property
    def nnz_dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def matvec64(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` on a float64 vector (B9 on the card)."""
        return hk_spmv.shift_ell_matvec(x, self.vals, self.cols,
                                        self.slice_ptr, self.shape[0])

    def matvec_df(self, x):
        """``(y_hi, y_lo) = A @ (x_hi, x_lo)``: the pair recombined to
        float64, multiplied, and split again."""
        y = self.matvec64(df64.pair_to_f64(*x).to(self.device))
        return df64.f64_to_pair(y)

    def diagonal_df(self):
        return df64.f64_to_pair(self.diag)

    def matvec(self, x):
        raise TypeError(
            "ShiftELLDF64Matrix is a double-float operator: use "
            "solver.df64.cg_df64 (matvec_df), not the f32 solve path")

    def __matmul__(self, x):
        return self.matvec(x)


# Above this many bytes of grid ``backend="auto"`` takes the hand kernel
# (the JAX package's threshold, kept so "auto" decides alike).
_PALLAS_BYTES_THRESHOLD = 48 * 2 ** 20


def _resolve_backend(backend: str, grid, itemsize: int) -> str:
    """The hand kernels take any grid (the TPU kernels' tiling rules do
    not apply), so "auto" decides on size alone."""
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend: {backend!r}")
    if backend != "auto":
        return backend
    n_bytes = itemsize
    for g in grid:
        n_bytes *= g
    return "pallas" if n_bytes >= _PALLAS_BYTES_THRESHOLD else "xla"


@dataclasses.dataclass(frozen=True)
class Stencil2D(LinearOperator):
    """Matrix-free 2D 5-point Poisson (Dirichlet) operator:
    ``(4u[i,j] - u[i-1,j] - u[i+1,j] - u[i,j-1] - u[i,j+1]) * scale``.

    ``backend``: ``"xla"`` (plain torch shifted adds), ``"pallas"`` (the
    hand kernel B1 on the card; its plain twin on the CPU) or ``"auto"``.
    """

    scale: torch.Tensor  # 0-d, on the operator's device
    grid: Tuple[int, int]
    backend: str = "xla"
    _dtype_name: str = "float32"

    @classmethod
    def create(cls, nx: int, ny: int, scale: float = 1.0,
               dtype=torch.float32, backend: str = "xla", device=None):
        dtype = torch_dtype(dtype)
        device = resolve_device(device)
        backend = _resolve_backend(backend, (nx, ny), dtype.itemsize)
        return cls(scale=_on(scale, device, dtype).reshape(()),
                   grid=(nx, ny), backend=backend,
                   _dtype_name=_dtype_name(dtype))

    @property
    def shape(self):
        n = self.grid[0] * self.grid[1]
        return (n, n)

    @property
    def dtype(self):
        return getattr(torch, self._dtype_name)

    @property
    def device(self):
        return self.scale.device

    def matvec(self, x):
        u = x.reshape(self.grid)
        if self.backend == "pallas":
            y = hk.stencil2d_apply(u, self.scale)
        else:
            y = hk.stencil2d_apply_plain(u, self.scale)
        return y.reshape(-1)

    def diagonal(self):
        return torch.full((self.shape[0],), 4.0, dtype=self.dtype,
                          device=self.device) * self.scale


@dataclasses.dataclass(frozen=True)
class Stencil3D(LinearOperator):
    """Matrix-free 3D 7-point Poisson (Dirichlet) operator - the north-star
    problem (BASELINE config #4: N=256^3).

    ``backend``: ``"xla"``, ``"pallas"`` (hand kernel B2) or ``"auto"``.
    """

    scale: torch.Tensor
    grid: Tuple[int, int, int]
    backend: str = "xla"
    _dtype_name: str = "float32"

    @classmethod
    def create(cls, nx: int, ny: int, nz: int, scale: float = 1.0,
               dtype=torch.float32, backend: str = "xla", device=None):
        dtype = torch_dtype(dtype)
        device = resolve_device(device)
        backend = _resolve_backend(backend, (nx, ny, nz), dtype.itemsize)
        return cls(scale=_on(scale, device, dtype).reshape(()),
                   grid=(nx, ny, nz), backend=backend,
                   _dtype_name=_dtype_name(dtype))

    @property
    def shape(self):
        n = self.grid[0] * self.grid[1] * self.grid[2]
        return (n, n)

    @property
    def dtype(self):
        return getattr(torch, self._dtype_name)

    @property
    def device(self):
        return self.scale.device

    def matvec(self, x):
        u = x.reshape(self.grid)
        if self.backend == "pallas":
            y = hk.stencil3d_apply(u, self.scale)
        else:
            y = hk.stencil3d_apply_plain(u, self.scale)
        return y.reshape(-1)

    def diagonal(self):
        return torch.full((self.shape[0],), 6.0, dtype=self.dtype,
                          device=self.device) * self.scale


@dataclasses.dataclass(frozen=True)
class IdentityOperator(LinearOperator):
    """M = I - the 'no preconditioner' object."""

    dim: int
    _dtype_name: str = "float32"
    _device: Optional[str] = None

    @property
    def shape(self):
        return (self.dim, self.dim)

    @property
    def dtype(self):
        return getattr(torch, self._dtype_name)

    @property
    def device(self):
        return resolve_device(self._device)

    def matvec(self, x):
        return x

    def matmat(self, x):
        return x

    def diagonal(self):
        return torch.ones(self.n, dtype=self.dtype, device=self.device)


@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner(LinearOperator):
    """M^-1 = diag(A)^-1 (BASELINE config #3): the first rung above the
    reference, which has no preconditioning."""

    inv_diag: torch.Tensor

    @classmethod
    def from_operator(cls, a: LinearOperator) -> "JacobiPreconditioner":
        return cls(inv_diag=1.0 / a.diagonal())

    @property
    def shape(self):
        n = self.inv_diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.inv_diag.dtype

    @property
    def device(self):
        return self.inv_diag.device

    def matvec(self, x):
        return self.inv_diag * x

    def matmat(self, x):
        return self.inv_diag[:, None] * x

    def diagonal(self):
        return self.inv_diag
