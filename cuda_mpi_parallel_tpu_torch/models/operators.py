"""Linear operators: the port's data-structure layer.

Counterpart of the JAX package's ``models/operators.py``: frozen
dataclasses holding tensors on one device, each exposing ``matvec`` /
``__matmul__`` / ``diagonal``.

* ``DenseOperator``  - dense A, ``a @ x``.
* ``CSRMatrix``      - general sparsity, gather + sorted-segment sum (the
  layout of the reference's hardcoded system, ``CUDACG.cu:94-117``).
* ``ShiftELLMatrix`` - assembled sparsity at kernel speed: the hand SpMV
  B8 (``ops/cuda/spmv.py``) over a sliced-ELL layout built from CSR.
* ``Stencil2D/3D``   - matrix-free 5-point / 7-point Poisson (Dirichlet):
  ``backend="pallas"`` runs the hand kernel (B1/B2, ``ops/cuda``),
  ``"xla"`` the plain torch shifted adds, ``"auto"`` picks by size.
* ``IdentityOperator`` - M = I.

Device rule: constructors take ``device=None``, meaning ``"cuda"``;
``device="cpu"`` is the only way onto the host.  The ELL/DIA formats and
the Jacobi preconditioner come with later slices (ROADMAP A2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import spmv
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
        return spmv.csr_matvec(self.data, self.indices, self.indptr, x)

    def diagonal(self):
        return spmv.csr_diagonal(self.data, self.indices, self.rows,
                                 self.indptr)

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.rows.long(), self.indices.long()),
                              self.data, accumulate=True)

    def to_shiftell(self) -> "ShiftELLMatrix":
        """This matrix on the hand SpMV (see ``ShiftELLMatrix``).  The JAX
        package's ``h``/``kc`` sheet geometry is TPU layout; the Hopper
        layout has none."""
        return ShiftELLMatrix.from_csr(self)

    def to_shiftell_df64(self):
        raise NotImplementedError(
            "the double-float shift-ELL format is not ported yet (ROADMAP "
            "A12, kernel B9)")

    def to_ell(self):
        raise NotImplementedError("ELLMatrix is not ported yet (ROADMAP A2)")

    def to_dia(self):
        raise NotImplementedError("DIAMatrix is not ported yet (ROADMAP A2)")


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
    def from_csr(cls, a: CSRMatrix) -> "ShiftELLMatrix":
        """Pack ``a`` on the host (numpy, once) and place the arrays on
        ``a``'s device."""
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
