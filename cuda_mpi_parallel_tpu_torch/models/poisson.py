"""Poisson problem generators (the framework's benchmark model family).

Counterpart of the JAX package's ``models/poisson.py``.  The reference
ships exactly one hardcoded 3x3 system (``CUDACG.cu:74-117``);
``oracle_system()`` reproduces it as the regression oracle.  The 2D
5-point and 3D 7-point (N=256^3) Laplacians are generated both as
assembled CSR and matrix-free (``Stencil2D/3D``).  Assembly is host-side
vectorized numpy; the operators land on ``device`` (``None`` = cuda).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .operators import CSRMatrix, Stencil2D, Stencil3D, torch_dtype


def oracle_system(dtype=torch.float64,
                  device=None) -> Tuple[CSRMatrix, torch.Tensor, np.ndarray]:
    """The reference's hardcoded system and its documented solution.

    A (symmetric, *indefinite* - eigenvalues {-0.236, 2, 4.236}, SURVEY
    quirk Q1), b, and the expected x = [0.50, 0.75, 1.00] from the comment
    at ``CUDACG.cu:74-82``.  CSR arrays match ``h_valA`` / ``h_csrRowPtrA``
    / ``h_csrColIndA`` / ``h_b`` (``CUDACG.cu:94-117,136-140``).
    """
    dtype = torch_dtype(dtype)
    val = np.array([3.0, 2.0, 2.0, 2.0, 1.0], dtype=np.float64)
    indptr = np.array([0, 2, 3, 5], dtype=np.int32)
    indices = np.array([0, 2, 1, 0, 2], dtype=np.int32)
    b = np.array([3.5, 1.5, 2.0], dtype=np.float64)
    x_expected = np.array([0.5, 0.75, 1.0], dtype=np.float64)
    a = CSRMatrix.from_arrays(torch.as_tensor(val, dtype=dtype), indices,
                              indptr, (3, 3), device=device)
    return a, torch.as_tensor(b, dtype=dtype, device=a.device), x_expected


def poisson_1d_csr(n: int, scale: float = 1.0, dtype=np.float64,
                   device=None) -> CSRMatrix:
    """Tridiagonal [-1, 2, -1] * scale (Dirichlet)."""
    rows, cols, vals = [], [], []
    idx = np.arange(n)
    rows.append(idx); cols.append(idx); vals.append(np.full(n, 2.0))
    rows.append(idx[:-1]); cols.append(idx[1:]); vals.append(np.full(n - 1, -1.0))
    rows.append(idx[1:]); cols.append(idx[:-1]); vals.append(np.full(n - 1, -1.0))
    return CSRMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals) * scale, n, dtype=dtype,
                              device=device)


def poisson_2d_csr(nx: int, ny: int, scale: float = 1.0, dtype=np.float64,
                   device=None) -> CSRMatrix:
    """Assembled 2D 5-point Laplacian (Dirichlet), row-major grid order -
    the same matrix as ``Stencil2D(nx, ny, scale)``."""
    n = nx * ny
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    lin = (i * ny + j).ravel()
    i, j = i.ravel(), j.ravel()
    rows = [lin]
    cols = [lin]
    vals = [np.full(n, 4.0)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = i + di, j + dj
        ok = (ni >= 0) & (ni < nx) & (nj >= 0) & (nj < ny)
        rows.append(lin[ok])
        cols.append((ni * ny + nj)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return CSRMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals) * scale, n, dtype=dtype,
                              device=device)


def poisson_3d_csr(nx: int, ny: int, nz: int, scale: float = 1.0,
                   dtype=np.float64, device=None) -> CSRMatrix:
    """Assembled 3D 7-point Laplacian (Dirichlet), row-major grid order."""
    n = nx * ny * nz
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    lin = ((i * ny + j) * nz + k).ravel()
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    rows = [lin]
    cols = [lin]
    vals = [np.full(n, 6.0)]
    for di, dj, dk in ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                       (0, 0, -1), (0, 0, 1)):
        ni, nj, nk = i + di, j + dj, k + dk
        ok = ((ni >= 0) & (ni < nx) & (nj >= 0) & (nj < ny)
              & (nk >= 0) & (nk < nz))
        rows.append(lin[ok])
        cols.append(((ni * ny + nj) * nz + nk)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return CSRMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals) * scale, n, dtype=dtype,
                              device=device)


def poisson_2d_operator(nx: int, ny: int, scale: float = 1.0,
                        dtype=torch.float32, backend: str = "xla",
                        device=None) -> Stencil2D:
    return Stencil2D.create(nx, ny, scale=scale, dtype=dtype,
                            backend=backend, device=device)


def poisson_3d_operator(nx: int, ny: int, nz: int, scale: float = 1.0,
                        dtype=torch.float32, backend: str = "xla",
                        device=None) -> Stencil3D:
    return Stencil3D.create(nx, ny, nz, scale=scale, dtype=dtype,
                            backend=backend, device=device)
