"""Matrix Market I/O (the SuiteSparse path, BASELINE config #5).

Counterpart of the JAX package's ``models/mmio.py``.  Files are read and
written through scipy; the JAX package's optional C++ parser
(``native/``) has no counterpart here, so scipy reads every file.
"""
from __future__ import annotations

import numpy as np

from .operators import CSRMatrix


def load_matrix_market(path: str, dtype=np.float64,
                       check_symmetric: bool = True,
                       device=None) -> CSRMatrix:
    """Load a Matrix Market file as CSR on ``device`` (``None`` = cuda).

    Symmetric-stored files are expanded to full storage (CG's SpMV wants
    the whole row), columns are sorted within each row, and
    ``check_symmetric`` raises on a general-stored file that is not
    symmetric, because CG silently diverges on nonsymmetric systems (the
    reference never checks, quirk Q4).
    """
    import scipy.io
    import scipy.sparse as sp

    m = scipy.io.mmread(path)
    if not sp.issparse(m):
        m = sp.csr_matrix(m)
    m = m.tocsr()
    if m.shape[0] != m.shape[1]:
        raise ValueError(f"matrix is not square: {m.shape}")
    if check_symmetric:
        _check_symmetric(m)
    m.sort_indices()
    return CSRMatrix.from_arrays(m.data.astype(np.dtype(dtype)),
                                 m.indices.astype(np.int32),
                                 m.indptr.astype(np.int32), m.shape,
                                 device=device)


def _check_symmetric(m) -> None:
    diff = abs(m - m.T)
    if diff.nnz and diff.max() > 1e-10 * max(abs(m).max(), 1.0):
        raise ValueError(
            "matrix is not symmetric; CG requires a symmetric operator")


def save_matrix_market(path: str, a: CSRMatrix) -> None:
    """Write ``a`` (general storage) to ``path``."""
    import scipy.io
    import scipy.sparse as sp

    m = sp.csr_matrix(
        (a.data.cpu().numpy(), a.indices.cpu().numpy(),
         a.indptr.cpu().numpy()), shape=a.shape)
    scipy.io.mmwrite(path, m)
