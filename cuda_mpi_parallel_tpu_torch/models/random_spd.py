"""Random SPD test matrices (BASELINE config #1).

Counterpart of the JAX package's ``models/random_spd.py``.  The
reference has one hardcoded system (``CUDACG.cu:94-117``); these
generators make well-conditioned SPD matrices with a controllable
spectrum, so CG iteration counts are predictable in tests.  Pure numpy
and scipy on the host, with the JAX package's seeding: the same seed
gives the same matrix in both packages.
"""
from __future__ import annotations

import numpy as np

from .operators import CSRMatrix, DenseOperator, _dtype_name, torch_dtype


def random_spd_dense(n: int, *, cond: float = 100.0, seed: int = 0,
                     dtype=np.float64, device=None) -> DenseOperator:
    """Dense SPD matrix with condition number ~``cond``: A = Q diag(s) Q^T."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.geomspace(1.0, cond, n)
    a = (q * s) @ q.T
    a = 0.5 * (a + a.T)  # exact symmetry
    return DenseOperator.create(a.astype(_np_dtype(dtype)), device=device)


def random_spd_sparse(n: int, *, density: float = 0.01, seed: int = 0,
                      dtype=np.float64, device=None) -> CSRMatrix:
    """Sparse SPD via B + B^T + diagonal dominance shift."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    nnz_target = max(n, int(density * n * n))
    rows = rng.integers(0, n, nnz_target)
    cols = rng.integers(0, n, nnz_target)
    vals = rng.standard_normal(nnz_target)
    b = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = b + b.T
    # Diagonal dominance => SPD (Gershgorin).
    row_abs = np.asarray(np.abs(a).sum(axis=1)).ravel()
    a = a + sp.diags(row_abs + 1.0)
    a.sort_indices()
    return CSRMatrix.from_arrays(a.data.astype(_np_dtype(dtype)),
                                 a.indices.astype(np.int32),
                                 a.indptr.astype(np.int32), a.shape,
                                 device=device)


def _np_dtype(dtype) -> np.dtype:
    """A numpy dtype from a numpy dtype, a torch dtype or a name."""
    return np.dtype(_dtype_name(torch_dtype(dtype)))
