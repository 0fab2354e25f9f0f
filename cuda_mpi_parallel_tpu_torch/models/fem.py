"""Unstructured-FEM-like SPD generators: SuiteSparse stand-ins.

Counterpart of the JAX package's ``models/fem.py``.  BASELINE config #5
names SuiteSparse matrices (thermal2, G3_circuit, parabolic_fem) that a
machine without network access cannot download; ``random_fem_2d`` makes
matrices of the same character - finite-element Laplacians over random
planar triangulations: SPD, irregular sparsity (5-9 nonzeros a row).
Pure numpy/scipy on the host: the same seed gives the same CSR arrays as
the JAX package.
"""
from __future__ import annotations

import numpy as np

from .operators import CSRMatrix


def random_fem_2d(n_points: int, *, seed: int = 0, dtype=np.float64,
                  device=None) -> CSRMatrix:
    """SPD stiffness-like matrix over a random Delaunay triangulation.

    The graph Laplacian of the triangulation's edge graph with lognormal
    edge weights (conductances), plus a diagonal shift of 1e-3: a P1 FEM
    stiffness matrix for heterogeneous diffusion with a reaction term,
    average degree ~6.  ``device`` as for every operator (``None`` =
    cuda).
    """
    from scipy.spatial import Delaunay
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    tri = Delaunay(pts)

    # unique undirected edges of the triangulation
    s = tri.simplices
    edges = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [0, 2]]])
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    i, j = edges[:, 0], edges[:, 1]

    # conductances ~ lognormal (heterogeneous medium)
    w = np.exp(rng.standard_normal(edges.shape[0]) * 0.5).astype(np.float64)

    # Laplacian: A[i,j] = -w_ij, A[i,i] = sum_j w_ij + shift
    shift = 1e-3
    rows = np.concatenate([i, j, i, j, np.arange(n_points)])
    cols = np.concatenate([j, i, i, j, np.arange(n_points)])
    vals = np.concatenate([-w, -w, w, w, np.full(n_points, shift)])

    m = sp.coo_matrix((vals, (rows, cols)),
                      shape=(n_points, n_points)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return CSRMatrix.from_scipy(m.astype(np.dtype(dtype)), device=device)
