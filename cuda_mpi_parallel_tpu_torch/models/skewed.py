"""Skewed SPD systems for the partition planner, as numpy COO triplets
``(rows, cols, vals, n)`` that ``CSRMatrix.from_coo`` takes (the JAX
package's takes them too): a dense coupling block over a bare diagonal,
a 5-point Poisson grid with a band of heavy grid rows, and a Poisson
grid with a dense block in place of its first rows.  Beside them, the
explicit machine model ``chip_smoke.py``'s ``plan_scope`` phase and the
planner's parity scripts give every planner, so that these systems get
the same plans on every host."""
import numpy as np


#: ``telemetry.roofline.MachineModel`` fields of the explicit planner
#: model (an H100 SXM's HBM and NVLink rates and capacity, rounded):
#: plans priced by it do not depend on the host or the package
PLANNING_MODEL = dict(name="plan-scope-shared", mem_bytes_per_s=3.35e12,
                      flops_per_s=6.7e13, net_bytes_per_s=4.5e11,
                      hbm_bytes=80e9, source="table")


def skewed_block_coo(n=32, c=8):
    """The JAX ``tests/test_balance.py`` ``skewed_block_csr`` triplets:
    one dense c-row coupling block over a bare-diagonal tail."""
    rows, cols, vals = [], [], []
    for i in range(c):
        for j in range(c):
            rows.append(i)
            cols.append(j)
            vals.append(float(c) if i == j else -0.5)
    for i in range(c, n):
        rows.append(i)
        cols.append(i)
        vals.append(2.0)
    return np.array(rows), np.array(cols), np.array(vals), n


def banded_skew_coo(nx, k):
    """An ``nx x nx`` 5-point Poisson grid whose second quarter of grid
    rows (row-major rows ``[n/4, n/2)``) also couples each point to the
    ``k`` nearest points of its grid row beyond the 5-point neighbours
    (value -0.25, the diagonal raised to keep it diagonally dominant):
    ``5 + k`` entries a heavy row, an nnz max/mean of the even split
    well above 2 at P = 4, and a skew spread over a quarter of the rows,
    which a contiguous split under the planner's row cap can rebalance
    (a dense block of a few rows cannot: the cap keeps it on <= 2
    shards)."""
    n = nx * nx
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    lin, i, j = (i * nx + j).ravel(), i.ravel(), j.ravel()
    heavy = (i >= nx // 4) & (i < nx // 2)
    rows, cols = [lin], [lin]
    vals = [np.where(heavy, 4.0 + 0.5 * k, 4.0)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = i + di, j + dj
        ok = (ni >= 0) & (ni < nx) & (nj >= 0) & (nj < nx)
        rows.append(lin[ok])
        cols.append((ni * nx + nj)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    for d in range(2, k // 2 + 2):
        for s in (-d, d):
            nj = j + s
            ok = heavy & (nj >= 0) & (nj < nx)
            rows.append(lin[ok])
            cols.append((i * nx + nj)[ok])
            vals.append(np.full(int(ok.sum()), -0.25))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


def dense_block_poisson_coo(nx, c):
    """BASELINE config #2's matrix (the ``nx x nx`` 5-point Poisson grid,
    row-major) with its first ``c`` rows replaced by a dense ``c x c`` SPD
    block (diagonal ``c``, off-diagonal -0.5) uncoupled from the rest:
    the JAX ``skewed_block_csr`` skew at a Poisson system's scale."""
    n = nx * nx
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    lin, i, j = (i * nx + j).ravel(), i.ravel(), j.ravel()
    rows, cols, vals = [lin[c:]], [lin[c:]], [np.full(n - c, 4.0)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = i + di, j + dj
        ok = (ni >= 0) & (ni < nx) & (nj >= 0) & (nj < nx) & (lin >= c)
        nb = ni * nx + nj
        ok &= nb >= c
        rows.append(lin[ok])
        cols.append(nb[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    br, bc = np.meshgrid(np.arange(c), np.arange(c), indexing="ij")
    rows.append(br.ravel())
    cols.append(bc.ravel())
    vals.append(np.where(br == bc, float(c), -0.5).ravel())
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)
