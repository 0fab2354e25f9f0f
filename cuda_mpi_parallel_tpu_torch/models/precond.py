"""Preconditioners beyond Jacobi: Chebyshev polynomial and block-Jacobi.

Counterpart of the JAX package's ``models/precond.py``.  The reference has
no preconditioning (``CUDACG.cu:269-352``); ``JacobiPreconditioner``
(``models/operators.py``) is the first rung above it, and this module adds
the next two:

* ``ChebyshevPreconditioner`` - a fixed-degree Chebyshev polynomial in A
  applied to the residual.  Its only ingredient is the operator's own
  matvec, so on a stencil it runs on the stencil kernels, and the
  streaming and resident engines apply it inside their own kernels (B5,
  and B10 at degree > 0).
* ``BlockJacobiPreconditioner`` - M^-1 = blockdiag(A)^-1 with dense
  blocks, inverted on the host; the application is one batched product.

Both are symmetric positive definite by construction, so CG's theory
applies to the preconditioned system.  Spectral bounds for Chebyshev come
from ``estimate_lmax``: power iteration on the device, no host read.
With ``axis_name`` the operator is one shard's block of a
row-partitioned operator and the power iteration's dots reduce over the
mesh (``ops.blas1``), so the estimate is of the global spectrum.  The
multigrid preconditioner is in ``models/multigrid.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import blas1
from ..ops.chebyshev import chebyshev_steps
from .operators import CSRMatrix, LinearOperator, _dtype_name


def estimate_lmax(
    a: LinearOperator,
    *,
    iters: int = 30,
    axis_name: Optional[str] = None,
    safety: float = 1.05,
) -> torch.Tensor:
    """Largest-eigenvalue estimate of SPD ``a`` by power iteration.

    Returns ``safety *`` (final Rayleigh quotient) as a 0-d tensor on
    ``a``'s device; nothing is read on the host.  The deterministic start
    vector ``sin(12.9898 i + 78.233) + 1.5`` has nonzero overlap with the
    dominant eigenvector of any symmetric A not specially aligned with
    it; ``iters=30`` gives ~1 % on the Poisson operators.  ``safety``
    inflates the estimate so Chebyshev's interval covers the spectrum.
    Under ``axis_name`` ``a`` is one shard's block (its local shards'
    blocks, stacked, ``parallel.comm``) and each shard starts from the
    global index of its rows, as the JAX package's does.
    """
    dtype, dev = a.dtype, a.device
    idx = torch.arange(a.shape[0], dtype=dtype, device=dev)
    if axis_name is not None:
        from ..parallel.comm import resolve

        comm = resolve(axis_name)
        n_local = a.shape[0] // comm.local_count
        idx = torch.cat([torch.arange(n_local, dtype=dtype, device=dev)
                         + float(s * n_local) for s in comm.shard_ids])
    v0 = torch.sin(idx * 12.9898 + 78.233) + 1.5
    v = v0 / torch.sqrt(blas1.dot(v0, v0, axis_name=axis_name))
    floor = torch.tensor(1e-30, dtype=dtype, device=dev)
    for _ in range(iters):
        w = a @ v
        v = w / torch.maximum(
            torch.sqrt(blas1.dot(w, w, axis_name=axis_name)), floor)
    return blas1.dot(v, a @ v, axis_name=axis_name) * safety


@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner(LinearOperator):
    """M^-1 r = p(A) r with p the ``degree``-term Chebyshev approximation
    of A^-1 on [lmin, lmax] (p has polynomial degree ``degree - 1``).

    The three-term Chebyshev semi-iteration for ``A z = r`` from z0 = 0
    (Saad, *Iterative Methods for Sparse Linear Systems*, Alg. 12.1), run
    for ``degree`` steps: a fixed polynomial in A times r, hence
    symmetric, and positive definite when [lmin, lmax] covers the
    spectrum.  ``degree=1`` is p(A) = I/theta; each application costs
    ``degree - 1`` matvecs and no reductions.  ``lmin``/``lmax`` are 0-d
    tensors on the operator's device.

    ``from_operator`` picks the bounds: lmax by power iteration,
    ``lmin = lmax / ratio`` (30, the common smoother convention).
    """

    a: LinearOperator
    lmin: torch.Tensor
    lmax: torch.Tensor
    degree: int = 4

    @classmethod
    def from_operator(
        cls,
        a: LinearOperator,
        *,
        degree: int = 4,
        ratio: float = 30.0,
        lmax: Optional[float] = None,
        lmin: Optional[float] = None,
        axis_name: Optional[str] = None,
        power_iters: int = 30,
    ) -> "ChebyshevPreconditioner":
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        dtype, dev = a.dtype, a.device
        lmax_v = (estimate_lmax(a, iters=power_iters, axis_name=axis_name)
                  if lmax is None
                  else torch.as_tensor(lmax, dtype=dtype, device=dev))
        lmin_v = (lmax_v / ratio if lmin is None
                  else torch.as_tensor(lmin, dtype=dtype, device=dev))
        return cls(a=a, lmin=lmin_v.reshape(()), lmax=lmax_v.reshape(()),
                   degree=degree)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def steps(self, dtype=None):
        """``(theta, [(c1, c2), ...])``: the interval centre and each
        step's coefficients (``ops.chebyshev.chebyshev_steps``), as 0-d
        tensors in ``dtype`` (default the interval's own)."""
        lmin, lmax = (v if dtype is None else v.to(dtype)
                      for v in (self.lmin, self.lmax))
        return chebyshev_steps(lmin, lmax, self.degree)

    def matvec(self, r):
        theta, steps = self.steps()
        d = r / theta
        z = d
        for c1, c2 in steps:
            d = c1 * d + c2 * (r - self.a @ z)
            z = z + d
        return z

    def diagonal(self):
        raise NotImplementedError(
            "polynomial preconditioner has no cheap explicit diagonal")


def _chebyshev_match_status(a, m) -> str:
    """``"match"`` if ``m``'s operator is ``a`` or the same stencil class
    with the same grid and scale, else ``"mismatch"``: the fused engines
    pair ``a``'s stencil with ``m``'s spectral interval, so both must
    describe the same matrix.  ``a`` is a 2D/3D stencil.  (The JAX
    package's third answer, a traced scale it cannot compare, does not
    arise in eager torch.)"""
    if m.a is a:
        return "match"
    if not (isinstance(m.a, type(a)) and tuple(m.a.grid) == tuple(a.grid)):
        return "mismatch"
    same = bool(m.a.scale.to(a.scale.device) == a.scale)
    return "match" if same else "mismatch"


def _fused_chebyshev_degree(a, m, engine: str) -> int:
    """The Chebyshev degree a fused engine (streaming, resident) applies
    inside its kernels for ``m`` (0 for ``None``); raises for any other
    preconditioner or for a Chebyshev built over another operator."""
    if m is None:
        return 0
    if not isinstance(m, ChebyshevPreconditioner):
        raise TypeError(
            f"{engine} supports m=None or a ChebyshevPreconditioner "
            f"(applied inside its kernels), got {type(m).__name__} - use "
            f"solver.cg for other preconditioners")
    if _chebyshev_match_status(a, m) != "match":
        raise ValueError(
            "the ChebyshevPreconditioner must be built over the same "
            "stencil operator being solved (same grid and same scale)")
    return int(m.degree)


@dataclasses.dataclass(frozen=True)
class BlockJacobiPreconditioner(LinearOperator):
    """M^-1 = blockdiag(A)^-1 with dense ``(bs, bs)`` blocks.

    The application is one batched product ``(n_blocks, bs, bs) @
    (n_blocks, bs)``.  Block size 1 is ``JacobiPreconditioner`` exactly.
    The blocks are extracted and inverted on the host (numpy): each block
    is symmetrized and inverted by dense LU; rows past n when ``bs`` does
    not divide it are padded with the identity.
    """

    inv_blocks: torch.Tensor  # (n_blocks, bs, bs)
    dim: int                  # unpadded dimension

    @classmethod
    def from_operator(cls, a, block_size: int = 8
                      ) -> "BlockJacobiPreconditioner":
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        inv = np.linalg.inv(_extract_diag_blocks(a, block_size))
        return cls(inv_blocks=torch.as_tensor(inv, device=a.device),
                   dim=a.shape[0])

    @property
    def block_size(self) -> int:
        return self.inv_blocks.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dim, self.dim)

    @property
    def dtype(self):
        return self.inv_blocks.dtype

    @property
    def device(self):
        return self.inv_blocks.device

    def matvec(self, x):
        bs = self.block_size
        n_blocks = self.inv_blocks.shape[0]
        xb = F.pad(x, (0, n_blocks * bs - self.dim)).reshape(n_blocks, bs)
        yb = torch.einsum("bij,bj->bi", self.inv_blocks, xb)
        return yb.reshape(-1)[: self.dim]

    def diagonal(self):
        d = torch.diagonal(self.inv_blocks, dim1=1, dim2=2).reshape(-1)
        return d[: self.dim]


def _extract_diag_blocks(a, bs: int) -> np.ndarray:
    """Host-side (n_blocks, bs, bs) block diagonal of ``a`` (a
    ``CSRMatrix`` or any operator small enough to make dense),
    symmetrized, identity-padded past row n, in ``a``'s dtype."""
    n = a.shape[0]
    n_blocks = -(-n // bs)
    blocks = np.tile(np.eye(bs), (n_blocks, 1, 1))
    if isinstance(a, CSRMatrix):
        data = a.data.cpu().numpy().astype(np.float64)
        cols = a.indices.cpu().numpy()
        rows = a.rows.cpu().numpy()
        in_block = rows // bs == cols // bs
        br, bc = rows[in_block], cols[in_block] % bs
        blocks[br // bs, br % bs, bc] = 0.0
        np.add.at(blocks, (br // bs, br % bs, bc), data[in_block])
    elif isinstance(a, LinearOperator):
        if n > 8192:
            raise ValueError(
                f"block-Jacobi extraction from a non-CSR operator "
                f"materializes the dense matrix; n={n} is too large - "
                f"assemble a CSRMatrix instead")
        dense = a.to_dense().cpu().numpy().astype(np.float64)
        for k in range(n_blocks):
            lo, hi = k * bs, min((k + 1) * bs, n)
            blocks[k, : hi - lo, : hi - lo] = dense[lo:hi, lo:hi]
    else:
        raise TypeError(
            f"block-Jacobi extraction supports CSRMatrix or a dense-able "
            f"operator, got {type(a).__name__}")
    blocks = 0.5 * (blocks + np.transpose(blocks, (0, 2, 1)))
    return blocks.astype(_dtype_name(a.dtype))
