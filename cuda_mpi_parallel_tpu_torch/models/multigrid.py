"""Geometric multigrid V-cycle preconditioner for the stencil operators.

Counterpart of the JAX package's ``models/multigrid.py``.  The reference
solves with bare CG (``CUDACG.cu:269-352``); on the Poisson problems
multigrid preconditioning changes the algorithm's complexity: CG alone
needs O(grid extent) iterations on the Laplacian, MG-preconditioned CG
O(1) (the JAX package measured 12 -> 16 iterations from 64^2 to 512^2 at
rtol 1e-8; the tests hold the grid independence).

* **Hierarchy**: cell-centered 2x-per-axis coarsening.  Every level is
  the same matrix-free unit stencil at a quarter of the finer level's
  scale (the transfers have unit row sums, so ``R A_h P`` is the unit
  stencil at scale/4 on smooth fields).  The finest level is the
  caller's operator and keeps its backend (``backend="pallas"``: the
  hand kernel B1/B2 on the card); the coarse levels take
  ``backend="xla"``, plain torch shifted adds, as the JAX package leaves
  them to XLA.
* **Transfers**: separable cell-centered bilinear interpolation
  (per-axis weights 3/4, 1/4) and its adjoint over 2, full weighting
  (1/8, 3/8, 3/8, 1/8): pads, multiply-adds in the JAX order and an
  interleave by ``torch.stack``.
* **Smoother**: weighted Jacobi, ``z + w * (r - A z)`` with
  ``w = omega / diag``; the stencil's diagonal is the constant
  ``4 * scale`` (2D) or ``6 * scale`` (3D), a 0-d device tensor, so no
  sweep reads the host.  Pre- and post-sweep counts are equal, which
  makes the cycle symmetric; ``omega * lmax(D^-1 A) < 2`` makes it
  positive definite, so it serves inside plain CG.  A sweep from zero is
  ``w * r``: ``A 0`` is exactly zero, so the cycle skips that product
  and keeps the JAX cycle's values.  One V-cycle applies the finest
  operator twice (the residual before the restriction and the
  post-sweep, at ``sweeps=1``).
* **Distributed**: inside a comm scope (``parallel.comm``) the same
  cycle runs on ``DistStencil2D/3D`` slabs, each block carrying the
  shard axis first (``(L, *local_grid)``).  Coarsening halves the local
  leading extent; each level's matvec does its own halo exchange and
  the transfers exchange one plane along the partitioned axis.  When
  the local extent cannot halve any further the residual is
  ``all_gather``-ed once a cycle and the hierarchy continues on the
  replicated global grid (``global_ops``), so the distributed hierarchy
  is the single-device one.  Pencil blocks (``DistStencil3DPencil``)
  work the same way with TWO partitioned grid axes: the transfers
  exchange halos over both mesh axes and the gather level all-gathers
  along both.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .operators import LinearOperator, Stencil2D, Stencil3D

#: per-level scale factor of the rediscretized coarse operator
_COARSE_SCALE = 0.25

#: the stencil's constant diagonal over its scale, by grid rank
_CENTRE = {2: 4.0, 3: 6.0}


def _can_halve(grid, min_extent: int) -> bool:
    return not any(g % 2 or g // 2 < min_extent for g in grid)


def _level_ops(a, min_extent: int, max_levels: int):
    """Operator hierarchies by halving grid extents, finest first.

    Returns ``(ops, global_ops)``.  For ``Stencil2D/3D``, ``global_ops``
    is empty and ``ops`` halves until an extent goes odd or would drop
    below ``min_extent``.  For ``DistStencil2D/3D`` slabs, ``ops`` halves
    the local leading extent as far as it can; if the global grid can
    still coarsen past that point, ``global_ops`` continues with
    replicated single-device stencils (applied once after one
    ``all_gather``, see ``_gather_level``), so the hierarchy has the
    single-device depth.  Coarse levels take ``backend="xla"``.
    """
    from ..parallel.operators import (
        DistStencil2D,
        DistStencil3D,
        DistStencil3DPencil,
    )

    def _replicated(scale, ggrid, dtype_name, budget):
        """Replicated single-device continuation of a distributed
        hierarchy, starting one level below the global grid ``ggrid``."""
        if budget <= 0 or not _can_halve(ggrid, min_extent):
            return ()
        cls2 = Stencil2D if len(ggrid) == 2 else Stencil3D
        out = [cls2(scale=scale * _COARSE_SCALE,
                    grid=tuple(g // 2 for g in ggrid),
                    backend="xla", _dtype_name=dtype_name)]
        while len(out) < budget and _can_halve(out[-1].grid, min_extent):
            prev = out[-1]
            out.append(dataclasses.replace(
                prev, scale=prev.scale * _COARSE_SCALE,
                grid=tuple(g // 2 for g in prev.grid)))
        return tuple(out)

    ops = [a]
    global_ops = ()
    while len(ops) + len(global_ops) < max_levels:
        op = ops[-1]
        if isinstance(op, (Stencil2D, Stencil3D)):
            if not _can_halve(op.grid, min_extent):
                break
            coarse = dataclasses.replace(
                op, scale=op.scale * _COARSE_SCALE,
                grid=tuple(g // 2 for g in op.grid), backend="xla")
        elif isinstance(op, (DistStencil2D, DistStencil3D)):
            lg = op.local_grid
            if _can_halve(lg, min_extent):
                coarse = dataclasses.replace(
                    op, scale=op.scale * _COARSE_SCALE,
                    local_grid=tuple(g // 2 for g in lg), backend="xla")
            else:
                # local extent exhausted: continue on the replicated
                # global grid if it can still coarsen
                ggrid = (lg[0] * op.n_shards,) + tuple(lg[1:])
                global_ops = _replicated(op.scale, ggrid, op._dtype_name,
                                         max_levels - len(ops))
                break
        elif isinstance(op, DistStencil3DPencil):
            lg = op.local_grid
            if _can_halve(lg, min_extent):
                coarse = dataclasses.replace(
                    op, scale=op.scale * _COARSE_SCALE,
                    local_grid=tuple(g // 2 for g in lg))
            else:
                ggrid = (lg[0] * op.shards[0], lg[1] * op.shards[1], lg[2])
                global_ops = _replicated(op.scale, ggrid, op._dtype_name,
                                         max_levels - len(ops))
                break
        else:
            raise TypeError(
                f"multigrid supports Stencil2D/3D, DistStencil2D/3D and "
                f"DistStencil3DPencil, got {type(op).__name__}")
        ops.append(coarse)
    return tuple(ops), tuple(global_ops)


def _op_grid(op) -> Tuple[int, ...]:
    return tuple(op.grid if hasattr(op, "grid") else op.local_grid)


def _op_dist(op):
    """(axis_name, n_shards) for distributed stencil blocks, else None."""
    if hasattr(op, "axis_name") and getattr(op, "n_shards", 1) > 1:
        return op.axis_name, op.n_shards
    return None


def _axis_dists(op) -> Tuple:
    """Per-grid-axis ``(mesh_axis_name, n_shards) | None``: slabs
    partition grid axis 0 only; pencils axes 0 and 1, each over its own
    mesh axis."""
    ndim = len(_op_grid(op))
    if hasattr(op, "axis_names"):  # DistStencil3DPencil
        return ((op.axis_names[0], op.shards[0]),
                (op.axis_names[1], op.shards[1])) + (None,) * (ndim - 2)
    return (_op_dist(op),) + (None,) * (ndim - 1)


# The transfers take blocks shaped ``(L, *grid)``: ``L`` is 1 on a single
# device and the local shard count inside a comm scope; grid axis ``ax``
# is tensor dim ``ax + 1`` and the leading axis is left alone.


def _pad_axis0(u: torch.Tensor, dist) -> torch.Tensor:
    """Pad grid axis 0 (dim 1) with one plane per side: the neighbour
    shards' planes when partitioned (``exchange_halo``), zeros
    (Dirichlet) at the global domain edges."""
    if dist is None:
        return F.pad(u, [0, 0] * (u.ndim - 2) + [1, 1])
    from ..parallel.halo import exchange_halo

    axis_name, n_shards = dist
    lo, hi = exchange_halo(u, axis_name, n_shards)
    return torch.cat([lo, u, hi], dim=1)


def _p1d(c: torch.Tensor, axis: int, dist=None) -> torch.Tensor:
    """Cell-centered bilinear prolongation along grid ``axis``: nc -> 2nc.

    Fine cell 2I gets 3/4 c(I) + 1/4 c(I-1); fine cell 2I+1 gets
    3/4 c(I) + 1/4 c(I+1); out-of-range neighbours are zero (Dirichlet)
    or the neighbour shard's plane (``dist``).
    """
    cm = torch.movedim(c, axis + 1, 1)
    pad = _pad_axis0(cm, dist)
    even = 0.75 * cm + 0.25 * pad[:, :-2]
    odd = 0.75 * cm + 0.25 * pad[:, 2:]
    out = torch.stack([even, odd], dim=2).reshape(
        (cm.shape[0], -1) + tuple(cm.shape[2:]))
    return torch.movedim(out, 1, axis + 1)


def _r1d(f: torch.Tensor, axis: int, dist=None) -> torch.Tensor:
    """Full-weighting restriction along grid ``axis`` (adjoint of
    ``_p1d`` over 2): coarse I gets 3/8 (f(2I) + f(2I+1)) + 1/8 (f(2I-1)
    + f(2I+2))."""
    fm = torch.movedim(f, axis + 1, 1)
    lead, n2 = fm.shape[:2]
    halves = (lead, n2 // 2, 2) + tuple(fm.shape[2:])
    pad = _pad_axis0(fm, dist)
    pairs = fm.reshape(halves)
    left = pad[:, :-2].reshape(halves)[:, :, 0]    # f(2I-1)
    right = pad[:, 2:].reshape(halves)[:, :, 1]    # f(2I+2)
    out = 0.375 * (pairs[:, :, 0] + pairs[:, :, 1]) + 0.125 * (left + right)
    return torch.movedim(out, 1, axis + 1)


def _restrict(r: torch.Tensor, fine_grid, dists=None) -> torch.Tensor:
    f = r.reshape((-1,) + tuple(fine_grid))
    for ax in range(len(fine_grid)):
        f = _r1d(f, ax, dists[ax] if dists else None)
    return f.reshape(-1)


def _prolong(e: torch.Tensor, fine_grid, dists=None) -> torch.Tensor:
    c = e.reshape((-1,) + tuple(g // 2 for g in fine_grid))
    for ax in range(len(fine_grid)):
        c = _p1d(c, ax, dists[ax] if dists else None)
    return c.reshape(-1)


@dataclasses.dataclass(frozen=True)
class MultigridPreconditioner(LinearOperator):
    """One symmetric V(nu, nu) cycle of geometric multigrid as M^-1."""

    ops: Tuple  # level operators, finest first
    global_ops: Tuple = ()  # replicated coarse continuation (distributed)
    omega: float = 0.8
    pre_sweeps: int = 1
    post_sweeps: int = 1
    coarse_sweeps: int = 16

    def __post_init__(self):
        # each level's smoother weight, made once per (level, dtype)
        object.__setattr__(self, "_weights", {})

    @classmethod
    def from_operator(
        cls,
        a,
        *,
        omega: float = 0.8,
        sweeps: int = 1,
        coarse_sweeps: int = 16,
        min_extent: int = 2,
        max_levels: int = 16,
    ) -> "MultigridPreconditioner":
        """Build the hierarchy from a (Dist)Stencil2D/3D operator.

        ``sweeps`` sets both the pre- and the post-smoothing count (they
        must be equal for symmetry, so only one knob is exposed).
        """
        ops, global_ops = _level_ops(a, min_extent, max_levels)
        return cls(ops=ops, global_ops=global_ops, omega=omega,
                   pre_sweeps=sweeps, post_sweeps=sweeps,
                   coarse_sweeps=coarse_sweeps)

    @property
    def n_levels(self) -> int:
        return len(self.ops) + len(self.global_ops)

    @property
    def shape(self):
        return self.ops[0].shape

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    def matvec(self, r):
        return self._vcycle(0, r)

    def _weight(self, op, dtype) -> torch.Tensor:
        """``omega / diag`` of ``op``'s constant diagonal as a 0-d device
        tensor: omega in ``r``'s dtype times ``1 / diag``, as the JAX
        cycle forms it."""
        key = (id(op), dtype)
        w = self._weights.get(key)
        if w is None:
            inv_diag = 1.0 / (_CENTRE[len(_op_grid(op))] * op.scale)
            w = torch.tensor(self.omega, dtype=dtype) * inv_diag
            self._weights[key] = w
        return w

    def _smooth(self, op, z, r, sweeps: int):
        """``sweeps`` weighted-Jacobi sweeps; ``z=None`` starts from
        zero, where a sweep is ``w * r``."""
        w = self._weight(op, r.dtype)
        for _ in range(sweeps):
            z = w * r if z is None else z + w * (r - op @ z)
        return torch.zeros_like(r) if z is None else z

    def _vcycle(self, level: int, r, ops=None):
        ops = self.ops if ops is None else ops
        op = ops[level]
        last = level == len(ops) - 1
        if last and ops is self.ops and self.global_ops:
            # distributed gather level: the local extent cannot halve
            # further, but the global grid can
            return self._gather_level(op, r)
        if last:
            # coarsest level: omega-Jacobi iterations from z0 = 0, a
            # fixed symmetric polynomial in A
            return self._smooth(op, None, r, self.coarse_sweeps)
        grid = _op_grid(op)
        dists = _axis_dists(op)
        z = self._smooth(op, None, r, self.pre_sweeps)
        rc = _restrict(r - op @ z, grid, dists)
        ec = self._vcycle(level + 1, rc, ops)
        z = z + _prolong(ec, grid, dists)
        return self._smooth(op, z, r, self.post_sweeps)

    def _gather_level(self, op, r):
        """The gather level of slabs (pencils:
        :meth:`_gather_level_pencil`).  Smooth locally, ``all_gather``
        the residual once (the global block, with no shard axis),
        continue the single-device hierarchy on it once, and take this
        process's shards' blocks of the prolonged correction: a reshape
        to ``(P, *local_grid)`` and a slice at its shard ids (all of
        them on a stacked mesh, the rank's on a process group)."""
        from ..parallel import comm as cm

        if hasattr(op, "axis_names"):
            return self._gather_level_pencil(op, r)
        lg = _op_grid(op)
        axis_name, n_shards = _op_dist(op)
        comm = cm.resolve(axis_name)
        ggrid = (lg[0] * n_shards,) + lg[1:]
        z = self._smooth(op, None, r, self.pre_sweeps)
        resid = comm.all_gather((r - op @ z).reshape((-1,) + lg))
        ec_g = self._vcycle(0, _restrict(resid.reshape(-1), ggrid),
                            self.global_ops)
        e_fine = _prolong(ec_g, ggrid).reshape((n_shards,) + lg)
        first = comm.shard_ids[0]
        z = z + e_fine[first:first + comm.local_count].reshape(-1)
        return self._smooth(op, z, r, self.post_sweeps)

    def _gather_level_pencil(self, op, r):
        """Smooth locally, ``all_gather`` the residual along the x axis
        and then the y axis (each shard then holds the global block),
        continue the single-device hierarchy once on one copy, and give
        each local shard its own block of the prolonged correction, at
        its axis indices times the local extents."""
        from ..parallel import comm as cm

        lnx, lny, nz = lg = op.local_grid
        (sx, sy), (ax_x, ax_y) = op.shards, op.axis_names
        ggrid = (lnx * sx, lny * sy, nz)
        z = self._smooth(op, None, r, self.pre_sweeps)
        resid = cm.resolve(ax_x).all_gather((r - op @ z).reshape((-1,) + lg))
        resid = cm.resolve(ax_y).all_gather(resid.transpose(1, 2))
        ec_g = self._vcycle(0, _restrict(resid[0].transpose(0, 1).reshape(-1),
                                         ggrid), self.global_ops)
        e_fine = _prolong(ec_g, ggrid).reshape(ggrid)
        z = z + torch.stack([
            e_fine[i * lnx:(i + 1) * lnx, j * lny:(j + 1) * lny]
            for i, j in zip(cm.shard_ids(ax_x), cm.shard_ids(ax_y))]
        ).reshape(-1)
        return self._smooth(op, z, r, self.post_sweeps)

    def diagonal(self):
        raise NotImplementedError(
            "multigrid preconditioner has no cheap explicit diagonal")
