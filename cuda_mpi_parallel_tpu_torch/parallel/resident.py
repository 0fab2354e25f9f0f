"""Distributed resident CG over a slab mesh: the whole solve of every
shard in one launch of the hand kernel B12.

Counterpart of the JAX package's ``parallel/resident.py``.
``solve_distributed_resident`` splits the grid's leading axis over a 1-D
mesh and runs ``ops.cuda.resident_dist``'s solve: per iteration the halo
exchange and the scalar allreduces happen inside the kernel, so the
whole multi-shard solve is one launch.  The P shards of a stacked mesh
on one card are P groups of CTAs of that launch; on the CPU the twin
runs the same per-shard protocol.  The multi-card lane (a process group
of several ranks, the kernel's peer table holding peer-mapped regions)
is not ported yet.

Trajectory against the single-device resident kernel: the same
recurrence; the dots accumulate per shard and then add the P partials in
shard order, so values agree to f32 reduction-order rounding.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.operators import Stencil2D, Stencil3D
from ..ops.cuda.resident_dist import (
    cg_resident_dist,
    check_shards_fit,
    supports_resident_dist,
)
from ..solver.cg import CGResult
from ..solver.status import CGStatus
from .mesh import Mesh, make_mesh


def solve_distributed_resident(
    a,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 32,
    iter_cap=None,
    m=None,
    record_history: bool = False,
    flight=None,
    detect_races: bool = False,
    interpret: bool = False,
) -> CGResult:
    """Solve ``A x = b`` with one B12 launch for all shards.

    ``a``: global f32 ``Stencil2D``/``Stencil3D`` whose leading grid axis
    divides the mesh and whose per-shard slab passes the resident gate;
    on a stacked mesh the P slabs share the card's L2, so the whole grid
    must fit too.  ``method="cg"``, x0 = 0; ``m`` None or a
    ``ChebyshevPreconditioner`` built over THIS operator (its polynomial
    runs inside the kernel on every shard, each step with its own halo
    exchange, and one more allreduce, rho = r . z, per iteration).
    ``record_history=True`` returns the check-block-granular ``||r||``
    trace (``cg_resident``'s layout).  ``interpret=True`` runs B12's
    plain twin instead of launching it.  ``detect_races`` is the JAX
    TPU simulator's race detector and has no counterpart here: it is
    accepted and changes nothing.  ``flight`` is not ported yet (ROADMAP
    A9).  Returns a ``CGResult`` with the global solution (flat).
    """
    if mesh is None:
        mesh = make_mesh(n_devices)
    if len(mesh.axis_names) != 1:
        raise ValueError(
            "solve_distributed_resident supports 1-D (slab) meshes")
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"solve_distributed_resident needs a Stencil2D/Stencil3D, "
            f"got {type(a).__name__}")
    if a.dtype != torch.float32:
        raise ValueError(
            f"the resident engine is float32-only, got {a.dtype}")
    n_shards = mesh.size
    grid = tuple(a.grid)
    if grid[0] % n_shards:
        raise ValueError(
            f"leading grid axis {grid[0]} does not divide over "
            f"{n_shards} shards")
    local_shape = (grid[0] // n_shards,) + grid[1:]
    degree = 0
    lmin = lmax = torch.zeros((), dtype=torch.float32)
    if m is not None:
        from ..models.precond import (
            ChebyshevPreconditioner,
            _chebyshev_match_status,
        )

        if not isinstance(m, ChebyshevPreconditioner):
            raise TypeError(
                f"solve_distributed_resident supports m=None or a "
                f"ChebyshevPreconditioner (applied in-kernel), got "
                f"{type(m).__name__}")
        if _chebyshev_match_status(a, m) != "match":
            raise ValueError(
                "the ChebyshevPreconditioner must be built over the "
                "same stencil operator being solved (same grid and "
                "same scale)")
        degree = int(m.degree)
        lmin, lmax = m.lmin, m.lmax
    if not supports_resident_dist(local_shape, device=mesh.device,
                                  preconditioned=degree > 0):
        raise ValueError(
            f"per-shard slab {local_shape} fails the resident gate (its "
            f"planes and exchange region must fit the card's L2)")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if flight is not None:
        raise NotImplementedError(
            "solve_distributed_resident: flight= is not ported yet "
            "(ROADMAP A9)")
    comm = mesh.comm
    if comm.kind != "stacked" and n_shards > 1:
        raise NotImplementedError(
            "solve_distributed_resident over a process group of several "
            "ranks is the multi-card B12 lane (peer-mapped exchange "
            "regions), not ported yet (ROADMAP A10 residue)")
    check_shards_fit(local_shape, comm.local_count, device=mesh.device,
                     preconditioned=degree > 0)
    b = b.to(mesh.device) if isinstance(b, torch.Tensor) \
        else torch.as_tensor(np.asarray(b), device=mesh.device)
    b = b.to(torch.float32).reshape((n_shards,) + local_shape)
    x, iters, rr, indef, conv, health, hist = cg_resident_dist(
        a.scale.to(mesh.device), b, tol=tol, rtol=rtol, maxiter=maxiter,
        check_every=check_every, iter_cap=iter_cap, degree=degree,
        lmin=lmin, lmax=lmax, interpret=interpret)
    history = None
    if record_history:
        from ..solver.resident import _expand_block_history

        history = _expand_block_history(hist, maxiter, check_every,
                                        iter_cap)
    converged = conv.to(torch.bool)
    healthy = health.to(torch.bool)
    dev = x.device

    def code(status):
        return torch.tensor(int(status), dtype=torch.int32, device=dev)
    status = torch.where(converged, code(CGStatus.CONVERGED),
                         torch.where(~healthy, code(CGStatus.BREAKDOWN),
                                     code(CGStatus.MAXITER)))
    return CGResult(x=x.reshape(-1), iterations=iters,
                    residual_norm=torch.sqrt(rr), converged=converged,
                    status=status, indefinite=indef.to(torch.bool),
                    residual_history=history)
