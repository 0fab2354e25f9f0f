"""Distributed fused-iteration streaming CG: the fused passes B3/B4 as
the local step of a slab decomposition.

Counterpart of the JAX package's ``parallel/streaming.py``.  Each shard
streams its own slab through pass A and pass B (``ops/cuda/fused_cg.py``
with ``halos=``); the neighbour shards' edge planes, moved by halo
exchange, replace the kernels' Dirichlet zero at the slab's edges; the
two inner products reduce their slab partials over the mesh.  Per
iteration each shard exchanges the edge planes of r and of the previous
direction; p_new's edge planes follow locally from them (beta is a
global scalar), so pass B needs no third exchange.  On a stacked mesh
each pass is one launch per shard.

Trajectory: the single-device streaming engine's, up to the reduction
order of the slab partials.  ``solve_distributed_streaming_df64`` (B6/B7
with halos) is not ported yet (ROADMAP A10 residue).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.operators import Stencil2D, Stencil3D
from ..ops.cuda.fused_cg import (
    fused_cg_pass_a,
    fused_cg_pass_b,
    supports_streaming,
)
from ..solver.cg import CGResult, _blocked_while, _safe_div, _threshold_sq
from ..solver.status import CGStatus
from .halo import exchange_halo
from .comm import bind
from .mesh import Mesh, make_mesh


def solve_distributed_streaming(
    a,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 1,
    flight=None,
) -> CGResult:
    """Solve A x = b with the fused streaming passes over a slab mesh.

    ``a``: global f32 ``Stencil2D``/``Stencil3D`` whose leading grid axis
    divides the mesh.  Other arguments as
    ``solver.streaming.cg_streaming``; ``flight`` is not ported yet
    (ROADMAP A9).  Returns a ``CGResult`` with the global solution
    (flat)."""
    if mesh is None:
        mesh = make_mesh(n_devices)
    if len(mesh.axis_names) != 1:
        raise ValueError(
            "solve_distributed_streaming supports 1-D (slab) meshes; "
            "use solve_distributed for pencil decompositions")
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"solve_distributed_streaming needs a Stencil2D/Stencil3D, "
            f"got {type(a).__name__}")
    if a.dtype != torch.float32:
        raise ValueError(
            f"the streaming engine is float32-only, got {a.dtype}")
    axis = mesh.axis_names[0]
    n_shards = mesh.size
    grid = tuple(a.grid)
    if grid[0] % n_shards:
        raise ValueError(
            f"leading grid axis {grid[0]} does not divide over "
            f"{n_shards} shards")
    local = (grid[0] // n_shards,) + grid[1:]
    if not supports_streaming(local):
        raise ValueError(f"per-shard slab {local} is not a non-empty "
                         f"2D/3D grid")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if flight is not None:
        raise NotImplementedError(
            "solve_distributed_streaming: flight= is not ported yet "
            "(ROADMAP A9)")
    comm = mesh.comm
    b = b.to(mesh.device) if isinstance(b, torch.Tensor) \
        else torch.as_tensor(np.asarray(b), device=mesh.device)
    b = comm.local_vector(b.to(torch.float32))
    lead = comm.local_count
    scale = a.scale.to(mesh.device)
    with bind(mesh):
        return _solve(scale, b.reshape((lead,) + local).contiguous(), comm,
                      axis, n_shards, tol, rtol, maxiter, check_every)


def _solve(scale, b, comm, axis, n_shards, tol, rtol, maxiter, check_every):
    """The per-shard loop on this process's stacked slabs ``b``."""
    lead = b.shape[0]
    dev = b.device
    f32 = torch.float32
    x = torch.zeros_like(b)
    r = b.clone()                 # pass B updates r in place
    dirs = [torch.zeros_like(b), torch.empty_like(b)]

    def psum(parts):
        return comm.psum(torch.stack(parts))

    rr0 = psum([torch.dot(r[s].reshape(-1), r[s].reshape(-1))
                for s in range(lead)])
    thresh_sq = _threshold_sq(tol, rtol, torch.sqrt(rr0), f32)
    state = dict(k=0, beta=torch.zeros((), dtype=f32, device=dev), rho=rr0,
                 indef=torch.zeros((), dtype=torch.bool, device=dev))

    def cond(s) -> bool:
        if s["k"] >= maxiter:
            return False
        rho = s["rho"]
        return bool((rho >= thresh_sq) & (rho > 0) & torch.isfinite(rho))

    def step(s):
        p_prev, p_new = dirs
        beta = s["beta"]
        r_lo, r_hi = exchange_halo(r, axis, n_shards)
        p_lo, p_hi = exchange_halo(p_prev, axis, n_shards)
        paps = [fused_cg_pass_a(scale, beta, r[i], p_prev[i],
                                (r_lo[i], r_hi[i], p_lo[i], p_hi[i]),
                                out=p_new[i])[1] for i in range(lead)]
        pap = psum(paps)
        indef = s["indef"] | ((pap <= 0) & (s["rho"] > 0))
        alpha = _safe_div(s["rho"], pap)
        # p_new's edge planes follow from the halos already exchanged
        pn_lo = r_lo + beta * p_lo
        pn_hi = r_hi + beta * p_hi
        rrs = [fused_cg_pass_b(scale, alpha, p_new[i], x[i], r[i],
                               (pn_lo[i], pn_hi[i]))[2] for i in range(lead)]
        rr = psum(rrs)
        dirs.reverse()
        return dict(k=s["k"] + 1, beta=_safe_div(rr, s["rho"]), rho=rr,
                    indef=indef)

    def fits(s) -> bool:
        return s["k"] + check_every <= maxiter

    final = _blocked_while(cond, step, state, check_every, fits)
    rho = final["rho"]
    converged = (rho < thresh_sq) | (rho == 0)

    def code(status):
        return torch.tensor(int(status), dtype=torch.int32, device=dev)
    status = torch.where(converged, code(CGStatus.CONVERGED),
                         torch.where(~torch.isfinite(rho),
                                     code(CGStatus.BREAKDOWN),
                                     code(CGStatus.MAXITER)))
    return CGResult(
        x=comm.global_vector(x.reshape(-1)),
        iterations=torch.tensor(final["k"], dtype=torch.int32, device=dev),
        residual_norm=torch.sqrt(rho), converged=converged, status=status,
        indefinite=final["indef"], residual_history=None)
