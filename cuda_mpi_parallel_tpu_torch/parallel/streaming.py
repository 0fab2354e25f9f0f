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
order of the slab partials.

``solve_distributed_streaming_df64`` is the same iteration in the f64
lane (the JAX function of that name): float64 slabs through B6/B7 with
``halos=``, the pap and rr partials reduced over the mesh in the comm's
shard order, the single-device ``cg_streaming_df64``'s threshold,
statuses and ``DF64CGResult``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.operators import Stencil2D, Stencil3D
from ..ops.cuda.fused_cg import (
    fused_cg_pass_a,
    fused_cg_pass_a_df64,
    fused_cg_pass_b,
    fused_cg_pass_b_df64,
    supports_streaming,
)
from ..solver.cg import (
    CGResult,
    _flight_extra,
    _note_engine,
    _run,
    _safe_div,
    _threshold_sq,
)
from ..solver.df64 import _coerce_rhs_df, _result, _threshold
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
    ``solver.streaming.cg_streaming``; ``flight`` records the
    all-reduced scalars, the same on every shard (heartbeat stripped).
    Returns a ``CGResult`` with the global solution (flat)."""
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
    axis, n_shards, local = _slab(a, mesh, check_every)
    if flight is not None:
        flight = flight.without_heartbeat()
    _note_engine("distributed-streaming", "cg", check_every,
                 n_shards=n_shards, **_flight_extra(flight))
    comm = mesh.comm
    b = b.to(mesh.device) if isinstance(b, torch.Tensor) \
        else torch.as_tensor(np.asarray(b), device=mesh.device)
    b = comm.local_vector(b.to(torch.float32))
    lead = comm.local_count
    scale = a.scale.to(mesh.device)
    with bind(mesh):
        return _solve(
            scale, b.reshape((lead,) + local).contiguous(), comm, axis,
            n_shards, maxiter, check_every,
            passes=(fused_cg_pass_a, fused_cg_pass_b),
            threshold=lambda rr0: _threshold_sq(tol, rtol, torch.sqrt(rr0),
                                                torch.float32),
            result=_f32_result, flight=flight)


def _slab(a, mesh, check_every):
    """``(axis, n_shards, local grid)`` of a slab mesh over stencil ``a``,
    after the checks both streaming lanes make."""
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
    return mesh.axis_names[0], n_shards, local


def _solve(scale, b, comm, axis, n_shards, maxiter, check_every, *,
           passes, threshold, result, flight=None):
    """The per-shard loop on this process's stacked slabs ``b``, shared by
    both lanes: ``passes`` is the lane's ``(pass A, pass B)`` wrappers,
    ``threshold(rr0)`` its squared convergence threshold and
    ``result(x, k, rho, converged, status, indefinite, flight)`` its
    result builder (``x`` the global solution, flat)."""
    pass_a, pass_b = passes
    lead = b.shape[0]
    dev = b.device
    x = torch.zeros_like(b)
    r = b.clone()                 # pass B updates r in place
    dirs = [torch.zeros_like(b), torch.empty_like(b)]

    def psum(parts):
        return comm.psum(torch.stack(parts))

    rr0 = psum([torch.dot(r[s].reshape(-1), r[s].reshape(-1))
                for s in range(lead)])
    thresh_sq = threshold(rr0)
    state = dict(k=0, beta=torch.zeros((), dtype=b.dtype, device=dev),
                 rho=rr0, indef=torch.zeros((), dtype=torch.bool, device=dev))

    def cond(s) -> bool:
        if s["k"] >= maxiter:
            return False
        rho = s["rho"]
        return bool((rho >= thresh_sq) & (rho > 0) & torch.isfinite(rho))

    def step_ab(s):
        p_prev, p_new = dirs
        beta = s["beta"]
        r_lo, r_hi = exchange_halo(r, axis, n_shards)
        p_lo, p_hi = exchange_halo(p_prev, axis, n_shards)
        paps = [pass_a(scale, beta, r[i], p_prev[i],
                       (r_lo[i], r_hi[i], p_lo[i], p_hi[i]),
                       out=p_new[i])[1] for i in range(lead)]
        pap = psum(paps)
        indef = s["indef"] | ((pap <= 0) & (s["rho"] > 0))
        alpha = _safe_div(s["rho"], pap)
        # p_new's edge planes follow from the halos already exchanged
        pn_lo = r_lo + beta * p_lo
        pn_hi = r_hi + beta * p_hi
        rrs = [pass_b(scale, alpha, p_new[i], x[i], r[i],
                      (pn_lo[i], pn_hi[i]))[2] for i in range(lead)]
        rr = psum(rrs)
        dirs.reverse()
        k = s["k"] + 1
        beta = _safe_div(rr, s["rho"])
        return dict(k=k, beta=beta, rho=rr, indef=indef), k, rr, alpha, beta

    def fits(s) -> bool:
        return s["k"] + check_every <= maxiter

    # the recorded scalars are the all-reduced globals, the same on
    # every shard
    final, fbuf = _run(cond, step_ab, state, check_every, fits, flight,
                       dtype=b.dtype, k0=0, rr0=rr0, heartbeat_ok=False)
    rho = final["rho"]
    converged = (rho < thresh_sq) | (rho == 0)

    def code(status):
        return torch.tensor(int(status), dtype=torch.int32, device=dev)
    # the JAX engines' status order: CONVERGED, then BREAKDOWN
    status = torch.where(converged, code(CGStatus.CONVERGED),
                         torch.where(~torch.isfinite(rho),
                                     code(CGStatus.BREAKDOWN),
                                     code(CGStatus.MAXITER)))
    return result(comm.global_vector(x.reshape(-1)), final["k"], rho,
                  converged, status, final["indef"], fbuf)


def _f32_result(x, k, rho, converged, status, indefinite, flight):
    return CGResult(
        x=x, iterations=torch.tensor(k, dtype=torch.int32, device=x.device),
        residual_norm=torch.sqrt(rho), converged=converged, status=status,
        indefinite=indefinite, residual_history=None, flight=flight)


def solve_distributed_streaming_df64(
    a,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 1,
):
    """f64-lane fused streaming CG over a slab mesh: the float64 twin of
    :func:`solve_distributed_streaming` (the JAX function of this name).

    Each iteration exchanges the edge planes of r and of the previous
    direction once, runs B6 on every shard with ``(r_lo, r_hi, p_lo,
    p_hi)``, reduces the pap partials over the mesh, forms p_new's edge
    planes locally as ``r_edge + beta * p_edge`` (no third exchange),
    runs B7 on every shard with them and reduces rr.  Arguments and the
    rhs coercion as ``solver.streaming.cg_streaming_df64``; ``a``: a
    global ``Stencil2D``/``Stencil3D`` whose leading grid axis divides
    the mesh.  Returns a ``DF64CGResult`` with the global solution."""
    if mesh is None:
        mesh = make_mesh(n_devices)
    if len(mesh.axis_names) != 1:
        raise ValueError(
            "solve_distributed_streaming_df64 supports 1-D (slab) meshes")
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"solve_distributed_streaming_df64 needs a Stencil2D/"
            f"Stencil3D, got {type(a).__name__}")
    axis, n_shards, local = _slab(a, mesh, check_every)
    b64 = _coerce_rhs_df(b).to(mesh.device).reshape(-1)
    if b64.numel() != a.shape[0]:
        raise ValueError(f"rhs of {b64.numel()} entries does not match "
                         f"operator shape {a.shape}")
    _note_engine("distributed-streaming-df64", "cg", check_every,
                 n_shards=n_shards)
    comm = mesh.comm
    b64 = comm.local_vector(b64)
    lead = comm.local_count
    scale = a.scale.to(mesh.device).double()      # re-read in f64
    with bind(mesh):
        return _solve(
            scale, b64.reshape((lead,) + local).contiguous(), comm, axis,
            n_shards, maxiter, check_every,
            passes=(fused_cg_pass_a_df64, fused_cg_pass_b_df64),
            threshold=lambda rr0: _threshold(float(tol) ** 2,
                                             float(rtol) ** 2, rr0),
            result=lambda x, k, rho, conv, status, indef, fbuf: _result(
                x, k, rho, conv, status, indef, flight=fbuf))
