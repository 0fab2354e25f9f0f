"""Solver-level entry for the one-launch resident CG engine.

Counterpart of the JAX package's ``solver/resident.py``: ``cg_resident``
runs the entire solve as ONE launch of the hand kernel B10
(``ops/cuda/resident.py``, ``csrc/resident.cu``) and adapts its raw
outputs to the ``CGResult`` contract; ``resident_eligible`` is the one
predicate ``solve(engine="resident"|"auto")`` routes by.

Scope: f32 ``Stencil2D``/``Stencil3D`` whose five working planes fit the
card's L2 (1024^2 and 128^3 do; 2048^2, 256^3 and 4096^2 take the
streaming engine), ``x0`` none or f32, ``method="cg"``, ``m=None``.  The
iteration count lands on a ``check_every`` block boundary, as
``cg(check_every=k)``'s does; ``converged`` and ``healthy`` come from
inside the kernel.  ``method="cg1"`` (ROADMAP A3), the in-kernel
Chebyshev ``m=`` (A8) and ``cg_resident_df64`` (A12) are not ported yet
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from ..models.operators import Stencil2D, Stencil3D
from ..ops.cuda.resident import (
    cg_resident_2d,
    cg_resident_3d,
    supports_resident_2d,
    supports_resident_3d,
)
from .cg import CGResult
from .status import CGStatus


def supports_resident(a) -> bool:
    """True if ``cg_resident`` can run this operator: an f32 2D/3D
    stencil whose grid passes the capacity gate of its device."""
    if not isinstance(a, (Stencil2D, Stencil3D)) or a.dtype != torch.float32:
        return False
    check = supports_resident_2d if len(a.grid) == 2 else supports_resident_3d
    return check(*a.grid, itemsize=4, device=a.device)


def _dtype_of(v):
    return v.dtype if isinstance(v, torch.Tensor) else torch.as_tensor(v).dtype


def resident_eligible(a, b=None, m=None, *, method: str = "cg",
                      record_history: bool = False, x0=None,
                      resume_from=None, return_checkpoint: bool = False,
                      compensated: bool = False) -> bool:
    """Can this solve run on the resident engine?  One predicate for
    ``solve(engine=...)``: the operator gate, an f32 rhs and x0 (or none),
    ``m=None``, ``method="cg"``, no checkpointing or compensated dots.

    ``record_history=True`` is not eligible: the resident trace is
    check-block granular while the general solver's is per-iteration, and
    ``engine="auto"`` must never change what a returned field means;
    ``solve(engine="resident", record_history=True)`` asks for it
    explicitly."""
    if m is not None or method != "cg":
        return False
    if not supports_resident(a):
        return False
    if (record_history or resume_from is not None or return_checkpoint
            or compensated):
        return False
    if x0 is not None and _dtype_of(x0) != torch.float32:
        return False
    if b is not None and _dtype_of(b) != torch.float32:
        return False
    return True


def cg_resident(
    a,
    b,
    x0=None,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 32,
    iter_cap=None,
    m=None,
    record_history: bool = False,
    method: str = "cg",
) -> CGResult:
    """Solve ``A x = b`` in one launch of the resident kernel.

    Arguments mirror ``solver.cg``: absolute ``tol`` (quirk Q3) and
    ``rtol``, ``maxiter`` (sizes the block loop), ``check_every`` (the
    check block; the count lands on a block boundary), ``iter_cap`` (a
    cap <= maxiter, number or tensor), ``x0`` (``None`` = the copy-only
    init).  ``b`` is flat or grid-shaped f32 and is moved to ``a``'s
    device; ``x`` comes back in ``b``'s shape.  ``record_history=True``
    returns ||r|| at index 0 and at every block boundary the solve
    reached, NaN elsewhere.
    """
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"cg_resident needs a Stencil2D or Stencil3D operator, got "
            f"{type(a).__name__} - use solver.cg for general operators")
    if m is not None:
        raise NotImplementedError(
            "m= on the resident engine (the in-kernel Chebyshev "
            "preconditioner) is not ported yet (ROADMAP A8)")
    grid = tuple(a.grid)
    n_cells = math.prod(grid)
    b = torch.as_tensor(b, device=a.device)
    flat_in = b.ndim == 1
    if flat_in:
        if b.shape[0] != n_cells:
            raise ValueError(f"rhs length {b.shape[0]} != grid {grid}")
        b_grid = b.reshape(grid)
    else:
        if tuple(b.shape) != grid:
            raise ValueError(f"rhs shape {tuple(b.shape)} != grid {grid}")
        b_grid = b
    if b_grid.dtype != torch.float32:
        raise ValueError(
            f"cg_resident is float32-only (got {b_grid.dtype}); other "
            f"dtypes route through solver.cg")
    kernel_fn = cg_resident_2d if len(grid) == 2 else cg_resident_3d
    x_grid, iters, rr, indef, conv, health, hist = kernel_fn(
        a.scale, b_grid, x0=x0, tol=tol, rtol=rtol, maxiter=maxiter,
        check_every=check_every, iter_cap=iter_cap, method=method)

    history = None
    if record_history:
        history = _expand_block_history(hist, maxiter, check_every,
                                        iter_cap)
    converged = conv.to(torch.bool)
    healthy = health.to(torch.bool)
    dev = x_grid.device
    status = torch.where(
        ~healthy, torch.tensor(int(CGStatus.BREAKDOWN), dtype=torch.int32,
                               device=dev),
        torch.where(converged,
                    torch.tensor(int(CGStatus.CONVERGED), dtype=torch.int32,
                                 device=dev),
                    torch.tensor(int(CGStatus.MAXITER), dtype=torch.int32,
                                 device=dev)))
    return CGResult(
        x=x_grid.reshape(-1) if flat_in else x_grid, iterations=iters,
        residual_norm=torch.sqrt(rr), converged=converged, status=status,
        indefinite=indef.to(torch.bool), residual_history=history)


def cg_resident_df64(a, b, x0=None, **kwargs):
    raise NotImplementedError(
        "cg_resident_df64 (the double-float resident solve, kernel B11) is "
        "not ported yet (ROADMAP A12)")


def _expand_block_history(hist: torch.Tensor, maxiter: int,
                          check_every: int, iter_cap) -> torch.Tensor:
    """Kernel block trace -> the general solver's ``(maxiter + 1,)``
    ``residual_history`` layout: ||r|| at index 0 and at each block
    boundary the solve reached (``min((j + 1) * check_every, cap)``), NaN
    elsewhere.  Blocks that never ran carry the -1 sentinel and are
    dropped; no host sync."""
    check_every = max(1, min(check_every, maxiter))
    nblocks = -(-maxiter // check_every) if maxiter else 0
    dev = hist.device
    full = torch.full((maxiter + 2,), float("nan"), dtype=torch.float32,
                      device=dev)
    full[0] = torch.sqrt(hist[0])
    if nblocks:
        vals = hist[1:]
        cap = torch.as_tensor(maxiter if iter_cap is None else iter_cap,
                              dtype=torch.int64, device=dev)
        idx = torch.minimum(
            (torch.arange(nblocks, dtype=torch.int64, device=dev) + 1)
            * check_every, cap)
        # sentinel slots go to the spare last index and are cut off
        idx = torch.where(vals < 0, torch.full_like(idx, maxiter + 1), idx)
        full.scatter_(0, idx, torch.sqrt(torch.abs(vals)))
    return full[:maxiter + 1]
