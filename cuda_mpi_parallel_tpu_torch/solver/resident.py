"""Solver-level entry for the one-launch resident CG engine.

Counterpart of the JAX package's ``solver/resident.py``: ``cg_resident``
runs the entire solve as ONE launch of the hand kernel B10
(``ops/cuda/resident.py``, ``csrc/resident.cu``) and adapts its raw
outputs to the ``CGResult`` contract; ``resident_eligible`` is the one
predicate ``solve(engine="resident"|"auto")`` routes by.

Scope: f32 ``Stencil2D``/``Stencil3D`` whose working planes fit the
card's L2 - five, or seven with a preconditioner, six for ``cg1``
(1024^2 and 128^3 fit five and six; 1024^2 fits seven, 128^3 does not;
2048^2, 256^3 and 4096^2 take the streaming engine) - ``x0`` none or
f32, ``method="cg"`` with ``m`` None or a ``ChebyshevPreconditioner``
built over the stencil being solved, applied inside the kernel, or the
unpreconditioned ``method="cg1"`` on the kernel's Chronopoulos-Gear
form.  The iteration count lands on a ``check_every`` block boundary,
as ``cg(check_every=k)``'s does; ``converged`` and ``healthy`` come
from inside the kernel.

``cg_resident_df64`` is the f64 lane's one-launch engine (the JAX
``cg_resident_df64``, kernel B11): any stencil whose five float64 planes
(seven with the in-kernel Chebyshev) fit the L2 - 1024^2 and cubes to
108^3; 768 x 1024 with the preconditioner - with the df64 solver's
threshold and statuses and a ``DF64CGResult``.
"""
from __future__ import annotations

import math

import torch

from ..models.operators import Stencil2D, Stencil3D
from ..models.precond import (
    ChebyshevPreconditioner,
    _chebyshev_match_status,
    _fused_chebyshev_degree,
)
from ..ops import df64 as df
from ..ops.cuda.resident import (
    cg_resident_2d,
    cg_resident_3d,
    cg_resident_df64_2d,
    cg_resident_df64_3d,
    supports_resident_2d,
    supports_resident_3d,
    supports_resident_df64_2d,
    supports_resident_df64_3d,
)
from . import df64 as _df64
from .cg import CGResult, _note_engine
from .status import CGStatus


def supports_resident(a, preconditioned: bool = False,
                      warm_start: bool = False, cg1: bool = False) -> bool:
    """True if ``cg_resident`` can run this operator: an f32 2D/3D
    stencil whose grid passes the capacity gate of its device
    (``preconditioned`` counts the in-kernel Chebyshev's planes, ``cg1``
    the Chronopoulos-Gear kernel's).  ``warm_start`` costs no plane: the
    kernel reads x0 only at init, into x's plane - as in the JAX
    package, where it is plane-neutral too - so it changes nothing."""
    if not isinstance(a, (Stencil2D, Stencil3D)) or a.dtype != torch.float32:
        return False
    check = supports_resident_2d if len(a.grid) == 2 else supports_resident_3d
    return check(*a.grid, itemsize=4, device=a.device,
                 preconditioned=preconditioned, cg1=cg1)


def _dtype_of(v):
    return v.dtype if isinstance(v, torch.Tensor) else torch.as_tensor(v).dtype


def resident_eligible(a, b=None, m=None, *, method: str = "cg",
                      record_history: bool = False, x0=None,
                      resume_from=None, return_checkpoint: bool = False,
                      compensated: bool = False) -> bool:
    """Can this solve run on the resident engine?  One predicate for
    ``solve(engine=...)``: the operator gate (with the preconditioned
    or the cg1 plane count), an f32 rhs and x0 (or none), ``m`` None or
    a ``ChebyshevPreconditioner`` built over ``a`` with ``method="cg"``,
    or ``method="cg1"`` with ``m`` None; no checkpointing or compensated
    dots.

    ``record_history=True`` is not eligible: the resident trace is
    check-block granular while the general solver's is per-iteration, and
    ``engine="auto"`` must never change what a returned field means;
    ``solve(engine="resident", record_history=True)`` asks for it
    explicitly."""
    chebyshev = isinstance(m, ChebyshevPreconditioner)
    if m is not None and not chebyshev:
        return False
    if method not in ("cg", "cg1"):
        return False
    if method == "cg1" and m is not None:
        return False  # the kernel's cg1 form is unpreconditioned
    # operator gate first: the match reads grid and scale, which only
    # stencils have
    if not supports_resident(a, preconditioned=chebyshev,
                             cg1=method == "cg1"):
        return False
    if chebyshev and _chebyshev_match_status(a, m) != "match":
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
    interpret: bool = False,
) -> CGResult:
    """Solve ``A x = b`` in one launch of the resident kernel.

    Arguments mirror ``solver.cg``: absolute ``tol`` (quirk Q3) and
    ``rtol``, ``maxiter`` (sizes the block loop), ``check_every`` (the
    check block; the count lands on a block boundary), ``iter_cap`` (a
    cap <= maxiter, number or tensor), ``x0`` (``None`` = the copy-only
    init).  ``b`` is flat or grid-shaped f32 and is moved to ``a``'s
    device; ``x`` comes back in ``b``'s shape.  ``m``: ``None`` or a
    ``ChebyshevPreconditioner`` built over THIS operator, whose
    polynomial the kernel applies (``degree - 1`` extra stencil passes
    and grid barriers per iteration).  ``method="cg1"``: the
    Chronopoulos-Gear kernel (``m`` must be ``None``).
    ``record_history=True`` returns
    ||r|| at index 0 and at every block boundary the solve reached, NaN
    elsewhere.  ``interpret=True`` runs the kernel's plain twin instead
    of launching it (on any device) - an explicit request, as the JAX
    package's interpret mode is; the default never does.
    """
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"cg_resident needs a Stencil2D or Stencil3D operator, got "
            f"{type(a).__name__} - use solver.cg for general operators")
    degree = _fused_chebyshev_degree(a, m, "cg_resident")
    lmin, lmax = (m.lmin, m.lmax) if degree else (0.0, 1.0)
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
    if method == "cg1" and m is not None:
        raise ValueError(
            "cg_resident method='cg1' is unpreconditioned (the "
            "preconditioned Chronopoulos-Gear form needs a third "
            "reduction)")
    _note_engine("resident", method, check_every)
    kernel_fn = cg_resident_2d if len(grid) == 2 else cg_resident_3d
    x_grid, iters, rr, indef, conv, health, hist = kernel_fn(
        a.scale, b_grid, x0=x0, tol=tol, rtol=rtol, maxiter=maxiter,
        check_every=check_every, iter_cap=iter_cap, precond_degree=degree,
        lmin=lmin, lmax=lmax, method=method, interpret=interpret)

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


def supports_resident_df64(a, preconditioned: bool = False) -> bool:
    """True if ``cg_resident_df64`` can run this operator: a 2D/3D
    stencil (any stored dtype) whose float64 planes - five, seven with
    the in-kernel Chebyshev (``preconditioned``) - fit the L2 of its
    device."""
    if isinstance(a, Stencil2D):
        return supports_resident_df64_2d(*a.grid, device=a.device,
                                         preconditioned=preconditioned)
    if isinstance(a, Stencil3D):
        return supports_resident_df64_3d(*a.grid, device=a.device,
                                         preconditioned=preconditioned)
    return False


def cg_resident_df64(
    a,
    b,
    x0=None,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 32,
    iter_cap=None,
    preconditioner=None,
    precond_degree: int = 4,
    record_history: bool = False,
    interpret: bool = False,
):
    """f64-class CG entirely inside one launch of B11.

    Arguments and trajectory semantics mirror ``solver.df64.cg_df64``
    (the threshold ``max(tol^2, rtol^2 ||r0||^2)``, ``method="cg"``).
    ``b`` and ``x0`` may be float64 data, an ``(hi, lo)`` pair or
    anything upcast from f32, flat or grid-shaped; ``x0 = None`` takes
    the copy-only init, else the kernel computes ``r0 = b - A x0``.  The
    solution comes back flat in a ``DF64CGResult``.
    ``preconditioner``: ``None`` or ``"chebyshev"`` - the
    ``precond_degree``-term polynomial applied inside the kernel on the
    interval of ``solver.df64.chebyshev_interval``.
    ``record_history=True`` returns the check-block-granular ||r|| trace
    (the f32 hi word), laid out as :func:`cg_resident`'s.
    ``interpret=True`` runs B11's plain twin, as for :func:`cg_resident`.
    """
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"cg_resident_df64 needs a Stencil2D or Stencil3D operator, "
            f"got {type(a).__name__} - use solver.df64.cg_df64 for "
            f"general operators")
    if preconditioner not in (None, "chebyshev"):
        raise ValueError(
            f"cg_resident_df64 supports preconditioner=None or "
            f"'chebyshev', got {preconditioner!r} - use "
            f"solver.df64.cg_df64 for jacobi/mg")
    degree = precond_degree if preconditioner == "chebyshev" else 0
    theta = delta = 1.0
    if degree:
        theta, delta = (df.pair_to_f64(*pair).to(a.device)
                        for pair in _df64.chebyshev_interval(a))
    grid = tuple(a.grid)
    n_cells = math.prod(grid)

    def to_grid(v, what):
        v = _df64._coerce_rhs_df(tuple(v) if isinstance(v, list) else v)
        v = v.to(a.device)
        if v.ndim == 1:
            if v.shape[0] != n_cells:
                raise ValueError(f"{what} length {v.shape[0]} != grid "
                                 f"{grid}")
            return v.reshape(grid)
        if tuple(v.shape) != grid:
            raise ValueError(f"{what} shape {tuple(v.shape)} != grid {grid}")
        return v

    b_grid = to_grid(b, "rhs")
    x0_grid = None if x0 is None else to_grid(x0, "x0")
    _note_engine("resident-df64", "cg", check_every)
    kernel_fn = cg_resident_df64_2d if len(grid) == 2 else cg_resident_df64_3d
    x_grid, iters, rr, indef, conv, health, hist = kernel_fn(
        a.scale.double(), b_grid, x0=x0_grid, tol=tol, rtol=rtol,
        maxiter=maxiter, check_every=check_every, iter_cap=iter_cap,
        precond_degree=degree, theta=theta, delta=delta,
        interpret=interpret)
    history = None
    if record_history:
        # the trace of the f32 hi word, as the JAX kernel keeps it
        history = _expand_block_history(hist.float(), maxiter, check_every,
                                        iter_cap)
    converged = conv.to(torch.bool)
    dev = x_grid.device
    status = torch.where(
        ~health.to(torch.bool),
        torch.tensor(int(CGStatus.BREAKDOWN), dtype=torch.int32, device=dev),
        torch.where(converged,
                    torch.tensor(int(CGStatus.CONVERGED), dtype=torch.int32,
                                 device=dev),
                    torch.tensor(int(CGStatus.MAXITER), dtype=torch.int32,
                                 device=dev)))
    return _df64._result(x_grid.reshape(-1), iters, rr, converged, status,
                         indef.to(torch.bool), history)


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
