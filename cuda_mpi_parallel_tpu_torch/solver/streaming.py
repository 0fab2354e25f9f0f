"""Solver-level entry for the fused-iteration streaming CG engine.

Counterpart of the JAX package's ``solver/streaming.py``: each CG
iteration is TWO launches, pass A and pass B (``ops/cuda/fused_cg.py``,
hand kernels B3/B4 on the card), against the general loop's separate
matvec, dots and vector updates.  Semantics mirror ``solver.cg`` (x0 = 0
fast path or ``r0 = b - A x0`` through the stencil kernel, absolute
``tol`` plus ``rtol``, ``check_every`` blocks through the SAME
``_blocked_while``, ``_safe_div`` freezing, CGStatus, per-iteration
history); iterates agree with the general solver to f32 reduction-order
rounding.

The p-update is deferred into pass A of the NEXT iteration
(p_k = r_k + beta_{k-1} p_{k-1}), so the loop carries the previous
direction and its beta; iteration 0 seeds p_0 = r_0 with beta = 0
against a zero direction.  Pass A writes p_new into the second of two
direction buffers (it must not overwrite p, whose neighbours other
blocks still read), and the two swap each iteration; pass B updates x
and r in place.

With ``m`` a ``ChebyshevPreconditioner`` built over the stencil being
solved, the preconditioned recurrence of ``solver.cg`` runs on the same
passes: at degree 1, ``z = r/theta`` folds into pass A (``theta=``) and
pass B (``with_rz=True`` sums ``rho = r . z``), so an iteration is still
two launches; at degree k >= 2, ``z = P(A) r`` takes k - 1 launches of
the Chebyshev step (B5: first, middle..., last, which also sums rho) after
pass B and once at init, and z rides the state into pass A in place of
r.  The interval scalars (theta, and each step's c1 and c2) are 0-d
tensors computed once by ``m.steps()``: nothing is read on the host
inside a check block.

Scope: f32 ``Stencil2D``/``Stencil3D``, ``m`` None or such a Chebyshev,
``method="cg"``.  The flight recorder comes with a later slice (ROADMAP
A9).  ``interpret=True`` runs the passes' plain twins instead of
launching the kernels, on any device - an explicit request, as the JAX
package's interpret mode is; the default never does.

``cg_streaming_df64`` is the f64 lane's engine (the JAX
``cg_streaming_df64``): the same two-pass iteration on float64 planes,
through B6/B7 (``fused_cg_pass_a_df64`` / ``fused_cg_pass_b_df64``),
with the df64 solver's threshold ``max(tol^2, rtol^2 ||r0||^2)``,
statuses and ``DF64CGResult``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.operators import Stencil2D, Stencil3D
from ..models.precond import (
    ChebyshevPreconditioner,
    _chebyshev_match_status,
    _fused_chebyshev_degree,
)
from ..ops import blas1
from ..ops.cuda.fused_cg import (
    fused_cg_pass_a,
    fused_cg_pass_a_df64,
    fused_cg_pass_a_plain,
    fused_cg_pass_b,
    fused_cg_pass_b_df64,
    fused_cg_pass_b_plain,
    fused_cheb_step,
    fused_cheb_step_plain,
    supports_streaming,
)
from ..ops.cuda.stencil import (
    stencil2d_apply,
    stencil2d_apply_plain,
    stencil3d_apply,
    stencil3d_apply_plain,
)
from .cg import (
    CGResult,
    _block_fits,
    _blocked_while,
    _cg_healthy,
    _cond,
    _history_init,
    _package,
    _safe_div,
    _threshold_sq,
)
from .df64 import _coerce_rhs_df, _result, _threshold
from .status import CGStatus


def supports_streaming_op(a) -> bool:
    """True if ``cg_streaming`` can run this operator: an f32
    ``Stencil2D``/``Stencil3D`` whose grid the fused-CG kernels take."""
    if not isinstance(a, (Stencil2D, Stencil3D)):
        return False
    if a.dtype != torch.float32:
        return False
    return supports_streaming(a.grid)


def _dtype_of(v):
    return v.dtype if isinstance(v, torch.Tensor) else torch.as_tensor(v).dtype


def streaming_eligible(a, b=None, m=None, *, method: str = "cg",
                       x0=None, resume_from=None,
                       return_checkpoint: bool = False,
                       compensated: bool = False,
                       record_history: bool = False) -> bool:
    """Eligibility for ``solve(engine="streaming")`` - one predicate.
    History IS supported (per-iteration).  ``m`` may be ``None`` or a
    ``ChebyshevPreconditioner`` built over ``a`` (the fused steps apply
    THIS operator's stencil, so a foreign interval would precondition
    with the wrong polynomial)."""
    del record_history  # supported at full granularity
    if m is not None and not (
            isinstance(m, ChebyshevPreconditioner)
            and isinstance(a, (Stencil2D, Stencil3D))
            and _chebyshev_match_status(a, m) == "match"):
        return False
    if method != "cg":
        return False
    if resume_from is not None or return_checkpoint or compensated:
        return False
    if not supports_streaming_op(a):
        return False
    if x0 is not None and _dtype_of(x0) != torch.float32:
        return False
    if b is not None and _dtype_of(b) != torch.float32:
        return False
    return True


class _StreamState(NamedTuple):
    k: int
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor           # the preconditioned residual (r at degree <= 1)
    p_prev: torch.Tensor      # the previous direction (zeros at k = 0)
    spare: torch.Tensor       # the other direction buffer
    beta_prev: torch.Tensor
    rho: torch.Tensor
    rr: torch.Tensor
    indefinite: torch.Tensor
    history: torch.Tensor


def _grid_of(v, grid, what: str) -> torch.Tensor:
    n_cells = math.prod(grid)
    if v.ndim == 1:
        if v.shape[0] != n_cells:
            raise ValueError(f"{what} length {v.shape[0]} != grid {grid}")
        return v.reshape(grid)
    if tuple(v.shape) != tuple(grid):
        raise ValueError(f"{what} shape {tuple(v.shape)} != grid {grid}")
    return v


def cg_streaming(
    a,
    b,
    x0=None,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 1,
    iter_cap=None,
    m=None,
    record_history: bool = False,
    flight=None,
    interpret: bool = False,
) -> CGResult:
    """Solve ``A x = b`` with the fused-iteration streaming engine.

    Arguments mirror ``solver.cg``; ``a`` must be an f32
    ``Stencil2D``/``Stencil3D``; ``b`` (flat or grid-shaped) and ``x0``
    must be f32 and are moved to ``a``'s device.  ``m``: ``None`` or a
    ``ChebyshevPreconditioner`` built over ``a`` (see the module
    docstring).  The default ``check_every=1`` matches ``solve()``:
    iteration counts equal the general solver's at equal tolerances and
    equal ``check_every``; ``check_every=32`` takes one host sync per 32
    iterations, for throughput runs.
    """
    if flight is not None:
        raise NotImplementedError(
            "flight= is not ported yet (ROADMAP A9)")
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"cg_streaming needs a Stencil2D or Stencil3D operator, got "
            f"{type(a).__name__} - use solver.cg for general operators")
    if a.dtype != torch.float32:
        raise ValueError(f"cg_streaming is float32-only (got {a.dtype})")
    grid = tuple(a.grid)
    if not supports_streaming(grid):
        raise ValueError(f"grid {grid} is not a non-empty 2D/3D grid")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    degree = _fused_chebyshev_degree(a, m, "cg_streaming")
    dev = a.device
    b = torch.as_tensor(b, device=dev)
    flat_in = b.ndim == 1
    b_grid = _grid_of(b, grid, "rhs")
    if b_grid.dtype != torch.float32:
        raise ValueError(
            f"cg_streaming is float32-only, got rhs {b_grid.dtype}")
    scale = a.scale
    if x0 is None:
        x = torch.zeros(grid, dtype=torch.float32, device=dev)
        r = b_grid.clone()         # pass B updates r in place; b is kept
    else:
        x0 = _grid_of(torch.as_tensor(x0, device=dev), grid, "x0")
        if x0.dtype != torch.float32:
            raise ValueError(f"x0 must be float32, got {x0.dtype}")
        x = x0.clone()
        if interpret:
            apply = (stencil2d_apply_plain if len(grid) == 2
                     else stencil3d_apply_plain)
        else:
            apply = stencil2d_apply if len(grid) == 2 else stencil3d_apply
        r = b_grid - apply(x0.contiguous(), scale)
    x, r = x.contiguous(), r.contiguous()
    check_every = min(check_every, max(maxiter, 1))
    cap = maxiter if iter_cap is None else int(iter_cap)

    theta = cheb_apply = None
    if degree:
        theta, steps = m.steps(torch.float32)
        theta = theta.to(dev)
    if degree >= 2:
        cheb_apply = _chebyshev(scale, theta,
                                [(c1.to(dev), c2.to(dev)) for c1, c2 in steps],
                                [torch.empty_like(x) for _ in range(3)],
                                fused_cheb_step_plain if interpret
                                else fused_cheb_step)
    pass_a = fused_cg_pass_a_plain if interpret else fused_cg_pass_a
    pass_b = fused_cg_pass_b_plain if interpret else fused_cg_pass_b

    rr0 = blas1.dot(r, r)
    nrm0 = torch.sqrt(rr0)
    thresh_sq = _threshold_sq(tol, rtol, nrm0, torch.float32)
    if degree >= 2:
        z0, rho0 = cheb_apply(r)
    elif degree == 1:
        z0, rho0 = r, blas1.dot(r, r / theta)
    else:
        z0, rho0 = r, rr0
    state = _StreamState(
        k=0, x=x, r=r, z=z0,
        p_prev=torch.zeros_like(x), spare=torch.empty_like(x),
        beta_prev=torch.zeros((), dtype=torch.float32, device=dev),
        rho=rho0, rr=rr0,
        indefinite=torch.zeros((), dtype=torch.bool, device=dev),
        history=_history_init(record_history, maxiter, torch.float32, 0,
                              nrm0))

    def step(s: _StreamState) -> _StreamState:
        # p = z + beta p; at degree 1 pass A forms z = r/theta itself
        p, pap = pass_a(scale, s.beta_prev, s.z, s.p_prev,
                        theta=theta if degree == 1 else None, out=s.spare)
        indefinite = s.indefinite | ((pap <= 0) & (s.rr > 0))  # quirk Q1
        alpha = _safe_div(s.rho, pap)                          # :311
        if degree == 1:
            x, r, rr, rho = pass_b(scale, alpha, p, s.x, s.r,
                                   theta=theta, with_rz=True)
            z = r
        else:
            x, r, rr = pass_b(scale, alpha, p, s.x, s.r)
            z, rho = cheb_apply(r) if degree else (r, rr)
        beta = _safe_div(rho, s.rho)                           # :336-339
        k = s.k + 1
        if record_history:
            s.history[k] = torch.sqrt(rr)
        return _StreamState(k=k, x=x, r=r, z=z, p_prev=p, spare=s.p_prev,
                            beta_prev=beta, rho=rho, rr=rr,
                            indefinite=indefinite, history=s.history)

    final = _blocked_while(_cond(maxiter, cap, thresh_sq), step, state,
                           check_every,
                           _block_fits(maxiter, cap, check_every))
    res = _package(final, _cg_healthy(final), thresh_sq, record_history)
    return dataclasses.replace(res, x=res.x.reshape(-1)) if flat_in else res


def _chebyshev(scale, theta, steps, bufs, step_fn=fused_cheb_step):
    """``r -> (z, rho)``: z = P(A) r by one launch of the Chebyshev step
    per ``(c1, c2)`` in ``steps`` (``ChebyshevPreconditioner.steps``),
    and rho = r . z from the last.  ``bufs``: three grids - two z buffers
    that the steps alternate (a step must not write the z it reads) and
    d, updated in place.  The returned z lies in one of the z buffers,
    overwritten by the next call, which is when the solver no longer
    needs it.  ``step_fn``: the B5 wrapper, or its twin."""
    zbufs, d = bufs[:2], bufs[2]
    n = len(steps)

    def apply(r):
        z = r
        for j, (c1, c2) in enumerate(steps):
            first, last = j == 0, j == n - 1
            out = step_fn(scale, theta, c1, c2, z,
                          None if first else r, None if first else d,
                          first=first, last=last, out=zbufs[j % 2], d_out=d)
            z = out[0]
        return z, out[2]
    return apply


# -- the f64 lane ---------------------------------------------------------------


def supports_streaming_df64(a) -> bool:
    """True if ``cg_streaming_df64`` can run this operator: a
    ``Stencil2D``/``Stencil3D`` of any stored dtype (the solve re-reads
    the scale in float64) on a non-empty grid - the f32 engine's rule,
    since the tile walk masks ragged edges at either width."""
    if not isinstance(a, (Stencil2D, Stencil3D)):
        return False
    return supports_streaming(a.grid)


def cg_streaming_df64(
    a,
    b,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    check_every: int = 1,
    iter_cap=None,
    interpret: bool = False,
):
    """f64-class fused-iteration streaming CG: the two-pass iteration of
    :func:`cg_streaming` on float64 planes (B6/B7 on the card).

    Arguments and the rhs coercion mirror ``solver.df64.cg_df64``
    (threshold ``max(tol^2, rtol^2 ||r0||^2)``; ``b`` flat or
    grid-shaped, a float64 array, an ``(hi, lo)`` pair or anything
    upcast from f32); x0 = 0.  Returns a ``DF64CGResult`` with the
    solution flat.  The iteration is the JAX engine's: p_k = r_k +
    beta_{k-1} p_{k-1} in pass A, iteration 0 against a zero direction.
    ``interpret=True`` runs B6/B7's plain twins, as for
    :func:`cg_streaming`.
    """
    if not isinstance(a, (Stencil2D, Stencil3D)):
        raise TypeError(
            f"cg_streaming_df64 needs a Stencil2D or Stencil3D operator, "
            f"got {type(a).__name__} - use solver.df64.cg_df64 for "
            f"general operators")
    grid = tuple(a.grid)
    if not supports_streaming_df64(a):
        raise ValueError(f"grid {grid} is not a non-empty 2D/3D grid")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    dev = a.device
    b_grid = _grid_of(_coerce_rhs_df(b).to(dev), grid, "rhs")
    scale = a.scale.double()          # re-read in f64
    check_every = min(check_every, max(maxiter, 1))
    cap = maxiter if iter_cap is None else int(iter_cap)
    x = torch.zeros(grid, dtype=torch.float64, device=dev)
    r = b_grid.clone().contiguous()   # pass B updates r in place
    rr0 = blas1.dot(r, r)
    thr = _threshold(float(tol) ** 2, float(rtol) ** 2, rr0)
    state = _StreamState(
        k=0, x=x, r=r, z=r, p_prev=torch.zeros_like(x),
        spare=torch.empty_like(x),
        beta_prev=torch.zeros((), dtype=torch.float64, device=dev),
        rho=rr0, rr=rr0,
        indefinite=torch.zeros((), dtype=torch.bool, device=dev),
        history=torch.zeros((0,), device=dev))
    pass_a = fused_cg_pass_a_plain if interpret else fused_cg_pass_a_df64
    pass_b = fused_cg_pass_b_plain if interpret else fused_cg_pass_b_df64

    def cond(s: _StreamState) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        return bool(~(s.rho < thr) & (s.rho > 0) & torch.isfinite(s.rho))

    def step(s: _StreamState) -> _StreamState:
        p, pap = pass_a(scale, s.beta_prev, s.r, s.p_prev, out=s.spare)
        indefinite = s.indefinite | ((pap <= 0) & (s.rho > 0))
        alpha = _safe_div(s.rho, pap)
        x, r, rr = pass_b(scale, alpha, p, s.x, s.r)
        beta = _safe_div(rr, s.rho)
        return _StreamState(k=s.k + 1, x=x, r=r, z=r, p_prev=p,
                            spare=s.p_prev, beta_prev=beta, rho=rr, rr=rr,
                            indefinite=indefinite, history=s.history)

    def fits(s: _StreamState) -> bool:
        return s.k + check_every <= maxiter and s.k + check_every <= cap

    s = _blocked_while(cond, step, state, check_every, fits)
    converged = (s.rho < thr) | (s.rho == 0)
    # the JAX engine's status order: CONVERGED, then BREAKDOWN
    status = torch.where(
        converged, torch.tensor(int(CGStatus.CONVERGED), dtype=torch.int32,
                                device=dev),
        torch.where(~torch.isfinite(s.rho),
                    torch.tensor(int(CGStatus.BREAKDOWN), dtype=torch.int32,
                                 device=dev),
                    torch.tensor(int(CGStatus.MAXITER), dtype=torch.int32,
                                 device=dev)))
    return _result(s.x.reshape(-1), s.k, s.rho, converged, status,
                   s.indefinite)
