"""f64-class CG: the JAX package's double-float solver, in native float64.

Counterpart of the JAX package's ``solver/df64.py``.  The reference
solves in float64 (``CUDA_R_64F`` descriptors, ``cublasD*`` calls -
``CUDACG.cu:216,248-347``); a TPU has none, so the JAX package carries
every vector, matrix value and recurrence scalar as a double-float
``(hi, lo)`` f32 pair (``ops.df64``).  An H100 has native FP64, so the
port keeps the JAX surface - ``(hi, lo)`` pair inputs, ``DF64CGResult``
with ``x_hi``/``x_lo``, ``DF64Checkpoint``, the same arguments, statuses
and refusals - and computes in float64 inside: a pair input is
recombined as ``hi.double() + lo.double()``, a float64 ``b`` is taken as
it is and anything else is upcast from f32, and the result keeps its
float64 solution (``x()`` returns it without losing bits; ``x_hi`` and
``x_lo`` are its split).  float64 carries 53 significand bits where a
pair carries about 48, so the two packages agree to about 1e-14 relative
per operation, not bit for bit.

Same reference-parity semantics as the JAX ``cg_df64``: absolute
``tol=1e-7`` on ||r|| (quirk Q3), ``maxiter=2000``, the x0 = 0 fast path
(r0 = p0 = b, no initial SpMV, ``CUDACG.cu:247-259``), the threshold
``max(tol^2, rtol^2 ||r0||^2)`` on ||r||^2, indefinite-direction
recording (quirk Q1), breakdown on non-finite scalars (quirk Q4) with
BREAKDOWN ahead of CONVERGED in the status.  Plain CG (the reference's
configuration), Jacobi-PCG (BASELINE config #3) or a Chebyshev
polynomial on the interval of :func:`chebyshev_interval`.

Operators: ``Stencil2D``/``Stencil3D`` (the scale re-read in float64;
plain torch float64 shifted adds - the JAX package's df64 stencil is XLA
code, not a Pallas kernel), ``CSRMatrix`` (float64 values, the plain
torch CSR product), ``ELLMatrix`` (float64 values, the plain torch
gather), ``ShiftELLMatrix`` (lifted) and ``ShiftELLDF64Matrix`` (the
hand SpMV B9 on the card).  ``method="minres"`` runs
``solver.minres.minres_df64``.  The one-launch
and streaming engines of this lane are ``solver.resident.cg_resident_df64``
(B11) and ``solver.streaming.cg_streaming_df64`` (B6/B7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.operators import (
    CSRMatrix,
    ELLMatrix,
    ShiftELLDF64Matrix,
    ShiftELLMatrix,
    Stencil2D,
    Stencil3D,
)
from ..models.precond import estimate_lmax
from ..ops import df64 as df
from ..ops import spmv
from ..ops.chebyshev import chebyshev_coefficients
from ..ops.cuda.stencil import stencil2d_apply_plain, stencil3d_apply_plain
from .cg import _blocked_while, _safe_div
from .status import CGStatus


@dataclasses.dataclass(frozen=True)
class DF64Checkpoint:
    """Complete CG recurrence state of the f64 lane, with the JAX
    package's fields: resuming continues the trajectory (the rr0 pair
    keeps the original rtol threshold).  ``state64`` holds the same
    state in float64 - ``(x, r, p, rho, rr, rr0)`` - when the port wrote
    the checkpoint; a resume takes it over the pairs, so the port's
    resumed solve equals its unsplit one.  A checkpoint carried over
    from the JAX package (``convert.df64_checkpoint_from_arrays``) has
    only the pairs."""

    x_hi: torch.Tensor
    x_lo: torch.Tensor
    r_hi: torch.Tensor
    r_lo: torch.Tensor
    p_hi: torch.Tensor
    p_lo: torch.Tensor
    rho_hi: torch.Tensor
    rho_lo: torch.Tensor
    rr_hi: torch.Tensor
    rr_lo: torch.Tensor
    rr0_hi: torch.Tensor
    rr0_lo: torch.Tensor
    k: torch.Tensor
    indefinite: torch.Tensor
    state64: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class DF64CGResult:
    """CG outcome with the solution as a pair (the JAX fields), beside
    the float64 solution itself.

    ``x()`` returns the float64 solution as numpy; ``residual_norm()``
    the final ||r|| as a float.
    """

    x_hi: torch.Tensor
    x_lo: torch.Tensor
    iterations: torch.Tensor
    residual_norm_sq_hi: torch.Tensor
    residual_norm_sq_lo: torch.Tensor
    converged: torch.Tensor
    status: torch.Tensor
    indefinite: torch.Tensor
    residual_history: Optional[torch.Tensor]  # (maxiter+1,) f32 ||r||, NaN
    # past the final iterate (the hi word: a diagnostic trace, as in JAX)
    checkpoint: Optional[DF64Checkpoint] = None
    flight: Optional[torch.Tensor] = None
    x64: Optional[torch.Tensor] = None               # the float64 solution
    residual_norm_sq: Optional[torch.Tensor] = None  # float64 ||r||^2

    def x(self) -> np.ndarray:
        if self.x64 is not None:
            return self.x64.detach().cpu().numpy()
        return df.to_f64(self.x_hi, self.x_lo)

    def residual_norm(self) -> float:
        if self.residual_norm_sq is not None:
            rr = float(self.residual_norm_sq)
        else:
            rr = float(df.to_f64(self.residual_norm_sq_hi,
                                 self.residual_norm_sq_lo))
        return float(np.sqrt(max(rr, 0.0)))

    def status_enum(self) -> CGStatus:
        return CGStatus(int(self.status))


def _result(x, k, rr, converged, status, indefinite, history=None,
            checkpoint=None) -> DF64CGResult:
    """A ``DF64CGResult`` from the float64 state (``x`` flat)."""
    xh, xl = df.f64_to_pair(x)
    rh, rl = df.f64_to_pair(rr)
    return DF64CGResult(
        x_hi=xh, x_lo=xl,
        iterations=torch.as_tensor(k, dtype=torch.int32, device=x.device),
        residual_norm_sq_hi=rh, residual_norm_sq_lo=rl, converged=converged,
        status=status, indefinite=indefinite, residual_history=history,
        checkpoint=checkpoint, x64=x, residual_norm_sq=rr)


def _status(finite, converged) -> torch.Tensor:
    """``solver.df64``'s status order: BREAKDOWN, then CONVERGED."""
    dev = converged.device
    return torch.where(
        ~finite, torch.tensor(int(CGStatus.BREAKDOWN), dtype=torch.int32,
                              device=dev),
        torch.where(converged,
                    torch.tensor(int(CGStatus.CONVERGED), dtype=torch.int32,
                                 device=dev),
                    torch.tensor(int(CGStatus.MAXITER), dtype=torch.int32,
                                 device=dev)))


@dataclasses.dataclass(frozen=True)
class _F64Operator:
    """An operator of the f64 lane: its float64 product and (for Jacobi)
    its float64 diagonal, a vector or a scalar."""

    matvec: Callable
    diag: Optional[torch.Tensor]
    n: int
    device: torch.device


def _stencil_matvec(a, scale):
    apply = (stencil2d_apply_plain if isinstance(a, Stencil2D)
             else stencil3d_apply_plain)
    grid = tuple(a.grid)

    def matvec(x):
        return apply(x.reshape(grid), scale).reshape(-1)
    return matvec


def _prepare_operator(a, jacobi: bool = False) -> _F64Operator:
    """``a`` as a float64 operator; the Jacobi diagonal only when asked
    for (full length for assembled matrices, the constant centre weight
    for stencils)."""
    if isinstance(a, ShiftELLDF64Matrix):
        return _F64Operator(matvec=a.matvec64, diag=a.diag if jacobi else None,
                            n=a.shape[0], device=a.device)
    if isinstance(a, ShiftELLMatrix):
        # lift the f32 packing: values stay exact, accumulation is f64
        return _prepare_operator(ShiftELLDF64Matrix.from_shiftell(a), jacobi)
    if isinstance(a, (Stencil2D, Stencil3D)):
        # the scale re-read in f64, so a non-exact scale keeps its bits
        scale = a.scale.double()
        diag = a.diagonal()[0].double() if jacobi else None
        return _F64Operator(matvec=_stencil_matvec(a, scale), diag=diag,
                            n=a.shape[0], device=a.device)
    if isinstance(a, CSRMatrix):
        data = a.data.double()
        n = a.shape[0]
        diag = (spmv.csr_diagonal(data, a.indices, a.rows, n)
                if jacobi else None)
        return _F64Operator(
            matvec=lambda x: spmv.csr_matvec(data, a.indices, a.rows, x, n),
            diag=diag, n=a.shape[0], device=a.device)
    if isinstance(a, ELLMatrix):
        if a.shape[0] >= _GATHER_WARN_ROWS:
            import warnings

            warnings.warn(
                f"df64 on an ELLMatrix runs the plain torch gather; at "
                f"n={a.shape[0]} use CSRMatrix.to_shiftell_df64() for the "
                f"hand f64 SpMV (B9), or shard over a mesh",
                UserWarning, stacklevel=3)
        vals = a.vals.double()
        diag = a.diagonal().double() if jacobi else None
        return _F64Operator(
            matvec=lambda x: spmv.ell_matvec(vals, a.cols, x), diag=diag,
            n=a.shape[0], device=a.device)
    raise TypeError(
        f"cg_df64 supports CSRMatrix/ELLMatrix/ShiftELLMatrix/"
        f"ShiftELLDF64Matrix/Stencil2D/Stencil3D, got {type(a).__name__} "
        f"(the JAX package's df64 lane has no DIA or dense operator)")


#: from this many rows on, an f64 ELL solve warns that the gather is the
#: slow route (the JAX package's threshold)
_GATHER_WARN_ROWS = 200_000


def _coerce_rhs_df(b) -> torch.Tensor:
    """Right-hand side -> float64 tensor.  An ``(hi, lo)`` pair of
    equal-shape f32 vectors (ndim >= 1) is recombined; float64 data is
    taken as it is; anything else is upcast from f32 (the JAX package
    lifts it with zero low words).  The pair rule is strict - f32 words,
    matching non-scalar shapes - so a plain 2-element tuple like
    ``(1.0, 2.0)`` still coerces as a length-2 VECTOR.  Shared by every
    entry of the lane."""
    if (isinstance(b, tuple) and len(b) == 2
            and all(isinstance(v, (np.ndarray, torch.Tensor)) for v in b)):
        hi, lo = (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                  for v in b)
        if (hi.dtype == torch.float32 and lo.dtype == torch.float32
                and hi.shape == lo.shape and hi.ndim >= 1):
            return df.pair_to_f64(hi, lo.to(hi.device))
    t = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
    if t.dtype == torch.float64:
        return t
    return t.to(torch.float32).to(torch.float64)


def _threshold(tol2, rtol2, rr0: torch.Tensor) -> torch.Tensor:
    """threshold^2 = max(tol^2, rtol^2 * ||r0||^2)."""
    return torch.maximum(torch.as_tensor(tol2, dtype=torch.float64,
                                         device=rr0.device),
                         rtol2 * rr0)


def chebyshev_interval(a, *, ratio: float = 30.0, iters: int = 30):
    """``(theta, delta)`` as ``(hi, lo)`` pairs of 0-d f32 tensors: the
    centre and half-width of ``[lmax / ratio, lmax]`` with ``lmax`` from
    power iteration on the host side of the solve (the JAX function).

    ``a`` may be any ``LinearOperator`` (``models.precond.estimate_lmax``
    in its dtype) or an operator with ``matvec_df`` (a power iteration on
    f32 vectors through its float64 product, rounded to f32 each step -
    the JAX hi-word iteration - with the 1.1 safety factor).
    Deterministic, so resumed or re-built solves derive the same
    preconditioner.  The pairs carry over to the JAX package's bits;
    the solvers recombine them to float64."""
    if hasattr(a, "matvec_df"):
        n, dev = a.shape[0], a.device
        idx = torch.arange(n, dtype=torch.float32, device=dev)
        v = torch.sin(idx * 12.9898 + 78.233) + 1.5
        v = v / torch.sqrt(torch.dot(v, v))
        floor = torch.tensor(1e-30, device=dev)
        for _ in range(iters):
            w = a.matvec64(v.double()).float()
            v = w / torch.sqrt(torch.maximum(torch.dot(w, w), floor))
        w = a.matvec64(v.double()).float()
        lmax = 1.1 * float(torch.dot(v, w) / torch.dot(v, v))
        dev = a.device
    else:
        lmax = float(estimate_lmax(a, iters=iters))
        dev = a.device
    lmin = lmax / ratio
    return (df.const((lmax + lmin) * 0.5, device=dev),
            df.const((lmax - lmin) * 0.5, device=dev))


def _chebyshev_apply(mv, r: torch.Tensor, theta: torch.Tensor,
                     steps) -> torch.Tensor:
    """z = p(A) r: the Chebyshev semi-iteration for A z = r from z0 = 0
    (the JAX ``_chebyshev_apply``), with each step's ``(c1, c2)`` from
    ``ops.chebyshev.chebyshev_coefficients(theta, delta, degree)``:
    ``degree - 1`` matvecs, no reductions."""
    d = r / theta
    z = d
    for c1, c2 in steps:
        d = c1 * d + c2 * (r - mv(z))
        z = z + d
    return z


class _State(NamedTuple):
    k: int
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor      # r . z (== rr without a preconditioner)
    rr: torch.Tensor       # ||r||^2 (convergence is checked on r, not z)
    indefinite: torch.Tensor
    finite: torch.Tensor
    history: torch.Tensor


def cg_df64(
    a,
    b,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    record_history: bool = False,
    preconditioner: Optional[str] = None,
    axis_name: Optional[str] = None,
    resume_from: Optional[DF64Checkpoint] = None,
    return_checkpoint: bool = False,
    check_every: int = 1,
    method: str = "cg",
    iter_cap: Optional[int] = None,
    precond_degree: int = 4,
    flight=None,
) -> DF64CGResult:
    """CG at the reference's precision (see the module docstring).

    ``b``: a float64 array or tensor (taken as it is), an ``(hi, lo)``
    pair of f32 vectors (recombined), or anything else (upcast from
    f32); it is moved to ``a``'s device.  ``preconditioner``: ``None``
    (the reference's plain CG), ``"jacobi"`` (diag(A)^-1 in float64) or
    ``"chebyshev"`` (the ``precond_degree``-term polynomial on the
    interval of :func:`chebyshev_interval`).  ``resume_from`` /
    ``return_checkpoint``: ``maxiter`` stays the TOTAL cap and the
    resumed run continues the trajectory.  ``check_every``: the
    convergence predicate once per k iterations (one host read per
    block; iterates identical, up to k - 1 frozen extra iterations).
    ``iter_cap``: a further bound <= ``maxiter``.  ``record_history``:
    the per-iteration ||r|| trace (f32, NaN-filled).

    ``method``: ``"cg"``, or the single-reduction ``"cg1"`` and the
    pipelined ``"pipecg"`` (residual replacement every 512 iterations)
    with ``preconditioner`` ``None`` or ``"jacobi"``; checkpoints,
    ``iter_cap`` and ``flight`` need ``"cg"``.  ``"minres"`` runs
    ``solver.minres.minres_df64`` (unpreconditioned, no checkpoints;
    ``iter_cap`` and ``check_every`` as for ``"cg"``).

    Not ported yet, each raising ``NotImplementedError`` with its
    ROADMAP item: ``preconditioner="mg"`` (A8), ``axis_name`` (A10),
    ``flight`` (A9).
    """
    if preconditioner not in (None, "jacobi", "chebyshev", "mg"):
        raise ValueError(
            f"cg_df64 supports preconditioner=None, 'jacobi', 'chebyshev' "
            f"or 'mg', got {preconditioner!r}")
    if method not in ("cg", "cg1", "pipecg", "minres"):
        raise ValueError(f"unknown method {method!r}; expected 'cg', "
                         f"'cg1', 'pipecg' or 'minres'")
    if flight is not None and method != "cg":
        raise ValueError(
            f"cg_df64 carries the flight recorder on method='cg' only "
            f"(got method={method!r}); use record_history for the "
            f"variants' dense trace")
    if method == "minres":
        if preconditioner is not None:
            raise ValueError(
                "method='minres' is unpreconditioned (preconditioned "
                "MINRES needs an SPD preconditioner and a different "
                "inner product)")
        if resume_from is not None or return_checkpoint:
            raise ValueError(
                "method='minres' does not support checkpoint/resume")
        from .minres import minres_df64

        return minres_df64(a, b, tol=tol, rtol=rtol, maxiter=maxiter,
                           record_history=record_history,
                           axis_name=axis_name, iter_cap=iter_cap,
                           check_every=check_every)
    if preconditioner in ("chebyshev", "mg") and method != "cg":
        raise ValueError(
            f"preconditioner={preconditioner!r} requires method='cg' in "
            f"df64 (the variants fuse their reductions around the plain "
            f"or Jacobi recurrence)")
    if preconditioner == "mg" and not isinstance(a, (Stencil2D, Stencil3D)):
        raise ValueError(
            f"preconditioner='mg' needs a matrix-free stencil operator "
            f"(Stencil2D/Stencil3D - the geometric hierarchy rediscretizes "
            f"the grid), got {type(a).__name__}")
    if precond_degree < 1:
        raise ValueError(f"precond_degree must be >= 1, got "
                         f"{precond_degree}")
    if method != "cg" and (resume_from is not None or return_checkpoint
                           or iter_cap is not None):
        raise ValueError(
            "checkpoint/resume (and its iter_cap segmenting) requires "
            "method='cg': DF64Checkpoint carries the standard recurrence "
            "state, not the variants' extra vectors")
    if preconditioner == "mg":
        raise NotImplementedError(
            "preconditioner='mg' (the multigrid V-cycle) is not ported yet "
            "(ROADMAP A8)")
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name= (the distributed df64 solve) is not ported yet "
            "(ROADMAP A10)")
    if flight is not None:
        raise NotImplementedError(
            "flight= is not ported yet (ROADMAP A9)")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")

    op = _prepare_operator(a, jacobi=preconditioner == "jacobi")
    b64 = _coerce_rhs_df(b).to(op.device)
    if tuple(b64.shape) != (op.n,):
        raise ValueError(f"rhs shape {tuple(b64.shape)} does not match the "
                         f"operator's {op.n} rows")
    if method != "cg":
        return _VARIANTS[method](
            op.matvec, op.diag, b64, float(tol) ** 2, float(rtol) ** 2,
            maxiter=maxiter, record_history=record_history,
            check_every=check_every)
    cap = maxiter if iter_cap is None else int(iter_cap)
    tol2, rtol2 = float(tol) ** 2, float(rtol) ** 2
    mv = op.matvec
    if preconditioner == "chebyshev":
        theta, delta = (df.pair_to_f64(*pair).to(op.device)
                        for pair in chebyshev_interval(a))
        steps = chebyshev_coefficients(theta, delta, precond_degree)

        def apply_m(r):
            return _chebyshev_apply(mv, r, theta, steps)
    elif preconditioner == "jacobi":
        def apply_m(r):
            return r / op.diag
    else:
        apply_m = None
    return _solve(mv, apply_m, b64, tol2, rtol2, resume_from, cap,
                  maxiter=maxiter, record_history=record_history,
                  return_checkpoint=return_checkpoint,
                  check_every=check_every)


def _solve(mv, apply_m, b64, tol2, rtol2, resume, cap, *, maxiter,
           record_history, return_checkpoint, check_every) -> DF64CGResult:
    dev = b64.device
    if resume is not None:
        x0, r0, p0, rho0, rr0, rr_base = _resume_state(resume, dev)
        k0 = int(resume.k)
        indef0 = torch.as_tensor(resume.indefinite, dtype=torch.bool,
                                 device=dev).reshape(())
    else:
        x0 = torch.zeros_like(b64)
        r0 = b64                          # x0 = 0 (CUDACG.cu:247-259)
        z0 = r0 if apply_m is None else apply_m(r0)
        p0 = z0
        rr0 = torch.dot(r0, r0)
        rho0 = rr0 if apply_m is None else torch.dot(r0, z0)
        rr_base = rr0
        k0 = 0
        indef0 = torch.zeros((), dtype=torch.bool, device=dev)
    # threshold^2 with the ORIGINAL solve's rr0 under resume
    thr = _threshold(tol2, rtol2, rr_base)
    history = torch.full((maxiter + 1 if record_history else 0,),
                         float("nan"), dtype=torch.float32, device=dev)
    if record_history:
        history[k0] = _trace(rr0)

    def cond(s: _State) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        # rr == 0: solved exactly - further steps would only freeze
        return bool(s.finite & ~(s.rr < thr) & (s.rr > 0))

    def step(s: _State) -> _State:
        ap = mv(s.p)
        pap = torch.dot(s.p, ap)
        alpha = _safe_div(s.rho, pap)
        x = s.x + alpha * s.p
        r = s.r - alpha * ap
        rr = torch.dot(r, r)
        if apply_m is None:
            z, rho = r, rr
        else:
            z = apply_m(r)
            rho = torch.dot(r, z)
        beta = _safe_div(rho, s.rho)
        p = z + beta * s.p
        k = s.k + 1
        if record_history:
            s.history[k] = _trace(rr)
        return _State(
            k=k, x=x, r=r, p=p, rho=rho, rr=rr,
            # s.rr > 0 excludes frozen post-exact-solve steps
            indefinite=s.indefinite | ((pap <= 0) & (s.rr > 0)),
            finite=torch.isfinite(rho) & torch.isfinite(pap),
            history=s.history)

    def fits(s: _State) -> bool:
        return s.k + check_every <= maxiter and s.k + check_every <= cap

    s = _blocked_while(cond, step, _State(
        k=k0, x=x0, r=r0, p=p0, rho=rho0, rr=rr0, indefinite=indef0,
        finite=torch.isfinite(rho0), history=history), check_every, fits)
    converged = (s.rr < thr) | (s.rr == 0)
    checkpoint = None
    if return_checkpoint:
        checkpoint = _checkpoint(s, rr_base)
    return _result(s.x, s.k, s.rr, converged, _status(s.finite, converged),
                   s.indefinite, s.history if record_history else None,
                   checkpoint)


def _trace(rr: torch.Tensor) -> torch.Tensor:
    """The history entry: sqrt of the f32 hi word of ||r||^2, as the JAX
    trace stores it."""
    return torch.sqrt(torch.clamp(rr.float(), min=0.0))


def _checkpoint(s: _State, rr_base: torch.Tensor) -> DF64Checkpoint:
    pairs = {}
    for name, v in (("x", s.x), ("r", s.r), ("p", s.p), ("rho", s.rho),
                    ("rr", s.rr), ("rr0", rr_base)):
        pairs[f"{name}_hi"], pairs[f"{name}_lo"] = df.f64_to_pair(v)
    return DF64Checkpoint(
        **pairs, k=torch.tensor(s.k, dtype=torch.int32, device=s.x.device),
        indefinite=s.indefinite,
        state64=(s.x, s.r, s.p, s.rho, s.rr, rr_base))


def _resume_state(c: DF64Checkpoint, dev) -> tuple:
    """(x, r, p, rho, rr, rr0) in float64 on ``dev``: the exact state
    when the port wrote the checkpoint, else the pairs recombined."""
    if c.state64 is not None:
        return tuple(v.to(dev) for v in c.state64)
    return tuple(df.pair_to_f64(getattr(c, f"{n}_hi"),
                                getattr(c, f"{n}_lo")).to(dev)
                 for n in ("x", "r", "p", "rho", "rr", "rr0"))


# -- single-reduction and pipelined variants ----------------------------------
#
# The JAX package's df64 ``_solve_cg1`` and ``_solve_pipecg``, in float64:
# the f32 lane's cg1/pipecg recurrences (``solver.cg``) with the lane's
# threshold, its status order (CONVERGED ahead of BREAKDOWN, as the JAX
# ``_variant_package`` has it) and no ``iter_cap``.  ``d`` is the Jacobi
# diagonal or ``None``.


class _CG1State(NamedTuple):
    k: int
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor        # A @ p, maintained by recurrence
    gamma: torch.Tensor    # r . u (u = M^-1 r; == ||r||^2 unpreconditioned)
    rr: torch.Tensor       # ||r||^2
    alpha: torch.Tensor    # step length for the NEXT x/r update
    indefinite: torch.Tensor
    history: torch.Tensor


class _PipeState(NamedTuple):
    k: int
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor        # M^-1 r
    w: torch.Tensor        # A u
    p: torch.Tensor
    s: torch.Tensor        # A p
    q: torch.Tensor        # M^-1 s
    z: torch.Tensor        # A q
    gamma: torch.Tensor
    rr: torch.Tensor
    alpha: torch.Tensor
    indefinite: torch.Tensor
    history: torch.Tensor


#: df64 drift is slow, as in f64: replacement every 512 iterations keeps
#: its ~3-matvec recompute negligible (``solver.cg._replace_cadence``)
_REPLACE_CADENCE_DF64 = 512


def _variant_dots(d, r, u, w):
    """``(rr, gamma, delta)``: ``r . r``, ``r . u`` and ``w . u``; two
    dots without the Jacobi diagonal (u == r)."""
    rr = torch.dot(r, r)
    if d is None:
        return rr, rr, torch.dot(w, r)
    return rr, torch.dot(r, u), torch.dot(w, u)


def _variant_init(mv, d, b64):
    """The x0 = 0 init of both variants: (x0, r0, u0, w0, rr0, gamma0,
    delta0, alpha0)."""
    r0 = b64
    u0 = r0 if d is None else r0 / d
    w0 = mv(u0)
    rr0, gamma0, delta0 = _variant_dots(d, r0, u0, w0)
    return (torch.zeros_like(b64), r0, u0, w0, rr0, gamma0, delta0,
            _safe_div(gamma0, delta0))


def _history0(record_history: bool, maxiter: int, rr0) -> torch.Tensor:
    hist = torch.full((maxiter + 1 if record_history else 0,), float("nan"),
                      dtype=torch.float32, device=rr0.device)
    if record_history:
        hist[0] = _trace(rr0)
    return hist


def _variant_while(step, st0, thr, maxiter: int, check_every: int):
    def cond(st) -> bool:
        if st.k >= maxiter:
            return False
        healthy = torch.isfinite(st.rr) & torch.isfinite(st.gamma) \
            & torch.isfinite(st.alpha) & (st.gamma > 0)
        return bool(~(st.rr < thr) & (st.rr > 0) & healthy)

    return _blocked_while(cond, step, st0, check_every,
                          lambda t: t.k + check_every <= maxiter)


def _variant_result(final, thr, record_history: bool) -> DF64CGResult:
    converged = (final.rr < thr) | (final.rr == 0)
    healthy = torch.isfinite(final.rr) & torch.isfinite(final.gamma) \
        & torch.isfinite(final.alpha) & ((final.gamma > 0) | (final.rr == 0))
    dev = final.rr.device
    status = torch.where(
        converged, torch.tensor(int(CGStatus.CONVERGED), dtype=torch.int32,
                                device=dev),
        torch.where(~healthy,
                    torch.tensor(int(CGStatus.BREAKDOWN), dtype=torch.int32,
                                 device=dev),
                    torch.tensor(int(CGStatus.MAXITER), dtype=torch.int32,
                                 device=dev)))
    return _result(final.x, final.k, final.rr, converged, status,
                   final.indefinite,
                   final.history if record_history else None)


def _solve_cg1(mv, d, b64, tol2, rtol2, *, maxiter, record_history,
               check_every) -> DF64CGResult:
    """Chronopoulos-Gear CG in float64 (the JAX df64 ``_solve_cg1``)."""
    x0, r0, u0, w0, rr0, gamma0, delta0, alpha0 = _variant_init(mv, d, b64)
    thr = _threshold(tol2, rtol2, rr0)

    def step(st: _CG1State) -> _CG1State:
        x = st.x + st.alpha * st.p
        r = st.r - st.alpha * st.s
        u = r if d is None else r / d
        w = mv(u)
        rr, gamma, delta = _variant_dots(d, r, u, w)
        beta = _safe_div(gamma, st.gamma)
        # == p_new . A p_new in exact arithmetic
        denom = delta - beta * _safe_div(gamma, st.alpha)
        alpha = _safe_div(gamma, denom)
        k = st.k + 1
        if record_history:
            st.history[k] = _trace(rr)
        return _CG1State(
            k=k, x=x, r=r, p=u + beta * st.p, s=w + beta * st.s,
            gamma=gamma, rr=rr, alpha=alpha,
            indefinite=st.indefinite | ((denom <= 0) & (rr > 0)),
            history=st.history)

    final = _variant_while(step, _CG1State(
        k=0, x=x0, r=r0, p=u0, s=w0, gamma=gamma0, rr=rr0, alpha=alpha0,
        indefinite=(delta0 <= 0) & (rr0 > 0),
        history=_history0(record_history, maxiter, rr0)), thr, maxiter,
        check_every)
    return _variant_result(final, thr, record_history)


def _solve_pipecg(mv, d, b64, tol2, rtol2, *, maxiter, record_history,
                  check_every) -> DF64CGResult:
    """Ghysels-Vanroose pipelined CG in float64 (the JAX df64
    ``_solve_pipecg``), residual replacement every
    ``_REPLACE_CADENCE_DF64`` iterations."""
    x0, r0, u0, w0, rr0, gamma0, delta0, alpha0 = _variant_init(mv, d, b64)
    m0 = w0 if d is None else w0 / d
    thr = _threshold(tol2, rtol2, rr0)

    def step(st: _PipeState) -> _PipeState:
        x = st.x + st.alpha * st.p
        k = st.k + 1
        if k % _REPLACE_CADENCE_DF64 == 0:
            # recompute every derived vector from its definition
            r = b64 - mv(x)
            u = r if d is None else r / d
            w = mv(u)
            s_old = mv(st.p)
            q_old = s_old if d is None else s_old / d
            z_old = mv(q_old)
        else:
            r = st.r - st.alpha * st.s
            u = st.u - st.alpha * st.q
            w = st.w - st.alpha * st.z
            s_old, q_old, z_old = st.s, st.q, st.z
        rr, gamma, delta = _variant_dots(d, r, u, w)
        mm = w if d is None else w / d
        nn = mv(mm)
        beta = _safe_div(gamma, st.gamma)
        denom = delta - beta * _safe_div(gamma, st.alpha)
        alpha = _safe_div(gamma, denom)
        if record_history:
            st.history[k] = _trace(rr)
        return _PipeState(
            k=k, x=x, r=r, u=u, w=w, p=u + beta * st.p, s=w + beta * s_old,
            q=mm + beta * q_old, z=nn + beta * z_old, gamma=gamma, rr=rr,
            alpha=alpha,
            indefinite=st.indefinite | ((denom <= 0) & (rr > 0)),
            history=st.history)

    final = _variant_while(step, _PipeState(
        k=0, x=x0, r=r0, u=u0, w=w0, p=u0, s=w0, q=m0, z=mv(m0),
        gamma=gamma0, rr=rr0, alpha=alpha0,
        indefinite=(delta0 <= 0) & (rr0 > 0),
        history=_history0(record_history, maxiter, rr0)), thr, maxiter,
        check_every)
    return _variant_result(final, thr, record_history)


_VARIANTS = {"cg1": _solve_cg1, "pipecg": _solve_pipecg}
