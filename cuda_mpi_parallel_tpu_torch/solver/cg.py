"""Conjugate-gradient solver: the loop runs eagerly, the scalars stay on
the device.

Counterpart of the JAX package's ``solver/cg.py``.  The JAX solve is one
``lax.while_loop``; eager PyTorch keeps the same property - no host
round-trip inside the recurrence - by holding rho, alpha, beta, the
breakdown guard and the indefinite flag as 0-d device tensors, and by
reading the convergence predicate on the host once per ``check_every``
block (one ``.item()``).  The default ``check_every=1`` syncs every
iteration, which is the reference's semantics (``CUDACG.cu:333``);
throughput runs use ``check_every=32``.

Reference-parity semantics kept (see the JAX module for the quirks):

* default ``tol=1e-7`` **absolute** on ||r||_2 (quirk Q3), plus ``rtol``;
* default ``maxiter=2000``;
* x0 = 0 fast path: r0 = b, p0 = b, no initial SpMV;
* p.Ap <= 0 on the indefinite 3x3 oracle is recorded (``indefinite``)
  and does not abort, so the oracle converges in 3 iterations;
* non-finite scalars stop the loop with ``CGStatus.BREAKDOWN``;
* ``check_every`` blocks run whole past convergence (iterates are frozen
  by ``_safe_div``), and a per-iteration tail never overshoots
  ``maxiter`` / ``iter_cap``.

This slice carries ``method="cg"`` without a preconditioner; every other
argument of the JAX signature raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .._device import is_hopper
from ..models.operators import DenseOperator, LinearOperator
from ..ops import blas1
from .status import CGStatus

#: arguments of the JAX signature this slice does not carry, and the
#: ROADMAP.md item that ports each
_LATER = {
    "m": "A8 (preconditioners; Jacobi in A2)",
    "compensated": "A3 (compensated dots)",
    "resume_from": "A3 (checkpoint/resume)",
    "return_checkpoint": "A3 (checkpoint/resume)",
    "flight": "A9 (flight recorder)",
    "fault": "A15 (fault injection)",
    "deflate": "A14 (Krylov recycling)",
    "basis": "A14 (Krylov recycling)",
    "axis_name": "A10 (distributed solve)",
}
_METHODS_LATER = {"cg1": "A3", "pipecg": "A3", "minres": "A11"}


def _refuse_unported(method: str, **given) -> None:
    if method not in ("cg", "cg1", "pipecg", "minres"):
        raise ValueError(f"unknown method {method!r}; expected 'cg', 'cg1', "
                         f"'pipecg' or 'minres'")
    if method != "cg":
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP "
            f"{_METHODS_LATER[method]}); this slice carries method='cg'")
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP {_LATER[name]})")


@dataclasses.dataclass(frozen=True)
class CGResult:
    """Everything the reference never reported (SURVEY quirk Q7).  Fields
    are tensors on the operator's device."""

    x: torch.Tensor                 # solution estimate
    iterations: torch.Tensor        # int32: CG iterations performed
    residual_norm: torch.Tensor     # final ||r||_2
    converged: torch.Tensor         # bool: residual_norm < threshold
    status: torch.Tensor            # int32 CGStatus code
    indefinite: torch.Tensor        # bool: p.Ap <= 0 was observed (Q1)
    residual_history: Optional[torch.Tensor]  # (maxiter+1,) or None
    checkpoint: Optional[object] = None
    flight: Optional[torch.Tensor] = None
    basis: Optional[tuple] = None

    def status_enum(self) -> CGStatus:
        return CGStatus(int(self.status))


class _CGState(NamedTuple):
    k: int                # iterations done (host int: the loop is host-driven)
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor     # r . z (== ||r||^2 unpreconditioned)
    rr: torch.Tensor      # ||r||^2
    indefinite: torch.Tensor
    history: torch.Tensor  # (maxiter+1,) or (0,) when not recording


def cg(
    a: LinearOperator,
    b,
    x0=None,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    m=None,
    record_history: bool = False,
    axis_name=None,
    resume_from=None,
    return_checkpoint: bool = False,
    iter_cap=None,
    check_every: int = 1,
    method: str = "cg",
    compensated: bool = False,
    flight=None,
    fault=None,
    deflate=None,
    basis=None,
) -> CGResult:
    """Solve A x = b by conjugate gradients on ``a``'s device.

    Arguments as in the JAX ``cg``: ``tol`` absolute on ||r||_2
    (quirk Q3), ``rtol`` relative (threshold ``max(tol, rtol*||r0||)``),
    ``maxiter`` the iteration cap (sizes the history), ``iter_cap`` a
    further bound <= maxiter, ``check_every`` the convergence-check
    block, ``record_history`` the per-iteration ||r|| trace, ``x0`` a
    warm start (``None`` takes the copy-only init, ``CUDACG.cu:247-259``).
    """
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    _refuse_unported(method, m=m, compensated=compensated,
                     resume_from=resume_from,
                     return_checkpoint=return_checkpoint, flight=flight,
                     fault=fault, deflate=deflate, basis=basis,
                     axis_name=axis_name)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    b = _as_rhs(b, a.device)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"operator shape {a.shape} does not match rhs "
                         f"shape {tuple(b.shape)}")
    cap = maxiter if iter_cap is None else int(iter_cap)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b   # r0 = b - A@0 = b: the reference's copy-only init (:248)
    else:
        x = torch.as_tensor(x0, device=a.device).to(b.dtype)
        r = b - a @ x
    rr0 = blas1.dot(r, r)
    nrm0 = torch.sqrt(rr0)
    thresh_sq = _threshold_sq(tol, rtol, nrm0, b.dtype)
    state = _CGState(
        k=0, x=x, r=r, p=r, rho=rr0, rr=rr0,
        indefinite=torch.zeros((), dtype=torch.bool, device=b.device),
        history=_history_init(record_history, maxiter, b.dtype, 0, nrm0))

    def step(s: _CGState) -> _CGState:
        ap = a @ s.p
        p_ap = blas1.dot(s.p, ap)                 # cublasDdot :304
        alpha = _safe_div(s.rho, p_ap)            # host arithmetic :311
        x = blas1.axpy(alpha, s.p, s.x)           # :314
        r = blas1.axpy(-alpha, ap, s.r)           # :320-321
        rr = blas1.dot(r, r)                      # cublasDnrm2 :328
        beta = _safe_div(rr, s.rho)               # :336-339
        p = blas1.xpby(r, beta, s.p)              # Dscal :342 + Daxpy :347
        k = s.k + 1
        if record_history:
            s.history[k] = torch.sqrt(rr)
        return _CGState(
            k=k, x=x, r=r, p=p, rho=rr, rr=rr,
            # s.rr > 0 excludes frozen post-exact-solve steps
            indefinite=s.indefinite | ((p_ap <= 0) & (s.rr > 0)),
            history=s.history)

    final = _blocked_while(_cond(maxiter, cap, thresh_sq), step, state,
                           check_every, _block_fits(maxiter, cap,
                                                    check_every))
    return _package(final, thresh_sq, record_history)


def _cond(maxiter: int, cap: int, thresh_sq: torch.Tensor) -> Callable:
    """The loop predicate; the device part costs one host sync."""
    def cond(s) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        unconverged = s.rr >= thresh_sq
        # rr == 0 means the system is solved exactly; iterating further
        # would divide 0/0
        nontrivial = s.rr > 0
        healthy = torch.isfinite(s.rr) & torch.isfinite(s.rho) & (s.rho > 0)
        return bool(unconverged & nontrivial & healthy)
    return cond


def _blocked_while(cond, step, state, check_every: int, block_fits=None):
    """``while cond: step`` with the predicate evaluated every k steps.

    With ``check_every > 1`` the loop runs whole blocks of k steps with
    one check (one host sync) per block; iterates are identical to
    ``check_every=1``, but up to k-1 extra iterations may run past
    convergence (``_safe_div`` freezes them).  Once ``block_fits(s)``
    says a whole block would pass the iteration budget, a per-iteration
    tail finishes, so ``maxiter``/``iter_cap`` is never overshot.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if check_every > 1:
        while (block_fits is None or block_fits(state)) and cond(state):
            for _ in range(check_every):
                state = step(state)
    while cond(state):                    # tail: < k iterations
        state = step(state)
    return state


def _block_fits(maxiter: int, cap: int, check_every: int):
    """Predicate: a full check_every block stays within maxiter AND cap."""
    def fits(s) -> bool:
        return s.k + check_every <= maxiter and s.k + check_every <= cap
    return fits


def _threshold_sq(tol, rtol, nrm0: torch.Tensor, dtype) -> torch.Tensor:
    """Squared convergence threshold: max(tol, rtol*||r0||)^2 (quirk Q3:
    absolute by default, matching ``CUDACG.cu:333``)."""
    dev = nrm0.device
    threshold = torch.maximum(
        torch.full((), float(tol), dtype=dtype, device=dev),
        torch.full((), float(rtol), dtype=dtype, device=dev) * nrm0)
    return threshold * threshold


def _history_init(record_history: bool, maxiter: int, dtype, k0: int,
                  nrm0: torch.Tensor) -> torch.Tensor:
    if record_history:
        history = torch.full((maxiter + 1,), float("nan"), dtype=dtype,
                             device=nrm0.device)
        history[k0] = nrm0
        return history
    return torch.zeros((0,), dtype=dtype, device=nrm0.device)


def _package(final, thresh_sq: torch.Tensor,
             record_history: bool) -> CGResult:
    """Shared epilogue: convergence/breakdown status + CGResult."""
    healthy = torch.isfinite(final.rr) & torch.isfinite(final.rho) \
        & ((final.rho > 0) | (final.rr == 0))
    converged = (final.rr < thresh_sq) | (final.rr == 0)
    dev = final.rr.device
    status = torch.where(
        converged,
        torch.full((), int(CGStatus.CONVERGED), dtype=torch.int32,
                   device=dev),
        torch.where(~healthy,
                    torch.full((), int(CGStatus.BREAKDOWN),
                               dtype=torch.int32, device=dev),
                    torch.full((), int(CGStatus.MAXITER),
                               dtype=torch.int32, device=dev)))
    return CGResult(
        x=final.x,
        iterations=torch.full((), final.k, dtype=torch.int32, device=dev),
        residual_norm=torch.sqrt(final.rr),
        converged=converged,
        status=status,
        indefinite=final.indefinite,
        residual_history=final.history if record_history else None)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, but a freeze (0) when both are exactly zero.

    Inside a ``check_every`` block, iterations past an exact solve have
    rho = p.Ap = 0; 0/0 would inject NaN into a state the predicate can
    no longer veto.  A genuine breakdown (den = 0 with num != 0) still
    produces inf -> caught by the health check.
    """
    zero = (num == 0) & (den == 0)
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def _as_operator(a) -> LinearOperator:
    """A raw matrix as a ``DenseOperator``: a tensor keeps its device,
    anything else goes to the default device (cuda)."""
    device = a.device if isinstance(a, torch.Tensor) else None
    op = DenseOperator.create(a, device=device)
    if op.a.ndim != 2:
        raise ValueError(f"expected a 2-D matrix or LinearOperator, got "
                         f"ndim={op.a.ndim}")
    return op


def _as_rhs(b, device) -> torch.Tensor:
    """``b`` as a floating tensor on ``device`` (integers become the
    default float dtype)."""
    b = torch.as_tensor(b, device=device)
    if not b.dtype.is_floating_point:
        b = b.to(torch.get_default_dtype())
    return b


def solve(
    a,
    b,
    x0=None,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    m=None,
    record_history: bool = False,
    resume_from=None,
    return_checkpoint: bool = False,
    iter_cap: Optional[int] = None,
    check_every: int = 1,
    method: str = "cg",
    compensated: bool = False,
    engine: str = "general",
    flight=None,
    fault=None,
    deflate=None,
    basis=None,
) -> CGResult:
    """Single-call entry point on the operator's device (``b``/``x0`` are
    moved there).

    ``engine``: ``"general"`` (default - the CG loop above, every
    operator), ``"resident"`` (the whole solve in one launch of the
    resident kernel, ``solver.resident`` - f32 stencils whose working set
    fits the card's L2; raises if out of scope), ``"streaming"`` (the
    fused two-kernel iteration, ``solver.streaming`` - f32 stencils of any
    size; raises if out of scope) or ``"auto"`` (on a Hopper card:
    resident when eligible, else streaming when eligible, else general;
    general elsewhere).  ``"auto"`` keeps ``record_history`` requests off
    the resident engine, whose trace is check-block granular; an explicit
    ``engine="resident"`` returns that trace.
    """
    if engine not in ("general", "auto", "resident", "streaming"):
        raise ValueError(f"unknown engine {engine!r}; expected 'general', "
                         f"'auto', 'resident' or 'streaming'")
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    _refuse_unported(method, m=m, compensated=compensated,
                     resume_from=resume_from,
                     return_checkpoint=return_checkpoint, flight=flight,
                     fault=fault, deflate=deflate, basis=basis)
    b = _as_rhs(b, a.device)
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=a.device)
    if engine in ("auto", "resident"):
        from .resident import cg_resident, resident_eligible

        eligible = ((engine == "resident" or is_hopper(a.device))
                    and resident_eligible(
                        a, b, m, method=method,
                        record_history=(record_history
                                        and engine != "resident"),
                        x0=x0, resume_from=resume_from,
                        return_checkpoint=return_checkpoint,
                        compensated=compensated))
        if engine == "resident" and not eligible:
            raise ValueError(
                "engine='resident' needs a float32 2D/3D stencil whose "
                "CG working set fits on chip (5 planes within the card's "
                "L2), a float32 rhs, m=None, method='cg', f32 x0 or none, "
                "and no checkpointing - use engine='general' (or 'auto') "
                "otherwise")
        if eligible:
            return cg_resident(a, b, x0, tol=tol, rtol=rtol,
                               maxiter=maxiter, check_every=check_every,
                               iter_cap=iter_cap,
                               record_history=record_history,
                               method=method)
    if engine in ("auto", "streaming"):
        from .streaming import cg_streaming, streaming_eligible

        eligible = ((engine == "streaming" or is_hopper(a.device))
                    and streaming_eligible(
                        a, b, m, method=method, x0=x0,
                        resume_from=resume_from,
                        return_checkpoint=return_checkpoint,
                        compensated=compensated,
                        record_history=record_history))
        if engine == "streaming" and not eligible:
            raise ValueError(
                "engine='streaming' needs a float32 2D/3D stencil, a "
                "float32 rhs and x0, m=None, method='cg' and no "
                "checkpointing - use engine='general' (or 'auto') "
                "otherwise")
        if eligible:
            return cg_streaming(a, b, x0, tol=tol, rtol=rtol,
                                maxiter=maxiter, check_every=check_every,
                                iter_cap=iter_cap,
                                record_history=record_history)
    return cg(a, b, x0, tol=tol, rtol=rtol, maxiter=maxiter,
              record_history=record_history, iter_cap=iter_cap,
              check_every=check_every)

