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

Methods: ``"cg"`` (the textbook recurrence, with or without a
preconditioner ``m``: ``z = m @ r``, ``rho = r . z``, ``p = z + beta
p``; ``compensated`` dots; ``resume_from``/``return_checkpoint`` with
:class:`CGCheckpoint`), ``"cg1"`` (Chronopoulos-Gear: every inner
product of an iteration at one point) and ``"pipecg"`` (Ghysels-Vanroose
pipelined CG with periodic residual replacement), each with any ``m``
and ``compensated``.  ``axis_name`` runs the same loop as one shard's
body of a row-partitioned solve (``parallel.solve_distributed``): every
inner product reduces over the named mesh axis (``ops.blas1``), one
reduction per iteration for cg1 and pipecg.  ``"minres"`` (Paige-Saunders,
``solver.minres``: symmetric indefinite systems, unpreconditioned, no
checkpoints or compensated dots) takes the general engine.  The arguments
still to be ported (``flight``, ``fault``, ``deflate``, ``basis``) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .._device import is_hopper
from ..models.operators import (
    DenseOperator,
    LinearOperator,
    ShiftELLDF64Matrix,
)
from ..ops import blas1
from .status import CGStatus

#: arguments of the JAX signature not ported yet, and the ROADMAP.md
#: item that ports each
_LATER = {
    "flight": "A9 (flight recorder)",
    "fault": "A15 (fault injection)",
    "deflate": "A14 (Krylov recycling)",
    "basis": "A14 (Krylov recycling)",
}


def _refuse_unported(method: str, **given) -> None:
    if method not in ("cg", "cg1", "pipecg", "minres"):
        raise ValueError(f"unknown method {method!r}; expected 'cg', 'cg1', "
                         f"'pipecg' or 'minres'")
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP {_LATER[name]})")


def _refuse_minres(flight, m, resume_from, return_checkpoint,
                   compensated) -> None:
    """The JAX ``cg``'s refusals for ``method="minres"``, in its order."""
    if flight is not None:
        raise ValueError(
            "method='minres' does not carry the flight recorder "
            "(its Lanczos recurrence has no CG alpha/beta; use "
            "record_history for its per-iteration trace)")
    if m is not None:
        raise ValueError(
            "method='minres' supports m=None (preconditioned MINRES "
            "needs an SPD preconditioner and a different inner "
            "product; SPD problems belong on the CG variants)")
    if resume_from is not None or return_checkpoint or compensated:
        raise ValueError(
            "method='minres' does not support checkpoint/resume or "
            "compensated dots")


@dataclasses.dataclass(frozen=True)
class CGCheckpoint:
    """Complete ``method="cg"`` recurrence state: resuming from it
    continues the exact trajectory (the same iterates, bit for bit),
    unlike a restart from x alone.  ``nrm0`` is ||r0|| of the ORIGINAL
    solve (the rtol threshold) and ``k`` the iterations done, which
    count against the resumed solve's ``maxiter``.  A JAX
    ``CGCheckpoint`` crosses through ``convert.checkpoint_from_arrays``.
    """

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    rr: torch.Tensor
    nrm0: torch.Tensor
    k: torch.Tensor
    indefinite: torch.Tensor


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
    resume_from: Optional[CGCheckpoint] = None,
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
    warm start (``None`` takes the copy-only init, ``CUDACG.cu:247-259``),
    ``m`` an optional SPD preconditioner applied as ``z = m @ r``.
    ``method``: ``"cg"``, ``"cg1"`` or ``"pipecg"`` (same iterates in
    exact arithmetic; see the module docstring), or ``"minres"``
    (``solver.minres.minres``: ``m``, ``flight``, checkpoints and
    ``compensated`` are refused).  ``compensated``: the
    double-float dots of ``ops.blas1``.  ``resume_from`` (a
    :class:`CGCheckpoint`) continues a partial ``method="cg"`` solve,
    ``maxiter`` staying the TOTAL cap; ``return_checkpoint`` puts the
    final state in ``result.checkpoint``.
    """
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    if method == "minres":
        _refuse_minres(flight, m, resume_from, return_checkpoint,
                       compensated)
    _refuse_unported(method, flight=flight, fault=fault, deflate=deflate,
                     basis=basis)
    if method == "minres":
        from .minres import minres

        return minres(a, b, x0, tol=tol, rtol=rtol, maxiter=maxiter,
                      record_history=record_history, axis_name=axis_name,
                      iter_cap=iter_cap, check_every=check_every)
    if resume_from is not None and x0 is not None:
        raise ValueError("pass either x0 or resume_from, not both: a "
                         "checkpoint carries its own iterate")
    if method != "cg" and (resume_from is not None or return_checkpoint):
        raise ValueError(
            "checkpoint/resume requires method='cg': CGCheckpoint "
            "carries the standard recurrence state, not the variants' "
            "extra vectors")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    b = _as_rhs(b, a.device)
    if axis_name is None and a.shape[1] != b.shape[0]:
        raise ValueError(f"operator shape {a.shape} does not match rhs "
                         f"shape {tuple(b.shape)}")
    cap = maxiter if iter_cap is None else int(iter_cap)
    if m is not None and not isinstance(m, LinearOperator):
        m = _as_operator(m, a.device)
    if method != "cg":
        impl = _cg1 if method == "cg1" else _pipecg
        return impl(a, b, x0, m=m, tol=tol, rtol=rtol, maxiter=maxiter,
                    cap=cap, record_history=record_history,
                    check_every=check_every, compensated=compensated,
                    axis_name=axis_name)

    def dot(x, y):
        fn = blas1.dot_compensated if compensated else blas1.dot
        return fn(x, y, axis_name=axis_name)

    if resume_from is not None:
        c = resume_from
        x, r, p0 = (torch.as_tensor(v, device=a.device)
                    for v in (c.x, c.r, c.p))
        rho0, rr0, nrm0 = (torch.as_tensor(v, device=a.device).reshape(())
                           for v in (c.rho, c.rr, c.nrm0))
        k0 = int(c.k)
        indef0 = torch.as_tensor(c.indefinite, dtype=torch.bool,
                                 device=a.device).reshape(())
    else:
        x, r = _init_xr(a, b, x0)
        # unpreconditioned: z == r, so rho == rr and one reduction
        # suffices
        rr0 = dot(r, r)
        if m is None:
            p0, rho0 = r, rr0
        else:
            p0 = m @ r
            rho0 = dot(r, p0)
        nrm0 = torch.sqrt(rr0)
        k0 = 0
        indef0 = torch.zeros((), dtype=torch.bool, device=b.device)
    thresh_sq = _threshold_sq(tol, rtol, nrm0, b.dtype)
    state = _CGState(
        k=k0, x=x, r=r, p=p0, rho=rho0, rr=rr0, indefinite=indef0,
        history=_history_init(record_history, maxiter, b.dtype, k0,
                              torch.sqrt(rr0)))

    def step(s: _CGState) -> _CGState:
        ap = a @ s.p
        p_ap = dot(s.p, ap)                       # cublasDdot :304
        alpha = _safe_div(s.rho, p_ap)            # host arithmetic :311
        x = blas1.axpy(alpha, s.p, s.x)           # :314
        r = blas1.axpy(-alpha, ap, s.r)           # :320-321
        rr = dot(r, r)                            # cublasDnrm2 :328
        if m is None:
            z, rho = r, rr
        else:
            z = m @ r
            rho = dot(r, z)
        beta = _safe_div(rho, s.rho)              # :336-339
        p = blas1.xpby(z, beta, s.p)              # Dscal :342 + Daxpy :347
        k = s.k + 1
        if record_history:
            s.history[k] = torch.sqrt(rr)
        return _CGState(
            k=k, x=x, r=r, p=p, rho=rho, rr=rr,
            # s.rr > 0 excludes frozen post-exact-solve steps
            indefinite=s.indefinite | ((p_ap <= 0) & (s.rr > 0)),
            history=s.history)

    final = _blocked_while(_cond(maxiter, cap, thresh_sq), step, state,
                           check_every, _block_fits(maxiter, cap,
                                                    check_every))
    checkpoint = None
    if return_checkpoint:
        checkpoint = CGCheckpoint(
            x=final.x, r=final.r, p=final.p, rho=final.rho, rr=final.rr,
            nrm0=nrm0, k=torch.tensor(final.k, dtype=torch.int32,
                                      device=b.device),
            indefinite=final.indefinite)
    return _package(final, _cg_healthy(final), thresh_sq, record_history,
                    checkpoint)


def _cg_healthy(final) -> torch.Tensor:
    """``method="cg"``'s health: finite scalars and rho > 0 unless the
    system is solved exactly."""
    return torch.isfinite(final.rr) & torch.isfinite(final.rho) \
        & ((final.rho > 0) | (final.rr == 0))


def _cond(maxiter: int, cap: int, thresh_sq: torch.Tensor) -> Callable:
    """The loop predicate; the device part costs one host sync."""
    def cond(s) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        unconverged = s.rr >= thresh_sq
        # rr == 0 means the system is solved exactly; iterating further
        # would divide 0/0
        nontrivial = s.rr > 0
        # rho = r . M^-1 r <= 0 with r != 0 is a preconditioner breakdown
        # (M not SPD): stop rather than spin to maxiter
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


def _package(final, healthy: torch.Tensor, thresh_sq: torch.Tensor,
             record_history: bool, checkpoint=None) -> CGResult:
    """Shared epilogue: convergence/breakdown status + CGResult."""
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
        residual_history=final.history if record_history else None,
        checkpoint=checkpoint)


# -- single-reduction and pipelined variants ----------------------------------


def _make_fdots(compensated: bool, axis_name=None) -> Callable:
    """The inner products of one cg1/pipecg iteration, evaluated at one
    point: compensated double-float dots, or plain ones - on a mesh all
    of them in ONE reduction over ``axis_name``."""
    if compensated:
        def fdots(pairs):
            return blas1.fused_dots_compensated(pairs, axis_name=axis_name)
    elif axis_name is None:
        def fdots(pairs):
            return [blas1.dot(x, y) for x, y in pairs]
    else:
        def fdots(pairs):
            return list(blas1.fused_dots(pairs, axis_name=axis_name))
    return fdots


def _init_xr(a, b, x0):
    """x0/r0 init shared by every method (x0=None takes the reference's
    copy-only fast path, CUDACG.cu:247-259)."""
    if x0 is None:
        return torch.zeros_like(b), b
    x = torch.as_tensor(x0, device=b.device).to(b.dtype)
    return x, b - a @ x


def _variant_cond(maxiter: int, cap: int, thresh_sq) -> Callable:
    """Loop predicate of cg1/pipecg: unconverged, nontrivial and healthy
    (gamma = r . M^-1 r <= 0 with r != 0 is a preconditioner breakdown)."""
    def cond(st) -> bool:
        if not (st.k < maxiter and st.k < cap):
            return False
        healthy = torch.isfinite(st.rr) & torch.isfinite(st.gamma) \
            & torch.isfinite(st.alpha) & (st.gamma > 0)
        return bool((st.rr >= thresh_sq) & (st.rr > 0) & healthy)
    return cond


def _variant_healthy(final) -> torch.Tensor:
    return torch.isfinite(final.rr) & torch.isfinite(final.gamma) \
        & torch.isfinite(final.alpha) & ((final.gamma > 0) | (final.rr == 0))


def _first_dots(fdots, m, r, u, w):
    """``(rr, gamma, delta)`` of the variants: ``r . r``, ``r . u`` and
    ``w . u`` with ``u = M^-1 r``, ``w = A u``; two dots without ``m``."""
    if m is None:
        rr, delta = fdots([(r, r), (w, r)])
        return rr, rr, delta
    return tuple(fdots([(r, r), (r, u), (w, u)]))


class _CG1State(NamedTuple):
    k: int
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor       # A @ p, maintained by recurrence
    gamma: torch.Tensor   # r . u (u = M^-1 r; == ||r||^2 unpreconditioned)
    rr: torch.Tensor      # ||r||^2
    alpha: torch.Tensor   # step length for the NEXT x/r update
    indefinite: torch.Tensor
    history: torch.Tensor


def _cg1(a, b, x0, *, m, tol, rtol, maxiter, cap, record_history,
         check_every, compensated, axis_name=None) -> CGResult:
    """Chronopoulos-Gear single-reduction CG (the JAX ``_cg1``): the
    textbook iterates in exact arithmetic, with every inner product of
    an iteration evaluated at one point; one extra vector recurrence
    ``s = A p``."""
    fdots = _make_fdots(compensated, axis_name)
    x, r = _init_xr(a, b, x0)
    u0 = r if m is None else m @ r
    w0 = a @ u0
    rr0, gamma0, delta0 = _first_dots(fdots, m, r, u0, w0)
    alpha0 = _safe_div(gamma0, delta0)
    nrm0 = torch.sqrt(rr0)
    thresh_sq = _threshold_sq(tol, rtol, nrm0, b.dtype)
    state = _CG1State(
        k=0, x=x, r=r, p=u0, s=w0, gamma=gamma0, rr=rr0, alpha=alpha0,
        indefinite=(delta0 <= 0) & (rr0 > 0),
        history=_history_init(record_history, maxiter, b.dtype, 0, nrm0))

    def step(st: _CG1State) -> _CG1State:
        x = blas1.axpy(st.alpha, st.p, st.x)
        r = blas1.axpy(-st.alpha, st.s, st.r)
        u = r if m is None else m @ r
        w = a @ u
        rr, gamma, delta = _first_dots(fdots, m, r, u, w)
        beta = _safe_div(gamma, st.gamma)
        # == p_new . A p_new in exact arithmetic
        denom = delta - beta * _safe_div(gamma, st.alpha)
        alpha = _safe_div(gamma, denom)
        k = st.k + 1
        if record_history:
            st.history[k] = torch.sqrt(rr)
        return _CG1State(
            k=k, x=x, r=r, p=blas1.xpby(u, beta, st.p),
            s=blas1.xpby(w, beta, st.s), gamma=gamma, rr=rr, alpha=alpha,
            # rr > 0 excludes frozen post-exact-solve steps
            indefinite=st.indefinite | ((denom <= 0) & (rr > 0)),
            history=st.history)

    final = _blocked_while(_variant_cond(maxiter, cap, thresh_sq), step,
                           state, check_every,
                           _block_fits(maxiter, cap, check_every))
    return _package(final, _variant_healthy(final), thresh_sq,
                    record_history)


def _replace_cadence(dtype) -> int:
    """Pipelined-CG residual-replacement cadence (the JAX
    ``_replace_cadence``): every 16 iterations in f32, where drift must
    be reset before the recurrence and true residuals part, and every
    512 in f64, where drift is slow."""
    return 16 if dtype.itemsize <= 4 else 512


class _PipeCGState(NamedTuple):
    k: int
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor       # M^-1 r
    w: torch.Tensor       # A u
    p: torch.Tensor
    s: torch.Tensor       # A p
    q: torch.Tensor       # M^-1 s
    z: torch.Tensor       # A q
    gamma: torch.Tensor   # r . u
    rr: torch.Tensor      # ||r||^2
    alpha: torch.Tensor
    indefinite: torch.Tensor
    history: torch.Tensor


def _pipecg(a, b, x0, *, m, tol, rtol, maxiter, cap, record_history,
            check_every, compensated, axis_name=None) -> CGResult:
    """Ghysels-Vanroose pipelined CG (the JAX ``_pipecg``): one fused
    reduction per iteration whose inputs precede the iteration's matvec,
    three extra vector recurrences, and residual replacement every
    :func:`_replace_cadence` iterations (every derived vector recomputed
    from its definition) to bound the recurrence drift."""
    fdots = _make_fdots(compensated, axis_name)
    x, r = _init_xr(a, b, x0)
    u0 = r if m is None else m @ r
    w0 = a @ u0
    rr0, gamma0, delta0 = _first_dots(fdots, m, r, u0, w0)
    m0 = w0 if m is None else m @ w0
    n0 = a @ m0
    alpha0 = _safe_div(gamma0, delta0)
    nrm0 = torch.sqrt(rr0)
    thresh_sq = _threshold_sq(tol, rtol, nrm0, b.dtype)
    cadence = _replace_cadence(b.dtype)
    state = _PipeCGState(
        k=0, x=x, r=r, u=u0, w=w0, p=u0, s=w0, q=m0, z=n0, gamma=gamma0,
        rr=rr0, alpha=alpha0, indefinite=(delta0 <= 0) & (rr0 > 0),
        history=_history_init(record_history, maxiter, b.dtype, 0, nrm0))

    def step(st: _PipeCGState) -> _PipeCGState:
        x = blas1.axpy(st.alpha, st.p, st.x)
        k = st.k + 1
        if k % cadence == 0:
            # residual replacement: the replaced (s, q, z) feed this
            # step's beta-updates, so the direction recurrences reset too
            r = b - a @ x
            u = r if m is None else m @ r
            w = a @ u
            s_old = a @ st.p
            q_old = s_old if m is None else m @ s_old
            z_old = a @ q_old
        else:
            r = blas1.axpy(-st.alpha, st.s, st.r)
            u = blas1.axpy(-st.alpha, st.q, st.u)
            w = blas1.axpy(-st.alpha, st.z, st.w)
            s_old, q_old, z_old = st.s, st.q, st.z
        rr, gamma, delta = _first_dots(fdots, m, r, u, w)
        mm = w if m is None else m @ w
        n = a @ mm
        beta = _safe_div(gamma, st.gamma)
        denom = delta - beta * _safe_div(gamma, st.alpha)
        alpha = _safe_div(gamma, denom)
        if record_history:
            st.history[k] = torch.sqrt(rr)
        return _PipeCGState(
            k=k, x=x, r=r, u=u, w=w, p=blas1.xpby(u, beta, st.p),
            s=blas1.xpby(w, beta, s_old), q=blas1.xpby(mm, beta, q_old),
            z=blas1.xpby(n, beta, z_old), gamma=gamma, rr=rr, alpha=alpha,
            indefinite=st.indefinite | ((denom <= 0) & (rr > 0)),
            history=st.history)

    final = _blocked_while(_variant_cond(maxiter, cap, thresh_sq), step,
                           state, check_every,
                           _block_fits(maxiter, cap, check_every))
    return _package(final, _variant_healthy(final), thresh_sq,
                    record_history)


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


def _as_operator(a, device=None) -> LinearOperator:
    """A raw matrix as a ``DenseOperator``: a tensor keeps its device,
    anything else goes to ``device`` (``None``: the default, cuda).  The
    f64 lane's ``ShiftELLDF64Matrix`` is refused, as in the JAX package."""
    if isinstance(a, ShiftELLDF64Matrix):
        raise TypeError(
            "ShiftELLDF64Matrix is a double-float operator: use "
            "solver.df64.cg_df64, not the f32 solve path")
    if isinstance(a, torch.Tensor):
        device = a.device
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
    operator and preconditioner), ``"resident"`` (the whole solve in one
    launch of the resident kernel, ``solver.resident`` - f32 stencils
    whose working set fits the card's L2; raises if out of scope),
    ``"streaming"`` (the fused two-kernel iteration, ``solver.streaming``
    - f32 stencils of any size; raises if out of scope) or ``"auto"`` (on
    a Hopper card: resident when eligible, else streaming when eligible,
    else general; general elsewhere).  The fused engines take ``m=None``
    or a ``ChebyshevPreconditioner`` built over the stencil being solved,
    which they apply inside their kernels; any other ``m`` keeps
    ``"auto"`` on the general engine.  ``method="cg1"`` (unpreconditioned)
    runs on the resident kernel's cg1 form; ``"pipecg"``, ``"minres"``,
    and ``"cg1"`` outside the resident engine, take the general engine
    (an explicit resident or streaming engine refuses them).  ``"auto"`` keeps
    ``record_history`` requests off the resident engine, whose trace is
    check-block granular; an explicit ``engine="resident"`` returns that
    trace.
    """
    if engine not in ("general", "auto", "resident", "streaming"):
        raise ValueError(f"unknown engine {engine!r}; expected 'general', "
                         f"'auto', 'resident' or 'streaming'")
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    if method == "minres" and engine in ("general", "auto"):
        # both engines end in cg(), which refuses these first
        _refuse_minres(flight, m, resume_from, return_checkpoint,
                       compensated)
    _refuse_unported(method, flight=flight, fault=fault, deflate=deflate,
                     basis=basis)
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
                "L2, 7 with a Chebyshev preconditioner, 6 for cg1), a "
                "float32 rhs, m=None or a Chebyshev preconditioner built "
                "over this operator, method='cg' (or the unpreconditioned "
                "'cg1'), f32 x0 or none, and no checkpointing - use "
                "engine='general' (or 'auto') otherwise")
        if eligible:
            return cg_resident(a, b, x0, tol=tol, rtol=rtol,
                               maxiter=maxiter, check_every=check_every,
                               iter_cap=iter_cap, m=m,
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
                "float32 rhs and x0, m=None or a Chebyshev "
                "preconditioner built over this operator, method='cg' "
                "and no checkpointing - use engine='general' (or 'auto') "
                "otherwise")
        if eligible:
            return cg_streaming(a, b, x0, tol=tol, rtol=rtol,
                                maxiter=maxiter, check_every=check_every,
                                iter_cap=iter_cap, m=m,
                                record_history=record_history)
    return cg(a, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, m=m,
              record_history=record_history, resume_from=resume_from,
              return_checkpoint=return_checkpoint, iter_cap=iter_cap,
              check_every=check_every, method=method,
              compensated=compensated)
