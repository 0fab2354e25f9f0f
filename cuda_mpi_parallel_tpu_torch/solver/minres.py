"""MINRES: the solver for symmetric INDEFINITE systems.

Counterpart of the JAX package's ``solver/minres.py``.  The reference's
own 3x3 system is symmetric indefinite (eigenvalues {-0.236, 2, 4.236},
SURVEY quirk Q1, ``CUDACG.cu:76-78``) and plain CG converges on it only
by luck.  MINRES (Paige & Saunders 1975) is a Lanczos three-term
recurrence whose tridiagonal least-squares problem is solved by a running
QR of Givens rotations: the residual never grows and nothing assumes
positivity.

The loop runs eagerly as the port's ``cg`` does: every scalar of the
recurrence is a 0-d tensor on the operator's device, the inner products
go through ``ops.blas1.dot`` (with ``axis_name`` they reduce over the
mesh, so ``parallel.solve_distributed(..., method="minres")`` runs this
body on each shard), and the continue predicate - one combined device
boolean - is read on the host once per ``check_every`` block.  Steps
that run past Krylov exhaustion inside a block are frozen by the same
``torch.where`` guards as the JAX recurrence, so they yield no NaN.

:func:`minres_df64` is the same recurrence in the f64 lane (float64
throughout, where the JAX package carries double-float pairs), returning
a ``DF64CGResult``.

Scope: unpreconditioned (``m`` is refused by ``cg``/``solve``), any
``LinearOperator``; the matvec is the operator's own, so a stencil with
``backend="pallas"`` runs B1/B2 and a ``ShiftELLMatrix`` B8 on the card,
and ``minres_df64`` on a ``ShiftELLDF64Matrix`` runs B9.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.operators import LinearOperator
from ..ops import blas1
from .status import CGStatus


class _State(NamedTuple):
    k: int                # iterations done (host int: the loop is host-driven)
    x: torch.Tensor
    r1: torch.Tensor      # the two scaled Lanczos residuals
    r2: torch.Tensor
    oldb: torch.Tensor
    beta: torch.Tensor
    dbar: torch.Tensor
    epsln: torch.Tensor   # one step delayed
    phibar: torch.Tensor  # the recurrence residual norm
    cs: torch.Tensor      # the last rotation
    sn: torch.Tensor
    w: torch.Tensor       # the last two update directions
    w2: torch.Tensor
    indefinite: torch.Tensor
    history: torch.Tensor


def _cond(maxiter: int, cap: int, thresh: torch.Tensor):
    """The JAX continue predicate: unconverged (>= keeps the exact tie
    iterating), nontrivial, finite, within the caps, and beta > 0 (beta
    == 0 means the Krylov space is exhausted: the solution is exact in
    it).  The device part is one boolean, one host read."""
    def cond(s: _State) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        return bool((s.phibar >= thresh) & (s.phibar > 0)
                    & torch.isfinite(s.phibar) & (s.beta > 0))
    return cond


def _step(matvec, dot, eps: torch.Tensor, record_history: bool):
    """One Paige-Saunders step, the JAX ``step``'s operations in its
    order."""
    one, zero = torch.ones_like(eps), torch.zeros_like(eps)

    def step(s: _State) -> _State:
        beta, oldb = s.beta, s.oldb
        beta_safe = torch.where(beta == 0, one, beta)
        v = s.r2 / beta_safe
        y = matvec(v)
        # y -= (beta/oldb) r1 == beta_k v_{k-1}; absent at k = 0
        factor = (beta / torch.where(oldb == 0, one, oldb) if s.k > 0
                  else zero)
        y = y - factor * s.r1
        alfa = dot(v, y)
        indefinite = s.indefinite | (alfa < 0)
        y = y - (alfa / beta_safe) * s.r2
        beta_n = torch.sqrt(dot(y, y))
        # the previous rotations applied to the new tridiagonal column,
        # then the new rotation annihilating beta_{k+1}
        oldeps = s.epsln
        delta = s.cs * s.dbar + s.sn * alfa
        gbar = s.sn * s.dbar - s.cs * alfa
        epsln = s.sn * beta_n
        dbar = -s.cs * beta_n
        gamma = torch.maximum(torch.sqrt(gbar * gbar + beta_n * beta_n), eps)
        cs = gbar / gamma
        sn = beta_n / gamma
        phi = cs * s.phibar
        phibar = sn * s.phibar
        # direction update and solution step
        w1, w2 = s.w2, s.w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = s.x + phi * w
        k = s.k + 1
        if record_history:
            s.history[k] = phibar.to(s.history.dtype)
        return _State(k=k, x=x, r1=s.r2, r2=y, oldb=beta, beta=beta_n,
                      dbar=dbar, epsln=epsln, phibar=phibar, cs=cs, sn=sn,
                      w=w, w2=w2, indefinite=indefinite, history=s.history)
    return step


def _run(matvec, dot, x, r0, beta1, thresh, eps, *, maxiter: int, cap: int,
         check_every: int, history: torch.Tensor,
         record_history: bool) -> _State:
    """The blocked loop from the initial state (``cs = -1``)."""
    from .cg import _block_fits, _blocked_while

    zero = torch.zeros_like(beta1)
    state = _State(
        k=0, x=x, r1=r0, r2=r0, oldb=zero, beta=beta1, dbar=zero,
        epsln=zero, phibar=beta1, cs=-torch.ones_like(beta1), sn=zero,
        w=torch.zeros_like(r0), w2=torch.zeros_like(r0),
        indefinite=torch.zeros((), dtype=torch.bool, device=r0.device),
        history=history)
    return _blocked_while(_cond(maxiter, cap, thresh),
                          _step(matvec, dot, eps, record_history), state,
                          check_every, _block_fits(maxiter, cap, check_every))


def _status(converged, healthy) -> torch.Tensor:
    """The JAX status order: CONVERGED, then BREAKDOWN, then MAXITER."""
    dev = converged.device

    def code(s):
        return torch.tensor(int(s), dtype=torch.int32, device=dev)
    return torch.where(converged, code(CGStatus.CONVERGED),
                       torch.where(~healthy, code(CGStatus.BREAKDOWN),
                                   code(CGStatus.MAXITER)))


def minres(
    a,
    b,
    x0=None,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    record_history: bool = False,
    axis_name=None,
    iter_cap=None,
    check_every: int = 1,
):
    """Solve the symmetric (possibly indefinite) system ``A x = b``.

    Arguments mirror ``solver.cg.cg``: absolute ``tol`` (quirk Q3),
    ``rtol`` relative (threshold ``max(tol, rtol * ||r0||)``), ``iter_cap``
    a further bound <= ``maxiter``, ``check_every`` the predicate's block
    (iterates identical to ``check_every=1``, up to k - 1 frozen extra
    steps), ``x0`` a warm start (``None``: r0 = b, no SpMV).  The residual
    norm tracked is MINRES's recurrence residual ``phibar``.

    Returns a ``CGResult`` on ``a``'s device; ``indefinite`` reports
    whether a negative ``v . A v`` Rayleigh quotient was observed (the
    certificate that CG would not have been guaranteed here).
    """
    from .cg import CGResult, _as_operator, _as_rhs, _threshold_sq

    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    b = _as_rhs(b, a.device)
    if axis_name is None and a.shape[1] != b.shape[0]:
        raise ValueError(f"operator shape {a.shape} does not match rhs "
                         f"shape {tuple(b.shape)}")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")

    def dot(x, y):
        return blas1.dot(x, y, axis_name=axis_name)

    cap = maxiter if iter_cap is None else int(iter_cap)
    dtype = b.dtype
    eps = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=b.device)
    if x0 is None:
        x = torch.zeros_like(b)
        r0 = b                       # x0 = 0 fast path (CUDACG.cu:247-259)
    else:
        x = torch.as_tensor(x0, device=b.device).to(dtype)
        r0 = b - a @ x
    beta1 = torch.sqrt(dot(r0, r0))
    thresh = torch.sqrt(_threshold_sq(tol, rtol, beta1, dtype))
    history = torch.full((maxiter + 1 if record_history else 0,),
                         float("nan"), dtype=dtype, device=b.device)
    if record_history:
        history[0] = beta1
    final = _run(a.matvec, dot, x, r0, beta1, thresh, eps, maxiter=maxiter,
                 cap=cap, check_every=check_every, history=history,
                 record_history=record_history)
    phibar = final.phibar
    # Krylov exhaustion (beta == 0) collapses phibar to 0 through the
    # last rotation (sn = 0): CONVERGED with the subspace's least-squares
    # solution, exact for a consistent system.  For a singular,
    # inconsistent one phibar is not ||b - A x||: check the true residual.
    converged = (phibar < thresh) | (phibar == 0)
    return CGResult(
        x=final.x,
        iterations=torch.tensor(final.k, dtype=torch.int32, device=b.device),
        residual_norm=phibar, converged=converged,
        status=_status(converged, torch.isfinite(phibar)),
        indefinite=final.indefinite,
        residual_history=final.history if record_history else None)


def minres_df64(
    a,
    b,
    *,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    record_history: bool = False,
    axis_name=None,
    iter_cap=None,
    check_every: int = 1,
):
    """MINRES in the f64 lane: the recurrence of :func:`minres` in
    float64, on the operators and right-hand sides ``solver.df64.cg_df64``
    takes (a ``ShiftELLDF64Matrix`` runs B9 on the card).  The gamma
    floor is float32's ``tiny``, as in the JAX double-float recurrence;
    the threshold is ``max(tol, rtol * ||b||)`` on ``phibar``.  Returns a
    ``DF64CGResult`` (``x64`` the float64 solution, ``x_hi``/``x_lo`` its
    split, ``residual_norm_sq`` = ``phibar^2``; the history holds
    ``phibar`` rounded to float32).  ``axis_name``: the mesh axis of a
    per-shard body, ``a`` a ``parallel.df64.DistStencilDF64`` slab and
    ``b`` its local right-hand side; the dots reduce over the mesh
    (``ops.blas1.dot``), as in the JAX package's distributed f64 lane."""
    from .df64 import _coerce_rhs_df, _prepare_operator, _result

    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    op = _prepare_operator(a)
    b64 = _coerce_rhs_df(b).to(op.device)
    if tuple(b64.shape) != (op.n,):
        raise ValueError(f"rhs shape {tuple(b64.shape)} does not match the "
                         f"operator's {op.n} rows")
    cap = maxiter if iter_cap is None else int(iter_cap)
    dev = b64.device
    eps = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float64,
                       device=dev)
    def dot(x, y):
        return blas1.dot(x, y, axis_name=axis_name)

    beta1 = torch.sqrt(dot(b64, b64))
    thresh = torch.maximum(
        torch.tensor(float(tol), dtype=torch.float64, device=dev),
        float(rtol) * beta1)
    history = torch.full((maxiter + 1 if record_history else 0,),
                         float("nan"), dtype=torch.float32, device=dev)
    if record_history:
        history[0] = beta1.float()
    final = _run(op.matvec, dot, torch.zeros_like(b64), b64, beta1,
                 thresh, eps, maxiter=maxiter, cap=cap,
                 check_every=check_every, history=history,
                 record_history=record_history)
    phibar = final.phibar
    converged = (phibar < thresh) | (phibar == 0)
    return _result(final.x, final.k, phibar * phibar, converged,
                   _status(converged, torch.isfinite(phibar)),
                   final.indefinite,
                   final.history if record_history else None)
