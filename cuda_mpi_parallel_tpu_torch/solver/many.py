"""Many-RHS solver tier: masked batched CG and true block-CG.

Counterpart of the JAX package's ``solver/many.py``.  ``cg_many`` solves
``A X = B`` for a column stack ``B`` of shape ``(n, k)`` with ONE matrix
sweep (``LinearOperator.matmat``: one launch of the stencils'
column-stack kernels, one segment sum of a CSR matrix) and one ``(k,)``
reduction per inner product (``blas1.dot_many``: ONE psum on a mesh) per
iteration, in two flavors:

* **masked batched CG** (``method="batched"``): ``k`` textbook CG
  recurrences in lockstep; alpha/beta/rr are per-lane ``(k,)`` tensors
  and a convergence mask freezes finished lanes (a ``torch.where``
  select per update, so a frozen lane keeps its columns bit for bit and
  no NaN computed for it leaks).  The loop runs until the LAST live lane
  meets its tolerance.  Lanes are arithmetically independent: at
  ``check_every=1`` lane ``j``'s iterates, count and status are those of
  the port's single-RHS ``cg`` of column ``j``, bit for bit (the tests
  assert it at ``k = 1`` and per lane).  Under ``check_every > 1`` the
  single-RHS solver runs up to k-1 unmasked steps past convergence
  inside a block while a batched lane freezes at its convergence step.
* **true block-CG** (``method="block"``, O'Leary 1980): the search
  directions span a k-dimensional block Krylov space coupled through
  ``k x k`` Gram solves (Cholesky), so convergence takes fewer
  iterations than the independent recurrences.  Rank collapse
  (converged or duplicate columns make a Gram singular) is deflated
  in-lane by an eigenvalue pseudo-inverse; a state that goes non-finite
  even so freezes one step before poisoning, and a masked batched
  continuation finishes the live lanes from the frozen iterate.

Host reads.  Both lanes keep every scalar on the device.  The batched
lane reads the loop predicate once per ``check_every`` block, as
``solver.cg`` does.  The block lane reads it as well, and in addition
one flag per Gram solve - two an iteration - because the JAX
``lax.cond`` between the Cholesky solve and the pseudo-inverse picks a
branch by data: the port runs ``torch.linalg.cholesky_ex`` (no sync; a
non-SPD Gram gives ``info != 0``, the JAX NaN factor) and reads whether
the factor and its solve are finite before it decides whether to run
``torch.linalg.eigh``.

Stacks are column-major inside the solver (``(k, n)`` storage seen as
``(n, k)``): each lane's columns are contiguous vectors, as the
single-RHS solve's are, which is what lets ``dot_many`` reduce each with
the single dot.  The result's ``x`` is an ``(n, k)`` tensor as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.operators import LinearOperator
from ..ops import blas1
from .cg import (
    CGResult,
    _as_operator,
    _as_rhs,
    _blocked_while,
    _note_engine,
    _safe_div,
)
from .status import CGStatus

__all__ = ["CGBatchResult", "cg_many", "solve_many", "stack_columns"]

#: batched-solver recurrences accepted by :func:`cg_many`
MANY_METHODS = ("batched", "block")

#: relative eigenvalue floor below which a Gram direction reads as
#: collapsed (converged/duplicate column) and is deflated in-lane
GRAM_DEFLATE_RTOL = 1e-10


def stack_columns(columns, k: int, dtype=None):
    """Stack 1-D right-hand sides into a zero-padded ``(n, k)`` numpy
    batch (the serving tier's bucket padding: the ``k - m`` pad lanes
    carry ``b = 0``, which both recurrences freeze at iteration 0).
    ``dtype=None`` takes the common numpy result type of the columns."""
    if k < 1:
        raise ValueError(f"bucket size must be >= 1, got {k}")
    cols = [np.asarray(c.detach().cpu() if isinstance(c, torch.Tensor)
                       else c) for c in columns]
    if not cols:
        raise ValueError("stack_columns needs at least one column")
    if len(cols) > k:
        raise ValueError(
            f"{len(cols)} columns do not fit a k={k} bucket")
    n = cols[0].shape[0]
    for c in cols:
        if c.ndim != 1 or c.shape[0] != n:
            raise ValueError(
                f"columns must be 1-D of one length, got shapes "
                f"{[c.shape for c in cols]}")
    if dtype is None:
        dtype = np.result_type(*cols)
    out = np.zeros((n, k), dtype=dtype)
    for j, c in enumerate(cols):
        out[:, j] = c
    return out


@dataclasses.dataclass(frozen=True)
class CGBatchResult:
    """Per-lane outcome of a many-RHS solve: every field after ``x`` is a
    ``(k,)`` per-lane tensor; :meth:`lane` gives one column's
    ``CGResult``."""

    x: torch.Tensor               # (n, k) solution stack
    iterations: torch.Tensor      # (k,) per-lane iterations to freeze
    residual_norm: torch.Tensor   # (k,) final ||r_j||_2
    converged: torch.Tensor       # (k,) bool
    status: torch.Tensor          # (k,) CGStatus int codes
    indefinite: torch.Tensor      # (k,) bool: lane saw p.Ap <= 0
    #: batched flight buffer (capacity, 1 + 3k) when a FlightConfig was
    #: passed; decode with telemetry.flight.lanes_from_buffer
    flight: Optional[torch.Tensor] = None
    #: block-CG only: True when the Gram solve broke down past the
    #: in-lane rank deflation and the masked batched continuation
    #: finished the solve (None = batched)
    fallback: Optional[torch.Tensor] = None
    #: Krylov-recycling basis ring ``(iterations, vectors)`` when a
    #: recycle.BasisConfig was passed (one lane's normalized residuals)
    basis: Optional[tuple] = None

    @property
    def n_rhs(self) -> int:
        return int(self.x.shape[1])

    def lane(self, j: int) -> CGResult:
        """A single column's result as a standard ``CGResult`` (the
        flight buffer is not sliced - use
        ``telemetry.flight.lanes_from_buffer`` on ``self.flight``)."""
        return CGResult(
            x=self.x[:, j], iterations=self.iterations[j],
            residual_norm=self.residual_norm[j],
            converged=self.converged[j], status=self.status[j],
            indefinite=self.indefinite[j], residual_history=None)

    def status_enums(self):
        return [CGStatus(int(s)) for s in self.status.cpu().tolist()]


class _ManyState(NamedTuple):
    k: int                  # loop iteration (host int: the loop is host-driven)
    x: torch.Tensor         # (n, k)
    r: torch.Tensor         # (n, k)
    p: torch.Tensor         # (n, k)
    rho: torch.Tensor       # (k,) r . z per lane
    rr: torch.Tensor        # (k,) ||r||^2 per lane
    iters: torch.Tensor     # (k,) per-lane iterations (frozen with lane)
    indefinite: torch.Tensor  # (k,) bool


class _BlockState(NamedTuple):
    k: int                  # steps taken (host int)
    kd: torch.Tensor        # () int32 steps that went through (JAX's k)
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor     # (k, k) Gram R^T Z
    rr: torch.Tensor
    iters: torch.Tensor
    indefinite: torch.Tensor
    broke: torch.Tensor     # () bool: Gram solve went non-finite


def _cols(t: torch.Tensor) -> torch.Tensor:
    """``t (n, k)`` column-major (no copy when it is already)."""
    return t.t().contiguous().t()


def _threshold_sq_many(tol, rtol, nrm0: torch.Tensor, dtype) -> torch.Tensor:
    """Per-lane squared threshold ``max(tol, rtol * ||r0_j||)^2``;
    ``tol``/``rtol`` scalars or ``(k,)`` per-lane arrays.  Per lane the
    same two roundings as ``solver.cg``'s ``_threshold_sq``."""
    dev = nrm0.device
    threshold = torch.maximum(
        torch.as_tensor(np.asarray(_host(tol), np.float64), dtype=dtype,
                        device=dev).broadcast_to(nrm0.shape),
        torch.as_tensor(np.asarray(_host(rtol), np.float64), dtype=dtype,
                        device=dev) * nrm0)
    return threshold * threshold


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _active_lanes(rr, rho, thresh_sq):
    """Per-lane liveness: unconverged, nontrivial (rr > 0) and healthy
    (finite scalars, SPD rho) - ``cg``'s predicate, per lane."""
    unconverged = rr >= thresh_sq
    nontrivial = rr > 0
    healthy = torch.isfinite(rr) & torch.isfinite(rho) & (rho > 0)
    return unconverged & nontrivial & healthy


def _select_lanes(mask, new, old):
    """Per-lane select of an ``(n, k)`` stack update: frozen lanes keep
    their column bit for bit."""
    return _cols(torch.where(mask[None, :], new, old))


def _package_many(final, thresh_sq, flight_buf=None, fallback=None,
                  basis_buf=None) -> CGBatchResult:
    """Per-lane epilogue: ``cg``'s status derivation, per lane."""
    converged = (final.rr < thresh_sq) | (final.rr == 0)
    healthy = torch.isfinite(final.rr) & torch.isfinite(final.rho) \
        & ((final.rho > 0) | (final.rr == 0))
    dev = final.rr.device

    def code(status):
        return torch.full((), int(status), dtype=torch.int32, device=dev)

    status = torch.where(converged, code(CGStatus.CONVERGED),
                         torch.where(~healthy, code(CGStatus.BREAKDOWN),
                                     code(CGStatus.MAXITER)))
    return CGBatchResult(
        x=final.x, iterations=final.iters,
        residual_norm=torch.sqrt(final.rr), converged=converged,
        status=status, indefinite=final.indefinite, flight=flight_buf,
        fallback=fallback, basis=basis_buf)


def cg_many(
    a,
    b,
    x0=None,
    *,
    tol=1e-7,
    rtol=0.0,
    maxiter: int = 2000,
    m=None,
    axis_name=None,
    iter_cap=None,
    check_every: int = 1,
    method: str = "batched",
    compensated: bool = False,
    flight=None,
    fault=None,
    deflate=None,
    basis=None,
) -> CGBatchResult:
    """Solve ``A X = B`` for all columns of ``B`` in one loop.

    Arguments as in the JAX ``cg_many``: ``b`` the ``(n, k)`` stack,
    ``x0`` an optional initial stack; ``tol``/``rtol`` scalars or per-lane
    ``(k,)`` arrays; ``m`` an optional preconditioner (applied through
    ``matmat``); ``axis_name`` the mesh axis of a row-partitioned body
    (all ``k`` partials of a reduction ride one psum); ``method``
    ``"batched"`` or ``"block"`` (see the module docstring);
    ``compensated`` the double-float per-lane dots (batched only);
    ``flight`` a ``telemetry.flight.FlightConfig`` - the batched
    recorder, ``(capacity, 1 + 3k)`` (batched only); ``deflate`` a
    ``recycle.RecycleSpace`` deflating every lane (batched only; its
    ``(k_defl, k)`` projection reduction fuses into the residual psum);
    ``basis`` a ``recycle.BasisConfig`` - the harvest ring of lane
    ``basis.lane`` (needs ``flight``; batched only); ``fault`` a
    ``robust.FaultPlan`` (batched only): the array sites poison one row
    of the whole stack, the ``reduction`` site lane ``fault.lane``'s
    ``p . Ap`` only, so that lane breaks down typed while its batchmates
    run on.
    """
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    b = _as_rhs(b, a.device)
    if b.ndim != 2:
        raise ValueError(
            f"cg_many solves a column stack: b must be (n, k), got "
            f"shape {tuple(b.shape)} (use solver.cg for a single RHS)")
    if axis_name is None and a.shape[1] != b.shape[0]:
        raise ValueError(f"operator shape {a.shape} does not match rhs "
                         f"stack shape {tuple(b.shape)}")
    if method not in MANY_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{MANY_METHODS}")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if flight is not None and method != "batched":
        raise ValueError(
            "the batched flight recorder records per-lane (rr, alpha, "
            "beta) scalars; block-CG's recurrence coefficients are "
            "k x k matrices - use method='batched' with flight, or "
            "drop the recorder")
    if compensated and method != "batched":
        raise ValueError("compensated dots ride the per-lane batched "
                         "recurrence only")
    if fault is not None:
        fault._check_lane(
            a, 1 if axis_name is None else getattr(a, "n_shards", 1),
            method=method, allowed="batched")
    from .recycle import check_recycling

    check_recycling(deflate, basis, method=method, rides="batched",
                    flight=flight,
                    conflict=("compensated dots" if compensated
                              and deflate is not None
                              else "fault injection" if fault is not None
                              and deflate is not None else None))
    if basis is not None and basis.lane >= b.shape[1]:
        raise ValueError(f"basis.lane={basis.lane} out of range for a "
                         f"{b.shape[1]}-column stack")
    if m is not None and not isinstance(m, LinearOperator):
        m = _as_operator(m, a.device)
    b = _cols(b)
    cap = maxiter if iter_cap is None else int(iter_cap)
    dot_many = partial(
        blas1.dot_many_compensated if compensated else blas1.dot_many,
        axis_name=axis_name)

    if x0 is None:
        x, r = torch.zeros_like(b), b   # r0 = B - A@0 = B: copy-only init
    else:
        x = _cols(torch.as_tensor(x0, device=b.device).to(b.dtype))
        r = _cols(b - a.matmat(x))
    if deflate is not None:
        # Galerkin entry correction, column-wise: every lane's r0 starts
        # orthogonal to the recycled space
        from .recycle import entry_project

        x, r = entry_project(deflate, x, r, axis_name)
        x, r = _cols(x), _cols(r)
    rr0 = dot_many(r, r)
    if m is not None:
        z = _cols(m.matmat(r))
        rho0 = dot_many(r, z)
    else:
        z, rho0 = r, rr0
    thresh_sq = _threshold_sq_many(tol, rtol, torch.sqrt(rr0), b.dtype)
    n_rhs = b.shape[1]
    iters0 = torch.zeros(n_rhs, dtype=torch.int32, device=b.device)
    indef0 = torch.zeros(n_rhs, dtype=torch.bool, device=b.device)

    if method == "block":
        bstate = _BlockState(
            k=0, kd=torch.zeros((), dtype=torch.int32, device=b.device),
            x=x, r=r, p=z, gamma=blas1.gram(r, z, axis_name=axis_name),
            rr=rr0, iters=iters0, indefinite=indef0,
            broke=torch.zeros((), dtype=torch.bool, device=b.device))
        final, fell_back = _run_block(a, m, bstate, thresh_sq, maxiter,
                                      cap, check_every, dot_many,
                                      axis_name)
        return _package_many(final, thresh_sq, fallback=fell_back)

    if deflate is None:
        p0 = z
    else:
        from .recycle import project_direction

        p0 = _cols(project_direction(deflate, z, axis_name))
    state = _ManyState(k=0, x=x, r=r, p=p0, rho=rho0, rr=rr0,
                       iters=iters0, indefinite=indef0)
    final, fbuf, bbuf = _run_batched(a, m, state, thresh_sq, maxiter, cap,
                                     check_every, dot_many, flight, b.dtype,
                                     axis_name=axis_name, deflate=deflate,
                                     basis=basis, fault=fault)
    return _package_many(final, thresh_sq, flight_buf=fbuf, basis_buf=bbuf)


def _batched_step_fn(a, m, thresh_sq, dot_many, axis_name=None,
                     deflate=None, fault=None):
    """One masked batched CG step: ``(new_state, k, rr, alpha, beta)`` -
    the step plus its per-lane recording scalars (frozen lanes' alpha
    and beta NaN).  ``fault`` arms the injection sites exactly as in
    ``cg``'s step (``fault=None`` is the untouched path)."""
    def step_ab(s: _ManyState):
        act = _active_lanes(s.rr, s.rho, thresh_sq)
        if fault is None:
            ap = _cols(a.matmat(s.p))             # ONE sweep, all lanes
        else:
            ap = _cols(fault.apply_matvec(a, s.p, s.k, axis_name))
        p_ap = dot_many(s.p, ap)
        if fault is not None:
            p_ap = fault.poison_reduction(p_ap, s.k)
        alpha = _safe_div(s.rho, p_ap)
        x = _select_lanes(act, blas1.axpy_many(alpha, s.p, s.x), s.x)
        r = _select_lanes(act, blas1.axpy_many(-alpha, ap, s.r), s.r)
        if deflate is None:
            rr_new = dot_many(r, r)
            if m is not None:
                z = _cols(m.matmat(r))
                rho_new = dot_many(r, z)
            else:
                z, rho_new = r, rr_new
            beta = _safe_div(rho_new, s.rho)
            p_new = blas1.xpby_many(z, beta, s.p)
        else:
            # the deflated lane: per-lane rr/rho and the (k_defl, k)
            # projection ride ONE fused reduction
            from .recycle import chol_solve, fused_deflated_dots

            z = _cols(m.matmat(r)) if m is not None else r
            rr_new, rho_new, wz = fused_deflated_dots(
                deflate, r, z, m is not None, axis_name)
            beta = _safe_div(rho_new, s.rho)
            p_new = blas1.xpby_many(z, beta, s.p) \
                - deflate.w @ chol_solve(deflate.chol, wz)
        rr = torch.where(act, rr_new, s.rr)
        rho = torch.where(act, rho_new, s.rho)
        p = _select_lanes(act, p_new, s.p)
        k = s.k + 1
        nan = torch.full_like(alpha, float("nan"))
        return _ManyState(
            k=k, x=x, r=r, p=p, rho=rho, rr=rr,
            iters=s.iters + act.to(torch.int32),
            # s.rr > 0 excludes frozen lanes (p = 0 gives p.Ap = 0)
            indefinite=s.indefinite | ((p_ap <= 0) & (s.rr > 0) & act),
        ), k, rr, torch.where(act, alpha, nan), torch.where(act, beta, nan)
    return step_ab


def _many_cond(maxiter: int, cap: int, thresh_sq):
    """The batched loop predicate: one host read."""
    def cond(s) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        return bool(torch.any(_active_lanes(s.rr, s.rho, thresh_sq)))
    return cond


def _many_fits(maxiter: int, cap: int, check_every: int):
    def fits(s) -> bool:
        return s.k + check_every <= maxiter and s.k + check_every <= cap
    return fits


def _run_batched(a, m, state, thresh_sq, maxiter, cap, check_every,
                 dot_many, flight, dtype, axis_name=None, deflate=None,
                 basis=None, fault=None):
    """The masked batched loop (and the optional flight recorder and
    recycling basis ring).  Returns ``(final, flight_buf, basis_buf)``."""
    step_ab = _batched_step_fn(a, m, thresh_sq, dot_many,
                               axis_name=axis_name, deflate=deflate,
                               fault=fault)
    cond = _many_cond(maxiter, cap, thresh_sq)
    fits = _many_fits(maxiter, cap, check_every)
    if flight is None:
        return _blocked_while(cond, lambda s: step_ab(s)[0], state,
                              check_every, fits), None, None

    from ..telemetry.flight import flight_init_many, flight_record_many

    buf = flight_init_many(flight, dtype, state.k, state.rr)
    bbuf = None
    if basis is not None:
        from .recycle import basis_init_many

        bbuf = basis_init_many(basis, dtype, state.k, state.r, state.rr)

    def fstep(s):
        s2, k, rr, alpha, beta = step_ab(s)
        flight_record_many(buf, flight, k, rr, alpha, beta)
        if bbuf is not None:
            from .recycle import basis_record_many

            # the recorded lane writes only while it is live (frozen
            # lanes' alpha is NaN): a lane that converged early must not
            # wrap the ring with its frozen residual
            basis_record_many(bbuf, basis, k, s2.r, rr,
                              active=torch.isfinite(alpha[basis.lane]))
        return s2

    final = _blocked_while(cond, fstep, state, check_every, fits)
    return final, buf, bbuf


def _gram_rank_deflated_solve(gram_mat, rhs):
    """Eigenvalue pseudo-inverse Gram solve: the block lane's in-lane
    rank-collapse deflation.  Directions below ``GRAM_DEFLATE_RTOL *
    lambda_max`` are zeroed, so a converged or duplicate direction drops
    out of the block step instead of poisoning the factor."""
    sym = 0.5 * (gram_mat + gram_mat.T)
    lam, q = torch.linalg.eigh(sym)
    lmax = torch.max(torch.abs(lam))
    good = lam > GRAM_DEFLATE_RTOL * lmax
    inv = torch.where(good, 1.0 / torch.where(good, lam, torch.ones_like(lam)),
                      torch.zeros_like(lam))
    return q @ (inv[:, None] * (q.T @ rhs))


def _gram_solve(gram_mat, rhs):
    """``gram_mat^{-1} rhs`` with in-lane rank deflation: the Cholesky
    solve when its factor and solution are finite (the common, full-rank
    case), else the eigenvalue pseudo-inverse.  ``cholesky_ex`` does not
    sync; a non-SPD Gram gives ``info != 0`` where the JAX factor is NaN.
    The branch is chosen on the host (one read).  Returns ``(solution,
    collapsed)``."""
    lw, info = torch.linalg.cholesky_ex(gram_mat)
    chol = torch.cholesky_solve(rhs, lw)
    ok = bool((info == 0) & torch.all(torch.isfinite(chol)))
    if ok:
        return chol, False
    return _gram_rank_deflated_solve(gram_mat, rhs), True


def _run_block(a, m, bstate, thresh_sq, maxiter, cap, check_every,
               dot_many, axis_name):
    """The block-CG loop and its masked batched continuation (the JAX
    ``_run_block``): a state that goes non-finite past the in-lane
    deflation freezes (``broke``) one step before poisoning, and the
    continuation re-seeds the independent recurrences from the frozen
    ``(x, r)`` (p = z = M r) under the remaining budget.  When nothing
    broke every lane is converged (or the budget is gone) and the
    continuation runs zero iterations."""
    gram = partial(blas1.gram, axis_name=axis_name)

    def cond(s: _BlockState) -> bool:
        if not (s.k < maxiter and s.k < cap):
            return False
        live = (s.rr >= thresh_sq) & (s.rr > 0) & torch.isfinite(s.rr)
        return bool(~s.broke & torch.any(live))

    def step(s: _BlockState) -> _BlockState:
        live = (s.rr >= thresh_sq) & (s.rr > 0)
        q = _cols(a.matmat(s.p))                   # ONE sweep, all lanes
        w = gram(s.p, q)                           # P^T A P  (k, k)
        alpha, _ = _gram_solve(w, s.gamma)
        x = _cols(s.x + s.p @ alpha)
        r = _cols(s.r - q @ alpha)
        z = _cols(m.matmat(r)) if m is not None else r
        gamma_new = gram(r, z)
        beta, _ = _gram_solve(s.gamma, gamma_new)
        p = _cols(z + s.p @ beta)
        rr = dot_many(r, r)
        ok = torch.all(torch.isfinite(alpha)) \
            & torch.all(torch.isfinite(beta)) & torch.all(torch.isfinite(rr))

        # non-finite past the in-lane deflation freezes the PRE-step state
        def sel(new, old):
            return torch.where(ok, new, old)

        return _BlockState(
            k=s.k + 1, kd=sel(s.kd + 1, s.kd),
            x=_cols(sel(x, s.x)), r=_cols(sel(r, s.r)),
            p=_cols(sel(p, s.p)), gamma=sel(gamma_new, s.gamma),
            rr=sel(rr, s.rr), iters=s.iters + (ok & live).to(torch.int32),
            # diag(P^T A P) <= 0 on a live lane: the block analogue of
            # cg's p.Ap <= 0 test
            indefinite=s.indefinite | (ok & live & (torch.diagonal(w) <= 0)),
            broke=s.broke | ~ok)

    final = _blocked_while(cond, step, bstate, check_every,
                           _many_fits(maxiter, cap, check_every))
    # masked batched continuation from the frozen state (0 iterations
    # unless the Gram broke down with live lanes left)
    z = _cols(m.matmat(final.r)) if m is not None else final.r
    rho = dot_many(final.r, z) if m is not None \
        else dot_many(final.r, final.r)
    mstate = _ManyState(
        k=int(final.kd), x=final.x, r=final.r, p=z, rho=rho, rr=final.rr,
        iters=final.iters, indefinite=final.indefinite)
    mfinal, _, _ = _run_batched(a, m, mstate, thresh_sq, maxiter, cap,
                                check_every, dot_many, None,
                                final.x.dtype, axis_name=axis_name)
    fell_back = final.broke & (mfinal.iters > final.iters).any()
    return mfinal, fell_back


def solve_many(
    a,
    b,
    x0=None,
    *,
    tol=1e-7,
    rtol=0.0,
    maxiter: int = 2000,
    m=None,
    iter_cap: Optional[int] = None,
    check_every: int = 1,
    method: str = "batched",
    compensated: bool = False,
    flight=None,
    fault=None,
    deflate=None,
    basis=None,
) -> CGBatchResult:
    """Single-call many-RHS entry point (the ``solve()`` of the batched
    tier) on the operator's device: validation, the ``engine_selected``
    event (engine ``"many"``) and :func:`cg_many` - the general matmat
    loop, as in the JAX package (the one-kernel engines are single-RHS).
    Single-device; the distributed entry is
    ``parallel.solve_distributed_many``."""
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    b = _as_rhs(b, a.device)
    if b.ndim != 2:
        raise ValueError(
            f"solve_many solves a column stack: b must be (n, k), got "
            f"shape {tuple(b.shape)} (use solve() for a single RHS)")
    if deflate is not None:
        from .recycle import check_space

        check_space(deflate, a)         # typed RecycleMismatch
    _note_engine("many", method, check_every, n_rhs=int(b.shape[1]),
                 **({"flight_stride": flight.stride}
                    if flight is not None else {}),
                 **({"fault": fault.fingerprint()}
                    if fault is not None else {}),
                 **({"deflate_k": deflate.k}
                    if deflate is not None else {}))
    return cg_many(a, b, x0, tol=tol, rtol=rtol, maxiter=maxiter, m=m,
                   iter_cap=iter_cap, check_every=check_every,
                   method=method, compensated=compensated, flight=flight,
                   fault=fault, deflate=deflate, basis=basis)
