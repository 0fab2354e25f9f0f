"""Krylov subspace recycling: deflated CG for repeat traffic.

Counterpart of the JAX package's ``solver/recycle.py``.  A service that
solves the same operator again and again with fresh right-hand sides
can harvest the spectral information each CG solve bought (approximate
extreme eigenpairs) and deflate it from the next solve, so the solves
get faster the longer it runs.  Three pieces:

* **The basis ring** (:class:`BasisConfig`): the solve keeps its last
  ``capacity`` normalized residuals, one ring write per iteration beside
  the flight recorder's row, nothing at all when off.
* **Harvest** (:func:`harvest_space`, host numpy): the flight record's
  alpha/beta columns give the CG-Lanczos tridiagonal of the ring's
  window (``telemetry.health.lanczos_tridiagonal``, stride 1 enforced);
  its eigenvectors combined with the ring give approximate extreme
  eigenvectors of A.  Harvests accumulate: a previous space is
  Rayleigh-Ritz-compressed with the new window back to ``k`` columns.
* **The deflated lane** (``cg``/``cg_many``/``solve_distributed``
  ``deflate=``): at entry ``x0 += W (W^T A W)^{-1} W^T r0`` (a Galerkin
  solve in the recycled space), and every new direction is projected
  against ``A W``.  On a mesh the per-iteration ``(k,)``-wide
  ``(AW)^T z`` reduction rides the residual-norm psum
  (:func:`fused_deflated_dots`), so the collective count per iteration
  is unchanged.  ``deflate=None`` leaves a solve's op stream as it was.

A :class:`RecycleSpace` is checked against the operator it deflates by
:func:`space_layout`, the operator's ``utils.checkpoint.
operator_fingerprint`` (the JAX package's bytes) and row count, so a
space harvested by the JAX package deflates the port's solve of the
same matrix (``convert.recycle_space_from_arrays``) and a wrong space
raises :class:`RecycleMismatch`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "BASIS_CAPACITY_LIMIT",
    "BasisConfig",
    "DEFAULT_K",
    "HarvestError",
    "HarvestInfo",
    "RecycleMismatch",
    "RecycleSpace",
    "basis_init",
    "basis_init_many",
    "basis_record",
    "basis_record_many",
    "check_space",
    "harvest_space",
    "recycled_sequence",
    "space_layout",
]

#: default recycled-space dimension (columns of W)
DEFAULT_K = 8

#: hard cap on basis-ring capacity: the ring holds ``capacity * n``
#: elements beside the solve (128 rows keep a 1M-row f32 solve's ring
#: under 512 MB); longer solves wrap and harvest from the trailing window
BASIS_CAPACITY_LIMIT = 128


class RecycleMismatch(ValueError):
    """A :class:`RecycleSpace` was offered to a solve it does not fit:
    another operator fingerprint or row count."""


class HarvestError(ValueError):
    """The basis ring / flight record cannot support a harvest (solve
    too short, decimated record, non-SPD Gram)."""


@dataclasses.dataclass(frozen=True)
class BasisConfig:
    """Basis-ring configuration (hashable, like ``FlightConfig``).

    ``capacity``: ring rows of normalized residuals kept beside the
    solve; once ``capacity * stride`` iterations have run the oldest rows
    are overwritten.  ``stride``: decimation; :func:`harvest_space`
    refuses stride != 1.  ``lane``: which column of a batched solve the
    ring records.
    """

    capacity: int = 32
    stride: int = 1
    lane: int = 0

    def __post_init__(self):
        if self.capacity < 2:
            raise ValueError(
                f"capacity must be >= 2, got {self.capacity}")
        if self.capacity > BASIS_CAPACITY_LIMIT:
            raise ValueError(
                f"capacity {self.capacity} exceeds "
                f"BASIS_CAPACITY_LIMIT={BASIS_CAPACITY_LIMIT} (the "
                f"ring rides the solve carry at capacity * n elements)")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.lane < 0:
            raise ValueError(f"lane must be >= 0, got {self.lane}")

    @classmethod
    def for_solve(cls, maxiter: int, lane: int = 0,
                  limit: int = BASIS_CAPACITY_LIMIT) -> "BasisConfig":
        """Capacity sized so a ``maxiter``-iteration solve never wraps
        (bounded by ``limit``)."""
        return cls(capacity=max(2, min(maxiter + 1, limit)), lane=lane)


# ---------------------------------------------------------------------------
# the in-loop ring: (iterations, vectors), written in place


def basis_init(cfg: BasisConfig, dtype, k0, r, rr):
    """Fresh basis ring with the initial residual recorded: ``its
    (capacity,) int32`` slot iterations (-1 = never written) and ``vecs
    (capacity, n)`` rows of ``r / ||r||`` (zeros where unwritten), on
    ``r``'s device."""
    its = torch.full((cfg.capacity,), -1, dtype=torch.int32,
                     device=r.device)
    vecs = torch.zeros((cfg.capacity,) + tuple(r.shape), dtype=dtype,
                       device=r.device)
    return basis_record((its, vecs), cfg, k0, r, rr)


def basis_record(buf, cfg: BasisConfig, k, r, rr, active=None):
    """One ring write of the normalized residual - the flight ring's
    rule (``k % stride == 0`` -> slot ``(k // stride) % capacity``), in
    place, no host read.  ``rr`` is the (reduced, global) ``||r||^2``, so
    a shard's row is its part of the unit global residual.  ``active`` (a
    device bool) gates the write: a batched solve's recorded lane stops
    writing once it freezes."""
    its, vecs = buf
    k = int(k)
    if k % cfg.stride:
        return buf
    slot = (k // cfg.stride) % cfg.capacity
    inv = torch.where(rr > 0, 1.0 / torch.sqrt(rr),
                      torch.zeros_like(rr)).to(vecs.dtype)
    row = r.to(vecs.dtype) * inv
    if active is None:
        its[slot] = k
        vecs[slot] = row
    else:
        its[slot] = torch.where(active, torch.full_like(its[slot], k),
                                its[slot])
        vecs[slot] = torch.where(active, row, vecs[slot])
    return its, vecs


def basis_init_many(cfg: BasisConfig, dtype, k0, r, rr):
    """Batched-solve ring init: records lane ``cfg.lane`` of the
    ``(n, k_rhs)`` residual stack (``rr`` per-lane ``(k_rhs,)``)."""
    return basis_init(cfg, dtype, k0, r[:, cfg.lane], rr[cfg.lane])


def basis_record_many(buf, cfg: BasisConfig, k, r, rr, active=None):
    return basis_record(buf, cfg, k, r[:, cfg.lane], rr[cfg.lane],
                        active=active)


# ---------------------------------------------------------------------------
# the recycled space


@dataclasses.dataclass(frozen=True)
class RecycleSpace:
    """A harvested deflation space: ``W`` (n x k, orthonormal columns, in
    the caller's global row order), ``A W`` and the lower Cholesky factor
    of ``W^T A W`` - what the deflated lane's projections consume.  The
    identity ``(n, k, layout)`` is checked against the operator."""

    w: object            # (n, k) orthonormal Ritz basis
    aw: object           # (n, k) = A @ W
    chol: object         # (k, k) lower Cholesky of W^T A W
    n: int
    k: int
    layout: str          # operator fingerprint + row count

    def fingerprint(self) -> str:
        return f"{self.layout}:k{self.k}"


@dataclasses.dataclass(frozen=True)
class HarvestInfo:
    """One harvest's quality digest (host-side; JSON-ready)."""

    k: int
    window: int                 # tridiagonal rows the harvest used
    iterations: int             # source solve's iteration count
    ritz: tuple                 # kept Ritz values, ascending
    quality: tuple              # ||A w - theta w|| / |theta| per pair
    accumulated: bool           # previous space was folded in

    def to_json(self) -> dict:
        return {
            "k": self.k, "window": self.window,
            "iterations": self.iterations,
            "ritz_min": float(self.ritz[0]) if self.ritz else None,
            "ritz_max": float(self.ritz[-1]) if self.ritz else None,
            "quality_max": (float(max(self.quality))
                            if self.quality else None),
            "accumulated": self.accumulated,
        }


def _as_linear_operator(a):
    from ..models.operators import LinearOperator

    if isinstance(a, LinearOperator):
        return a
    from .cg import _as_operator

    return _as_operator(a)


#: id-keyed weakref memo of layout tokens: the fingerprint walk is O(nnz)
#: host work, so repeat checks on a live operator object cost O(1)
_LAYOUT_MEMO: dict = {}


def space_layout(a) -> str:
    """The layout token a space is checked against: the operator's
    fingerprint (``utils.checkpoint.operator_fingerprint``) and its row
    count.  Spaces live in the caller's global row order, so the token
    serves the single-device and the distributed lanes alike.  Memoized
    per live operator object."""
    import weakref

    from ..utils.checkpoint import operator_fingerprint

    a = _as_linear_operator(a)
    hit = _LAYOUT_MEMO.get(id(a))
    if hit is not None and hit[0]() is a:
        return hit[1]
    token = f"{operator_fingerprint(a)[:12]}:{int(a.shape[0])}"
    try:
        ref = weakref.ref(a)
    except TypeError:
        return token
    if len(_LAYOUT_MEMO) > 256:
        for key in [k for k, (r, _) in _LAYOUT_MEMO.items()
                    if r() is None]:
            _LAYOUT_MEMO.pop(key, None)
    _LAYOUT_MEMO[id(a)] = (ref, token)
    return token


def check_space(space, a) -> None:
    """Typed refusal (never a wrong-space deflation): the space must
    have been harvested from THIS operator."""
    if not isinstance(space, RecycleSpace):
        raise TypeError(
            f"deflate must be a solver.recycle.RecycleSpace, got "
            f"{type(space).__name__}")
    expected = space_layout(a)
    if space.layout != expected:
        raise RecycleMismatch(
            f"RecycleSpace layout {space.layout!r} does not match this "
            f"operator ({expected!r}): the space was harvested from a "
            f"different matrix (or row count) and deflating with it "
            f"would silently waste every projection. Harvest a space "
            f"from THIS operator (solver.recycle.harvest_space).")


_RIDES_WHY = {
    "cg": "the projection and the harvest assume the textbook direction "
          "recurrence",
    "batched": "block CG deflates rank collapse in-lane through its own "
               "Gram pseudo-inverse, and its recurrence coefficients are "
               "k x k matrices, not a lane's Lanczos process",
}


def check_recycling(deflate, basis, *, method: str, rides: str, flight,
                    conflict: Optional[str] = None) -> None:
    """The refusals of ``deflate=`` / ``basis=`` every entry point shares,
    in the JAX ``solve_distributed``'s order: the ``method`` the
    recycling lane ``rides`` (``"cg"`` for the single-RHS solvers,
    ``"batched"`` for the stacks), ``conflict`` - what else the caller
    asked for that the recycling lane cannot carry (compensated dots,
    checkpoint/resume, fault injection) or None -, the arguments' types,
    and the flight recorder the ring needs.  Entry points keep their own
    lane checks and call :func:`check_space` themselves, as the JAX
    package's ``solve``/``solve_many``/``solve_distributed`` do."""
    if deflate is None and basis is None:
        return
    feature = "deflate= (Krylov recycling)" if deflate is not None \
        else "basis= (the recycling harvest ring)"
    if method != rides:
        raise ValueError(f"{feature} rides method={rides!r} only (got "
                         f"{method!r}): {_RIDES_WHY[rides]}")
    if conflict is not None:
        raise ValueError(
            f"{feature} does not compose with {conflict} (the recycling "
            f"lane carries projection and ring state the others do not)")
    for arg, name, cls in ((deflate, "deflate", RecycleSpace),
                           (basis, "basis", BasisConfig)):
        if arg is not None and not isinstance(arg, cls):
            raise TypeError(f"{name} must be a solver.recycle."
                            f"{cls.__name__}, got {type(arg).__name__}")
    if basis is not None and flight is None:
        raise ValueError(
            "basis= needs flight= (a stride-1 FlightConfig): the harvest "
            "combines the basis ring with the flight recorder's "
            "alpha/beta tridiagonal")


# ---------------------------------------------------------------------------
# harvest: basis ring + tridiagonal -> RecycleSpace


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _decode_basis(basis) -> tuple:
    """Host view of a ring: ``(iterations (m,), vectors, rows)`` - the
    written, finite slots' iterations sorted ascending, the ring's vectors
    as fetched (``(capacity, n)``, not copied again) and the slot of each
    sorted iteration."""
    its, vecs = basis
    its = _host(its)
    vecs = _host(vecs)
    # a broken-down solve writes non-finite rows: dropped, so the harvest
    # fails typed (a too-small window) rather than on NaN
    ok = np.nonzero((its >= 0) & np.isfinite(vecs).all(axis=1))[0]
    order = ok[np.argsort(its[ok], kind="stable")]
    return its[order].astype(np.int64), vecs, order


def harvest_space(
    a,
    result,
    *,
    k: int = DEFAULT_K,
    prev: Optional[RecycleSpace] = None,
    lane: int = 0,
    n_rhs: Optional[int] = None,
    note: bool = True,
) -> tuple:
    """Combine a solve's basis ring with its flight record into a
    :class:`RecycleSpace`; returns ``(space, HarvestInfo)``.

    ``a`` is the operator the solve ran (the global one: the harvest pays
    one ``matmat`` of an ``(n, <= 2k)`` stack); ``result`` a ``CGResult``
    or ``CGBatchResult`` carrying ``.basis`` and a stride-1 ``.flight``;
    ``k`` the dimension kept (smallest Ritz values); ``prev`` a space to
    accumulate; ``lane``/``n_rhs`` the recorded lane of a batched solve.
    Host numpy (and one device matmat).  Raises :class:`HarvestError`
    when the record cannot support it.
    """
    from ..telemetry import health
    from ..telemetry.flight import FlightRecord, lanes_from_buffer

    a = _as_linear_operator(a)
    if getattr(result, "basis", None) is None:
        raise HarvestError(
            "the solve carried no basis ring: pass "
            "basis=BasisConfig(...) (and flight=FlightConfig(stride=1)"
            ") to the solve that should be harvested")
    if getattr(result, "flight", None) is None:
        raise HarvestError(
            "the solve carried no flight recorder: the harvest needs "
            "the alpha/beta tridiagonal - pass "
            "flight=FlightConfig(stride=1)")
    if n_rhs is not None and n_rhs > 1:
        record = lanes_from_buffer(result.flight, n_rhs)[lane]
    else:
        record = FlightRecord.from_buffer(result.flight)
    try:
        diag, off, res_its = health.lanczos_tridiagonal(record)
    except ValueError as e:
        raise HarvestError(str(e)) from e

    bits, bvecs, slots = _decode_basis(result.basis)
    # intersect: tridiagonal rows whose residual vector the ring kept
    pos = {int(t): i for i, t in enumerate(bits)}
    keep = np.array([int(t) in pos for t in res_its])
    if int(keep.sum()) < 2:
        raise HarvestError(
            f"basis ring (iterations {bits[0] if bits.size else '-'}"
            f"..{bits[-1] if bits.size else '-'}) and tridiagonal rows "
            f"({res_its[0]}..{res_its[-1]}) share < 2 iterations - "
            f"ring capacity too small for this solve?")
    # the trailing consecutive run keeps the tridiagonal a principal
    # submatrix
    kept_idx = np.nonzero(keep)[0]
    brk = np.nonzero(np.diff(kept_idx) != 1)[0]
    first = kept_idx[int(brk[-1]) + 1] if brk.size else kept_idx[0]
    sel = np.arange(first, kept_idx[-1] + 1)
    w_dim = sel.shape[0]
    if w_dim < 2:
        raise HarvestError("usable consecutive window < 2 rows")
    t_w = np.diag(diag[sel])
    o = off[sel[:-1]]
    t_w += np.diag(o, 1) + np.diag(o, -1)
    try:
        lam, coeff = np.linalg.eigh(t_w)
    except np.linalg.LinAlgError as e:
        raise HarvestError(f"tridiagonal eigendecomposition failed: "
                           f"{e}") from e
    kd = int(min(k, w_dim))
    idx = np.argsort(lam)[:kd]
    # Lanczos vectors alternate sign against the stored residuals
    rows = slots[np.array([pos[int(t)] for t in res_its[sel]])]
    signs = ((-1.0) ** np.arange(w_dim))[:, None]
    w_window = bvecs[rows].astype(np.float64).T @ (signs * coeff[:, idx])

    basis = w_window if prev is None \
        else np.hstack([_host(prev.w).astype(np.float64), w_window])
    # orthonormalize by SVD (rank-revealing: an accumulated harvest
    # overlaps the previous space)
    try:
        u, s, _ = np.linalg.svd(basis, full_matrices=False)
    except np.linalg.LinAlgError as e:
        raise HarvestError(f"basis orthonormalization failed: "
                           f"{e}") from e
    good = s > max(1e-8 * float(s[0]), 1e-30)
    q = u[:, good]
    if q.shape[1] < 1:
        raise HarvestError("harvested basis is numerically rank-0")
    dtype = result.x.dtype if isinstance(result.x, torch.Tensor) \
        else torch.as_tensor(np.asarray(result.x)).dtype
    aq = _host(a.matmat(torch.as_tensor(q, dtype=dtype, device=a.device))
               ).astype(np.float64)
    g = q.T @ aq
    g = 0.5 * (g + g.T)
    try:
        mu, z = np.linalg.eigh(g)
    except np.linalg.LinAlgError as e:
        raise HarvestError(f"Rayleigh-Ritz eigendecomposition "
                           f"failed: {e}") from e
    if not np.all(np.isfinite(mu)):
        raise HarvestError("Rayleigh-Ritz projection is non-finite "
                           "(non-finite basis vectors?)")
    kd = int(min(k, q.shape[1]))
    order = np.argsort(mu)[:kd]
    while kd >= 1:
        zsel = z[:, order[:kd]]
        g_w = zsel.T @ g @ zsel
        g_w = 0.5 * (g_w + g_w.T)
        try:
            chol = np.linalg.cholesky(g_w)
            break
        except np.linalg.LinAlgError:
            kd -= 1          # drop the worst-conditioned direction
    else:
        raise HarvestError(
            "W^T A W is not positive definite at any k (non-SPD "
            "operator, or a poisoned trace)")
    zsel = z[:, order[:kd]]
    w_final = q @ zsel
    aw_final = aq @ zsel
    ritz = mu[order[:kd]]
    quality = tuple(
        float(np.linalg.norm(aw_final[:, i] - ritz[i] * w_final[:, i])
              / max(abs(float(ritz[i])), 1e-300))
        for i in range(kd))

    def dev(v):
        return torch.as_tensor(v, dtype=dtype, device=a.device)

    space = RecycleSpace(
        w=dev(w_final), aw=dev(aw_final), chol=dev(chol),
        n=int(a.shape[0]), k=kd, layout=space_layout(a))
    info = HarvestInfo(
        k=kd, window=w_dim,
        iterations=int(record.iterations[-1]) if len(record) else 0,
        ritz=tuple(float(v) for v in ritz),
        quality=quality, accumulated=prev is not None)
    if note:
        note_harvest(info)
    return space, info


def note_harvest(info: HarvestInfo, **extra) -> None:
    """One harvest through the telemetry: the ``recycle_harvest`` event
    and the space-quality gauges."""
    from ..telemetry import events
    from ..telemetry.registry import REGISTRY

    REGISTRY.counter(
        "recycle_harvests_total",
        "RecycleSpace harvests (Ritz extraction from a solve's basis "
        "ring + flight record)").inc()
    REGISTRY.gauge(
        "recycle_space_k",
        "columns of the most recently harvested RecycleSpace").set(
            info.k)
    if info.ritz:
        REGISTRY.gauge(
            "recycle_ritz_min",
            "smallest kept Ritz value of the most recent harvest").set(
                float(info.ritz[0]))
    events.emit("recycle_harvest", **info.to_json(), **extra)


def note_applied(k: int, iterations: int, baseline: Optional[float],
                 **extra) -> None:
    """A solve ran with a recycled space: its iterations against the
    undeflated baseline (the iterations-saved gauge)."""
    from ..telemetry import events
    from ..telemetry.registry import REGISTRY

    saved = None if baseline is None else float(baseline) - iterations
    if saved is not None:
        REGISTRY.gauge(
            "recycle_iters_saved",
            "iterations saved by the most recent deflated solve vs "
            "the handle's undeflated baseline").set(saved)
    events.emit("recycle_applied", k=k, iterations=int(iterations),
                **({"baseline_iterations": float(baseline),
                    "iters_saved": saved}
                   if baseline is not None else {}),
                **extra)


# ---------------------------------------------------------------------------
# the repeat-solve loop


@dataclasses.dataclass(frozen=True)
class RecycleEntry:
    """One solve of a :func:`recycled_sequence` run."""

    index: int
    result: object
    elapsed_s: float
    harvest_s: float
    deflated: bool
    info: Optional[HarvestInfo]

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "iterations": int(self.result.iterations),
            "converged": bool(self.result.converged),
            "elapsed_s": float(self.elapsed_s),
            "harvest_s": float(self.harvest_s),
            "deflated": self.deflated,
            **({"harvest": self.info.to_json()}
               if self.info is not None else {}),
        }


@dataclasses.dataclass(frozen=True)
class RecycleSequenceResult:
    entries: tuple = ()

    @property
    def result(self):
        return self.entries[-1].result

    def iterations(self):
        return [int(e.result.iterations) for e in self.entries]

    def summary(self) -> dict:
        its = self.iterations()
        solve_wall = sum(e.elapsed_s for e in self.entries)
        harvest_wall = sum(e.harvest_s for e in self.entries)
        last = self.entries[-1]
        return {
            "repeats": len(self.entries),
            "iterations": its,
            "first_solve_iterations": its[0],
            "final_solve_iterations": its[-1],
            "iters_saved": its[0] - its[-1],
            "harvest_overhead_pct": round(
                100.0 * harvest_wall / max(solve_wall, 1e-30), 3),
            "k": last.info.k if last.info is not None else None,
            "solves": [e.to_json() for e in self.entries],
        }

    def describe_lines(self):
        lines = []
        for e in self.entries:
            tag = "deflated" if e.deflated else "harvest source"
            h = (f", harvest {e.harvest_s * 1e3:.1f} ms "
                 f"(k={e.info.k}, ritz_min {e.info.ritz[0]:.3g})"
                 if e.info is not None else "")
            lines.append(
                f"solve {e.index + 1} : "
                f"{int(e.result.iterations)} iters, "
                f"{e.elapsed_s * 1e3:.3f} ms [{tag}]{h}")
        its = self.iterations()
        lines.append(f"recycling : {its[0]} -> {its[-1]} iters/solve "
                     f"({its[0] - its[-1]} saved)")
        return lines


def recycled_sequence(
    a,
    b,
    *,
    repeats: int = 2,
    k: int = DEFAULT_K,
    capacity: Optional[int] = None,
    mesh=None,
    maxiter: int = 2000,
    rhs_for=None,
    **kw,
) -> RecycleSequenceResult:
    """Solve the same operator ``repeats`` times, harvesting after every
    solve and deflating the next.

    ``rhs_for(i)`` supplies solve ``i``'s right-hand side (``None`` reuses
    ``b``).  ``mesh`` routes through ``parallel.solve_distributed``;
    ``None`` runs the single-device ``solver.solve``.  Each solve is
    dispatched twice (a warm-up under the ``warmup`` phase, then the
    timed one) so a timing never includes a kernel build.  ``**kw``
    forwards to the solve entry point.
    """
    import time as _time

    from ..telemetry import events
    from ..telemetry.flight import FlightConfig
    from ..utils.timing import time_fn

    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    cfg = BasisConfig.for_solve(maxiter) if capacity is None \
        else BasisConfig(capacity=capacity)
    flight = FlightConfig.for_solve(maxiter, stride=1)

    def dispatch(b_i, space, basis_cfg):
        if mesh is not None:
            from ..parallel import solve_distributed

            return solve_distributed(a, b_i, mesh=mesh,
                                     maxiter=maxiter, flight=flight,
                                     basis=basis_cfg, deflate=space,
                                     **kw)
        from .cg import solve

        return solve(a, b_i, maxiter=maxiter, flight=flight,
                     basis=basis_cfg, deflate=space, **kw)

    space = None
    info = None
    entries = []
    for i in range(repeats):
        b_i = b if rhs_for is None else rhs_for(i)
        calls = [0]

        def once():
            calls[0] += 1
            if calls[0] == 1:
                with events.scoped(phase="warmup"):
                    return dispatch(b_i, space, cfg)
            return dispatch(b_i, space, cfg)

        elapsed, res = time_fn(once, warmup=1, repeats=1)
        deflated = space is not None
        if deflated:
            note_applied(space.k, int(res.iterations),
                         float(entries[0].result.iterations))
        t0 = _time.perf_counter()
        try:
            space, info = harvest_space(a, res, k=k, prev=space)
        except HarvestError:
            info = None          # keep the previous space (if any)
        harvest_s = _time.perf_counter() - t0
        entries.append(RecycleEntry(
            index=i, result=res, elapsed_s=float(elapsed),
            harvest_s=float(harvest_s), deflated=deflated, info=info))
    return RecycleSequenceResult(entries=tuple(entries))


# ---------------------------------------------------------------------------
# the deflated lane's device-side projections (consumed by cg/cg_many)


def chol_solve(l, rhs):
    """``(W^T A W)^{-1} rhs`` through the space's Cholesky factor (``rhs``
    a ``(k,)`` vector or a ``(k, m)`` stack)."""
    if rhs.ndim == 1:
        return torch.cholesky_solve(rhs[:, None], l)[:, 0]
    return torch.cholesky_solve(rhs, l)


def _wt(w, v, axis_name):
    """``w^T v`` reduced over ``axis_name``: each shard's product and one
    psum (``w`` and ``v`` row-partitioned alike, shard axis first)."""
    if axis_name is None:
        return w.T @ v
    from ..parallel.comm import resolve

    comm = resolve(axis_name)
    count = comm.local_count
    ws = w.reshape((count, -1) + tuple(w.shape[1:]))
    vs = v.reshape((count, -1) + tuple(v.shape[1:]))
    return comm.psum(torch.stack([ws[s].T @ vs[s] for s in range(count)]))


def entry_project(space: RecycleSpace, x, r, axis_name):
    """Galerkin entry correction ``x += W (W^T A W)^{-1} W^T r`` - after
    it ``W^T r = 0``.  For ``(n,)`` vectors and ``(n, k_rhs)`` stacks;
    one psum at entry on a mesh."""
    c = chol_solve(space.chol, _wt(space.w, r, axis_name))
    return x + space.w @ c, r - space.aw @ c


def project_direction(space: RecycleSpace, z, axis_name):
    """A-orthogonalize a direction against the space:
    ``z - W (W^T A W)^{-1} (A W)^T z``."""
    wz = _wt(space.aw, z, axis_name)
    return z - space.w @ chol_solve(space.chol, wz)


def fused_deflated_dots(space: RecycleSpace, r, z, preconditioned: bool,
                        axis_name):
    """The deflated step's reductions as ONE: ``(rr, rho, (AW)^T z)`` -
    ``r . r``, ``r . z`` (``rho = rr`` without a preconditioner) and the
    projection, for a vector ``(n,)`` (0-d scalars, ``(k_defl,)``) or a
    stack ``(n, k_rhs)`` (per-lane ``(k_rhs,)``, ``(k_defl, k_rhs)``).
    On a mesh each shard's partials are concatenated and reduced by one
    psum, so a deflated iteration makes the undeflated one's count of
    collectives."""
    from ..ops import blas1

    stacked = r.ndim == 2
    n_dots = 2 if preconditioned else 1

    def local(rs, zs, aws):
        if stacked:
            parts = [blas1.dot_many(rs, rs)]
            if preconditioned:
                parts.append(blas1.dot_many(rs, zs))
        else:
            parts = [blas1.dot(rs, rs)[None]]
            if preconditioned:
                parts.append(blas1.dot(rs, zs)[None])
        return torch.cat(parts + [(aws.T @ zs).reshape(-1)])

    if axis_name is None:
        fused = local(r, z, space.aw)
    else:
        from ..parallel.comm import resolve

        comm = resolve(axis_name)
        count = comm.local_count
        rs = r.reshape((count, -1) + tuple(r.shape[1:]))
        zs = z.reshape((count, -1) + tuple(z.shape[1:]))
        aws = space.aw.reshape((count, -1) + tuple(space.aw.shape[1:]))
        fused = comm.psum(torch.stack([local(rs[s], zs[s], aws[s])
                                       for s in range(count)]))
    width = r.shape[1] if stacked else 1
    rr = fused[:width]
    rho = fused[width:2 * width] if preconditioned else rr
    wz = fused[n_dots * width:]
    if stacked:
        return rr, rho, wz.reshape(space.k, width)
    return rr[0], rho[0], wz
