"""Self-healing solves: typed breakdown -> bounded restart.

Counterpart of the JAX package's ``robust/recover.py``.  The solvers
already detect a poisoned recurrence on the device (the loop's health
predicate) and exit with ``CGStatus.BREAKDOWN`` within ``check_every``
iterations.  This module is the host-side half: a
:class:`RecoveryPolicy` that re-seeds CG from the last finite iterate and
re-dispatches, a bounded number of times, emitting ``solve_fault`` /
``solve_recovery`` events and the ``solve_breakdowns_total`` /
``solve_recoveries_total`` counters as it goes.

Restart, not resume: a fault contaminates the recurrence vectors
(r/p/rho), so continuing the exact trajectory is impossible - the restart
re-seeds fresh CG (r0 = b - A x0) from the best finite x available.  With
``snapshot_every=N`` the attempt runs in N-iteration segments, each
returning a checkpointed result, so "last finite iterate" is a genuinely
pre-fault iterate rather than zero; without it, a mid-solve fault
restarts from zero (the fault-free answer either way).  The seed stays
on the device: whether an iterate is finite is one reduction and one
read.

A transient ``FaultPlan`` (the default) disarms itself on restart
(``FaultPlan.after_restart() -> None``); a ``sticky`` plan persists, so
recovery exhausts its budget and returns the final typed BREAKDOWN -
loud, never silently wrong.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["RecoveredResult", "RecoveryPolicy", "solve_with_recovery"]


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Bounded-restart policy for BREAKDOWN outcomes.

    ``max_restarts``: re-dispatches allowed after the first breakdown
    (0 = detect-and-report only).  ``restart_from``: ``"last_finite"``
    seeds the restart from the most recent finite iterate (the final
    ``x`` when it survived, else the last finite per-segment solution
    under ``snapshot_every``, else zero); ``"zero"`` always restarts
    cold.  ``snapshot_every``: run each attempt in segments of N
    iterations with checkpointing, so a finite pre-fault iterate exists
    to restart from (None = one whole-solve dispatch per attempt).
    """

    max_restarts: int = 2
    restart_from: str = "last_finite"
    snapshot_every: Optional[int] = None

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{self.max_restarts}")
        if self.restart_from not in ("last_finite", "zero"):
            raise ValueError(
                f"restart_from must be 'last_finite' or 'zero', got "
                f"{self.restart_from!r}")
        if self.snapshot_every is not None and self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got "
                             f"{self.snapshot_every}")


@dataclasses.dataclass(frozen=True)
class RecoveredResult:
    """Outcome of :func:`solve_with_recovery`.

    ``result`` is the final attempt's ``CGResult``; ``faults`` records
    every detected breakdown ``{iteration, site, fingerprint}``;
    ``recovered`` is True when at least one breakdown was detected AND
    the final solve converged (the self-healing case).  An exhausted
    budget leaves ``recovered=False`` with ``result.status`` the typed
    BREAKDOWN - the caller decides, nothing is silent.
    """

    result: object
    attempts: int
    restarts: int
    recovered: bool
    faults: Tuple[dict, ...] = ()

    def to_json(self) -> dict:
        from ..solver.status import CGStatus

        return {
            "attempts": self.attempts,
            "restarts": self.restarts,
            "recovered": self.recovered,
            "faults": [dict(f) for f in self.faults],
            "final_status": CGStatus(int(self.result.status)).name,
        }


def _fault_record(fault, result) -> dict:
    return {"iteration": int(result.iterations),
            "site": fault.site if fault is not None else "unknown",
            "fingerprint": (fault.fingerprint()
                            if fault is not None else None)}


def _note_fault(fault, result, engine: str) -> dict:
    """One detected breakdown -> ``solve_fault`` event + counter
    (through the shared ``telemetry.session.note_breakdown``).  Returns
    the fault record kept on the RecoveredResult."""
    from ..telemetry.session import note_breakdown

    rec = _fault_record(fault, result)
    note_breakdown(rec["site"], rec["iteration"], engine=engine,
                   fingerprint=rec["fingerprint"])
    return rec


def _note_recovery(action: str, attempt: int, **extra) -> None:
    from ..telemetry import events
    from ..telemetry.registry import REGISTRY

    REGISTRY.counter(
        "solve_recoveries_total",
        "recovery actions taken after a typed breakdown",
        labelnames=("action",)).inc(action=action)
    events.emit("solve_recovery", attempt=attempt, action=action,
                **extra)


def _finite(x) -> bool:
    return bool(torch.isfinite(x).all())


def solve_with_recovery(
    a,
    b,
    *,
    policy: Optional[RecoveryPolicy] = None,
    inject=None,
    mesh=None,
    n_devices: Optional[int] = None,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    validate: bool = True,
    **kw,
) -> RecoveredResult:
    """Solve ``A x = b`` with typed-breakdown recovery.

    Distributed (``mesh``/``n_devices`` given - assembled ``CSRMatrix``
    on the allgather/gather lanes, ``**kw`` forwarded to
    :func:`parallel.solve_distributed`) or single-device (``**kw``
    forwarded to :func:`solver.solve`).  ``inject`` arms a
    :class:`.inject.FaultPlan` into the first attempt - the chaos
    harness's entry; a transient plan disarms on restart, a sticky one
    persists and exhausts the budget.  Each detected breakdown emits a
    ``solve_fault`` event; each restart a ``solve_recovery`` event.
    ``validate`` pre-checks the inputs
    (:func:`.validate.check_finite_problem`) exactly like the direct
    entry points.
    """
    from ..solver.status import CGStatus

    policy = policy or RecoveryPolicy()
    distributed = mesh is not None or n_devices is not None
    if validate:
        from .validate import check_finite_problem

        check_finite_problem(a, b)
    if distributed:
        from ..models.operators import CSRMatrix
        from ..parallel.dist_cg import solve_distributed
        from ..parallel.mesh import make_mesh

        if mesh is None:
            mesh = make_mesh(n_devices)
        # refuse lanes that cannot carry a warm restart UPFRONT: a
        # mid-recovery ValueError from the x0 re-dispatch would land
        # at the exact moment recovery was supposed to help
        if not isinstance(a, CSRMatrix) \
                or kw.get("csr_comm", "allgather") != "allgather" \
                or kw.get("exchange") == "ring":
            raise ValueError(
                "distributed recovery rides the assembled-CSR "
                "allgather/gather lanes (the restart re-dispatches "
                "with x0, which stencil slabs and the ring schedules "
                "do not carry)")
        engine = "distributed"

        def dispatch(x0, fault, resume_from, return_checkpoint,
                     iter_cap):
            return solve_distributed(
                a, b, mesh=mesh, tol=tol, rtol=rtol, maxiter=maxiter,
                x0=x0, inject=fault, resume_from=resume_from,
                return_checkpoint=return_checkpoint, iter_cap=iter_cap,
                validate=False, **kw)
    else:
        from ..solver.cg import solve

        engine = "general"

        def dispatch(x0, fault, resume_from, return_checkpoint,
                     iter_cap):
            return solve(a, b, x0, tol=tol, rtol=rtol, maxiter=maxiter,
                         fault=fault, resume_from=resume_from,
                         return_checkpoint=return_checkpoint,
                         iter_cap=iter_cap, **kw)

    def attempt(seed, fault):
        """One bounded attempt; returns ``(result, last_finite_x)``.
        ``last_finite_x`` is the newest finite per-segment solution
        (``snapshot_every`` mode only - a whole-solve attempt has no
        intermediate iterate to offer)."""
        if policy.snapshot_every is None:
            return dispatch(seed, fault, None, False, None), None
        state = None
        last_finite = None
        while True:
            done = int(state.k) if state is not None else 0
            cap = min(done + policy.snapshot_every, maxiter)
            res = dispatch(seed if state is None else None, fault,
                           state, True, cap)
            if int(res.status) == int(CGStatus.BREAKDOWN):
                return res, last_finite
            if bool(res.converged) or int(res.iterations) >= maxiter:
                return res, last_finite
            if _finite(res.x):
                last_finite = res.x
            state = res.checkpoint

    seed = None
    fault = inject
    attempts = 0
    restarts = 0
    faults = []
    while True:
        res, seg_finite = attempt(seed, fault)
        attempts += 1
        broke = int(res.status) == int(CGStatus.BREAKDOWN)
        if not broke:
            recovered = restarts > 0 and bool(res.converged)
            if recovered:
                _note_recovery("recovered", restarts,
                               iterations=int(res.iterations))
            return RecoveredResult(
                result=res, attempts=attempts, restarts=restarts,
                recovered=recovered, faults=tuple(faults))
        if restarts >= policy.max_restarts:
            # out of budget: the final breakdown is the caller's to see
            faults.append(_fault_record(fault, res))
            _note_recovery("exhausted", restarts)
            return RecoveredResult(
                result=res, attempts=attempts, restarts=restarts,
                recovered=False, faults=tuple(faults))
        faults.append(_note_fault(fault, res, engine))
        restarts += 1
        fault = fault.after_restart() if fault is not None else None
        seed = None
        seed_kind = "zero"
        if policy.restart_from == "last_finite":
            if _finite(res.x):
                seed, seed_kind = res.x, "final_x"
            elif seg_finite is not None:
                seed, seed_kind = seg_finite, "last_finite_segment"
        _note_recovery("restart", restarts, seed=seed_kind,
                       from_iteration=int(res.iterations))
