"""Survival of a long solve: preemption drills and elastic migration.

Counterpart of the JAX package's ``robust`` package, the parts that
checkpoint/resume needs (ROADMAP A13):

* :mod:`.inject` - the host-level :class:`Preemption` hook that kills
  a resumable segment between checkpoints, and the typed
  :class:`PreemptedError` / :class:`ShardLostError`;
* :mod:`.elastic` - :func:`migrate_checkpoint` re-lays a distributed
  checkpoint out for a different mesh shape (residual-continuity seam
  contract), :func:`lift_checkpoint` gathers one back to global row
  order.  ``utils.checkpoint.solve_resumable_distributed(elastic=True)``
  migrates with it at load time.

The JAX package's other robust modules (in-trace fault injection
``FaultPlan``, ``recover``, ``validate``, the straggler ``watchdog``)
are not ported yet: naming one through this package raises
``NotImplementedError`` (ROADMAP A15).
"""
from __future__ import annotations

from . import elastic, inject
from .elastic import (
    MigrationResult,
    MigrationSeamError,
    lift_checkpoint,
    migrate_checkpoint,
)
from .inject import PreemptedError, Preemption, ShardLostError

#: the JAX package's robust names that come with ROADMAP A15
_LATER = frozenset({
    "FAULT_SITES", "HOST_FAULT_SITES", "Degradation", "FaultPlan",
    "RecoveredResult", "RecoveryPolicy", "StragglerWatchdog",
    "check_finite_problem", "check_finite_rhs", "recover",
    "solve_with_recovery", "validate", "watchdog",
})


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"robust.{name} is not ported yet (ROADMAP A15: fault "
            f"injection, recovery, validation and the straggler "
            f"watchdog)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "MigrationResult",
    "MigrationSeamError",
    "PreemptedError",
    "Preemption",
    "ShardLostError",
    "elastic",
    "inject",
    "lift_checkpoint",
    "migrate_checkpoint",
]
