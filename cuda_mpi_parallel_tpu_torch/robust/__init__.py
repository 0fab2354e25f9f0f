"""Deterministic chaos harness, self-healing solves and survival of a long
solve.

Counterpart of the JAX package's ``robust`` package (ROADMAP A13, A15):

* :mod:`.inject` - a static, hashable :class:`FaultPlan` that arms a
  solve to corrupt, at a chosen iteration and shard, the halo payload,
  the local SpMV output or the reduction scalar (decided on the host,
  written on the device), plus the host-level :class:`Preemption` hook
  that kills a resumable segment between checkpoints and the
  ``shard_loss`` drill of the elastic loop;
* detection - the solvers' health predicate (``isfinite(rr) &
  isfinite(rho) & rho > 0``) exits a poisoned recurrence with
  ``CGStatus.BREAKDOWN`` within ``check_every`` iterations;
* :mod:`.recover` - :class:`RecoveryPolicy` /
  :func:`solve_with_recovery`: bounded restarts from the last finite
  iterate, over both the single-device and the distributed CSR solve;
* :mod:`.validate` - loud pre-solve rejection of non-finite inputs;
* :mod:`.elastic` - :func:`migrate_checkpoint` re-lays a distributed
  checkpoint out for a different mesh shape (residual-continuity seam
  contract), :func:`lift_checkpoint` gathers one back to global row
  order.  ``utils.checkpoint.solve_resumable_distributed(elastic=True)``
  migrates with it at load time and at a ``shard_loss`` drill.

The straggler watchdog (``StragglerWatchdog``, ``Degradation``) profiles
the partition through ``telemetry.phasetrace`` and is not ported yet:
naming it raises ``NotImplementedError`` (ROADMAP A15, item 9b).
"""
from __future__ import annotations

from . import elastic, inject, recover, validate
from .elastic import (
    MigrationResult,
    MigrationSeamError,
    lift_checkpoint,
    migrate_checkpoint,
)
from .inject import (
    FAULT_SITES,
    HOST_FAULT_SITES,
    FaultPlan,
    PreemptedError,
    Preemption,
    ShardLostError,
)
from .recover import RecoveredResult, RecoveryPolicy, solve_with_recovery
from .validate import check_finite_problem, check_finite_rhs

#: the JAX package's robust names that come with the straggler watchdog
_LATER = frozenset({"Degradation", "StragglerWatchdog", "watchdog"})


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"robust.{name} is not ported yet (ROADMAP A15, item 9b: the "
            f"straggler watchdog over telemetry.phasetrace)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FAULT_SITES",
    "HOST_FAULT_SITES",
    "FaultPlan",
    "MigrationResult",
    "MigrationSeamError",
    "PreemptedError",
    "Preemption",
    "RecoveredResult",
    "RecoveryPolicy",
    "ShardLostError",
    "check_finite_problem",
    "check_finite_rhs",
    "elastic",
    "inject",
    "lift_checkpoint",
    "migrate_checkpoint",
    "recover",
    "solve_with_recovery",
    "validate",
]
