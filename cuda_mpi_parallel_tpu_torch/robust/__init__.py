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
  migrates with it at load time, at a ``shard_loss`` drill and on a
  watchdog finding;
* :mod:`.watchdog` - :class:`StragglerWatchdog`: each measured
  ``telemetry.phasetrace`` profile against its EWMA baseline (the peer
  median at first), typed :class:`Degradation` findings as
  ``shard_degraded`` events, the elastic loop's checkpoint-now-and-
  migrate trigger (drilled by the ``shard_slow`` site).
"""
from __future__ import annotations

from . import elastic, inject, recover, validate, watchdog
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
from .watchdog import Degradation, StragglerWatchdog

__all__ = [
    "Degradation",
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
    "StragglerWatchdog",
    "check_finite_problem",
    "check_finite_rhs",
    "elastic",
    "inject",
    "lift_checkpoint",
    "migrate_checkpoint",
    "recover",
    "solve_with_recovery",
    "validate",
    "watchdog",
]
