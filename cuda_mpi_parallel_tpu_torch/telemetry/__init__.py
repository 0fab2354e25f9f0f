"""solve-trace: the port's observability core.

Counterpart of the JAX package's ``telemetry`` package, its core
modules:

* :mod:`.registry` - a process-wide metrics registry (counters, gauges,
  histograms with labels; JSON and Prometheus-text exposition);
* :mod:`.events` - a JSONL solve-trace emitter with the JAX package's
  typed events (``solve_start``, ``engine_selected``,
  ``eligibility_rejected``, ``check_block``, ``flight_heartbeat``,
  ``solve_health``, ``solve_end``, ...) carrying monotonic timestamps
  and a solve id;
* :mod:`.session` - ``observe_solve(...)``, a context manager that
  composes ``utils.timing.Timer`` phase sections with
  ``torch.profiler`` traces and the event stream;
* :mod:`.flight` - the convergence flight recorder: a fixed-size,
  stride-decimated ring buffer of ``(iteration, ||r||^2, alpha, beta)``
  that the engines fill with one launch a recorded row and no host sync;
* :mod:`.health` - solve-health diagnostics over the flight record:
  CG-Lanczos Ritz/condition estimates and stagnation / plateau /
  divergence classification, emitted as ``solve_health`` events and
  decay-rate / kappa gauges.

* :mod:`.cost` - per-iteration collective counts and payload/wire bytes
  of a solve, recorded at the comm layer (``trace_solve_cost``), and the
  analytic op model;
* :mod:`.roofline` - the machine model (an H100 priced from its
  published peaks, the CPU self-calibrated) and the achieved-vs-bound
  verdict of a measured solve (``analyze``);
* :mod:`.shardscope` - per-shard rows, nnz, slots and halo bytes of a
  partition, and their imbalance (``shard_profile`` events);
* :mod:`.memscope` - per-shard device-memory footprints (exact matrix
  bytes, the modeled working set, a solve's recorded peak) and the
  capacity classification (``memory_profile`` events).

The JAX package's other telemetry modules (``phasetrace``,
``calibrate``, ``report``, ``tracing``, ``slo``, ``fleet``) are not
ported yet: naming one through this package raises
``NotImplementedError`` (ROADMAP A16).

Everything is opt-in: with no event sink configured and metrics
untouched, every instrumentation hook is a cheap host-side no-op, and
the solve's iterates are the same either way.  :func:`active` says
whether a consumer is attached; the work that exists only to feed one
(the distributed lanes' comm-cost record and peak record, the shard and
memory accounting) runs only then.
"""
from __future__ import annotations

from . import (
    cost,
    events,
    flight,
    health,
    memscope,
    registry,
    roofline,
    session,
    shardscope,
)
from .events import EventStream, configure, emit, validate_event
from .flight import FlightConfig, FlightRecord
from .health import SolveHealth, assess_solve_health
from .memscope import MemoryBudgetError, MemoryFootprint
from .registry import REGISTRY, MetricsRegistry
from .roofline import MachineModel, RooflineReport
from .session import observe_solve
from .shardscope import ShardReport, shard_report

#: the JAX package's telemetry names that come with ROADMAP A16
_LATER = frozenset({
    "CalibrationFit", "DriftReport", "PhaseProfile", "RequestTrace",
    "SLOConfig", "SLOTracker", "SLOWindow", "SolveReport", "calibrate",
    "fleet", "perfetto_trace", "phasetrace", "report", "slo", "tracing",
    "validate_perfetto",
})

#: set by force_active(): opts into the telemetry-only derived work even
#: with no event sink
_FORCED = [False]


def force_active(on: bool = True) -> None:
    """Opt into telemetry-driven derived work (the comm-cost and peak
    records of a distributed solve, the shard and memory accounting)
    without configuring an event sink.  Metrics counters always run;
    this flag only gates the extras that cost something."""
    _FORCED[0] = bool(on)


def active() -> bool:
    """True when any telemetry consumer is attached (an event sink is
    configured, or ``force_active`` was called).  Instrumentation sites
    use this to skip work that only exists to feed telemetry."""
    return _FORCED[0] or events.active()


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"telemetry.{name} is not ported yet (ROADMAP A16: the rest "
            f"of telemetry)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EventStream",
    "FlightConfig",
    "FlightRecord",
    "MachineModel",
    "MemoryBudgetError",
    "MemoryFootprint",
    "MetricsRegistry",
    "REGISTRY",
    "RooflineReport",
    "ShardReport",
    "SolveHealth",
    "active",
    "assess_solve_health",
    "configure",
    "cost",
    "emit",
    "events",
    "flight",
    "force_active",
    "health",
    "memscope",
    "observe_solve",
    "registry",
    "roofline",
    "session",
    "shard_report",
    "shardscope",
    "validate_event",
]
