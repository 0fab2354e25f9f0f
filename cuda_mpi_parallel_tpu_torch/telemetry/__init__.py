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

The JAX package's other telemetry modules (``cost``, ``roofline``,
``shardscope``, ``memscope``, ``phasetrace``, ``calibrate``, ``report``,
``tracing``, ``slo``, ``fleet``) are not ported yet: naming one through
this package raises ``NotImplementedError`` (ROADMAP A16).

Everything is opt-in: with no event sink configured and metrics
untouched, every instrumentation hook is a cheap host-side no-op, and
the solve's iterates are the same either way.
"""
from __future__ import annotations

from . import events, flight, health, registry, session
from .events import EventStream, configure, emit, validate_event
from .flight import FlightConfig, FlightRecord
from .health import SolveHealth, assess_solve_health
from .registry import REGISTRY, MetricsRegistry
from .session import observe_solve

#: the JAX package's telemetry names that come with ROADMAP A16
_LATER = frozenset({
    "CalibrationFit", "DriftReport", "MachineModel", "MemoryBudgetError",
    "MemoryFootprint", "PhaseProfile", "RequestTrace", "RooflineReport",
    "SLOConfig", "SLOTracker", "SLOWindow", "ShardReport", "SolveReport",
    "active", "calibrate", "cost", "fleet", "force_active", "memscope",
    "perfetto_trace", "phasetrace", "report", "roofline", "shard_report",
    "shardscope", "slo", "tracing", "validate_perfetto",
})


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
    "MetricsRegistry",
    "REGISTRY",
    "SolveHealth",
    "assess_solve_health",
    "configure",
    "emit",
    "events",
    "flight",
    "health",
    "observe_solve",
    "registry",
    "session",
    "validate_event",
]
