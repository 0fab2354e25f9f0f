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
  capacity classification (``memory_profile`` events);
* :mod:`.report` - one text/JSON solve report over all of the above,
  and the Chrome-trace/Perfetto timeline exporter (modeled spans from a
  shard report, measured spans from a phase profile);
* :mod:`.phasetrace` - the measured phase profiler: the halo exchange
  (and each round), the local SpMV per shard and the dot+psum reduction
  of a partitioned CSR operator, each timed alone on the mesh;
* :mod:`.calibrate` - the runtime-measured machine model: fit the
  planner's gather slowdown and net bandwidth from observed solves or a
  phase profile, track predicted-vs-measured drift, and keep fits in the
  measured-artifact cache, which ``resolve_plan`` and
  ``parallel.solve_sequence`` prefer when fresh and confident;
* :mod:`.tracing`, :mod:`.slo`, :mod:`.fleet` - the serve tier's host
  bookkeeping: per-request span trees, rolling-window SLO burn, and the
  cross-replica merge of registry snapshots.

Everything is opt-in: with no event sink configured and metrics
untouched, every instrumentation hook is a cheap host-side no-op, and
the solve's iterates are the same either way.  :func:`active` says
whether a consumer is attached; the work that exists only to feed one
(the distributed lanes' comm-cost record and peak record, the shard and
memory accounting) runs only then.
"""
from __future__ import annotations

from . import (
    calibrate,
    cost,
    events,
    fleet,
    flight,
    health,
    memscope,
    phasetrace,
    registry,
    report,
    roofline,
    session,
    shardscope,
    slo,
    tracing,
)
from .calibrate import CalibrationFit, DriftReport
from .events import EventStream, configure, emit, validate_event
from .flight import FlightConfig, FlightRecord
from .health import SolveHealth, assess_solve_health
from .memscope import MemoryBudgetError, MemoryFootprint
from .phasetrace import PhaseProfile
from .registry import REGISTRY, MetricsRegistry
from .report import SolveReport, perfetto_trace, validate_perfetto
from .roofline import MachineModel, RooflineReport
from .session import observe_solve
from .shardscope import ShardReport, shard_report
from .slo import SLOConfig, SLOTracker, SLOWindow
from .tracing import RequestTrace

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


__all__ = [
    "CalibrationFit",
    "DriftReport",
    "EventStream",
    "FlightConfig",
    "FlightRecord",
    "MachineModel",
    "MemoryBudgetError",
    "MemoryFootprint",
    "MetricsRegistry",
    "PhaseProfile",
    "REGISTRY",
    "RequestTrace",
    "RooflineReport",
    "SLOConfig",
    "SLOTracker",
    "SLOWindow",
    "ShardReport",
    "SolveHealth",
    "SolveReport",
    "active",
    "assess_solve_health",
    "calibrate",
    "configure",
    "cost",
    "emit",
    "events",
    "fleet",
    "flight",
    "force_active",
    "health",
    "memscope",
    "observe_solve",
    "perfetto_trace",
    "phasetrace",
    "registry",
    "report",
    "roofline",
    "session",
    "shard_report",
    "shardscope",
    "slo",
    "tracing",
    "validate_event",
    "validate_perfetto",
]
