"""Structured solve-trace events: one JSON object per line (JSONL).

Counterpart of the JAX package's ``telemetry/events.py``, with the same
``EVENT_SCHEMA`` key for key and field for field, so a stream the port
writes passes the JAX ``validate_event`` (``tools/validate_trace.py``).
Every solve can emit a typed trace of what the framework decided and
measured on its behalf - which engine ran, why a fast path was
rejected, whether the distributed solver cache hit, what the
communication cost model says, and how the solve ended.  The reference
records none of this (its only output is the solution vector,
``CUDACG.cu:361-365``); a serving deployment cannot be debugged without
it.

Design rules:

* **Opt-in and free when off.**  ``emit()`` with no sink configured
  and no subscriber attached is a dict-build away from a no-op; no
  file handle, no formatting.  Consumers are a JSONL sink
  (:func:`configure`) and/or bounded in-process subscriber rings
  (:func:`subscribe` - the ops plane's live event bus; drop-oldest,
  never blocking the emitter).
* **Host-side only.**  Events carry host scalars.  Emission never
  reads a device value, so instrumentation can never force a transfer
  into (or a sync after) a solve - results are read only by consumers
  that already synced (``session.observe_solve``'s epilogue).  The
  flight recorder's heartbeat rides the solve's own check-block read
  (``telemetry.flight``).
* **Strict JSON.**  Payloads pass through ``utils.logging.sanitize``
  (non-finite floats -> ``null``) and are serialized with
  ``allow_nan=False``, so a trace file is always parseable by strict
  readers (jq/BigQuery) - the same bug class fixed in
  ``utils.logging.emit_json``.

Event schema (``EVENT_SCHEMA``): each event has ``event`` (type name),
``t`` (monotonic seconds, ``time.perf_counter`` - durations between
events are meaningful, absolute values are not), ``solve_id`` (opaque
string tying one solve's events together; ``None`` outside a solve
scope), plus per-type required fields listed below.  Unknown extra
fields are allowed - the schema floor is what consumers may rely on.
"""
from __future__ import annotations

import contextlib
import contextvars
import io
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, IO, Iterator, Optional, Tuple, Union

from ..utils.logging import sanitize

__all__ = [
    "EVENT_SCHEMA",
    "EventStream",
    "Subscription",
    "active",
    "ambient_scope",
    "configure",
    "current_solve_id",
    "emit",
    "new_solve_id",
    "read_events",
    "scoped",
    "solve_scope",
    "subscribe",
    "unsubscribe",
    "validate_event",
]

#: event type -> field names REQUIRED beyond the common envelope
#: (event, t, solve_id).  Extra fields are always permitted.
EVENT_SCHEMA: Dict[str, tuple] = {
    # a solve was requested: problem/config description
    "solve_start": ("label",),
    # which engine/method actually runs the solve
    "engine_selected": ("engine", "method"),
    # a fast path was considered and declined (engine= the declined one)
    "eligibility_rejected": ("engine", "reason"),
    # the distributed compiled-solver cache was consulted
    "dist_cache_hit": ("key",),
    "dist_cache_miss": ("key",),
    # one convergence-check block boundary (post-solve, from the
    # recorded residual history - NOT emitted from inside the hot loop)
    "check_block": ("iteration",),
    # jaxpr-derived communication cost of the compiled solve body
    "comm_cost": ("psum_per_iteration", "ppermute_per_iteration",
                  "comm_bytes_per_iteration"),
    # static per-shard load/communication accounting computed at
    # partition time (telemetry.shardscope.ShardReport.to_json payload)
    "shard_profile": ("kind", "n_shards", "rows", "nnz",
                      "halo_send_bytes"),
    # an imbalance-aware partition plan (balance.PartitionPlan) was
    # applied to a distributed solve: the chosen reorder/split lane plus
    # the planner's predicted imbalance digest joined to the measured
    # one of the partition actually built - the shardscope feedback
    # loop, closed, in one event.  A second, EXTENDED emission with
    # stage="drift" (telemetry.calibrate.note_drift) follows a measured
    # solve and additionally carries drift_pct /
    # predicted_s_per_iteration / measured_s_per_iteration - the
    # model-error % of the plan's cost prediction
    "partition_plan": ("reorder", "split", "n_shards", "measured"),
    # measured per-shard per-phase timing of a partitioned operator
    # (telemetry.phasetrace.PhaseProfile.to_json payload): phase
    # seconds (halo/spmv/reduction + the composed step), per-shard
    # spmv seconds, per-link wire bandwidths ("links"), and the
    # explained-fraction residual check
    "phase_profile": ("n_shards", "exchange", "phases",
                      "explained_fraction"),
    # a sequence replan decision (dist_cg.solve_sequence): whether
    # solve k+1 kept or switched its partition plan based on the model
    # calibrated from solve k, with the predicted gain of the choice
    "replan": ("solve_index", "decision"),
    # a compiled distributed solver was evicted from the bounded LRU
    # cache (parallel.dist_cg; a long-running service on many
    # operators must not leak traces) - key is the evicted entry's
    # digest, the same id its dist_cache_hit/miss events carried
    "dist_cache_evict": ("key",),
    # solver-service request lifecycle (serve.SolverService): a request
    # entered its microbatch queue; a batch was cut and dispatched onto
    # solve_many / solve_distributed_many (the batch's events share the
    # dispatch's solve_id - the request->solve linkage); a request left
    # the service with a typed terminal status (CONVERGED/.../TIMEOUT)
    "request_enqueued": ("request_id", "handle", "queue_depth"),
    "batch_dispatch": ("handle", "bucket", "n_requests", "reason"),
    "request_done": ("request_id", "status", "wait_s"),
    # sampled in-flight heartbeat (FlightConfig.heartbeat > 0 only;
    # queued in the hot loop, emitted at the check block's host read)
    "flight_heartbeat": ("iteration",),
    # flight-recorder health verdict (telemetry.health): trace
    # classification + decay rates + Ritz condition estimate
    "solve_health": ("classification", "converged", "iterations"),
    # a solve exited with a typed BREAKDOWN (robust/): site names the
    # faulted recurrence site when a chaos FaultPlan was armed
    # ("unknown" for organically detected breakdowns), iterations the
    # step the health predicate caught it at
    "solve_fault": ("site", "status", "iterations"),
    # a recovery action after a breakdown (robust.solve_with_recovery):
    # action is "restart" (re-seeded re-dispatch), "recovered" (final
    # solve converged after >= 1 restart) or "exhausted" (budget spent,
    # typed BREAKDOWN returned)
    "solve_recovery": ("attempt", "action"),
    # serve retry/breaker lifecycle: a failed (ERROR/BREAKDOWN) request
    # was re-enqueued with backoff; a handle's circuit breaker changed
    # state (closed/open/half_open)
    "request_retry": ("request_id", "attempt", "status"),
    "breaker_transition": ("handle", "state"),
    # multi-tenant overload protection (serve.admission/serve.sched):
    # a submit was REFUSED at the door (token bucket exhausted, or the
    # shed ladder's reject rung - reason says which; retry_after_s is
    # the typed hint the caller gets); the weighted-fair dispatcher
    # picked a flow ("dispatch", with the priced cost) or held a
    # dispatch-ready flow under the defer rung ("defer", throttled to
    # one event per flow per ladder episode); the shed ladder changed
    # level (0 ok / 1 degrade / 2 defer / 3 reject, with the queue
    # depth that drove it)
    "admission": ("request_id", "tenant", "slo_class", "decision"),
    "sched_dispatch": ("tenant", "slo_class", "decision"),
    "shed": ("level", "queue_depth"),
    # Krylov recycling (solver.recycle): a RecycleSpace was harvested
    # from a solve's basis ring + flight tridiagonal (k columns kept,
    # window = tridiagonal rows used, iterations = source solve's);
    # a solve consulted a recycled space (iters_saved vs the
    # undeflated baseline rides when the consumer knows one)
    "recycle_harvest": ("k", "window", "iterations"),
    "recycle_applied": ("k", "iterations"),
    # elastic solves (robust.elastic / robust.watchdog): the straggler
    # watchdog found one shard's measured phase timing (or one link's
    # measured bandwidth) degraded past its threshold vs the
    # calibration-cache EWMA baseline; a checkpoint was migrated to a
    # different mesh shape (reason: "resume_mesh_change" for a
    # cross-run elastic resume, "shard_degraded"/"shard_loss" for the
    # in-run checkpoint-now-and-migrate triggers); a live serve handle
    # was migrated onto a new mesh (queued requests preserved, buckets
    # re-warmed off the request path)
    "shard_degraded": ("shard", "phase", "ratio"),
    "solve_migration": ("n_shards_from", "n_shards_to", "reason"),
    "handle_migrated": ("handle", "n_shards_from", "n_shards_to"),
    # request observatory (telemetry.tracing / telemetry.slo /
    # serve.usage): one causal span of a request's life in the serve
    # tier (name in {submit, admission, queue_wait, sched, solve,
    # retry, migration, result}; parent_span_id None only for the
    # root submit span; traceparent is the W3C-shaped context string
    # a future HTTP/gRPC shim injects/extracts unchanged); a rolling
    # SLO error-budget window tripped its burn-rate threshold for one
    # (tenant, slo_class, window); one dispatched batch's metered
    # usage totals with the per-tenant apportionment that must
    # reconcile with them
    "span": ("trace_id", "span_id", "parent_span_id", "name",
             "request_id", "start_s", "duration_s"),
    "slo_burn": ("tenant", "slo_class", "window", "burn_rate"),
    "usage": ("n_requests", "device_seconds", "wire_bytes",
              "batch_iterations"),
    # device-memory footprint of a partitioned solve
    # (telemetry.memscope.MemoryFootprint.to_json payload, plus the
    # measured live-array twin and backend allocator peak when known):
    # per-shard persistent bytes (exact matrix + modeled solver working
    # set), the jaxpr-liveness transient peak, and the FITS / TIGHT /
    # OVERFLOW / unknown classification against MachineModel.hbm_bytes
    "memory_profile": ("kind", "n_shards", "n_rhs", "matrix_bytes",
                       "persistent_bytes", "peak_bytes",
                       "classification"),
    # the solve finished (converged or not) and was synced
    "solve_end": ("status", "iterations", "residual_norm"),
}

_COUNTER = itertools.count(1)
_SOLVE_ID: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "cuda_mpi_parallel_tpu_solve_id", default=None)
_SCOPE_FIELDS: contextvars.ContextVar[Dict[str, Any]] = \
    contextvars.ContextVar("cuda_mpi_parallel_tpu_event_fields",
                           default={})

#: Thread-visible mirror of the contextvar scope: the scope managers
#: keep this plain snapshot current, and the flight recorder's
#: heartbeat stamps each sample with it when the sample is queued, so a
#: sample delivered later (at the next check-block read, or at scope
#: exit) still carries the solve_id/phase of the solve that took it.
#: Single in-flight solve per process assumed (concurrent solves would
#: interleave).
_AMBIENT: Dict[str, Any] = {}


def _sync_ambient() -> None:
    snap: Dict[str, Any] = {}
    sid = _SOLVE_ID.get()
    if sid is not None:
        snap["solve_id"] = sid
    snap.update(_SCOPE_FIELDS.get())
    global _AMBIENT
    _AMBIENT = snap


def ambient_scope() -> Dict[str, Any]:
    """The current solve scope (solve_id + ``scoped`` fields) as seen
    from ANY thread - what host-side callbacks pass to ``emit`` so
    their events stay correlated with the solve that is in flight."""
    return dict(_AMBIENT)


def _drain_callbacks() -> None:
    """Flush the flight recorder's pending heartbeat samples before a
    scope is torn down: a sample is emitted at the check-block read
    after it was taken, so a solve that ended without one (at maxiter)
    leaves its last samples queued.  Runs at scope exit - post-solve,
    outside any hot loop (it waits for the samples' copy to the host) -
    and is a no-op when the recorder was never imported or has nothing
    pending."""
    flight = sys.modules.get(__name__.rpartition(".")[0] + ".flight")
    if flight is not None:
        flight.drain_heartbeats()


@contextlib.contextmanager
def scoped(**fields: Any) -> Iterator[None]:
    """Attach ``fields`` to every event emitted inside the block.

    The honest answer to double-dispatch: a CLI solve runs once for
    compile warmup and once timed, and BOTH dispatches really happen -
    so both emit, but the warmup's events carry ``phase="warmup"`` and
    consumers filter rather than miscount.  Explicit emit() fields win
    over scope fields on collision.
    """
    merged = dict(_SCOPE_FIELDS.get())
    merged.update(fields)
    token = _SCOPE_FIELDS.set(merged)
    _sync_ambient()
    try:
        yield
    finally:
        _drain_callbacks()
        _SCOPE_FIELDS.reset(token)
        _sync_ambient()


def scope_phase() -> str:
    """The current emission scope's phase ("solve" unless inside
    ``scoped(phase=...)``).  Metric-updating instrumentation uses this
    as a label so dispatch counters can be split the same way the
    event stream is (e.g. the CLI's compile-warmup dispatch)."""
    return str(_SCOPE_FIELDS.get().get("phase", "solve"))


def new_solve_id() -> str:
    """Process-unique opaque id: monotonic counter + coarse timestamp."""
    return f"s{next(_COUNTER):06d}-{int(time.time())}"


def current_solve_id() -> Optional[str]:
    return _SOLVE_ID.get()


@contextlib.contextmanager
def solve_scope(solve_id: Optional[str] = None) -> Iterator[str]:
    """Bind a solve id so every ``emit`` inside the block carries it."""
    sid = solve_id if solve_id is not None else new_solve_id()
    token = _SOLVE_ID.set(sid)
    _sync_ambient()
    try:
        yield sid
    finally:
        _drain_callbacks()
        _SOLVE_ID.reset(token)
        _sync_ambient()


class EventStream:
    """A JSONL sink.  ``path_or_stream`` is a filesystem path (opened
    append, line-buffered flushes) or any ``.write()``-able object.

    ``rotate_bytes``: size-based rotation for long-running sinks (a
    serve process on ``--trace-events`` must never fill the disk).
    After any write that leaves the file at or past the threshold the
    file is atomically renamed to ``PATH.1`` (``os.replace`` - the
    same one-predecessor pattern as checkpoint ``keep_last``) and a
    fresh ``PATH`` is opened, so at most ~2x ``rotate_bytes`` is ever
    on disk.  Path sinks only; ignored for stream objects, which have
    no name to rename.
    """

    def __init__(self, path_or_stream: Union[str, IO[str]],
                 rotate_bytes: Optional[int] = None):
        if isinstance(path_or_stream, (str, bytes)):
            self._path: Optional[str] = os.fspath(path_or_stream)
            self._fh: IO[str] = open(path_or_stream, "a", encoding="utf-8")
            self._owns = True
        else:
            self._path = None
            self._fh = path_or_stream
            self._owns = False
        self._rotate_bytes = (int(rotate_bytes)
                              if rotate_bytes and self._path else None)
        self._lock = threading.Lock()

    def emit(self, event_type: str, **fields: Any) -> Dict[str, Any]:
        record = _build_event(event_type, fields)
        line = json.dumps(sanitize(record), allow_nan=False,
                          sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            if (self._rotate_bytes is not None
                    and self._fh.tell() >= self._rotate_bytes):
                self._rotate_locked()
        return record

    def _rotate_locked(self) -> None:
        """Rename the full file to ``.1`` and reopen fresh (lock held)."""
        assert self._path is not None
        self._fh.close()
        os.replace(self._path, self._path + ".1")
        self._fh = open(self._path, "a", encoding="utf-8")

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "EventStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _build_event(event_type: str, fields: Dict[str, Any]) -> Dict[str, Any]:
    if event_type not in EVENT_SCHEMA:
        raise ValueError(
            f"unknown event type {event_type!r}; known: "
            f"{sorted(EVENT_SCHEMA)}")
    record = {"event": event_type, "t": time.perf_counter(),
              "solve_id": current_solve_id()}
    record.update(_SCOPE_FIELDS.get())
    record.update(fields)
    missing = [f for f in EVENT_SCHEMA[event_type] if f not in record]
    if missing:
        raise ValueError(
            f"event {event_type!r} missing required fields: {missing}")
    return record


def validate_event(record: Dict[str, Any]) -> Dict[str, Any]:
    """Check one parsed JSONL record against the schema; returns it.

    Raises ``ValueError`` on an unknown type, a missing envelope or
    required field, or a payload that is not strict JSON (tested by
    re-serializing with ``allow_nan=False``).
    """
    if not isinstance(record, dict):
        raise ValueError(f"event record must be an object, got "
                         f"{type(record).__name__}")
    etype = record.get("event")
    if etype not in EVENT_SCHEMA:
        raise ValueError(f"unknown event type {etype!r}")
    for field in ("t", "solve_id") + EVENT_SCHEMA[etype]:
        if field not in record:
            raise ValueError(f"event {etype!r} missing field {field!r}")
    if not isinstance(record["t"], (int, float)):
        raise ValueError(f"event timestamp must be numeric, got "
                         f"{record['t']!r}")
    json.dumps(record, allow_nan=False)   # strict-JSON payload check
    return record


def read_events(path: str) -> list:
    """Parse and schema-validate a solve-trace JSONL file.

    The single reader every consumer of ``--trace-events`` output goes
    through (tools/solve_report.py, tools/validate_trace.py), so "which
    traces are acceptable" has one definition.  Blank lines are
    skipped; any other violation raises ``ValueError`` naming
    ``path:lineno``.  An event-free file is an error - for a trace
    consumer there is nothing to do, and for the CI gate silence means
    the instrumentation broke.
    """
    out = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(validate_event(json.loads(line)))
            except (ValueError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e
    if not out:
        raise ValueError(f"{path}: no events")
    return out


# ---------------------------------------------------------------------------
# in-process subscribers (the ops plane's live event bus)

class Subscription:
    """A bounded in-process event ring one consumer drains.

    The emitter side (:func:`emit`, any thread, possibly mid-solve
    epilogue) NEVER blocks on a subscriber: ``_offer`` is O(1) under
    the subscription's own lock, and when the ring is full the OLDEST
    event is dropped and counted - in :attr:`dropped` and in the
    process-wide ``events_dropped_total`` counter - so a stalled
    consumer (a slow SSE client, a wedged scraper) can never apply
    backpressure to the serving path.  Consumers drain with
    :meth:`pop` (blocking, timeout) or :meth:`drain` (everything
    buffered, non-blocking).
    """

    def __init__(self, maxlen: int = 1024):
        if maxlen < 1:
            raise ValueError(f"subscription maxlen must be >= 1, got "
                             f"{maxlen}")
        self.maxlen = int(maxlen)
        self._ring: deque = deque()
        self._cond = threading.Condition()
        self.dropped = 0
        self.closed = False

    def _offer(self, record: Dict[str, Any]) -> None:
        """Emitter side: append without ever blocking (drop-oldest)."""
        dropped = False
        with self._cond:
            if self.closed:
                return
            if len(self._ring) >= self.maxlen:
                self._ring.popleft()
                self.dropped += 1
                dropped = True
            self._ring.append(record)
            self._cond.notify_all()
        if dropped:
            # registry import deferred: events must stay importable
            # without pulling the metrics module at module-import time
            from .registry import REGISTRY

            REGISTRY.counter(
                "events_dropped_total",
                "events dropped by full in-process subscriber rings "
                "(bounded bus, never blocks the emitter)").inc()

    def pop(self, timeout: Optional[float] = None
            ) -> Optional[Dict[str, Any]]:
        """Oldest buffered event, waiting up to ``timeout`` seconds
        (``None`` = wait forever).  ``None`` on timeout or once the
        subscription is closed and drained."""
        with self._cond:
            while not self._ring:
                if self.closed:
                    return None
                if not self._cond.wait(timeout=timeout):
                    return None
            return self._ring.popleft()

    def drain(self) -> list:
        """Everything buffered right now (non-blocking, FIFO)."""
        with self._cond:
            out = list(self._ring)
            self._ring.clear()
            return out

    def close(self) -> None:
        """Detach: stops receiving and wakes any blocked ``pop``."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()


_SUBS_LOCK = threading.Lock()
_SUBS: Tuple["Subscription", ...] = ()


def subscribe(maxlen: int = 1024) -> Subscription:
    """Attach a bounded in-process subscriber to the event stream.

    Subscribers receive every event :func:`emit` produces - sink or no
    sink - as sanitized strict-JSON-ready dicts.  A live subscriber
    makes :func:`active` true, so derived instrumentation runs for it
    exactly as it would for a file sink; the solve body itself stays
    bit-identical (everything here is host-side).
    """
    global _SUBS
    sub = Subscription(maxlen=maxlen)
    with _SUBS_LOCK:
        _SUBS = _SUBS + (sub,)
    return sub


def unsubscribe(sub: Subscription) -> None:
    """Detach and close a subscription (idempotent)."""
    global _SUBS
    with _SUBS_LOCK:
        _SUBS = tuple(s for s in _SUBS if s is not sub)
    sub.close()


# ---------------------------------------------------------------------------
# module-level default sink (what instrumentation sites talk to)

_SINK: Optional[EventStream] = None


def configure(path_or_stream: Union[str, IO[str], None],
              rotate_bytes: Optional[int] = None) -> None:
    """Install (or with ``None`` remove) the process-default event sink.

    Instrumented call sites all emit through this module-level sink, so
    one ``configure("trace.jsonl")`` traces every solve in the process.
    ``rotate_bytes`` passes through to :class:`EventStream` (path
    sinks only): long-running serve processes rotate to ``PATH.1``
    instead of growing without bound.
    """
    global _SINK
    if _SINK is not None:
        _SINK.close()
        _SINK = None
    if path_or_stream is not None:
        _SINK = EventStream(path_or_stream, rotate_bytes=rotate_bytes)


def active() -> bool:
    """True when anyone is listening: a default sink is installed or
    at least one in-process subscriber is attached."""
    return _SINK is not None or bool(_SUBS)


def emit(event_type: str, **fields: Any) -> Optional[Dict[str, Any]]:
    """Emit to the default sink and every attached subscriber; a cheap
    no-op when nobody is listening.

    Returns the emitted record (or ``None`` when inactive) so call
    sites can reuse the payload.  Subscribers receive the SANITIZED
    record (non-finite floats -> ``None``) - exactly what the JSONL
    sink would have serialized, so SSE consumers and file readers see
    one payload shape.
    """
    sink, subs = _SINK, _SUBS
    if sink is None and not subs:
        return None
    if sink is not None:
        record = sink.emit(event_type, **fields)
    else:
        record = _build_event(event_type, fields)
    if subs:
        clean = sanitize(record)
        for sub in subs:
            sub._offer(clean)
    return record


@contextlib.contextmanager
def capture() -> Iterator[io.StringIO]:
    """Route the default sink into an in-memory buffer for the block
    (tests; restores the previous sink on exit)."""
    global _SINK
    prev = _SINK
    buf = io.StringIO()
    _SINK = EventStream(buf)
    try:
        yield buf
    finally:
        _SINK = prev
