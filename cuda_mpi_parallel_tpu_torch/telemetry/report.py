"""The unified solve report + Perfetto timeline exporter.

Counterpart of the JAX package's ``telemetry/report.py``: for the same
inputs, :meth:`SolveReport.to_json` and :func:`perfetto_trace` give the
JAX dicts, key for key.

The telemetry produces four streams for one solve - the JSONL event
trace, the flight record / health verdict, the per-shard profile
(:mod:`.shardscope`) and the roofline join (:mod:`.roofline`).  This
module fuses them into the two artifacts a human actually opens:

* :class:`SolveReport` - one text (or JSON) report answering "what
  ran, how fast, which shard is the straggler, how far from the
  hardware" in a screenful;
* :func:`perfetto_trace` - a Chrome-trace/Perfetto JSON timeline
  (``chrome://tracing`` / https://ui.perfetto.dev load it directly):
  one track per shard drawing the halo / spmv / reduction phases of
  each iteration, plus one track for the host-side ``Timer`` sections
  and a residual counter track from the flight record.  The per-shard
  spans come from one of two sources, named in the trace metadata's
  ``span_source`` field: ``"measured"`` when a
  ``telemetry.phasetrace.PhaseProfile`` was passed (real per-shard
  per-phase walls - the straggler is measured, and any unexplained
  iteration time shows as an honest gap before the next iteration),
  or ``"modeled"`` (the static-schedule fallback: per-shard durations
  proportional to accounted work, the iteration slot scaled to the
  measured per-iteration wall time).

:func:`validate_perfetto` is the structural contract both the tests
and the JAX package's ``tools/validate_trace.py`` enforce: loadable
event array, ``ph``/``ts``/``pid``/``tid`` on every event, monotone
``ts`` per track (the tool additionally requires the ``span_source``
metadata field on every trace this repo exports).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import sanitize

__all__ = [
    "SolveReport",
    "memory_lines",
    "perfetto_trace",
    "phase_lines",
    "service_lines",
    "validate_perfetto",
    "write_perfetto",
]

#: iterations drawn in the timeline: enough to see the steady-state
#: pattern, bounded so a 30k-iteration solve does not emit a 100 MB
#: trace.  When a solve runs longer, the drawn window is the FIRST
#: ``MAX_DRAWN_ITERATIONS`` and the truncation is recorded in the
#: trace metadata (no silent caps).
MAX_DRAWN_ITERATIONS = 64

_HOST_PID = 0
_SHARD_PID = 1
_COUNTER_PID = 2
_REQUEST_PID = 3


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """Everything known about one finished solve, fused.

    All fields are optional except the record: the report renders
    whatever subset exists (a single-device solve has no shard
    profile; an engine without the recorder has no flight section).
    """

    record: Dict[str, Any]                  # utils.logging.solve_record
    shard: Optional[object] = None          # shardscope.ShardReport
    roofline: Optional[object] = None       # roofline.RooflineReport
    flight_summary: Optional[dict] = None   # FlightRecord.summary()
    health: Optional[dict] = None           # SolveHealth.to_json()
    comm: Optional[dict] = None             # per-solve comm account
    #: runtime calibration & drift (telemetry.calibrate): either a
    #: SequenceResult.summary() (a solve_sequence run) or a bare
    #: {"drift": DriftReport.to_json()} for a single planned solve
    calibration: Optional[dict] = None
    #: solver-service replay summary (serve.SolverService.stats()):
    #: request/batch counts, occupancy, padding, latency percentiles
    service: Optional[dict] = None
    #: measured phase profile (telemetry.phasetrace
    #: PhaseProfile.to_json() payload, or the phase_profile event)
    phase: Optional[dict] = None
    #: device-memory observatory (telemetry.memscope): the
    #: MemoryFootprint.to_json() payload plus ``measured_bytes`` /
    #: ``device_peak_bytes`` when the dispatch measured its twin
    memory: Optional[dict] = None
    sections: Sequence[Tuple[str, float]] = ()

    def to_json(self) -> dict:
        out: Dict[str, Any] = {"record": dict(self.record)}
        if self.shard is not None:
            out["shard_profile"] = self.shard.to_json()
        if self.roofline is not None:
            out["roofline"] = self.roofline.to_json()
        if self.flight_summary is not None:
            out["flight"] = dict(self.flight_summary)
        if self.health is not None:
            out["health"] = dict(self.health)
        if self.comm is not None:
            out["comm"] = dict(self.comm)
        if self.calibration is not None:
            out["calibration"] = dict(self.calibration)
        if self.service is not None:
            out["service"] = dict(self.service)
        if self.phase is not None:
            out["phase_profile"] = dict(self.phase)
        if self.memory is not None:
            out["memory"] = dict(self.memory)
        if self.sections:
            out["sections"] = {name: s for name, s in self.sections}
        return sanitize(out)

    def to_text(self) -> str:
        rec = self.record
        lines: List[str] = []
        lines.append(f"== solve report: {rec.get('problem', '?')} ==")
        rnorm = rec.get("residual_norm")
        rnorm_s = f"{rnorm:.6e}" if isinstance(rnorm, (int, float)) \
            else "n/a"
        lines.append(
            f"status {rec.get('status', '?')}  "
            f"iterations {rec.get('iterations', '?')}  "
            f"||r|| {rnorm_s}")
        if rec.get("elapsed_s") is not None:
            lines.append(
                f"time {rec['elapsed_s'] * 1e3:.3f} ms  "
                f"({rec.get('iters_per_sec', 0.0):.1f} iters/s)  "
                f"device {rec.get('device', '?')} "
                f"mesh={rec.get('mesh', 1)} dtype={rec.get('dtype', '?')}")
        if self.shard is not None:
            lines.append("")
            lines.append(f"-- per-shard profile ({self.shard.kind}) --")
            lines.append(self.shard.table())
        if self.comm is not None:
            lines.append("")
            lines.append(
                f"-- communication (comm-layer record, per device) --")
            lines.append(
                f"{self.comm.get('psum', 0)} psum, "
                f"{self.comm.get('ppermute', 0)} ppermute, "
                f"{self.comm.get('all_gather', 0)} all_gather, "
                f"{self.comm.get('comm_bytes', 0)} payload bytes total")
            if self.comm.get("wire_bytes") is not None:
                ex = self.comm.get("exchange")
                pad = self.comm.get("halo_padding_fraction")
                lines.append(
                    f"wire: {self.comm['wire_bytes']} interconnect "
                    f"bytes total"
                    + (f", exchange={ex}" if ex else "")
                    + (f", halo padding {pad * 100:.1f}%"
                       if pad is not None else ""))
            if self.comm.get("note"):
                lines.append(f"({self.comm['note']})")
        if self.roofline is not None:
            r = self.roofline
            age = getattr(r, "model_age_s", None)
            age_s = f", measured {age / 3600:.1f}h ago" \
                if age is not None else ""
            lines.append("")
            lines.append(f"-- roofline ({r.model.name}, {r.model.source}"
                         f"{age_s}) --")
            lines.append(
                f"per-iteration model: {r.flops_per_iteration:.3g} flops, "
                f"{r.mem_bytes_per_iteration:.3g} mem B, "
                f"{r.comm_bytes_per_iteration:.3g} comm B "
                f"(intensity {r.arithmetic_intensity:.3f} flop/B)")
            lines.append(
                f"bound terms: mem {r.t_mem_s * 1e6:.3g} us, compute "
                f"{r.t_flop_s * 1e6:.3g} us, comm "
                f"{r.t_comm_s * 1e6:.3g} us -> {r.bound}-bound")
            lines.append(
                f"efficiency: {r.efficiency_pct:.1f}% of roofline "
                f"({r.model_s_per_iteration * 1e6:.3g} us model vs "
                f"{r.measured_s_per_iteration * 1e6:.3g} us measured "
                f"per iteration)")
        if self.phase is not None:
            lines.append("")
            lines.append("-- phase profile (measured) --")
            lines.extend(phase_lines(self.phase))
        if self.memory is not None:
            lines.append("")
            lines.append("-- memory (per-shard HBM accounting) --")
            lines.extend(memory_lines(self.memory))
        if self.calibration is not None:
            lines.append("")
            lines.append("-- calibration & drift --")
            lines.extend(_calibration_lines(self.calibration))
        if self.service is not None:
            lines.append("")
            lines.append("-- solver service --")
            lines.extend(service_lines(self.service))
        if self.health is not None:
            lines.append("")
            lines.append(f"-- solve health --")
            lines.append(
                f"{self.health.get('classification', '?')}: "
                f"{self.health.get('message', '')}")
        if self.flight_summary is not None:
            f = self.flight_summary
            lines.append(
                f"flight: {f.get('n_records')} records @ stride "
                f"{f.get('stride')}, decay rate {f.get('decay_rate')}")
        if self.sections:
            lines.append("")
            lines.append("-- host timer sections --")
            for name, sec in self.sections:
                lines.append(f"  {name:>12}: {sec * 1e3:9.3f} ms")
        return "\n".join(lines) + "\n"


def memory_lines(mem: Dict[str, Any]) -> List[str]:
    """Render a memscope memory profile (the ``memory_profile`` event
    payload / ``MemoryFootprint.to_json()`` plus the measured twin):
    worst-shard persistent split matrix/solver, the transient peak vs
    the device HBM, and the measured device-array bytes that anchor
    the model."""
    def fmt(v) -> str:
        if not isinstance(v, (int, float)):
            return "n/a"
        for unit, scale in (("GiB", 2 ** 30), ("MiB", 2 ** 20),
                            ("KiB", 2 ** 10)):
            if abs(v) >= scale:
                return f"{v / scale:.2f} {unit}"
        return f"{int(v)} B"

    pers = mem.get("persistent_bytes") or []
    lines = [
        f"{mem.get('kind', '?')} x {mem.get('n_shards', '?')} shards, "
        f"k={mem.get('n_rhs', 1)}: persistent "
        f"{fmt(max(pers) if pers else None)}/shard worst "
        f"(matrix {fmt(max(mem.get('matrix_bytes') or [0]))}, "
        f"solver {fmt(max(mem.get('solver_bytes') or [0]))})",
    ]
    line = f"peak {fmt(mem.get('peak_bytes'))}/shard"
    if mem.get("jaxpr_peak_bytes") is not None:
        line += f" (recorded transient {fmt(mem['jaxpr_peak_bytes'])})"
    cls = mem.get("classification", "unknown")
    if mem.get("hbm_bytes"):
        hr = mem.get("headroom_frac")
        line += f" vs {fmt(mem['hbm_bytes'])} HBM -> {cls}"
        if isinstance(hr, (int, float)):
            line += f" ({hr * 100:.1f}% headroom)"
    else:
        line += f" -> {cls} (device HBM size unknown)"
    lines.append(line)
    if mem.get("measured_bytes") is not None:
        line = (f"measured: {fmt(mem['measured_bytes'])} device arrays "
                f"held (== model, asserted)")
        if mem.get("device_peak_bytes") is not None:
            line += f", allocator peak {fmt(mem['device_peak_bytes'])}"
        lines.append(line)
    return lines


def service_lines(stats: Dict[str, Any]) -> List[str]:
    """Render a solver-service replay summary
    (``serve.SolverService.stats()``): request disposition, batch
    occupancy/padding, bucket usage and the latency percentiles - the
    queue-side story the per-solve sections above cannot tell."""
    def ms(v) -> str:
        return f"{v * 1e3:.3f} ms" if isinstance(v, (int, float)) \
            else "n/a"

    lines = [
        f"requests: {stats.get('submitted', 0)} submitted, "
        f"{stats.get('completed', 0)} completed "
        f"({stats.get('converged', 0)} converged, "
        f"{stats.get('timeouts', 0)} timeout, "
        f"{stats.get('errors', 0)} error)"
        + (f", {stats['rejected']} rejected (backpressure)"
           if stats.get("rejected") else "")
        + f", queue depth {stats.get('queue_depth', 0)}",
        f"batches : {stats.get('batches', 0)} dispatched, occupancy "
        f"mean {stats.get('occupancy_mean', 0.0):.2f}, padding "
        f"{stats.get('padding_fraction', 0.0) * 100:.1f}% "
        f"({stats.get('padded_lanes', 0)}/"
        f"{stats.get('lanes_dispatched', 0)} lanes)",
    ]
    buckets = stats.get("bucket_counts") or {}
    if buckets:
        lines.append("buckets : " + ", ".join(
            f"k={k}: {v}" for k, v in sorted(
                buckets.items(), key=lambda kv: int(kv[0]))))
    # the self-healing story (retry policy / circuit breaker /
    # tolerance degradation), only when any of it actually fired
    if stats.get("retries") or stats.get("refused") \
            or stats.get("degraded") or stats.get("breakers") \
            or stats.get("migrations"):
        open_b = stats.get("breakers") or {}
        lines.append(
            f"robust  : {stats.get('retries', 0)} retried, "
            f"{stats.get('refused', 0)} refused (breaker), "
            f"{stats.get('degraded', 0)} tolerance-degraded"
            + (f", {stats['migrations']} handle(s) migrated"
               if stats.get("migrations") else "")
            + (f"; breakers not closed: "
               f"{', '.join(f'{k}={v}' for k, v in sorted(open_b.items()))}"
               if open_b else ""))
    # the overload story (shed ladder / admission / per-tenant and
    # per-class disposition), only when the service actually has one
    shed = stats.get("shed")
    if shed:
        cap = shed.get("capacity_rhs_per_s")
        lines.append(
            f"shed    : level {shed.get('level', 0)} "
            f"({shed.get('name', 'ok')}), "
            f"{shed.get('transitions', 0)} transition(s), "
            f"{shed.get('deferred_flows', 0)} deferred flow(s), "
            f"{shed.get('admission_rejected', 0)} admission-rejected"
            + (f"; capacity ~{cap:.1f} RHS/s"
               if isinstance(cap, (int, float)) else ""))
    for tenant, row in sorted((stats.get("tenants") or {}).items()):
        lines.append(
            f"tenant  : {tenant}: {row.get('submitted', 0)} submitted, "
            f"{row.get('completed', 0)} completed, "
            f"{row.get('rejected', 0)} rejected, "
            f"{row.get('timeouts', 0)} timeout, "
            f"depth {row.get('depth', 0)}")
    for name, row in sorted((stats.get("classes") or {}).items()):
        target = row.get("target_latency_s")
        lines.append(
            f"class   : {name}: {row.get('submitted', 0)} submitted, "
            f"{row.get('in_slo', 0)}/{row.get('completed', 0)} in SLO"
            + (f" (target {ms(target)})"
               if isinstance(target, (int, float)) else "")
            + f", {row.get('timeouts', 0)} timeout, "
            f"{row.get('rejected', 0)} rejected, p99 "
            f"{ms(row.get('p99_s'))}")
    lat = stats.get("latency") or {}
    lines.append(
        f"latency : p50 {ms(lat.get('p50_s'))}  "
        f"p95 {ms(lat.get('p95_s'))}  p99 {ms(lat.get('p99_s'))}  "
        f"(max {ms(lat.get('max_s'))})")
    # wait-vs-solve split (queueing delay vs batched solve wall): the
    # two levers are different - wait is tuned with max_wait/max_batch,
    # solve with the operator/bucket - so the report separates them
    for key, label in (("wait", "wait    "), ("solve", "solve   ")):
        sub = stats.get(key)
        if sub:
            lines.append(
                f"{label}: p50 {ms(sub.get('p50_s'))}  "
                f"p95 {ms(sub.get('p95_s'))}  "
                f"p99 {ms(sub.get('p99_s'))}")
    if stats.get("solved_rhs_per_sec") is not None:
        lines.append(
            f"throughput: {stats['solved_rhs_per_sec']:.1f} solved "
            f"RHS/s over {stats.get('replay_window_s', 0.0):.3f} s "
            f"replay window")
    if stats.get("dist_cache_misses_postwarm") is not None:
        lines.append(
            f"zero-retrace: dist_cache_miss after warmup = "
            f"{int(stats['dist_cache_misses_postwarm'])}")
    return lines


def phase_lines(phase: Dict[str, Any]) -> List[str]:
    """Render a measured phase profile (``telemetry.phasetrace``
    ``PhaseProfile.to_json()`` payload, or the ``phase_profile`` event
    - same shape): per-phase walls, the per-shard SpMV row with its
    measured stall factor, per-link wire bandwidths, and the
    explained-fraction residual check."""
    def us(v) -> str:
        return f"{float(v) * 1e6:.1f} us" if isinstance(v, (int, float)) \
            else "n/a"

    ph = phase.get("phases") or {}
    stall = phase.get("stall_factors") or {}
    reds = int(phase.get("reductions_per_iteration", 2))
    lines = [
        f"exchange {phase.get('exchange', '?')} on "
        f"{phase.get('n_shards', '?')} shards, "
        f"{phase.get('repeats', '?')} chained reps/phase "
        f"[plan: {phase.get('plan', 'even')}]",
        f"halo {us(ph.get('halo_s'))} + spmv {us(ph.get('spmv_s'))} + "
        f"{reds} x reduction {us(ph.get('reduction_s'))} vs measured "
        f"iteration core {us(phase.get('step_s'))}",
    ]
    spmv = phase.get("spmv_s")
    if spmv:
        lines.append(
            "per-shard spmv: ["
            + ", ".join(f"{float(v) * 1e6:.1f}" for v in spmv)
            + f"] us, stall factor {float(stall.get('spmv', 1.0)):.3f}")
    for link in phase.get("links") or ():
        lines.append(
            f"link shift {link.get('shift')}: {link.get('bytes')} "
            f"B/round @ "
            f"{float(link.get('bytes_per_s', 0.0)) / 1e6:.2f} MB/s")
    ef = phase.get("explained_fraction")
    if ef is not None:
        lines.append(f"explained: phase sum = {float(ef) * 100:.1f}% "
                     f"of the measured iteration core")
    efs = phase.get("explained_fraction_vs_solve")
    if efs is not None:
        lines.append(
            f"           {float(efs) * 100:.1f}% of the solve's "
            f"measured per-iteration wall "
            f"({float(phase.get('solve_s_per_iteration', 0.0)) * 1e6:.1f}"
            f" us/iter)")
    return lines


def _calibration_lines(calib: Dict[str, Any]) -> List[str]:
    """Render the calibration/drift payload (tolerant of both shapes:
    a SequenceResult.summary() or a bare single-solve drift dict)."""
    lines: List[str] = []
    fit = calib.get("calibration")
    if isinstance(fit, dict) and isinstance(fit.get("model"), dict):
        m = fit["model"]
        net = m.get("net_bytes_per_s") or 0.0
        lines.append(
            f"model {m.get('name', '?')}: gather slowdown "
            f"x{m.get('gather_slowdown', 0.0):.2f}, net "
            f"{net / 1e9:.3f} GB/s, fit {fit.get('method', '?')} "
            f"(residual {fit.get('residual_rel', 0.0) * 100:.1f}%, "
            f"{'confident' if fit.get('confident') else 'LOW CONFIDENCE'}"
            f", {fit.get('n_observations', 0)} obs)")
    drift = calib.get("drift")
    if isinstance(drift, dict):
        lines.append(
            f"drift: model error {drift.get('drift_pct', 0.0):+.1f}% "
            f"(predicted "
            f"{drift.get('predicted_s_per_iteration', 0.0) * 1e6:.3g} "
            f"us/iter vs measured "
            f"{drift.get('measured_s_per_iteration', 0.0) * 1e6:.3g}, "
            f"model {drift.get('model', '?')}, plan "
            f"{drift.get('plan', '?')})")
    for dec in calib.get("decisions") or ():
        lines.append(
            f"replan: {dec.get('decision', '?')} for solve "
            f"{dec.get('solve_index', 0) + 1} (predicted gain "
            f"{dec.get('predicted_gain_pct', 0.0):+.1f}% on "
            f"{dec.get('model', '?')})")
    for s in calib.get("solves") or ():
        lines.append(
            f"solve {s.get('index', 0) + 1}: "
            f"{s.get('iterations', '?')} iters, "
            f"{s.get('elapsed_s', 0.0) * 1e3:.3f} ms, plan "
            f"{s.get('plan', '?')}"
            + (f" [{s['scored_by']}]" if s.get("scored_by") else ""))
    if not lines:
        lines.append("(no calibration data)")
    return lines


# ---------------------------------------------------------------------------
# Perfetto / Chrome-trace export

def _meta(pid: int, tid: int, name: str, value: str) -> dict:
    # metadata events carry ts=0 so the structural contract (every
    # event has ph/ts/pid/tid) holds for them too
    return {"ph": "M", "ts": 0, "pid": pid, "tid": tid, "name": name,
            "args": {"name": value}}


def _x(pid: int, tid: int, name: str, ts: float, dur: float,
       **args: Any) -> dict:
    ev = {"ph": "X", "ts": round(float(ts), 3),
          "dur": round(max(float(dur), 0.001), 3),
          "pid": pid, "tid": tid, "name": name}
    if args:
        ev["args"] = args
    return ev


def _shard_phase_weights(shard, k: int) -> Tuple[float, float, float]:
    """Model 'seconds' (arbitrary units) of one iteration's halo /
    spmv / reduction phases on shard ``k``, from the static per-shard
    accounting: halo time ~ payload bytes, spmv time ~ live entries
    plus padding slots (padding multiplies like real work), reduction
    a small fixed cost.  Only RATIOS matter - the iteration slot is
    rescaled to measured wall time."""
    halo = float(shard.halo_send_bytes[k] + shard.halo_recv_bytes[k])
    spmv = float(shard.slots[k]) * 12.0   # ~bytes per slot (val+idx)
    red = 0.02 * float(shard.slots.max()) * 12.0 + 1.0
    return halo, spmv, red


def perfetto_trace(*, iterations: int, elapsed_s: float,
                   shard=None, n_shards: Optional[int] = None,
                   sections: Sequence[Tuple[str, float]] = (),
                   flight_history: Optional[np.ndarray] = None,
                   phase_profile=None,
                   request_spans: Sequence[dict] = (),
                   label: str = "solve") -> dict:
    """Build the Chrome-trace JSON dict (see module docstring).

    ``iterations``/``elapsed_s``: the measured solve.  ``shard``: a
    ``shardscope.ShardReport`` (its per-shard work sizes the modeled
    phase durations); without one, ``n_shards`` uniform tracks are
    drawn.  ``phase_profile``: a ``telemetry.phasetrace.PhaseProfile``
    (or its ``to_json()`` dict) - when given, the per-shard spans are
    the MEASURED per-phase walls and the metadata carries
    ``span_source: "measured"``; otherwise the static-schedule model
    renders them (``span_source: "modeled"``).  ``sections``: host
    ``Timer.sections``.  ``flight_history``: a ``(maxiter + 1,)``
    ||r|| array (``FlightRecord.to_history``) drawn as a counter
    track.  ``request_spans``: ``"span"`` event records from a traced
    serve replay (``telemetry.tracing.span_events``) - drawn as a
    fourth process ("requests"), one thread per trace with the request
    id as the thread name, so per-request causal chains sit on the
    same timeline as the solve phases.  Timestamps are microseconds
    (the trace-event convention).
    """
    prof = None
    if phase_profile is not None:
        prof = phase_profile.to_json() \
            if hasattr(phase_profile, "to_json") else dict(phase_profile)

    events: List[dict] = []
    events.append(_meta(_HOST_PID, 0, "process_name", "host"))
    events.append(_meta(_SHARD_PID, 0, "process_name",
                        f"shards ({label})"))

    # host timer sections, laid back-to-back (the Timer records
    # durations, not start stamps; ordering is the recording order)
    t = 0.0
    for name, sec in sections:
        dur = max(float(sec), 0.0) * 1e6
        events.append(_x(_HOST_PID, 0, name, t, dur))
        t += dur

    shards = shard.n_shards if shard is not None else (n_shards or 1)
    if prof is not None:
        shards = int(prof["n_shards"])
    its = max(int(iterations), 1)
    drawn = min(its, MAX_DRAWN_ITERATIONS)
    iter_us = max(float(elapsed_s), 1e-9) * 1e6 / its

    if prof is not None:
        iter_us = _measured_shard_tracks(events, prof, iter_us, drawn)
    else:
        _modeled_shard_tracks(events, shard, shards, iter_us, drawn)

    if request_spans:
        _request_tracks(events, request_spans)

    if flight_history is not None:
        hist = np.asarray(flight_history, dtype=np.float64).reshape(-1)
        events.append(_meta(_COUNTER_PID, 0, "process_name",
                            "residual (flight record)"))
        idx = np.nonzero(np.isfinite(hist))[0]
        for i in idx:
            # same truncation as the shard tracks: a 30k-iteration
            # dense history must not blow the documented size cap
            if i > drawn:
                break
            events.append({
                "ph": "C", "ts": round(float(i) * iter_us, 3),
                "pid": _COUNTER_PID, "tid": 0, "name": "log10_residual",
                "args": {"log10_residual":
                         float(np.log10(max(hist[i], 1e-300)))}})

    metadata = {
        "label": label,
        "iterations": int(iterations),
        "drawn_iterations": int(drawn),
        "elapsed_s": float(elapsed_s),
        "truncated": bool(its > drawn),
        # the structured successor of the old free-text "not a device
        # profile" note: every exported timeline says which renderer
        # produced its per-shard spans, and the trace validator
        # requires the field
        "span_source": "measured" if prof is not None else "modeled",
    }
    if prof is not None:
        metadata["explained_fraction"] = prof.get("explained_fraction")
        metadata["phase_exchange"] = prof.get("exchange")
    if request_spans:
        metadata["n_request_traces"] = len(
            {s.get("trace_id") for s in request_spans
             if isinstance(s, dict) and s.get("trace_id")})
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": metadata,
    }
    return sanitize(trace)


def _modeled_shard_tracks(events, shard, shards: int, iter_us: float,
                          drawn: int) -> None:
    """The static-schedule fallback renderer: per-shard durations
    proportional to accounted work, iteration slot scaled to the
    measured per-iteration wall."""
    weights = []
    for k in range(shards):
        if shard is not None:
            weights.append(_shard_phase_weights(shard, k))
        else:
            weights.append((1.0, 8.0, 1.0))
    totals = [sum(w) for w in weights]
    scale = iter_us / max(max(totals), 1e-30)

    for k in range(shards):
        events.append(_meta(_SHARD_PID, k, "thread_name", f"shard {k}"))
        halo_us, spmv_us, red_us = (w * scale for w in weights[k])
        for i in range(drawn):
            base = i * iter_us
            ts = base
            if halo_us > 0:
                events.append(_x(_SHARD_PID, k, "halo", ts, halo_us,
                                 iteration=i))
                ts += halo_us
            events.append(_x(_SHARD_PID, k, "spmv", ts, spmv_us,
                             iteration=i))
            ts += spmv_us
            # the psum barrier: every shard's iteration ends together,
            # so a balanced shard's "reduction" includes its wait on
            # the straggler - that wedge IS the imbalance cost
            events.append(_x(_SHARD_PID, k, "reduction", ts,
                             max(base + iter_us - ts, red_us),
                             iteration=i))


def _measured_shard_tracks(events, prof: dict, iter_us: float,
                           drawn: int) -> float:
    """The measured renderer: spans are the phase profiler's walls.
    Each shard's iteration draws halo (whole-mesh wall), its own
    measured SpMV seconds, and the reduction barriers; time the spans
    do not cover is left as a visible gap - unexplained iteration cost
    is a gap, never a stretched span.  Returns the iteration slot
    actually used (grown if the measured spans exceed the solve's
    per-iteration wall, so track timestamps stay monotone)."""
    ph = prof.get("phases") or {}
    reds = int(prof.get("reductions_per_iteration", 2))
    halo_us = float(ph.get("halo_s", 0.0)) * 1e6
    red_us = float(ph.get("reduction_s", 0.0)) * 1e6 * reds
    spmv_us = [float(v) * 1e6 for v in prof.get("spmv_s") or ()]
    n = int(prof["n_shards"])
    if len(spmv_us) < n:
        spmv_us += [0.0] * (n - len(spmv_us))
    span_max = max(halo_us + s + red_us for s in spmv_us)
    slot = max(iter_us, span_max)
    for k in range(n):
        events.append(_meta(_SHARD_PID, k, "thread_name", f"shard {k}"))
        for i in range(drawn):
            ts = i * slot
            if halo_us > 0:
                events.append(_x(_SHARD_PID, k, "halo", ts, halo_us,
                                 iteration=i, span_source="measured"))
                ts += halo_us
            events.append(_x(_SHARD_PID, k, "spmv", ts, spmv_us[k],
                             iteration=i, span_source="measured"))
            ts += spmv_us[k]
            if red_us > 0:
                events.append(_x(_SHARD_PID, k, "reduction", ts,
                                 red_us, iteration=i,
                                 span_source="measured"))
    return slot


def _request_tracks(events, request_spans: Sequence[dict]) -> None:
    """The per-request track family: one thread per trace_id under the
    "requests" process, every span an X event.  Span timestamps are
    service-clock seconds; they are rebased to the earliest span so
    the family starts at t=0 like the solve tracks, and emitted in
    (ts, dur) order per track to satisfy ``validate_perfetto``'s
    monotonicity contract."""
    spans = [s for s in request_spans
             if isinstance(s, dict) and s.get("trace_id")]
    if not spans:
        return
    events.append(_meta(_REQUEST_PID, 0, "process_name", "requests"))
    t0 = min(float(s.get("start_s", 0.0)) for s in spans)
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(str(s["trace_id"]), []).append(s)
    for tid, (trace_id, group) in enumerate(sorted(by_trace.items())):
        rid = next((s.get("request_id") for s in group
                    if s.get("request_id")), trace_id[:8])
        events.append(_meta(_REQUEST_PID, tid, "thread_name", str(rid)))
        group.sort(key=lambda s: (float(s.get("start_s", 0.0)),
                                  float(s.get("duration_s", 0.0))))
        for s in group:
            args = {"trace_id": trace_id,
                    "span_id": s.get("span_id")}
            for key in ("status", "decision", "solve_id", "attempt",
                        "reason", "tenant", "slo_class"):
                if s.get(key) is not None:
                    args[key] = s[key]
            events.append(_x(
                _REQUEST_PID, tid, str(s.get("name", "span")),
                (float(s.get("start_s", 0.0)) - t0) * 1e6,
                float(s.get("duration_s", 0.0)) * 1e6, **args))


def write_perfetto(path: str, trace: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f, allow_nan=False)


def validate_perfetto(trace) -> dict:
    """Structural contract of an exported timeline; returns the trace.

    Raises ``ValueError`` unless: ``traceEvents`` is a non-empty list
    (a bare top-level list is also accepted - Chrome does); every
    event carries ``ph``/``ts``/``pid``/``tid``; per ``(pid, tid)``
    track the non-metadata timestamps are monotone non-decreasing; and
    at least one complete (``ph == "X"``) event exists.
    """
    if isinstance(trace, list):
        events = trace
    elif isinstance(trace, dict):
        events = trace.get("traceEvents")
    else:
        raise ValueError(f"perfetto trace must be an object or array, "
                         f"got {type(trace).__name__}")
    if not isinstance(events, list) or not events:
        raise ValueError("perfetto trace has no traceEvents array (or "
                         "it is empty)")
    tracks: Dict[Tuple[Any, Any], float] = {}
    saw_complete = False
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for field in ("ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(
                    f"traceEvents[{i}] missing required key {field!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"traceEvents[{i}] ts is not numeric")
        if ev["ph"] == "M":
            continue
        if ev["ph"] == "X":
            saw_complete = True
            if "dur" not in ev or not isinstance(ev["dur"], (int, float)):
                raise ValueError(
                    f"traceEvents[{i}] complete event missing numeric "
                    f"'dur'")
        key = (ev["pid"], ev["tid"])
        prev = tracks.get(key)
        if prev is not None and ev["ts"] < prev:
            raise ValueError(
                f"traceEvents[{i}] timestamp {ev['ts']} goes backwards "
                f"on track pid={ev['pid']} tid={ev['tid']} (prev "
                f"{prev})")
        tracks[key] = ev["ts"]
    if not saw_complete:
        raise ValueError("perfetto trace contains no complete (ph='X') "
                         "events")
    return trace
