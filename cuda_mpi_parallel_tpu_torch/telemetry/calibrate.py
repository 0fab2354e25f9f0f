"""calibra: the runtime-measured machine model and drift tracker.

Counterpart of the JAX package's ``telemetry/calibrate.py``: the same
observations, fits, drift reports and cache entries.  The one
difference is the backend name a fit and its cache key carry: the
port names it from the device, ``"cuda"`` or ``"cpu"`` (``None``
follows the device rule: the card), as ``roofline.machine_model``
does.  On the CPU both packages then write and read one key,
``calibration-cpu-<host>``, in one ``utils.tune.JsonCache`` directory,
so a fit stored by either loads in the other.

The partition planner (``balance.plan``) and the roofline price every
decision with a *fixed reference* machine model - the gather slowdown
is a conservative table guess, net bandwidth is a table entry, and
nothing ever records how wrong those guesses were.  Production
workloads (time-stepping, a solver service) solve the same
operator hundreds of times, and SpMV throughput is ultimately
sustained-stream bandwidth (arxiv 2204.00900) - so the model fitted
from the *first* solve's measured wall time should steer every later
solve.  This module closes that loop in three layers:

* **Measurement** - :func:`observation_for` turns one observed solve
  (its measured ``(iterations, elapsed_s)`` plus the static per-shard
  accounting the partition already produced) into a
  :class:`PhaseObservation`; :func:`fit_machine_model` least-squares
  fits the free parameters of the planner's own cost model - an
  effective gather bandwidth (reported as a measured
  ``gather_slowdown`` replacing the hardcoded table 8.0) and net
  bytes/s - with explicit fit residuals and a ``confident`` flag that
  stays False when iterations are too few or the fit had to fall back.
* **Drift as a first-class metric** - :func:`drift_report` compares
  the model-predicted per-iteration stall seconds
  (``balance.plan.score_report``, the SAME terms that chose the plan)
  against the measured per-iteration time; :func:`note_drift` exports
  the error % as registry gauges and an extended ``partition_plan``
  event, so model error is itself tracked across runs.
* **Persistence** - calibrated models live in the measured-artifact
  disk cache next to the autotuner (``utils.tune.JsonCache``), keyed
  by backend + host fingerprint with a staleness bound;
  :func:`preferred_model` is the one-line lookup the replan loop
  (``parallel.dist_cg.resolve_plan`` / ``solve_sequence``) uses to
  prefer a calibrated model when a fresh, confident one exists.

The fit deliberately does NOT try to separate gather slowdown from
streaming bandwidth inside one total - they are not identifiable from
a single wall time.  Streaming bandwidth comes from the base machine
model (the roofline table, or the CPU triad self-benchmark); the solve
fits the *effective gather bandwidth* and the measured slowdown is
their ratio.  Everything here is host arithmetic on already-synced
scalars: calibration can never touch a compiled solve (the
zero-perturbation test in tests/test_torch_calibrate.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from .roofline import MachineModel, machine_model

__all__ = [
    "CALIBRATION_MAX_AGE_S",
    "CalibrationFit",
    "DriftReport",
    "MIN_CALIBRATION_ITERATIONS",
    "PhaseObservation",
    "cache_key",
    "drift_report",
    "fit_link_bandwidths",
    "fit_machine_model",
    "load_calibration",
    "note_calibration",
    "note_drift",
    "observation_for",
    "observations_from_profile",
    "preferred_model",
    "store_calibration",
]

#: below this many total observed iterations the fit is never marked
#: confident: a 3-iteration oracle solve is all dispatch overhead, not
#: bandwidth
MIN_CALIBRATION_ITERATIONS = 8

#: a fit whose max relative residual exceeds this is not confident -
#: the model family does not explain the observations (noise, or a
#: phase the cost model does not price)
CONFIDENT_RESIDUAL = 0.25

#: disk-cached calibrations older than this are ignored by
#: :func:`preferred_model` (same week bound as the roofline CPU model)
CALIBRATION_MAX_AGE_S = 7 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class PhaseObservation:
    """One observed solve, reduced to the cost model's coordinates.

    ``gather_bytes_per_iteration`` is the padded slot work the model's
    memory term prices (``slots_max * (itemsize + 4)``);
    ``net_bytes_per_iteration`` the wire-priced bytes of the exchange
    lane that actually ran (fixed x-rotation payload, or the packed
    coupled-entry rounds - ``balance.plan.wire_bytes_for``) - both
    computed by :func:`observation_for` from a ``ShardReport`` so
    predicted and measured always price the same terms.
    """

    iterations: int
    elapsed_s: float
    gather_bytes_per_iteration: float
    net_bytes_per_iteration: float
    label: str = ""

    def __post_init__(self):
        if self.iterations < 1:
            raise ValueError(
                f"observation needs >= 1 iteration, got {self.iterations}")
        if self.elapsed_s <= 0.0:
            raise ValueError(
                f"observation needs elapsed_s > 0, got {self.elapsed_s}")

    @property
    def s_per_iteration(self) -> float:
        return self.elapsed_s / self.iterations

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def observation_for(report, iterations: int, elapsed_s: float, *,
                    itemsize: int,
                    comm_bytes_per_iteration: Optional[float] = None,
                    exchange: str = "allgather",
                    label: str = "") -> PhaseObservation:
    """Build the observation for one solve from its static accounting.

    ``report`` is the coupling-semantics ``ShardReport`` of the layout
    that ran (``shardscope.report_for_ranges`` / the plan's predicted
    report) - the same report ``balance.plan.score_report`` prices, so
    the fit corrects exactly the model that planned.  ``exchange``
    names the halo wire the solve ran; its per-iteration bytes come
    from ``balance.plan.wire_bytes_for`` (the planner's own term -
    fixed payload for allgather/ring, the full-weight packed coupled
    rounds for gather; the historical 0.25 coupling fudge is gone on
    both sides at once, so predicted and measured stay one model).
    When the recorded per-iteration wire is known
    (``dist_cg.last_comm_cost``), pass it as
    ``comm_bytes_per_iteration`` to replace the analytic term.
    """
    from ..balance.plan import wire_bytes_for

    gather = float(report.slots.max()) * (itemsize + 4)
    if comm_bytes_per_iteration is not None:
        net = float(comm_bytes_per_iteration)
    else:
        net = wire_bytes_for(report, exchange, itemsize)
    return PhaseObservation(
        iterations=int(iterations), elapsed_s=float(elapsed_s),
        gather_bytes_per_iteration=gather,
        net_bytes_per_iteration=net, label=label)


def observations_from_profile(profile, *, label: str = "phase"
                              ) -> List[PhaseObservation]:
    """Phase-resolved observations from ONE measured phase profile
    (``telemetry.phasetrace.PhaseProfile``) - the constructor that
    makes the ``lstsq2`` confident tier routine without ``--repeat``.

    A whole-solve wall time collapses the gather and wire terms into
    one number, so a single solve could historically only reach the
    degraded ``fixed-net`` tier.  A phase profile measured the two
    terms SEPARATELY, so it decomposes into two observations whose
    byte ratios are orthogonal by construction:

    * the SpMV phase (the mesh-measured phase wall, priced at the
      planner's ``slots.max()`` slot coordinate - the same
      wall-per-coordinate convention the whole-solve fit uses) with
      zero wire bytes - determines the effective gather bandwidth;
    * the halo phase (every exchange round, the lane's real padded
      wire bytes) with zero gather bytes - determines net bytes/s.

    Each observation carries ``iterations=profile.repeats`` (the
    measured repetitions), so the fit's iteration floor
    (:data:`MIN_CALIBRATION_ITERATIONS`) is met by any profile with
    ``repeats >= 4``.  The reduction phase is deliberately dropped:
    the planner's cost model has no latency term, and folding barrier
    time into a bandwidth would corrupt both estimates.
    """
    reps = int(profile.repeats)
    spmv_s = float(profile.spmv_mesh_s)
    obs = [PhaseObservation(
        iterations=reps, elapsed_s=spmv_s * reps,
        gather_bytes_per_iteration=float(profile.gather_bytes),
        net_bytes_per_iteration=0.0, label=f"{label}:spmv")]
    if profile.halo_s > 0.0 and profile.wire_bytes > 0:
        obs.append(PhaseObservation(
            iterations=reps, elapsed_s=float(profile.halo_s) * reps,
            gather_bytes_per_iteration=0.0,
            net_bytes_per_iteration=float(profile.wire_bytes),
            label=f"{label}:halo"))
    return obs


def fit_link_bandwidths(rounds) -> List[dict]:
    """Per-link bandwidth estimates from individually timed exchange
    rounds: ``rounds`` is an iterable of ``(shift, bytes, seconds)``
    (or dicts with those keys) - one entry per ``ppermute`` round, as
    ``telemetry.phasetrace`` measures them.  Each round is one ring
    rotation (shard ``j`` -> ``(j + shift) % P``), timed alone, so its
    bandwidth is directly ``bytes / seconds`` - exact recovery, no
    least squares (tests feed synthetic timings and get the chosen
    bandwidths back bit-exactly).  Links only separate when round
    payloads differ; uniform payloads still yield honest (equal)
    estimates."""
    out = []
    for r in rounds:
        if isinstance(r, dict):
            shift, nbytes, secs = r["shift"], r["bytes"], r["seconds"]
        else:
            shift, nbytes, secs = r
        out.append({
            "shift": int(shift),
            "bytes": int(nbytes),
            "seconds": float(secs),
            "bytes_per_s": float(nbytes) / max(float(secs), 1e-300),
        })
    return out


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """Outcome of fitting the machine model to observed solves."""

    model: MachineModel
    method: str            # "lstsq2" | "fixed-net" | "proportional"
    residual_rel: float    # max relative per-observation fit error
    n_observations: int
    total_iterations: int
    confident: bool
    backend: str
    host: str

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["model"] = self.model.to_json()
        return out

    @classmethod
    def from_json(cls, data: dict) -> "CalibrationFit":
        if not isinstance(data, dict):
            raise TypeError(
                f"calibration JSON must be an object, got "
                f"{type(data).__name__}")
        return cls(
            model=MachineModel.from_json(data["model"]),
            method=str(data.get("method", "?")),
            residual_rel=float(data.get("residual_rel", float("nan"))),
            n_observations=int(data.get("n_observations", 0)),
            total_iterations=int(data.get("total_iterations", 0)),
            confident=bool(data.get("confident", False)),
            backend=str(data.get("backend", "?")),
            host=str(data.get("host", "?")),
        )

    def describe(self) -> str:
        m = self.model
        net = m.net_bytes_per_s or 0.0
        return (f"{m.name}: gather x{m.gather_slowdown:.2f} slowdown "
                f"(eff {m.mem_bytes_per_s / m.gather_slowdown / 1e9:.2f} "
                f"GB/s of {m.mem_bytes_per_s / 1e9:.2f} stream), net "
                f"{net / 1e9:.2f} GB/s; fit {self.method}, residual "
                f"{self.residual_rel * 100:.1f}%, "
                f"{'confident' if self.confident else 'LOW CONFIDENCE'} "
                f"({self.n_observations} obs, "
                f"{self.total_iterations} iters)")


def _solve_2x2(a, b, y):
    """Least-squares ``y ~ a*u + b*v`` via the normal equations;
    returns ``(u, v)`` or ``None`` when the design is (near) rank
    deficient - one observation, or observations whose gather/net byte
    ratios are indistinguishable."""
    g = np.array([[float(a @ a), float(a @ b)],
                  [float(a @ b), float(b @ b)]])
    rhs = np.array([float(a @ y), float(b @ y)])
    det = g[0, 0] * g[1, 1] - g[0, 1] * g[1, 0]
    if det <= 1e-12 * max(g[0, 0] * g[1, 1], 1e-300):
        return None
    u, v = np.linalg.solve(g, rhs)
    return float(u), float(v)


def fit_machine_model(observations: Sequence[PhaseObservation], *,
                      base: Optional[MachineModel] = None,
                      backend: Optional[str] = None,
                      per_link=None) -> CalibrationFit:
    """Fit the planner's cost model to observed per-iteration times.

    Model: ``t_iter = gather_bytes / gather_bw + net_bytes / net_bw``
    with unknown effective bandwidths.  Strategy, most to least
    determined:

    1. **lstsq2** - >= 2 observations with distinct byte ratios: both
       bandwidths from the 2x2 normal equations;
    2. **fixed-net** - the net term is pinned at the base model's
       bandwidth and only the gather bandwidth is fitted (the only
       honest option for a single observation);
    3. **proportional** - if a fitted bandwidth came out non-positive
       (the model family cannot explain the data), both reference
       bandwidths are scaled by measured/modeled total time; never
       marked confident.

    The returned model keeps the base model's streaming
    ``mem_bytes_per_s`` and ``flops_per_s`` (a CG solve cannot measure
    a matmul) and reports ``gather_slowdown = stream_bw / gather_bw``.

    ``per_link`` optionally attaches per-link wire bandwidths (the
    :func:`fit_link_bandwidths` output, or raw ``(shift, bytes/s)``
    pairs) to the fitted model's ``per_link`` field - they ride the
    calibration cache and every ``drift_report``/``solve_sequence``
    replan that adopts the model, without changing the aggregate
    ``net_bytes_per_s`` the planner prices today (two-tier wire
    pricing is a later consumer).
    """
    obs = list(observations)
    if not obs:
        raise ValueError("fit_machine_model needs >= 1 observation")
    backend = _backend_name(backend)
    if base is None:
        base = machine_model(backend)
    base_net = float(base.net_bytes_per_s or base.mem_bytes_per_s)

    a = np.array([o.gather_bytes_per_iteration for o in obs],
                 dtype=np.float64)
    b = np.array([o.net_bytes_per_iteration for o in obs],
                 dtype=np.float64)
    y = np.array([o.s_per_iteration for o in obs], dtype=np.float64)
    total_iters = int(sum(o.iterations for o in obs))

    method = None
    u = v = None                      # u = 1/gather_bw, v = 1/net_bw
    if len(obs) >= 2:
        sol = _solve_2x2(a, b, y)
        if sol is not None and sol[0] > 0.0 and sol[1] > 0.0:
            u, v = sol
            method = "lstsq2"
    if method is None:
        # pin the net term at the base model and fit the gather term
        v_fixed = 1.0 / base_net
        resid = y - b * v_fixed
        denom = float(a @ a)
        u_fit = float(a @ resid) / denom if denom > 0.0 else -1.0
        if u_fit > 0.0:
            u, v = u_fit, v_fixed
            method = "fixed-net"
    if method is None:
        # proportional fallback: scale the whole reference model by the
        # measured/modeled time ratio (the model family cannot separate
        # the terms for this data) - never confident
        ref_gather_bw = base.mem_bytes_per_s / max(
            base.gather_slowdown, 1e-9)
        t_model = a / ref_gather_bw + b / base_net
        factor = float(np.mean(y / np.maximum(t_model, 1e-300)))
        factor = max(factor, 1e-9)
        u = factor / ref_gather_bw
        v = factor / base_net
        method = "proportional"

    gather_bw = 1.0 / u
    net_bw = 1.0 / v
    pred = a * u + b * v
    residual = float(np.max(np.abs(pred - y) / np.maximum(y, 1e-300)))

    from ..utils.tune import host_fingerprint

    host = host_fingerprint()
    gather_slowdown = max(base.mem_bytes_per_s / gather_bw, 1e-3)
    links = None
    if per_link:
        links = tuple(
            (int(e["shift"]), float(e["bytes_per_s"]))
            if isinstance(e, dict) else (int(e[0]), float(e[1]))
            for e in per_link)
    model = MachineModel(
        name=f"calibrated-{backend}-{host}",
        mem_bytes_per_s=base.mem_bytes_per_s,
        flops_per_s=base.flops_per_s,
        net_bytes_per_s=net_bw,
        source="calibrated",
        gather_slowdown=gather_slowdown,
        created_at=time.time(),
        per_link=links)
    confident = (method != "proportional"
                 and total_iters >= MIN_CALIBRATION_ITERATIONS
                 and residual <= CONFIDENT_RESIDUAL)
    return CalibrationFit(
        model=model, method=method, residual_rel=residual,
        n_observations=len(obs), total_iterations=total_iters,
        confident=confident, backend=backend, host=host)


# ---------------------------------------------------------------------------
# persistence (the measured-artifact disk cache, utils.tune.JsonCache)

def _backend_name(backend=None) -> str:
    """The backend a fit and its cache key are named by: a device, or
    its name, reduced to its type (``"cuda:1"`` -> ``"cuda"``; any other
    name as given); ``None`` follows the device rule - the card."""
    if backend is None:
        return "cuda"
    return str(backend).split(":", 1)[0]


def cache_key(backend: Optional[str] = None,
              host: Optional[str] = None) -> str:
    from ..utils.tune import host_fingerprint

    return f"calibration-{_backend_name(backend)}-" \
        f"{host or host_fingerprint()}"


def store_calibration(fit: CalibrationFit, cache=None) -> Optional[str]:
    """Persist a fit for :func:`load_calibration`/:func:`preferred_model`
    (best-effort: an unwritable cache directory returns ``None`` rather
    than failing the solve that produced the fit)."""
    from ..utils.tune import JsonCache

    if cache is None:
        cache = JsonCache()
    try:
        return cache.put(cache_key(fit.backend, fit.host), fit.to_json(),
                         created_at=fit.model.created_at)
    except (OSError, ValueError):
        return None


def load_calibration(backend: Optional[str] = None, cache=None,
                     max_age_s: float = CALIBRATION_MAX_AGE_S
                     ) -> Optional[CalibrationFit]:
    """The stored fit for ``backend`` on this host, or ``None`` when
    missing, stale, or unparseable."""
    from ..utils.tune import JsonCache

    if cache is None:
        cache = JsonCache()
    entry = cache.get(cache_key(backend), max_age_s=max_age_s)
    if entry is None:
        return None
    try:
        return CalibrationFit.from_json(entry["payload"])
    except (KeyError, TypeError, ValueError):
        return None


def preferred_model(backend: Optional[str] = None, cache=None
                    ) -> Optional[MachineModel]:
    """The calibrated model a planner should prefer, or ``None``.

    Only a fresh AND confident stored fit qualifies - an unconfident
    fit must never silently steer plans (the reference model is the
    safe default).  ``None`` keeps ``plan_partition`` on the
    deterministic reference table, so with no calibration on disk the
    planning path is bit-identical to pre-calibration behavior.
    """
    fit = load_calibration(backend, cache)
    if fit is None or not fit.confident:
        return None
    return fit.model


# ---------------------------------------------------------------------------
# drift: predicted-vs-measured model error, tracked per solve

@dataclasses.dataclass(frozen=True)
class DriftReport:
    """How wrong the machine model was about one solve."""

    predicted_s_per_iteration: float
    measured_s_per_iteration: float
    drift_pct: float               # 100 * (measured - predicted) / predicted
    model: str                     # name of the model that predicted
    plan: str                      # layout lane ("even", "rcm+nnz", ...)
    fingerprint: Optional[str] = None
    iterations: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        return (f"model error {self.drift_pct:+.1f}% "
                f"(predicted {self.predicted_s_per_iteration * 1e6:.3g} "
                f"us/iter vs measured "
                f"{self.measured_s_per_iteration * 1e6:.3g} on "
                f"{self.model})")


def drift_report(report, iterations: int, elapsed_s: float, *,
                 itemsize: int, model: Optional[MachineModel] = None,
                 plan=None, exchange: Optional[str] = None
                 ) -> DriftReport:
    """Predicted-vs-measured stall-time drift for one solve.

    ``report``/``itemsize`` describe the layout that ran (coupling
    semantics); ``model`` is the machine model that PRICED it (the one
    that chose the plan - reference unless a calibrated model was
    passed), so drift measures that model's error, not the best
    possible model's.  ``exchange`` names the halo wire the solve ran
    (default: the plan's scored lane, or allgather) - the drift
    contract extends to the wire: prediction prices the same exchange
    that moved the bytes."""
    from ..balance.plan import score_report

    if exchange is None:
        exchange = getattr(plan, "exchange", "allgather") \
            if plan is not None else "allgather"
    predicted = score_report(report, itemsize=itemsize, model=model,
                             exchange=exchange)
    measured = float(elapsed_s) / max(int(iterations), 1)
    drift = 100.0 * (measured - predicted) / max(predicted, 1e-300)
    if model is None:
        from ..balance.plan import reference_model

        model = reference_model()
    return DriftReport(
        predicted_s_per_iteration=predicted,
        measured_s_per_iteration=measured,
        drift_pct=drift, model=str(model.name),
        plan=(plan.label if plan is not None else "even"),
        fingerprint=(plan.fingerprint() if plan is not None else None),
        iterations=int(iterations))


def note_drift(drift: DriftReport, *, report=None,
               plan=None, n_shards: Optional[int] = None) -> DriftReport:
    """Publish a drift measurement: registry gauges always, plus (when
    an event sink is active) the EXTENDED ``partition_plan`` event -
    the partition-time event's required fields re-stated with the
    post-solve ``drift_pct``/predicted/measured stall seconds attached
    and ``stage="drift"`` so consumers can tell the two apart."""
    from .. import telemetry
    from .registry import REGISTRY

    REGISTRY.gauge(
        "plan_drift_pct",
        "predicted-vs-measured per-iteration stall-time model error %"
        " of the most recent solve",
        labelnames=("plan",)).set(drift.drift_pct, plan=drift.plan)
    REGISTRY.gauge(
        "plan_predicted_s_per_iteration",
        "modeled per-iteration stall seconds of the layout that ran",
        labelnames=("plan",)).set(drift.predicted_s_per_iteration,
                                  plan=drift.plan)
    REGISTRY.gauge(
        "plan_measured_s_per_iteration",
        "measured per-iteration wall seconds of the layout that ran",
        labelnames=("plan",)).set(drift.measured_s_per_iteration,
                                  plan=drift.plan)
    if telemetry.events.active():
        reorder, split = "none", "even"
        exchange = "allgather"
        if plan is not None:
            reorder, split = plan.reorder, plan.split
            exchange = getattr(plan, "exchange", "allgather")
        shards = n_shards
        if shards is None:
            shards = (plan.n_shards if plan is not None
                      else (report.n_shards if report is not None else 0))
        measured_imb = (report.imbalance() if report is not None
                        else None)
        telemetry.events.emit(
            "partition_plan", stage="drift", reorder=reorder,
            split=split, exchange=exchange, n_shards=int(shards),
            measured=measured_imb,
            drift_pct=drift.drift_pct,
            predicted_s_per_iteration=drift.predicted_s_per_iteration,
            measured_s_per_iteration=drift.measured_s_per_iteration,
            model=drift.model,
            **({"fingerprint": drift.fingerprint}
               if drift.fingerprint else {}))
    return drift


def note_calibration(fit: CalibrationFit) -> CalibrationFit:
    """Export a fit's parameters as registry gauges (labeled by
    backend), so calibration itself is observable across runs."""
    from .registry import REGISTRY

    m = fit.model
    for gname, help_, val in (
            ("calibration_gather_slowdown",
             "measured sparse-gather slowdown vs streaming bandwidth",
             m.gather_slowdown),
            ("calibration_mem_bytes_per_s",
             "streaming memory bandwidth of the calibrated model",
             m.mem_bytes_per_s),
            ("calibration_net_bytes_per_s",
             "network bandwidth of the calibrated model",
             m.net_bytes_per_s or 0.0),
            ("calibration_residual_rel",
             "max relative fit residual of the calibrated model",
             fit.residual_rel),
            ("calibration_confident",
             "1 when the stored calibration is confident enough to "
             "steer plans", 1.0 if fit.confident else 0.0)):
        REGISTRY.gauge(gname, help_, labelnames=("backend",)).set(
            val, backend=fit.backend)
    for shift, bps in (m.per_link or ()):
        REGISTRY.gauge(
            "calibration_link_bytes_per_s",
            "measured per-link halo-wire bandwidth (phase profiler; "
            "ring-rotation shift identifies the link)",
            labelnames=("backend", "shift")).set(
                bps, backend=fit.backend, shift=str(shift))
    return fit
