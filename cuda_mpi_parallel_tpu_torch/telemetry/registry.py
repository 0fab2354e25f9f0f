"""Process-wide metrics registry: counters, gauges, histograms.

The port's copy of the JAX package's ``telemetry/registry.py`` (pure
Python, so the two are the same code; the port imports nothing of the
JAX package).  A deliberately small, dependency-free subset of the
Prometheus client model - enough for the north star ("serves heavy
traffic") without pulling a client library the container does not ship.
Metrics are host-side Python state only: incrementing a counter never
touches a device value, so instrumentation can never force a sync into
a solve.

Exposition formats:

* ``REGISTRY.snapshot()`` - a JSON-serializable dict;
* ``REGISTRY.to_prometheus()`` - the Prometheus text format, one
  ``name{labels} value`` line per child, for scrape endpoints.

Thread-safe: one process-wide lock guards child creation and updates
(solves may be issued from serving threads).
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MAX_LABEL_SETS",
           "MetricsRegistry", "PERCENTILES", "REGISTRY",
           "quantile_from_buckets"]

#: default histogram buckets (seconds-flavored, matching solve times
#: from sub-ms resident kernels to multi-minute 256^3 streaming runs)
DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.5, 10.0, 60.0, 300.0)

#: the percentile readout every histogram exposes (JSON ``percentiles``
#: and ``{name}_p50/_p95/_p99`` Prometheus gauges) - the latency
#: summary the solver service's SLO reporting consumes
PERCENTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

#: per-metric label-cardinality cap.  Per-tenant labels made series
#: count caller-controlled: an adversarial (or merely enthusiastic)
#: tenant id stream must not grow exposition without bound.  Once a
#: metric holds this many DISTINCT label sets, updates for new sets
#: collapse into one ``__other__`` bucket (every label position set to
#: ``"__other__"``) and the metric's overflow counter increments -
#: aggregate mass is preserved, per-series attribution is dropped,
#: memory stays bounded.  Existing series keep updating normally.
#: Read at update time (not bound at construction) so tests can
#: monkeypatch a tiny cap.
MAX_LABEL_SETS = 256


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> Tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[name]) for name in labelnames)


def _format_labels(labelnames: Sequence[str], key: Tuple,
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(zip(labelnames, key))
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    # Exposition-format label escaping: backslash FIRST (later rules
    # insert backslashes), then double-quote and newline - the three
    # characters the Prometheus text format requires escaped inside
    # label values.  An unescaped newline splits the sample line in
    # two and poisons the whole scrape.
    body = ",".join(
        '{}="{}"'.format(
            n,
            str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))
        for n, v in pairs)
    return "{" + body + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (), *, lock=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock if lock is not None else threading.Lock()
        self._children: Dict[Tuple, float] = {}
        self._label_overflow = 0

    def _bounded_key(self, key: Tuple) -> Tuple:
        """Route a NEW label set past ``MAX_LABEL_SETS`` into the
        ``__other__`` bucket (lock held).  Known sets and unlabeled
        metrics pass through untouched; the overflow bucket itself is
        not counted against the cap."""
        if not self.labelnames or key in self._children:
            return key
        other = ("__other__",) * len(self.labelnames)
        distinct = len(self._children) - (other in self._children)
        if distinct >= MAX_LABEL_SETS:
            self._label_overflow += 1
            return other
        return key

    @property
    def label_overflow(self) -> int:
        """How many updates landed in ``__other__`` because the metric
        was at its label-cardinality cap."""
        with self._lock:
            return self._label_overflow

    def _update(self, labels: Dict[str, str], fn) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            key = self._bounded_key(key)
            self._children[key] = fn(self._children.get(key))

    def value(self, **labels: str) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._children.get(key, 0.0)

    def snapshot(self):
        with self._lock:
            return [
                {"labels": dict(zip(self.labelnames, key)), "value": val}
                for key, val in sorted(self._children.items())
            ]

    def _overflow_lines(self) -> List[str]:
        """The ``{name}_label_overflow`` companion counter (emitted
        only once the cap engaged - a quiet metric stays quiet)."""
        with self._lock:
            n = self._label_overflow
        if n <= 0:
            return []
        return [f"# TYPE {self.name}_label_overflow counter",
                f"{self.name}_label_overflow {n}"]

    def prometheus_lines(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            for key, val in sorted(self._children.items()):
                lines.append(
                    f"{self.name}{_format_labels(self.labelnames, key)} "
                    f"{_format_value(val)}")
        lines.extend(self._overflow_lines())
        return lines


def _format_value(v: float) -> str:
    # Prometheus text format supports the NaN/+Inf/-Inf literals; a
    # non-finite observation must render, not poison every later scrape
    # (int(nan) raises).
    if math.isnan(v):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    as_int = int(v)
    return str(as_int) if v == as_int else repr(float(v))


class Counter(_Metric):
    """Monotonically increasing count (resets only with the process)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (amount={amount})")
        self._update(labels, lambda old: (old or 0.0) + amount)


class Gauge(_Metric):
    """A value that can go up and down (or be set outright)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        self._update(labels, lambda old: float(value))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        self._update(labels, lambda old: (old or 0.0) + amount)

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)


def quantile_from_buckets(bounds: Sequence[float],
                          cumulative_counts: Sequence[float],
                          total: float, q: float) -> Optional[float]:
    """``histogram_quantile`` semantics over cumulative bucket counts:
    find the bucket the q-th observation landed in and interpolate
    linearly inside it (lower bound of the first bucket is 0).
    Observations past the last finite bound clamp to that bound - the
    honest answer a bucketed histogram can give.  ``None`` when
    nothing was observed.

    THE one quantile definition: :class:`Histogram` readouts and the
    fleet-merge aggregation (``telemetry.fleet``) both call this, so a
    merged histogram's p99 is exactly the p99 this registry would
    report for the union stream.
    """
    if total <= 0:
        return None
    target = q * total
    prev = 0.0
    for i, bound in enumerate(bounds):
        if cumulative_counts[i] >= target:
            lower = 0.0 if i == 0 else bounds[i - 1]
            within = cumulative_counts[i] - prev
            if within <= 0:
                return bound
            return lower + (bound - lower) * (target - prev) / within
        prev = cumulative_counts[i]
    return bounds[-1]


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; ``+Inf`` is implicit)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS, *, lock=None):
        super().__init__(name, help, labelnames, lock=lock)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds
        # children: key -> [bucket_counts..., count, sum]
        self._children: Dict[Tuple, List[float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(self.labelnames, labels)
        value = float(value)
        with self._lock:
            key = self._bounded_key(key)
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = \
                    [0.0] * (len(self.buckets) + 2)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child[i] += 1
            child[-2] += 1
            child[-1] += value

    def value(self, **labels: str):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                return {"count": 0, "sum": 0.0}
            return {"count": int(child[-2]), "sum": child[-1]}

    def _quantile_locked(self, child, q: float) -> Optional[float]:
        return quantile_from_buckets(self.buckets, child[:-2],
                                     child[-2], q)

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """The q-th latency quantile (0 < q < 1) of one child, derived
        from the cumulative buckets; ``None`` when nothing was
        observed.  Used by the solver service's p50/p95/p99 readout."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                return None
            return self._quantile_locked(child, q)

    def snapshot(self):
        with self._lock:
            out = []
            for key, child in sorted(self._children.items()):
                out.append({
                    "labels": dict(zip(self.labelnames, key)),
                    "buckets": {
                        _format_value(b): int(child[i])
                        for i, b in enumerate(self.buckets)},
                    "count": int(child[-2]),
                    "sum": child[-1],
                    "percentiles": {
                        name: self._quantile_locked(child, q)
                        for name, q in PERCENTILES},
                })
            return out

    def prometheus_lines(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        with self._lock:
            for key, child in sorted(self._children.items()):
                for i, bound in enumerate(self.buckets):
                    lab = _format_labels(self.labelnames, key,
                                         ("le", _format_value(bound)))
                    lines.append(f"{self.name}_bucket{lab} {int(child[i])}")
                lab = _format_labels(self.labelnames, key, ("le", "+Inf"))
                lines.append(f"{self.name}_bucket{lab} {int(child[-2])}")
                lab = _format_labels(self.labelnames, key)
                lines.append(f"{self.name}_count{lab} {int(child[-2])}")
                lines.append(
                    f"{self.name}_sum{lab} {_format_value(child[-1])}")
            # bucket-derived percentile gauges: scrape consumers get
            # p50/p95/p99 without running histogram_quantile themselves
            # (and the CLI's --metrics text is readable as-is).  Gauge-
            # typed companions, never part of the histogram series.
            for pname, q in PERCENTILES:
                lines.append(f"# TYPE {self.name}_{pname} gauge")
                for key, child in sorted(self._children.items()):
                    v = self._quantile_locked(child, q)
                    if v is None:
                        continue
                    lab = _format_labels(self.labelnames, key)
                    lines.append(
                        f"{self.name}_{pname}{lab} {_format_value(v)}")
        lines.extend(self._overflow_lines())
        return lines


class MetricsRegistry:
    """Named home for every metric in the process.

    ``counter``/``gauge``/``histogram`` are get-or-create: a second
    registration with the same name returns the SAME child (so
    instrument sites need no import-order coordination), but a name
    collision across metric kinds or label sets is a programming error
    and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls \
                        or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}"
                        f"{existing.labelnames}, cannot re-register as "
                        f"{cls.__name__}{tuple(labelnames)}")
                return existing
            metric = cls(name, help, labelnames, lock=self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        # same loud-collision policy as kind/labelnames: silently
        # landing observations in someone else's buckets is invisible
        want = tuple(sorted(float(b) for b in buckets))
        if h.buckets != want:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}, cannot re-register with {want}")
        return h

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable view of every metric's current state."""
        out: Dict[str, dict] = {}
        for m in sorted(self.metrics(), key=lambda m: m.name):
            entry = {"kind": m.kind, "help": m.help,
                     "series": m.snapshot()}
            if isinstance(m, Histogram):
                # the bucket EDGES, explicit: a fleet merge
                # (telemetry.fleet) sums bucket counts bucket-wise and
                # must never re-derive the bounds from formatted keys
                entry["bucket_bounds"] = [float(b) for b in m.buckets]
            if m.labelnames:
                entry["labelnames"] = list(m.labelnames)
            overflow = m.label_overflow
            if overflow:
                entry["label_overflow"] = overflow
            out[m.name] = entry
        return out

    def to_json(self, **dumps_kwargs) -> str:
        return json.dumps(self.snapshot(), allow_nan=False, **dumps_kwargs)

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            lines.extend(m.prometheus_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (tests; a process never needs this)."""
        with self._lock:
            self._metrics.clear()


#: The process-wide default registry every instrumentation site uses.
REGISTRY = MetricsRegistry()
