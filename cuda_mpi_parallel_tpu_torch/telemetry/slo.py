"""Rolling-window SLO accounting per (tenant, slo_class).

Counterpart of the JAX package's ``telemetry/slo.py``, line for line:
the same windows, burn rates, edge-triggered ``slo_burn`` events and
gauges.

The serve tier's ``stats()`` percentiles are point-in-time: they say
how fast requests were, not whether the service is KEEPING ITS
PROMISE over time.  This module adds the standard SRE error-budget
view on the service clock (so the fake-clock test idiom drives it
deterministically):

* every terminal request outcome is an observation - in-SLO
  (converged within its class's target latency) or out (missed
  target, TIMEOUT, ERROR, or turned away: REFUSED /
  ADMISSION_REJECTED burn budget too - a rejected request is a broken
  promise from the caller's seat);
* per (tenant, slo_class) the tracker keeps a pruned deque of
  ``(t, ok)`` over the longest configured window and reports the
  in-SLO goodput ratio, the **burn rate** per window
  (``bad_ratio / budget`` - 1.0 means burning exactly the allowed
  budget, >1 means the budget exhausts early), and error-budget
  remaining;
* when a window's burn rate crosses its threshold a typed
  ``slo_burn`` event fires (edge-triggered, re-arming when the burn
  drops back below) - the classic fast/slow multi-window alert pair.

Observe-only by design: nothing here throttles anything.  But
:meth:`SLOTracker.burn_rate` is the documented hook the shed ladder
MAY consume later (``ShedConfig`` growing a burn-rate rung would call
it with the fast window) - the signal is exposed, the policy is not
presumed.

Host-side plain-Python only: observations are made from the
service's post-solve bookkeeping with host scalars, so ``slo=None``
(the default) is free and a solve runs the same operations either
way.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import events
from .registry import REGISTRY

__all__ = ["SLOConfig", "SLOTracker", "SLOWindow"]


@dataclass(frozen=True)
class SLOWindow:
    """One rolling alert window: ``seconds`` of lookback and the burn
    rate past which it trips.  The conventional pair is a fast window
    (minutes, high threshold - page on a cliff) and a slow window
    (hours, low threshold - ticket on a leak); the serve tests drive
    scaled-down versions through the fake clock."""
    name: str
    seconds: float
    burn_threshold: float

    def __post_init__(self):
        if self.seconds <= 0:
            raise ValueError(f"window {self.name!r}: seconds must be "
                             f"> 0, got {self.seconds}")
        if self.burn_threshold <= 0:
            raise ValueError(f"window {self.name!r}: burn_threshold "
                             f"must be > 0, got {self.burn_threshold}")


@dataclass(frozen=True)
class SLOConfig:
    """SLO accounting policy for a SolverService.

    ``budget`` is the allowed bad fraction (0.01 = 99% objective);
    ``min_samples`` keeps a near-empty window from tripping on its
    first bad request (burn is 0 until the window holds that many
    observations).
    """
    windows: Tuple[SLOWindow, ...] = (
        SLOWindow("fast", 60.0, 14.4),
        SLOWindow("slow", 3600.0, 1.0),
    )
    budget: float = 0.01
    min_samples: int = 8

    def __post_init__(self):
        if not self.windows:
            raise ValueError("SLOConfig needs at least one window")
        if not (0.0 < self.budget < 1.0):
            raise ValueError(f"budget must be in (0, 1), got "
                             f"{self.budget}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got "
                             f"{self.min_samples}")


@dataclass
class _FlowState:
    """Per-(tenant, slo_class) rolling state."""
    samples: deque = field(default_factory=deque)   # (t, ok) pairs
    good: int = 0
    bad: int = 0
    tripped: Dict[str, bool] = field(default_factory=dict)


class SLOTracker:
    """Rolling-window SLO accounting; one per SolverService.

    Thread-safe: worker threads observe concurrently.  All times come
    from the caller (the service clock), never from wall time - the
    fake-clock drill is bit-deterministic.
    """

    def __init__(self, config: SLOConfig):
        self.config = config
        self._max_window = max(w.seconds for w in config.windows)
        self._flows: Dict[Tuple[str, str], _FlowState] = {}
        self._lock = threading.Lock()
        self._burn_events = 0
        labelnames = ("tenant", "slo_class", "window")
        self._g_ratio = REGISTRY.gauge(
            "slo_goodput_ratio",
            "in-SLO fraction of terminal outcomes over the window",
            labelnames=labelnames)
        self._g_burn = REGISTRY.gauge(
            "slo_burn_rate",
            "bad_ratio / budget over the window (1.0 = on budget)",
            labelnames=labelnames)
        self._g_budget = REGISTRY.gauge(
            "slo_error_budget_remaining",
            "fraction of the window's error budget still unspent",
            labelnames=labelnames)

    # -- observation --------------------------------------------------

    def observe(self, tenant: str, slo_class: str, t: float,
                in_slo: bool) -> None:
        """Record one terminal outcome at service-clock time ``t``.

        Prunes everything older than the longest window, recomputes
        every window's burn, updates the gauges, and emits one
        ``slo_burn`` event per window on the below->above threshold
        edge.
        """
        cfg = self.config
        key = (str(tenant), str(slo_class))
        trips = []
        with self._lock:
            flow = self._flows.setdefault(key, _FlowState())
            flow.samples.append((float(t), bool(in_slo)))
            if in_slo:
                flow.good += 1
            else:
                flow.bad += 1
            horizon = float(t) - self._max_window
            while flow.samples and flow.samples[0][0] < horizon:
                _, ok = flow.samples.popleft()
                if ok:
                    flow.good -= 1
                else:
                    flow.bad -= 1
            for window in cfg.windows:
                burn, ratio, n = self._window_burn_locked(
                    flow, float(t), window)
                labels = {"tenant": key[0], "slo_class": key[1],
                          "window": window.name}
                self._g_ratio.set(ratio, **labels)
                self._g_burn.set(burn, **labels)
                self._g_budget.set(max(0.0, 1.0 - burn), **labels)
                was = flow.tripped.get(window.name, False)
                now_tripped = burn >= window.burn_threshold
                flow.tripped[window.name] = now_tripped
                if now_tripped and not was:
                    self._burn_events += 1
                    trips.append((window, burn, ratio, n))
        for window, burn, ratio, n in trips:
            events.emit(
                "slo_burn", tenant=key[0], slo_class=key[1],
                window=window.name, burn_rate=round(burn, 6),
                burn_threshold=window.burn_threshold,
                window_s=window.seconds, budget=cfg.budget,
                goodput_ratio=round(ratio, 6), n_samples=n, t_service=t)

    def _window_burn_locked(self, flow: _FlowState, now: float,
                            window: SLOWindow
                            ) -> Tuple[float, float, int]:
        """(burn, goodput_ratio, n) for one window (lock held).

        The longest window is O(1) off the running counters; shorter
        windows scan the pruned deque from the new end (bounded by the
        longest window's population).
        """
        if window.seconds >= self._max_window:
            good, bad = flow.good, flow.bad
        else:
            horizon = now - window.seconds
            good = bad = 0
            for ts, ok in reversed(flow.samples):
                if ts < horizon:
                    break
                if ok:
                    good += 1
                else:
                    bad += 1
        n = good + bad
        if n < self.config.min_samples or n == 0:
            return 0.0, 1.0, n
        bad_ratio = bad / n
        return bad_ratio / self.config.budget, good / n, n

    # -- the documented shed-ladder hook -------------------------------

    def burn_rate(self, tenant: str, slo_class: str, now: float,
                  window: Optional[str] = None) -> float:
        """Current burn rate for one flow (default: fastest window).

        THE hook a future shed-ladder rung consumes: observe-only
        today, but ``ShedConfig`` may call this with the service clock
        and shed the classes below gold when the gold flow burns hot.
        Returns 0.0 for unknown flows (no data = no alarm).
        """
        cfg = self.config
        if window is None:
            win = min(cfg.windows, key=lambda w: w.seconds)
        else:
            matches = [w for w in cfg.windows if w.name == window]
            if not matches:
                raise ValueError(
                    f"unknown SLO window {window!r}; configured: "
                    f"{[w.name for w in cfg.windows]}")
            win = matches[0]
        with self._lock:
            flow = self._flows.get((str(tenant), str(slo_class)))
            if flow is None:
                return 0.0
            burn, _, _ = self._window_burn_locked(flow, float(now), win)
            return burn

    def burning(self, now: float) -> List[Dict[str, Any]]:
        """Every (flow, window) currently burning over its threshold.

        The readiness gate's view of this tracker: read-only (no
        events, no trip-latch mutation - :meth:`observe` owns those),
        computed at the caller's clock so a fake-clock ops test can
        drive it deterministically.  Empty list = no flow is burning.
        """
        now = float(now)
        out: List[Dict[str, Any]] = []
        with self._lock:
            for (tenant, slo_class), flow in sorted(self._flows.items()):
                for window in self.config.windows:
                    burn, _, n = self._window_burn_locked(
                        flow, now, window)
                    if burn > window.burn_threshold:
                        out.append({
                            "tenant": tenant,
                            "slo_class": slo_class,
                            "window": window.name,
                            "burn_rate": round(burn, 4),
                            "burn_threshold": window.burn_threshold,
                            "n": n,
                        })
        return out

    # -- reporting -----------------------------------------------------

    def snapshot(self, now: float) -> Dict[str, Any]:
        """The stats() section: per-flow per-window burn/goodput plus
        the trip counter."""
        out: Dict[str, Any] = {"burn_events": self._burn_events,
                               "budget": self.config.budget,
                               "flows": {}}
        with self._lock:
            for (tenant, slo_class), flow in sorted(self._flows.items()):
                entry: Dict[str, Any] = {}
                for window in self.config.windows:
                    burn, ratio, n = self._window_burn_locked(
                        flow, float(now), window)
                    entry[window.name] = {
                        "burn_rate": round(burn, 4),
                        "goodput_ratio": round(ratio, 4),
                        "budget_remaining": round(
                            max(0.0, 1.0 - burn), 4),
                        "n": n,
                        "tripped": flow.tripped.get(window.name,
                                                    False),
                    }
                out["flows"][f"{tenant}/{slo_class}"] = entry
        return out
