"""Straggler watchdog: measured phase timings -> typed degradation.

Counterpart of the JAX package's ``robust/watchdog.py``, line for line,
but for the backend its baseline cache key names: the device the
profile was measured on (``"cuda"`` or ``"cpu"``), as
``telemetry.calibrate`` names a fit's.

``telemetry.phasetrace`` makes per-shard SpMV seconds and per-link halo
bandwidths MEASURED quantities; this module is the consumer that turns
them into a recovery trigger.  A :class:`StragglerWatchdog` compares
each new ``telemetry.phasetrace.PhaseProfile`` against its
calibration-cache EWMA baseline (``utils.tune.JsonCache`` - the same
measured-artifact store the machine-model calibrations live in, so a
healthy host's history survives the process) and emits a typed
``shard_degraded`` event + counter for every shard whose local SpMV
slowed - or link whose measured bandwidth dropped - past the
threshold.

``utils.checkpoint.solve_resumable_distributed(elastic=True,
watchdog=...)`` consumes the findings as a checkpoint-now-and-migrate
trigger: the segment's state is already saved, so the loop migrates
the checkpoint off the degraded shard's mesh and resumes.  Drill it
deterministically with ``robust.FaultPlan(site="shard_slow")`` - the
drill inflates the MEASURED profile (``FaultPlan.doctor_profile``),
so the watchdog's real detection path runs end to end without a real
straggler.

First-observation behavior is deliberate: with no EWMA history, a
shard's baseline is the MEDIAN of its peers in the same profile (a
mesh of equals with one straggler still detects on the very first
profile); links have no meaningful peer (rounds carry different
payloads), so link findings need history.  Healthy observations fold
into the EWMA; degraded ones never do - a straggler must not drag its
own baseline up until it reads healthy.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = [
    "DEFAULT_THRESHOLD",
    "Degradation",
    "StragglerWatchdog",
    "WATCHDOG_MAX_AGE_S",
]

#: a shard (or link) reading this many times worse than its baseline
#: is degraded; 2x is far above virtual-device scheduling noise and
#: far below the shard_slow drill's 8x
DEFAULT_THRESHOLD = 2.0

#: EWMA baselines older than this are treated as absent (same rule as
#: the machine-model calibrations: last month's kernel is not a
#: baseline)
WATCHDOG_MAX_AGE_S = 7 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class Degradation:
    """One typed watchdog finding (the ``shard_degraded`` payload).

    ``phase`` is ``"spmv"`` (``shard`` = the slow shard's index) or
    ``"link"`` (``shard`` = the exchange round's shift - the link
    identity phasetrace measures).  ``ratio`` is measured/baseline for
    seconds, baseline/measured for bandwidths - always "times worse".
    """

    shard: int
    phase: str
    measured: float
    baseline: float
    ratio: float
    threshold: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        what = ("shard" if self.phase == "spmv" else "link shift")
        return (f"{what} {self.shard} {self.phase} degraded "
                f"{self.ratio:.1f}x past baseline "
                f"(threshold {self.threshold:g}x)")


class StragglerWatchdog:
    """See the module docstring.

    Args:
      threshold: degradation ratio that fires a finding.
      alpha: EWMA weight of a new healthy observation.
      cache: ``utils.tune.JsonCache`` override (tests); ``None`` uses
        the default measured-artifact cache directory.
      persist: write EWMA baselines back to the cache (``False`` keeps
        them in-process - drills that must not pollute a host's real
        baselines).
      check_every_segments: how often the elastic loop profiles
        (every Nth completed segment; profiling re-pays the O(nnz)
        partition, so long production segments check sparsely).
      profile_repeats: chained reps per profiled phase
        (``phasetrace.profile_partition``'s ``repeats``).
    """

    def __init__(self, *, threshold: float = DEFAULT_THRESHOLD,
                 alpha: float = 0.3, cache=None, persist: bool = False,
                 check_every_segments: int = 1,
                 profile_repeats: int = 4):
        if threshold <= 1.0:
            raise ValueError(
                f"threshold must be > 1 (a ratio), got {threshold}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if check_every_segments < 1:
            raise ValueError(
                f"check_every_segments must be >= 1, got "
                f"{check_every_segments}")
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.persist = bool(persist)
        self.check_every_segments = int(check_every_segments)
        self.profile_repeats = int(profile_repeats)
        self._cache = cache
        self._spmv: dict = {}
        self._links: dict = {}
        self._loaded = False
        self._device = None
        self.degradations: List[Degradation] = []

    # -- persistence (the calibration-cache EWMA) ---------------------

    def _cache_obj(self):
        if self._cache is None:
            from ..utils.tune import JsonCache

            self._cache = JsonCache()
        return self._cache

    def _cache_key(self) -> str:
        from ..telemetry.calibrate import _backend_name
        from ..utils.tune import host_fingerprint

        return f"watchdog-{_backend_name(self._device)}-" \
            f"{host_fingerprint()}"

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        entry = self._cache_obj().get(self._cache_key(),
                                      max_age_s=WATCHDOG_MAX_AGE_S)
        if entry is None:
            return
        payload = entry.get("payload")
        if not isinstance(payload, dict):
            return
        for field, store in (("spmv", self._spmv),
                             ("links", self._links)):
            vals = payload.get(field)
            if isinstance(vals, dict):
                store.update({str(k): float(v)
                              for k, v in vals.items()
                              if isinstance(v, (int, float))})

    def _store(self) -> None:
        if not self.persist:
            return
        try:
            self._cache_obj().put(self._cache_key(),
                                  {"spmv": self._spmv,
                                   "links": self._links})
        except OSError:
            pass  # cache failure degrades to in-process baselines

    # -- detection ----------------------------------------------------

    def observe(self, profile) -> List[Degradation]:
        """Check one measured profile; returns (and notes) this
        profile's findings.  Healthy readings fold into the EWMA;
        degraded ones are emitted as ``shard_degraded`` events and
        never update their own baseline.  The baselines are those of the
        first profile's device."""
        if not self._loaded:
            self._device = getattr(profile, "device", None)
        self._load()
        n_shards = int(profile.n_shards)
        spmv = np.asarray(profile.spmv_s, dtype=float)
        found: List[Degradation] = []

        for shard, measured in enumerate(spmv):
            key = f"{n_shards}:{shard}"
            baseline = self._spmv.get(key)
            if baseline is None:
                # first observation: the median of the shard's PEERS
                # (itself excluded - on a 2-shard mesh the straggler
                # would otherwise sit inside its own baseline and
                # never trip)
                peers = np.delete(spmv, shard)
                baseline = float(np.median(peers)) if peers.size \
                    else float(measured)
            ratio = float(measured) / max(baseline, 1e-300)
            if baseline > 0 and ratio > self.threshold:
                found.append(Degradation(
                    shard=shard, phase="spmv", measured=float(measured),
                    baseline=float(baseline), ratio=ratio,
                    threshold=self.threshold))
                continue
            prev = self._spmv.get(key)
            self._spmv[key] = float(measured) if prev is None \
                else (1 - self.alpha) * prev + self.alpha * float(measured)

        for link in profile.links:
            shift = int(link.get("shift", 0))
            bps = float(link.get("bytes_per_s", 0.0))
            if bps <= 0:
                continue
            key = f"{n_shards}:{shift}"
            baseline = self._links.get(key)
            if baseline is not None:
                ratio = baseline / max(bps, 1e-300)
                if ratio > self.threshold:
                    found.append(Degradation(
                        shard=shift, phase="link", measured=bps,
                        baseline=float(baseline), ratio=float(ratio),
                        threshold=self.threshold))
                    continue
            self._links[key] = bps if baseline is None \
                else (1 - self.alpha) * baseline + self.alpha * bps

        self._store()
        self.degradations.extend(found)
        for d in found:
            self._note(d, n_shards)
        return found

    def _note(self, d: Degradation, n_shards: int) -> None:
        from ..telemetry import events
        from ..telemetry.registry import REGISTRY

        REGISTRY.counter(
            "watchdog_degraded_total",
            "typed shard/link degradations the straggler watchdog "
            "detected (measured phase timing vs EWMA baseline)",
            labelnames=("phase",)).inc(phase=d.phase)
        events.emit("shard_degraded", n_shards=n_shards, **d.to_json())

    def degraded_shards(self, findings) -> List[int]:
        """The SHARD indices a migration should drop (``spmv``
        findings; a slow link names a round, not a host, and the
        replan already reprices the wire)."""
        return sorted({d.shard for d in findings if d.phase == "spmv"})
