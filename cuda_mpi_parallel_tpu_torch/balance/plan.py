"""Partition planning: choose (reorder x split x exchange) by predicted
stall cost.

Counterpart of the JAX package's ``balance/plan.py``, its own copy: the
same candidates, scores, plans and fingerprints, with one design change
- the default machine model (:func:`reference_model`) is a fixed H100
table, so ``plan="auto"`` can choose another layout than the JAX
package's default does (the ratio of memory to network bandwidth
differs); one explicit ``MachineModel`` given to both planners gives
the same plan.

``telemetry.shardscope`` can *measure* per-shard nnz/halo skew the
moment a partition is built; this module closes the loop by choosing
the partition FROM that measurement before anything is built.  A
:func:`plan_partition` call enumerates candidate plans - a symmetric
SPD-preserving reordering (none / RCM / greedy nnz-aware, see
``.reorder``) crossed with a contiguous row split (even / balanced-nnz,
see ``.nnz_split``) crossed with a halo-exchange lane (allgather /
gather, see ``parallel.exchange``) - scores each candidate with
shardscope's static accounting (``report_for_ranges``) joined to the
roofline communication model (``telemetry.roofline.MachineModel``),
and returns the minimizer as a :class:`PartitionPlan`.

The default score is the modeled per-iteration SHARD-STALL time of the
shipped distributed schedules.  On the stacked per-shard tensors every
shard is padded to identical shapes, so nnz skew does not make one device late -
it inflates the UNIFORM padded slot count every device multiplies
through (that is how the ``nnz_max_over_mean`` stall factor is paid
here), plus the wire term of the candidate's exchange lane:

    score =   slots_max * (itemsize + 4) * G / mem_bw    (padded work)
            + wire_bytes(exchange) / net_bw              (halo wire)

    wire_bytes(allgather | ring) = (P - 1) * n_local * itemsize
    wire_bytes(gather)           = padded coupled-entry rounds
                                   (shardscope.gather_wire_bytes)

``G`` (``model.gather_slowdown``) prices sparse-gather work against
the streaming bandwidth the machine model quotes: the per-entry x
gather is random access; the table default of 8
(:data:`GATHER_SLOWDOWN`, the JAX package's value) is a deliberately
conservative charge, not a measurement of the card.

Balancing nnz shrinks the first term; keeping shards row-compact (the
``row_cap_factor`` cap) bounds the allgather wire; a bandwidth-
reducing reorder shrinks the gather wire.  The coupled halo is priced
at FULL weight on the gather lane - the wire honors it
(``parallel.exchange`` ships exactly the coupled entries): each lane is
charged the bytes its schedule actually moves.  All three machine parameters (mem
bandwidth, net bandwidth, gather slowdown) live on ONE
``telemetry.roofline.MachineModel`` shared with the roofline and the
runtime calibrator; the default is the deterministic H100 reference
table (:func:`reference_model`) so plans stay host-independent - the
CPU and the card plan alike - and another model is used only when
explicitly passed via ``model=``.

Everything is host-side numpy over the CSR structure arrays - no
device state, no tracing; a plan is pure layout metadata that the
``parallel`` partitioners consume (``row_ranges=``) and the solvers
invert on the way out (``permutation``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from ..parallel.partition import _host
from . import nnz_split, reorder as reorder_mod

__all__ = [
    "GREEDY_REORDER_LIMIT",
    "PartitionPlan",
    "plan_partition",
    "reference_model",
    "score_report",
    "wire_bytes_for",
]

#: rows above which the O(nnz log n) Python-heap greedy ordering is
#: dropped from the candidate set (RCM's native path stays; planning a
#: multi-million-row system should not spend minutes in heapq)
GREEDY_REORDER_LIMIT = 200_000

_REFERENCE = [None]

#: the name the default model's plans record in ``scored_by``
REFERENCE_NAME = "reference-h100"

#: the H100 data sheet's HBM capacity (80 GB), the reference's
#: ``hbm_bytes``
_H100_HBM_BYTES = 80.0e9


def __getattr__(name):
    # GATHER_SLOWDOWN is a lazy alias of the ONE shared definition
    # (telemetry.roofline.DEFAULT_GATHER_SLOWDOWN, also the
    # MachineModel field default) - duplicating the literal here let
    # the two layers this PR unified drift apart; lazy so importing
    # balance/ alone stays light (roofline pulls the telemetry stack)
    if name == "GATHER_SLOWDOWN":
        from ..telemetry.roofline import DEFAULT_GATHER_SLOWDOWN

        return DEFAULT_GATHER_SLOWDOWN
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reference_model():
    """The planner's deterministic reference machine: the ``"H100"`` row
    of ``telemetry.roofline``'s published peaks (HBM and interconnect
    bytes/s, float32 FLOP/s), the data sheet's 80 GB and the
    conservative gather-slowdown default, as one shared
    ``telemetry.roofline.MachineModel`` named :data:`REFERENCE_NAME`.
    It never queries a device: only the ratios matter for ranking
    candidates, and a model read from the host would make plans
    host-dependent - so this is the default, and any other model is
    opt-in via ``model=``."""
    if _REFERENCE[0] is None:
        from ..telemetry.roofline import MachineModel, published_peaks

        mem, f32, _f64, net = published_peaks("H100")
        # gather_slowdown deliberately omitted: the MachineModel field
        # default IS the shared table value
        _REFERENCE[0] = MachineModel(
            name=REFERENCE_NAME, mem_bytes_per_s=mem, flops_per_s=f32,
            net_bytes_per_s=net, hbm_bytes=_H100_HBM_BYTES,
            source="table")
    return _REFERENCE[0]


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionPlan:
    """One chosen partition layout: how to reorder, where to cut.

    ``row_ranges`` and ``report`` describe the matrix AFTER
    ``permutation`` is applied (``perm[new] = old``, the
    ``CSRMatrix.permuted`` convention); ``permutation is None`` means
    the original ordering.  ``report`` is the PREDICTED ShardReport
    (coupling-based halo semantics, ``report_for_ranges``); the
    schedule-specific measured report is emitted by the partitioner at
    solve time and the two ride one ``partition_plan`` telemetry event.
    """

    n_shards: int
    row_ranges: Tuple[Tuple[int, int], ...]
    permutation: Optional[np.ndarray]   # perm[new] = old, or None
    reorder: str                        # "none" | "rcm" | "greedy"
    split: str                          # "even" | "nnz"
    objective: str
    score: float
    #: the halo-exchange lane this plan was scored for: "allgather"
    #: (the legacy fixed collective - also what a pre-exchange saved
    #: plan loads as), "gather" (packed coupled-entry ppermute rounds,
    #: parallel.exchange) or "ring" (full x-block rotation).  The
    #: solve honors it unless the caller pins exchange= explicitly.
    exchange: str = "allgather"
    report: Optional[object] = None     # predicted ShardReport
    #: the even-split imbalance digest of the UNpermuted matrix - the
    #: baseline the plan is beating, for reports and benches
    baseline_imbalance: Optional[dict] = None
    #: name of the MachineModel whose parameters priced ``score`` -
    #: :data:`REFERENCE_NAME` unless another model was passed
    scored_by: str = REFERENCE_NAME

    @property
    def label(self) -> str:
        # the legacy allgather lane keeps the historical two-part label
        # (dashboards and gauge series keyed on it stay continuous);
        # other lanes name their wire
        if self.exchange == "allgather":
            return f"{self.reorder}+{self.split}"
        return f"{self.reorder}+{self.split}+{self.exchange}"

    def fingerprint(self) -> str:
        """Short stable digest of the layout (ranges + permutation +
        exchange lane): the solver-cache key component and event
        correlation id.  The legacy allgather lane hashes exactly as
        before this field existed, so saved pre-exchange plans keep
        their recorded fingerprints."""
        h = hashlib.sha1()
        h.update(repr((self.n_shards, self.row_ranges)).encode())
        if self.permutation is not None:
            h.update(np.ascontiguousarray(
                self.permutation, dtype=np.int64).tobytes())
        if self.exchange != "allgather":
            h.update(f"exchange={self.exchange}".encode())
        return h.hexdigest()[:12]

    def inverse_permutation(self) -> Optional[np.ndarray]:
        if self.permutation is None:
            return None
        return reorder_mod.inverse_permutation(self.permutation)

    @property
    def n_global(self) -> int:
        return int(self.row_ranges[-1][1]) if self.row_ranges else 0

    def validate_for(self, a) -> None:
        n = int(a.shape[0])
        if self.n_global != n:
            raise ValueError(
                f"plan covers {self.n_global} rows but the operator has "
                f"{n} (plan fingerprints are per-matrix layouts)")
        if self.permutation is not None:
            # full bijection check, not just length: a corrupt saved
            # plan must be rejected HERE (downstream gathers clamp
            # out-of-range indices and would return a silently wrong x)
            if self.permutation.shape[0] != n or not np.array_equal(
                    np.sort(self.permutation), np.arange(n)):
                raise ValueError(
                    f"plan permutation is not a permutation of "
                    f"range({n})")

    def is_trivial(self) -> bool:
        """True when the plan IS the legacy layout: no permutation,
        the even row split, and a fixed-payload wire (allgather/ring -
        what the unplanned schedules run anyway).  ``resolve_plan``
        collapses trivial plans to ``None`` so an auto-planned solve
        of an already-balanced system shares the unplanned executable
        (same cache key, same operations) instead of building a
        byte-identical twin.  A gather-lane plan is never trivial: its
        wire differs from the legacy schedule even on even ranges."""
        return self.permutation is None and self.exchange != "gather" \
            and self.row_ranges \
            == nnz_split.even_ranges(self.n_global, self.n_shards)

    def describe(self) -> str:
        pred = ""
        if self.report is not None and self.baseline_imbalance:
            pred = (f", nnz max/mean "
                    f"{self.baseline_imbalance['nnz_max_over_mean']:.2f}"
                    f" -> "
                    f"{self.report.imbalance()['nnz_max_over_mean']:.2f}")
        return (f"{self.label} over {self.n_shards} shards "
                f"({self.fingerprint()}{pred})")

    def to_json(self) -> dict:
        return {
            "version": 1,
            "n_shards": self.n_shards,
            "row_ranges": [[int(lo), int(hi)]
                           for lo, hi in self.row_ranges],
            "permutation": (None if self.permutation is None
                            else [int(v) for v in self.permutation]),
            "reorder": self.reorder,
            "split": self.split,
            "exchange": self.exchange,
            "objective": self.objective,
            "score": float(self.score),
            "fingerprint": self.fingerprint(),
            "predicted": (None if self.report is None
                          else self.report.to_json()),
            "baseline_imbalance": self.baseline_imbalance,
            "scored_by": self.scored_by,
        }

    @classmethod
    def from_json(cls, data: dict) -> "PartitionPlan":
        from ..telemetry.shardscope import ShardReport

        perm = data.get("permutation")
        pred = data.get("predicted")
        return cls(
            n_shards=int(data["n_shards"]),
            row_ranges=tuple((int(lo), int(hi))
                             for lo, hi in data["row_ranges"]),
            permutation=(None if perm is None
                         else np.asarray(perm, dtype=np.int64)),
            reorder=str(data.get("reorder", "?")),
            split=str(data.get("split", "?")),
            # pre-exchange saved plans were scored for (and ran) the
            # allgather wire - load them as exactly that
            exchange=str(data.get("exchange", "allgather")),
            objective=str(data.get("objective", "auto")),
            score=float(data.get("score", 0.0)),
            report=(None if pred is None
                    else ShardReport.from_json(pred)),
            baseline_imbalance=data.get("baseline_imbalance"),
            scored_by=str(data.get("scored_by", REFERENCE_NAME)),
        )

    def layout_json(self) -> dict:
        """MINIMAL layout identity - exactly what a distributed
        checkpoint must record to be migratable to a different mesh
        shape later (``robust.elastic``): the row ranges, the
        permutation, the exchange lane and the fingerprint.  No
        predicted report, no score - a checkpoint's npz should not
        carry a planner diagnostic payload."""
        return {
            "n_shards": int(self.n_shards),
            "row_ranges": [[int(lo), int(hi)]
                           for lo, hi in self.row_ranges],
            "permutation": (None if self.permutation is None
                            else [int(v) for v in self.permutation]),
            "exchange": self.exchange,
            "fingerprint": self.fingerprint(),
            "label": self.label,
        }

    @classmethod
    def from_layout_json(cls, data: dict) -> "PartitionPlan":
        """Rebuild a plan from its :meth:`layout_json` - enough to lift
        a checkpoint's padded plan-permuted state back to global row
        order (reorder/split/score are unknown and labeled so)."""
        perm = data.get("permutation")
        return cls(
            n_shards=int(data["n_shards"]),
            row_ranges=tuple((int(lo), int(hi))
                             for lo, hi in data["row_ranges"]),
            permutation=(None if perm is None
                         else np.asarray(perm, dtype=np.int64)),
            reorder="saved", split="saved", objective="saved",
            score=0.0,
            exchange=str(data.get("exchange", "allgather")),
        )

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "PartitionPlan":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(json.load(f))


def wire_bytes_for(report, exchange: str, itemsize: int) -> float:
    """Per-device per-matvec interconnect bytes of ``exchange`` on the
    layout ``report`` describes (coupling semantics,
    ``shardscope.report_for_ranges``).

    The fixed lanes (allgather / ring) land ``(P - 1) * n_local``
    entries on every device however the entries couple; the gather
    lane ships the coupled-entry rounds padded per-round to the max
    over shards (``shardscope.gather_wire_bytes`` - FULL weight, no
    down-weighting: since ``parallel.exchange`` the wire honors the
    coupling, so the planner charges exactly what is sent)."""
    if exchange == "gather":
        from ..telemetry.shardscope import gather_wire_bytes

        return float(gather_wire_bytes(report))
    from ..parallel.exchange import allgather_wire_bytes

    # one definition of the dense wire, shared with choose_exchange's
    # auto rule - refining the all_gather pricing updates both at once
    return float(allgather_wire_bytes(report.n_shards, report.n_local,
                                      itemsize))


def score_report(report, *, objective: str = "time", itemsize: int = 8,
                 model=None, exchange: str = "allgather") -> float:
    """Rank a candidate layout; lower is better (seconds for 'time').

    ``report`` is a coupling-semantics ``ShardReport``
    (``shardscope.report_for_ranges``); ``model`` a
    ``telemetry.roofline.MachineModel`` supplying the mem/net
    bandwidths and gather slowdown (default: :func:`reference_model`);
    ``exchange`` the halo wire the candidate would run (its bytes are
    priced via :func:`wire_bytes_for`).  Public so that an already-built
    layout can be re-priced with the terms the planner chose it by."""
    if objective == "nnz":
        from ..telemetry.shardscope import max_over_mean

        return float(max_over_mean(report.nnz))
    if objective == "halo":
        return float(report.halo_send_bytes.max()
                     + report.halo_recv_bytes.max())
    if model is None:
        model = reference_model()
    from ..telemetry.roofline import DEFAULT_GATHER_SLOWDOWN

    mem_bps = float(model.mem_bytes_per_s)
    net_bps = float(model.net_bytes_per_s
                    or reference_model().net_bytes_per_s)
    gather = float(getattr(model, "gather_slowdown",
                           DEFAULT_GATHER_SLOWDOWN))
    # "time": modeled per-iteration stall seconds (module docstring)
    slot_term = (float(report.slots.max()) * (itemsize + 4)
                 * gather / mem_bps)
    wire_term = wire_bytes_for(report, exchange, itemsize) / net_bps
    return slot_term + wire_term


def plan_partition(a, n_shards: int, *, objective: str = "auto",
                   reorders: Optional[Sequence[str]] = None,
                   splits: Sequence[str] = ("even", "nnz"),
                   exchange: str = "auto",
                   row_cap_factor: float = 1.25,
                   itemsize: Optional[int] = None,
                   model=None,
                   hbm_budget: Optional[float] = None) -> PartitionPlan:
    """Enumerate (reorder x split x exchange) candidates; return the
    minimizer.

    Args:
      a: the global assembled ``CSRMatrix`` (SPD; symmetric pattern).
      n_shards: mesh size the partition targets.
      objective: ``"auto"``/``"time"`` (modeled per-iteration stall
        seconds - the default), ``"nnz"`` (pure nnz max/mean stall
        factor) or ``"halo"`` (peak coupling bytes).
      reorders: candidate orderings; default ``("none", "rcm",
        "greedy")`` with greedy dropped past
        :data:`GREEDY_REORDER_LIMIT` rows.
      splits: candidate row splits (``"even"``, ``"nnz"``).
      exchange: halo-wire lanes to search - ``"auto"`` (the default)
        scores every (reorder, split) under BOTH the legacy allgather
        wire and the coupled-entry gather wire
        (``parallel.exchange``), full weight each, and lets the
        cheaper lane win; ``"allgather"``/``"gather"``/``"ring"`` pin
        one lane (ring prices like allgather: the rotation lands the
        same fixed payload).
      row_cap_factor: balanced-nnz splits cap real rows per shard at
        ``ceil(n/P) * factor`` so one shard of very light rows cannot
        inflate everyone's padded local size (see
        ``nnz_split.balanced_nnz_ranges``).
      itemsize: value bytes for halo/slot pricing (default: the
        matrix dtype's).
      model: a ``telemetry.roofline.MachineModel`` to price the time
        objective against (mem/net bandwidth AND gather slowdown);
        default is the static H100 reference table
        (:func:`reference_model`) so plans are host-deterministic.
        Pass another model (``telemetry.roofline.machine_model()``) to
        rank against it - the plan's ``scored_by`` records which model
        chose it.
      hbm_budget: per-device HBM bytes the chosen partition must fit
        in (``telemetry.memscope`` accounting: worst-shard pinned
        partition bytes + the modeled solver working set).  Candidates
        that overflow are dropped from the search; when EVERY layout
        overflows at ``n_shards``, the planner doubles the mesh until
        one fits (a tight budget drives the shard count up) and the
        returned plan's ``n_shards`` records the grown size.  When no
        mesh up to ``n`` rows fits, raises
        :class:`telemetry.memscope.MemoryBudgetError` naming the
        bytes.  ``None`` (default) skips the gate entirely.

    Returns:
      The best :class:`PartitionPlan`; candidates are tried simplest
      first (none+even leads), so on a balanced structured system the
      planner returns the legacy layout and the solve proceeds exactly
      as an unplanned one would.
    """
    if objective == "auto":
        objective = "time"
    if objective not in ("time", "nnz", "halo"):
        raise ValueError(f"unknown plan objective {objective!r}")
    if exchange not in ("auto", "allgather", "gather", "ring"):
        raise ValueError(f"unknown plan exchange {exchange!r}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    # nnz/halo objectives rank layouts, not wires: score once per
    # (reorder, split) on the pinned lane (or the legacy default)
    if exchange != "auto":
        lanes = (exchange,)
    elif objective == "time":
        lanes = ("allgather", "gather")
    else:
        lanes = ("allgather",)
    from ..telemetry import shardscope

    n = int(a.shape[0])
    if itemsize is None:
        itemsize = int(a.data.element_size())
    if model is None:
        model = reference_model()
    if reorders is None:
        reorders = ("none", "rcm", "greedy")
        if n > GREEDY_REORDER_LIMIT:
            reorders = ("none", "rcm")
    row_cap = max(1, int(-(-n // n_shards) * row_cap_factor)) \
        if row_cap_factor else None

    baseline = shardscope.report_for_ranges(
        a, nnz_split.even_ranges(n, n_shards), itemsize=itemsize,
        plan="none+even")
    baseline_imb = baseline.imbalance()

    def _fits_budget(rep, lane) -> bool:
        # worst-shard persistent bytes (exact slot accounting from the
        # predicted report + the modeled solver working set) vs the
        # per-device budget; the gather lane's extended-x buffer holds
        # the halo rows the report predicts
        if hbm_budget is None:
            return True
        from ..telemetry import memscope

        halo_w = 0
        if lane == "gather":
            halo_w = int(np.ceil(
                float(np.asarray(rep.halo_recv_bytes).max()) / itemsize))
        solver = memscope.solver_bytes_per_shard(
            n_local=rep.n_local, n_shards=n_shards, itemsize=itemsize,
            exchange=lane, halo_width=halo_w)
        worst = int(np.asarray(rep.persistent_bytes).max()) + solver
        return worst <= hbm_budget

    over_budget = 0
    best = None
    for rname in reorders:
        if rname == "none":
            perm, ap = None, a
        elif rname == "rcm":
            perm = reorder_mod.rcm_reorder(a)
            ap = a.permuted(perm)
        elif rname == "greedy":
            perm = reorder_mod.greedy_nnz_reorder(a)
            ap = a.permuted(perm)
        else:
            raise ValueError(f"unknown reorder {rname!r}")
        indptr = _host(ap.indptr)
        for sname in splits:
            if sname == "even":
                ranges = nnz_split.even_ranges(n, n_shards)
            elif sname == "nnz":
                ranges = nnz_split.balanced_nnz_ranges(
                    indptr, n_shards, max_local_rows=row_cap)
            else:
                raise ValueError(f"unknown split {sname!r}")
            if rname == "none" and sname == "even":
                rep = baseline  # same inputs; the O(nnz) walk is paid once
            else:
                rep = shardscope.report_for_ranges(
                    ap, ranges, itemsize=itemsize,
                    plan=f"{rname}+{sname}")
            trivial_layout = rname == "none" and sname == "even"
            for lane in lanes:
                if not _fits_budget(rep, lane):
                    over_budget += 1
                    continue
                score = score_report(rep, objective=objective,
                                     itemsize=itemsize, model=model,
                                     exchange=lane)
                cand = PartitionPlan(
                    n_shards=n_shards, row_ranges=ranges,
                    permutation=perm,
                    reorder=rname, split=sname, objective=objective,
                    score=score, exchange=lane, report=rep,
                    baseline_imbalance=baseline_imb,
                    scored_by=str(model.name))
                if best is None:
                    best = cand               # none+even on the FIRST
                    legacy_score = score      # lane: the legacy lane
                    layout_floor = score
                    continue
                # Two-layer hysteresis (candidate order runs simplest
                # first: trivial layout leads, allgather lane before
                # gather, so ties always stay with the simpler choice):
                if trivial_layout:
                    # a wire upgrade on the legacy LAYOUT carries no
                    # permutation/variable-row churn but still builds
                    # a new cached solver - it must clear the same > 2%
                    # bar vs the legacy lane
                    if score < legacy_score * 0.98 \
                            and score < best.score * (1 - 1e-9):
                        best = cand
                    layout_floor = min(layout_floor, score)
                    continue
                # a LAYOUT deviation must beat the best trivial-layout
                # lane by > 2%: reordering to collect a wire win the
                # trivial layout already gets for free is pure churn
                # for a model-noise-sized gain
                if score < layout_floor * 0.98 \
                        and score < best.score * (1 - 1e-9):
                    best = cand
    if best is None:
        if over_budget:
            # every layout overflows this mesh: grow it (doubling keeps
            # pod-slice shapes) until one fits, or refuse with the
            # memscope accounting once shards would outnumber rows
            if n_shards * 2 <= n:
                return plan_partition(
                    a, n_shards * 2, objective=objective,
                    reorders=reorders, splits=splits,
                    exchange=exchange, row_cap_factor=row_cap_factor,
                    itemsize=itemsize, model=model,
                    hbm_budget=hbm_budget)
            from ..telemetry import memscope

            required = int(np.asarray(
                baseline.persistent_bytes).max()) \
                + memscope.solver_bytes_per_shard(
                    n_local=baseline.n_local, n_shards=n_shards,
                    itemsize=itemsize, exchange="allgather")
            raise memscope.MemoryBudgetError(
                f"no partition of this {n}-row system fits "
                f"hbm_budget={int(hbm_budget)} bytes at any mesh size "
                f"up to {n_shards} shards (worst-shard persistent "
                f"bytes {required} at {n_shards} shards)",
                required_bytes=required,
                budget_bytes=int(hbm_budget), n_shards=n_shards)
        raise ValueError(
            "plan_partition needs at least one (reorder, split) "
            "candidate; got empty reorders/splits")
    return best
