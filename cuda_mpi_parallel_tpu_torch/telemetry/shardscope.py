"""Per-shard load and communication accounting at partition time.

Counterpart of the JAX package's ``telemetry/shardscope.py``: the same
reports, field for field, for the CSR and stencil families; for the
ring shift-ELL families ``rows``, ``nnz``, the halo payloads and
``neighbors`` are the JAX report's, while ``slots`` and
``persistent_bytes`` are the port's own - its ring slabs are packed in
Hopper's sliced ELL, ragged per owner, not the TPU's uniform sheets.

The node-aware SpMV literature (PAPERS: arXiv 1612.08060, 1112.5588)
is unanimous about what kills row-partitioned solvers at scale: not
total work but *skew* - one shard with fatter rows or a heavier halo
stalls every ``psum`` for the whole mesh, every iteration.  The rest
of the telemetry is per-*solve* (aggregate collective counts,
flight-recorded convergence); this module makes it per-*shard*.

Everything here is **static and host-side**: the numbers are computed
from the partition layout the moment it is built (``numpy`` over the
same arrays the partitioner just produced), never from device state -
so the accounting can never perturb a solve (the solves of
tests/test_torch_shardscope.py run the same operations telemetered or
not).  A :class:`ShardReport` answers, per shard ``k``:

* how many real (unpadded) rows and live matrix entries it owns;
* how many entry *slots* it was allocated (uniform-shape padding -
  the stacked per-shard tensors need identical local shapes, unlike
  ragged MPI ranks - or the sliced-ELL packers' slice widths), i.e.
  wasted multiply work;
* how many bytes it sends/receives per matvec, to which neighbor
  (ring ``ppermute`` schedules are neighbor-resolved; ``all_gather``
  is attributed to the mesh at large).

Byte semantics match :mod:`.cost`: **payload bytes per device per
matvec** - what the collective's input block carries, not wire-level
algorithm bytes (an all_gather's ring implementation may move more).

Imbalance is summarized two ways, following the SpMV-skew papers:
``max/mean`` (the stall factor: a psum waits for the heaviest shard)
and the Gini coefficient (how concentrated the load is overall).

Emission: :func:`note_report` publishes a ``shard_profile`` event and
per-shard labeled gauges (``shard="k"``) when telemetry is active, and
always parks the report in a module slot, :func:`last_shard_report`
(mirroring ``dist_cg.last_comm_cost``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..parallel.partition import _host

__all__ = [
    "ShardReport",
    "gather_wire_bytes",
    "gini",
    "last_shard_report",
    "max_over_mean",
    "note_report",
    "report_for_ranges",
    "report_gather_csr",
    "report_partition_csr",
    "report_ring_csr",
    "report_ring_shiftell",
    "report_stencil",
    "reset_last_shard_report",
    "shard_report",
]


def max_over_mean(values) -> float:
    """The stall factor of a per-shard quantity: ``max / mean``.

    1.0 is perfect balance; a psum-synchronized loop runs at the speed
    of the max shard, so this factor IS the slowdown versus a
    perfectly rebalanced partition.  Zero-mean (empty) inputs report
    1.0 - nothing to stall on."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        return 1.0
    mean = float(arr.mean())
    if mean == 0.0:
        return 1.0
    return float(arr.max()) / mean


def gini(values) -> float:
    """Gini coefficient of a nonnegative per-shard quantity.

    0 = perfectly even, ->1 = all load on one shard.  The standard
    mean-absolute-difference form, O(P^2) - P is a device count, never
    large."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        return 0.0
    mean = float(arr.mean())
    if mean == 0.0:
        return 0.0
    diff_sum = float(np.abs(arr[:, None] - arr[None, :]).sum())
    return diff_sum / (2.0 * arr.size * arr.size * mean)


@dataclasses.dataclass(frozen=True)
class ShardReport:
    """Static per-shard accounting of one partitioned operator.

    ``halo_send_bytes``/``halo_recv_bytes`` are per matvec per shard
    (payload semantics, see module docstring); multiply by the
    method's matvecs/iteration and the solve's iteration count for
    whole-solve volume.  ``neighbors[k]`` lists ``(peer, bytes)``
    sends - ``peer`` is a shard index, or ``-1`` for an unattributed
    collective (all_gather).
    """

    kind: str                     # partition family (csr-allgather, ...)
    n_shards: int
    n_global: int
    n_global_padded: int
    n_local: int                  # padded rows per shard
    rows: np.ndarray              # (P,) real rows owned
    nnz: np.ndarray               # (P,) live matrix entries owned
    slots: np.ndarray             # (P,) allocated entry slots
    halo_send_bytes: np.ndarray   # (P,) bytes sent per matvec
    halo_recv_bytes: np.ndarray   # (P,) bytes received per matvec
    neighbors: Tuple[Tuple[Tuple[int, int], ...], ...]
    #: which partition plan produced this layout ("even" = the legacy
    #: uniform row split; planned partitions label reports with their
    #: reorder+split lane, e.g. "rcm+nnz")
    plan: str = "even"
    #: (P,) per-shard device bytes the partition pins for the life of
    #: a dispatcher - ``telemetry.memscope``'s numbers (ONE shared
    #: definition: ``matrix_bytes_per_shard`` for built partitions,
    #: ``csr_slot_bytes(slots)`` for the planner's predicted report),
    #: so shard_profile events carry bytes alongside nnz/slots.
    #: ``None`` for reports rebuilt from pre-memscope event files.
    persistent_bytes: Optional[np.ndarray] = None

    # ---- derived -----------------------------------------------------
    def padding_overhead(self) -> np.ndarray:
        """Per-shard wasted-slot fraction: ``(slots - nnz) / slots``.

        The fraction of allocated multiply work that is padding (zero
        entries plus synthetic unit-diagonal padding rows).  0.0 when a
        shard has no slots at all."""
        slots = self.slots.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = (slots - self.nnz) / slots
        return np.where(slots > 0, frac, 0.0)

    def imbalance(self) -> dict:
        """The skew digest: max/mean + Gini for each load axis."""
        return {
            "rows_max_over_mean": max_over_mean(self.rows),
            "nnz_max_over_mean": max_over_mean(self.nnz),
            "nnz_gini": gini(self.nnz),
            "halo_send_max_over_mean": max_over_mean(self.halo_send_bytes),
            "halo_send_gini": gini(self.halo_send_bytes),
            "padding_overhead_total": float(
                (self.slots.sum() - self.nnz.sum())
                / max(int(self.slots.sum()), 1)),
        }

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "plan": self.plan,
            "n_shards": self.n_shards,
            "n_global": self.n_global,
            "n_global_padded": self.n_global_padded,
            "n_local": self.n_local,
            "rows": [int(v) for v in self.rows],
            "nnz": [int(v) for v in self.nnz],
            "slots": [int(v) for v in self.slots],
            "halo_send_bytes": [int(v) for v in self.halo_send_bytes],
            "halo_recv_bytes": [int(v) for v in self.halo_recv_bytes],
            "padding_overhead": [round(float(v), 6)
                                 for v in self.padding_overhead()],
            "neighbors": [[[int(p), int(b)] for p, b in ns]
                          for ns in self.neighbors],
            "imbalance": self.imbalance(),
            "persistent_bytes": (
                None if self.persistent_bytes is None
                else [int(v) for v in self.persistent_bytes]),
        }

    @classmethod
    def from_json(cls, data: dict) -> "ShardReport":
        """Rebuild from :meth:`to_json` output (what a ``shard_profile``
        event carries - tools/solve_report.py's input)."""
        return cls(
            kind=str(data["kind"]), n_shards=int(data["n_shards"]),
            n_global=int(data["n_global"]),
            n_global_padded=int(data["n_global_padded"]),
            n_local=int(data["n_local"]),
            rows=np.asarray(data["rows"], dtype=np.int64),
            nnz=np.asarray(data["nnz"], dtype=np.int64),
            slots=np.asarray(data["slots"], dtype=np.int64),
            halo_send_bytes=np.asarray(data["halo_send_bytes"],
                                       dtype=np.int64),
            halo_recv_bytes=np.asarray(data["halo_recv_bytes"],
                                       dtype=np.int64),
            neighbors=tuple(tuple((int(p), int(b)) for p, b in ns)
                            for ns in data.get("neighbors", [])),
            plan=str(data.get("plan", "even")),
            persistent_bytes=(
                None if data.get("persistent_bytes") is None
                else np.asarray(data["persistent_bytes"],
                                dtype=np.int64)),
        )

    def table(self) -> str:
        """The per-shard text table of a report."""
        head = (f"{'shard':>5}  {'rows':>9}  {'nnz':>11}  {'pad%':>6}  "
                f"{'halo out B/mv':>13}  {'halo in B/mv':>12}")
        pad = self.padding_overhead() * 100.0
        lines = [head]
        for k in range(self.n_shards):
            lines.append(
                f"{k:>5}  {int(self.rows[k]):>9}  {int(self.nnz[k]):>11}  "
                f"{pad[k]:>6.1f}  {int(self.halo_send_bytes[k]):>13}  "
                f"{int(self.halo_recv_bytes[k]):>12}")
        imb = self.imbalance()
        lines.append(
            f"imbalance: nnz max/mean {imb['nnz_max_over_mean']:.3f} "
            f"(gini {imb['nnz_gini']:.3f}), halo max/mean "
            f"{imb['halo_send_max_over_mean']:.3f}, padding overhead "
            f"{imb['padding_overhead_total'] * 100:.1f}% "
            f"[plan: {self.plan}]")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the reports (one per partition family)

def _row_ranges(n: int, n_local: int, n_shards: int,
                row_ranges=None) -> Tuple[Tuple[int, int], ...]:
    """The contiguous row ranges of a partition: the planner's explicit
    ranges when present, else the legacy even split they generalize."""
    if row_ranges is not None:
        return tuple((int(lo), int(hi)) for lo, hi in row_ranges)
    return tuple((min(s * n_local, n), min((s + 1) * n_local, n))
                 for s in range(n_shards))


def _real_rows(n: int, n_local: int, n_shards: int,
               row_ranges=None) -> np.ndarray:
    ranges = _row_ranges(n, n_local, n_shards, row_ranges)
    return np.array([hi - lo for lo, hi in ranges], dtype=np.int64)


def _csr_shard_nnz(a, n_local: int, n_shards: int,
                   row_ranges=None) -> np.ndarray:
    """Exact live entries per row block, from the global indptr (the
    partitioners' padded arrays cannot distinguish a real unit diagonal
    from a synthetic padding-row one; the source matrix can)."""
    indptr = _host(a.indptr).astype(np.int64)
    ranges = _row_ranges(a.shape[0], n_local, n_shards, row_ranges)
    return np.array([int(indptr[hi] - indptr[lo]) if hi > lo else 0
                     for lo, hi in ranges], dtype=np.int64)


def _partition_persistent_bytes(parts) -> np.ndarray:
    """memscope's exact pinned-bytes account of a built partition -
    imported lazily (memscope also consumes this module)."""
    from .memscope import matrix_bytes_per_shard

    return matrix_bytes_per_shard(parts)


def _plan_label(parts, plan) -> str:
    if plan is not None:
        return str(plan)
    return "planned" if getattr(parts, "row_ranges", None) is not None \
        else "even"


def _ring_halo(n_shards: int, payload: int):
    """Ring x-rotation traffic: ``n_shards - 1`` ppermute steps per
    matvec, each carrying ``payload`` bytes; shard ``k`` sends to
    ``(k - 1) % P`` and receives from ``(k + 1) % P`` (the schedule in
    ``parallel.operators.DistCSRRing``)."""
    total = (n_shards - 1) * payload
    send = np.full(n_shards, total, dtype=np.int64)
    recv = send.copy()
    neighbors = tuple(
        (((k - 1) % n_shards, total),) if n_shards > 1 else ()
        for k in range(n_shards))
    return send, recv, neighbors


def gather_wire_bytes(report: "ShardReport") -> int:
    """Per-device per-matvec interconnect bytes of the gather halo
    exchange (``parallel.exchange``) on the layout ``report``
    describes - REQUIRES coupling semantics (``report_for_ranges``),
    whose ``neighbors`` list the distinct coupled-entry bytes per
    (owner, reader) pair.

    The schedule packs pair ``j -> (j + r) % P`` into rotation round
    ``r`` and pads each round to the max over senders (one shape per
    collective on every shard), so the wire is
    ``sum_r max_j bytes(j -> (j + r) % P)`` - exactly what
    ``exchange.GatherSchedule.wire_bytes_per_matvec`` reports for the
    built schedule, here computable from the report alone (what the
    planner scores before anything is built).  Rounds with no coupled
    pair contribute zero (they are dropped from the wire entirely).
    """
    p = report.n_shards
    if p <= 1:
        return 0
    pair = {}
    for k, ns in enumerate(report.neighbors):
        for peer, b in ns:
            if peer >= 0:
                pair[(k, peer)] = int(b)
    total = 0
    for shift in range(1, p):
        total += max(pair.get((k, (k + shift) % p), 0)
                     for k in range(p))
    return total


def report_gather_csr(a, parts, plan=None) -> ShardReport:
    """Accounting for ``partition.partition_csr(exchange='gather')``
    output (the ``DistCSRGather`` packed-ppermute schedule).

    Unlike every fixed-payload schedule, the wire here IS the coupled
    halo: per round ``r`` shard ``k`` sends its padded slab
    (``m_r * itemsize`` bytes, the round's max live count over
    senders) to ``(k + r) % P`` and receives the same from
    ``(k - r) % P`` - so sends and receives are uniform across shards
    and ``neighbors`` resolves per rotation peer.  These are the REAL
    per-matvec wire bytes (padding included: padded slots ride the
    links too), matching the recorded ``wire_bytes`` account of
    ``telemetry.cost`` exactly."""
    sched = parts.halo
    n_shards, n_local = parts.n_shards, parts.n_local
    ranges = getattr(parts, "row_ranges", None)
    itemsize = np.asarray(parts.data).dtype.itemsize
    nnz = _csr_shard_nnz(a, n_local, n_shards, ranges)
    slots = np.full(n_shards, parts.data.shape[1], dtype=np.int64)
    per_device = sched.wire_bytes_per_matvec(itemsize)
    send = np.full(n_shards, per_device, dtype=np.int64)
    recv = send.copy()
    neighbors = tuple(
        tuple(((k + r.shift) % n_shards, r.m * itemsize)
              for r in sched.rounds)
        for k in range(n_shards))
    return ShardReport(
        kind="csr-gather", n_shards=n_shards, n_global=parts.n_global,
        n_global_padded=parts.n_global_padded, n_local=n_local,
        rows=_real_rows(parts.n_global, n_local, n_shards, ranges),
        nnz=nnz,
        slots=slots, halo_send_bytes=send, halo_recv_bytes=recv,
        neighbors=neighbors, plan=_plan_label(parts, plan),
        persistent_bytes=_partition_persistent_bytes(parts))


def report_partition_csr(a, parts, plan=None) -> ShardReport:
    """Accounting for ``partition.partition_csr`` output (the
    ``all_gather`` ``DistCSR`` schedule; gather-exchange partitions
    dispatch to :func:`report_gather_csr`)."""
    if getattr(parts, "halo", None) is not None:
        return report_gather_csr(a, parts, plan=plan)
    n_shards, n_local = parts.n_shards, parts.n_local
    ranges = getattr(parts, "row_ranges", None)
    itemsize = np.asarray(parts.data).dtype.itemsize
    nnz = _csr_shard_nnz(a, n_local, n_shards, ranges)
    slots = np.full(n_shards, parts.data.shape[1], dtype=np.int64)
    # all_gather payload: each shard contributes its own x block and
    # receives every other shard's (payload semantics - see module doc)
    send = np.full(n_shards, n_local * itemsize, dtype=np.int64)
    recv = np.full(n_shards, (n_shards - 1) * n_local * itemsize,
                   dtype=np.int64)
    neighbors = tuple(((-1, int(send[k])),) if n_shards > 1 else ()
                      for k in range(n_shards))
    return ShardReport(
        kind="csr-allgather", n_shards=n_shards, n_global=parts.n_global,
        n_global_padded=parts.n_global_padded, n_local=n_local,
        rows=_real_rows(parts.n_global, n_local, n_shards, ranges),
        nnz=nnz,
        slots=slots, halo_send_bytes=send, halo_recv_bytes=recv,
        neighbors=neighbors, plan=_plan_label(parts, plan),
        persistent_bytes=_partition_persistent_bytes(parts))


def report_ring_csr(a, parts, plan=None) -> ShardReport:
    """Accounting for ``partition.ring_partition_csr`` output (the
    ``ppermute`` x-rotation ``DistCSRRing`` schedule)."""
    n_shards, n_local = parts.n_shards, parts.n_local
    ranges = getattr(parts, "row_ranges", None)
    itemsize = np.asarray(parts.data[0]).dtype.itemsize
    nnz = _csr_shard_nnz(a, n_local, n_shards, ranges)
    slots = np.full(n_shards,
                    sum(d.shape[1] for d in parts.data), dtype=np.int64)
    send, recv, neighbors = _ring_halo(n_shards, n_local * itemsize)
    return ShardReport(
        kind="csr-ring", n_shards=n_shards, n_global=parts.n_global,
        n_global_padded=parts.n_global_padded, n_local=n_local,
        rows=_real_rows(parts.n_global, n_local, n_shards, ranges),
        nnz=nnz,
        slots=slots, halo_send_bytes=send, halo_recv_bytes=recv,
        neighbors=neighbors, plan=_plan_label(parts, plan),
        persistent_bytes=_partition_persistent_bytes(parts))


def report_ring_shiftell(a, parts, plan=None) -> ShardReport:
    """Accounting for ``partition.ring_partition_shiftell`` (f32/f64)
    AND ``ring_partition_shiftell_df64`` output.

    Slot counts are the port's own: owner ``s``'s sliced-ELL slots
    summed over its ring steps (``len(vals[t][s])``; ragged across
    owners, unlike the JAX package's uniform TPU sheets), and
    ``persistent_bytes`` the bytes of the tensors the lane pins
    (``memscope.matrix_bytes_per_shard``).  Rows, nnz, halo payloads
    and neighbors are the JAX report's: the f64 ring rotates 8-byte x
    entries, as the JAX df64 packer's two f32 planes do."""
    from ..parallel import partition as part

    n_shards, n_local = parts.n_shards, parts.n_local
    ranges = getattr(parts, "row_ranges", None)
    df64 = isinstance(parts, part.RingPartitionedShiftELLDF64)
    nnz = _csr_shard_nnz(a, n_local, n_shards, ranges)
    slots = np.array([sum(int(parts.vals[t][s].shape[0])
                          for t in range(n_shards))
                      for s in range(n_shards)], dtype=np.int64)
    payload = n_local * (8 if df64
                         else np.asarray(parts.vals[0][0]).dtype.itemsize)
    send, recv, neighbors = _ring_halo(n_shards, payload)
    return ShardReport(
        kind="ring-shiftell-df64" if df64 else "ring-shiftell",
        n_shards=n_shards, n_global=parts.n_global,
        n_global_padded=parts.n_global_padded, n_local=n_local,
        rows=_real_rows(parts.n_global, n_local, n_shards, ranges),
        nnz=nnz,
        slots=slots, halo_send_bytes=send, halo_recv_bytes=recv,
        neighbors=neighbors, plan=_plan_label(parts, plan),
        persistent_bytes=_partition_persistent_bytes(parts))


def report_stencil(local_grid, n_shards: int, itemsize: int,
                   points: int, kind: str) -> ShardReport:
    """Accounting for a slab-partitioned matrix-free stencil.

    Rows and (implicit) entries are uniform by construction; the per-
    shard variation is the halo - interior shards exchange one boundary
    plane with BOTH neighbors, edge shards with one (``ppermute``'s
    fill-with-zeros edge is the Dirichlet boundary,
    ``parallel.halo.exchange_halo``)."""
    n_rows = int(np.prod(local_grid))
    plane = int(np.prod(local_grid[1:])) if len(local_grid) > 1 else 1
    plane_bytes = plane * itemsize
    rows = np.full(n_shards, n_rows, dtype=np.int64)
    nnz = np.full(n_shards, points * n_rows, dtype=np.int64)
    send = np.zeros(n_shards, dtype=np.int64)
    neighbors = []
    for k in range(n_shards):
        ns = []
        if k + 1 < n_shards:   # forward shift: k's last plane -> k+1
            ns.append((k + 1, plane_bytes))
        if k > 0:              # backward shift: k's first plane -> k-1
            ns.append((k - 1, plane_bytes))
        send[k] = sum(b for _, b in ns)
        neighbors.append(tuple(ns))
    # the shift pairs are symmetric: bytes received == bytes sent
    return ShardReport(
        kind=kind, n_shards=n_shards,
        n_global=n_rows * n_shards, n_global_padded=n_rows * n_shards,
        n_local=n_rows, rows=rows, nnz=nnz, slots=nnz.copy(),
        halo_send_bytes=send, halo_recv_bytes=send.copy(),
        neighbors=tuple(neighbors))


def shard_report(a, parts, plan=None) -> ShardReport:
    """Dispatch on the partition family (the four partitioner output
    types in ``parallel.partition``)."""
    from ..parallel import partition as part

    if isinstance(parts, part.PartitionedCSR):
        return report_partition_csr(a, parts, plan=plan)
    if isinstance(parts, part.RingPartitionedCSR):
        return report_ring_csr(a, parts, plan=plan)
    if isinstance(parts, (part.RingPartitionedShiftELL,
                          part.RingPartitionedShiftELLDF64)):
        return report_ring_shiftell(a, parts, plan=plan)
    raise TypeError(f"no shard accounting for {type(parts).__name__}")


def report_for_ranges(a, row_ranges, *, itemsize=None,
                      plan: str = "ranges") -> ShardReport:
    """Static accounting for an ARBITRARY contiguous row split of a CSR
    matrix - the shared code path between the partition planner
    (scoring candidate splits before any partition is built) and the
    post-hoc profiler (re-reporting a split that already ran).

    Differences from the schedule-specific reports above:

    * ``slots`` is what ``partition.partition_csr`` WOULD allocate for
      these ranges: every shard padded to the max of (nnz + padding
      rows) - the uniform-shape cost of the split, before any packer
      geometry;
    * halo bytes are COUPLING-based, not schedule-based: shard ``k``
      receives one x entry per *distinct* off-range column its rows
      reference and sends one per distinct local row referenced by
      another shard's rows.  The allgather/ring schedules move a fixed
      payload regardless of sparsity; the coupling volume is the part a
      reordering can actually shrink, which is what the planner needs
      to rank candidate permutations (a gather-based halo exchange
      would move exactly these bytes).

    ``neighbors[k]`` lists ``(peer, bytes)`` sends per matvec.
    """
    indptr = _host(a.indptr).astype(np.int64)
    indices = _host(a.indices).astype(np.int64)
    n = int(a.shape[0])
    n_shards = len(row_ranges)
    ranges = tuple((int(lo), int(hi)) for lo, hi in row_ranges)
    if itemsize is None:
        itemsize = a.data.element_size()
    rows = np.array([hi - lo for lo, hi in ranges], dtype=np.int64)
    nnz = _csr_shard_nnz(a, 0, n_shards, ranges)
    n_local = max(int(rows.max()) if n_shards else 0, 1)
    counts = nnz + (n_local - rows)  # padding rows carry a unit diagonal
    slots = np.full(n_shards, int(counts.max()) if n_shards else 0,
                    dtype=np.int64)

    # shard id of every row (and so of every column, SPD => square)
    starts = np.array([lo for lo, _ in ranges] + [n], dtype=np.int64)
    shard_of = np.repeat(np.arange(n_shards, dtype=np.int64),
                         np.diff(starts))
    entry_rows = np.repeat(np.arange(n, dtype=np.int64),
                           np.diff(indptr))
    row_shard = shard_of[entry_rows]
    col_shard = shard_of[indices]
    off = row_shard != col_shard
    send = np.zeros(n_shards, dtype=np.int64)
    recv = np.zeros(n_shards, dtype=np.int64)
    pair_counts: dict = {}
    if off.any():
        # distinct (referencing shard, column) pairs: one x entry each
        # (all vectorized - the planner calls this per candidate lane,
        # and a 1M-row FEM matrix has millions of cross-shard pairs)
        keys = row_shard[off] * np.int64(n) + indices[off]
        uniq = np.unique(keys)
        u_reader = uniq // n          # the shard that needs the entry
        u_owner = shard_of[uniq % n]  # the shard that owns the column
        np.add.at(recv, u_reader, itemsize)
        np.add.at(send, u_owner, itemsize)
        pair_keys, counts = np.unique(
            u_owner * np.int64(n_shards) + u_reader, return_counts=True)
        pair_counts = {
            (int(k // n_shards), int(k % n_shards)): int(c) * itemsize
            for k, c in zip(pair_keys, counts)}
    sends = [[] for _ in range(n_shards)]
    for (owner, peer), b in sorted(pair_counts.items()):
        sends[owner].append((peer, b))
    neighbors = tuple(tuple(s) for s in sends)
    from .memscope import csr_slot_bytes

    return ShardReport(
        kind="ranges", n_shards=n_shards, n_global=n,
        n_global_padded=n_local * n_shards, n_local=n_local,
        rows=rows, nnz=nnz, slots=slots,
        halo_send_bytes=send, halo_recv_bytes=recv,
        neighbors=neighbors, plan=plan,
        persistent_bytes=csr_slot_bytes(slots, itemsize).astype(
            np.int64))


# ---------------------------------------------------------------------------
# emission + the pickup slot

#: the most recent report noted by a partition site (None before any) -
#: the same pattern as dist_cg._LAST_COMM_COST
_LAST: list = [None]


def last_shard_report() -> Optional[ShardReport]:
    return _LAST[0]


def reset_last_shard_report() -> None:
    _LAST[0] = None


def note_report(report: ShardReport) -> ShardReport:
    """Publish a freshly computed report: park it
    (:func:`last_shard_report`), and when telemetry is active emit a
    ``shard_profile`` event plus per-shard labeled gauges.  Host-side only; call sites gate the (cheap, but
    not free) report computation itself on ``telemetry.active()``."""
    from .. import telemetry
    from .registry import REGISTRY

    _LAST[0] = report
    if not telemetry.active():
        return report
    imb = report.imbalance()
    telemetry.events.emit("shard_profile", **report.to_json())
    for gname, help_, values in (
            ("shard_rows", "real rows owned per shard", report.rows),
            ("shard_nnz", "live matrix entries per shard", report.nnz),
            ("shard_halo_send_bytes",
             "halo payload bytes sent per matvec per shard",
             report.halo_send_bytes)):
        g = REGISTRY.gauge(gname, help_, labelnames=("kind", "shard"))
        for k in range(report.n_shards):
            g.set(float(values[k]), kind=report.kind, shard=str(k))
    REGISTRY.gauge(
        "shard_nnz_imbalance",
        "per-partition nnz max/mean stall factor",
        labelnames=("kind",)).set(imb["nnz_max_over_mean"],
                                  kind=report.kind)
    REGISTRY.gauge(
        "shard_halo_imbalance",
        "per-partition halo-send max/mean stall factor",
        labelnames=("kind",)).set(imb["halo_send_max_over_mean"],
                                  kind=report.kind)
    return report
