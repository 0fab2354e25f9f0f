"""Sparse gather halo exchange: ship only the coupled x entries.

Counterpart of the JAX package's ``parallel/exchange.py``, host numpy
as there and field for field the same: ``DistCSR`` all-gathers the
whole padded x every matvec, ``DistCSRRing`` rotates full x-blocks,
whatever the coupling; a :class:`GatherSchedule`, compiled once at
partition time, ships only the coupled entries:

* per (shard, neighbour) pair, the sorted set of remote x entries the
  shard's rows reference;
* grouped into ring-rotation rounds (round ``r``: shard ``j`` sends to
  ``(j + r) % P``), each one ``ppermute`` whose permutation is a
  rotation (``halo.validate_permutation`` checks every round);
* each round padded to its max live count over shards (the padding
  fraction is reported), rounds with no coupling dropped;
* column ids remapped into the extended-x layout ``[local block |
  round-1 recv | round-2 recv | ...]``, entry order untouched - which
  is why a gather-exchange solve gives the allgather solve's bits.

``exchange="auto"`` keeps allgather when the padded coupled volume
approaches the dense payload (:data:`AUTO_WIRE_FRACTION`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "AUTO_WIRE_FRACTION",
    "GatherRound",
    "GatherSchedule",
    "accepts_gather",
    "allgather_wire_bytes",
    "build_gather_schedule",
    "choose_exchange",
    "gather_wire_entries",
]

#: ``exchange="auto"`` takes the gather schedule only when its padded
#: wire volume is below this fraction of the allgather wire
#: ((P-1) * n_local entries per device) - near-dense coupling pays the
#: padding AND re-ships multiply-read entries, so the fixed collective
#: is the better wire there.
AUTO_WIRE_FRACTION = 0.9


@dataclasses.dataclass(frozen=True)
class GatherRound:
    """One ``ppermute`` round of a gather schedule.

    At round ``shift`` every shard ``j`` sends ``send_idx[j]`` (local x
    offsets, ``counts[j]`` live entries zero-padded to the shared
    ``m``) to shard ``(j + shift) % n_shards``.  Padding slots carry
    offset 0; the receiver's remapped columns never reference a padded
    slot, so the padded value is multiplied by nothing.
    """

    shift: int
    send_idx: np.ndarray   # (n_shards, m) int32 local x offsets
    counts: np.ndarray     # (n_shards,) live entries per sender

    @property
    def m(self) -> int:
        """Padded entries per device this round actually ships."""
        return int(self.send_idx.shape[1])


@dataclasses.dataclass(frozen=True)
class GatherSchedule:
    """The compiled halo schedule of one gather-exchange partition.

    ``rounds`` holds only the shifts with ANY coupling (empty rounds
    are dropped from the wire entirely); ``coupled_entries`` counts the
    real distinct (reader shard, column) pairs across the mesh - the
    coupling number - while the wire additionally carries
    the per-round padding to max.
    """

    n_shards: int
    n_local: int
    rounds: Tuple[GatherRound, ...]
    coupled_entries: int

    @property
    def halo_width(self) -> int:
        """Extended-x entries appended after the local block (sum of
        per-round padded sizes) - uniform across shards."""
        return sum(r.m for r in self.rounds)

    def wire_entries_per_device(self) -> int:
        """Entries each device sends (== receives) per matvec,
        padding included - what actually crosses the interconnect."""
        return self.halo_width

    def wire_bytes_per_matvec(self, itemsize: int) -> int:
        return self.wire_entries_per_device() * int(itemsize)

    def round_wire_bytes(self, itemsize: int) -> Tuple[int, ...]:
        """Per-round padded bytes each device ships (== receives) -
        one entry per live round, in round order.  Sums to
        :meth:`wire_bytes_per_matvec`; a phase profiler divides each
        round's measured seconds by its entry here to fit a per-link
        bandwidth (which separates links only when payloads differ)."""
        return tuple(r.m * int(itemsize) for r in self.rounds)

    def padding_fraction(self) -> float:
        """Fraction of shipped entries that are pad-to-max filler.

        ``1 - real coupled pairs / (padded entries * P)``; 0.0 for an
        empty schedule (nothing shipped, nothing padded)."""
        shipped = self.halo_width * self.n_shards
        if shipped == 0:
            return 0.0
        return 1.0 - self.coupled_entries / shipped

    def perms(self):
        """The validated ppermute rotation of every round, in round
        order (``halo.rotation_perm`` - each device sends once and
        receives once)."""
        from .halo import rotation_perm

        return tuple(rotation_perm(self.n_shards, r.shift)
                     for r in self.rounds)

    def to_json(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "n_local": self.n_local,
            "rounds": [{"shift": r.shift, "m": r.m,
                        "counts": [int(c) for c in r.counts]}
                       for r in self.rounds],
            "coupled_entries": int(self.coupled_entries),
            "halo_width": self.halo_width,
            "padding_fraction": round(self.padding_fraction(), 6),
        }


def allgather_wire_bytes(n_shards: int, n_local: int,
                         itemsize: int) -> int:
    """Per-device interconnect bytes of the dense alternatives: both
    the ring implementation of ``all_gather`` and the explicit ring
    x-rotation land ``(P - 1) * n_local`` entries on every device per
    matvec - the fixed payload the gather schedule undercuts."""
    return (n_shards - 1) * n_local * int(itemsize)


def _coupled_sets(data: np.ndarray, cols: np.ndarray, n_local: int,
                  n_shards: int):
    """``(needed, coupled)``: per (reader, owner) pair the sorted
    distinct (padded-)global column ids the reader's live entries
    reference in the owner's block, plus their total count - the
    schedule's raw material, shared by build_gather_schedule and the
    counts-only wire probe below."""
    needed = {}
    coupled = 0
    for s in range(n_shards):
        live = data[s] != 0
        blk = cols[s] // n_local
        for j in range(n_shards):
            if j == s:
                continue
            sel = live & (blk == j)
            if not sel.any():
                continue
            u = np.unique(cols[s][sel])
            needed[(s, j)] = u
            coupled += u.size
    return needed, coupled


def _round_sizes(needed, n_shards: int):
    """Per coupled shift, ``(shift, counts, m)`` with ``m`` the padded
    entries every device ships that round (max live count over
    senders); empty shifts are dropped."""
    out = []
    for shift in range(1, n_shards):
        counts = np.zeros(n_shards, dtype=np.int64)
        for j in range(n_shards):
            counts[j] = needed.get(((j + shift) % n_shards, j),
                                   np.empty(0)).size
        m = int(counts.max()) if n_shards else 0
        if m:
            out.append((shift, counts, m))
    return out


def gather_wire_entries(data: np.ndarray, cols: np.ndarray,
                        n_local: int, n_shards: int) -> int:
    """Padded entries per device per matvec a gather schedule of this
    partition WOULD ship - the ``exchange="auto"`` probe, without
    materializing send indices or remapping a single column (the
    decline path on dense coupling pays only the coupled-set scan)."""
    needed, _ = _coupled_sets(np.asarray(data), np.asarray(cols),
                              n_local, n_shards)
    return sum(m for _, _, m in _round_sizes(needed, n_shards))


def build_gather_schedule(data: np.ndarray, cols: np.ndarray,
                          n_local: int, n_shards: int, *,
                          precomputed=None
                          ) -> Tuple[GatherSchedule, np.ndarray]:
    """Compile the gather halo schedule of a row-partitioned CSR.

    Args:
      data/cols: the ``(n_shards, m)`` stacked per-shard entry arrays a
        ``partition.partition_csr`` call just built.  ``cols`` are
        (padded-)global ids; dead padding slots have ``data == 0``.
      n_local/n_shards: the partition geometry (columns of block ``b``
        live at ``[b * n_local, (b + 1) * n_local)``).
      precomputed: an already-computed ``_coupled_sets(data, cols, ...)``
        result, so a caller that probed the wire first (the
        ``exchange="auto"`` accept path) does not pay the coupled-set
        scan twice.

    Returns:
      ``(schedule, new_cols)`` - the schedule plus ``cols`` remapped
      into each shard's extended-x layout: own-block ids map to
      ``[0, n_local)``, each remote id to ``n_local + offset`` of its
      slot in the round it arrives on, and dead slots to 0 (their zero
      data multiplies whatever sits there).  Entry ORDER is untouched,
      so the downstream ``csr_matvec`` sums in exactly the allgather
      path's order - same bits out.
    """
    data = np.asarray(data)
    cols = np.asarray(cols)
    # needed[(reader, owner)] = sorted distinct cols reader uses from
    # owner's block - the distinct cross-shard coupled
    # (reader, column) pairs, as index sets instead of counts
    needed, coupled = precomputed if precomputed is not None \
        else _coupled_sets(data, cols, n_local, n_shards)

    rounds = []
    offsets = {}            # shift -> extended-x offset of its recv slab
    width = 0
    for shift, counts, m in _round_sizes(needed, n_shards):
        send_idx = np.zeros((n_shards, m), dtype=np.int32)
        for j in range(n_shards):
            u = needed.get(((j + shift) % n_shards, j))
            if u is not None:
                send_idx[j, : u.size] = (u - j * n_local).astype(np.int32)
        rounds.append(GatherRound(shift=shift, send_idx=send_idx,
                                  counts=counts))
        offsets[shift] = n_local + width
        width += m

    new_cols = np.zeros_like(cols)
    for s in range(n_shards):
        live = data[s] != 0
        c = cols[s]
        blk = c // n_local
        own = live & (blk == s)
        new_cols[s][own] = (c[own] - s * n_local).astype(cols.dtype)
        for j in range(n_shards):
            if j == s:
                continue
            u = needed.get((s, j))
            if u is None:
                continue
            sel = live & (blk == j)
            shift = (s - j) % n_shards
            new_cols[s][sel] = (offsets[shift]
                                + np.searchsorted(u, c[sel])
                                ).astype(cols.dtype)
    sched = GatherSchedule(n_shards=n_shards, n_local=n_local,
                           rounds=tuple(rounds), coupled_entries=coupled)
    sched.perms()   # every schedule built here is permutation-validated
    return sched, new_cols


def accepts_gather(wire_bytes: int, n_shards: int, n_local: int,
                   itemsize: int,
                   fraction: float = AUTO_WIRE_FRACTION) -> bool:
    """The ``exchange="auto"`` decision rule, on raw byte counts:
    gather only when its padded wire undercuts the dense payload by at
    least ``1 - fraction`` - as the coupled volume approaches O(n)
    (dense stencils, every entry read by several shards) the fixed
    collective wins and auto declines to plain allgather.  The ONE
    definition behind :func:`choose_exchange`, the partitioner's
    counts-only probe, and the sequence calibrator's lane inference."""
    if n_shards <= 1:
        return False
    dense = allgather_wire_bytes(n_shards, n_local, itemsize)
    return dense > 0 and wire_bytes < fraction * dense


def choose_exchange(schedule: GatherSchedule, itemsize: int,
                    fraction: float = AUTO_WIRE_FRACTION) -> str:
    """:func:`accepts_gather` on a built schedule's wire."""
    return ("gather" if accepts_gather(
        schedule.wire_bytes_per_matvec(itemsize), schedule.n_shards,
        schedule.n_local, itemsize, fraction) else "allgather")
