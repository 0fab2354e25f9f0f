"""Row partitioning of linear systems across the mesh.

Counterpart of the JAX package's ``parallel/partition.py``, host numpy
as there, producing the same arrays field for field: a global CSR
system split into per-shard row blocks padded to identical local shapes
(a stacked ``(P, ...)`` tensor, like ``shard_map``, needs uniform
shapes).  Padding rows carry a unit diagonal and a zero right-hand side,
so the padded system is still SPD, the padded solution components stay
exactly zero, and Jacobi preconditioning never divides by a zero
diagonal.  It runs once, before the solve: layout work is setup cost,
like the reference's H2D staging (``CUDACG.cu:119-186``).

Plan-driven splits: every partitioner takes an optional ``row_ranges``
- one contiguous ``(lo, hi)`` row range per shard, with variable real
row counts, padded to the max; column ids are remapped into the padded
global layout (:func:`gather_indices`).  ``row_ranges=None`` is the
even split.  The planner that makes such ranges (``balance/``, the
``plan=`` argument of ``solve_distributed``) is not ported yet (ROADMAP
A10 residue); nor are the ring shift-ELL layouts, which sit on B8/B9.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..models.operators import CSRMatrix


def _host(v) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)

#: one contiguous (lo, hi) row range per shard (balance.nnz_split)
RowRanges = Tuple[Tuple[int, int], ...]


class PartitionedCSR(NamedTuple):
    """Stacked per-shard CSR blocks (leading axis = shard index).

    ``data``/``cols``/``local_rows`` have shape ``(n_shards, max_local_nnz)``;
    padding entries have ``data == 0`` and in-range indices.  ``cols`` are
    *global* column ids (the distributed matvec gathers from an all-gathered
    x); ``local_rows`` are local row ids in ``[0, n_local)``.  For a
    plan-driven split ``row_ranges`` records the variable real-row layout
    (``cols`` are then PADDED-global ids, ``gather_indices`` maps back);
    ``None`` marks the legacy even split.
    """

    data: np.ndarray
    cols: np.ndarray
    local_rows: np.ndarray
    n_local: int
    n_global_padded: int
    n_global: int
    n_shards: int
    row_ranges: Optional[RowRanges] = None
    #: compiled gather halo schedule (parallel.exchange) when the
    #: partition was built with ``exchange="gather"`` (or "auto"
    #: accepted it); ``cols`` are then EXTENDED-LOCAL ids into
    #: ``[local block | per-round halo slabs]``.  ``None`` = the
    #: allgather layout, byte-identical to pre-exchange output.
    halo: Optional[object] = None


def padded_size(n: int, n_shards: int) -> int:
    return ((n + n_shards - 1) // n_shards) * n_shards


def check_ranges(row_ranges, n: int, n_shards: int) -> RowRanges:
    """Validate a plan's contiguous cover of ``[0, n)`` (one possibly
    empty range per shard; the JAX ``balance.nnz_split.validate_ranges``
    rule) and return it normalized."""
    ranges = tuple((int(lo), int(hi)) for lo, hi in row_ranges)
    if len(ranges) != n_shards:
        raise ValueError(
            f"expected {n_shards} row ranges, got {len(ranges)}")
    cursor = 0
    for k, (lo, hi) in enumerate(ranges):
        if lo != cursor or hi < lo:
            raise ValueError(
                f"row ranges must tile [0, {n}) contiguously; range {k} "
                f"is [{lo}, {hi}) after covering [0, {cursor})")
        cursor = hi
    if cursor != n:
        raise ValueError(
            f"row ranges cover [0, {cursor}), expected [0, {n})")
    return ranges


def gather_indices(row_ranges: RowRanges, n_local: int) -> np.ndarray:
    """``g`` with ``g[r]`` = padded global id of original row ``r``:
    shard ``s``'s rows ``[lo, hi)`` land at ``s * n_local + [0, hi-lo)``.
    ``x_original = x_padded[g]`` recovers a solution, ``b_padded[g] =
    b`` scatters a right-hand side (:func:`pad_vector_ranges`)."""
    n = int(row_ranges[-1][1]) if row_ranges else 0
    g = np.empty(n, dtype=np.int64)
    for s, (lo, hi) in enumerate(row_ranges):
        g[lo:hi] = s * n_local + np.arange(hi - lo, dtype=np.int64)
    return g


def ranges_n_local(row_ranges: RowRanges) -> int:
    """Padded per-shard slot count of a variable-row split: the max
    real row count over shards (every shard pads to it) - THE
    definition every consumer of a planned layout shares (partitioners
    here, ``pad_vector_ranges`` callers, and the elastic checkpoint
    migration that re-derives a saved layout's geometry)."""
    return max(max(hi - lo for lo, hi in row_ranges), 1)


def layout_gather_indices(n: int, n_shards: int,
                          row_ranges: Optional[RowRanges] = None
                          ) -> np.ndarray:
    """``g`` with ``x_original = x_padded[g]`` for EITHER layout: the
    plan-driven variable-row split (``gather_indices``) or the legacy
    even split, where real rows keep their ids and only the tail is
    padding.  The single padded->global map the elastic checkpoint
    migration lifts recurrence vectors through."""
    if row_ranges is not None:
        return gather_indices(row_ranges, ranges_n_local(row_ranges))
    return np.arange(n, dtype=np.int64)


def _ranges_layout(a, n_shards: int, row_ranges: RowRanges):
    """Shared geometry of a plan-driven split: ``(ranges, n_local,
    n_pad, gmap)`` with ``n_local`` the max real row count (every shard
    pads to it) and ``gmap`` the original-row -> padded-id map.  The
    CALLER's shard count is validated against the ranges - a plan for
    the wrong mesh must fail here, not as a far-away shape error."""
    ranges = check_ranges(row_ranges, a.shape[0], n_shards)
    n_local = ranges_n_local(ranges)
    return ranges, n_local, n_local * n_shards, \
        gather_indices(ranges, n_local)


def _attach_gather_schedule(parts: "PartitionedCSR",
                            exchange: str) -> "PartitionedCSR":
    """Compile the gather halo schedule onto a freshly built partition
    (``parallel.exchange``): cols remapped to the extended-local
    layout, schedule attached as ``halo``.  ``exchange="auto"`` keeps
    the allgather layout untouched when the coupled volume is too
    dense to win - probed with the counts-only wire scan, so the
    decline path (dense coupling, exactly where the scan is largest)
    never materializes send indices or remaps a column."""
    from . import exchange as ex

    sets = None
    if exchange == "auto":
        itemsize = np.asarray(parts.data).dtype.itemsize
        sets = ex._coupled_sets(np.asarray(parts.data),
                                np.asarray(parts.cols),
                                parts.n_local, parts.n_shards)
        wire = sum(m for _, _, m
                   in ex._round_sizes(sets[0], parts.n_shards)) \
            * itemsize
        if not ex.accepts_gather(wire, parts.n_shards, parts.n_local,
                                 itemsize):
            return parts
    sched, new_cols = ex.build_gather_schedule(
        parts.data, parts.cols, parts.n_local, parts.n_shards,
        precomputed=sets)
    return parts._replace(cols=new_cols, halo=sched)


def check_exchange(exchange: str, allowed, where: str) -> str:
    """Validate an ``exchange=`` argument against one partitioner's
    lanes - a typo'd mode must fail at the call site, not as a silent
    allgather fallback."""
    if exchange not in allowed:
        raise ValueError(
            f"unknown exchange {exchange!r} for {where}; expected one "
            f"of {sorted(allowed)}")
    return exchange


def partition_csr(a: CSRMatrix, n_shards: int,
                  row_ranges: Optional[RowRanges] = None,
                  exchange: str = "allgather") -> PartitionedCSR:
    """Split a global CSR matrix into ``n_shards`` row blocks.

    ``row_ranges`` (a partition plan's contiguous variable-row split)
    reshapes the layout: shard ``s`` owns rows ``[lo_s, hi_s)`` padded
    to the max real row count, and ``cols`` are remapped into the
    padded global ordering.  ``None`` is the legacy even split,
    byte-identical to what this function always produced.

    ``exchange`` selects the halo wire the partition is laid out for:
    ``"allgather"`` (default, byte-identical legacy output - global
    column ids, the ``DistCSR`` all-gather matvec), ``"gather"``
    (compile the packed coupled-entry schedule of
    ``parallel.exchange`` and remap ``cols`` into the extended-local
    layout; the schedule rides the ``halo`` field), or ``"auto"``
    (build the schedule, keep it only when its padded wire undercuts
    the dense payload - see ``exchange.AUTO_WIRE_FRACTION``).
    """
    check_exchange(exchange, ("allgather", "gather", "auto"),
                   "partition_csr")
    if row_ranges is not None:
        parts = _partition_csr_ranges(a, n_shards, row_ranges)
        if exchange != "allgather":
            parts = _attach_gather_schedule(parts, exchange)
        return parts
    n = a.shape[0]
    n_pad = padded_size(n, n_shards)
    n_local = n_pad // n_shards

    data = _host(a.data)
    indices = _host(a.indices)
    indptr = _host(a.indptr).astype(np.int64)

    # Entries per shard; padding rows contribute their unit diagonal.
    counts = np.empty(n_shards, dtype=np.int64)
    for s in range(n_shards):
        lo, hi = s * n_local, min((s + 1) * n_local, n)
        pad_rows = n_local - max(0, hi - lo)
        counts[s] = (indptr[hi] - indptr[lo] if hi > lo else 0) + pad_rows
    m = int(counts.max())

    out_data = np.zeros((n_shards, m), dtype=data.dtype)
    out_cols = np.zeros((n_shards, m), dtype=np.int32)
    out_rows = np.zeros((n_shards, m), dtype=np.int32)
    entry_rows = np.repeat(np.arange(n), np.diff(indptr))
    for s in range(n_shards):
        lo, hi = s * n_local, min((s + 1) * n_local, n)
        k = 0
        if hi > lo:
            e0, e1 = indptr[lo], indptr[hi]
            k = int(e1 - e0)
            out_data[s, :k] = data[e0:e1]
            out_cols[s, :k] = indices[e0:e1]
            out_rows[s, :k] = entry_rows[e0:e1] - lo
        # Unit-diagonal padding rows (keep the padded system SPD).
        for r in range(max(hi, lo), (s + 1) * n_local):
            out_data[s, k] = 1.0
            out_cols[s, k] = r  # global id of the padding row
            out_rows[s, k] = r - lo
            k += 1
    parts = PartitionedCSR(
        data=out_data, cols=out_cols, local_rows=out_rows,
        n_local=n_local, n_global_padded=n_pad, n_global=n,
        n_shards=n_shards,
    )
    if exchange != "allgather":
        parts = _attach_gather_schedule(parts, exchange)
    return parts


def _partition_csr_ranges(a: CSRMatrix, n_shards: int,
                          row_ranges: RowRanges) -> PartitionedCSR:
    """The plan-driven sibling of the even split above: variable real
    rows per shard under one common padded slot count.  Column ids are
    remapped through ``gather_indices`` so the all-gathered x (whose
    layout IS the concatenation of padded shard blocks) lines up;
    padding rows keep the unit diagonal at their own padded id."""
    n = a.shape[0]
    ranges, n_local, n_pad, gmap = _ranges_layout(a, n_shards, row_ranges)
    data = _host(a.data)
    indices = _host(a.indices)
    indptr = _host(a.indptr).astype(np.int64)

    counts = np.array(
        [int(indptr[hi] - indptr[lo]) + (n_local - (hi - lo))
         for lo, hi in ranges], dtype=np.int64)
    m = int(counts.max()) if n_shards else 1

    out_data = np.zeros((n_shards, m), dtype=data.dtype)
    out_cols = np.zeros((n_shards, m), dtype=np.int32)
    out_rows = np.zeros((n_shards, m), dtype=np.int32)
    entry_rows = np.repeat(np.arange(n), np.diff(indptr))
    for s, (lo, hi) in enumerate(ranges):
        k = 0
        if hi > lo:
            e0, e1 = indptr[lo], indptr[hi]
            k = int(e1 - e0)
            out_data[s, :k] = data[e0:e1]
            out_cols[s, :k] = gmap[indices[e0:e1]]
            out_rows[s, :k] = entry_rows[e0:e1] - lo
        for r_local in range(hi - lo, n_local):
            out_data[s, k] = 1.0
            out_cols[s, k] = s * n_local + r_local
            out_rows[s, k] = r_local
            k += 1
    return PartitionedCSR(
        data=out_data, cols=out_cols, local_rows=out_rows,
        n_local=n_local, n_global_padded=n_pad, n_global=n,
        n_shards=n_shards, row_ranges=ranges,
    )


def pad_vector(b: np.ndarray, n_padded: int) -> np.ndarray:
    """Zero-pad the leading (row) axis to ``n_padded``; trailing axes
    - a many-RHS ``(n, k)`` column stack - ride along."""
    out = np.zeros((n_padded,) + b.shape[1:], dtype=b.dtype)
    out[: b.shape[0]] = b
    return out


def pad_vector_ranges(b: np.ndarray, row_ranges: RowRanges,
                      n_local: int) -> np.ndarray:
    """Scatter a global vector (or ``(n, k)`` stack - rows scatter,
    columns ride) into the padded variable-row layout (shard blocks of
    ``n_local``, real rows first, zeros after)."""
    n_pad = n_local * len(row_ranges)
    out = np.zeros((n_pad,) + b.shape[1:], dtype=b.dtype)
    out[gather_indices(row_ranges, n_local)] = b
    return out


class RingPartitionedCSR(NamedTuple):
    """Per-shard CSR blocks split by COLUMN block, in ring-schedule order.

    ``data``/``cols``/``local_rows`` are LENGTH-``n_shards`` tuples, one
    entry per ring STEP, each of shape ``(n_shards, m_t)``: axis 0 = owner
    shard, and owner ``i``'s step-``t`` slab holds its coupling to column
    block ``(i + t) % n_shards`` - pre-arranged host-side so the device
    loop indexes slabs statically.  Each step is padded only to ITS OWN
    max across owners (``m_t``): for PDE-like matrices the own-block slab
    (step 0) carries most of the nnz, and padding every step to the
    global max would inflate per-matvec work by up to n_shards x.
    ``cols`` are relative to the column block's start; padding entries
    have ``data == 0``.
    """

    data: Tuple[np.ndarray, ...]
    cols: Tuple[np.ndarray, ...]
    local_rows: Tuple[np.ndarray, ...]
    n_local: int
    n_global_padded: int
    n_global: int
    n_shards: int
    row_ranges: Optional[RowRanges] = None


def ring_partition_csr(a: CSRMatrix, n_shards: int,
                       row_ranges: Optional[RowRanges] = None,
                       exchange: str = "ring") -> RingPartitionedCSR:
    """Split a global CSR matrix for the ring SpMV schedule.

    Starts from ``partition_csr``'s row blocks, then splits each owner's
    entries by column block, padding uniformly across owners per step
    (shapes must match across devices; they may differ between steps).
    A plan's ``row_ranges`` passes straight through: the remapped
    padded-global ``cols`` tile into ``n_local``-sized column blocks by
    construction, so the ring's block arithmetic is unchanged.

    ``exchange`` is validated for interface uniformity with
    ``partition_csr``: the ring layout IS its exchange (full x-block
    rotation), so only ``"ring"`` (or ``"auto"``, which resolves to
    it) is legal here - a gather-exchange layout comes from
    ``partition_csr(exchange="gather")``.
    """
    check_exchange(exchange, ("ring", "auto"), "ring_partition_csr "
                   "(gather/allgather layouts come from partition_csr)")
    rows_part = partition_csr(a, n_shards, row_ranges)
    n_local = rows_part.n_local
    slabs = []
    for s in range(n_shards):
        d, c, r = (rows_part.data[s], rows_part.cols[s],
                   rows_part.local_rows[s])
        live = d != 0
        blk = c // n_local
        per_step = []
        for t in range(n_shards):
            b = (s + t) % n_shards
            sel = live & (blk == b)
            per_step.append((d[sel], c[sel] - b * n_local, r[sel]))
        slabs.append(per_step)

    data, cols, lrows = [], [], []
    for t in range(n_shards):
        m_t = max(1, max(slabs[s][t][0].shape[0] for s in range(n_shards)))
        dt = np.zeros((n_shards, m_t), dtype=rows_part.data.dtype)
        ct = np.zeros((n_shards, m_t), dtype=np.int32)
        rt = np.zeros((n_shards, m_t), dtype=np.int32)
        for s in range(n_shards):
            d, c, r = slabs[s][t]
            k = d.shape[0]
            dt[s, :k] = d
            ct[s, :k] = c
            rt[s, :k] = r
        data.append(dt)
        cols.append(ct)
        lrows.append(rt)
    return RingPartitionedCSR(
        data=tuple(data), cols=tuple(cols), local_rows=tuple(lrows),
        n_local=n_local, n_global_padded=rows_part.n_global_padded,
        n_global=rows_part.n_global, n_shards=n_shards,
        row_ranges=rows_part.row_ranges,
    )


def ring_partition_shiftell(a: CSRMatrix, n_shards: int, *,
                            h: int | None = None, kc: int = 8,
                            row_ranges: Optional[RowRanges] = None):
    """Not ported yet: the ring slabs packed for the shift-ELL SpMV B8
    (``csr_comm="ring-shiftell"``)."""
    raise NotImplementedError(
        "ring_partition_shiftell (the ring-shiftell lane, on B8) is not "
        "ported yet (ROADMAP A10 residue: ring-shiftell)")


def ring_partition_shiftell_df64(a: CSRMatrix, n_shards: int, *,
                                 h: int | None = None, kc: int = 8,
                                 row_ranges: Optional[RowRanges] = None):
    """Not ported yet: the f64 ring slabs for B9."""
    raise NotImplementedError(
        "ring_partition_shiftell_df64 (the f64 ring-shiftell lane, on B9) "
        "is not ported yet (ROADMAP A10 residue: ring-shiftell)")
