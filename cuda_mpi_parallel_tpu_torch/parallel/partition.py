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
even split.  The planner that makes such ranges is
``balance.plan_partition`` (the ``plan=`` argument of the distributed
CSR lanes).

The ring shift-ELL partitioners pack each ring slab for the hand SpMV
(B8, and B9 in float64) in Hopper's sliced ELL, not the TPU's sheets.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..models.operators import CSRMatrix, _layout_hints
from ..ops.cuda.spmv import (
    SLICE,
    SlicedELL,
    pack_sliced_ell,
    unpack_sliced_ell,
)


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


def plan_gather_indices(n: int, n_shards: int, plan=None) -> np.ndarray:
    """``g`` with ``x_caller = x_padded[g]`` for the layout of a
    ``balance.PartitionPlan`` (``None``: the even split): the padding
    strip (:func:`layout_gather_indices`) yields the plan's PERMUTED
    ordering, then the plan's inverse permutation restores the caller's
    row order - one fused gather.  The map ``dist_cg`` applies to a
    returned ``x`` and the elastic migration lifts a checkpoint
    through."""
    ranges = plan.row_ranges if plan is not None else None
    idx = layout_gather_indices(n, n_shards, ranges)
    inv = plan.inverse_permutation() if plan is not None else None
    return idx if inv is None else idx[inv]


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


class RingPartitionedShiftELL(NamedTuple):
    """Ring-schedule slabs packed for the hand SpMV B8.

    The communication structure of ``RingPartitionedCSR``: one slab per
    (owner, step), owner ``i``'s step-``t`` slab coupling to column
    block ``(i + t) % n_shards``, columns relative to the block's start.
    Each slab is packed in Hopper's sliced ELL
    (``ops.cuda.spmv.pack_sliced_ell``) over its ``n_local`` rows, in
    place of the TPU's shift-ELL sheets: ``vals[t][s]``, ``cols[t][s]``
    and ``slice_ptr[t][s]`` are owner ``s``'s step-``t`` arrays (ragged:
    no shape needs to match across owners).  :func:`stack_ring_step`
    packs the slabs of several owners as one sliced ELL over their
    stacked rows - one launch a step on a stacked mesh.  ``h``/``kc``
    are the TPU sheet geometry, kept as given and read by nothing.
    """

    vals: Tuple[Tuple[np.ndarray, ...], ...]
    cols: Tuple[Tuple[np.ndarray, ...], ...]
    slice_ptr: Tuple[Tuple[np.ndarray, ...], ...]
    diag: np.ndarray            # (n_shards, n_local) - Jacobi's input
    h: Optional[int]
    kc: int
    n_local: int
    n_global_padded: int
    n_global: int
    n_shards: int
    row_ranges: Optional[RowRanges] = None


class RingPartitionedShiftELLDF64(NamedTuple):
    """The f64 sibling of :class:`RingPartitionedShiftELL`, for B9: the
    same slabs with float64 values and diagonal (the JAX package's
    ``(hi, lo)`` f32 planes, which :attr:`diag_hi`/:attr:`diag_lo`
    still give for the diagonal)."""

    vals: Tuple[Tuple[np.ndarray, ...], ...]
    cols: Tuple[Tuple[np.ndarray, ...], ...]
    slice_ptr: Tuple[Tuple[np.ndarray, ...], ...]
    diag: np.ndarray            # (n_shards, n_local) float64
    h: Optional[int]
    kc: int
    n_local: int
    n_global_padded: int
    n_global: int
    n_shards: int
    row_ranges: Optional[RowRanges] = None

    @property
    def diag_hi(self) -> np.ndarray:
        return self.diag.astype(np.float32)

    @property
    def diag_lo(self) -> np.ndarray:
        return (self.diag - self.diag_hi.astype(np.float64)).astype(
            np.float32)


def _ring_pack_slabs(a: CSRMatrix, n_shards: int, h, kc, *, lift,
                     row_ranges=None):
    """Shared core of the ring shift-ELL partitioners: ring-split ``a``,
    rebuild each (owner, step) slab as CSR without the zero padding
    entries (``lift`` maps its values to the packing dtype) and pack it
    in sliced ELL.  Returns ``(ring, steps)`` with ``steps[t][s]`` owner
    ``s``'s packed step-``t`` slab."""
    _layout_hints(h, kc)
    ring = ring_partition_csr(a, n_shards, row_ranges)
    n_local = ring.n_local

    def slab(t, s):
        d = lift(ring.data[t][s])
        c, r = ring.cols[t][s], ring.local_rows[t][s]
        live = d != 0
        d, c, r = d[live], c[live], r[live]
        order = np.argsort(r, kind="stable")
        indptr = np.zeros(n_local + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(r, minlength=n_local))
        return pack_sliced_ell(indptr, c[order].astype(np.int32), d[order],
                               n_local)

    steps = [[slab(t, s) for s in range(n_shards)] for t in range(n_shards)]
    return ring, steps


def _padded_diag(a: CSRMatrix, ring, dtype) -> np.ndarray:
    """The padded global diagonal (Jacobi's input): scattered through
    the variable-row layout when the split is plan-driven, appended
    unit entries on the even split's tail otherwise.  Padding rows are
    unit-diagonal either way."""
    rows = (gather_indices(ring.row_ranges, ring.n_local)
            if ring.row_ranges is not None else slice(0, ring.n_global))
    diag = np.ones(ring.n_global_padded, dtype=dtype)
    diag[rows] = _host(a.diagonal())
    return diag


def _ring_fields(steps):
    return tuple(tuple(tuple(getattr(p, f) for p in ps) for ps in steps)
                 for f in ("vals", "cols", "slice_ptr"))


def ring_partition_shiftell_df64(a: CSRMatrix, n_shards: int, *,
                                 h: int | None = None, kc: int = 8,
                                 row_ranges: Optional[RowRanges] = None
                                 ) -> RingPartitionedShiftELLDF64:
    """Ring-split + f64 sliced-ELL packing (see ring_partition_shiftell):
    the matrix values are lifted to float64 on the host before packing,
    so f64-valued problems keep their low bits and f32 data packs
    exactly."""
    ring, steps = _ring_pack_slabs(
        a, n_shards, h, kc, row_ranges=row_ranges,
        lift=lambda d: np.asarray(d, dtype=np.float64))
    vals, cols, slice_ptr = _ring_fields(steps)
    return RingPartitionedShiftELLDF64(
        vals=vals, cols=cols, slice_ptr=slice_ptr,
        diag=_padded_diag(a, ring, np.float64).reshape(n_shards,
                                                       ring.n_local),
        h=h, kc=kc, n_local=ring.n_local,
        n_global_padded=ring.n_global_padded, n_global=ring.n_global,
        n_shards=n_shards, row_ranges=ring.row_ranges)


def ring_partition_shiftell(a: CSRMatrix, n_shards: int, *,
                            h: int | None = None, kc: int = 8,
                            row_ranges: Optional[RowRanges] = None
                            ) -> RingPartitionedShiftELL:
    """Ring-split ``a`` and pack every (owner, step) slab in sliced ELL
    for B8 (``csr_comm="ring-shiftell"``).

    Each slab is an ``n_local x n_local`` sparse block holding its
    entries in CSR order, so a row adds its slots in the order
    ``ring_partition_csr`` keeps them.  ``h``/``kc`` (the JAX sheet
    geometry: block height, chunk width) are checked and ignored, as
    ``ShiftELLMatrix.from_csr`` does.
    """
    ring, steps = _ring_pack_slabs(a, n_shards, h, kc, lift=lambda d: d,
                                   row_ranges=row_ranges)
    vals, cols, slice_ptr = _ring_fields(steps)
    dtype = np.asarray(ring.data[0]).dtype
    return RingPartitionedShiftELL(
        vals=vals, cols=cols, slice_ptr=slice_ptr,
        diag=_padded_diag(a, ring, dtype).reshape(n_shards, ring.n_local),
        h=h, kc=kc, n_local=ring.n_local,
        n_global_padded=ring.n_global_padded, n_global=ring.n_global,
        n_shards=n_shards, row_ranges=ring.row_ranges)


def stack_ring_step(parts, t: int, shard_ids):
    """One sliced ELL of the step-``t`` slabs of the owners ``shard_ids``
    (a stacked mesh's every shard, or a rank's one) over their stacked
    rows: owner ``shard_ids[k]``'s rows and columns move by ``k *
    n_local``, so the product against the resident x-blocks, flattened
    shard-major, is each owner's slab product in turn.  A row keeps its
    slots in order, so the bits are those of the separate products.
    When ``n_local`` is a whole number of slices no slice holds rows of
    two owners, and the stacked pack is the owners' packs end to end."""
    n_local = parts.n_local
    if n_local % SLICE == 0:
        vals, cols, ptrs, base = [], [], [np.zeros(1, dtype=np.int64)], 0
        for k, s in enumerate(shard_ids):
            c = np.asarray(parts.cols[t][s])
            ptr = np.asarray(parts.slice_ptr[t][s], dtype=np.int64)
            vals.append(np.asarray(parts.vals[t][s]))
            cols.append(np.where(c >= 0, c + k * n_local, c).astype(
                np.int32))
            ptrs.append(ptr[1:] + base)
            base += int(ptr[-1])
        return SlicedELL(vals=np.concatenate(vals),
                         cols=np.concatenate(cols),
                         slice_ptr=np.concatenate(ptrs),
                         n=len(shard_ids) * n_local)
    indptr, indices, data = [np.zeros(1, dtype=np.int64)], [], []
    for k, s in enumerate(shard_ids):
        ip, ix, d = unpack_sliced_ell(SlicedELL(
            vals=parts.vals[t][s], cols=parts.cols[t][s],
            slice_ptr=parts.slice_ptr[t][s], n=n_local))
        indptr.append(ip[1:] + indptr[-1][-1])
        indices.append(ix + k * n_local)
        data.append(d)
    return pack_sliced_ell(np.concatenate(indptr),
                           np.concatenate(indices).astype(np.int32),
                           np.concatenate(data), len(shard_ids) * n_local)
