"""Contiguous balanced-nnz row splitting (the chains-on-chains problem).

Counterpart of the JAX package's ``balance/nnz_split.py``, its own copy
(host numpy, the same ranges element for element).

The even row split every partitioner shipped with assigns ``ceil(n/P)``
rows per shard regardless of how the nonzeros fall.  On a skewed
unstructured system that is exactly the ``nnz_max_over_mean`` stall
factor shardscope measures: a psum-synchronized loop runs at the speed
of the heaviest shard, every iteration (Bienz et al., arXiv 1612.08060
SS3; Kreutzer et al., arXiv 1112.5588 SS4 make the same observation for
GPU clusters).  This module fixes the *split* half of the problem:
assign each shard a CONTIGUOUS run of rows whose nnz totals are as
equal as the row granularity allows.

Contiguity is not a simplification - it is what keeps the distributed
schedules intact.  Every partitioner in ``parallel.partition`` maps
"shard s owns rows [lo, hi)" onto its collective schedule (block
all_gather, ring x-block rotation); an arbitrary row assignment would
need a gather/scatter layer per matvec.  Contiguous balanced splitting
is the classic chains-on-chains partitioning problem (CCP: place P-1
dividers in a chain of weighted tasks minimizing the max chain weight),
solved here exactly:

* ``balanced_nnz_ranges`` - prefix-sum probe for the optimal bottleneck
  (binary search on the max-shard-nnz value; each feasibility probe is
  a greedy ``searchsorted`` walk over the nnz prefix sums, O(P log n)),
  then a local boundary refinement pass that spreads rows back across
  underfull trailing shards (the greedy walk front-loads) without ever
  increasing the bottleneck;
* ``even_ranges`` - the legacy split as a range tuple, so planners and
  reports can compare the two through one code path.

Variable rows per shard compose with the stacked per-shard tensors'
uniform shapes through padding, not ragged shapes: the partitioners pad
every shard to the max real row count with unit-diagonal rows (see
``parallel.partition``), so a balanced split trades a few padding rows
for the removal of the nnz stall factor.

Host-side numpy only; nothing here touches device state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "balanced_nnz_ranges",
    "even_ranges",
    "range_nnz",
    "validate_ranges",
]

Ranges = Tuple[Tuple[int, int], ...]


def even_ranges(n: int, n_shards: int) -> Ranges:
    """The legacy even row split as ``((lo, hi), ...)`` ranges.

    Matches ``partition.partition_csr``'s default layout exactly:
    ``ceil(n / P)`` rows per shard, trailing shards short (possibly
    empty when ``P > n``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_local = -(-n // n_shards) if n else 0
    return tuple(
        (min(s * n_local, n), min((s + 1) * n_local, n))
        for s in range(n_shards))


def range_nnz(indptr: np.ndarray, ranges: Ranges) -> np.ndarray:
    """Live matrix entries per range, straight off the CSR indptr."""
    c = np.asarray(indptr, dtype=np.int64)
    return np.array([int(c[hi] - c[lo]) for lo, hi in ranges],
                    dtype=np.int64)


def validate_ranges(ranges, n: int, n_shards: int) -> Ranges:
    """Check that ``ranges`` is a contiguous cover of ``[0, n)`` with one
    (possibly empty) range per shard; returns the normalized tuple."""
    ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
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


def _feasible(c: np.ndarray, n: int, n_shards: int, bottleneck: int,
              max_local_rows: Optional[int]) -> bool:
    """Can P greedy chains each holding <= ``bottleneck`` nnz (and
    optionally <= ``max_local_rows`` rows) cover all n rows?"""
    start = 0
    for _ in range(n_shards):
        if start >= n:
            return True
        end = int(np.searchsorted(c, c[start] + bottleneck,
                                  side="right")) - 1
        if max_local_rows is not None:
            end = min(end, start + max_local_rows)
        if end <= start:
            return False  # a single row exceeds the probe bottleneck
        start = end
    return start >= n


def _greedy_boundaries(c: np.ndarray, n: int, n_shards: int,
                       bottleneck: int,
                       max_local_rows: Optional[int]) -> np.ndarray:
    bounds = np.zeros(n_shards + 1, dtype=np.int64)
    start = 0
    for s in range(n_shards):
        if start < n:
            end = int(np.searchsorted(c, c[start] + bottleneck,
                                      side="right")) - 1
            if max_local_rows is not None:
                end = min(end, start + max_local_rows)
            end = max(end, start + 1)
            start = min(end, n)
        bounds[s + 1] = start
    bounds[n_shards] = n
    return bounds


def _refine_boundaries(c: np.ndarray, bounds: np.ndarray,
                       max_local_rows: Optional[int]) -> np.ndarray:
    """Local divider refinement: slide each internal boundary while it
    strictly improves ``(max nnz, max rows)`` of the two adjacent
    chains.  The greedy walk that seeded ``bounds`` front-loads shards
    (trailing shards can come out empty); this pass spreads rows back
    without ever increasing the global bottleneck - each move is
    accepted only if the local pairwise maximum decreases, and the
    global max over shards is the max of those pairwise maxima."""
    bounds = bounds.copy()
    n_shards = len(bounds) - 1

    def cost(lo, mid, hi):
        left = (int(c[mid] - c[lo]), mid - lo)
        right = (int(c[hi] - c[mid]), hi - mid)
        return max(left, right)

    for _ in range(2 * n_shards):
        moved = False
        for s in range(1, n_shards):
            lo, mid, hi = int(bounds[s - 1]), int(bounds[s]), \
                int(bounds[s + 1])
            best_mid, best_cost = mid, cost(lo, mid, hi)
            for cand in (mid - 1, mid + 1):
                if cand < lo or cand > hi:
                    continue
                if max_local_rows is not None and (
                        cand - lo > max_local_rows
                        or hi - cand > max_local_rows):
                    continue
                cc = cost(lo, cand, hi)
                if cc < best_cost:
                    best_mid, best_cost = cand, cc
            if best_mid != mid:
                bounds[s] = best_mid
                moved = True
        if not moved:
            break
    return bounds


def balanced_nnz_ranges(indptr, n_shards: int, *,
                        max_local_rows: Optional[int] = None) -> Ranges:
    """Contiguous row ranges minimizing the max per-shard nnz.

    Args:
      indptr: CSR row-pointer array of the GLOBAL matrix (n + 1 long).
      n_shards: number of contiguous chains to cut.
      max_local_rows: optional cap on real rows per shard.  The padded
        local size every shard allocates is ``max_s (hi_s - lo_s)``
        (the stacked per-shard tensors have uniform shapes), so an uncapped split of a
        matrix with a dense block plus a long light tail can hand one
        shard most of the ROWS and inflate everyone's padding; the cap
        bounds that trade.  When the cap makes the instance infeasible
        (``P * cap < n``) it is ignored.

    Returns:
      ``((lo_0, hi_0), ..., (lo_{P-1}, hi_{P-1}))`` tiling ``[0, n)``.
      The bottleneck (max per-shard nnz) is exactly optimal among
      contiguous splits for the given cap; the refinement pass then
      evens out rows at equal bottleneck.
    """
    c = np.asarray(indptr, dtype=np.int64)
    n = int(c.shape[0]) - 1
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n <= 0 or n_shards == 1:
        return validate_ranges(even_ranges(n, n_shards), n, n_shards)
    if max_local_rows is not None and max_local_rows * n_shards < n:
        max_local_rows = None  # cap infeasible: ignore, keep covering
    total = int(c[n])
    row_nnz_max = int(np.max(c[1:] - c[:-1]))
    lo_b = max(row_nnz_max, -(-total // n_shards))
    hi_b = total
    # binary search the optimal bottleneck; the row cap can make a
    # bottleneck infeasible that pure nnz would accept, so probe with
    # both constraints applied
    while lo_b < hi_b:
        mid = (lo_b + hi_b) // 2
        if _feasible(c, n, n_shards, mid, max_local_rows):
            hi_b = mid
        else:
            lo_b = mid + 1
    bounds = _greedy_boundaries(c, n, n_shards, lo_b, max_local_rows)
    bounds = _refine_boundaries(c, bounds, max_local_rows)
    ranges = tuple((int(bounds[s]), int(bounds[s + 1]))
                   for s in range(n_shards))
    return validate_ranges(ranges, n, n_shards)
