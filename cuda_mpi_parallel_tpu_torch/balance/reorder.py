"""SPD-preserving symmetric reorderings for partition planning.

Counterpart of the JAX package's ``balance/reorder.py``, its own copy
(host numpy/heapq, the same permutations element for element).

A contiguous row split (``nnz_split``) balances *work*; the *halo* a
shard exchanges is set by how many of its matrix columns live on other
shards, which is a property of the ORDERING.  Symmetric permutations
``P A P^T`` preserve symmetry and positive-definiteness exactly (the
spectrum is invariant), so the solver sees the same conditioning while
the partition sees a matrix whose couplings are concentrated near the
diagonal - cross-shard references collapse to the shards' boundary
neighborhoods, which is the node-aware-SpMV result (arXiv 1612.08060):
balanced rows plus bandwidth-reducing order is what converts a measured
stall factor into recovered wall time.

Two orderings, both returning ``perm[new] = old`` (the convention of
``CSRMatrix.permuted`` / ``CSRMatrix.rcm_permutation``):

* ``rcm_reorder`` - reverse Cuthill-McKee, delegating to the operator's
  scipy path (``CSRMatrix.rcm_permutation``).  The classic bandwidth
  reducer; after it, a contiguous split's cross-shard columns shrink
  to O(bandwidth) per boundary.
* ``greedy_nnz_reorder`` - a greedy envelope-reduction variant that is
  *nnz-aware*: grow the ordering one row at a time, always appending
  the unordered row with the most already-ordered neighbors
  (maximizing locality of the coupling), breaking ties toward lighter
  rows so heavy rows spread through the order instead of clumping at a
  BFS frontier the splitter then has to cut through.  Component seeds
  are min-degree rows (the RCM heuristic).

Host-side numpy/heapq; O(nnz log n).
"""
from __future__ import annotations

import heapq

import numpy as np

from ..parallel.partition import _host

__all__ = [
    "greedy_nnz_reorder",
    "inverse_permutation",
    "rcm_reorder",
]


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv`` with ``inv[perm[i]] = i``: maps an old index to its new
    position.  ``x_original = x_permuted[inv]`` undoes a solve in the
    permuted ordering (``CSRMatrix.permuted`` docstring)."""
    perm = np.asarray(perm)
    inv = np.empty(perm.shape[0], dtype=np.int64)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return inv


def rcm_reorder(a) -> np.ndarray:
    """Reverse Cuthill-McKee via the operator's own scipy path."""
    return np.asarray(a.rcm_permutation(), dtype=np.int64)


def greedy_nnz_reorder(a) -> np.ndarray:
    """Greedy max-adjacency, light-rows-first envelope ordering.

    At every step append the unordered row with the most neighbors
    already ordered; among equals prefer the row with fewer total
    entries.  Seeds (per connected component) are min-degree rows.
    A lazy-deletion heap keeps it O(nnz log n) - stale heap entries
    are skipped when their recorded adjacency no longer matches.
    """
    indptr = _host(a.indptr).astype(np.int64)
    indices = _host(a.indices).astype(np.int64)
    n = int(indptr.shape[0]) - 1
    degree = indptr[1:] - indptr[:-1]
    placed = np.zeros(n, dtype=bool)
    adjacency = np.zeros(n, dtype=np.int64)  # ordered-neighbor count
    order = np.empty(n, dtype=np.int64)
    heap: list = []
    seed_order = np.argsort(degree, kind="stable")
    seed_pos = 0
    count = 0
    while count < n:
        while heap:
            neg_adj, deg, row = heapq.heappop(heap)
            if not placed[row] and -neg_adj == adjacency[row]:
                break
        else:
            # heap empty (or all stale): seed the next component with
            # the lightest unplaced row
            while placed[seed_order[seed_pos]]:
                seed_pos += 1
            row = int(seed_order[seed_pos])
        placed[row] = True
        order[count] = row
        count += 1
        for nb in indices[indptr[row]:indptr[row + 1]]:
            nb = int(nb)
            if nb == row or placed[nb]:
                continue
            adjacency[nb] += 1
            heapq.heappush(heap,
                           (-int(adjacency[nb]), int(degree[nb]), nb))
    return order
