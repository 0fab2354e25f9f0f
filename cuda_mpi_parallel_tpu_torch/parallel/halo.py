"""Halo exchange over the mesh: neighbour shifts by ``ppermute``.

Counterpart of the JAX package's ``parallel/halo.py``, with its
semantics: each shard owns a contiguous block of grid planes, and a 5/7
point stencil at the block's edge needs one plane from each neighbour.
``ppermute``'s zeros for unmatched destinations give the Dirichlet zero
at the global domain edges.  Inside a comm scope a block carries the
shard axis first (``(L, local_n, ...)``, ``parallel.comm``), and so do
its halos.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import comm as cm


def validate_permutation(perm, n_shards=None):
    """Reject permutation lists with duplicate sources or destinations
    (two sources racing into one destination are undefined), and with
    ``n_shards`` any id outside ``[0, n_shards)``.  Returns ``perm`` as
    a list."""
    perm = list(perm)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs):
        raise ValueError(
            f"ppermute permutation lists a source twice (each device "
            f"can send at most once): {perm}")
    if len(set(dsts)) != len(dsts):
        raise ValueError(
            f"ppermute permutation lists a destination twice (two "
            f"sources racing into one destination is undefined): "
            f"{perm}")
    if n_shards is not None:
        bad = [(s, d) for s, d in perm
               if not (0 <= s < n_shards and 0 <= d < n_shards)]
        if bad:
            raise ValueError(
                f"ppermute permutation references device ids outside "
                f"[0, {n_shards}): {bad}")
    return perm


def rotation_perm(n_shards: int, shift: int):
    """The validated ring rotation ``j -> (j + shift) % n_shards``."""
    if not 1 <= shift < n_shards:
        raise ValueError(
            f"rotation shift must be in [1, n_shards); got shift="
            f"{shift} with n_shards={n_shards} (shift 0 is a self-send "
            f"carrying no halo)")
    return validate_permutation(
        ((j, (j + shift) % n_shards) for j in range(n_shards)),
        n_shards=n_shards)


def neighbor_shift_perms(n_shards: int):
    """(forward, backward) permutation lists for a 1-D non-periodic
    chain: forward ``i -> i+1`` (a shard receives its lower neighbour's
    boundary), backward ``i -> i-1``.  Edge shards receive zeros."""
    fwd = validate_permutation(
        (i, i + 1) for i in range(n_shards - 1))
    bwd = validate_permutation(
        (i, i - 1) for i in range(1, n_shards))
    return fwd, bwd


def _scope(axis_name):
    """The comm bound to ``axis_name``, or None outside every scope."""
    try:
        return cm.resolve(axis_name)
    except NameError:
        return None


def exchange_halo(u: torch.Tensor, axis_name: str,
                  n_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange boundary slabs of a block partitioned on its leading axis.

    ``u``: the local block ``(local_n, ...)``; inside a comm scope it
    carries the shard axis in front, ``(L, local_n, ...)``.  Returns
    ``(lo, hi)``: the previous shard's last plane (zeros on shard 0) and
    the next shard's first plane (zeros on the last shard), with extent 1
    along the block axis.  ``n_shards == 1`` returns zeros without a
    collective (and, as in the JAX package, needs no scope)."""
    comm = _scope(axis_name)
    if comm is None:
        if n_shards != 1:
            raise NameError(f"unbound axis name: {axis_name}")
        zero = torch.zeros_like(u[:1])
        return zero, zero
    if n_shards == 1:
        zero = torch.zeros_like(u[:, :1])
        return zero, zero
    fwd, bwd = neighbor_shift_perms(n_shards)
    lo = comm.ppermute(u[:, -1:], fwd)
    hi = comm.ppermute(u[:, :1], bwd)
    return lo, hi


def exchange_halo_axis(u: torch.Tensor, axis_name: str, n_shards: int,
                       dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`exchange_halo` along the block's local dimension ``dim``:
    ``(lo, hi)`` shaped like ``u`` with extent 1 along ``dim``."""
    if dim == 0:
        return exchange_halo(u, axis_name, n_shards)
    off = 0 if _scope(axis_name) is None else 1
    um = torch.movedim(u, dim + off, off)
    lo, hi = exchange_halo(um, axis_name, n_shards)
    return torch.movedim(lo, off, dim + off), torch.movedim(hi, off, dim + off)
