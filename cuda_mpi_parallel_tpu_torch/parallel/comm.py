"""The port's collectives: ``psum``, ``ppermute`` and ``all_gather`` over
a mesh axis, and the scope that binds an axis name to them.

Counterpart of what the JAX package gets from ``jax.shard_map``
(``utils/compat.shard_map``) and the ``lax`` collectives inside it.  A
per-shard body names a mesh axis (``axis_name="rows"``); the parallel
entry points run that body inside :func:`shard_map` (or
:func:`bind`), which puts the mesh's comm in scope, and
:func:`resolve` finds it again - ``ops.blas1``'s dots, the halo
exchange and the distributed operators all reduce or move data through
it.  Outside any scope a named axis raises ``NameError``, as ``lax.psum``
does outside ``shard_map``.

Two backends:

* :class:`StackedComm` - the P shards of a mesh whose devices repeat one
  device, in one process.  Every per-shard tensor carries the shard axis
  first: a sharded vector is ``(P, n_local, ...)`` (or its flat
  ``(P * n_local,)``, which is shard-major).  ``psum`` adds the per-shard
  values in shard order 0, 1, ..., P - 1; ``ppermute`` is an indexed
  roll whose unmatched destinations get zeros, as ``lax.ppermute``
  gives; ``all_gather`` is a reshape.  The CPU parity tests run on it,
  and on the card it runs P shards on one device.
* :class:`ProcessGroupComm` - one rank per device over
  ``torch.distributed``: gloo on the CPU, NCCL on the card.  A
  per-shard tensor carries a shard axis of length 1.  ``psum`` is an
  ``all_gather`` of the partials and then the same shard-order sum -
  never a bare ``all_reduce``, whose order NCCL does not fix - so both
  backends give the same bits; ``ppermute`` is ``batch_isend_irecv``.

Each comm counts its collectives in ``counts`` (one per call), which is
how a test sees that a cg1 iteration makes one reduction.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Sequence, Tuple

import torch


def _fold(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ... + parts[-1]``, left to right: the one
    summation order of every psum, whichever backend holds the parts."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


class StackedComm:
    """``n_shards`` shards of one mesh axis, all in this process on
    ``device``: per-shard tensors are stacked along a leading shard
    axis."""

    kind = "stacked"

    def __init__(self, n_shards: int, device) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        self.counts: collections.Counter = collections.Counter()

    @property
    def local_count(self) -> int:
        """Shards held by this process (the leading axis of a per-shard
        tensor)."""
        return self.n_shards

    @property
    def shard_ids(self) -> Tuple[int, ...]:
        return tuple(range(self.n_shards))

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        """Sum the per-shard values ``v[s]`` in shard order; the result
        (without the shard axis) is what every shard holds."""
        self.counts["psum"] += 1
        return _fold(list(v.unbind(0)))

    def ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        """``out[d] = v[s]`` for each ``(s, d)`` of ``perm``; a shard no
        pair sends to gets zeros."""
        self.counts["ppermute"] += 1
        out = torch.zeros_like(v)
        for src, dst in perm:
            out[dst] = v[src]
        return out

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """The shards' blocks ``(P, n_local, ...)`` concatenated along
        their first axis (``lax.all_gather(..., tiled=True)``)."""
        self.counts["all_gather"] += 1
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def local_vector(self, x_global: torch.Tensor) -> torch.Tensor:
        """This process's part of a global row-partitioned vector: all of
        it, in the stacked layout."""
        return x_global

    def global_vector(self, x_local: torch.Tensor) -> torch.Tensor:
        """The global vector from this process's part (already global)."""
        return x_local


class ProcessGroupComm:
    """One shard per rank of the ``torch.distributed`` default process
    group (gloo on the CPU, NCCL on the card, where each rank drives its
    current CUDA device); per-shard tensors carry a shard axis of
    length 1."""

    kind = "distributed"

    def __init__(self) -> None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupComm needs torch.distributed.init_process_group "
                "first (give it the address, world size and rank)")
        self.n_shards = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        self.counts: collections.Counter = collections.Counter()

    @property
    def local_count(self) -> int:
        return 1

    @property
    def shard_ids(self) -> Tuple[int, ...]:
        return (self.rank,)

    def _gather_parts(self, t: torch.Tensor):
        import torch.distributed as dist

        flat = t.contiguous().reshape(-1)     # 0-d partials gather as (1,)
        parts = [torch.empty_like(flat) for _ in range(self.n_shards)]
        dist.all_gather(parts, flat)
        return [part.reshape(t.shape) for part in parts]

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        self.counts["psum"] += 1
        return _fold(self._gather_parts(v[0]))

    def ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        import torch.distributed as dist

        self.counts["ppermute"] += 1
        out = torch.zeros_like(v)
        ops, recv = [], None
        for src, dst in perm:
            if src == self.rank:
                ops.append(dist.P2POp(dist.isend, v[0].contiguous(), dst))
            if dst == self.rank:
                recv = torch.empty_like(v[0])
                ops.append(dist.P2POp(dist.irecv, recv, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            out[0] = recv
        return out

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        self.counts["all_gather"] += 1
        return torch.cat(self._gather_parts(v[0]), dim=0)

    def local_vector(self, x_global: torch.Tensor) -> torch.Tensor:
        return x_global.reshape((self.n_shards, -1)
                                + tuple(x_global.shape[1:]))[self.rank]

    def global_vector(self, x_local: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._gather_parts(x_local), dim=0)


# -- the scope: which comm an axis name means ---------------------------------

_SCOPES = threading.local()


def _stack() -> list:
    if not hasattr(_SCOPES, "frames"):
        _SCOPES.frames = []
    return _SCOPES.frames


@contextlib.contextmanager
def bind(mesh):
    """Put ``mesh``'s comm in scope under each of its axis names for the
    body of the ``with`` (what ``shard_map`` does for its function)."""
    frames = _stack()
    frames.append({name: mesh.comm for name in mesh.axis_names})
    try:
        yield mesh.comm
    finally:
        frames.pop()


def resolve(axis_name):
    """The comm bound to ``axis_name`` by the innermost scope naming it.
    A tuple of several axes (a pencil mesh) is not ported (ROADMAP A10
    residue)."""
    if isinstance(axis_name, (tuple, list)):
        if len(axis_name) != 1:
            raise NotImplementedError(
                f"axis_name={tuple(axis_name)!r}: reductions over several "
                f"mesh axes (a pencil mesh) are not ported yet (ROADMAP "
                f"A10 residue: pencil meshes)")
        axis_name = axis_name[0]
    for frame in reversed(_stack()):
        if axis_name in frame:
            return frame[axis_name]
    raise NameError(f"unbound axis name: {axis_name}")


def local_count(axis_name) -> int:
    """Shards of ``axis_name`` this process holds: the length of a
    per-shard tensor's leading axis (1 outside any scope: a lone local
    block, as the JAX operators see one)."""
    try:
        return resolve(axis_name).local_count
    except NameError:
        return 1


def shard_ids(axis_name) -> Tuple[int, ...]:
    """The mesh positions of this process's shards of ``axis_name``."""
    try:
        return resolve(axis_name).shard_ids
    except NameError:
        return (0,)


def shard_map(f=None, *, mesh, in_specs=None, out_specs=None,
              check_vma: bool = True, **kwargs):
    """Run ``f`` as the per-shard body over ``mesh`` (the port of
    ``utils/compat.shard_map``; the decorator-factory form, ``f``
    omitted, works too).

    The body is called once per process with its arguments as given:
    the port's entry points lay out the per-shard tensors themselves
    (stacked ``(P, ...)`` on a stacked mesh, the rank's block on a
    process group), so ``in_specs``/``out_specs`` are accepted for the
    JAX surface and not read, and ``check_vma`` has no counterpart."""
    if f is None:
        def wrap(fn):
            return shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=check_vma,
                             **kwargs)
        return wrap

    def run(*args, **kw):
        with bind(mesh):
            return f(*args, **kw)
    return run


__all__ = ["ProcessGroupComm", "StackedComm", "bind", "local_count",
           "resolve", "shard_ids", "shard_map"]
