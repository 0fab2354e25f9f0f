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

On a 2-D (pencil) mesh of ``sx x sy`` shards the per-shard tensors keep
ONE leading shard axis of ``sx * sy``, shard ``(i, j)`` at ``i * sy + j``
(shard-major, as on a 1-D mesh).  Each axis name resolves to an
:class:`AxisComm`, a view that moves data along that axis only, within
each row or column of the mesh; the tuple of both names resolves to the
whole mesh's comm, whose ``psum`` folds all ``sx * sy`` partials in shard
order.

Each comm counts its collectives in ``counts`` (one per call; an axis
view counts in its mesh comm's), which is how a test sees that a cg1
iteration makes one reduction.  While a :class:`CommRecorder` is active
(``telemetry.cost.trace_solve_cost``), each collective also records its
per-device payload and wire bytes, and the solver loops mark their trips
(:func:`loop_trips`); with no recorder active, both are a no-op.
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


# -- the cost recorder ----------------------------------------------------------


class CommRecorder:
    """The collectives of one recorded run, each ``(name, payload bytes,
    wire bytes, where)``: ``where`` is ``None`` outside the solver loops,
    else ``(loop, trip)`` - the top-level loop's index in order of entry
    and the trip within it (``solver.cg._blocked_while`` marks them).

    Bytes follow the JAX package's ``telemetry.cost``: the payload is one
    shard's input block (a halo ``ppermute`` ships one boundary plane,
    a ``psum`` its partials), and the wire bytes, counted for the
    data-movement collectives only, are what crosses links per device -
    a ``ppermute`` its payload, an ``all_gather`` its output less its
    input."""

    def __init__(self) -> None:
        self.events: list = []
        self.trips: list = []     # every (loop, trip) marked, in order
        self.n_loops = 0
        self._where = None
        self._depth = 0
        #: called with ``(loop, trip)`` as each top-level trip starts
        self.on_trip = None

    def note(self, name: str, payload: int, n_parts: int) -> None:
        wire = {"all_gather": payload * (n_parts - 1),
                "ppermute": payload}.get(name, 0)
        self.events.append((name, payload, wire, self._where))


_RECORDING = threading.local()


def active_recorder():
    """The innermost active :class:`CommRecorder`, or ``None``."""
    stack = getattr(_RECORDING, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording():
    """Record every collective of the ``with`` body (and the solver
    loops' trips) into a fresh :class:`CommRecorder`, yielded.  Records
    nest: an enclosing recorder sees the same collectives and trips."""
    if not hasattr(_RECORDING, "stack"):
        _RECORDING.stack = []
    rec = CommRecorder()
    _RECORDING.stack.append(rec)
    try:
        yield rec
    finally:
        _RECORDING.stack.pop()


@contextlib.contextmanager
def loop_trips():
    """Scope of one solver ``while`` loop: yields ``trip()``, which the
    loop calls at the start of each trip, or ``None`` with no recorder
    active (the loop then runs exactly as unrecorded).  Only top-level
    loops count: a loop inside another's trip leaves its parent's
    trip marked."""
    recs = list(getattr(_RECORDING, "stack", None) or ())
    if not recs:
        yield None
        return
    loops = []
    for rec in recs:
        rec._depth += 1
        loop = None
        if rec._depth == 1:
            loop = rec.n_loops
            rec.n_loops += 1
        loops.append(loop)
    trips = [0]

    def trip() -> None:
        for rec, loop in zip(recs, loops):
            if loop is not None:
                rec._where = (loop, trips[0])
                rec.trips.append(rec._where)
                if rec.on_trip is not None:
                    rec.on_trip(rec._where)
        trips[0] += 1
    try:
        yield trip
    finally:
        for rec, loop in zip(recs, loops):
            rec._depth -= 1
            if loop is not None:
                rec._where = None


def _note(comm, name: str, v: torch.Tensor) -> None:
    """Count one collective of ``comm`` and, with recorders active,
    record it in each with one shard's block of ``v`` (its leading axis
    the shards) as its payload - sized from the shape, so a recorded
    solve runs no extra operation."""
    comm.counts[name] += 1
    recs = getattr(_RECORDING, "stack", None)
    if recs:
        payload = v.numel() // max(int(v.shape[0]), 1) * v.element_size()
        for rec in recs:
            rec.note(name, payload, comm.n_shards)


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
        _note(self, "psum", v)
        return _fold(list(v.unbind(0)))

    def ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        """``out[d] = v[s]`` for each ``(s, d)`` of ``perm``; a shard no
        pair sends to gets zeros."""
        _note(self, "ppermute", v)
        return self._ppermute(v, perm)

    def _ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        out = torch.zeros_like(v)
        for src, dst in perm:
            out[dst] = v[src]
        return out

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """The shards' blocks ``(P, n_local, ...)`` concatenated along
        their first axis (``lax.all_gather(..., tiled=True)``)."""
        _note(self, "all_gather", v)
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _all_blocks(self, v: torch.Tensor):
        """Every shard's block of ``v``, by global shard id."""
        return list(v.unbind(0))

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
        _note(self, "psum", v)
        return _fold(self._gather_parts(v[0]))

    def ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        _note(self, "ppermute", v)
        return self._ppermute(v, perm)

    def _ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        import torch.distributed as dist

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
        _note(self, "all_gather", v)
        return torch.cat(self._gather_parts(v[0]), dim=0)

    def _all_blocks(self, v: torch.Tensor):
        return self._gather_parts(v[0])

    def local_vector(self, x_global: torch.Tensor) -> torch.Tensor:
        return x_global.reshape((self.n_shards, -1)
                                + tuple(x_global.shape[1:]))[self.rank]

    def global_vector(self, x_local: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._gather_parts(x_local), dim=0)


class AxisComm:
    """One axis of a 2-D mesh's comm (``axis`` 0 or 1 of ``shape = (sx,
    sy)``): ``ppermute`` and ``all_gather`` along that axis only, each row
    or column of the mesh on its own (the reductions name both axes and
    take the mesh comm).  Tensors keep the mesh comm's layout (one leading
    shard axis of ``sx * sy``, shard ``(i, j)`` at ``i * sy + j``), and
    the collectives count in the mesh comm's ``counts``.

    ``shard_ids`` are this process's shards' indices ALONG the axis (the
    ``lax.axis_index`` counterpart); ``n_shards`` is the axis' size."""

    def __init__(self, comm, shape, axis: int) -> None:
        self.comm = comm
        self.shape = tuple(int(s) for s in shape)
        self.axis = int(axis)
        self.n_shards = self.shape[self.axis]

    kind = property(lambda self: self.comm.kind)
    device = property(lambda self: self.comm.device)
    counts = property(lambda self: self.comm.counts)
    local_count = property(lambda self: self.comm.local_count)

    @property
    def shard_ids(self) -> Tuple[int, ...]:
        sy = self.shape[1]
        return tuple(s // sy if self.axis == 0 else s % sy
                     for s in self.comm.shard_ids)

    def _line(self, s: int) -> list:
        """The global ids of the shards on global shard ``s``'s row (axis
        1) or column (axis 0), in axis order."""
        sx, sy = self.shape
        if self.axis == 0:
            return [i * sy + s % sy for i in range(sx)]
        return [(s // sy) * sy + j for j in range(sy)]

    def ppermute(self, v: torch.Tensor, perm) -> torch.Tensor:
        """``perm``'s ``(src, dst)`` pairs of axis indices, applied within
        every row or column of the mesh; unmatched destinations get
        zeros."""
        _note(self, "ppermute", v)
        lines = {tuple(self._line(s))
                 for s in range(self.shape[0] * self.shape[1])}
        return self.comm._ppermute(v, [(line[s], line[d]) for line in lines
                                       for s, d in perm])

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """Each local shard's blocks ``(L, n, ...)`` replaced by its row's
        or column's blocks concatenated along their first axis, in axis
        order: ``(L, n_shards * n, ...)`` (``lax.all_gather(...,
        tiled=True)`` over this axis; the result keeps the shard axis,
        since it differs across the other axis).  On a process group it
        gathers every rank's block and keeps its own line's."""
        _note(self, "all_gather", v)
        parts = self.comm._all_blocks(v)
        return torch.stack([torch.cat([parts[t] for t in self._line(s)])
                            for s in self.comm.shard_ids])


# -- the scope: which comm an axis name means ---------------------------------

_SCOPES = threading.local()


def _stack() -> list:
    if not hasattr(_SCOPES, "frames"):
        _SCOPES.frames = []
    return _SCOPES.frames


@contextlib.contextmanager
def bind(mesh):
    """Put ``mesh``'s comms in scope for the body of the ``with`` (what
    ``shard_map`` does for its function): each axis name its axis' comm
    (the mesh comm itself on a 1-D mesh, an :class:`AxisComm` on a 2-D
    one), the set of all its names the mesh comm."""
    frames = _stack()
    frame = dict(mesh.axis_comms)
    frame[frozenset(mesh.axis_names)] = mesh.comm
    frames.append(frame)
    try:
        yield mesh.comm
    finally:
        frames.pop()


def resolve(axis_name):
    """The comm bound to ``axis_name`` by the innermost scope naming it:
    one axis name its axis' comm, a tuple naming every axis of a mesh
    (``("rows", "cols")``, in any order) the whole mesh's comm."""
    if isinstance(axis_name, (tuple, list)) and len(axis_name) == 1:
        axis_name = axis_name[0]
    key = frozenset(axis_name) if isinstance(axis_name, (tuple, list)) \
        else axis_name
    for frame in reversed(_stack()):
        if key in frame:
            return frame[key]
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


__all__ = ["AxisComm", "CommRecorder", "ProcessGroupComm", "StackedComm",
           "active_recorder", "bind", "local_count", "loop_trips",
           "recording", "resolve", "shard_ids", "shard_map"]
