"""Op and communication accounting for solves, at the comm layer.

Counterpart of the JAX package's ``telemetry/cost.py``.  Node-aware SpMV
(arXiv 1612.08060) and GPGPU-cluster SpMV scaling (arXiv 1112.5588) both
show that communication VOLUME - not flop count - governs distributed
SpMV performance, so the volume is a measured quantity here: count the
collectives that matter (``psum``, ``ppermute``, ``all_gather``) per
loop trip and sum each one's per-device payload bytes (a halo
``ppermute`` carries exactly one boundary plane of
``parallel.halo.exchange_halo``, so payload bytes ARE halo bytes).

The JAX package walks the traced solve's jaxpr; a PyTorch solve has no
jaxpr, so the port accounts where its collectives happen:
:func:`trace_solve_cost` runs the solve once with a
``parallel.comm.CommRecorder`` active - every collective records its
name, payload and wire bytes, and ``solver.cg._blocked_while`` marks
each loop trip - and splits the record into setup and per-trip counts
with the JAX semantics.  ``OpCounts.ops`` therefore holds collectives
only (the JAX walk also counts ``dot_general``, which the comm layer
does not see).  With no recorder active, a solve runs the same
operations as before the recorder existed.

Terminology: a *loop trip* is one pass of a solver loop.  With
``check_every=1`` (the default) one trip is one CG iteration; with
``check_every=k`` the main loop's trip is a k-iteration block
(``solver.cg._blocked_while``) and callers pass ``iterations_per_trip=k``
to normalize.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter as _Counter
from typing import Any, Callable, Dict, Mapping, Tuple

__all__ = [
    "COLLECTIVE_PRIMITIVES",
    "EXCHANGE_PRIMITIVES",
    "OpCounts",
    "SolveCost",
    "analytic_solve_ops",
    "stencil_halo_bytes_per_iteration",
    "trace_solve_cost",
]

#: primitive names whose payload moves over the interconnect
COLLECTIVE_PRIMITIVES = frozenset({
    "psum", "pmax", "pmin", "ppermute", "pshuffle", "all_gather",
    "all_to_all", "reduce_scatter",
})

#: the DATA-MOVEMENT subset: collectives that relocate x/halo payloads
#: between devices (what an ``exchange=`` lane controls), as opposed to
#: the scalar reductions of the CG recurrence.  Only these contribute
#: to ``wire_bytes``.
EXCHANGE_PRIMITIVES = frozenset({
    "ppermute", "pshuffle", "all_gather", "all_to_all",
    "reduce_scatter",
})


@dataclasses.dataclass(frozen=True)
class OpCounts:
    """Collective counts plus byte accounts for one region.

    Two byte semantics ride together (the JAX package's):

    * ``comm_bytes`` - PAYLOAD bytes: the sum of each collective's
      per-device input (for a halo ``ppermute`` exactly the
      boundary-slab size).
    * ``wire_bytes`` - per-device INTERCONNECT bytes of the
      data-movement collectives (:data:`EXCHANGE_PRIMITIVES`): an
      ``all_gather`` is charged ``output - input`` bytes (``(P-1) *
      n_local`` remote entries land on every device), a ``ppermute`` its
      payload (sent exactly once).  Scalar reductions are excluded, so
      ``wire_bytes`` is exactly the halo volume the exchange schedule
      promises.
    """

    ops: Mapping[str, int]
    comm_bytes: int = 0
    wire_bytes: int = 0

    def get(self, name: str) -> int:
        return int(self.ops.get(name, 0))

    @property
    def psum(self) -> int:
        return self.get("psum")

    @property
    def ppermute(self) -> int:
        return self.get("ppermute")

    @property
    def all_gather(self) -> int:
        return self.get("all_gather")

    @property
    def dots(self) -> int:
        return self.get("dot_general")

    @property
    def collectives(self) -> int:
        return sum(v for k, v in self.ops.items()
                   if k in COLLECTIVE_PRIMITIVES)

    def scaled(self, factor: float) -> "OpCounts":
        """Counts scaled by ``factor`` (e.g. 1/check_every); exact
        integer results stay ints."""
        def scale(v):
            s = v * factor
            return int(s) if float(s).is_integer() else s

        return OpCounts(
            ops={k: scale(v) for k, v in self.ops.items()},
            comm_bytes=scale(self.comm_bytes),
            wire_bytes=scale(self.wire_bytes))

    def to_json(self) -> Dict[str, Any]:
        return {"ops": dict(sorted(self.ops.items())),
                "comm_bytes": self.comm_bytes,
                "wire_bytes": self.wire_bytes}


@dataclasses.dataclass(frozen=True)
class SolveCost:
    """The cost decomposition of one recorded solve.

    ``per_iteration`` is the main loop's per-trip counts normalized by
    ``iterations_per_trip``; ``setup`` is everything outside the loops
    (init reductions, result assembly); ``loops`` holds the per-trip
    counts of every top-level loop that ran a trip, in order (the
    ``check_every`` block loop, then the per-iteration tail loop).
    """

    setup: OpCounts
    per_iteration: OpCounts
    loops: Tuple[OpCounts, ...]

    def totals(self, iterations: int) -> OpCounts:
        """Whole-solve counts for a solve that ran ``iterations``
        iterations: ``setup + iterations * per_iteration``."""
        ops = _Counter({k: int(v) for k, v in self.setup.ops.items()})
        for k, v in self.per_iteration.ops.items():
            ops[k] += v * iterations
        return OpCounts(
            ops=dict(ops),
            comm_bytes=self.setup.comm_bytes
            + self.per_iteration.comm_bytes * iterations,
            wire_bytes=self.setup.wire_bytes
            + self.per_iteration.wire_bytes * iterations)

    def to_json(self) -> Dict[str, Any]:
        return {"setup": self.setup.to_json(),
                "per_iteration": self.per_iteration.to_json(),
                "n_loops": len(self.loops)}


def _counts(events) -> OpCounts:
    ops: _Counter = _Counter()
    comm = wire = 0
    for name, payload, w in events:
        ops[name] += 1
        comm += payload
        wire += w
    return OpCounts(ops=dict(ops), comm_bytes=comm, wire_bytes=wire)


def _worst(trips) -> OpCounts:
    """One loop's per-trip counts: the most of each op and of each byte
    account over its trips (every trip of a CG loop is alike; where they
    differ - pipecg's periodic residual replacement - the bound, as the
    JAX walk takes a ``cond``'s worst branch)."""
    ops: _Counter = _Counter()
    for t in trips:
        for k, v in t.ops.items():
            ops[k] = max(ops[k], v)
    return OpCounts(ops=dict(ops),
                    comm_bytes=max((t.comm_bytes for t in trips), default=0),
                    wire_bytes=max((t.wire_bytes for t in trips), default=0))


def trace_solve_cost(fn: Callable, *args,
                     iterations_per_trip: int = 1,
                     **kwargs) -> SolveCost:
    """Run ``fn(*args, **kwargs)`` once with the comm layer recording and
    return its :class:`SolveCost`.

    Unlike the JAX ``trace_solve_cost``, which traces without executing,
    this EXECUTES the solve (a PyTorch program exists only as it runs):
    the accounted collectives are the ones that ran.  ``fn``'s result is
    discarded.  ``iterations_per_trip`` normalizes blocked loops
    (``check_every=k`` -> k)."""
    if iterations_per_trip < 1:
        raise ValueError(
            f"iterations_per_trip must be >= 1, got {iterations_per_trip}")
    from ..parallel.comm import recording

    with recording() as rec:
        fn(*args, **kwargs)
    return recorded_cost(rec, iterations_per_trip=iterations_per_trip)


def recorded_cost(rec, iterations_per_trip: int = 1) -> SolveCost:
    """The :class:`SolveCost` of a finished ``parallel.comm.CommRecorder``
    (what :func:`trace_solve_cost` returns; ``parallel.dist_cg`` records
    the first telemetered solve of each cached solver with it)."""
    setup = []
    trips: Dict[Tuple[int, int], list] = {w: [] for w in rec.trips}
    for name, payload, wire, where in rec.events:
        (setup if where is None else trips[where]).append(
            (name, payload, wire))
    loops = [_worst([_counts(ev) for w, ev in trips.items() if w[0] == loop])
             for loop in sorted({w[0] for w in trips})]
    if loops:
        main = loops[0]
        per_iter = main.scaled(1.0 / iterations_per_trip) \
            if iterations_per_trip > 1 else main
    else:
        per_iter = OpCounts(ops={})
    return SolveCost(setup=_counts(setup), per_iteration=per_iter,
                     loops=tuple(loops))


def stencil_halo_bytes_per_iteration(grid: Tuple[int, ...],
                                     itemsize: int,
                                     matvecs_per_iteration: int = 1) -> int:
    """Analytic per-device halo traffic of a slab-partitioned stencil.

    One matvec exchanges one boundary plane with each neighbor
    (``parallel.halo.exchange_halo``: one forward + one backward
    ``ppermute``, payload ``grid[1:]`` each).  This is the cross-check
    for the recorded ``comm_bytes`` - tests assert the two agree
    exactly.
    """
    plane = int(math.prod(grid[1:])) if len(grid) > 1 else 1
    return 2 * plane * itemsize * matvecs_per_iteration


#: Analytic per-iteration op model of the solver recurrences, straight
#: from the implementations in ``solver/cg.py`` (and the reference's
#: loop for "cg": 1 SpMV ``CUDACG.cu:295``, 2 reductions ``:304,328``,
#: 3 vector updates ``:314,320,342-347``).  ``axpy`` counts xpby/axpy
#: class fused vector updates.
_METHOD_OPS = {
    # method -> (spmv, dots, axpy) per iteration, unpreconditioned
    "cg": (1, 2, 3),
    "cg1": (1, 2, 4),      # dots fused into ONE reduction (s = A p axpy)
    "pipecg": (1, 2, 6),   # one fused reduction; s/q/z recurrences
    "minres": (1, 2, 5),   # Lanczos + two Givens updates
    # many-RHS tier (solver.many): same recurrence shape as "cg" per
    # lane, but ONE SpMM/exchange serves every lane; block adds the
    # k x k Gram solve (ignored here - O(k^3) host-scale flops against
    # O(nnz k) sweeps)
    "batched": (1, 2, 3),
    "block": (1, 3, 3),    # P^T A P, R^T Z and the per-lane ||r||^2
}


def analytic_solve_ops(method: str = "cg",
                       preconditioned: bool = False,
                       precond_matvecs: int = 0,
                       n_rhs: int = 1) -> Dict[str, int]:
    """Per-iteration SpMV/dot/axpy model for a solver recurrence.

    ``preconditioned`` adds the extra ``r . z`` inner product and one
    preconditioner application per iteration; ``precond_matvecs`` is the
    application's own matvec count (e.g. ``degree - 1`` for a Chebyshev
    polynomial), folded into ``spmv``.

    ``n_rhs`` is the batched-solve lane count (``solver.many``): the
    ``spmv`` count stays the number of MATRIX SWEEPS per iteration (one
    SpMM serves every lane), while ``dot``/``axpy`` count per-lane
    vector reductions/updates and so scale by ``n_rhs``.
    """
    if method not in _METHOD_OPS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{sorted(_METHOD_OPS)}")
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    spmv, dots, axpy = _METHOD_OPS[method]
    if preconditioned:
        dots += 1
        spmv += precond_matvecs
    return {"spmv": spmv, "dot": dots * n_rhs, "axpy": axpy * n_rhs}
