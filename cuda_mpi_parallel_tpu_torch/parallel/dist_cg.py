"""Row-partitioned distributed CG: the same solver body, over a mesh.

Counterpart of the JAX package's ``parallel/dist_cg.py``:
``solve_distributed(a, b, mesh=...)`` takes a global problem (an
assembled ``CSRMatrix`` or a matrix-free ``Stencil2D``/``Stencil3D``),
partitions its rows over the mesh and runs ``solver.cg`` as the
per-shard body inside ``parallel.comm.shard_map``:

* the inner products reduce over the mesh axis (``ops.blas1`` with
  ``axis_name``; one reduction per iteration for cg1 and pipecg);
* the SpMV's neighbour dependencies become halo exchange (stencils) or
  one all_gather, the gather schedule's rounds, or the ring rotation
  (general CSR);
* the convergence test reads one host scalar per check block, as the
  single-device loop does.

The solver body is the single-device ``cg``; the distribution enters
only through ``axis_name`` and the operators' communication.

Lanes: stencil slabs (``backend="pallas"`` runs B1/B2 on each slab);
``Stencil3D`` on a 2-D mesh (``make_mesh_2d``: pencils, ``"xla"`` only,
as in the JAX package);
assembled CSR with ``csr_comm="allgather"`` (``exchange=None``,
``"allgather"``, ``"gather"`` or ``"auto"``), ``csr_comm="ring"`` and
``csr_comm="ring-shiftell"`` (the ring on B8); on the allgather and
gather lanes with ``method="cg"``, checkpoint/resume (``x0``,
``resume_from``, ``return_checkpoint``, ``iter_cap``); ``plan=`` (a
``balance.PartitionPlan`` or ``"auto"``) on every CSR lane;
``method`` cg, cg1, pipecg and minres; ``preconditioner`` None,
``"jacobi"``, ``"chebyshev"`` and, on stencil slabs, ``"mg"`` (minres
takes none); ``deflate=``/``basis=`` (Krylov recycling,
``solver.recycle``) on the allgather and gather lanes with
``method="cg"``; ``inject=`` (a ``robust.FaultPlan``) on the same
lanes.

Telemetry: while ``telemetry.active()``, each partition is accounted
(``telemetry.shardscope`` and ``telemetry.memscope``: the
``shard_profile``, ``partition_plan`` and ``memory_profile`` events),
and the first solve of each cached solver runs under the comm layer's
recorder and, over its setup and first two loop trips, a
``memscope.PeakRecord``; every telemetered solve then
sets the ``dist_comm_*_per_iteration`` gauges and emits ``comm_cost``.
With telemetry off none of it runs: the same operations, the same bits.

The many-RHS lane: ``solve_distributed_many`` (and
``ManyRHSDispatcher``, which partitions once and dispatches many
batches) runs ``solver.many.cg_many`` as the per-shard body over the
same ``DistCSR``/``DistCSRGather`` partition; each iteration ships all
``k`` columns through one exchange and one psum per inner product, so
its collectives per iteration are the single-RHS solve's.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..models.operators import (
    CSRMatrix,
    JacobiPreconditioner,
    Stencil2D,
    Stencil3D,
)
from ..models.multigrid import MultigridPreconditioner
from ..models.precond import ChebyshevPreconditioner
from ..solver.cg import (
    CGCheckpoint,
    CGResult,
    _flight_extra,
    _note_engine,
    cg,
)
from . import partition as part
from .comm import shard_map
from .mesh import Mesh, make_mesh, shard_vector
from .operators import (
    DistCSR,
    DistCSRGather,
    DistCSRRing,
    DistShiftELLRing,
    DistStencil2D,
    DistStencil3D,
    DistStencil3DPencil,
    from_pencils,
    to_pencils,
)


def solve_distributed(
    a,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    preconditioner: Optional[str] = None,
    precond_degree: int = 4,
    record_history: bool = False,
    method: str = "cg",
    check_every: int = 1,
    compensated: bool = False,
    csr_comm: str = "allgather",
    flight=None,
    plan=None,
    exchange=None,
    x0=None,
    resume_from: Optional[CGCheckpoint] = None,
    return_checkpoint: bool = False,
    iter_cap: Optional[int] = None,
    inject=None,
    validate: bool = True,
    deflate=None,
    basis=None,
) -> CGResult:
    """Solve the global system A x = b row-partitioned over a mesh.

    Args (the JAX ``solve_distributed``'s):
      a: global operator - ``CSRMatrix``, ``Stencil2D`` or ``Stencil3D``.
      b: global right-hand side (length n).
      mesh: a ``parallel.make_mesh`` mesh; default ``make_mesh(n_devices)``
        (the process group, or every CUDA device).  A ``make_mesh_2d``
        mesh takes a ``Stencil3D`` (``backend="xla"``) as pencils: x and
        y partitioned, four ``ppermute``s a matvec, the dots reduced over
        both axes; ``x`` comes back in natural order.
      preconditioner: ``None``, ``"jacobi"`` or ``"chebyshev"`` (degree
        ``precond_degree``; its power-iteration estimate and every
        application run inside the per-shard body, reducing over the
        mesh) or ``"mg"`` (the geometric multigrid V-cycle on stencil
        slabs, built from the local slab inside the per-shard body: each
        level's matvec and transfers exchange halos, and the residual
        is all-gathered once a cycle where the local extent stops
        halving, so the hierarchy is the single-device one; a CSR
        problem raises ``ValueError``).  ``"bjacobi"`` is single-device
        only.
      method: ``"cg"``, ``"cg1"`` (one reduction per iteration),
        ``"pipecg"`` or ``"minres"`` (the symmetric-indefinite solver,
        ``solver.minres``, unpreconditioned: a preconditioner is refused
        as ``solver.cg`` refuses it), its dots reduced over the mesh.
      csr_comm: general-CSR schedule - ``"allgather"``, ``"ring"`` or
        ``"ring-shiftell"`` (the ring with each step's slabs one launch
        of the hand SpMV B8, ``DistShiftELLRing``).
      exchange: the CSR halo wire on the allgather lane - ``"gather"``
        ships only the coupled x entries, ``"allgather"`` the full x,
        ``"auto"`` takes the gather schedule when its padded wire is
        below ``exchange.AUTO_WIRE_FRACTION`` of the dense one, ``"ring"``
        is ``csr_comm="ring"``; ``None`` the legacy allgather.
      validate: a finiteness check of ``b`` and the operator's
        coefficients before the solve (a non-finite value raises
        ``ValueError``); ``False`` skips it.
      flight: a ``telemetry.flight.FlightConfig`` - the convergence
        flight recorder inside the per-shard solve (heartbeat stripped:
        ``FlightConfig.without_heartbeat``).  It records the all-reduced
        scalars, so every shard's buffer is the same.
      x0: optional global initial guess (length n), padded and sharded
        like ``b``; ``None`` keeps the copy-only zero init.
      resume_from / return_checkpoint / iter_cap: distributed
        checkpoint/resume (``solver.cg.CGCheckpoint`` semantics - the
        resumed trajectory is bit-exact).  The checkpoint's vector
        leaves are GLOBAL vectors in the PADDED row layout of this
        exact partition (the padding rows are not cut, unlike ``x``'s);
        its scalars are the reduced values every shard holds.  Persist
        them with ``utils.checkpoint.solve_resumable_distributed``,
        whose fingerprint covers the mesh and exchange lane.  They and
        ``x0`` ride the assembled-CSR allgather/gather lanes with
        ``method="cg"`` only (``ValueError`` elsewhere, as in the JAX
        package).  ``iter_cap`` and the resume state are arguments of
        the cached per-shard solver, so every segment of a resumable
        solve runs the same one.
      deflate: a ``solver.recycle.RecycleSpace`` - Krylov-recycling
        deflation.  The space lives in the caller's global row order;
        ``W``/``AW`` are padded and sharded like ``b``, so the in-loop
        projections are local products plus the one fused reduction of
        the deflated ``cg`` lane (collectives per iteration unchanged).
        A space of another operator raises ``RecycleMismatch``.  CSR
        allgather/gather lanes with ``method="cg"`` only.
      basis: a ``solver.recycle.BasisConfig`` - the recycling harvest
        ring (needs a stride-1 ``flight``); ``result.basis`` comes back
        in the caller's row order, so ``recycle.harvest_space(a,
        result)`` works on the global operator.  Same lanes as
        ``deflate``.
      inject: a ``robust.FaultPlan`` - deterministic fault injection into
        the per-shard solve (halo payload, local SpMV output or the
        reduced ``p . Ap``; ``robust.inject``).  CSR allgather/gather
        lanes with ``method="cg"``; ``None`` runs the same operations as
        a call that never mentions injection.
      plan: partition plan for assembled CSR problems - ``None`` (the
        legacy even split, bit-identical), ``"auto"`` (run
        ``balance.plan_partition`` for this mesh, priced by its H100
        reference model) or a ``balance.PartitionPlan``.  The plan's
        symmetric permutation and variable-row split apply inside the
        solve; ``x`` comes back in the caller's row order.  Its scored
        exchange lane runs unless ``exchange=`` pins one; a plan scored
        for the gather wire conflicts with the ring schedules
        (``ValueError``).  A plan that is the legacy layout collapses to
        ``None`` (the same cached solver).  Stencils refuse it
        (``ValueError``).
      (tol/rtol/maxiter/record_history/check_every/compensated as in
      ``solver.cg``.)

    Returns:
      ``CGResult`` whose ``x`` is the global solution (length n, padding
      rows stripped) on the mesh's device, on every rank of a process
      group.
    """
    if mesh is None:
        mesh = make_mesh(n_devices)
    if preconditioner == "bjacobi":
        raise ValueError(
            "preconditioner='bjacobi' is single-device only (its dense "
            "block extraction is host-side); use 'jacobi', 'chebyshev' "
            "or 'mg' on a mesh")
    if preconditioner not in (None, "jacobi", "chebyshev", "mg"):
        raise ValueError(f"unknown preconditioner: {preconditioner!r}")
    b = b.to(mesh.device) if isinstance(b, torch.Tensor) \
        else torch.as_tensor(np.asarray(b), device=mesh.device)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"operator shape {a.shape} does not match rhs "
                         f"shape {tuple(b.shape)}")
    if csr_comm not in ("allgather", "ring", "ring-shiftell"):
        raise ValueError(f"unknown csr_comm: {csr_comm!r}")
    if exchange not in (None, "auto", "gather", "allgather", "ring"):
        raise ValueError(
            f"unknown exchange: {exchange!r} (expected 'auto', "
            f"'gather', 'allgather', 'ring' or None)")
    if exchange is not None and not isinstance(a, CSRMatrix):
        raise ValueError(
            f"exchange= applies to assembled CSRMatrix problems; "
            f"{type(a).__name__} slabs exchange plane halos already")
    if exchange == "ring":
        if csr_comm == "ring-shiftell":
            raise ValueError(
                "exchange='ring' conflicts with csr_comm='ring-shiftell'"
                " (pick one schedule)")
        csr_comm, exchange = "ring", None
    elif exchange in ("gather", "allgather") \
            and csr_comm in ("ring", "ring-shiftell"):
        raise ValueError(
            f"exchange={exchange!r} conflicts with csr_comm="
            f"{csr_comm!r}: the ring schedules rotate full x-blocks "
            f"(use csr_comm='allgather' with exchange=, or drop one)")
    if plan is not None and not isinstance(a, CSRMatrix):
        raise ValueError(
            f"plan= applies to assembled CSRMatrix problems; "
            f"{type(a).__name__} slabs are uniform by construction "
            f"(nothing to rebalance)")
    if validate:
        from ..robust.validate import check_finite_problem, check_finite_rhs

        check_finite_problem(a, b)
        if x0 is not None:
            check_finite_rhs(x0, what="x0")
    resumable = (x0 is not None or resume_from is not None
                 or return_checkpoint or iter_cap is not None)
    if deflate is not None or basis is not None:
        from ..solver.recycle import check_recycling, check_space

        feature = "deflate= (Krylov recycling)" if deflate is not None \
            else "basis= (the recycling harvest ring)"
        if not isinstance(a, CSRMatrix) or csr_comm != "allgather":
            raise ValueError(
                f"{feature} rides the assembled-CSR allgather/gather "
                f"lanes only (got {type(a).__name__}, csr_comm="
                f"{csr_comm!r}, exchange={exchange!r})")
        check_recycling(
            deflate, basis, method=method, rides="cg", flight=flight,
            conflict=("fault injection" if inject is not None
                      else "checkpoint/resume (x0/resume_from/"
                           "return_checkpoint/iter_cap)" if resumable
                      else None))
        if deflate is not None:
            check_space(deflate, a)     # typed RecycleMismatch
    if inject is not None or resumable:
        feature = ("inject (fault injection)" if inject is not None
                   else "checkpoint/resume (x0/resume_from/"
                        "return_checkpoint/iter_cap)")
        if not isinstance(a, CSRMatrix) or csr_comm != "allgather":
            raise ValueError(
                f"{feature} rides the assembled-CSR allgather/gather "
                f"lanes only (got {type(a).__name__}, csr_comm="
                f"{csr_comm!r}, exchange={exchange!r})")
        if method != "cg":
            raise ValueError(
                f"{feature} requires method='cg' (got {method!r})")
    if inject is not None:
        _check_inject(inject, mesh, method, "cg")
    if flight is not None:
        flight = flight.without_heartbeat()
    kw = dict(tol=tol, rtol=rtol, maxiter=maxiter, method=method,
              check_every=check_every, compensated=compensated,
              flight=flight)
    precond = (preconditioner, precond_degree)
    n_shards = mesh.size

    def note():
        # after ALL validation, immediately before a dispatch - an
        # engine_selected event means the solve actually runs
        _note_engine("distributed", method, check_every, n_shards=n_shards,
                     **_flight_extra(flight))

    if len(mesh.axis_names) == 2:
        # pencil decomposition: two partitioned grid axes
        if not isinstance(a, Stencil3D):
            raise TypeError(
                "a 2-D mesh (pencil decomposition) supports Stencil3D "
                f"only, got {type(a).__name__}")
        if a.backend == "pallas":
            raise ValueError(
                "the pencil path has no pallas matvec; re-create the "
                "operator with backend='xla' for a 2-D mesh")
        note()
        return _solve_pencil(a, b, mesh, precond, record_history, kw)
    if preconditioner == "mg" and not isinstance(a, (Stencil2D, Stencil3D)):
        raise ValueError("preconditioner='mg' needs a stencil operator "
                         "(geometric multigrid has no CSR hierarchy)")
    axis = mesh.axis_names[0]

    if isinstance(a, (Stencil2D, Stencil3D)):
        note()
        return _solve_stencil(a, b, mesh, axis, n_shards, precond,
                              record_history, kw)
    if isinstance(a, CSRMatrix):
        plan = resolve_plan(plan, a, n_shards,
                            exchange=_plan_exchange_hint(csr_comm,
                                                         exchange))
        if inject is not None:
            kw["fault"] = inject
        if basis is not None:
            kw["basis"] = basis
        note()
        return _solve_csr(a, b, mesh, axis, n_shards, precond,
                          record_history, kw, csr_comm=csr_comm, plan=plan,
                          exchange=exchange, x0=x0, resume_from=resume_from,
                          return_checkpoint=return_checkpoint,
                          iter_cap=iter_cap, deflate=deflate)
    raise TypeError(f"solve_distributed supports CSRMatrix/Stencil2D/"
                    f"Stencil3D, got {type(a).__name__}")


# -- fault plans ----------------------------------------------------------------


def _check_inject(inject, mesh, method: str, allowed: str) -> None:
    """The refusals of an ``inject=`` plan, before any partitioning: a
    ``robust.FaultPlan`` that fits a lane of ``mesh`` (every distributed
    CSR lane exchanges a halo)."""
    from ..robust.inject import FaultPlan

    if not isinstance(inject, FaultPlan):
        raise TypeError(f"inject must be a robust.FaultPlan, got "
                        f"{type(inject).__name__}")
    inject._check_lane(None, int(mesh.size), method=method,
                       allowed=allowed, exchanges=True)


# -- the solver cache ---------------------------------------------------------

#: built per-shard solvers: (problem structure, mesh, static config) ->
#: the shard_map'd body.  Everything static lives in the key; the arrays
#: (b, operator data, the stencil scale) are arguments.  LRU-bounded by
#: DIST_CACHE_CAP_ENV (default DEFAULT_DIST_CACHE_CAP), least recently
#: hit first; a later identical solve simply builds again.
_SOLVER_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_CACHE_LOCK = threading.Lock()

#: env override for the solver-cache capacity (entries, >= 1)
DIST_CACHE_CAP_ENV = "CUDA_MPI_PARALLEL_TPU_DIST_CACHE_CAP"
DEFAULT_DIST_CACHE_CAP = 64

#: incremented each time a cached solver is built (a cache miss)
_BUILD_COUNT = [0]

#: per-key comm-layer cost (telemetry.cost.SolveCost) of the first
#: telemetered solve of that key, recorded while it ran
_COST_CACHE: dict = {}

#: per-key memscope.PeakRecord high water (process bytes) of the same
#: recorded solve
_PEAK_CACHE: dict = {}

#: (SolveCost, context dict) of the most recent telemetered solve
#: dispatched through the cache
_LAST_COMM_COST = [None]


def _dist_cache_cap() -> int:
    raw = os.environ.get(DIST_CACHE_CAP_ENV)
    if not raw:
        return DEFAULT_DIST_CACHE_CAP
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(
            f"{DIST_CACHE_CAP_ENV}={raw!r} is not an integer") from None
    if cap < 1:
        raise ValueError(
            f"{DIST_CACHE_CAP_ENV} must be >= 1, got {cap} (the cache "
            f"must hold at least the in-flight solver)")
    return cap


def clear_solver_cache() -> None:
    with _CACHE_LOCK:
        _SOLVER_CACHE.clear()
        _COST_CACHE.clear()
        _PEAK_CACHE.clear()
    _LAST_COMM_COST[0] = None


def last_comm_cost():
    """``(telemetry.cost.SolveCost, context)`` of the most recent
    distributed solve, or ``None`` (no solve yet, or telemetry was
    inactive so nothing was recorded).

    Consumers attributing the cost to a specific solve must call
    :func:`reset_last_comm_cost` before dispatching it: the df64 and
    resident lanes do not record, so without the reset a stale value
    from an earlier ``solve_distributed`` would be misattributed."""
    return _LAST_COMM_COST[0]


def reset_last_comm_cost() -> None:
    _LAST_COMM_COST[0] = None


def cache_key_parts(kind: str, **parts):
    """Canonical solver-cache key: ``(kind, ("field", value), ...)`` with
    fields sorted by name and ``None``-valued fields dropped, so a lane
    that is not threaded keeps the key it had before the lane existed."""
    return (kind,) + tuple(
        (name, value) for name, value in sorted(parts.items())
        if value is not None)


def _cached_solver(key, build):
    """Fetch-or-build the per-shard solver of ``key`` (LRU)."""
    with _CACHE_LOCK:
        fn = _SOLVER_CACHE.get(key)
        if fn is not None:
            _SOLVER_CACHE.move_to_end(key)
            return fn
    built = build()
    _BUILD_COUNT[0] += 1
    cap = _dist_cache_cap()
    with _CACHE_LOCK:
        fn = _SOLVER_CACHE.setdefault(key, built)
        while len(_SOLVER_CACHE) > cap:
            evicted, _ = _SOLVER_CACHE.popitem(last=False)
            _COST_CACHE.pop(evicted, None)
            _PEAK_CACHE.pop(evicted, None)
    return fn


def _run_solver(key, build, args, ctx=None):
    """Fetch-or-build the per-shard solver of ``key`` and run it on
    ``args``.  With ``ctx`` (the ``comm_cost`` context: ``kind``,
    ``check_every``, ...) and telemetry active, the first solve of the
    key runs under the comm layer's recorder and a
    ``memscope.PeakRecord`` over its setup and first two loop trips (the
    recorded cost and peak are cached beside the solver), and every such
    solve sets the per-iteration comm gauges and emits ``comm_cost``.
    Otherwise the solver just runs."""
    from .. import telemetry

    fn = _cached_solver(key, build)
    if ctx is None or not telemetry.active():
        return fn(*args)
    cost = _COST_CACHE.get(key)
    if cost is None:
        from ..telemetry.cost import recorded_cost
        from ..telemetry.memscope import PeakRecord
        from .comm import recording

        peak = PeakRecord(_args_device(args)).add(args)
        with recording() as rec, peak:
            # the working set is at its steady state once the setup and
            # two loop trips have run (the first one's p is still r's
            # storage): the peak record ends as the third trip starts,
            # the comm record runs to the end
            rec.on_trip = lambda where: (
                peak.stop() if len(rec.trips) > 2 else None)
            res = fn(*args)
        cost = recorded_cost(rec, iterations_per_trip=ctx["check_every"])
        with _CACHE_LOCK:
            _COST_CACHE[key] = cost
            _PEAK_CACHE[key] = int(peak.peak)
    else:
        res = fn(*args)
    _LAST_COMM_COST[0] = (cost, dict(ctx))
    per = cost.per_iteration
    for gname, gval in (
            ("dist_comm_psum_per_iteration", per.psum),
            ("dist_comm_ppermute_per_iteration", per.ppermute),
            ("dist_comm_all_gather_per_iteration", per.all_gather),
            ("dist_comm_bytes_per_iteration", per.comm_bytes),
            ("dist_comm_wire_bytes_per_iteration", per.wire_bytes)):
        telemetry.REGISTRY.gauge(
            gname, "recorded per-iteration communication of the most "
            "recent distributed solve",
            labelnames=("kind",)).set(gval, kind=str(ctx.get("kind", "?")))
    telemetry.events.emit(
        "comm_cost", key=_key_id(key),
        psum_per_iteration=per.psum,
        ppermute_per_iteration=per.ppermute,
        all_gather_per_iteration=per.all_gather,
        dots_per_iteration=per.dots,
        comm_bytes_per_iteration=per.comm_bytes,
        wire_bytes_per_iteration=per.wire_bytes,
        setup=cost.setup.to_json(), **ctx)
    return res


def _args_device(args):
    """The device of the first tensor among a solver's arguments."""
    from ..telemetry.memscope import _tensors

    return next((t.device for t in _tensors(args)
                 if isinstance(t, torch.Tensor)), None)


def _key_id(key) -> str:
    """Short stable digest of a cache key for event payloads (the key
    holds Mesh objects and is not JSON)."""
    import hashlib

    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


# -- partition accounting and planning ------------------------------------------


def _note_shards(build_report) -> None:
    """Per-shard partition accounting (telemetry.shardscope), computed
    only when a telemetry consumer is attached - the partition path of
    an untelemetered solve is untouched.  ``build_report`` takes the
    shardscope module and returns the ShardReport."""
    from .. import telemetry

    if not telemetry.active():
        return
    telemetry.shardscope.note_report(build_report(telemetry.shardscope))


def _note_memory(parts, arrays, key, mesh, *, n_rhs=1, flight=None,
                 basis=None) -> None:
    """Per-shard device-memory accounting (telemetry.memscope), computed
    only when a telemetry consumer is attached.  ``arrays`` is the tree
    of this process's tensors the dispatch pins for its lifetime; their
    summed bytes are asserted equal to the model's matrix bytes of this
    process's shards inside ``note_footprint`` - the exact-match
    contract that keeps the static model honest.  ``key`` fetches the
    recorded peak of the solver (``_PEAK_CACHE``; the process's bytes,
    charged to its shards in equal shares)."""
    from .. import telemetry

    if not telemetry.active():
        return
    ms = telemetry.memscope
    ids = tuple(mesh.comm.shard_ids)
    peak = _PEAK_CACHE.get(key)
    fp = ms.footprint_for_partition(
        parts, n_rhs=n_rhs,
        flight_capacity=flight.capacity if flight is not None else 0,
        basis_m=basis.capacity if basis is not None else 0,
        jaxpr_peak=None if peak is None else -(-peak // len(ids)),
        hbm_bytes=ms.hbm_bytes_for(backend=str(mesh.device)),
        shard_ids=ids)
    ms.note_footprint(fp, measured_bytes=ms.live_device_bytes(arrays),
                      device_peak=ms.device_memory_peak(mesh.device),
                      shard_ids=ids)


def _plan_exchange_hint(csr_comm: str, exchange) -> str:
    """The exchange lane ``plan_partition`` should search/pin for a
    solve: the ring schedules price their fixed rotation (whether
    requested as ``csr_comm=`` or ``exchange="ring"``), an explicit
    ``exchange=`` pins its lane, and ``None``/``"auto"`` leave the
    planner free to choose (allgather vs gather joins the search)."""
    if csr_comm in ("ring", "ring-shiftell") or exchange == "ring":
        return "ring"
    if exchange in ("gather", "allgather"):
        return exchange
    return "auto"


def resolve_plan(plan, a, n_shards, *, model=None, exchange="auto"):
    """Normalize the ``plan=`` argument of the CSR entry points:
    ``None`` passes through (the even split), ``"auto"`` runs the
    planner, a ``balance.PartitionPlan`` is validated against the
    operator and mesh.  Shared by ``solve_distributed``,
    ``solve_distributed_many``, ``solve_distributed_df64``, the elastic
    migration and the resumable loop.

    ``model`` prices ``"auto"`` planning (default: the planner's H100
    reference table, ``balance.reference_model`` - the JAX package
    prefers a runtime calibration there, which the port does not have
    yet).  ``exchange`` is the halo-wire lane hint forwarded to
    ``plan_partition`` (pin ``"allgather"``/``"gather"``/``"ring"``, or
    ``"auto"`` to let the lane join the (reorder x split) search)."""
    if plan is None:
        return None
    from ..balance import PartitionPlan, plan_partition

    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(
                f"plan must be None, 'auto' or a balance.PartitionPlan, "
                f"got {plan!r}")
        plan = plan_partition(a, n_shards, model=model, exchange=exchange)
    elif not isinstance(plan, PartitionPlan):
        raise TypeError(
            f"plan must be None, 'auto' or a balance.PartitionPlan, "
            f"got {type(plan).__name__}")
    if plan.n_shards != n_shards:
        raise ValueError(
            f"plan targets {plan.n_shards} shards but the mesh has "
            f"{n_shards}")
    if exchange == "ring" and getattr(plan, "exchange",
                                      "allgather") == "gather":
        # the ring schedules rotate full x-blocks and would silently
        # drop the plan's scored wire - the same conflict an explicit
        # exchange='gather' + csr_comm='ring' raises
        raise ValueError(
            "this plan was scored for the gather halo exchange, but "
            "the requested ring schedule rotates full x-blocks; "
            "re-plan with exchange='ring' (or drop csr_comm='ring')")
    plan.validate_for(a)
    if plan.is_trivial():
        # no permutation + even ranges IS the unplanned layout: take
        # the plan=None path so the solve shares the legacy cached
        # solver instead of building a twin under a new key
        return None
    return plan


def _apply_plan_permutation(a, b, plan):
    """Host-side symmetric reorder of the global system: ``P A P^T``
    and ``b[perm]`` (``CSRMatrix.permuted`` semantics; ``b`` host
    numpy).  The inverse rides the unpadding, so callers always get x
    in THEIR row ordering."""
    if plan is None or plan.permutation is None:
        return a, b
    perm = plan.permutation
    return a.permuted(perm), np.asarray(b)[perm]


def _note_partition(a, parts, plan) -> None:
    """The planned-partition sibling of ``_note_shards``: park/emit the
    measured schedule-specific ShardReport labeled with the plan lane,
    plus a ``partition_plan`` event joining the planner's PREDICTED
    imbalance (coupling-halo semantics, ``report_for_ranges``) to the
    MEASURED one - the closed feedback loop in one event."""
    from .. import telemetry

    if not telemetry.active():
        return
    label = plan.label if plan is not None else None
    rep = telemetry.shardscope.shard_report(a, parts, plan=label)
    telemetry.shardscope.note_report(rep)
    if plan is not None:
        telemetry.events.emit(
            "partition_plan", reorder=plan.reorder, split=plan.split,
            exchange=getattr(plan, "exchange", "allgather"),
            n_shards=plan.n_shards, fingerprint=plan.fingerprint(),
            objective=plan.objective, score=float(plan.score),
            predicted=(plan.report.imbalance()
                       if plan.report is not None else None),
            measured=rep.imbalance())


def _padded_rows(host, parts) -> np.ndarray:
    """A global host vector - or ``(n, k)`` stack - in the partition's
    padded row layout (even split, or the plan's variable rows)."""
    if parts.row_ranges is not None:
        return part.pad_vector_ranges(host, parts.row_ranges, parts.n_local)
    return part.pad_vector(host, parts.n_global_padded)


def _unpad_rows(parts, plan, device):
    """The rows of the gathered padded solution that are the caller's
    rows, in the caller's order: a slice for the even split, an index
    tensor for a planned layout."""
    if parts.row_ranges is None:
        return slice(0, parts.n_global)
    return torch.as_tensor(
        part.plan_gather_indices(parts.n_global, parts.n_shards, plan),
        device=device)


# -- the lanes ----------------------------------------------------------------


def _make_precond(precond, local, axis):
    """The preconditioner, built inside the per-shard body: the
    Chebyshev estimate's reductions and every application run over
    ``axis`` (a mesh axis name, or the tuple of both on a pencil mesh);
    the multigrid hierarchy is built from the local slab or pencil."""
    name, degree = precond
    if name == "jacobi":
        return JacobiPreconditioner.from_operator(local)
    if name == "chebyshev":
        return ChebyshevPreconditioner.from_operator(
            local, degree=degree, axis_name=axis)
    if name == "mg":
        return MultigridPreconditioner.from_operator(local)
    return None


def _global_result(res: CGResult, mesh: Mesh, rows=None) -> CGResult:
    """The per-shard result with ``x`` made global (gathered on a process
    group) and cut to the caller's ``rows`` (``_unpad_rows``; ``None``
    keeps every row); a checkpoint's vectors are made global too,
    padding rows kept (the layout a resume shards again)."""
    x = mesh.comm.global_vector(res.x)
    if rows is not None:
        x = x[rows]
    basis = res.basis
    if basis is not None:
        its, vecs = basis
        vecs = mesh.comm.global_vector(vecs.t().contiguous()).t()
        basis = (its, vecs if rows is None else vecs[:, rows])
    ck = res.checkpoint
    if ck is not None:
        ck = dataclasses.replace(ck, **{
            name: mesh.comm.global_vector(getattr(ck, name))
            for name in ("x", "r", "p")})
    return dataclasses.replace(res, x=x, checkpoint=ck, basis=basis)


def _solve_stencil(a, b, mesh, axis, n_shards, precond, record_history,
                   kw) -> CGResult:
    cls = DistStencil2D if isinstance(a, Stencil2D) else DistStencil3D
    local = cls.create(a.grid, n_shards, axis_name=axis, scale=a.scale,
                       dtype=a.dtype, backend=a.backend, device=mesh.device)
    two_d = isinstance(a, Stencil2D)
    _note_shards(lambda ss: ss.report_stencil(
        local.local_grid, n_shards, torch.finfo(a.dtype).bits // 8,
        points=5 if two_d else 7,
        kind="stencil2d" if two_d else "stencil3d"))
    b_local = shard_vector(b.to(a.dtype), mesh, axis)
    key = cache_key_parts(
        "stencil", operator=cls.__name__, local_grid=local.local_grid,
        backend=local.backend, dtype=local._dtype_name, axis=axis,
        mesh=mesh, precond=precond, record_history=record_history,
        solver_kw=tuple(sorted(kw.items())))

    def build():
        def run(b_local, scale):
            loc = dataclasses.replace(local, scale=scale)
            m = _make_precond(precond, loc, axis)
            return cg(loc, b_local, m=m, record_history=record_history,
                      axis_name=axis, **kw)
        return shard_map(run, mesh=mesh)

    ctx = dict(kind="stencil", check_every=kw["check_every"],
               method=kw["method"], n_shards=n_shards)
    res = _run_solver(key, build, (b_local, local.scale), ctx)
    return _global_result(res, mesh)


def _solve_pencil(a, b, mesh, precond, record_history, kw) -> CGResult:
    """Stencil3D over a 2-D mesh: x- and y-axes partitioned, four halo
    ppermutes per matvec, inner products reduced over BOTH mesh axes.
    ``b`` goes into the pencils by a transpose of blocks, and ``x`` comes
    back to natural order by its inverse."""
    ax_x, ax_y = mesh.axis_names
    sx, sy = mesh.devices.shape
    local = DistStencil3DPencil.create(a.grid, (sx, sy),
                                       axis_names=(ax_x, ax_y),
                                       scale=a.scale, dtype=a.dtype,
                                       device=mesh.device)
    b_local = mesh.comm.local_vector(
        to_pencils(b.to(a.dtype), a.grid, (sx, sy)))
    key = cache_key_parts(
        "pencil", local_grid=local.local_grid, shards=local.shards,
        dtype=local._dtype_name, axes=(ax_x, ax_y), mesh=mesh,
        precond=precond, record_history=record_history,
        solver_kw=tuple(sorted(kw.items())))

    def build():
        def run(b_local, scale):
            loc = dataclasses.replace(local, scale=scale)
            m = _make_precond(precond, loc, (ax_x, ax_y))
            return cg(loc, b_local, m=m, record_history=record_history,
                      axis_name=(ax_x, ax_y), **kw)
        return shard_map(run, mesh=mesh)

    ctx = dict(kind="pencil", check_every=kw["check_every"],
               method=kw["method"], n_shards=int(sx * sy))
    res = _run_solver(key, build, (b_local, local.scale), ctx)
    x = from_pencils(mesh.comm.global_vector(res.x), a.grid, (sx, sy))
    return dataclasses.replace(res, x=x)


def _resolve_exchange_mode(exchange, plan=None) -> str:
    """The partition-time exchange mode of the allgather-family CSR
    lane: an explicit ``exchange=`` always wins; otherwise the plan's
    scored lane runs (the planner priced that wire); an unplanned
    ``"auto"`` defers to the coupled-volume rule; and bare ``None``
    without a plan is the legacy allgather, bit-identical."""
    if exchange in ("gather", "allgather"):
        return exchange
    if plan is not None:
        lane = getattr(plan, "exchange", "allgather")
        return lane if lane in ("gather", "auto") else "allgather"
    return "auto" if exchange == "auto" else "allgather"


def _local_rows(arr, mesh):
    """This process's shards' rows of a stacked ``(P, ...)`` host array,
    on the mesh's device."""
    ids = list(mesh.comm.shard_ids)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(arr)[ids]),
                           device=mesh.device)


def _resume_state(resume_from, parts, mesh, axis) -> CGCheckpoint:
    """A distributed checkpoint (global padded vectors, reduced scalars;
    tensors or host arrays) laid out on the mesh: each vector sharded
    like ``b``, each scalar on the mesh's device."""
    n_rows = int(resume_from.x.shape[0])
    if n_rows != parts.n_global_padded:
        raise ValueError(
            f"resume_from checkpoint has {n_rows} rows but this "
            f"partition's padded layout has {parts.n_global_padded}: the "
            f"checkpoint belongs to a different plan/mesh layout (resume "
            f"under the layout that wrote it - utils.checkpoint."
            f"solve_resumable_distributed fingerprints this)")
    return CGCheckpoint(
        **{name: shard_vector(getattr(resume_from, name), mesh, axis)
           for name in ("x", "r", "p")},
        **{name: torch.as_tensor(getattr(resume_from, name),
                                 device=mesh.device).reshape(())
           for name in ("rho", "rr", "nrm0", "k", "indefinite")})


def _prepare_deflate(space, parts, plan, mesh, axis):
    """A space's ``W``/``AW`` through the permute/pad/shard pipeline of
    ``b`` (the padding rows are zero rows of ``W``, inert in every
    projection), and its Cholesky factor on the mesh's device."""
    def sharded(v):
        host = part._host(v)
        if plan is not None and plan.permutation is not None:
            host = host[plan.permutation]
        return shard_vector(_padded_rows(host, parts), mesh, axis)

    return (sharded(space.w), sharded(space.aw),
            torch.as_tensor(part._host(space.chol), device=mesh.device))


def _solve_csr(a, b, mesh, axis, n_shards, precond, record_history, kw,
               csr_comm: str = "allgather", plan=None, exchange=None,
               x0=None, resume_from=None, return_checkpoint: bool = False,
               iter_cap=None, deflate=None) -> CGResult:
    if csr_comm == "ring-shiftell":
        return _solve_csr_shiftell(a, b, mesh, axis, n_shards, precond,
                                   record_history, kw, plan=plan)
    ring = csr_comm == "ring"
    a, b_np = _apply_plan_permutation(
        a, b.to(a.dtype).detach().cpu().numpy(), plan)
    if x0 is not None and plan is not None \
            and plan.permutation is not None:
        x0 = part._host(x0)[plan.permutation]
    ranges = plan.row_ranges if plan is not None else None
    if ring:
        parts = part.ring_partition_csr(a, n_shards, ranges)
        resolved = "ring"
    else:
        parts = part.partition_csr(
            a, n_shards, ranges,
            exchange=_resolve_exchange_mode(exchange, plan))
        resolved = "gather" if parts.halo is not None else "allgather"
    _note_partition(a, parts, plan)
    b_local = shard_vector(_padded_rows(b_np, parts), mesh, axis)
    n_local = parts.n_local
    sched = parts.halo if not ring else None
    gather = sched is not None
    if ring:
        data, cols, rows = (tuple(_local_rows(v, mesh) for v in field)
                            for field in (parts.data, parts.cols,
                                          parts.local_rows))
    else:
        data, cols, rows = (_local_rows(v, mesh) for v in
                            (parts.data, parts.cols, parts.local_rows))
    send = tuple(_local_rows(r.send_idx, mesh) for r in sched.rounds) \
        if gather else ()
    shifts = tuple(r.shift for r in sched.rounds) if gather else ()
    geometry = tuple((r.shift, r.m) for r in sched.rounds) \
        if gather else None
    # the resume lanes' state and cap are arguments of the one cached
    # solver, never parts of its key: every segment reuses it
    x0_local = None if x0 is None else shard_vector(
        _padded_rows(part._host(x0), parts), mesh, axis)
    resume = None if resume_from is None \
        else _resume_state(resume_from, parts, mesh, axis)
    key = cache_key_parts(
        "csr", ring=ring, exchange=resolved, geometry=geometry,
        n_local=n_local, n_shards=n_shards, axis=axis, mesh=mesh,
        precond=precond, record_history=record_history,
        solver_kw=tuple(sorted(kw.items())),
        deflate=None if deflate is None else int(deflate.k),
        plan=plan.fingerprint() if plan is not None else None)
    space_ops = None if deflate is None \
        else _prepare_deflate(deflate, parts, plan, mesh, axis)

    def build():
        def run(b_local, data_s, cols_s, rows_s, send_s, x0_l=None,
                resume_l=None, cap=None, return_checkpoint=False,
                space_ops=None):
            if gather:
                op = DistCSRGather(
                    data=data_s, cols=cols_s, local_rows=rows_s,
                    send_idx=send_s, shifts=shifts, n_local=n_local,
                    axis_name=axis, n_shards=n_shards)
            else:
                op_cls = DistCSRRing if ring else DistCSR
                op = op_cls(data=data_s, cols=cols_s, local_rows=rows_s,
                            n_local=n_local, axis_name=axis,
                            n_shards=n_shards)
            m = _make_precond(precond, op, axis)
            return cg(op, b_local, x0_l, m=m,
                      record_history=record_history, axis_name=axis,
                      resume_from=resume_l,
                      return_checkpoint=return_checkpoint, iter_cap=cap,
                      deflate=_local_space(deflate, space_ops), **kw)
        return shard_map(run, mesh=mesh)

    ctx = dict(kind="csr-gather" if gather else "csr",
               check_every=kw["check_every"], method=kw["method"],
               n_shards=n_shards, exchange=resolved,
               **({"plan": plan.label} if plan is not None else {}))
    if gather:
        itemsize = np.asarray(parts.data).dtype.itemsize
        ctx["halo_padding_fraction"] = round(sched.padding_fraction(), 6)
        ctx["halo_wire_bytes_per_matvec"] = \
            sched.wire_bytes_per_matvec(itemsize)
    if deflate is not None:
        ctx["deflate_k"] = int(deflate.k)
    res = _run_solver(key, build, (
        b_local, data, cols, rows, send, x0_local, resume, iter_cap,
        return_checkpoint, space_ops), ctx)
    _note_memory(parts, (data, cols, rows, send), key, mesh,
                 flight=kw.get("flight"), basis=kw.get("basis"))
    return _global_result(res, mesh, _unpad_rows(parts, plan, mesh.device))


def _local_space(space, space_ops):
    """The per-shard ``RecycleSpace`` of a deflated dispatch: the
    space's identity with its sharded operands (``None`` undeflated)."""
    if space_ops is None:
        return None
    from ..solver.recycle import RecycleSpace

    w, aw, chol = space_ops
    return RecycleSpace(w=w, aw=aw, chol=chol, n=space.n, k=space.k,
                        layout=space.layout)


def ring_step_tensors(parts, mesh):
    """The per-step ``(vals, cols, slice_ptr)`` tuples of this process's
    shards of a ring shift-ELL partition, each step's slabs packed as one
    sliced ELL over the local shards' stacked rows
    (``partition.stack_ring_step``), on the mesh's device."""
    ids = tuple(mesh.comm.shard_ids)
    steps = [part.stack_ring_step(parts, t, ids)
             for t in range(parts.n_shards)]
    return tuple(tuple(torch.as_tensor(getattr(p, f), device=mesh.device)
                       for p in steps)
                 for f in ("vals", "cols", "slice_ptr"))


def _solve_csr_shiftell(a, b, mesh, axis, n_shards, precond,
                        record_history, kw, plan=None) -> CGResult:
    """The ring schedule on the hand SpMV B8 (``DistShiftELLRing``)."""
    a, b_np = _apply_plan_permutation(
        a, b.to(a.dtype).detach().cpu().numpy(), plan)
    parts = part.ring_partition_shiftell(
        a, n_shards,
        row_ranges=plan.row_ranges if plan is not None else None)
    _note_partition(a, parts, plan)
    b_local = shard_vector(_padded_rows(b_np, parts), mesh, axis)
    vals, cols, slice_ptr = ring_step_tensors(parts, mesh)
    diag = _local_rows(parts.diag, mesh).reshape(-1)
    n_local = parts.n_local
    key = cache_key_parts(
        "csr-shiftell", n_local=n_local, n_shards=n_shards, axis=axis,
        mesh=mesh, precond=precond,
        record_history=record_history,
        solver_kw=tuple(sorted(kw.items())),
        plan=plan.fingerprint() if plan is not None else None)

    def build():
        def run(b_local, vals_s, cols_s, slice_ptr_s, diag_s):
            op = DistShiftELLRing(
                vals=vals_s, cols=cols_s, slice_ptr=slice_ptr_s, diag=diag_s,
                h=parts.h, kc=parts.kc, n_local=n_local, axis_name=axis,
                n_shards=n_shards)
            m = _make_precond(precond, op, axis)
            return cg(op, b_local, m=m, record_history=record_history,
                      axis_name=axis, **kw)
        return shard_map(run, mesh=mesh)

    ctx = dict(kind="csr-shiftell", check_every=kw["check_every"],
               method=kw["method"], n_shards=n_shards,
               **({"plan": plan.label} if plan is not None else {}))
    res = _run_solver(key, build, (b_local, vals, cols, slice_ptr, diag),
                      ctx)
    _note_memory(parts, (vals, cols, slice_ptr, diag), key, mesh,
                 flight=kw.get("flight"))
    return _global_result(res, mesh, _unpad_rows(parts, plan, mesh.device))


# -- the many-RHS lane ---------------------------------------------------------
#
# Production traffic is many medium systems against one operator, and
# the SpMV is bound by memory: every extra right-hand side riding one
# sweep of the matrix is nearly free.  A k-lane solve pays one matrix
# sweep (one SpMM) and one halo exchange (one all_gather, or the gather
# rounds each carrying an (m_r, k) slab) per iteration, and one psum per
# inner product: the collectives per iteration of the single-RHS solve.


class ManyRHSDispatcher:
    """Partition once, dispatch many: the static half of
    :func:`solve_distributed_many` resolved once - partition, gather
    schedule and the matrix blocks on the mesh's device - so that
    :meth:`solve` only pads and shards ``b`` and consults the solver
    cache.  ``inject=`` arms a ``robust.FaultPlan`` into every dispatch
    (``method="batched"`` only); ``plan=`` is resolved once
    (``resolve_plan``): its permutation applies to the rows of every
    ``B``, its split and exchange lane to the partition."""

    def __init__(self, a, *, mesh: Optional[Mesh] = None,
                 n_devices: Optional[int] = None, maxiter: int = 2000,
                 preconditioner: Optional[str] = None,
                 method: str = "batched", check_every: int = 1,
                 compensated: bool = False, flight=None, plan=None,
                 exchange=None, inject=None):
        from ..solver.many import MANY_METHODS

        if mesh is None:
            mesh = make_mesh(n_devices)
        if len(mesh.axis_names) != 1:
            raise ValueError(
                "solve_distributed_many runs on a 1-D mesh (the pencil "
                "decomposition is stencil-only, and stencils are "
                "single-RHS here)")
        if not isinstance(a, CSRMatrix):
            raise TypeError(
                f"solve_distributed_many supports assembled CSRMatrix "
                f"problems; {type(a).__name__} operators are "
                f"single-RHS on a mesh (use solve_distributed per "
                f"column)")
        if method not in MANY_METHODS:
            raise ValueError(f"unknown method {method!r}; expected one "
                             f"of {MANY_METHODS}")
        if preconditioner not in (None, "jacobi"):
            raise ValueError(
                f"solve_distributed_many supports preconditioner None "
                f"or 'jacobi' (got {preconditioner!r}); the "
                f"chebyshev/mg applications are single-vector on a "
                f"mesh")
        if exchange not in (None, "auto", "gather", "allgather"):
            raise ValueError(
                f"unknown exchange: {exchange!r} (expected 'auto', "
                f"'gather', 'allgather' or None; the ring schedules "
                f"rotate single x-blocks and do not batch)")
        if flight is not None:
            if method != "batched":
                raise ValueError(
                    "the batched flight recorder needs "
                    "method='batched' (block-CG's recurrence scalars "
                    "are k x k matrices)")
            flight = flight.without_heartbeat()
        if inject is not None:
            _check_inject(inject, mesh, method, "batched")
        self.inject = inject
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = int(mesh.size)
        self.n = int(a.shape[0])
        self.maxiter = int(maxiter)
        self.preconditioner = preconditioner
        self.method = method
        self.check_every = int(check_every)
        self.compensated = bool(compensated)
        self.flight = flight
        self.plan = resolve_plan(
            plan, a, self.n_shards,
            exchange=_plan_exchange_hint("allgather", exchange))
        self._perm = (self.plan.permutation
                      if self.plan is not None else None)
        ap = a.permuted(self._perm) if self._perm is not None else a
        self.parts = part.partition_csr(
            ap, self.n_shards,
            self.plan.row_ranges if self.plan is not None else None,
            exchange=_resolve_exchange_mode(exchange, self.plan))
        self.resolved_exchange = ("gather" if self.parts.halo is not None
                                  else "allgather")
        # Krylov recycling: the operator's layout token (computed on the
        # first deflated dispatch) and a one-slot cache of the last
        # space's padded, sharded operands
        self._space_layout_token = None
        self._deflate_slot = (None, None)
        self._a_for_layout = a
        _note_partition(ap, self.parts, self.plan)
        self._data, self._cols, self._rows = (
            _local_rows(v, mesh) for v in (self.parts.data, self.parts.cols,
                                           self.parts.local_rows))
        sched = self.parts.halo
        self._gather = sched is not None
        self._send = tuple(_local_rows(r.send_idx, mesh)
                           for r in sched.rounds) if self._gather else ()
        self._shifts = tuple(r.shift for r in sched.rounds) \
            if self._gather else ()
        geometry = tuple((r.shift, r.m) for r in sched.rounds) \
            if self._gather else None
        # everything but n_rhs: each dispatch key extends this prefix
        self._key_base = cache_key_parts(
            "csr-many", method=method,
            exchange=self.resolved_exchange, geometry=geometry,
            n_local=self.parts.n_local, n_shards=self.n_shards,
            axis=self.axis, mesh=mesh, precond=preconditioner,
            check_every=self.check_every,
            compensated=self.compensated, flight=flight,
            maxiter=self.maxiter,
            plan=(self.plan.fingerprint()
                  if self.plan is not None else None),
            fault=inject)

    def live_device_arrays(self):
        """The device arrays this dispatcher holds for its lifetime: the
        sharded partition (values, columns, rows, gather send maps) -
        the measured twin of ``telemetry.memscope.matrix_bytes_per_shard
        (self.parts)``; their summed bytes equal the model's exactly."""
        return (self._data, self._cols, self._rows, self._send)

    def memory_footprint(self, *, n_rhs: int = 1, hbm_bytes="auto",
                         model=None):
        """This dispatcher's :class:`telemetry.memscope.MemoryFootprint`
        at dispatch width ``n_rhs`` (pinned partition bytes + modeled
        per-solve working set; no solve).  ``hbm_bytes="auto"`` without
        a ``model`` classifies against the mesh device's capacity."""
        from ..telemetry import memscope

        if hbm_bytes == "auto" and model is None:
            hbm_bytes = memscope.hbm_bytes_for(backend=str(self.mesh.device))
        return memscope.footprint_for_partition(
            self.parts, n_rhs=n_rhs,
            flight_capacity=(self.flight.capacity
                             if self.flight is not None else 0),
            hbm_bytes=hbm_bytes, model=model)

    def space_layout_token(self) -> str:
        """The ``recycle.space_layout`` token of this dispatcher's
        operator (cached: the fingerprint walk is O(nnz))."""
        if self._space_layout_token is None:
            from ..solver.recycle import space_layout

            self._space_layout_token = space_layout(self._a_for_layout)
        return self._space_layout_token

    def _deflate_operands(self, space):
        """A RecycleSpace's padded, sharded operands for this partition
        (one-slot cache per space object)."""
        cached_space, operands = self._deflate_slot
        if cached_space is space:
            return operands
        if space.layout != self.space_layout_token():
            from ..solver.recycle import RecycleMismatch

            raise RecycleMismatch(
                f"RecycleSpace layout {space.layout!r} does not match "
                f"this dispatcher's operator "
                f"({self.space_layout_token()!r}): harvest a space "
                f"from THIS operator (never a wrong-space deflation)")
        operands = _prepare_deflate(space, self.parts, self.plan, self.mesh,
                                    self.axis)
        self._deflate_slot = (space, operands)
        return operands

    def solve(self, b, *, tol=1e-7, rtol=0.0, deflate=None,
              basis=None, flight=None):
        """One batched solve of ``A X = B`` (``B (n, k)``) on the
        prepared partition; see :func:`solve_distributed_many`.

        ``deflate``/``basis``: the Krylov-recycling lanes (operands
        prepared once per space and cached).  ``flight`` overrides the
        construction-time recorder for this dispatch only (it joins the
        solver-cache key)."""
        from ..solver.many import cg_many

        b_np = part._host(b)
        if b_np.ndim != 2:
            raise ValueError(
                f"solve_distributed_many solves a column stack: b "
                f"must be (n, k), got shape {b_np.shape}")
        if self.n != b_np.shape[0]:
            raise ValueError(
                f"operator has {self.n} rows, rhs stack has shape "
                f"{b_np.shape}")
        if not np.issubdtype(b_np.dtype, np.floating):
            b_np = b_np.astype(np.result_type(float))
        n_rhs = int(b_np.shape[1])
        flight_override = flight is not None
        eff_flight = (flight.without_heartbeat() if flight_override
                      else self.flight)
        from ..solver.recycle import check_recycling

        check_recycling(deflate, basis, method=self.method, rides="batched",
                        flight=eff_flight)
        if deflate is not None and self.inject is not None:
            raise ValueError(
                "deflate= on a fault-injected dispatcher is "
                "unsupported (the chaos harness drills the "
                "undeflated recurrence)")
        space_ops = (None if deflate is None
                     else self._deflate_operands(deflate))
        _note_engine("distributed-many", self.method, self.check_every,
                     n_shards=self.n_shards, n_rhs=n_rhs,
                     **_flight_extra(eff_flight),
                     **({"deflate_k": deflate.k}
                        if deflate is not None else {}))
        if self._perm is not None:
            b_np = b_np[self._perm]
        b_local = shard_vector(_padded_rows(b_np, self.parts), self.mesh,
                               self.axis)
        mesh, axis, gather = self.mesh, self.axis, self._gather
        n_local, n_shards = self.parts.n_local, self.n_shards
        shifts, method = self._shifts, self.method
        preconditioner = self.preconditioner
        maxiter, check_every = self.maxiter, self.check_every
        compensated = self.compensated
        fault = self.inject
        key = self._key_base + (("n_rhs", n_rhs),)
        if flight_override:
            key = key + (("flight_override", eff_flight),)
        if basis is not None:
            key = key + (("basis", basis),)
        if deflate is not None:
            key = key + (("deflate", int(deflate.k)),)

        def build():
            def run(b_local, data_s, cols_s, rows_s, tol_s, rtol_s, send_s,
                    space_ops):
                if gather:
                    op = DistCSRGather(
                        data=data_s, cols=cols_s, local_rows=rows_s,
                        send_idx=send_s, shifts=shifts, n_local=n_local,
                        axis_name=axis, n_shards=n_shards)
                else:
                    op = DistCSR(data=data_s, cols=cols_s,
                                 local_rows=rows_s, n_local=n_local,
                                 axis_name=axis, n_shards=n_shards)
                m = _make_precond((preconditioner, 0), op, axis)
                return cg_many(op, b_local, tol=tol_s, rtol=rtol_s,
                               maxiter=maxiter, m=m, axis_name=axis,
                               check_every=check_every, method=method,
                               compensated=compensated, flight=eff_flight,
                               fault=fault,
                               deflate=_local_space(deflate, space_ops),
                               basis=basis)
            return shard_map(run, mesh=mesh)

        ctx = dict(kind="csr-gather-many" if gather else "csr-many",
                   check_every=check_every, method=method,
                   n_shards=n_shards, n_rhs=n_rhs,
                   exchange=self.resolved_exchange,
                   **({"plan": self.plan.label}
                      if self.plan is not None else {}))
        if gather:
            sched = self.parts.halo
            itemsize = np.asarray(self.parts.data).dtype.itemsize
            ctx["halo_padding_fraction"] = \
                round(sched.padding_fraction(), 6)
            # the per-round slabs carry k columns each: the padded
            # per-matvec wire scales by n_rhs
            ctx["halo_wire_bytes_per_matvec"] = \
                sched.wire_bytes_per_matvec(itemsize) * n_rhs
        if deflate is not None:
            ctx["deflate_k"] = int(deflate.k)
        res = _run_solver(key, build, (
            b_local, self._data, self._cols, self._rows, tol, rtol,
            self._send, space_ops), ctx)
        _note_memory(self.parts, self.live_device_arrays(), key, self.mesh,
                     n_rhs=n_rhs, flight=eff_flight, basis=basis)
        return _unpad_result_many(res, self.parts, self.plan, self.mesh)


def solve_distributed_many(
    a,
    b,
    *,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    tol=1e-7,
    rtol=0.0,
    maxiter: int = 2000,
    preconditioner: Optional[str] = None,
    method: str = "batched",
    check_every: int = 1,
    compensated: bool = False,
    flight=None,
    plan=None,
    exchange=None,
    inject=None,
):
    """Solve ``A X = B`` for a column stack ``B (n, k)`` over a mesh.

    The many-RHS sibling of :func:`solve_distributed`: the per-shard body
    is ``solver.many.cg_many`` (masked batched or block CG) over the
    ``DistCSR``/``DistCSRGather`` partition, and each iteration ships all
    ``k`` columns through one exchange.  Lanes of a ``method="batched"``
    solve at ``check_every=1`` are bit-identical to the single-RHS
    distributed solves of their columns.

    Scope (everything else refuses): assembled ``CSRMatrix`` operators on
    a 1-D mesh, the allgather/gather exchange lanes, ``preconditioner``
    ``None`` or ``"jacobi"``, methods ``"batched"``/``"block"``;
    ``flight`` (batched only) carries the per-lane recorder; ``inject``
    a ``robust.FaultPlan`` (batched only: a ``reduction`` plan breaks
    lane ``inject.lane`` alone).  ``plan=`` composes exactly as in
    :func:`solve_distributed` (the plan's permutation applies to the
    ROWS of ``B``; its exchange lane is honored).  Returns a
    ``solver.many.CGBatchResult`` whose ``x`` is the global ``(n, k)``
    stack.  Repeat callers construct a
    :class:`ManyRHSDispatcher` once instead.
    """
    return ManyRHSDispatcher(
        a, mesh=mesh, n_devices=n_devices, maxiter=maxiter,
        preconditioner=preconditioner, method=method,
        check_every=check_every, compensated=compensated,
        flight=flight, plan=plan, exchange=exchange, inject=inject,
    ).solve(b, tol=tol, rtol=rtol)


def _unpad_result_many(res, parts, plan, mesh):
    """The per-shard many-RHS result made global: the solution stack's
    rows gathered and cut to the caller's rows in the caller's order,
    the basis ring's vectors likewise; the per-lane tensors pass
    through."""
    rows = _unpad_rows(parts, plan, mesh.device)
    x = mesh.comm.global_vector(res.x)[rows]
    basis = res.basis
    if basis is not None:
        its, vecs = basis
        vecs = mesh.comm.global_vector(vecs.t().contiguous()).t()
        basis = (its, vecs[:, rows])
    return dataclasses.replace(res, x=x, basis=basis)
