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
assembled CSR with ``csr_comm="allgather"`` (``exchange=None``,
``"allgather"``, ``"gather"`` or ``"auto"``) and ``csr_comm="ring"``;
``method`` cg, cg1, pipecg and minres; ``preconditioner`` None,
``"jacobi"`` and ``"chebyshev"`` (minres takes none).  The arguments of
lanes not ported yet are accepted and raise ``NotImplementedError``
naming their ROADMAP item.
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
from ..models.precond import ChebyshevPreconditioner
from ..solver.cg import CGCheckpoint, CGResult, cg
from . import partition as part
from .comm import shard_map
from .mesh import Mesh, make_mesh, shard_vector
from .operators import (
    DistCSR,
    DistCSRGather,
    DistCSRRing,
    DistStencil2D,
    DistStencil3D,
)


def _refuse(feature: str, item: str):
    raise NotImplementedError(
        f"solve_distributed: {feature} is not ported yet (ROADMAP {item})")


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
        (the process group, or every CUDA device).
      preconditioner: ``None``, ``"jacobi"`` or ``"chebyshev"`` (degree
        ``precond_degree``; its power-iteration estimate and every
        application run inside the per-shard body, reducing over the
        mesh).  ``"bjacobi"`` is single-device only; ``"mg"`` is not
        ported yet (ROADMAP A8).
      method: ``"cg"``, ``"cg1"`` (one reduction per iteration),
        ``"pipecg"`` or ``"minres"`` (the symmetric-indefinite solver,
        ``solver.minres``, unpreconditioned: a preconditioner is refused
        as ``solver.cg`` refuses it), its dots reduced over the mesh.
      csr_comm: general-CSR schedule - ``"allgather"`` or ``"ring"``
        (``"ring-shiftell"`` waits for its B8/B9 lane).
      exchange: the CSR halo wire on the allgather lane - ``"gather"``
        ships only the coupled x entries, ``"allgather"`` the full x,
        ``"auto"`` takes the gather schedule when its padded wire is
        below ``exchange.AUTO_WIRE_FRACTION`` of the dense one, ``"ring"``
        is ``csr_comm="ring"``; ``None`` the legacy allgather.
      validate: a finiteness check of ``b`` and the operator's
        coefficients before the solve (a non-finite value raises
        ``ValueError``); ``False`` skips it.
      flight, plan, x0, resume_from, return_checkpoint, iter_cap,
      inject, deflate, basis: not ported yet; each raises naming its
      ROADMAP item.
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
        _check_finite_problem(a, b)
        if x0 is not None:
            _check_finite_rhs(x0, what="x0")
    if deflate is not None or basis is not None:
        feature = "deflate= (Krylov recycling)" if deflate is not None \
            else "basis= (the recycling harvest ring)"
        if not isinstance(a, CSRMatrix) or csr_comm != "allgather":
            raise ValueError(
                f"{feature} rides the assembled-CSR allgather/gather "
                f"lanes only (got {type(a).__name__}, csr_comm="
                f"{csr_comm!r}, exchange={exchange!r})")
        if method != "cg":
            raise ValueError(
                f"{feature} requires method='cg' (got {method!r})")
        _refuse(feature, "A14")
    resumable = (x0 is not None or resume_from is not None
                 or return_checkpoint or iter_cap is not None)
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
        _refuse(feature, "A15" if inject is not None else "A13")
    if flight is not None:
        _refuse("flight= (the flight recorder)", "A9")
    if plan is not None:
        _refuse("plan= (partition planning)", "A10 residue: balance/")
    if preconditioner == "mg":
        _refuse("preconditioner='mg'", "A8")
    if len(mesh.axis_names) != 1:
        _refuse("a 2-D mesh (pencil decomposition)",
                "A10 residue: pencil meshes")
    if csr_comm == "ring-shiftell":
        _refuse("csr_comm='ring-shiftell' (shift-ELL slabs on B8)",
                "A10 residue: ring-shiftell")
    kw = dict(tol=tol, rtol=rtol, maxiter=maxiter, method=method,
              check_every=check_every, compensated=compensated)
    precond = (preconditioner, precond_degree)
    axis = mesh.axis_names[0]
    n_shards = mesh.size
    if isinstance(a, (Stencil2D, Stencil3D)):
        return _solve_stencil(a, b, mesh, axis, n_shards, precond,
                              record_history, kw)
    if isinstance(a, CSRMatrix):
        return _solve_csr(a, b, mesh, axis, n_shards, precond,
                          record_history, kw, csr_comm=csr_comm,
                          exchange=exchange)
    raise TypeError(f"solve_distributed supports CSRMatrix/Stencil2D/"
                    f"Stencil3D, got {type(a).__name__}")


# -- validation ---------------------------------------------------------------


def _count_nonfinite(v) -> int:
    v = torch.as_tensor(v)
    if not v.dtype.is_floating_point:
        return 0
    return int((~torch.isfinite(v)).sum())


def _check_finite_rhs(b, *, what: str = "b") -> None:
    """``ValueError`` when the right-hand side carries a non-finite entry
    (the JAX ``robust.validate.check_finite_rhs``)."""
    bad = _count_nonfinite(b)
    if bad:
        raise ValueError(
            f"{what} carries {bad} non-finite entr"
            f"{'y' if bad == 1 else 'ies'} (NaN/Inf): the solve would "
            f"spin a poisoned recurrence to its first health check and "
            f"report BREAKDOWN. Fix the input, or pass validate=False "
            f"to stage the fault deliberately.")


def _check_finite_problem(a, b=None) -> None:
    """The operator's coefficient arrays (and the rhs) must be finite
    (the JAX ``robust.validate.check_finite_problem``)."""
    if b is not None:
        _check_finite_rhs(b)
    for name in ("data", "vals", "scale", "diag"):
        v = getattr(a, name, None)
        if v is None:
            continue
        bad = _count_nonfinite(v)
        if bad:
            raise ValueError(
                f"operator {type(a).__name__}.{name} carries {bad} "
                f"non-finite entr{'y' if bad == 1 else 'ies'} "
                f"(NaN/Inf): refusing to solve a poisoned system. "
                f"Fix the matrix, or pass validate=False to stage the "
                f"fault deliberately.")


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
            _SOLVER_CACHE.popitem(last=False)
    return fn


# -- the lanes ----------------------------------------------------------------


def _make_precond(precond, local, axis):
    """The preconditioner, built inside the per-shard body: the
    Chebyshev estimate's reductions and every application run over
    ``axis``."""
    name, degree = precond
    if name == "jacobi":
        return JacobiPreconditioner.from_operator(local)
    if name == "chebyshev":
        return ChebyshevPreconditioner.from_operator(
            local, degree=degree, axis_name=axis)
    return None


def _global_result(res: CGResult, mesh: Mesh, n_global=None) -> CGResult:
    """The per-shard result with ``x`` made global (gathered on a process
    group) and cut to ``n_global`` rows."""
    x = mesh.comm.global_vector(res.x)
    if n_global is not None:
        x = x[:n_global]
    return dataclasses.replace(res, x=x)


def _solve_stencil(a, b, mesh, axis, n_shards, precond, record_history,
                   kw) -> CGResult:
    cls = DistStencil2D if isinstance(a, Stencil2D) else DistStencil3D
    local = cls.create(a.grid, n_shards, axis_name=axis, scale=a.scale,
                       dtype=a.dtype, backend=a.backend, device=mesh.device)
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

    res = _cached_solver(key, build)(b_local, local.scale)
    return _global_result(res, mesh)


def _resolve_exchange_mode(exchange) -> str:
    """The partition-time exchange mode of the allgather-family CSR lane
    (unplanned): an explicit ``exchange=`` wins, ``"auto"`` defers to
    the coupled-volume rule, ``None`` is the legacy allgather."""
    if exchange in ("gather", "allgather"):
        return exchange
    return "auto" if exchange == "auto" else "allgather"


def _local_rows(arr, mesh):
    """This process's shards' rows of a stacked ``(P, ...)`` host array,
    on the mesh's device."""
    ids = list(mesh.comm.shard_ids)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(arr)[ids]),
                           device=mesh.device)


def _solve_csr(a, b, mesh, axis, n_shards, precond, record_history, kw,
               csr_comm: str = "allgather", exchange=None) -> CGResult:
    ring = csr_comm == "ring"
    if ring:
        parts = part.ring_partition_csr(a, n_shards)
        resolved = "ring"
    else:
        parts = part.partition_csr(a, n_shards,
                                   exchange=_resolve_exchange_mode(exchange))
        resolved = "gather" if parts.halo is not None else "allgather"
    b_pad = part.pad_vector(b.to(a.dtype).detach().cpu().numpy(),
                            parts.n_global_padded)
    b_local = shard_vector(b_pad, mesh, axis)
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
    key = cache_key_parts(
        "csr", ring=ring, exchange=resolved, geometry=geometry,
        n_local=n_local, n_shards=n_shards, axis=axis, mesh=mesh,
        precond=precond, record_history=record_history,
        solver_kw=tuple(sorted(kw.items())))

    def build():
        def run(b_local, data_s, cols_s, rows_s, send_s):
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
            return cg(op, b_local, m=m, record_history=record_history,
                      axis_name=axis, **kw)
        return shard_map(run, mesh=mesh)

    res = _cached_solver(key, build)(b_local, data, cols, rows, send)
    return _global_result(res, mesh, parts.n_global)
