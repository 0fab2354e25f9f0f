"""The distributed f64 lane: CG at the reference's precision over a slab
mesh.

Counterpart of the JAX package's ``parallel/df64.py``.  The reference's
two defining traits are float64 arithmetic (``CUDA_R_64F``,
``CUDACG.cu:216,288``) and, by its name, distribution; this module joins
them.  The JAX package carries every vector as a double-float ``(hi,
lo)`` f32 pair and moves both words in one ``ppermute``; an H100 has
native FP64, so the port's slab is a float64 ``DistStencil2D/3D``
(``parallel.operators``, ``backend="pallas"``: the f64 instance of
B1/B2 on each slab, one exchange of the f64 edge planes a matvec), and
the per-shard body is the single-device ``solver.df64`` recurrence with
its dots reduced over the mesh (``axis_name``), in the comm's fixed
shard order.

An assembled ``CSRMatrix`` takes the ring schedule on float64 sliced-ELL
slabs (``DistShiftELLDF64Ring``: each ring step one launch of the f64
hand SpMV B9), the reference's f64 CSR SpMV across devices.

A ``Stencil3D`` on a 2-D mesh (``make_mesh_2d``) runs on float64
pencils (``DistStencil3DPencil``): x and y partitioned, the dots reduced
over both mesh axes, the cg family only.

``solve_distributed_df64`` runs on a stacked mesh (P shards of one
device) or a process group, as ``solve_distributed`` does; its CSR lane
takes ``plan=`` (a ``balance.PartitionPlan`` or ``"auto"``, priced for
the ring).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.operators import CSRMatrix, Stencil2D, Stencil3D
from ..ops import df64 as df
from ..solver.df64 import (
    DF64CGResult,
    _F64Operator,
    _coerce_rhs_df,
    _dispatch,
    _prepare_operator,
    chebyshev_interval,
)
from . import comm as cm
from . import partition as part
from .dist_cg import (
    _cached_solver,
    _local_rows,
    _note_partition,
    _note_shards,
    _unpad_rows,
    cache_key_parts,
    clear_solver_cache,
    resolve_plan,
    ring_step_tensors,
)
from .mesh import Mesh, make_mesh, shard_vector
from .operators import (
    DistShiftELLDF64Ring,
    DistStencil2D,
    DistStencil3D,
    DistStencil3DPencil,
    from_pencils,
    to_pencils,
)


@dataclasses.dataclass(frozen=True)
class DistStencilDF64:
    """Local block of a slab-partitioned Poisson stencil in the f64 lane
    (the JAX ``DistStencilDF64``, with its fields).

    ``matvec`` is the native float64 product: a float64 ``DistStencil2D``
    or ``DistStencil3D`` slab with ``backend="pallas"`` (B1/B2 in double
    on the card, their twin on the CPU), one exchange of the f64 edge
    planes each.  ``matvec_df`` takes and returns ``(hi, lo)`` pairs.
    The scale is the pair's value in float64 (about 48 bits, as in the
    JAX package)."""

    scale_hi: torch.Tensor
    scale_lo: torch.Tensor
    local_grid: Tuple[int, ...]   # (lnx, ny) or (lnx, ny, nz)
    axis_name: str
    n_shards: int
    kind: str                     # "2d" | "3d"

    @classmethod
    def create(cls, global_grid, n_shards, axis_name="rows", scale=1.0,
               device=None) -> "DistStencilDF64":
        nx = global_grid[0]
        if nx % n_shards:
            raise ValueError(
                f"grid x-extent {nx} not divisible by {n_shards} shards")
        dev = resolve_device(device)
        sh, sl = df.split_f64(np.float64(float(scale)))
        return cls(scale_hi=torch.as_tensor(sh, device=dev),
                   scale_lo=torch.as_tensor(sl, device=dev),
                   local_grid=(nx // n_shards,) + tuple(global_grid[1:]),
                   axis_name=axis_name, n_shards=n_shards,
                   kind="2d" if len(global_grid) == 2 else "3d")

    @property
    def shape(self):
        n = cm.local_count(self.axis_name) * math.prod(self.local_grid)
        return (n, n)

    @property
    def device(self) -> torch.device:
        return self.scale_hi.device

    @functools.cached_property
    def _slab(self):
        """The float64 slab operator that computes ``matvec``."""
        cls = DistStencil2D if self.kind == "2d" else DistStencil3D
        return cls(scale=df.pair_to_f64(self.scale_hi, self.scale_lo),
                   local_grid=tuple(self.local_grid),
                   axis_name=self.axis_name, n_shards=self.n_shards,
                   backend="pallas", _dtype_name="float64")

    @property
    def diag(self) -> torch.Tensor:
        """diag(A), the constant centre weight times the scale: a 0-d
        float64 tensor (the Jacobi diagonal of ``solver.df64``)."""
        return (4.0 if self.kind == "2d" else 6.0) * self._slab.scale

    @property
    def diag_hi(self):
        return df.f64_to_pair(self.diag)[0]

    @property
    def diag_lo(self):
        return df.f64_to_pair(self.diag)[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._slab.matvec(x)

    #: the f64 lane's name for the float64 product (``ShiftELLDF64Matrix``)
    matvec64 = matvec

    def matvec_df(self, x):
        return df.f64_to_pair(self.matvec(df.pair_to_f64(*x)))


def solve_distributed_df64(
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
    check_every: int = 1,
    method: str = "cg",
    flight=None,
    plan=None,
) -> DF64CGResult:
    """f64-lane CG on a row-partitioned system over a mesh: stencil slabs
    or assembled CSR on the ring (the JAX ``solve_distributed_df64``).

    Semantics of ``solver.df64.cg_df64`` (absolute ``tol`` on ||r||,
    x0 = 0, the threshold ``max(tol^2, rtol^2 ||r0||^2)``, breakdown
    detection), with the dots reduced over the mesh and the halo
    exchange in float64.

    Args (the JAX function's):
      a: global ``Stencil2D``/``Stencil3D`` whose leading grid axis
        divides the mesh (a ``Stencil3D`` on a ``make_mesh_2d`` mesh:
        float64 pencils, methods cg, cg1 and pipecg; the Chebyshev
        interval the global operator's, the ``"mg"`` cycle on the f32
        pencil sibling), or a ``CSRMatrix`` (any row count: padding
        rows are solved as zeros and stripped), whose values are lifted
        to float64 and run on the ring of B9 slabs (methods cg, cg1,
        pipecg; None, jacobi or chebyshev).
      b: global right-hand side: float64 data as it is, an ``(hi, lo)``
        pair recombined, anything else upcast from f32.
      preconditioner: ``None``, ``"jacobi"``, ``"chebyshev"`` (degree
        ``precond_degree``; the interval of ``solver.df64.
        chebyshev_interval`` on the GLOBAL operator, on the host side) or
        ``"mg"`` (one f32 V-cycle through the distributed hierarchy of an
        f32 ``DistStencil2D/3D`` sibling of the slab, applied to the f64
        residual rounded to f32 and promoted back; ``method="cg"``).
      method: ``"cg"``, ``"cg1"`` / ``"pipecg"`` (one reduction of the
        stacked dots an iteration) or ``"minres"`` (unpreconditioned).
      flight: a ``telemetry.flight.FlightConfig`` on ``method="cg"``
        (heartbeat stripped): the recorded scalars are the reduced
        globals, the same on every shard.
      plan: on CSR a partition plan (``None``, ``"auto"`` or a
        ``balance.PartitionPlan``) resolved for the ring schedule
        (``dist_cg.resolve_plan(..., exchange="ring")``; a plan scored
        for the gather wire raises ``ValueError``); its permutation and
        variable-row split apply inside the solve and ``x`` comes back
        in the caller's row order.  Refused on stencils
        (``ValueError``), as in the JAX package.
      (mesh/n_devices/tol/rtol/maxiter/record_history/check_every as in
      ``solve_distributed`` / ``cg_df64``.)

    Returns:
      ``DF64CGResult`` with the global solution: ``x()`` float64 on the
      host, ``x64`` on the mesh's device (on every rank of a process
      group), ``x_hi``/``x_lo`` its split.
    """
    if mesh is None:
        mesh = make_mesh(n_devices)
    if preconditioner not in (None, "jacobi", "chebyshev", "mg"):
        raise ValueError(
            f"solve_distributed_df64 supports preconditioner=None, "
            f"'jacobi', 'chebyshev' or 'mg', got {preconditioner!r}")
    if preconditioner in ("chebyshev", "mg") and method != "cg":
        raise ValueError(
            f"preconditioner={preconditioner!r} requires method='cg' "
            f"in df64")
    if preconditioner == "mg" and not isinstance(a, (Stencil2D, Stencil3D)):
        raise ValueError(
            "preconditioner='mg' needs a matrix-free stencil operator "
            "(the geometric hierarchy rediscretizes the grid); assembled "
            "CSR supports jacobi or chebyshev")
    if method not in ("cg", "cg1", "pipecg", "minres"):
        raise ValueError(f"unknown method {method!r}; expected 'cg', "
                         f"'cg1', 'pipecg' or 'minres'")
    if flight is not None and method != "cg":
        raise ValueError(
            f"solve_distributed_df64 carries the flight recorder on "
            f"method='cg' only (got method={method!r}); use "
            f"record_history for the variants' dense trace")
    if flight is not None:
        flight = flight.without_heartbeat()
    if method == "minres":
        if preconditioner is not None:
            raise ValueError(
                "method='minres' is unpreconditioned in df64 "
                "(preconditioned MINRES needs an SPD M; use method='cg')")
        if not isinstance(a, (Stencil2D, Stencil3D)):
            raise TypeError(
                "distributed df64 minres supports matrix-free Stencil2D/"
                f"Stencil3D slabs, got {type(a).__name__}")
        if len(mesh.axis_names) == 2:
            raise ValueError(
                "distributed df64 minres supports 1-D (slab) meshes; "
                "pencil decomposition is cg-family only")
    if not isinstance(a, (CSRMatrix, Stencil2D, Stencil3D)):
        raise TypeError(
            f"solve_distributed_df64 supports matrix-free Stencil2D/"
            f"Stencil3D and assembled CSRMatrix (df64 ring-shiftell "
            f"schedule), got {type(a).__name__}")
    if plan is not None and not isinstance(a, CSRMatrix):
        raise ValueError(
            f"plan= applies to assembled CSRMatrix problems; "
            f"{type(a).__name__} slabs are uniform by construction "
            f"(nothing to rebalance)")
    b64 = _coerce_rhs_df(b).to(mesh.device)
    if tuple(b64.shape) != (a.shape[0],):
        raise ValueError(f"rhs shape {tuple(b64.shape)} does not match "
                         f"operator shape {a.shape}")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    solve_kw = dict(
        method=method, preconditioner=preconditioner,
        precond_degree=precond_degree, tol=tol, rtol=rtol, maxiter=maxiter,
        record_history=record_history, check_every=check_every,
        flight=flight)
    if len(mesh.axis_names) == 2:
        # pencil decomposition: two partitioned grid axes
        if not isinstance(a, Stencil3D):
            raise TypeError(
                "a 2-D mesh (pencil decomposition) supports Stencil3D "
                f"only, got {type(a).__name__}")
        return _solve_pencil_df64(a, b64, mesh, solve_kw)
    axis = mesh.axis_names[0]
    n_shards = mesh.size
    if isinstance(a, CSRMatrix):
        # the f64 CSR lane is the ring schedule: pin the planner to
        # ring pricing (a gather exchange has no f64 lane)
        return _solve_csr_shiftell_df64(
            a, b64, mesh, axis, n_shards, solve_kw,
            plan=resolve_plan(plan, a, n_shards, exchange="ring"))
    local = DistStencilDF64.create(a.grid, n_shards, axis_name=axis,
                                   scale=a.scale, device=mesh.device)
    # per-shard accounting (telemetry.shardscope): the f64 halos carry
    # 8 bytes a boundary point, as the JAX (hi, lo) planes do
    two_d = isinstance(a, Stencil2D)
    _note_shards(lambda ss: ss.report_stencil(
        local.local_grid, n_shards, 8, points=5 if two_d else 7,
        kind="stencil2d-df64" if two_d else "stencil3d-df64"))
    b_local = shard_vector(b64, mesh, axis)
    interval = _global_interval(a, preconditioner)
    backend = a.backend if preconditioner == "mg" else None
    key = cache_key_parts(
        "df64", local_grid=local.local_grid, operator=local.kind, axis=axis,
        mesh=mesh, precond=preconditioner, degree=precond_degree,
        backend=backend, record_history=record_history, maxiter=maxiter,
        check_every=check_every, method=method, flight=flight,
        tol=float(tol), rtol=float(rtol))

    def build():
        def run(b_loc, scale_hi, scale_lo, interval_t):
            loc = dataclasses.replace(local, scale_hi=scale_hi,
                                      scale_lo=scale_lo)
            if method == "minres":
                from ..solver.minres import minres_df64

                return minres_df64(loc, b_loc, tol=tol, rtol=rtol,
                                   maxiter=maxiter,
                                   record_history=record_history,
                                   axis_name=axis, check_every=check_every)
            mg = None
            if preconditioner == "mg":
                mg = _f32_hierarchy(loc, backend)
            return _local_solve(loc, b_loc, interval_t, mg, axis, solve_kw)
        return cm.shard_map(run, mesh=mesh)

    res = _cached_solver(key, build)(b_local, local.scale_hi,
                                     local.scale_lo, interval)
    return _global_result(res, mesh)


def _solve_pencil_df64(a, b64, mesh, solve_kw) -> DF64CGResult:
    """Stencil3D in the f64 lane over a 2-D mesh: float64 pencils
    (``DistStencil3DPencil``, four ``ppermute``s a matvec), the
    ``solver.df64`` recurrence with its dots reduced over BOTH mesh
    axes; ``"mg"`` runs its f32 V-cycle on the float32 pencil sibling."""
    ax_x, ax_y = mesh.axis_names
    shards = tuple(mesh.devices.shape)
    local = DistStencil3DPencil.create(a.grid, shards,
                                       axis_names=(ax_x, ax_y),
                                       scale=float(a.scale),
                                       dtype=torch.float64,
                                       device=mesh.device)
    b_local = mesh.comm.local_vector(to_pencils(b64, a.grid, shards))
    interval = _global_interval(a, solve_kw["preconditioner"])
    key = cache_key_parts(
        "pencil-df64", local_grid=local.local_grid, shards=shards,
        axes=(ax_x, ax_y), mesh=mesh,
        solve_kw=tuple(sorted(solve_kw.items())))

    def build():
        def run(b_loc, scale, interval_t):
            loc = dataclasses.replace(local, scale=scale)
            jacobi = solve_kw["preconditioner"] == "jacobi"
            op = _F64Operator(matvec=loc.matvec,
                              diag=6.0 * scale if jacobi else None,
                              n=loc.shape[0], device=loc.device)
            mg = None
            if solve_kw["preconditioner"] == "mg":
                from ..models.multigrid import MultigridPreconditioner

                mg = MultigridPreconditioner.from_operator(
                    dataclasses.replace(loc, scale=scale.float(),
                                        _dtype_name="float32"))
            return _dispatch(op, b_loc, interval=interval_t, mg=mg,
                             axis_name=(ax_x, ax_y), resume_from=None,
                             return_checkpoint=False, iter_cap=None,
                             **solve_kw)
        return cm.shard_map(run, mesh=mesh)

    res = _cached_solver(key, build)(b_local, local.scale, interval)
    x = from_pencils(mesh.comm.global_vector(res.x64), a.grid, shards)
    x_hi, x_lo = df.f64_to_pair(x)
    return dataclasses.replace(res, x64=x, x_hi=x_hi, x_lo=x_lo)


def _global_interval(a, preconditioner):
    """The Chebyshev interval from the GLOBAL operator, on the host side
    (every shard applies the same polynomial), or None."""
    return (chebyshev_interval(a) if preconditioner == "chebyshev"
            else None)


def _local_solve(loc, b_loc, interval, mg, axis, solve_kw):
    """The per-shard cg-family body: ``solver.df64``'s recurrence on the
    local block, its dots reduced over ``axis``."""
    jacobi = solve_kw["preconditioner"] == "jacobi"
    return _dispatch(_prepare_operator(loc, jacobi=jacobi), b_loc,
                     interval=interval, mg=mg, axis_name=axis,
                     resume_from=None, return_checkpoint=False,
                     iter_cap=None, **solve_kw)


def _global_result(res, mesh, rows=None):
    """The per-shard result with the global solution (gathered on a
    process group), cut to the caller's ``rows`` (``dist_cg.
    _unpad_rows``), and its split."""
    x = mesh.comm.global_vector(res.x64)
    if rows is not None:
        x = x[rows]
    x_hi, x_lo = df.f64_to_pair(x)
    return dataclasses.replace(res, x64=x, x_hi=x_hi, x_lo=x_lo)


def _solve_csr_shiftell_df64(a, b64, mesh, axis, n_shards,
                             solve_kw, plan=None) -> DF64CGResult:
    """Assembled CSR in the f64 lane: the ring schedule on the f64 hand
    SpMV B9 (``DistShiftELLDF64Ring``), the reference's defining
    combination - ``CUDA_R_64F`` CSR SpMV (``CUDACG.cu:216,288``) across
    devices.  Padding rows are solved as zeros and stripped; a plan's
    permutation and variable-row split apply inside and are undone on
    ``x``."""
    if plan is not None and plan.permutation is not None:
        a = a.permuted(plan.permutation)
        b64 = b64[torch.as_tensor(plan.permutation, device=b64.device)]
    parts = part.ring_partition_shiftell_df64(
        a, n_shards,
        row_ranges=plan.row_ranges if plan is not None else None)
    _note_partition(a, parts, plan)
    b_pad = torch.zeros(parts.n_global_padded, dtype=torch.float64,
                        device=mesh.device)
    if parts.row_ranges is not None:
        b_pad[torch.as_tensor(part.gather_indices(
            parts.row_ranges, parts.n_local), device=mesh.device)] = b64
    else:
        b_pad[:parts.n_global] = b64
    b_local = shard_vector(b_pad, mesh, axis)
    vals, cols, slice_ptr = ring_step_tensors(parts, mesh)
    diag = _local_rows(parts.diag, mesh).reshape(-1)
    interval = _global_interval(a, solve_kw["preconditioner"])
    n_local = parts.n_local
    key = cache_key_parts(
        "csr-shiftell-df64", n_local=n_local, n_shards=n_shards,
        axis=axis, mesh=mesh, solve_kw=tuple(sorted(solve_kw.items())),
        plan=plan.fingerprint() if plan is not None else None)

    def build():
        def run(b_loc, vals_s, cols_s, slice_ptr_s, diag_s, interval_t):
            op = DistShiftELLDF64Ring(
                vals=vals_s, cols=cols_s, slice_ptr=slice_ptr_s,
                diag=diag_s, h=parts.h, kc=parts.kc, n_local=n_local,
                axis_name=axis, n_shards=n_shards)
            return _local_solve(op, b_loc, interval_t, None, axis, solve_kw)
        return cm.shard_map(run, mesh=mesh)

    res = _cached_solver(key, build)(b_local, vals, cols, slice_ptr, diag,
                                     interval)
    return _global_result(res, mesh, _unpad_rows(parts, plan, mesh.device))


def _f32_hierarchy(loc: DistStencilDF64, backend: str):
    """The V-cycle of the ``"mg"`` lane: the distributed multigrid
    hierarchy of the f32 ``DistStencil2D/3D`` sibling of slab ``loc``
    (the global stencil's ``backend``, the scale's hi word: the f32
    scale), built inside the per-shard body."""
    from ..models.multigrid import MultigridPreconditioner

    cls = DistStencil2D if loc.kind == "2d" else DistStencil3D
    return MultigridPreconditioner.from_operator(cls(
        scale=loc.scale_hi, local_grid=tuple(loc.local_grid),
        axis_name=loc.axis_name, n_shards=loc.n_shards, backend=backend,
        _dtype_name="float32"))


__all__ = ["DistStencilDF64", "clear_solver_cache",
           "solve_distributed_df64"]
