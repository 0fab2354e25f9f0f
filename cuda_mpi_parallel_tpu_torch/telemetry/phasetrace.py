"""phasetrace: measured per-shard per-phase timing of distributed solves.

Counterpart of the JAX package's ``telemetry/phasetrace.py``: the same
:class:`PhaseProfile` (fields, derived numbers and ``to_json``), the same
lanes, refusals, ``phase_profile`` event and ``phase_*`` gauges.

Given a partition of a CSR system (the ``DistCSR`` / ``DistCSRGather`` /
``DistCSRRing`` lanes of ``parallel.dist_cg``), the profiler times **the
building blocks of the port's own operators** - the methods the real
matvec composes, so a profiled phase IS the solve's code path, never a
reimplementation:

* **halo** - the exchange alone: ``DistCSR.gather_x`` (one
  ``all_gather``), every ``DistCSRGather.exchange_round`` (and each round
  *individually*, giving per-round wire seconds and a fitted per-link
  bytes/s where round payloads differ), or the ring's ``rotate`` chain;
* **spmv** - the local CSR multiply alone (``ops.spmv.csr_matvec``),
  timed PER SHARD on that shard's own arrays (the straggler is measured,
  not modeled), and once over the whole mesh;
* **reduction** - one dot plus the comm layer's ``psum``, the
  iteration's barrier.

The JAX package compiles each phase as a ``repeats``-trip ``fori_loop``
under ``shard_map``; the port runs each as an eager loop of ``repeats``
trips inside the mesh's comm scope, synchronised at both ends through
``utils.timing.time_fn`` (best of ``outer``).  A data dependency
(:func:`_chain`) threads every trip into the next, as in the JAX
package.  What a trip costs here is what this executor pays: on the
card each trip's launches are issued from the host, and on a stacked
mesh the shards run one after another, so the mesh SpMV wall
approaches ``sum(spmv_s)`` (the JAX docstring's virtual-device case).
A composed **step** - matvec, two dot+psum reductions and the CG axpys -
is timed the same way and anchors the residual check
(:meth:`PhaseProfile.explained_fraction`).

Consumers: ``calibrate.observations_from_profile`` (two orthogonal
observations, so one profile reaches the ``lstsq2`` tier),
``report.perfetto_trace(phase_profile=...)`` (measured spans),
:func:`note_profile` and the straggler watchdog
(``robust.watchdog``) inside ``utils.checkpoint``'s resumable loop.

Profiling builds its own operators from the partition and runs its own
launches after a solve: it never touches a solve's tensors or its cached
solver (tests/test_torch_phasetrace.py records a solve's op stream with
and without a profile between).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DEFAULT_REPEATS",
    "PhaseProfile",
    "note_profile",
    "profile_distributed",
    "profile_partition",
]

#: chained repetitions per timed phase loop: enough to amortize
#: dispatch into the per-rep number, and (at the default) comfortably
#: past calibrate.MIN_CALIBRATION_ITERATIONS so a single profile can
#: back a confident fit
DEFAULT_REPEATS = 16

#: phase sum below this fraction of the measured step wall marks the
#: profile unexplained (a phase the profiler does not isolate is
#: dominating the iteration); over-explanation past the mirrored bound
#: ``2 - FLOOR`` means the phases double-count work the composed step
#: overlaps.
EXPLAINED_FRACTION_FLOOR = 0.7


@dataclasses.dataclass(frozen=True)
class PhaseProfile:
    """Measured per-shard per-phase seconds of one partitioned operator.

    All times are seconds per repetition (= per matvec / per phase
    application).  ``spmv_s`` is per shard; the communication phases
    are whole-mesh walls (a collective synchronizes every shard, so a
    per-shard split of its wall would be fiction - the per-shard story
    of the wire lives in ``links``, one timed entry per exchange
    round).  ``step_s`` is the measured iteration core (matvec +
    ``reductions_per_iteration`` dot+psum barriers + the CG axpys) -
    the wall the phase sum is checked against.
    """

    kind: str                     # csr | csr-gather | csr-ring
    exchange: str                 # allgather | gather | ring
    n_shards: int
    n_local: int
    itemsize: int
    repeats: int
    spmv_s: np.ndarray            # (P,) per-shard local SpMV seconds
    #: the SpMV phase's whole-MESH wall (every shard multiplying, no
    #: collective) - what the iteration actually pays for the phase
    #: under this executor.  With one device a shard this approaches
    #: ``max(spmv_s)``; on a stacked mesh the shards run one after
    #: another and it approaches ``sum(spmv_s)`` - measuring it keeps
    #: the explained-fraction check honest on both.
    spmv_mesh_s: float
    halo_s: float                 # whole exchange, seconds per matvec
    reduction_s: float            # one dot + psum
    step_s: float                 # measured iteration core
    #: per exchange round: shift, per-device padded bytes, measured
    #: seconds, bytes/s (calibrate.fit_link_bandwidths output)
    links: Tuple[dict, ...] = ()
    #: planner slot-term coordinate: ``slots_max * (itemsize + 4)``
    gather_bytes: int = 0
    #: per-device wire bytes per matvec of the lane that ran
    wire_bytes: int = 0
    reductions_per_iteration: int = 2
    solve_iterations: Optional[int] = None
    solve_elapsed_s: Optional[float] = None
    plan: str = "even"
    #: the device the profile was measured on (the mesh's; not part of
    #: ``to_json``) - names the watchdog's baseline backend
    device: Optional[str] = None

    # ---- derived -----------------------------------------------------
    def phase_seconds(self, shard: int) -> Tuple[float, float, float]:
        """(halo, spmv, reduction) seconds of one iteration on
        ``shard`` - reduction counted ``reductions_per_iteration``
        times, the way the iteration pays it."""
        return (float(self.halo_s), float(self.spmv_s[shard]),
                float(self.reduction_s * self.reductions_per_iteration))

    def critical_path_s(self) -> float:
        """Phase sum of one iteration: halo + the mesh-measured SpMV
        wall + the iteration's reduction barriers.  Every term is a
        whole-mesh wall measured under the same executor, so the sum
        is commensurable with ``step_s`` (and with a real solve's
        per-iteration wall)."""
        return (float(self.halo_s) + float(self.spmv_mesh_s)
                + float(self.reduction_s * self.reductions_per_iteration))

    def stall_factors(self) -> dict:
        """Measured max/mean per phase.  The communication phases are
        1.0 by construction (padded-uniform payloads, one wall); the
        SpMV factor is the real measured straggler penalty."""
        from .shardscope import max_over_mean

        return {
            "halo": 1.0,
            "spmv": max_over_mean(self.spmv_s),
            "reduction": 1.0,
        }

    def explained_fraction(self) -> float:
        """Fraction of the measured iteration core (``step_s``) the
        phase critical path explains - the residual check.  Values
        near 1.0 mean the three phases ARE the iteration; a low value
        means an unprofiled cost dominates."""
        return self.critical_path_s() / max(float(self.step_s), 1e-300)

    @property
    def solve_s_per_iteration(self) -> Optional[float]:
        if not self.solve_iterations or self.solve_elapsed_s is None:
            return None
        return float(self.solve_elapsed_s) / max(
            int(self.solve_iterations), 1)

    def explained_fraction_vs_solve(self) -> Optional[float]:
        """The same residual check against the ACTUAL solve's measured
        per-iteration wall (when the caller provided it) - the solve
        additionally pays while-loop plumbing and convergence checks,
        so this is <= the step-based fraction in practice."""
        spi = self.solve_s_per_iteration
        if spi is None:
            return None
        return self.critical_path_s() / max(spi, 1e-300)

    def to_json(self) -> dict:
        out = {
            "kind": self.kind,
            "exchange": self.exchange,
            "plan": self.plan,
            "n_shards": int(self.n_shards),
            "n_local": int(self.n_local),
            "itemsize": int(self.itemsize),
            "repeats": int(self.repeats),
            "phases": {
                "halo_s": float(self.halo_s),
                "spmv_s": float(self.spmv_mesh_s),
                "spmv_shard_max_s": float(np.max(self.spmv_s)),
                "spmv_shard_mean_s": float(np.mean(self.spmv_s)),
                "reduction_s": float(self.reduction_s),
            },
            "spmv_s": [float(v) for v in self.spmv_s],
            "step_s": float(self.step_s),
            "links": [dict(e) for e in self.links],
            "gather_bytes": int(self.gather_bytes),
            "wire_bytes": int(self.wire_bytes),
            "reductions_per_iteration": int(
                self.reductions_per_iteration),
            "stall_factors": self.stall_factors(),
            "explained_fraction": round(self.explained_fraction(), 6),
        }
        if self.solve_s_per_iteration is not None:
            out["solve_s_per_iteration"] = self.solve_s_per_iteration
            out["explained_fraction_vs_solve"] = round(
                self.explained_fraction_vs_solve(), 6)
        return out

    def describe_lines(self) -> List[str]:
        """Human lines for the report's "-- phase profile --" section
        (also rendered by ``report.phase_lines`` from the JSON form)."""
        from .report import phase_lines

        return phase_lines(self.to_json())


# ---------------------------------------------------------------------------
# measurement machinery

def _chain(s, probe, tiny):
    """Thread a data dependency from ``probe`` (this trip's phase
    output) into the next trip's input without changing ``s``
    meaningfully: adds ``probe's first element * tiny`` (the dtype's
    smallest normal), so every trip consumes the one before it."""
    if probe.numel() == 0:
        return s
    return s + probe.reshape(-1)[0] * tiny


def _time_loop(fn, *args, repeats: int, outer: int = 2):
    """Best-of-``outer`` wall seconds of one ``repeats``-trip loop
    ``fn(*args)``, divided by ``repeats`` (one warm-up call first; the
    device is synchronised around every call)."""
    from ..utils.timing import time_fn

    elapsed, _ = time_fn(fn, *args, warmup=1, repeats=outer,
                         reduce="best")
    return elapsed / max(int(repeats), 1)


def _mesh_phase(mesh, body, state, repeats: int):
    """Time a mesh phase: ``repeats`` trips of ``body(i, state) ->
    state`` inside the mesh's comm scope (the scope a solve's per-shard
    body runs in), from ``state``."""
    from ..parallel import comm as cm

    def run():
        s = state
        with cm.bind(mesh):
            for i in range(repeats):
                s = body(i, s)
        return s[0] if isinstance(s, tuple) else s

    return _time_loop(run, repeats=repeats)


def profile_partition(parts, mesh, *, repeats: int = DEFAULT_REPEATS,
                      solve_iterations: Optional[int] = None,
                      solve_elapsed_s: Optional[float] = None,
                      plan: str = "even") -> PhaseProfile:
    """Measure the phase profile of an already-built partition.

    ``parts`` is ``partition.partition_csr`` output (allgather or gather
    lane - ``parts.halo`` decides) or ``partition.ring_partition_csr``
    output (the ring lane, detected by its per-step tuple slabs);
    ``mesh`` the 1-D mesh the solve runs on.  The partition's arrays go
    to the mesh's device; the timed bodies are the operator building
    blocks under the mesh's comm, plus per-shard SpMV timings.
    """
    from . import events
    from .calibrate import fit_link_bandwidths

    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if len(mesh.axis_names) != 1:
        raise ValueError("phase profiling runs on a 1-D mesh (pencil "
                         "meshes are stencil-only)")
    axis = mesh.axis_names[0]
    n_shards = int(mesh.devices.size)
    if n_shards != int(parts.n_shards):
        raise ValueError(f"partition targets {parts.n_shards} shards "
                         f"but the mesh has {n_shards}")
    if n_shards < 2:
        raise ValueError("phase profiling needs a mesh with >= 2 "
                         "devices (a 1-shard 'exchange' has no wire)")
    ring = isinstance(parts.data, tuple)
    n_local = int(parts.n_local)
    dtype = np.asarray(parts.data[0] if ring else parts.data).dtype
    itemsize = int(dtype.itemsize)
    tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    tiny = float(np.finfo(dtype).tiny)
    from ..parallel.mesh import shard_vector

    x_dev = shard_vector(np.ones(parts.n_global_padded, dtype=dtype),
                         mesh, axis)
    with events.scoped(phase="phase-profile"):
        if ring:
            profile = _profile_ring(parts, mesh, axis, x_dev, tiny,
                                    repeats, n_shards, n_local, itemsize,
                                    tdtype)
        else:
            profile = _profile_allgather_family(
                parts, mesh, axis, x_dev, tiny, repeats, n_shards,
                n_local, itemsize, tdtype)
    kind, exchange, spmv_s, spmv_mesh_s, halo_s, reduction_s, step_s, \
        rounds, gather_bytes, wire_bytes = profile
    return PhaseProfile(
        kind=kind, exchange=exchange, n_shards=n_shards,
        n_local=n_local, itemsize=itemsize, repeats=int(repeats),
        spmv_s=np.asarray(spmv_s, dtype=np.float64),
        spmv_mesh_s=float(spmv_mesh_s),
        halo_s=float(halo_s), reduction_s=float(reduction_s),
        step_s=float(step_s),
        links=tuple(fit_link_bandwidths(rounds)),
        gather_bytes=int(gather_bytes), wire_bytes=int(wire_bytes),
        reductions_per_iteration=2,   # the CG iteration's two barriers
        solve_iterations=solve_iterations,
        solve_elapsed_s=solve_elapsed_s, plan=str(plan),
        device=str(mesh.device))


def _step_body(op, axis):
    """The iteration-core body: one matvec, two dot+psum barriers, the
    CG axpys - bounded synthetic coefficients so ``repeats`` trips stay
    finite whatever the operator's spectrum."""
    from ..ops import blas1

    def body(i, s):
        p, r = s
        q = op.matvec(p)
        denom = blas1.dot(p, q, axis_name=axis)
        alpha = 1.0 / (denom.abs() + 1.0)
        r2 = r - alpha * q
        rr = blas1.dot(r2, r2, axis_name=axis)
        beta = rr / (rr + 1.0)
        return (r2 + beta * p, r2)
    return body


def _reduction_body(axis, tiny):
    from ..ops import blas1

    def body(i, s):
        return _chain(s, blas1.dot(s, s, axis_name=axis), tiny)
    return body


def _shard_slabs(parts, k, steps, device):
    """Shard ``k``'s ``(data, cols, rows)`` of each step (one step for the
    allgather family), sorted by row for the ordered segment sums, on
    ``device``."""
    from ..parallel.operators import _sorted_by_row

    out = []
    for t in steps:
        arrs = [np.asarray(f if t is None else f[t])[k:k + 1]
                for f in (parts.data, parts.cols, parts.local_rows)]
        d, c, r = _sorted_by_row(*(torch.as_tensor(v, device=device)
                                   for v in arrs))
        out.append((d[0], c[0], r[0]))
    return out


def _spmv_seconds(parts, steps, x_size, n_local, tdtype, repeats, tiny,
                  device):
    """Per-shard local-SpMV seconds, each shard's arrays timed alone
    (the measured straggler; the psum barrier in the real loop makes the
    max of these everyone's wait).  A ring shard multiplies every step's
    slab."""
    from ..ops import spmv as spmv_ops

    out = []
    for k in range(int(parts.n_shards)):
        slabs = _shard_slabs(parts, k, steps, device)
        x0 = torch.ones(x_size, dtype=tdtype, device=device)

        def run(slabs=slabs, x0=x0):
            s = x0
            for _ in range(repeats):
                y = None
                for d, c, r in slabs:
                    yt = spmv_ops.csr_matvec(d, c, r, s, n_local)
                    y = yt if y is None else y + yt
                s = _chain(s, y, tiny)
            return s

        out.append(_time_loop(run, repeats=repeats))
    return np.asarray(out, dtype=np.float64)


def _profile_allgather_family(parts, mesh, axis, x_dev, tiny, repeats,
                              n_shards, n_local, itemsize, tdtype):
    from ..parallel.dist_cg import _local_rows
    from ..parallel.exchange import allgather_wire_bytes
    from ..parallel.operators import DistCSR, DistCSRGather

    sched = parts.halo
    gather = sched is not None
    data, cols, rows = (_local_rows(v, mesh) for v in
                        (parts.data, parts.cols, parts.local_rows))
    if gather:
        shifts = tuple(r.shift for r in sched.rounds)
        op = DistCSRGather(
            data=data, cols=cols, local_rows=rows,
            send_idx=tuple(_local_rows(r.send_idx, mesh)
                           for r in sched.rounds),
            shifts=shifts, n_local=n_local, axis_name=axis,
            n_shards=n_shards)
    else:
        op = DistCSR(data=data, cols=cols, local_rows=rows,
                     n_local=n_local, axis_name=axis, n_shards=n_shards)
    lead = int(data.shape[0])
    device = mesh.device

    if gather:
        def halo_body(i, s):
            ext = op.extend_x(s)
            # chain through the RECEIVED slabs, not the local block
            return _chain(s, ext[:, n_local:], tiny)
        x_ext_size = n_local + sched.halo_width
        ext_shape = (lead, x_ext_size)
    else:
        def halo_body(i, s):
            return _chain(s, op.gather_x(s), tiny)
        x_ext_size = parts.n_global_padded
        ext_shape = (x_ext_size,)

    def spmv_mesh_body(i, s):
        # no collective: every shard multiplies against a constant
        # extended x (nudged by the chained state)
        xc = torch.ones(ext_shape, dtype=tdtype, device=device) \
            + s[0] * tiny
        return _chain(s, op.local_matvec(xc), tiny)

    halo_s = _mesh_phase(mesh, halo_body, x_dev, repeats)
    spmv_mesh_s = _mesh_phase(mesh, spmv_mesh_body, x_dev, repeats)
    reduction_s = _mesh_phase(mesh, _reduction_body(axis, tiny), x_dev,
                              repeats)
    step_s = _mesh_phase(mesh, _step_body(op, axis), (x_dev, x_dev),
                         repeats)

    rounds = []
    if gather:
        round_bytes = sched.round_wire_bytes(itemsize)
        for i in range(len(shifts)):
            def round_body(j, s, i=i):
                return _chain(s, op.exchange_round(s, i), tiny)
            secs = _mesh_phase(mesh, round_body, x_dev, repeats)
            rounds.append((shifts[i], round_bytes[i], secs))
        wire_bytes = sched.wire_bytes_per_matvec(itemsize)
    else:
        wire_bytes = allgather_wire_bytes(n_shards, n_local, itemsize)

    spmv_s = _spmv_seconds(parts, (None,), x_ext_size, n_local, tdtype,
                           repeats, tiny, device)
    slots_max = int(np.asarray(parts.data).shape[1])
    gather_bytes = slots_max * (itemsize + 4)
    kind = "csr-gather" if gather else "csr"
    exchange = "gather" if gather else "allgather"
    return (kind, exchange, spmv_s, spmv_mesh_s, halo_s, reduction_s,
            step_s, rounds, gather_bytes, wire_bytes)


def _profile_ring(parts, mesh, axis, x_dev, tiny, repeats, n_shards,
                  n_local, itemsize, tdtype):
    from ..parallel.dist_cg import _local_rows
    from ..parallel.exchange import allgather_wire_bytes
    from ..parallel.operators import DistCSRRing

    data, cols, rows = (tuple(_local_rows(v, mesh) for v in field)
                        for field in (parts.data, parts.cols,
                                      parts.local_rows))
    op = DistCSRRing(data=data, cols=cols, local_rows=rows,
                     n_local=n_local, axis_name=axis, n_shards=n_shards)
    lead = int(data[0].shape[0])
    device = mesh.device

    def halo_body(i, s):
        xb = s.reshape(-1, n_local)
        for _ in range(n_shards - 1):
            xb = op.rotate(xb)
        return xb.reshape(-1)

    def one_rotation_body(i, s):
        return op.rotate(s.reshape(-1, n_local)).reshape(-1)

    def spmv_mesh_body(i, s):
        # every step slab multiplied against a constant resident block
        # (no rotation - the SpMV phase alone)
        xc = torch.ones((lead, n_local), dtype=tdtype, device=device) \
            + s[0] * tiny
        y = None
        for t in range(n_shards):
            yt = op.step_matvec(t, xc)
            y = yt if y is None else y + yt
        return _chain(s, y, tiny)

    halo_s = _mesh_phase(mesh, halo_body, x_dev, repeats)
    spmv_mesh_s = _mesh_phase(mesh, spmv_mesh_body, x_dev, repeats)
    rotation_s = _mesh_phase(mesh, one_rotation_body, x_dev, repeats)
    reduction_s = _mesh_phase(mesh, _reduction_body(axis, tiny), x_dev,
                              repeats)
    step_s = _mesh_phase(mesh, _step_body(op, axis), (x_dev, x_dev),
                         repeats)
    # one shard's ring spmv = its slab multiplies across all steps
    spmv_s = _spmv_seconds(parts, tuple(range(len(parts.data))), n_local,
                           n_local, tdtype, repeats, tiny, device)

    # every rotation ships the same fixed n_local block - links cannot
    # separate, but the one measured rotation is still an honest wire
    rounds = [(1, n_local * itemsize, rotation_s)]
    wire_bytes = allgather_wire_bytes(n_shards, n_local, itemsize)
    # the ring's per-shard multiply walks every step slab: the slot
    # coordinate is the summed per-step slot widths
    gather_bytes = (sum(int(np.asarray(parts.data[t]).shape[1])
                        for t in range(len(parts.data)))
                    * (itemsize + 4))
    return ("csr-ring", "ring", spmv_s, spmv_mesh_s, halo_s,
            reduction_s, step_s, rounds, gather_bytes, wire_bytes)


def profile_distributed(a, *, mesh=None, n_devices: Optional[int] = None,
                        plan=None, csr_comm: str = "allgather",
                        exchange=None,
                        repeats: int = DEFAULT_REPEATS,
                        solve_iterations: Optional[int] = None,
                        solve_elapsed_s: Optional[float] = None
                        ) -> PhaseProfile:
    """Profile the partition a ``solve_distributed(a, ...)`` call with
    the same arguments would run: resolve the plan, apply its
    permutation, build the identical partition (same helpers as
    ``dist_cg._solve_csr``), and measure (:func:`profile_partition`).
    This re-pays the O(nnz) host partition work a just-finished solve
    already did - acceptable for a post-solve profiling pass; a caller
    holding the live partition should call :func:`profile_partition`
    directly instead.

    ``solve_iterations``/``solve_elapsed_s`` optionally anchor the
    profile to an actual measured solve of this system, enabling
    :meth:`PhaseProfile.explained_fraction_vs_solve`.
    """
    from ..models.operators import CSRMatrix
    from ..parallel import partition as part
    from ..parallel.dist_cg import (
        _apply_plan_permutation,
        _plan_exchange_hint,
        _resolve_exchange_mode,
        resolve_plan,
    )
    from ..parallel.mesh import make_mesh

    if not isinstance(a, CSRMatrix):
        raise ValueError(
            f"phase profiling supports assembled CSRMatrix problems "
            f"(the partitioned-operator lanes); got "
            f"{type(a).__name__}")
    if csr_comm == "ring-shiftell":
        raise ValueError(
            "phase profiling does not support csr_comm='ring-shiftell' "
            "(the hand slab kernel fuses its phases; use the csr ring "
            "lane)")
    if mesh is None:
        mesh = make_mesh(n_devices)
    n_shards = int(mesh.devices.size)
    plan = resolve_plan(plan, a, n_shards,
                        exchange=_plan_exchange_hint(csr_comm, exchange))
    ap, _ = _apply_plan_permutation(a, np.zeros(a.shape[0]), plan)
    ranges = plan.row_ranges if plan is not None else None
    if csr_comm == "ring" or exchange == "ring":
        parts = part.ring_partition_csr(ap, n_shards, ranges)
    else:
        parts = part.partition_csr(
            ap, n_shards, ranges,
            exchange=_resolve_exchange_mode(exchange, plan))
    return profile_partition(
        parts, mesh, repeats=repeats,
        solve_iterations=solve_iterations,
        solve_elapsed_s=solve_elapsed_s,
        plan=plan.label if plan is not None else "even")


def note_profile(profile: PhaseProfile) -> PhaseProfile:
    """Publish a profile: the ``phase_profile`` event (when a sink is
    active) plus per-phase / per-shard / per-link registry gauges -
    the measured siblings of the static ``shard_profile`` emission."""
    from . import events
    from .registry import REGISTRY

    payload = profile.to_json()
    events.emit("phase_profile", **payload)
    for phase, secs in (("halo", profile.halo_s),
                        ("spmv", profile.spmv_mesh_s),
                        ("reduction", profile.reduction_s),
                        ("step", profile.step_s)):
        REGISTRY.gauge(
            "phase_seconds",
            "measured whole-mesh seconds per application of one solve "
            "phase (step = the composed iteration core)",
            labelnames=("phase",)).set(float(secs), phase=phase)
    for phase, factor in profile.stall_factors().items():
        REGISTRY.gauge(
            "phase_stall_factor",
            "measured max/mean across shards per phase (the psum-"
            "barrier straggler penalty)",
            labelnames=("phase",)).set(float(factor), phase=phase)
    for k, secs in enumerate(profile.spmv_s):
        REGISTRY.gauge(
            "phase_spmv_seconds",
            "measured per-shard local-SpMV seconds per matvec",
            labelnames=("shard",)).set(float(secs), shard=str(k))
    for link in profile.links:
        REGISTRY.gauge(
            "phase_link_bytes_per_s",
            "measured per-link halo-wire bandwidth (one exchange "
            "round, timed alone)",
            labelnames=("shift",)).set(
                float(link["bytes_per_s"]), shift=str(link["shift"]))
    REGISTRY.gauge(
        "phase_explained_fraction",
        "fraction of the measured iteration core explained by the "
        "phase critical path (halo + slowest spmv + reductions)").set(
            profile.explained_fraction())
    return profile
