"""Deterministic fault injection: host-decided, device-applied.

Counterpart of the JAX package's ``robust/inject.py``.  A
:class:`FaultPlan` is a STATIC, hashable description of one fault:
which solver recurrence site to corrupt (``halo`` payload, local
``spmv`` output, or the ``reduction`` scalar), at which 0-based solver
iteration, on which shard, with which non-finite value.  The plan rides
the distributed solver-cache key exactly like a ``FlightConfig``, and
its :meth:`~FaultPlan.fingerprint` is the JAX package's, so a plan is
named alike in both packages' events.

The JAX package fires the fault inside its compiled ``lax.while_loop``
through a ``lax.cond`` on the loop counter.  The port's loop is driven
from the host with its step counter a Python int, so the decision is the
host's - :meth:`FaultPlan.fires` compares that counter, no device value
is read - and the corruption is one in-place index write on the device,
made on the firing step only.  An armed solve adds no host read.

``fault=None`` (everywhere) is the contract: the solver runs exactly the
operations it runs without the argument (asserted in
``tests/test_torch_robust.py``).

Shard semantics (the JAX module's):

* ``halo``/``spmv`` faults are shard-local, modeling one chip's bad wire
  or bad HBM read.  The shard gate - the JAX ``lax.axis_index`` - selects
  the target shard's rows through ``parallel.comm``'s shard ids: its row
  of the ``(P, n_local)`` stack on a stacked mesh, this rank's block on
  a process group when ``rank == shard``.  The poison still reaches
  every shard through the next reduction, so the loop predicate exits
  coherently on all shards.
* ``reduction`` faults poison the already-reduced scalar on every shard
  at once - physically, one shard's NaN contribution to an allreduce IS
  everyone's NaN.  A shard-targeted poison of a replicated scalar would
  desynchronize the loop's trip counts across the mesh, so ``shard`` is
  recorded for the event but the corruption is global by construction.

The host-level "preemption" mode lives here too: :class:`Preemption`
kills a resumable solve between segment checkpoints
(``utils.checkpoint.solve_resumable_distributed`` calls the hook after
each save), so the restart/resume drill is deterministic; the
host-level ``shard_loss`` site declares a shard lost at a segment
boundary so the elastic loop migrates off it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

__all__ = [
    "FAULT_SITES",
    "FAULT_VALUES",
    "HOST_FAULT_SITES",
    "SHARD_SLOW_FACTOR",
    "FaultPlan",
    "PreemptedError",
    "Preemption",
    "ShardLostError",
]

#: recurrence sites a plan corrupts inside a solve
TRACE_FAULT_SITES = ("halo", "spmv", "reduction")

#: host-level elastic-drill sites (robust.elastic / the watchdog): they
#: never enter a solve - "shard_slow" inflates one shard's MEASURED phase
#: timing so the straggler watchdog's detection path runs against
#: doctored-but-real profile data, and "shard_loss" declares one shard
#: lost at a segment boundary so the elastic loop migrates off it.  For
#: both, ``iteration`` counts completed SEGMENTS (1-based), not solver
#: steps.
HOST_FAULT_SITES = ("shard_slow", "shard_loss")

#: recurrence sites a plan can corrupt
FAULT_SITES = TRACE_FAULT_SITES + HOST_FAULT_SITES

#: deterministic slowdown a "shard_slow" drill applies to the target
#: shard's measured per-matvec SpMV seconds
SHARD_SLOW_FACTOR = 8.0

#: spellable non-finite values (stored as strings so a FaultPlan stays
#: hashable AND equal to its twin - a float NaN field would make two
#: identical plans compare unequal)
FAULT_VALUES = ("nan", "inf", "-inf")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic fault, armed into a solve.

    Fields are all static scalars: the plan is hashable (solver-cache
    key component) and its :meth:`fingerprint` is stable across
    processes and equal to the JAX package's.

    ``site``: ``"halo"`` corrupts the halo payload the target shard
    *received* (every gathered/extended entry beyond its local block - a
    corrupt message, deterministic regardless of which entries the
    shard's rows reference); ``"spmv"`` corrupts entry ``index`` of the
    target shard's local SpMV output (its whole row of a stack);
    ``"reduction"`` corrupts the reduced recurrence scalar ``p . Ap``
    (see the module docstring for why that one is global).
    ``iteration`` is the 0-based solver step whose matvec/reduction is
    corrupted (a resumed solve counts from its checkpoint, so the index
    is absolute).  The host-level elastic-drill sites
    (``shard_slow``/``shard_loss``, :data:`HOST_FAULT_SITES`) reuse the
    field as a completed-SEGMENT count instead.  ``lane`` targets one
    column of a many-RHS ``reduction`` fault.  ``sticky=True`` models a
    permanent fault: :meth:`after_restart` keeps it armed, so recovery
    exhausts its restart budget and fails typed; the default models a
    transient - the restarted solve runs clean.
    """

    site: str
    iteration: int
    shard: int = 0
    index: int = 0
    value: str = "nan"
    lane: int = 0
    sticky: bool = False

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {FAULT_SITES}")
        if self.iteration < 0:
            raise ValueError(f"fault iteration must be >= 0, got "
                             f"{self.iteration}")
        if self.shard < 0:
            raise ValueError(f"fault shard must be >= 0, got "
                             f"{self.shard}")
        if self.index < 0 or self.lane < 0:
            raise ValueError("fault index/lane must be >= 0")
        if self.value not in FAULT_VALUES:
            raise ValueError(f"unknown fault value {self.value!r}; "
                             f"expected one of {FAULT_VALUES}")

    # -- identity ------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable short digest (event payloads, cache keys)."""
        spec = (f"fault:{self.site}:{self.iteration}:{self.shard}:"
                f"{self.index}:{self.value}:{self.lane}:{self.sticky}")
        return hashlib.sha1(spec.encode()).hexdigest()[:12]

    def describe(self) -> str:
        return (f"{self.value} into {self.site} at iteration "
                f"{self.iteration} on shard {self.shard}"
                f"{' (sticky)' if self.sticky else ''}")

    def to_json(self) -> dict:
        return {
            "site": self.site, "iteration": self.iteration,
            "shard": self.shard, "index": self.index,
            "value": self.value, "lane": self.lane,
            "sticky": self.sticky,
            "fingerprint": self.fingerprint(),
        }

    @classmethod
    def parse(cls, spec: str, **overrides) -> "FaultPlan":
        """Parse the CLI spelling ``SITE:ITER[:SHARD]`` (e.g.
        ``halo:10`` or ``spmv:25:2``)."""
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"fault spec {spec!r} must be SITE:ITER[:SHARD] "
                f"(e.g. halo:10, spmv:25:2); sites: "
                f"{', '.join(FAULT_SITES)}")
        site = parts[0]
        try:
            iteration = int(parts[1])
            shard = int(parts[2]) if len(parts) == 3 else 0
        except ValueError:
            raise ValueError(
                f"fault spec {spec!r}: iteration/shard must be "
                f"integers")
        return cls(site=site, iteration=iteration, shard=shard,
                   **overrides)

    def after_restart(self):
        """The plan a recovery restart runs under: a transient fault is
        gone (``None`` - the clean re-solve), a sticky one persists."""
        return self if self.sticky else None

    # -- host-level elastic-drill sites -------------------------------

    @property
    def host_level(self) -> bool:
        """True for the elastic-drill sites (``shard_slow`` /
        ``shard_loss``), which are consumed by the host-side resumable
        loop and must never be armed into a solve."""
        return self.site in HOST_FAULT_SITES

    def fires_segment(self, completed_segments: int) -> bool:
        """Host-level trigger: this drill fires once ``iteration``
        segments have completed (1-based; ``iteration=0`` fires at the
        first boundary)."""
        return self.host_level \
            and completed_segments >= max(self.iteration, 1)

    def doctor_profile(self, profile, completed_segments: int):
        """The ``shard_slow`` drill: the measured phase profile (any
        object with ``spmv_s``/``spmv_mesh_s``, the JAX
        ``telemetry.phasetrace.PhaseProfile``) with the target shard's
        per-matvec SpMV seconds inflated by ``SHARD_SLOW_FACTOR`` (mesh
        wall adjusted by the same delta).  Any other site (or an unfired
        segment gate) returns the profile untouched."""
        if self.site != "shard_slow" \
                or not self.fires_segment(completed_segments):
            return profile
        import numpy as np

        spmv = np.array(profile.spmv_s, dtype=float)
        if self.shard >= spmv.shape[0]:
            return profile
        delta = spmv[self.shard] * (SHARD_SLOW_FACTOR - 1.0)
        spmv[self.shard] += delta
        return dataclasses.replace(
            profile, spmv_s=spmv,
            spmv_mesh_s=float(profile.spmv_mesh_s) + float(delta))

    # -- the solve's sites --------------------------------------------

    def fault_value(self, dtype):
        """The poison as a 0-d tensor of ``dtype`` (on the CPU; an index
        write moves it to the target's device)."""
        return torch.tensor(float(self.value), dtype=dtype)

    def _target(self, axis_name):
        """The position of the target shard among this process's shards
        (the leading axis of a per-shard tensor), or ``None`` when this
        process does not hold it.  One local block (no ``axis_name``, or
        outside a comm scope) is shard 0."""
        if axis_name is None:
            return 0 if self.shard == 0 else None
        from ..parallel import comm

        ids = tuple(comm.shard_ids(axis_name))
        return ids.index(self.shard) if self.shard in ids else None

    def fires(self, k, axis_name=None) -> bool:
        """Host decision: this step, on a shard this process holds.
        ``k`` is the solver's 0-based step counter (a Python int)."""
        if int(k) != self.iteration:
            return False
        return axis_name is None or self._target(axis_name) is not None

    def _poison_row(self, y, row: int):
        """``y`` with row ``row`` (a scalar entry of a vector, the whole
        row of an ``(n, k)`` stack) set to the fault value, in place."""
        y[row] = float(self.value)
        return y

    def apply_matvec(self, a, p, k, axis_name=None):
        """``a @ p`` (or ``a.matmat(p)`` for a stack) with this plan's
        halo/spmv fault armed at step ``k``.  ``reduction`` plans leave
        the matvec untouched (see :meth:`poison_reduction`)."""
        if self.host_level:
            raise ValueError(
                f"fault site {self.site!r} is a host-level elastic "
                f"drill (consumed by utils.checkpoint."
                f"solve_resumable_distributed / robust.watchdog); it "
                f"cannot be armed into a compiled solve")
        stack = p.ndim == 2
        apply = (lambda v: a.matmat(v)) if stack else (lambda v: a @ v)
        if self.site == "reduction":
            return apply(p)
        fire = self.fires(k, axis_name)
        if self.site == "spmv":
            y = apply(p)
            if fire:
                from ..parallel import comm

                lead = 1 if axis_name is None \
                    else comm.local_count(axis_name)
                block = y.shape[0] // lead
                self._poison_row(y, self._target(axis_name) * block
                                 + self.index % block)
            return y
        # site == "halo": corrupt the payload the exchange delivered -
        # the WHOLE received message, not one slot (a single poisoned
        # entry the target shard's rows happen not to reference would be
        # a fault that silently does nothing) - then run the unchanged
        # local multiply over it: the real solve's wire, poisoned after
        # the receive.
        if hasattr(a, "extend_x"):     # DistCSRGather: packed rounds
            x_ext = a.extend_x(p)
            if x_ext.shape[1] - a.n_local <= 0:
                raise ValueError(
                    "halo fault: the gather schedule ships no halo "
                    "entries to corrupt (fully decoupled shards)")
            if fire:
                x_ext[self._target(axis_name), a.n_local:] = \
                    float(self.value)
            return a.local_apply(lambda s: x_ext[s], stack)
        if hasattr(a, "gather_x"):     # DistCSR: allgathered full x
            x_full = a.gather_x(p)
            if not fire:
                return a.local_apply(lambda s: x_full, stack)
            target = self._target(axis_name)
            bad = torch.full_like(x_full, float(self.value))
            if a.n_shards > 1:
                # everything OUTSIDE the target shard's own block is
                # payload some neighbor shipped; mesh 1: the whole gather
                # IS the exchange output
                own = slice(self.shard * a.n_local,
                            (self.shard + 1) * a.n_local)
                bad[own] = x_full[own]
            return a.local_apply(
                lambda s: bad if s == target else x_full, stack)
        raise ValueError(
            f"halo fault needs a distributed gather/allgather operator "
            f"(DistCSR/DistCSRGather); {type(a).__name__} has no halo "
            f"exchange to corrupt - use site='spmv' or 'reduction'")

    def poison_reduction(self, v, k):
        """The ``reduction`` site: corrupt the reduced scalar (or lane
        ``self.lane`` of a ``(k,)`` per-lane vector) at step ``k``.
        Applied identically on every shard - see the module docstring for
        why the shard gate must NOT apply here."""
        if self.site != "reduction" or not self.fires(k):
            return v
        v = v.clone()
        if v.ndim == 0:
            v.fill_(float(self.value))
            return v
        return self._poison_row(v, self.lane % v.shape[0])

    def validate_for_operator(self, a, n_shards: int = 1) -> None:
        """Host-side pre-solve checks with readable errors."""
        self._check_lane(a, n_shards)

    def _check_lane(self, a, n_shards: int = 1, *,
                    method: Optional[str] = None, allowed: str = "cg",
                    exchanges: Optional[bool] = None) -> None:
        """Whether this plan fits this lane, the one place the solvers
        ask: its site enters a solve (not a host-level drill), its shard
        is one of ``n_shards``, ``method`` (``None``: not checked) is
        the recurrence the lane drills (``allowed``: ``"cg"`` on the
        single solve and the distributed lanes, ``"batched"`` on the
        many-RHS ones), and a ``halo`` site has an exchange to poison.
        ``exchanges`` says whether the lane exchanges a halo; ``None``
        reads it off ``a`` (a ``gather_x`` or ``extend_x``)."""
        if method is not None and method != allowed:
            raise ValueError(
                f"fault injection (robust.FaultPlan) rides "
                f"method={allowed!r} only (got {method!r}): "
                + _WHY_ONLY[allowed])
        if self.host_level:
            raise ValueError(
                f"fault site {self.site!r} is a host-level elastic "
                f"drill: arm it on solve_resumable_distributed("
                f"elastic=True) (shard_slow additionally needs a "
                f"watchdog=), not on a direct solve")
        if self.shard >= max(n_shards, 1):
            raise ValueError(
                f"fault targets shard {self.shard} but the mesh has "
                f"{n_shards} shard(s)")
        if exchanges is None:
            exchanges = hasattr(a, "extend_x") or hasattr(a, "gather_x")
        if self.site == "halo" and not exchanges:
            raise ValueError(
                f"halo fault needs a distributed gather/allgather "
                f"operator; {type(a).__name__} has no halo exchange "
                f"(use site='spmv' or 'reduction', or solve "
                f"distributed)")


#: why a plan rides one recurrence only, by the method it rides
_WHY_ONLY = {
    "cg": "the chaos harness drills the textbook recurrence",
    "batched": ("block-CG's in-trace Gram-collapse fallback would mask "
                "an armed fault as a rank event instead of a typed "
                "BREAKDOWN"),
}


class PreemptedError(RuntimeError):
    """A resumable solve was killed between segments (the chaos
    harness's host-level preemption).  State is already on disk - a
    later call with the same path resumes the exact trajectory."""


class ShardLostError(RuntimeError):
    """A ``shard_loss`` drill was armed on a NON-elastic resumable
    solve: losing a shard can only be survived by migrating off it,
    which the loop refuses to do without ``elastic=True`` - typed so
    orchestration layers can branch on "re-run elastic" specifically
    rather than on a generic configuration error."""


@dataclasses.dataclass
class Preemption:
    """Host-level preemption hook for segmented resumable solves.

    ``solve_resumable_distributed(..., preempt=Preemption(n))`` raises
    :class:`PreemptedError` after ``n`` completed (saved) segments -
    the deterministic stand-in for a worker being killed mid-run.  The
    checkpoint of every completed segment is on disk, so the drill is:
    catch the error, call again, and the resumed trajectory bit-matches
    the uninterrupted run.
    """

    after_segments: int = 1

    def __post_init__(self):
        if self.after_segments < 1:
            raise ValueError(
                f"after_segments must be >= 1, got {self.after_segments}")

    def __call__(self, completed_segments: int) -> None:
        if completed_segments >= self.after_segments:
            raise PreemptedError(
                f"preempted after {completed_segments} segment(s) "
                f"(chaos harness); the last checkpoint is saved - "
                f"call again to resume")
