"""Elastic checkpoint migration: resume a distributed solve on a mesh
shape it was not checkpointed under.

Counterpart of the JAX package's ``robust/elastic.py``.  A distributed
``CGCheckpoint``'s vector leaves (x, r, p) live in the PADDED row
layout of one exact partition, which is why a resume under another
layout is refused with a typed ``CheckpointMismatch``.  This module
turns the refusal into a migration:

* :func:`lift_checkpoint` gathers every vector leaf back to GLOBAL row
  order through the saved layout's composed inverse (the variable-row
  padding strip ``partition.layout_gather_indices``, then the plan's
  inverse permutation: ``partition.plan_gather_indices``, the map
  ``solve_distributed`` applies to a returned ``x``).
* :func:`migrate_checkpoint` lifts, re-plans for the new shard count
  (``balance.plan_partition`` through ``dist_cg.resolve_plan``), and
  re-permutes and re-pads every leaf for the new layout.  The
  recurrence SCALARS (rho, rr, nrm0, k) are permutation-invariant inner
  products and pass through untouched.

The asserted contract is residual continuity across the seam: the
migration recomputes ``||r||`` of the lifted state on the host and
requires it within ``seam_rtol`` of the checkpointed ``sqrt(rr)``.  A
seam outside tolerance means the state (or the recorded layout) is
corrupt, and the migration fails typed instead of resuming garbage.

Leaves come back as host numpy, which
``solve_distributed(resume_from=...)`` places on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..parallel import partition as part

__all__ = [
    "MigrationResult",
    "MigrationSeamError",
    "lift_checkpoint",
    "migrate_checkpoint",
]

#: default residual-continuity tolerance across the migration seam:
#: the lifted ``||r||`` (exact permutation + zero-padding of the saved
#: vector) vs the checkpointed reduced ``sqrt(rr)`` differ only by
#: reduction order - well under 1e-5 for f32 states, 1e-12 for f64
DEFAULT_SEAM_RTOL = 1e-5


class MigrationSeamError(RuntimeError):
    """The migrated state's recomputed ``||r||`` disagrees with the
    checkpointed one past ``seam_rtol``: the saved vectors and the
    recorded layout do not describe the same state - resuming would
    silently converge to garbage, so the migration refuses."""


@dataclasses.dataclass(frozen=True)
class MigrationResult:
    """One migrated checkpoint plus its seam diagnostics.

    ``checkpoint`` holds host-numpy leaves in the NEW padded layout
    (what ``solve_distributed(resume_from=...)`` on the new mesh
    consumes); ``plan`` is the new partition plan (``None`` = even
    split).  ``r_norm`` is the
    recomputed global residual norm, ``checkpoint_r_norm`` the
    ``sqrt(rr)`` it must be continuous with, ``seam_rel_err`` their
    relative disagreement - the asserted elastic contract.
    """

    checkpoint: object
    plan: Optional[object]
    n_shards_from: int
    n_shards_to: int
    k: int
    r_norm: float
    checkpoint_r_norm: float
    seam_rel_err: float

    def to_json(self) -> dict:
        return {
            "n_shards_from": self.n_shards_from,
            "n_shards_to": self.n_shards_to,
            "k": self.k,
            "plan": (self.plan.label if self.plan is not None
                     else "even"),
            "plan_fingerprint": (self.plan.fingerprint()
                                 if self.plan is not None else None),
            "r_norm": self.r_norm,
            "checkpoint_r_norm": self.checkpoint_r_norm,
            "seam_rel_err": self.seam_rel_err,
        }

    def describe(self) -> str:
        plan_s = self.plan.label if self.plan is not None else "even"
        return (f"mesh {self.n_shards_from} -> {self.n_shards_to} at "
                f"k={self.k} (plan {plan_s}, ||r|| {self.r_norm:.6e}, "
                f"seam rel err {self.seam_rel_err:.2e})")


#: the checkpoint's vector leaves (global row layout); scalars pass
#: through a migration untouched
_VECTOR_LEAVES = ("x", "r", "p")
_SCALAR_LEAVES = ("rho", "rr", "nrm0", "k", "indefinite")


def _layout_rows(n: int, n_shards: int, plan) -> int:
    """The padded row count of the layout ``plan`` (``None``: the even
    split) gives ``n`` rows over ``n_shards``."""
    if plan is not None:
        return part.ranges_n_local(plan.row_ranges) * n_shards
    return part.padded_size(n, n_shards)


def lift_checkpoint(ckpt, n: int, *, n_shards: int, plan=None):
    """A distributed checkpoint's recurrence state in GLOBAL row order
    (host numpy): every vector leaf gathered through the saved
    layout's composed inverse (``plan``: the ``balance.PartitionPlan``
    it was written under, ``None`` = the even split), every scalar
    passed through.  The mesh-shape-free half of a migration - also
    useful on its own for inspecting a checkpoint in the caller's row
    ordering."""
    from ..solver.cg import CGCheckpoint

    x = part._host(ckpt.x)
    expect = _layout_rows(n, n_shards, plan)
    if x.shape[0] != expect:
        raise ValueError(
            f"checkpoint has {x.shape[0]} padded rows but the "
            f"declared layout (n={n}, {n_shards} shards, plan="
            f"{plan.label if plan is not None else 'even'}) pads to "
            f"{expect}: the checkpoint was written under a different "
            f"layout than the one recorded")
    idx = part.plan_gather_indices(n, n_shards, plan)
    leaves = {name: part._host(getattr(ckpt, name))[idx]
              for name in _VECTOR_LEAVES}
    leaves.update({name: part._host(getattr(ckpt, name))
                   for name in _SCALAR_LEAVES})
    return CGCheckpoint(**leaves)


def migrate_checkpoint(ckpt, n_shards_new: int, *, a,
                       n_shards_old: int, plan_old=None,
                       plan="auto", exchange=None, model=None,
                       seam_rtol: float = DEFAULT_SEAM_RTOL
                       ) -> MigrationResult:
    """Re-lay a distributed ``CGCheckpoint`` out for a new mesh shape.

    Args (the JAX ``migrate_checkpoint``'s):
      ckpt: the saved checkpoint (host arrays or tensors, padded layout
        of the OLD partition).
      n_shards_new: target shard count.
      a: the global operator (its row count defines the global layout).
      n_shards_old / plan_old: the layout the checkpoint was written
        under (``solve_resumable_distributed`` records both in the
        checkpoint's layout metadata; ``plan_old=None`` = even split).
      plan: the NEW layout - ``"auto"`` re-runs the balance planner
        for ``n_shards_new`` priced by ``model`` (default: the
        planner's H100 reference table), ``None`` keeps the even
        split, or an explicit ``balance.PartitionPlan``.
      exchange: the halo-wire lane the resumed solve will run
        (forwarded to the planner's lane hint exactly as
        ``solve_distributed`` does).
      seam_rtol: residual-continuity tolerance (see module docstring).

    Returns a :class:`MigrationResult`; raises
    :class:`MigrationSeamError` when the lifted state's recomputed
    ``||r||`` disagrees with the checkpointed one.
    """
    from ..parallel.dist_cg import _plan_exchange_hint, resolve_plan
    from ..solver.cg import CGCheckpoint

    if n_shards_new < 1:
        raise ValueError(
            f"n_shards_new must be >= 1, got {n_shards_new}")
    n = int(a.shape[0])
    lifted = lift_checkpoint(ckpt, n, n_shards=n_shards_old,
                             plan=plan_old)

    # the asserted elastic contract: the state the new mesh resumes
    # from must carry the residual the old mesh checkpointed
    r_norm = float(np.linalg.norm(np.asarray(lifted.r, np.float64)))
    ck_norm = float(np.sqrt(max(float(part._host(ckpt.rr)), 0.0)))
    seam = abs(r_norm - ck_norm) / max(ck_norm, 1e-300)
    if not np.isfinite(r_norm) or seam > seam_rtol:
        raise MigrationSeamError(
            f"migration seam broken: lifted ||r|| = {r_norm:.9e} vs "
            f"checkpointed sqrt(rr) = {ck_norm:.9e} (rel err "
            f"{seam:.3e} > {seam_rtol:g}): the saved vectors and the "
            f"recorded layout do not describe the same state")

    plan_new = resolve_plan(
        plan, a, n_shards_new, model=model,
        exchange=_plan_exchange_hint("allgather", exchange))
    perm = plan_new.permutation if plan_new is not None else None
    ranges = plan_new.row_ranges if plan_new is not None else None

    def repad(v: np.ndarray) -> np.ndarray:
        if perm is not None:
            v = v[perm]
        if ranges is not None:
            return part.pad_vector_ranges(
                v, ranges, part.ranges_n_local(ranges))
        return part.pad_vector(v, part.padded_size(n, n_shards_new))

    leaves = {name: repad(np.asarray(getattr(lifted, name)))
              for name in _VECTOR_LEAVES}
    leaves.update({name: np.asarray(getattr(lifted, name))
                   for name in _SCALAR_LEAVES})
    return MigrationResult(
        checkpoint=CGCheckpoint(**leaves), plan=plan_new,
        n_shards_from=int(n_shards_old), n_shards_to=int(n_shards_new),
        k=int(part._host(ckpt.k)), r_norm=r_norm,
        checkpoint_r_norm=ck_norm, seam_rel_err=float(seam))
