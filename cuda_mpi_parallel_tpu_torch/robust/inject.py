"""Host-level preemption for segmented resumable solves.

Counterpart of the host-level part of the JAX package's
``robust/inject.py``: :class:`Preemption` kills a resumable solve
between segment checkpoints (``utils.checkpoint.
solve_resumable_distributed`` calls the hook after each save), so the
restart/resume drill is deterministic, and :class:`PreemptedError` /
:class:`ShardLostError` are the typed failures of that drill.

The in-trace fault injection (``FaultPlan``, ``FAULT_SITES``,
``HOST_FAULT_SITES``) is not ported yet: naming it raises
``NotImplementedError`` (ROADMAP A15).
"""
from __future__ import annotations

import dataclasses

#: the JAX module's names that come with ROADMAP A15
_LATER = frozenset({"FaultPlan", "FAULT_SITES", "HOST_FAULT_SITES",
                    "TRACE_FAULT_SITES"})


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"robust.inject.{name} is not ported yet (ROADMAP A15: fault "
            f"injection)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
