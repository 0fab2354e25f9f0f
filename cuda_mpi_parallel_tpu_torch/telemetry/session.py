"""``observe_solve``: one context manager that wires a solve into the
whole telemetry stack.

Counterpart of the JAX package's ``telemetry/session.py``.  Composes, in
one ``with`` block:

* a solve id + ``solve_start``/``solve_end`` events (:mod:`.events`);
* a ``utils.timing.Timer`` for named phase sections (build / solve /
  verify - the working version of the reference's dead ``cpuSecond``,
  ``CUDACG.cu:35-39``);
* an optional ``torch.profiler`` trace (``utils.timing.profile_trace``);
* registry metrics: solve count/outcome, iteration totals, wall-time
  histogram (:mod:`.registry`).

The context NEVER reads device values on its own - the caller decides
when the solve's results are synced by calling ``obs.finish(result)``
(typically after ``time_fn``, which synced already; a 0-d CUDA tensor
of the result is then read once).  An unfinished scope still emits ``solve_end`` with
``status="unobserved"`` so traces have no dangling starts.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..utils import timing
from . import events
from .registry import REGISTRY

__all__ = ["SolveObservation", "observe_solve", "solve_metrics"]

#: cap on per-boundary check_block events for one solve: a 2000-
#: iteration history at check_every=1 must not turn the trace file
#: into a 2000-line wall; boundaries are strided to stay under this.
MAX_CHECK_BLOCK_EVENTS = 32


#: per-solve iteration histogram buckets (iteration-flavored, spanning
#: the 3-iteration oracle to capped 256^3 marathons)
ITERATION_BUCKETS = (1, 3, 10, 30, 100, 300, 1000, 3000, 10000, 30000)


def solve_metrics():
    """The registry metrics every observed solve feeds (get-or-create,
    so import order never matters)."""
    return {
        "solves": REGISTRY.counter(
            "solves_total", "solves observed, by engine and outcome",
            labelnames=("engine", "status")),
        "iterations": REGISTRY.counter(
            "solve_iterations_total", "CG iterations run, by engine",
            labelnames=("engine",)),
        "iters_hist": REGISTRY.histogram(
            "solve_iterations_per_solve",
            "iterations per observed solve, by engine",
            labelnames=("engine",), buckets=ITERATION_BUCKETS),
        "seconds": REGISTRY.histogram(
            "solve_seconds", "observed wall time per solve",
            labelnames=("engine",)),
    }


def note_breakdown(site: str, iterations: int,
                   status: str = "BREAKDOWN", **fields: Any) -> None:
    """One typed breakdown -> ``solve_fault`` event +
    ``solve_breakdowns_total`` counter.  The SINGLE definition every
    emission site shares (observe_solve's epilogue, the recovery
    layer, the serve dispatcher) - three hand-spelled copies of the
    counter would silently fork its help text on the next edit."""
    REGISTRY.counter(
        "solve_breakdowns_total",
        "solves that exited with a typed BREAKDOWN (non-finite "
        "recurrence or non-SPD preconditioner)",
        labelnames=("site",)).inc(site=site)
    events.emit("solve_fault", site=site, status=status,
                iterations=iterations, **fields)


class SolveObservation:
    """Handle yielded by :func:`observe_solve`."""

    def __init__(self, solve_id: str, label: str, engine: str,
                 check_every: int):
        self.solve_id = solve_id
        self.label = label
        self.engine = engine
        self.check_every = max(int(check_every), 1)
        self.timer = timing.Timer()
        self.result = None
        self.elapsed_s: Optional[float] = None
        self._finished = False

    def section(self, name: str, sync=None):
        """Named phase section on the observation's timer."""
        return self.timer.section(name, sync=sync)

    def finish(self, result, elapsed_s: Optional[float] = None,
               health=None, **extra: Any) -> Dict[str, Any]:
        """Record the solve's outcome.  ``result`` is a ``CGResult``
        (or the df64 adapter) whose scalars the CALLER has already
        synced - reading them here is a host conversion, not a new
        device round-trip.  ``health`` is an optional
        ``telemetry.health.SolveHealth`` (computed by the caller from
        the post-solve flight record); when given, the verdict is
        emitted as a ``solve_health`` event + gauges inside this
        solve's scope and embedded in the ``solve_end`` payload.
        Returns the ``solve_end`` payload."""
        self.result = result
        self.elapsed_s = elapsed_s
        iterations = int(result.iterations)
        status = result.status_enum().name
        metrics = solve_metrics()
        metrics["solves"].inc(engine=self.engine, status=status)
        metrics["iterations"].inc(iterations, engine=self.engine)
        metrics["iters_hist"].observe(iterations, engine=self.engine)
        if elapsed_s is not None:
            metrics["seconds"].observe(elapsed_s, engine=self.engine)

        if health is not None:
            from .health import emit_solve_health

            extra = dict(extra, health=emit_solve_health(
                health, engine=self.engine))
        self._emit_check_blocks(result, iterations)
        payload: Dict[str, Any] = dict(
            status=status,
            iterations=iterations,
            residual_norm=float(result.residual_norm),
            converged=bool(result.converged),
            label=self.label,
            engine=self.engine,
            sections={name: sec for name, sec in self.timer.sections},
            **extra,
        )
        if elapsed_s is not None:
            payload["elapsed_s"] = float(elapsed_s)
        if status == "BREAKDOWN":
            # typed fault detection lands in telemetry even when no
            # recovery wrapper ran (site is unknown here - the solver
            # only knows the recurrence went non-finite; an armed
            # FaultPlan's site rides the recovery layer's emission)
            note_breakdown("unknown", iterations, engine=self.engine)
        events.emit("solve_end", **payload)
        self._finished = True
        return payload

    def _emit_check_blocks(self, result, iterations: int) -> None:
        """Check-block stats, post-solve and host-side only: boundary
        residuals come out of the RECORDED history (``solver/cg.py``
        writes it on device during the solve), never from probing live
        device state."""
        if not events.active():
            return
        k = self.check_every
        n_blocks = -(-iterations // k) if iterations else 0
        hist = getattr(result, "residual_history", None)
        if hist is None:
            events.emit("check_block", iteration=iterations,
                        block=n_blocks, check_every=k, final=True)
            return
        if isinstance(hist, torch.Tensor):
            hist = hist.detach().cpu().numpy()
        hist = np.asarray(hist)
        boundaries = [min(j * k, iterations)
                      for j in range(1, n_blocks + 1)] or [0]
        stride = max(1, -(-len(boundaries) // MAX_CHECK_BLOCK_EVENTS))
        picked = boundaries[::stride]
        if boundaries[-1] not in picked:
            picked.append(boundaries[-1])
        for it in picked:
            if it < hist.shape[0] and np.isfinite(hist[it]):
                events.emit("check_block", iteration=it,
                            block=-(-it // k) if it else 0,
                            check_every=k,
                            residual_norm=float(hist[it]),
                            final=it == iterations)


@contextlib.contextmanager
def observe_solve(label: str, *, engine: str = "general",
                  check_every: int = 1,
                  profile_dir: Optional[str] = None,
                  **meta: Any) -> Iterator[SolveObservation]:
    """Observe one solve end to end.

    Usage::

        with observe_solve("poisson2d n=1024", engine="auto") as obs:
            with obs.section("build"):
                a, b = build_problem()
            with obs.section("solve"):
                elapsed, result = time_fn(lambda: solve(a, b))
            obs.finish(result, elapsed_s=elapsed)

    ``meta`` keys ride on the ``solve_start`` event.  When
    ``profile_dir`` is set, the whole block runs under a
    ``torch.profiler`` trace (a Chrome trace in that directory).
    """
    sid = events.new_solve_id()
    with events.solve_scope(sid):
        events.emit("solve_start", label=label, engine=engine,
                    check_every=check_every, **meta)
        obs = SolveObservation(sid, label, engine, check_every)
        try:
            with timing.profile_trace(profile_dir):
                yield obs
        except BaseException as e:
            # the no-dangling-starts contract holds on the error path
            # too: close the solve's trace, then re-raise untouched
            if not obs._finished:
                events.emit("solve_end", status="error", iterations=0,
                            residual_norm=None, label=label,
                            engine=engine, error=type(e).__name__)
            raise
        if not obs._finished:
            events.emit("solve_end", status="unobserved", iterations=0,
                        residual_norm=None, label=label, engine=engine)
