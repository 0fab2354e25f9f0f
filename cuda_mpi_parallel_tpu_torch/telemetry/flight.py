"""Convergence flight recorder: in-loop telemetry with no host syncs.

Counterpart of the JAX package's ``telemetry/flight.py``.  The reference
checks convergence every iteration but reports nothing
(``CUDACG.cu:333,365`` - "Success" unconditionally, SURVEY Q4/Q7).  The
flight recorder is a **fixed-size, stride-decimated ring buffer** of
``(iteration, ||r||^2, alpha, beta)`` rows that every recorder-capable
engine fills as it runs, and that reads exactly like the JAX package's:
the same rows, NaN in unwritten slots, the solve's dtype, the same ring
wrap.

The port's loops are driven from the host, so the iteration count ``k``
is a host ``int`` and the host decides whether row
``(k // stride) % capacity`` is written at all (the JAX package writes
a masked row every iteration).  Properties the design guarantees:

* **One launch a recorded row, and no host sync.**  The row's
  ``(rr, alpha, beta)`` - 0-d device tensors the step already holds -
  go into the buffer with one ``torch.stack(..., out=...)``; the
  iteration column stays on the host (a numpy array) and is copied to
  the device once, when the result is packaged
  (:meth:`FlightRing.buffer`).  The row's cost is host time, about 16
  us a row on the H100 machine (``chip_smoke.py``'s ``flight_256``
  line), which shows where a loop is host-bound; ``stride`` divides it.
* **Bit-identical iterates when on.**  The recorder only reads the
  step's scalars; with ``flight=None`` the solver does not build it.
* **Bounded cost.**  One ``(capacity, 4)`` buffer, independent of
  ``maxiter`` and stride; distributed solves record the all-reduced
  scalars, so every shard's buffer is the same.

The sampled heartbeat (``FlightConfig.heartbeat``; the JAX package's
``maybe_heartbeat``, a ``jax.debug.callback``) is a queue on the ring:
:meth:`FlightRing.beat` keeps ``(k, rr)`` on the device, and the
engine's check-block read (:meth:`FlightRing.stage` before it,
:meth:`FlightRing.deliver` after) carries the samples to the host in a
copy queued ahead of the convergence flag's, so the one sync of the
check block covers both.  Each sample becomes a ``flight_heartbeat``
event.  Samples a solve leaves undelivered (it stopped at ``maxiter``,
with no last read) wait in this module until :func:`drain_heartbeats`
emits them, at the exit of an ``events`` scope - as the JAX package
drains its callbacks there.

On top of the record, :mod:`.health` reconstructs the CG-Lanczos
tridiagonal from the alpha/beta columns to estimate the extreme Ritz
values and condition number, and classifies stagnation / plateau /
divergence - see ``health.assess_solve_health``.

The one-launch engines cannot write a ring from inside their kernel,
but the kernels already keep a check-block-granular ``||r||^2`` trace
for the convergence decision; :func:`buffer_from_block_history` adapts
it into the same layout (alpha/beta columns NaN).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "COLUMNS",
    "FlightConfig",
    "FlightRecord",
    "buffer_from_block_history",
    "flight_init",
    "flight_init_many",
    "flight_record",
    "flight_record_many",
    "lanes_from_buffer",
    "many_columns",
]

#: Column layout of one recorder row.
COLUMNS = ("iteration", "residual_sq", "alpha", "beta")

#: Default ring capacity: 1024 rows x 4 f32 = 16 KiB.
DEFAULT_CAPACITY = 1024

#: Hard cap on ``FlightConfig.for_solve``-derived capacities: 4096 rows
#: keep the buffer at 64 KiB and the host-side spectral window
#: (health.py) cheap.
CAPACITY_LIMIT = 4096


@dataclasses.dataclass(frozen=True)
class FlightConfig:
    """Static recorder configuration (hashable: it may key a solver
    cache).

    ``capacity``: ring rows; once ``capacity * stride`` iterations have
    run, the oldest rows are overwritten (the record keeps the LAST
    ``capacity`` sampled iterations).
    ``stride``: decimation - record every ``stride``-th iteration.
    ``heartbeat``: iterations between sampled host heartbeats (a
    ``flight_heartbeat`` event each); 0 (the default) adds nothing to
    the loop.
    """

    capacity: int = DEFAULT_CAPACITY
    stride: int = 1
    heartbeat: int = 0

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.heartbeat < 0:
            raise ValueError(
                f"heartbeat must be >= 0 (0 = off), got {self.heartbeat}")

    @classmethod
    def for_solve(cls, maxiter: int, stride: int = 1, heartbeat: int = 0,
                  limit: int = CAPACITY_LIMIT) -> "FlightConfig":
        """Capacity sized so a ``maxiter``-iteration solve at ``stride``
        never wraps (bounded by ``limit``): lossless up to
        ``limit * stride`` iterations, last-window beyond."""
        capacity = max(1, min(maxiter // max(stride, 1) + 1, limit))
        return cls(capacity=capacity, stride=stride, heartbeat=heartbeat)

    def without_heartbeat(self) -> "FlightConfig":
        """This config with the heartbeat stripped.  The distributed
        lanes run it (one sample per shard would multiply the stream),
        so their solver caches never fork on a field that cannot change
        the solve."""
        if not self.heartbeat:
            return self
        return dataclasses.replace(self, heartbeat=0)


def _slot(cfg: FlightConfig, k: int) -> Optional[int]:
    """The ring row iteration ``k`` writes, or ``None`` when the stride
    skips it."""
    if k % cfg.stride:
        return None
    return (k // cfg.stride) % cfg.capacity


class FlightRing:
    """The recorder an engine's loop carries: the device buffer of
    ``(rr, alpha, beta)``, on the host the iteration column, and the
    heartbeat's samples.

    :meth:`record` takes a host ``int`` ``k`` and the step's 0-d device
    scalars; :meth:`buffer` returns the ``(capacity, 4)`` buffer with the
    iteration column filled - what ``result.flight`` holds.
    """

    def __init__(self, cfg: FlightConfig, dtype, device, k0: int, rr0):
        self.cfg = cfg
        self.buf = torch.full((cfg.capacity, len(COLUMNS)), float("nan"),
                              dtype=dtype, device=device)
        self.its = np.full(cfg.capacity, np.nan)
        self.queued: list = []      # (k, rr, scope) samples not yet staged
        self.staged: list = []      # _Batch copies on their way to the host
        slot = _slot(cfg, int(k0))
        if slot is not None:        # the initial state: no step has run
            self.buf[slot, 1].copy_(rr0)
            self.its[slot] = k0

    def record(self, k: int, rr, alpha, beta) -> None:
        """Row ``(k, rr, alpha, beta)`` when the stride samples ``k``:
        one launch, no host read."""
        slot = _slot(self.cfg, k)
        if slot is None:
            return
        torch.stack([rr, alpha, beta], out=self.buf[slot, 1:])
        self.its[slot] = k

    def beat(self, k: int, rr) -> None:
        """The sampled heartbeat: every ``heartbeat``-th iteration queues
        ``(k, rr)`` - ``rr`` stays a device scalar - with the scope of
        the solve in flight."""
        if self.cfg.heartbeat and k % self.cfg.heartbeat == 0:
            from . import events

            self.queued.append((k, rr, events.ambient_scope()))

    def stage(self) -> None:
        """Start the queued samples' copy to the host, ahead of a check
        block's read: one stack and one non-blocking copy into pinned
        memory, then an event.  No sync."""
        if self.queued:
            self.staged.append(_Batch.of(self.queued))
            self.queued = []

    def deliver(self) -> None:
        """Emit the staged samples whose copy has completed - after a
        check block's read, all of them: that read synchronized the
        stream behind the copy."""
        while self.staged and self.staged[0].done():
            self.staged.pop(0).emit()

    def buffer(self) -> torch.Tensor:
        """The buffer with its iteration column: one host-to-device copy
        (from pinned memory on the card, so it does not sync).  Samples
        still on their way are left to :func:`drain_heartbeats`."""
        self.stage()
        self.deliver()
        _UNDELIVERED.extend(self.staged)
        self.staged = []
        col = torch.from_numpy(self.its).to(self.buf.dtype)
        if self.buf.device.type == "cuda":
            col = col.pin_memory()
        self.buf[:, 0].copy_(col, non_blocking=True)
        return self.buf


def flight_init(cfg: FlightConfig, dtype, k0, rr0):
    """Fresh ring buffer with the solve's initial state recorded
    (iteration ``k0``, residual ``rr0``, alpha/beta NaN - no step has
    run yet) on ``rr0``'s device.  Unwritten rows are NaN."""
    rr0 = torch.as_tensor(rr0)
    buf = torch.full((cfg.capacity, len(COLUMNS)), float("nan"),
                     dtype=dtype, device=rr0.device)
    nan = torch.full((), float("nan"), dtype=dtype, device=rr0.device)
    return flight_record(buf, cfg, k0, rr0, nan, nan)


def flight_record(buf, cfg: FlightConfig, k, rr, alpha, beta):
    """One ring write: when ``k % stride == 0``, row
    ``(k // stride) % capacity`` becomes ``(k, rr, alpha, beta)``;
    otherwise the buffer passes through unchanged.  ``k`` is an
    iteration count the host holds; the write is in place and the
    buffer is returned.  (The engines' loops use :class:`FlightRing`,
    which defers the iteration column to one copy per solve.)"""
    k = int(k)
    slot = _slot(cfg, k)
    if slot is None:
        return buf
    dtype = buf.dtype
    buf[slot, 0] = float(k)
    torch.stack([torch.as_tensor(v, device=buf.device).to(dtype).reshape(())
                 for v in (rr, alpha, beta)], out=buf[slot, 1:])
    return buf


# ---------------------------------------------------------------------------
# The sampled heartbeat's way to the host


class _Batch:
    """Heartbeat samples copied to the host together: ``values`` is a
    host tensor a non-blocking copy fills, complete once ``event`` (a
    CUDA event; ``None`` on the CPU, where the copy is the stack) has
    passed."""

    def __init__(self, its, values, scopes, event):
        self.its, self.values, self.scopes, self.event = \
            its, values, scopes, event

    @classmethod
    def of(cls, samples) -> "_Batch":
        values = torch.stack([rr for _, rr, _ in samples])
        event = None
        if values.device.type == "cuda":
            values = values.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return cls([k for k, _, _ in samples], values,
                   [scope for _, _, scope in samples], event)

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def emit(self) -> None:
        for k, rr, scope in zip(self.its, self.values.tolist(),
                                self.scopes):
            _heartbeat_host(k, rr, scope)


#: batches that finished solves left on their way to the host
_UNDELIVERED: list = []


def drain_heartbeats() -> None:
    """Emit every sample a finished solve left undelivered, waiting for
    its copy (post-solve: the exit of an ``events`` scope)."""
    while _UNDELIVERED:
        batch = _UNDELIVERED.pop(0)
        if batch.event is not None:
            batch.event.synchronize()
        batch.emit()


def _heartbeat_host(iteration: int, residual_sq: float, scope) -> None:
    """Host side of one sample: the most-recent-iteration gauge and,
    when a sink listens, the ``flight_heartbeat`` event with the scope
    of the solve that took it."""
    from . import events
    from .registry import REGISTRY

    REGISTRY.gauge(
        "solve_heartbeat_iteration",
        "most recent in-flight heartbeat iteration (sampled; only "
        "emitted when FlightConfig.heartbeat > 0)").set(iteration)
    if events.active():
        events.emit("flight_heartbeat", iteration=iteration,
                    residual_sq=residual_sq, **scope)


# ---------------------------------------------------------------------------
# Many-RHS (batched) recorder: one ring buffer carrying every lane
#
# A batched CG runs k solves through one loop; its recorder rows are
# ``(iteration, rr_0..rr_{k-1}, alpha_0..alpha_{k-1}, beta_0..beta_{k-1})``
# in ONE (capacity, 1 + 3k) buffer, written with the same slot rule as the
# single-RHS buffer.  ``lanes_from_buffer`` slices the fetched buffer back
# into k standard FlightRecords.


def many_columns(n_rhs: int) -> int:
    """Row width of a batched flight buffer: iteration + 3 per-lane
    scalar columns (rr, alpha, beta)."""
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    return 1 + 3 * n_rhs


def flight_init_many(cfg: FlightConfig, dtype, k0, rr0):
    """Fresh batched ring buffer (``rr0`` is the per-lane ``(k,)``
    initial residual; alpha/beta lanes NaN - no step has run)."""
    rr0 = torch.as_tensor(rr0)
    n_rhs = int(rr0.shape[0])
    buf = torch.full((cfg.capacity, many_columns(n_rhs)), float("nan"),
                     dtype=dtype, device=rr0.device)
    nan = torch.full((n_rhs,), float("nan"), dtype=dtype, device=rr0.device)
    return flight_record_many(buf, cfg, k0, rr0, nan, nan)


def flight_record_many(buf, cfg: FlightConfig, k, rr, alpha, beta):
    """One ring write of a batched row (``rr``/``alpha``/``beta`` are
    ``(k,)`` per-lane scalars) - the slot rule of :func:`flight_record`;
    in place, the buffer returned."""
    k = int(k)
    slot = _slot(cfg, k)
    if slot is None:
        return buf
    dtype = buf.dtype
    buf[slot, 0] = float(k)
    torch.cat([torch.as_tensor(v, device=buf.device).to(dtype).reshape(-1)
               for v in (rr, alpha, beta)], out=buf[slot, 1:])
    return buf


def _host(buf) -> np.ndarray:
    """A buffer as a float64 numpy array (one device-to-host copy for a
    tensor on the card; post-solve)."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().double().numpy()
    return np.asarray(buf, dtype=np.float64)


def lanes_from_buffer(buf, n_rhs: int, stride: Optional[int] = None):
    """Slice a fetched batched buffer into ``n_rhs`` standard
    :class:`FlightRecord` views (lane ``j``: iteration, ``rr_j``,
    ``alpha_j``, ``beta_j``).  Host-side numpy, once, post-solve."""
    arr = _host(buf)
    expect = many_columns(n_rhs)
    if arr.ndim != 2 or arr.shape[1] != expect:
        raise ValueError(
            f"batched flight buffer must be (capacity, {expect}) for "
            f"n_rhs={n_rhs}, got {arr.shape}")
    records = []
    for j in range(n_rhs):
        lane = np.stack([arr[:, 0], arr[:, 1 + j],
                         arr[:, 1 + n_rhs + j],
                         arr[:, 1 + 2 * n_rhs + j]], axis=1)
        records.append(FlightRecord.from_buffer(lane, stride=stride))
    return records


def buffer_from_block_history(block_rr, check_every: int,
                              cap: Optional[int] = None) -> np.ndarray:
    """Adapt a resident kernel's block trace to the recorder layout.

    ``block_rr``: the ``(nblocks + 1,)`` ``||r||^2`` trace the resident
    kernels keep (slot 0 = initial, slot j = after block j, ``-1.0``
    sentinel for never-run blocks).  Returns a standard ``(rows, 4)``
    flight buffer: iteration ``min(j * check_every, cap)``, the block
    residual, NaN alpha/beta (the kernel's recurrence scalars never
    leave the chip).  Host-side numpy - called once post-solve.
    """
    arr = _host(block_rr).reshape(-1)
    n = arr.shape[0]
    its = np.arange(n, dtype=np.float64) * float(check_every)
    if cap is not None:
        its = np.minimum(its, float(cap))
    buf = np.full((n, len(COLUMNS)), np.nan)
    valid = arr >= 0.0  # ||r||^2 >= 0; -1.0 is the never-ran sentinel
    buf[valid, 0] = its[valid]
    buf[valid, 1] = arr[valid]
    return buf


@dataclasses.dataclass(frozen=True)
class FlightRecord:
    """Host-side view of a fetched flight buffer: rows sorted by
    iteration, unwritten (NaN) slots dropped, duplicates (ring slots
    that share a capped iteration) resolved to the last write."""

    iterations: np.ndarray   # (m,) int64, strictly increasing
    residual_sq: np.ndarray  # (m,) float64
    alphas: np.ndarray       # (m,) float64 (NaN where not recorded)
    betas: np.ndarray        # (m,) float64
    stride: int = 1

    @classmethod
    def from_buffer(cls, buf, stride: Optional[int] = None
                    ) -> "FlightRecord":
        """The post-solve fetch: ONE host conversion of the buffer (the
        solve itself is already complete)."""
        arr = _host(buf).reshape(-1, len(COLUMNS))
        mask = np.isfinite(arr[:, 0])
        rows = arr[mask]
        # stable sort + keep-last dedupe: a capped final block can land
        # on an iteration an earlier ring pass also wrote
        order = np.argsort(rows[:, 0], kind="stable")
        rows = rows[order]
        if rows.shape[0]:
            keep = np.append(rows[1:, 0] != rows[:-1, 0], True)
            rows = rows[keep]
        its = rows[:, 0].astype(np.int64)
        if stride is None:
            # infer from the LEADING diffs: the final row may be
            # cap-clamped (a resident block trace whose last block hit
            # iter_cap mid-block), so the last diff can be a remainder
            # smaller than the true granularity
            diffs = np.diff(its)
            if diffs.size > 1:
                stride = int(diffs[:-1].min())
            elif diffs.size == 1:
                stride = int(diffs[0])
            else:
                stride = 1
        return cls(iterations=its, residual_sq=rows[:, 1],
                   alphas=rows[:, 2], betas=rows[:, 3],
                   stride=max(int(stride), 1))

    @classmethod
    def from_history(cls, history, stride: Optional[int] = None
                     ) -> "FlightRecord":
        """Adapt a ``residual_history`` array (``||r||`` at finite
        indices, NaN elsewhere - the dense general-solver trace or the
        resident engines' expanded block trace) into a record with NaN
        alpha/beta columns."""
        hist = _host(history).reshape(-1)
        idx = np.nonzero(np.isfinite(hist))[0]
        buf = np.full((idx.shape[0], len(COLUMNS)), np.nan)
        buf[:, 0] = idx
        buf[:, 1] = hist[idx] ** 2
        return cls.from_buffer(buf, stride=stride)

    def __len__(self) -> int:
        return int(self.iterations.shape[0])

    @property
    def residuals(self) -> np.ndarray:
        """``||r||`` per recorded iteration (sqrt of the stored
        ``||r||^2``)."""
        return np.sqrt(np.maximum(self.residual_sq, 0.0))

    def to_history(self, maxiter: int, dtype=np.float64) -> np.ndarray:
        """Expand into the solvers' ``(maxiter + 1,)``
        ``residual_history`` layout: ``||r||`` at recorded iterations,
        NaN elsewhere."""
        hist = np.full(maxiter + 1, np.nan, dtype=dtype)
        keep = self.iterations <= maxiter
        hist[self.iterations[keep]] = self.residuals[keep].astype(dtype)
        return hist

    def decay_rate(self, tail: Optional[int] = None) -> Optional[float]:
        """Least-squares slope of ``log10 ||r||`` per iteration over the
        (optionally last-``tail``-rows of the) record; negative means
        converging, ~0 means flatlined.  ``None`` with < 2 usable
        points (zero/non-finite residuals are excluded)."""
        its = self.iterations.astype(np.float64)
        res = self.residuals
        if tail is not None and tail < its.shape[0]:
            its, res = its[-tail:], res[-tail:]
        ok = np.isfinite(res) & (res > 0.0)
        if int(ok.sum()) < 2 or its[ok][-1] == its[ok][0]:
            return None
        slope = np.polyfit(its[ok], np.log10(res[ok]), 1)[0]
        return float(slope)

    def summary(self) -> dict:
        """Compact JSON-ready digest."""
        out = {
            "n_records": len(self),
            "stride": int(self.stride),
            "first_iteration": (int(self.iterations[0]) if len(self)
                                else None),
            "last_iteration": (int(self.iterations[-1]) if len(self)
                               else None),
            "decay_rate": self.decay_rate(),
        }
        if len(self):
            res = self.residuals
            ok = np.isfinite(res)
            out["residual_first"] = float(res[0]) if ok[0] else None
            out["residual_last"] = float(res[-1]) if ok[-1] else None
            out["residual_min"] = (float(res[ok].min()) if ok.any()
                                   else None)
        return out

    def to_json(self) -> dict:
        """Full record as strict-JSON-ready lists (non-finite values
        are the consumer's to sanitize - ``utils.logging.sanitize``)."""
        return {
            "stride": int(self.stride),
            "iterations": [int(v) for v in self.iterations],
            "residual_sq": list(self.residual_sq),
            "alpha": list(self.alphas),
            "beta": list(self.betas),
        }
