"""Wall-clock timing and profiling helpers.

Counterpart of the JAX package's ``utils/timing.py``.  Resurrects the
intent of the reference's dead code: ``cpuSecond()``
(``CUDACG.cu:35-39``) is defined but never called, and the program
reports no timing at all (SURVEY SS5).  CUDA launches are asynchronous,
so every measurement brackets a synchronization of the devices that
hold the result (:func:`_block`) - the ``cudaDeviceSynchronize`` the
reference would have needed around its (unwritten) timers.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch


def wall_seconds() -> float:
    """Monotonic wall clock (the working version of ``cpuSecond``)."""
    return time.perf_counter()


def _leaves(tree):
    """The tensors of a nested result: tensors, lists/tuples/dicts of
    them, and the fields of dataclasses and named tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def _block(tree) -> None:
    """Wait for all device work producing ``tree``: synchronize each CUDA
    device that holds one of its tensors (the JAX package calls
    ``block_until_ready``).  A no-op for CPU tensors, which are complete
    when they are returned."""
    devices = {t.device for t in _leaves(tree) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 1,
    repeats: int = 5,
    reduce: str = "best",
    **kwargs,
):
    """Time ``fn(*args)`` with warmup and device synchronization.

    Returns ``(seconds, result)`` where ``seconds`` is the best-of-repeats
    (``reduce="best"``, the standard steady-state protocol) or the median
    (``reduce="median"``, robust to launch-latency outliers).  The first
    ``warmup`` calls include kernel builds and are excluded.
    """
    import statistics

    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args, **kwargs)
        _block(result)
    times = []
    for _ in range(repeats):
        t0 = wall_seconds()
        result = fn(*args, **kwargs)
        _block(result)
        times.append(wall_seconds() - t0)
    if reduce == "best":
        return min(times), result
    if reduce == "median":
        return statistics.median(times), result
    raise ValueError(f"unknown reduce mode: {reduce!r}")


def paired_delta_rate(run: Callable[[int], object], lo: int, hi: int,
                      *, pairs: int = 7) -> float:
    """Iteration-delta throughput from INTERLEAVED lo/hi call pairs.

    ``run(it)`` must execute exactly ``it`` iterations of the work being
    measured.  The per-pair rate ``(hi - lo) / (t_hi - t_lo)`` cancels the
    per-call launch overhead, and interleaving the lo/hi calls cancels
    drift of the service rate, which a phase-separated protocol (all lo
    calls, then all hi calls) would alias into the subtraction.  Returns
    the median per-pair rate (robust to the occasional pair whose delta
    is swallowed by a jitter spike) in iterations/second.
    """
    import statistics

    _block(run(lo))   # warmup, both shapes
    _block(run(hi))
    rates = []
    for _ in range(max(pairs, 1)):
        t0 = wall_seconds()
        _block(run(lo))
        t_lo = wall_seconds() - t0
        t0 = wall_seconds()
        _block(run(hi))
        t_hi = wall_seconds() - t0
        rates.append((hi - lo) / max(t_hi - t_lo, 1e-9))
    return statistics.median(rates)


@dataclass
class Timer:
    """Accumulating named-section timer for coarse phase breakdowns."""

    sections: List[tuple] = field(default_factory=list)

    @contextlib.contextmanager
    def section(self, name: str, sync: Optional[object] = None):
        t0 = wall_seconds()
        try:
            yield
        finally:
            if sync is not None:
                _block(sync)
            self.sections.append((name, wall_seconds() - t0))

    def report(self) -> str:
        return "\n".join(f"{name:>24s}: {sec * 1e3:9.3f} ms"
                         for name, sec in self.sections)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Optional ``torch.profiler`` trace of the block, CPU and (when a
    card is present) CUDA activity, written as a Chrome trace
    (``trace.json``, Perfetto-readable) into ``log_dir``.

    No-op when ``log_dir`` is None, so call sites can be unconditional.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
