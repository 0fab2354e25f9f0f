"""Empirical configuration autotuner + the measured-artifact disk cache.

Counterpart of the JAX package's ``utils/tune.py``.  The solver exposes
performance knobs whose best setting depends on the card and the
problem: ``check_every`` (predicate cadence, one host read a block),
``method`` (cg / cg1 recurrences) and the stencil ``backend`` (plain
torch shifted adds, ``"xla"``, against the hand kernel B1/B2,
``"pallas"``); for an assembled CSR matrix the format (ELL, DIA, and the
sliced ELL of the hand SpMV B8, ``to_shiftell``).  :func:`autotune`
measures each candidate's marginal per-iteration cost on the actual
device with the actual operator (iteration-count deltas, so the fixed
dispatch cost cancels; ``utils.timing.time_fn`` synchronises the card
around each solve) and returns the fastest configuration as
ready-to-splat solver kwargs.

:class:`JsonCache` is the on-disk home for everything *measured* on this
host that is worth keeping across processes: the roofline's
CPU-calibrated machine model lives here (keyed by
:func:`host_fingerprint`).  The file format, the envelope and
``$CUDA_MPI_PARALLEL_TPU_CACHE_DIR`` are the JAX package's, so both
packages on one host share one measurement.  Entries carry a
``created_at`` stamp and readers pass a staleness bound - an old
measurement is treated as absent, never silently trusted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from .timing import time_fn

#: environment override for the cache directory (tests and CI point this
#: at a scratch dir so measured artifacts never leak across runs)
CACHE_DIR_ENV = "CUDA_MPI_PARALLEL_TPU_CACHE_DIR"


def default_cache_dir() -> str:
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "cuda_mpi_parallel_tpu")


def host_fingerprint() -> str:
    """Short stable digest of THIS host (node name, arch, core count):
    the cache key component that keeps one machine's measured bandwidths
    from pricing another machine's plans."""
    import platform

    raw = f"{platform.node()}|{platform.machine()}|{os.cpu_count()}"
    return hashlib.sha1(raw.encode()).hexdigest()[:12]


class JsonCache:
    """Tiny key -> JSON-payload disk cache with creation stamps.

    One file per key under ``directory`` (default:
    ``$CUDA_MPI_PARALLEL_TPU_CACHE_DIR`` or
    ``~/.cache/cuda_mpi_parallel_tpu``).  Writes are atomic (tmp +
    rename) so a crashed writer can never leave a half-entry; reads
    treat a corrupt or stale file as a miss, never an error - cache
    failure must degrade to "measure again", not break a solve.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or default_cache_dir()

    def path(self, key: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", key)
        return os.path.join(self.directory, f"{safe}.json")

    def get(self, key: str,
            max_age_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """The envelope ``{"created_at": unix_s, "payload": {...}}`` for
        ``key``, or ``None`` when missing, unparseable, malformed, or
        older than ``max_age_s``."""
        try:
            with open(self.path(key), encoding="utf-8") as f:
                entry = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None
        if not isinstance(entry, dict) \
                or not isinstance(entry.get("created_at"), (int, float)) \
                or "payload" not in entry:
            return None
        if max_age_s is not None \
                and time.time() - entry["created_at"] > max_age_s:
            return None
        return entry

    def put(self, key: str, payload: Any,
            created_at: Optional[float] = None) -> str:
        """Atomically write ``payload`` under ``key``; returns the entry
        path.  Raises ``OSError`` on an unwritable directory - callers
        that can live without persistence catch it."""
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(key)
        entry = {"created_at": (time.time() if created_at is None
                                else float(created_at)),
                 "payload": payload}
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(entry, f, allow_nan=False)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def delete(self, key: str) -> None:
        try:
            os.unlink(self.path(key))
        except OSError:
            pass


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of an autotune sweep."""

    best: Dict            # pure kwargs for solve()/solve_distributed()
    us_per_iter: float    # measured marginal cost of the best config
    table: Dict[str, float]  # config label -> us/iter (nan = failed/noisy)
    operator: Optional[object] = None  # winning operator variant, if any

    def __str__(self) -> str:
        op = f" operator={type(self.operator).__name__}" if (
            self.operator is not None) else ""
        lines = [f"autotune: best = {self.best}{op} "
                 f"({self.us_per_iter:.1f} us/iter)"]
        for label, us in sorted(self.table.items(), key=lambda kv: kv[1]):
            lines.append(f"  {label:40s} {us:10.1f} us/iter")
        return "\n".join(lines)


def _hand_kernel_fits(a) -> bool:
    """The port's shape gate of B1/B2 (``ops.cuda.stencil``): a float32
    or float64 grid of any extent (the TPU kernels' tiling rules do not
    apply)."""
    import torch

    return a.dtype in (torch.float32, torch.float64)


def _on_card(b) -> bool:
    """Whether the sweep's tensors live on a CUDA device: there a
    candidate's failure is a hand kernel failing to build or launch, and
    it propagates rather than letting a plain-torch candidate win."""
    return bool(getattr(b, "is_cuda", False))


def _candidate_ops(a):
    """Yield (label, operator) variants lazily: stencils try both matvec
    backends (``"pallas"`` the hand kernel B1/B2); CSR matrices try the
    alternative assembled formats (ELL rectangular gather, DIA shifted
    FMAs, the sliced ELL of the hand SpMV B8).  Lazy so at most one
    converted copy is alive during the sweep."""
    from ..models.operators import CSRMatrix, Stencil2D, Stencil3D

    yield "", a
    if isinstance(a, (Stencil2D, Stencil3D)):
        for backend in ("xla", "pallas"):
            if backend == a.backend:
                continue
            if backend == "pallas" and not _hand_kernel_fits(a):
                continue
            yield f"backend={backend} ", dataclasses.replace(
                a, backend=backend)
    if isinstance(a, CSRMatrix):
        for fmt, conv in (("ell", a.to_ell), ("dia", a.to_dia),
                          ("shiftell", a.to_shiftell)):
            try:
                yield f"format={fmt} ", conv()
            except ValueError:
                continue  # e.g. too many diagonals for DIA


def autotune(
    a,
    b,
    *,
    m=None,
    methods: Tuple[str, ...] = ("cg", "cg1"),
    check_everys: Tuple[int, ...] = (1, 32),
    iters_lo: int = 32,
    iters_hi: int = 160,
    repeats: int = 3,
) -> TuneResult:
    """Measure candidate solver configurations and return the fastest.

    Each candidate runs ``tol=0`` solves of ``iters_lo`` and ``iters_hi``
    iterations; the cost is the delta divided by the iteration gap, which
    cancels fixed dispatch overhead.  Keep ``iters_hi`` below the point
    where a strong preconditioner drives the residual to exact zero (the
    loop would exit early and corrupt the delta).

    A candidate that exits early or measures a non-positive delta scores
    nan, and a format that does not fit the matrix (the ``ValueError`` of
    its conversion) is not offered.  Any other failure of a candidate
    propagates when ``b`` lives on the card, where the candidates are the
    hand kernels (B1/B2, B8); on CPU tensors it scores nan, as in the JAX
    package.

    Returns a ``TuneResult``; splat ``result.best`` into ``solve``:

        cfg = autotune(op, b)
        res = solve(cfg.operator or op, b, rtol=1e-6, **cfg.best)
    """
    from ..solver.cg import solve

    table: Dict[str, float] = {}
    best: Optional[Tuple[float, Dict, Optional[object]]] = None
    # On a loaded host, small iteration gaps can lose EVERY candidate's
    # delta to timer noise; before giving up, retry the sweep with an 8x
    # wider gap, which raises the differential work an order of
    # magnitude above the noise floor.
    for gap_scale in (1, 8):
        hi = iters_lo + (iters_hi - iters_lo) * gap_scale
        for op_label, op in _candidate_ops(a):
            for method in methods:
                for ce in check_everys:
                    label = f"{op_label}method={method} check_every={ce}"
                    kwargs = {"method": method, "check_every": ce}
                    try:
                        t_lo, _ = time_fn(
                            lambda: solve(op, b, tol=0.0, maxiter=iters_lo,
                                          m=m, **kwargs),
                            warmup=1, repeats=repeats, reduce="median")
                        t_hi, res_hi = time_fn(
                            lambda: solve(op, b, tol=0.0, maxiter=hi,
                                          m=m, **kwargs),
                            warmup=1, repeats=repeats, reduce="median")
                        us = (t_hi - t_lo) / (hi - iters_lo) * 1e6
                    except Exception:
                        if _on_card(b):
                            raise
                        table[label] = float("nan")
                        continue
                    if (getattr(res_hi, "iterations", None) is not None
                            and int(res_hi.iterations) != hi):
                        # The solve exited before maxiter (exact-zero
                        # residual or breakdown freeze): the delta then
                        # underestimates the true per-iteration cost, so
                        # discard rather than let it win the sweep.
                        table[label] = float("nan")
                        continue
                    if us <= 0.0:
                        # Timer noise swamped the iteration delta; a zero
                        # (or negative) marginal cost would wrongly win
                        # the sweep.  Discard the sample, don't clamp it.
                        table[label] = float("nan")
                        continue
                    table[label] = us
                    if best is None or us < best[0]:
                        # keep only the incumbent so losing operator
                        # variants are freed as the sweep moves on
                        best = (us, dict(kwargs), op if op_label else None)
        if best is not None:
            break

    if best is None:
        raise RuntimeError("autotune: every candidate configuration failed "
                           "or measured a non-positive iteration delta "
                           "(twice, the second sweep with an 8x wider "
                           "iteration gap)")
    us, kwargs, win_op = best
    return TuneResult(best=kwargs, us_per_iter=us, table=table,
                      operator=win_op)


def solve_tuned(a, b, *, m=None, tune_kwargs=None, **solve_kwargs):
    """Autotune, then solve with the winning configuration.

    The measured sweep costs ~(2 * candidates * repeats) short solves -
    worth it for long or repeated solves, not for one-shot small systems.
    """
    from ..solver.cg import solve

    cfg = autotune(a, b, m=m, **(tune_kwargs or {}))
    op = cfg.operator if cfg.operator is not None else a
    return solve(op, b, m=m, **cfg.best, **solve_kwargs), cfg
