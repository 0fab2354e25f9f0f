"""Solve-health diagnostics on top of the flight record.

The port's copy of the JAX package's ``telemetry/health.py``: numpy and
scipy on the host, over a record fetched once after the solve, so the
two packages give the same verdict on the same record.

The reference prints "Success" whether CG converged or silently hit
maxit (``CUDACG.cu:365``, SURVEY Q4/Q7); this module is the layer that
turns "the solve returned MAXITER" into "the solve stagnated at
iteration 412 with kappa ~ 3e6, residual decay flatlined at 1e-9".

Two independent diagnostics, both computed HOST-SIDE from the
once-fetched :class:`~.flight.FlightRecord` (the compiled solve is
never touched):

* **Spectral estimate** (:func:`estimate_condition`): CG is Lanczos in
  disguise - the recurrence scalars define the Lanczos tridiagonal

      T[j, j]     = 1/alpha_j + beta_{j-1}/alpha_{j-1}
      T[j, j + 1] = sqrt(beta_j) / alpha_j

  whose extreme eigenvalues (Ritz values) converge to A's extreme
  eigenvalues (Golub & Van Loan SS10.2; the standard CG condition
  estimator).  The recorder's alpha/beta columns at stride 1 are
  exactly these scalars, so kappa ~ lmax/lmin comes free with the
  trace.  Needs a consecutive (stride-1) run of rows; decimated or
  resident-kernel records (NaN alpha/beta) skip the estimate and
  return ``None``.
* **Trace classification** (:func:`classify_trace`): the residual
  column distinguishes a solve that was still converging when the
  budget ran out (MAXITER), one whose decay flatlined above tolerance
  (STAGNATED - f32 attainable-accuracy floors, loss of orthogonality),
  and one whose residual grew away from its minimum (DIVERGED -
  indefinite operator/preconditioner).  The new ``CGStatus`` codes
  carry ``describe()`` text like the solver-produced ones.

The verdict flows out through the observability stack: a
``solve_health`` event (``EVENT_SCHEMA``), a residual-decay-rate gauge
and a kappa-estimate gauge in the metrics registry
(:func:`emit_solve_health`), and the per-solve iteration histogram
observed by ``session.observe_solve``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..solver.status import CGStatus
from .flight import FlightRecord

__all__ = [
    "SolveHealth",
    "assess_lanes",
    "assess_solve_health",
    "classify_trace",
    "emit_solve_health",
    "estimate_condition",
    "lanczos_tridiagonal",
    "ritz_values",
]

#: |d log10 ||r|| / d iteration| below which a tail is "flatlined":
#: less than one decade per 1000 iterations is indistinguishable from
#: a rounding-noise floor for every solver configuration in this repo
#: (the slowest healthy tail measured - unpreconditioned 256^3 f32 -
#: decays ~1 decade per ~150 iterations).
STAGNATION_RATE = 1e-3

#: Residual growth factor over the recorded minimum that reads as
#: divergence rather than plateau noise.
DIVERGENCE_FACTOR = 10.0

#: Rows of the spectral window: the tridiagonal eigenproblem is dense
#: O(w^2) memory / O(w^3) time on the fallback path; 512 rows resolve
#: the extreme Ritz values to percent level long before this cap.
SPECTRAL_WINDOW = 512


@dataclasses.dataclass(frozen=True)
class SolveHealth:
    """One solve's health verdict (JSON-ready via :meth:`to_json`)."""

    classification: CGStatus
    converged: bool
    iterations: int
    decay_rate: Optional[float]        # log10 ||r|| per iteration, full
    tail_decay_rate: Optional[float]   # same, last window
    kappa_estimate: Optional[float]    # lmax/lmin Ritz ratio (stride 1)
    ritz_min: Optional[float]
    ritz_max: Optional[float]
    plateau_iteration: Optional[int]   # where the trace flatlined
    residual_min: Optional[float]
    residual_last: Optional[float]
    message: str

    def describe(self) -> str:
        return self.message

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["classification"] = self.classification.name
        return out


def lanczos_tridiagonal(record: FlightRecord,
                        window: int = SPECTRAL_WINDOW):
    """``(diag, off, residual_iterations)`` - the exact principal
    submatrix of the CG-Lanczos tridiagonal over the record's trailing
    consecutive run, aligned to the RESIDUAL indices the Lanczos basis
    vectors carry.

    This is the Krylov-recycling harvest's half of the spectral story
    (``solver.recycle``): row ``i`` of the returned tridiagonal is the
    Rayleigh-quotient row of the normalized residual at iteration
    ``residual_iterations[i]``, so ``V_w^T A V_w`` for a basis-ring
    window ``V_w`` of those residuals is EXACTLY this matrix -
    eigenvectors of it are Ritz-vector coefficients, not just Ritz
    values.  Unlike :func:`ritz_values` (a diagnostic inner bound that
    tolerates a truncated first row), every entry here carries its full
    cross term, which is why the first recorded step of the run is
    consumed as a coefficient source but not given a row.

    Raises ``ValueError`` - loudly, never junk - when the record
    cannot support the reconstruction:

    * **stride-decimated records** (``record.stride != 1``): the
      tridiagonal couples CONSECUTIVE iterations; decimated alpha/beta
      rows would assemble a matrix whose eigenpairs belong to no
      operator.  Re-record with ``--flight-record 1`` / a stride-1
      ``FlightConfig`` (the stride-1 requirement is also stated in the
      README's "Krylov recycling" section).
    * records with fewer than 3 usable consecutive rows (nothing to
      window), or whose alpha/beta columns are NaN (resident block
      traces record no recurrence scalars).
    """
    if record.stride != 1:
        raise ValueError(
            f"Lanczos/Ritz harvesting needs a stride-1 flight record "
            f"(consecutive alpha/beta rows assemble the tridiagonal); "
            f"this record is stride-{record.stride} decimated and "
            f"would silently produce junk Ritz values. Re-record at "
            f"stride 1 (--flight-record 1 / FlightConfig(stride=1)).")
    if len(record) < 3:
        raise ValueError(
            f"Lanczos/Ritz harvesting needs >= 3 recorded iterations, "
            f"got {len(record)} (solve too short, or the ring was "
            f"overwritten)")
    its = record.iterations
    breaks = np.nonzero(np.diff(its) != 1)[0]
    start = int(breaks[-1]) + 1 if breaks.size else 0
    its = its[start:]
    alphas = record.alphas[start:]
    betas = record.betas[start:]
    ok = np.isfinite(alphas) & np.isfinite(betas)
    its, alphas, betas = its[ok], alphas[ok], betas[ok]
    bad = np.nonzero((alphas <= 0.0) | (betas < 0.0))[0]
    if bad.size:
        its = its[:bad[0]]
        alphas, betas = alphas[:bad[0]], betas[:bad[0]]
    if alphas.shape[0] > window:
        its = its[-window:]
        alphas, betas = alphas[-window:], betas[-window:]
    m = alphas.shape[0]
    if m < 2:
        raise ValueError(
            "Lanczos/Ritz harvesting found < 2 usable consecutive "
            "alpha/beta rows (NaN columns - a resident block trace? - "
            "or non-SPD scalars truncated the run)")
    # row i describes the residual BEFORE the step recorded at its[i]:
    # alpha/beta recorded at iteration j are the textbook alpha_{j-1}/
    # beta_{j-1}, so residual index t = j - 1.  diag(t) = 1/alpha_t +
    # beta_{t-1}/alpha_{t-1}; the previous-step term for row 0 comes
    # from the run's FIRST recorded row (consumed, not given a row)
    # unless the run starts at the solve's first step (t = 0, no
    # previous term exists).
    if int(its[0]) == 1:
        res_its = its - 1
        diag = 1.0 / alphas
        diag[1:] += betas[:-1] / alphas[:-1]
        off = np.sqrt(np.maximum(betas[:-1], 0.0)) / alphas[:-1]
    else:
        res_its = its[1:] - 1
        diag = 1.0 / alphas[1:] + betas[:-1] / alphas[:-1]
        off = np.sqrt(np.maximum(betas[1:-1], 0.0)) / alphas[1:-1]
    if diag.shape[0] < 2:
        raise ValueError(
            "Lanczos/Ritz harvesting found < 2 tridiagonal rows after "
            "aligning to residual indices (solve too short)")
    return diag, off, res_its.astype(np.int64)


def ritz_values(record: FlightRecord,
                window: int = SPECTRAL_WINDOW) -> Optional[np.ndarray]:
    """Eigenvalues of the CG-Lanczos tridiagonal reconstructed from the
    record's trailing consecutive stride-1 rows (up to ``window`` of
    them), or ``None`` when the record cannot support it (stride > 1,
    NaN alpha/beta columns, or < 2 usable rows before the first
    non-SPD scalar)."""
    if record.stride != 1 or len(record) < 3:
        return None
    its = record.iterations
    # trailing run of consecutive iterations (the ring keeps the last
    # capacity rows, so after a wrap the tail is still consecutive)
    breaks = np.nonzero(np.diff(its) != 1)[0]
    start = int(breaks[-1]) + 1 if breaks.size else 0
    alphas = record.alphas[start:]
    betas = record.betas[start:]
    # the initial row (alpha NaN - no step ran) contributes nothing
    ok = np.isfinite(alphas) & np.isfinite(betas)
    alphas, betas = alphas[ok], betas[ok]
    # non-SPD scalars (alpha <= 0 / beta < 0) poison the recurrence from
    # that step on - pipecg in particular records a run of negative
    # alphas once it hits its rounding floor.  The rows BEFORE the first
    # such step still define a valid tridiagonal, so truncate there
    # rather than voiding the whole estimate.
    bad = np.nonzero((alphas <= 0.0) | (betas < 0.0))[0]
    if bad.size:
        alphas, betas = alphas[:bad[0]], betas[:bad[0]]
    if alphas.shape[0] > window:
        alphas, betas = alphas[-window:], betas[-window:]
    m = alphas.shape[0]
    if m < 2:
        return None
    diag = 1.0 / alphas
    diag[1:] += betas[:-1] / alphas[:-1]
    off = np.sqrt(betas[:-1]) / alphas[:-1]
    try:
        from scipy.linalg import eigh_tridiagonal

        return np.asarray(eigh_tridiagonal(diag, off,
                                           eigvals_only=True))
    except Exception:  # scipy absent/old: dense fallback, window-capped
        t = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
        return np.linalg.eigvalsh(t)


def estimate_condition(record: FlightRecord,
                       window: int = SPECTRAL_WINDOW):
    """``(lmin_est, lmax_est, kappa_est)`` from the Ritz values, or
    ``(None, None, None)`` when the record cannot support the
    reconstruction.  Ritz intervals are INNER bounds: lmax_est <= lmax
    and lmin_est >= lmin, so kappa_est is a lower bound that tightens
    as the recorded window grows."""
    ritz = ritz_values(record, window=window)
    if ritz is None or ritz.shape[0] == 0:
        return None, None, None
    lmin, lmax = float(ritz.min()), float(ritz.max())
    if lmin <= 0.0 or not np.isfinite(lmin) or not np.isfinite(lmax):
        return None, None, None
    return lmin, lmax, lmax / lmin


def classify_trace(record: FlightRecord, *, converged: bool,
                   status: Optional[int] = None):
    """``(classification, tail_decay_rate, plateau_iteration, message)``.

    Solver-reported outcomes win where they are specific (CONVERGED,
    BREAKDOWN); the trace refines the unspecific one (MAXITER) into
    still-converging / STAGNATED / DIVERGED.
    """
    res = record.residuals
    ok = np.isfinite(res) & (res > 0.0)
    tail_n = max(8, len(record) // 4)
    tail_rate = record.decay_rate(tail=tail_n)
    if converged:
        return CGStatus.CONVERGED, tail_rate, None, "converged"
    if status is not None and int(status) == int(CGStatus.BREAKDOWN):
        return (CGStatus.BREAKDOWN, tail_rate, None,
                CGStatus.BREAKDOWN.describe())
    if int(ok.sum()) < 3:
        return (CGStatus.MAXITER, tail_rate, None,
                "iteration budget exhausted (trace too short to "
                "classify)")
    its = record.iterations[ok]
    r = res[ok]
    i_min = int(np.argmin(r))
    r_min = float(r[i_min])
    plateau_it = int(its[i_min])
    if float(r[-1]) > DIVERGENCE_FACTOR * r_min:
        return (CGStatus.DIVERGED, tail_rate, plateau_it,
                f"residual grew {float(r[-1]) / r_min:.1f}x from its "
                f"minimum {r_min:.3e} at iteration {plateau_it}")
    if tail_rate is not None and abs(tail_rate) < STAGNATION_RATE:
        return (CGStatus.STAGNATED, tail_rate, plateau_it,
                f"residual decay flatlined near {r_min:.3e} after the "
                f"plateau at iteration {plateau_it}")
    return (CGStatus.MAXITER, tail_rate, None,
            "iteration budget exhausted while still converging "
            f"(tail decay {0.0 if tail_rate is None else tail_rate:.2e} "
            f"decades/iteration)")


def assess_solve_health(record: FlightRecord, *, converged: bool,
                        status: Optional[int] = None,
                        iterations: Optional[int] = None) -> SolveHealth:
    """The full verdict: classification + decay rates + spectral
    estimate, all from the once-fetched record."""
    classification, tail_rate, plateau_it, message = classify_trace(
        record, converged=converged, status=status)
    lmin, lmax, kappa = estimate_condition(record)
    res = record.residuals
    ok = np.isfinite(res) & (res > 0.0)
    r_min = float(res[ok].min()) if ok.any() else None
    r_last = float(res[-1]) if len(record) and np.isfinite(res[-1]) \
        else None
    if kappa is not None:
        message += f" (kappa >= {kappa:.3g} from {len(record)} records)"
    return SolveHealth(
        classification=classification,
        converged=bool(converged),
        iterations=(int(iterations) if iterations is not None
                    else (int(record.iterations[-1]) if len(record)
                          else 0)),
        decay_rate=record.decay_rate(),
        tail_decay_rate=tail_rate,
        kappa_estimate=kappa,
        ritz_min=lmin,
        ritz_max=lmax,
        plateau_iteration=plateau_it,
        residual_min=r_min,
        residual_last=r_last,
        message=message,
    )


def assess_lanes(records, *, converged, statuses, iterations):
    """Per-lane verdicts of a batched (many-RHS) solve.

    ``records`` are the per-lane :class:`~.flight.FlightRecord` views
    (``flight.lanes_from_buffer``); ``converged``/``statuses``/
    ``iterations`` are the per-lane arrays of a
    ``solver.many.CGBatchResult``.  Each lane is classified exactly
    like a single-RHS solve - a lane that flatlined above ITS tolerance
    reads STAGNATED even while its neighbors converged.
    """
    out = []
    for j, rec in enumerate(records):
        out.append(assess_solve_health(
            rec, converged=bool(np.asarray(converged)[j]),
            status=int(np.asarray(statuses)[j]),
            iterations=int(np.asarray(iterations)[j])))
    return out


def emit_solve_health(health: SolveHealth,
                      engine: str = "general") -> dict:
    """Route one verdict through the observability stack: the
    ``solve_health`` event (when a sink is active) plus the
    residual-decay-rate and kappa-estimate gauges.  Returns the event
    payload (also what a caller embeds in its JSON record)."""
    from . import events
    from .registry import REGISTRY

    payload = health.to_json()
    if health.decay_rate is not None:
        REGISTRY.gauge(
            "solve_residual_decay_rate",
            "log10 ||r|| decay per iteration of the most recent "
            "flight-recorded solve (negative = converging)",
            labelnames=("engine",)).set(health.decay_rate, engine=engine)
    if health.kappa_estimate is not None:
        REGISTRY.gauge(
            "solve_condition_estimate",
            "Ritz-value condition estimate (lower bound) of the most "
            "recent flight-recorded solve",
            labelnames=("engine",)).set(health.kappa_estimate,
                                        engine=engine)
    events.emit("solve_health", engine=engine, **payload)
    return payload
