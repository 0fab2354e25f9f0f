"""Structured logging for solves.

Counterpart of the JAX package's ``utils/logging.py``.  The reference's
entire observability story is ``printf`` of the solution vector plus
error strings in ``CLEANUP`` calls - no residual history, no iteration
count, no timing (``CUDACG.cu:361-365``, SURVEY quirk Q7).  Here every
solve can be summarized as a structured record, and convergence
histories print as compact traces.

A record is built from a result the caller has finished with: reading a
0-d CUDA tensor here is one host read, after the solve.
"""
from __future__ import annotations

import json
import logging
import math
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

LOGGER_NAME = "cuda_mpi_parallel_tpu"


def sanitize(obj: Any) -> Any:
    """Make ``obj`` strictly-JSON serializable: non-finite floats become
    ``null``, and numpy scalars and 0-d tensors become Python scalars.

    ``json.dumps`` happily emits the ``NaN``/``Infinity`` literals, which
    are NOT JSON - jq, browsers, BigQuery and every strict parser reject
    the record.  A BREAKDOWN solve carries a non-finite
    ``residual_norm`` by definition (quirk Q4), so solve records hit
    this in practice.  Recurses through dicts/lists/tuples; leaves other
    types alone.
    """
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, torch.Tensor) and obj.ndim == 0:
        obj = obj.item()                # 0-d tensor -> python scalar
    if isinstance(obj, np.generic):     # numpy scalar -> python scalar
        obj = obj.item()
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def get_logger(level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(level)
    return logger


def solve_record(result, elapsed_s: Optional[float] = None,
                 **extra: Any) -> Dict[str, Any]:
    """Flatten a CGResult into a JSON-serializable record."""
    rec: Dict[str, Any] = {
        "iterations": int(result.iterations),
        "residual_norm": float(result.residual_norm),
        "converged": bool(result.converged),
        "status": result.status_enum().name,
        "indefinite": bool(result.indefinite),
    }
    if elapsed_s is not None:
        rec["elapsed_s"] = elapsed_s
        iters = max(int(result.iterations), 1)
        rec["iters_per_sec"] = iters / elapsed_s
    rec.update(extra)
    return rec


def format_history(result, every: int = 1) -> str:
    """Compact residual trace (absent from the reference).

    NaN slots are skipped: the resident engine's trace is check-block
    granular (values only at block boundaries, NaN between - see
    ``cg_resident(record_history=True)``), and per-iteration traces have
    no NaNs below ``result.iterations`` so nothing is hidden there.
    """
    if result.residual_history is None:
        return "(history not recorded)"
    hist = result.residual_history
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    hist = np.asarray(hist)
    k = int(result.iterations)
    idx = list(range(0, k + 1, every))
    # Always include the final entry: when ``every`` does not divide k
    # the stride stops short of the converged residual.  For
    # block-granular traces (resident engine) the last finite slot <= k
    # stands in.
    last_finite = next((i for i in range(k, -1, -1)
                        if np.isfinite(hist[i])), None)
    if last_finite is not None and last_finite not in idx:
        idx.append(last_finite)
    lines = [f"  iter {i:5d}  ||r|| = {hist[i]:.6e}"
             for i in idx if np.isfinite(hist[i])]
    return "\n".join(lines)


def emit_json(record: Dict[str, Any], stream=None) -> None:
    stream = sys.stdout if stream is None else stream
    # allow_nan=False makes any future non-finite leak a loud error
    # instead of silently invalid JSON; sanitize() maps the legitimate
    # ones (BREAKDOWN residuals) to null first.
    stream.write(json.dumps(sanitize(record), allow_nan=False) + "\n")
    stream.flush()
