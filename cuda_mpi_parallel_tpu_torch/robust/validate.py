"""Loud pre-solve validation of problem data.

Counterpart of the JAX package's ``robust/validate.py``.  A NaN/Inf in
``b`` or the matrix values would spin the recurrence to its first health
check and surface as a BREAKDOWN - a correct but wasteful outcome for a
fault that was visible before the solve ever dispatched.  These checks
count the non-finite entries where the data lives: one ``isfinite``
reduction and one host read per array (a 1 M-row CSR on the card is
never copied to the host to be checked), run once per entry-point call:
``parallel.solve_distributed`` and ``robust.solve_with_recovery``
(opt-out via ``validate=False`` for callers that stage
intentionally-poisoned systems, e.g. the chaos tests themselves).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_finite_problem", "check_finite_rhs"]


def _count_nonfinite(arr) -> int:
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        host = np.asarray(arr)
        if not np.issubdtype(host.dtype, np.floating):
            return 0
        t = torch.as_tensor(host)
    if not t.dtype.is_floating_point:
        return 0
    return int(torch.count_nonzero(~torch.isfinite(t)))


def check_finite_rhs(b, *, what: str = "b") -> None:
    """Raise ``ValueError`` when the right-hand side carries any
    non-finite entry (one reduction where ``b`` lives, one read)."""
    bad = _count_nonfinite(b)
    if bad:
        raise ValueError(
            f"{what} carries {bad} non-finite entr"
            f"{'y' if bad == 1 else 'ies'} (NaN/Inf): the solve would "
            f"spin a poisoned recurrence to its first health check and "
            f"report BREAKDOWN. Fix the input, or pass validate=False "
            f"(--no-validate) to stage the fault deliberately.")


def check_finite_problem(a, b=None) -> None:
    """Validate the operator's coefficient arrays (and optionally the
    rhs).  Covers the assembled formats' value arrays and the stencil
    scale; matrix-free operators without coefficient arrays pass
    (there is nothing to check)."""
    if b is not None:
        check_finite_rhs(b)
    for name in ("data", "vals", "scale", "diag"):
        v = getattr(a, name, None)
        if v is None:
            continue
        leaves = v if isinstance(v, (tuple, list)) else (v,)
        for leaf in leaves:
            bad = _count_nonfinite(leaf)
            if bad:
                raise ValueError(
                    f"operator {type(a).__name__}.{name} carries {bad} "
                    f"non-finite entr{'y' if bad == 1 else 'ies'} "
                    f"(NaN/Inf): refusing to solve a poisoned system. "
                    f"Fix the matrix, or pass validate=False "
                    f"(--no-validate) to stage the fault deliberately.")
