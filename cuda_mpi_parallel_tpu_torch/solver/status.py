"""Typed solver statuses.

The reference has no notion of solver status: it prints "Success"
(``CUDACG.cu:365``) whether CG converged or silently hit maxit, and divides
by p.Ap with no breakdown check (``:311``, SURVEY quirks Q4/Q7).  The
framework surfaces these as a typed status carried through the solve as a
0-d device tensor (an IntEnum value, so the code is an int32 on the card
until the caller reads it).  The codes are those of the JAX package's
``solver/status.py``.
"""
from __future__ import annotations

import enum


class CGStatus(enum.IntEnum):
    """Outcome of a CG solve (device-scalar friendly int codes).

    Codes 0-2 are produced ON DEVICE by the solvers.  Codes 3-4 are
    HOST-SIDE refinements of MAXITER produced by the flight-recorder
    health diagnostics (``telemetry.health.classify_trace``): the
    solver cannot distinguish "budget too small" from "stalled" or
    "moving away" without the recorded trace, and the refinement must
    never perturb the compiled loop - so it lives off-device.
    """

    CONVERGED = 0     # ||r|| dropped below the tolerance
    MAXITER = 1       # iteration budget exhausted (reference: silent "Success")
    BREAKDOWN = 2     # non-finite recurrence scalar (e.g. p.Ap == 0 division)
    STAGNATED = 3     # trace verdict: residual decay flatlined above tol
    DIVERGED = 4      # trace verdict: residual grew away from its minimum

    def describe(self) -> str:
        return {
            CGStatus.CONVERGED: "converged",
            CGStatus.MAXITER: "maximum iterations reached without convergence",
            CGStatus.BREAKDOWN: (
                "numerical breakdown: a non-finite recurrence scalar "
                "(NaN/Inf in ||r||^2 or p.Ap - corrupted input data, "
                "a poisoned halo payload, or overflow) or a non-SPD "
                "preconditioner (r.Mr <= 0 with r != 0).  This is the "
                "PROBLEM's fault, not the engine's: the solve exited "
                "typed within one check_every block of the poisoned "
                "step (result.iterations names it); see the "
                "solve_fault event, and robust.solve_with_recovery "
                "for bounded restart"),
            CGStatus.STAGNATED: (
                "stagnated: residual decay flatlined above the "
                "tolerance (attainable-accuracy floor or lost "
                "orthogonality; see the solve_health event)"),
            CGStatus.DIVERGED: (
                "diverged: residual grew away from its recorded "
                "minimum (indefinite operator or preconditioner)"),
        }[self]
