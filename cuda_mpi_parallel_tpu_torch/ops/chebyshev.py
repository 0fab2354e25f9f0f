"""The scalars of the Chebyshev semi-iteration, computed in one place.

``ChebyshevPreconditioner.matvec``, the streaming engine's B5 launches
and the resident kernel's plain twin all run the same recurrence
(JAX ``models/precond.py:155-169``)::

    d = r / theta;  z = d
    for (c1, c2) in steps:  d = c1 d + c2 (r - A z);  z = z + d

This module gives them ``theta`` and each step's ``(c1, c2)``, in the
JAX operation order that ``csrc/resident.cu``'s ``cheb_apply`` rounds
alike, so no engine can drift from the others.  The f64 lane
(``solver.df64``) parameterises the interval by its centre and
half-width (``chebyshev_interval``'s ``theta``, ``delta``, JAX
``solver/df64.py:442``); :func:`chebyshev_coefficients` serves both.
"""
from __future__ import annotations


def chebyshev_steps(lmin, lmax, degree: int):
    """``(theta, [(c1, c2), ...])`` of the ``degree``-term Chebyshev
    polynomial on ``[lmin, lmax]``: the interval centre and the
    coefficients of its ``degree - 1`` steps, as 0-d tensors of
    ``lmin``'s dtype and device (or floats, given floats)."""
    theta = (lmax + lmin) / 2    # interval centre
    delta = (lmax - lmin) / 2    # interval half-width
    return theta, chebyshev_coefficients(theta, delta, degree)


def chebyshev_coefficients(theta, delta, degree: int):
    """Each step's ``(c1, c2)`` of the ``degree``-term Chebyshev
    semi-iteration on the interval of centre ``theta`` and half-width
    ``delta`` (``degree - 1`` steps), in the scalars' dtype."""
    sigma = theta / delta
    rho = 1.0 / sigma
    steps = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return steps
