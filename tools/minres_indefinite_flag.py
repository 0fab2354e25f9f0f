"""When MINRES's ``indefinite`` flag rises, in the JAX package.

    JAX_PLATFORMS=cpu python tools/minres_indefinite_flag.py [n ...]

The flag records a negative Rayleigh quotient ``v . A v`` of a Lanczos
vector (``solver/minres.py``: ``alfa < 0``).  For each grid n x n
(default 64 and 128) this builds 2D Poisson minus sigma I, sigma the
midpoint of the two smallest distinct Dirichlet eigenvalues (one
negative eigenvalue, of magnitude (lambda_12 - lambda_11) / 2 beside a
largest of about 8) - the system ``chip_smoke.py``'s
``minres_indefinite_1024`` phase solves at n = 1024 - and, for contrast,
the same matrix minus sigma = 1 (a sizable negative part), with b =
A x_true (x_true standard normal, numpy seed 0).  It solves each with
the JAX package's ``solve(method="minres")`` in float32 to rtol 1e-5
and float64 to rtol 1e-10, and ``cg_df64(method="minres")`` to rtol
1e-10, and prints one JSON line per solve: the iterations, the status,
the flag, the float64 true relative residual, and the Rayleigh
quotients of the two lowest modes (the certificate that exactly one
eigenvalue is negative).  Runs on the CPU in about a minute.
"""
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from cuda_mpi_parallel_tpu import CSRMatrix, cg_df64, solve  # noqa: E402
from cuda_mpi_parallel_tpu.models import poisson  # noqa: E402


def eig(i: int, j: int, n: int) -> float:
    h = math.pi / (2 * (n + 1))
    return 4 * math.sin(i * h) ** 2 + 4 * math.sin(j * h) ** 2


def shifted(a, sigma: float, dtype) -> CSRMatrix:
    data = np.asarray(a.data, np.float64).copy()
    data[np.asarray(a.indices) == np.asarray(a.rows)] -= sigma
    return CSRMatrix.from_arrays(data.astype(dtype), np.asarray(a.indices),
                                 np.asarray(a.indptr), a.shape)


def mode(n: int, j: int) -> np.ndarray:
    t = np.arange(1, n + 1) * math.pi / (n + 1)
    u = np.outer(np.sin(t), np.sin(j * t)).ravel()
    return u / np.linalg.norm(u)


def main(sizes) -> None:
    for n in sizes:
        a = poisson.poisson_2d_csr(n, n, dtype=np.float64)
        midpoint = 0.5 * (eig(1, 1, n) + eig(1, 2, n))
        for label, sigma in (("midpoint", midpoint), ("one", 1.0)):
            a64 = shifted(a, sigma, np.float64)
            dense = np.asarray(a64.to_dense())
            q = [float(mode(n, j) @ dense @ mode(n, j)) for j in (1, 2)]
            x_true = np.random.default_rng(0).standard_normal(n * n)
            b64 = dense @ x_true
            runs = (
                ("solve_f32", lambda: solve(
                    shifted(a, sigma, np.float32),
                    jnp.asarray(b64, jnp.float32), method="minres", tol=0.0,
                    rtol=1e-5, maxiter=20000, check_every=32)),
                ("solve_f64", lambda: solve(
                    a64, jnp.asarray(b64), method="minres", tol=0.0,
                    rtol=1e-10, maxiter=20000, check_every=32)),
                ("cg_df64", lambda: cg_df64(
                    a64, b64, method="minres", tol=0.0, rtol=1e-10,
                    maxiter=20000, check_every=32)))
            for name, run in runs:
                res = run()
                x = res.x() if name == "cg_df64" \
                    else np.asarray(res.x, np.float64)
                true_rel = float(np.linalg.norm(b64 - dense @ x)
                                 / np.linalg.norm(b64))
                print(json.dumps({
                    "n": n, "shift": label, "sigma": sigma, "solver": name,
                    "iterations": int(res.iterations),
                    "status": res.status_enum().name,
                    "indefinite": bool(res.indefinite),
                    "true_rel_residual_f64": true_rel,
                    "rayleigh_mode_11": q[0], "rayleigh_mode_12": q[1]}),
                    flush=True)


if __name__ == "__main__":
    main([int(v) for v in sys.argv[1:]] or [64, 128])
