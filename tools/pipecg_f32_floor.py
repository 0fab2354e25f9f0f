"""How deep f32 pipelined CG gets on 3D Poisson, in the JAX package.

    JAX_PLATFORMS=cpu python tools/pipecg_f32_floor.py [n ...]

For each grid n^3 (default 64 and 128) solves 3D Poisson in float32
with b = A x_true (x_true standard normal, numpy seed 0) to rtol 1e-6,
maxiter 4000, with ``method="cg"``, ``"cg1"`` and ``"pipecg"`` through
``cuda_mpi_parallel_tpu.solve``, and prints one JSON line per solve:
the iterations, the status and the float64 true relative residual
||b - A x|| / ||b||.  pipecg's residual replacement every 16 iterations
bounds the drift of its recurrence residual, but not below what rtol
1e-6 needs at 128^3: the reference finding that ``chip_smoke.py``'s
``general_pipecg_256`` phase reports.  Runs on the CPU in about a
minute.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from cuda_mpi_parallel_tpu import solve  # noqa: E402
from cuda_mpi_parallel_tpu.models import poisson  # noqa: E402


def main(sizes) -> None:
    for n in sizes:
        op = poisson.poisson_3d_operator(n, n, n, dtype=jnp.float32)
        op64 = poisson.poisson_3d_operator(n, n, n, dtype=jnp.float64)
        x_true = np.random.default_rng(0).standard_normal(n ** 3)
        b = op @ jnp.asarray(x_true, jnp.float32)
        b64 = jnp.asarray(b, jnp.float64)
        for method in ("cg", "cg1", "pipecg"):
            res = solve(op, b, tol=0.0, rtol=1e-6, maxiter=4000,
                        method=method)
            x64 = jnp.asarray(res.x, jnp.float64)
            true_rel = float(jnp.linalg.norm(b64 - op64 @ x64)
                             / jnp.linalg.norm(b64))
            print(json.dumps({"n": n, "method": method,
                              "iterations": int(res.iterations),
                              "status": res.status_enum().name,
                              "true_rel_residual_f64": true_rel}),
                  flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64, 128])
