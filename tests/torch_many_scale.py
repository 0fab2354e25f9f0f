"""Block CG and Krylov recycling at the larger grids the test files do
not reach: the JAX package and the port side by side on the CPU, the same
numpy inputs through both.

* ``block``: 2D Poisson ``n x n`` matrix-free f32, k = 8 columns of
  b = A X (X from ``--seed``), rtol 1e-6 - ``solve_many`` batched and
  block, each lane's count from each package.
* ``recycle``: 2D Poisson ``n x n`` as assembled f32 CSR, rtol 1e-6,
  ``recycled_sequence(repeats=3, k=8)`` on repeat traffic (the same b)
  and on fresh traffic (a new b each solve, ``rhs_for``): the counts and
  each harvest's kept Ritz values from each package, beside the
  operator's smallest eigenvalue ``8 sin^2(pi / (2 (n + 1)))``.

Run from the repository root, one JSON line a case::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_many_scale.py block --grid 512
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_many_scale.py recycle --grid 256
"""
import argparse
import json
import math
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.solver import recycle as jrec
from cuda_mpi_parallel_tpu.solver.many import solve_many as jsolve_many
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.solver import recycle as rec
from cuda_mpi_parallel_tpu_torch.solver import solve_many

KW = dict(tol=0.0, rtol=1e-6, maxiter=4000)


def block(n: int, k: int, seed: int) -> None:
    x = np.random.default_rng(seed).standard_normal((n * n, k)).astype(
        np.float32)
    jop = jpoisson.poisson_2d_operator(n, n)
    top = tpoisson.poisson_2d_operator(n, n, device="cpu")
    jb = jop.matmat(jnp.asarray(x))
    b = np.asarray(jb)
    for method in ("batched", "block"):
        t0 = time.perf_counter()
        jres = jsolve_many(jop, jb, method=method, **KW)
        jax.block_until_ready(jres.x)
        t_jax = time.perf_counter() - t0
        t0 = time.perf_counter()
        tres = solve_many(top, torch.as_tensor(b), method=method, **KW)
        t_port = time.perf_counter() - t0
        print(json.dumps(dict(
            case="block", grid=[n, n], k=k, seed=seed, method=method,
            jax_iterations=np.asarray(jres.iterations).tolist(),
            port_iterations=tres.iterations.tolist(),
            jax_converged=bool(np.all(np.asarray(jres.converged))),
            port_converged=bool(tres.converged.all()),
            jax_cpu_seconds=t_jax, port_cpu_seconds=t_port)), flush=True)


def recycle(n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((3, n * n))
    ja = jpoisson.poisson_2d_csr(n, n, dtype=np.float32)
    ta = tpoisson.poisson_2d_csr(n, n, dtype=torch.float32, device="cpu")
    a64 = tpoisson.poisson_2d_csr(n, n, dtype=torch.float64, device="cpu")
    bs = [(a64 @ torch.as_tensor(v)).float().numpy() for v in xs]
    lam_min = 8.0 * math.sin(math.pi / (2 * (n + 1))) ** 2
    for traffic in ("repeat", "fresh"):
        rhs_for = None if traffic == "repeat" else (lambda i: bs[i])
        jseq = jrec.recycled_sequence(
            ja, jnp.asarray(bs[0]), repeats=3, k=8,
            rhs_for=None if rhs_for is None
            else (lambda i: jnp.asarray(bs[i])), **KW)
        tseq = rec.recycled_sequence(
            ta, torch.as_tensor(bs[0]), repeats=3, k=8,
            rhs_for=None if rhs_for is None
            else (lambda i: torch.as_tensor(bs[i])), **KW)

        def ritz(seq):
            return [[float(v) for v in e.info.ritz] if e.info else None
                    for e in seq.entries]

        print(json.dumps(dict(
            case="recycle", grid=[n, n], seed=seed, traffic=traffic,
            lambda_min=lam_min,
            jax_iterations=jseq.iterations(),
            port_iterations=tseq.iterations(),
            jax_ritz=ritz(jseq), port_ritz=ritz(tseq))), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("case", choices=("block", "recycle"))
    p.add_argument("--grid", type=int, nargs="+", default=[256])
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    torch.set_num_threads(4)
    for n in args.grid:
        if args.case == "block":
            block(n, args.k, args.seed)
        else:
            recycle(n, args.seed)


if __name__ == "__main__":
    main()
