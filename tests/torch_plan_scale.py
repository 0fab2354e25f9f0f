"""The partition planner at config #2's scale (1,048,576 rows), the JAX
package and the port side by side on the CPU: the plans each returns,
host numpy, for the same numpy systems.

* ``balanced``: config #2's CSR (1024^2 Poisson, f32) at P = 4.
* ``banded``: the banded skew system (``models.skewed.
  banded_skew_coo(1024, 24)``, the ``plan_scope`` phase's of
  ``chip_smoke.py``).
* ``block``: config #2's CSR with its first 2,048 rows a dense SPD block
  (``dense_block_poisson_coo(1024, 2048)``): its even split's nnz
  max/mean, and how far the planner's row cap lets a plan cut it.
* ``fixture``: ``tests/fixtures/skewed_spd_240.mtx`` at P = 4 under
  each default, the JAX RCM through its native library as well
  (``jax_native_default``: its order differs from scipy's).

For each, ``plan_partition(exchange=...)`` under ONE explicit machine
model given to both planners, and under each package's default (the
port's H100 table, the JAX package's TPU table); the JAX RCM through its
scipy fallback (the port's) unless named.  Run from the repository
root, one JSON line a case::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_plan_scale.py
"""
import argparse
import json
import time

import numpy as np

import cuda_mpi_parallel_tpu.native.bindings as jnative
from cuda_mpi_parallel_tpu.balance import plan_partition as jplan
from cuda_mpi_parallel_tpu.models.operators import CSRMatrix as JCSR
from cuda_mpi_parallel_tpu.telemetry.roofline import MachineModel as JModel
from cuda_mpi_parallel_tpu_torch.balance import plan_partition
from cuda_mpi_parallel_tpu_torch.models.operators import CSRMatrix
from cuda_mpi_parallel_tpu_torch.models.skewed import (
    PLANNING_MODEL,
    banded_skew_coo,
    dense_block_poisson_coo,
)
from cuda_mpi_parallel_tpu_torch.telemetry.roofline import MachineModel


def poisson_coo(nx):
    return dense_block_poisson_coo(nx, 0)


def digest(plan, seconds):
    base = plan.baseline_imbalance["nnz_max_over_mean"]
    got = plan.report.imbalance()["nnz_max_over_mean"]
    return dict(label=plan.label, fingerprint=plan.fingerprint(),
                score=plan.score, scored_by=plan.scored_by,
                trivial=plan.is_trivial(), even_nnz_max_over_mean=base,
                nnz_max_over_mean=got, cut=base / got,
                row_ranges=[list(r) for r in plan.row_ranges],
                seconds=seconds)


def case(name, coo, p):
    r, c, v, n = coo
    v = v.astype(np.float32)
    ours_a = CSRMatrix.from_coo(r, c, v, n, dtype=np.float32, device="cpu")
    jax_a = JCSR.from_coo(r, c, v, n, dtype=np.float32)
    for exchange in ("auto", "ring"):
        row = dict(case=name, rows=n, nnz=int(ours_a.nnz), shards=p,
                   exchange=exchange)
        for label, fn, a, model in (
                ("port_shared", plan_partition, ours_a,
                 MachineModel(**PLANNING_MODEL)),
                ("jax_shared", jplan, jax_a, JModel(**PLANNING_MODEL)),
                ("port_default", plan_partition, ours_a, None),
                ("jax_default", jplan, jax_a, None)):
            t0 = time.perf_counter()
            plan = fn(a, p, exchange=exchange, model=model)
            row[label] = digest(plan, time.perf_counter() - t0)
        row["shared_equal"] = (
            row["port_shared"]["fingerprint"]
            == row["jax_shared"]["fingerprint"]
            and abs(row["port_shared"]["score"] - row["jax_shared"]["score"])
            <= 1e-12 * abs(row["jax_shared"]["score"]))
        print(json.dumps(row), flush=True)


def fixture_case(p):
    from cuda_mpi_parallel_tpu.models import mmio as jmmio
    from cuda_mpi_parallel_tpu_torch.models import mmio

    path = "tests/fixtures/skewed_spd_240.mtx"
    ours, theirs = mmio.load_matrix_market(path, device="cpu"), \
        jmmio.load_matrix_market(path)
    row = dict(case="fixture", rows=240, shards=p, exchange="auto")
    native = jnative.available
    for label, fn, a in (("port_default", plan_partition, ours),
                         ("jax_default", jplan, theirs),
                         ("jax_native_default", jplan, theirs)):
        jnative.available = native if label == "jax_native_default" \
            else (lambda: False)
        t0 = time.perf_counter()
        row[label] = digest(fn(a, p), time.perf_counter() - t0)
    jnative.available = lambda: False
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    fixture_case(args.shards)
    jnative.available = lambda: False      # the scipy RCM in both
    case("balanced", poisson_coo(args.grid), args.shards)
    case("banded", banded_skew_coo(args.grid, 24), args.shards)
    case("block", dense_block_poisson_coo(args.grid, 2 * args.grid),
         args.shards)


if __name__ == "__main__":
    main()
