"""The rank body of ``test_torch_dist_df64.py``'s two-rank gloo test.

Kept apart from the test module, which imports JAX: each spawned rank
imports this module, and so only torch and the port."""
import numpy as np
import torch

import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar


def problems():
    """``(lane, a, b, kw)`` of each solve: 2D Poisson 16 x 16, b = A x
    in float64 (x from seed 1)."""
    a = pt.Stencil2D.create(16, 16, device="cpu")
    a64 = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(1).standard_normal(a.n)
    b = (a64 @ torch.as_tensor(x)).numpy()
    kw = dict(tol=0.0, rtol=1e-9)
    return [("df64", a, b, dict(kw, method="cg1", preconditioner="jacobi")),
            ("df64", a, b, dict(kw, preconditioner="mg")),
            ("df64", a, b, dict(kw, method="minres")),
            ("streaming", a, b, kw)]


def solve(lane, a, b, mesh, kw):
    fn = (tpar.solve_distributed_df64 if lane == "df64"
          else tpar.solve_distributed_streaming_df64)
    return fn(a, b, mesh=mesh, **kw)


def gloo_rank(rank, world, init, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        m = tpar.make_mesh()
        got = []
        for lane, a, b, kw in problems():
            m.comm.counts.clear()
            res = solve(lane, a, b, m, kw)
            got.append(dict(x=res.x64, iterations=int(res.iterations),
                            counts=dict(m.comm.counts)))
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()
