"""The rank bodies of the gloo tests: two ranks in
``test_torch_dist.py`` (the f32 stencil and gather-CSR lanes),
``test_torch_dist_df64.py`` (the f64 slab lanes) and
``test_torch_dist_shiftell.py`` (the ring shift-ELL lanes) and
``test_torch_elastic.py`` (a preempted and resumed resumable solve),
four on a (2, 2) pencil mesh in ``test_torch_multihost.py``.

Kept apart from the test modules, which import JAX: each spawned rank
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


def ring_problems():
    """``(lane, a, b, kw)`` of the ring shift-ELL solves: 2D Poisson
    15 x 17 as CSR (255 rows: a padding row at two ranks), b = A x in
    float64 (x from seed 2); the f32 lane on B8's twin, the f64 lane on
    B9's."""
    from cuda_mpi_parallel_tpu_torch.models import poisson

    a = poisson.poisson_2d_csr(15, 17, dtype=torch.float32, device="cpu")
    a64 = poisson.poisson_2d_csr(15, 17, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(2).standard_normal(a.n)
    b = (a64 @ torch.as_tensor(x)).numpy()
    return [("ring-shiftell", a, torch.as_tensor(b, dtype=torch.float32),
             dict(tol=0.0, rtol=1e-5, method="cg1",
                  preconditioner="chebyshev")),
            ("df64", a64, b, dict(tol=0.0, rtol=1e-9, method="pipecg",
                                  preconditioner="jacobi"))]


PROBLEMS = {"slabs": problems, "ring-shiftell": ring_problems}


def solve(lane, a, b, mesh, kw):
    if lane == "ring-shiftell":
        return tpar.solve_distributed(a, b, mesh=mesh,
                                      csr_comm="ring-shiftell", **kw)
    fn = (tpar.solve_distributed_df64 if lane == "df64"
          else tpar.solve_distributed_streaming_df64)
    return fn(a, b, mesh=mesh, **kw)


def solution(res):
    """The solve's global x: float64 in the f64 lanes, else ``x``."""
    return res.x64 if hasattr(res, "x64") else res.x


def gloo_rank(rank, world, init, out, which="slabs"):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        m = tpar.make_mesh()
        got = []
        for lane, a, b, kw in PROBLEMS[which]():
            m.comm.counts.clear()
            res = solve(lane, a, b, m, kw)
            got.append(dict(x=solution(res), iterations=int(res.iterations),
                            counts=dict(m.comm.counts)))
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def pencil_problems():
    """``(lane, a, b, kw)`` of the pencil solves on a (2, 2) mesh: 3D
    Poisson 8 x 8 x 8, b = A x in float64 (x from seed 3); the f32 lane
    with MG and with Chebyshev under pipecg, the f64 lane with cg1 +
    Jacobi and with MG."""
    a = pt.Stencil3D.create(8, 8, 8, device="cpu")
    a64 = pt.Stencil3D.create(8, 8, 8, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(3).standard_normal(a.n)
    b = (a64 @ torch.as_tensor(x)).numpy()
    b32 = torch.as_tensor(b, dtype=torch.float32)
    return [("f32", a, b32, dict(tol=0.0, rtol=1e-5, preconditioner="mg")),
            ("f32", a, b32, dict(tol=0.0, rtol=1e-5, method="pipecg",
                                 preconditioner="chebyshev")),
            ("df64", a, b, dict(tol=0.0, rtol=1e-9, method="cg1",
                                preconditioner="jacobi")),
            ("df64", a, b, dict(tol=0.0, rtol=1e-9, preconditioner="mg"))]


def solve_pencil(lane, a, b, mesh, kw):
    fn = (tpar.solve_distributed_df64 if lane == "df64"
          else tpar.solve_distributed)
    return fn(a, b, mesh=mesh, **kw)


def pencil_rank(rank, world, init, out):
    """A rank of the (2, 2) pencil mesh: the pencil solves, and its slice
    of ``arange(64)`` through ``multihost.shard_vector_global``."""
    from cuda_mpi_parallel_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(init, world, rank, device="cpu")
    try:
        m = tpar.make_mesh_2d((2, 2))
        got = []
        for lane, a, b, kw in pencil_problems():
            m.comm.counts.clear()
            res = solve_pencil(lane, a, b, m, kw)
            got.append(dict(x=solution(res), iterations=int(res.iterations),
                            counts=dict(m.comm.counts)))
        v = torch.arange(64, dtype=torch.float64)
        per = 64 // world
        mine = multihost.shard_vector_global(v[rank * per:(rank + 1) * per],
                                             64, multihost.global_mesh())
        torch.save(dict(solves=got, shard=mine,
                        info=multihost.process_info()), f"{out}.{rank}")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def slab_problems(lane):
    """The f32 solves of ``test_torch_dist.py``'s gloo test: 3D Poisson
    8 x 8 x 128 with cg1 + Jacobi and with MG, whose gather level has
    each rank slice its block of the replicated correction at its rank
    (``lane="stencil"``), or 2D Poisson 16 x 32 as CSR on the gather
    schedule; b from seed 12."""
    from cuda_mpi_parallel_tpu_torch.models import poisson

    if lane == "stencil":
        a = pt.Stencil3D.create(8, 8, 128, device="cpu")
        kws = [dict(tol=0.0, rtol=1e-5, method="cg1",
                    preconditioner="jacobi"),
               dict(tol=0.0, rtol=1e-5, preconditioner="mg")]
    else:
        a = poisson.poisson_2d_csr(16, 32, dtype=torch.float32,
                                   device="cpu")
        kws = [dict(tol=0.0, rtol=1e-5, exchange="gather")]
    b = torch.as_tensor(np.random.default_rng(12).standard_normal(
        a.shape[0]).astype(np.float32))
    return [(a, b, kw) for kw in kws]


def slab_rank(rank, world, init, out, lane):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        m = tpar.make_mesh()
        assert m.comm.kind == "distributed" and m.size == world
        got = []
        for a, b, kw in slab_problems(lane):
            m.comm.counts.clear()
            res = tpar.solve_distributed(a, b, mesh=m, **kw)
            got.append(dict(x=res.x, iterations=int(res.iterations),
                            counts=dict(m.comm.counts)))
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def resumable_problem(fixture):
    """The JAX elastic tests' problem: the skewed SPD fixture (240 rows)
    and b from seed 0."""
    from cuda_mpi_parallel_tpu_torch.models import mmio

    a = mmio.load_matrix_market(fixture, device="cpu")
    return a, np.random.default_rng(0).standard_normal(240)


def resumable_rank(rank, world, init, out, fixture, path):
    """A rank of a resumable distributed solve: preempted after one
    segment, then resumed from the file rank 0 wrote."""
    import os

    import torch.distributed as dist
    from cuda_mpi_parallel_tpu_torch.robust import (
        PreemptedError,
        Preemption,
    )
    from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        a, b = resumable_problem(fixture)
        m = tpar.make_mesh()
        kw = dict(mesh=m, segment_iters=20, tol=1e-8, maxiter=500,
                  keep_last=2)
        try:
            ck.solve_resumable_distributed(a, b, path,
                                           preempt=Preemption(2), **kw)
        except PreemptedError:
            pass
        saved = dict(np.load(path))
        prev = os.path.exists(path + ".prev1")
        res = ck.solve_resumable_distributed(a, b, path, **kw)
        torch.save(dict(x=res.x, iterations=int(res.iterations),
                        k=int(saved["k"]), prev=prev,
                        left=os.path.exists(path)), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()
