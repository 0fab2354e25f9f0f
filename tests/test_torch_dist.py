"""The port's distributed solve (``parallel``) against the JAX package's.

Inputs are numpy-seeded and handed to both packages.  The JAX side runs
on meshes of the 8 virtual CPU devices ``tests/conftest.py`` sets up;
the port's on a stacked mesh of P CPU shards (``make_mesh(P,
devices=["cpu"] * P)``), and twice on a 2-rank ``torch.distributed``
gloo process group, which must give the stacked mesh's bits.

Parity contract: the halo exchange and the partitions equal the JAX
package's exactly (pure data movement and host numpy); the solves take
the JAX iteration counts and statuses, with x within ``2e-5 * max|x|``
(each shard's partial dots sum in another order than XLA's, so iterates
differ by f32 reduction rounding - well above f32 rounding, far below a
wrong answer).  The Chebyshev lane carries the JAX spectral estimate
across (torch and XLA round ``sin`` of large arguments apart, and the
estimate's last digit moves a count at a borderline tolerance).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models.precond import estimate_lmax as jestimate
from cuda_mpi_parallel_tpu.utils.compat import shard_map as jshard_map
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist

tprecond = sys.modules["cuda_mpi_parallel_tpu_torch.models.precond"]

torch.set_num_threads(1)

GRID_2D = (16, 128)
GRID_3D = (8, 8, 128)
X_TOL = 2e-5


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def stencils(grid, backend="xla"):
    """The same global stencil in both packages (the port's on the CPU)."""
    if len(grid) == 2:
        return (jp.Stencil2D.create(*grid, backend=backend),
                pt.Stencil2D.create(*grid, backend=backend, device="cpu"))
    return (jp.Stencil3D.create(*grid, backend=backend),
            pt.Stencil3D.create(*grid, backend=backend, device="cpu"))


def csrs(nx=16, ny=32):
    ja = jpoisson.poisson_2d_csr(nx, ny, dtype=np.float32)
    ta = pt.CSRMatrix.from_arrays(np.asarray(ja.data), np.asarray(ja.indices),
                                  np.asarray(ja.indptr), ja.shape,
                                  device="cpu")
    return ja, ta


def assert_parity(res, jres, what=""):
    assert int(res.iterations) == int(jres.iterations), what
    assert int(res.status) == int(jres.status), what
    x, jx = res.x.numpy(), np.asarray(jres.x).reshape(-1)
    assert x.shape == jx.shape
    assert np.abs(x - jx).max() <= X_TOL * np.abs(jx).max(), what


# -- 1. mesh, scope and halo exchange -----------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_exchange_halo_matches_jax(n):
    u = vec(8 * n * 128, 1).reshape(8 * n, 128)
    f = jshard_map(lambda v: jpar.exchange_halo(v, "rows", n),
                   mesh=jpar.make_mesh(n), in_specs=(P("rows"),),
                   out_specs=(P("rows"), P("rows")))
    jlo, jhi = (np.asarray(v) for v in f(jnp.asarray(u)))
    m = mesh(n)
    with tcomm.bind(m):
        lo, hi = tpar.exchange_halo(torch.as_tensor(u).reshape(n, 8, 128),
                                    "rows", n)
    np.testing.assert_array_equal(lo.reshape(n, 128).numpy(), jlo)
    np.testing.assert_array_equal(hi.reshape(n, 128).numpy(), jhi)
    assert m.comm.counts["ppermute"] == (0 if n == 1 else 2)


def test_exchange_halo_axis_and_permutations():
    n = 4
    u = vec(n * 2 * 6 * 5, 2).reshape(n * 2, 6, 5)
    f = jshard_map(lambda v: jpar.exchange_halo_axis(v, "rows", n, 1),
                   mesh=jpar.make_mesh(n), in_specs=(P("rows"),),
                   out_specs=(P("rows"), P("rows")))
    jlo, jhi = (np.asarray(v) for v in f(jnp.asarray(u)))
    with tcomm.bind(mesh(n)):
        lo, hi = tpar.exchange_halo_axis(
            torch.as_tensor(u).reshape(n, 2, 6, 5), "rows", n, 1)
    np.testing.assert_array_equal(lo.reshape(n * 2, 1, 5).numpy(), jlo)
    np.testing.assert_array_equal(hi.reshape(n * 2, 1, 5).numpy(), jhi)
    assert tpar.neighbor_shift_perms(4) == jpar.neighbor_shift_perms(4)
    assert tpar.rotation_perm(5, 2) == jpar.rotation_perm(5, 2)
    for bad in ([(0, 1), (0, 2)], [(0, 1), (2, 1)]):
        with pytest.raises(ValueError, match="twice"):
            tpar.validate_permutation(bad)
    with pytest.raises(ValueError, match="outside"):
        tpar.validate_permutation([(0, 4)], n_shards=4)
    with pytest.raises(ValueError, match="shift"):
        tpar.rotation_perm(4, 0)


def test_mesh_and_scope_rules():
    m = mesh(4)
    assert m.size == 4 and m.axis_names == ("rows",) \
        and m.comm.kind == "stacked" and m.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="multi-card"):
        tpar.make_mesh(2, devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="pencil"):
        tpar.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="requested 5"):
        tpar.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()                       # devices=None: every card
    with pytest.raises(NameError, match="unbound axis name: rows"):
        pt.ops.blas1.dot(torch.ones(2), torch.ones(2), axis_name="rows")
    b = torch.arange(8.0)
    assert torch.equal(tpar.shard_vector(b, m), b)
    with pytest.raises(ValueError, match="divide"):
        tpar.shard_vector(torch.ones(6), m)
    with pytest.raises(ValueError, match="axis"):
        tpar.row_sharding(m, "cols")
    # the shard_map counterpart puts the comm in scope for its body
    run = tpar.shard_map(lambda x: pt.ops.blas1.dot(x, x, axis_name="rows"),
                         mesh=m, in_specs=P("rows"), out_specs=P())
    assert float(run(torch.ones(8))) == 8.0
    assert m.comm.counts["psum"] == 1


def test_stacked_collectives_are_the_jax_ones():
    m = mesh(4)
    v = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    with tcomm.bind(m):
        c = tcomm.resolve("rows")
        assert torch.equal(c.psum(v), v[0] + v[1] + v[2] + v[3])
        shifted = c.ppermute(v, [(0, 1), (1, 2)])
        assert torch.equal(shifted[1], v[0]) and torch.equal(shifted[2], v[1])
        assert not shifted[0].any() and not shifted[3].any()
        assert torch.equal(c.all_gather(v), v.reshape(-1))
    assert dict(m.comm.counts) == {"psum": 1, "ppermute": 1, "all_gather": 1}


# -- 2. the distributed operators ---------------------------------------------


@pytest.mark.parametrize("grid", [GRID_2D, GRID_3D])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dist_stencil_matvec_matches_global(grid, n, backend):
    _, top = stencils(grid)
    cls = tpar.DistStencil2D if len(grid) == 2 else tpar.DistStencil3D
    loc = cls.create(grid, n, scale=0.37, backend=backend, device="cpu")
    x = torch.as_tensor(vec(top.n, 3))
    want = pt.Stencil2D.create(*grid, scale=0.37, device="cpu") \
        if len(grid) == 2 else pt.Stencil3D.create(*grid, scale=0.37,
                                                   device="cpu")
    with tcomm.bind(mesh(n)):
        got = loc @ x
        assert loc.shape == (top.n, top.n)
        diag = loc.diagonal()
    if backend == "xla":       # the global formula, term for term
        assert torch.equal(got, want @ x)
    else:                      # slab stencil + the -scale * halo rows
        np.testing.assert_allclose(got.numpy(), (want @ x).numpy(),
                                   rtol=1e-6, atol=1e-5)
    assert torch.equal(diag, want.diagonal())


def test_dist_stencil_create_rules():
    with pytest.raises(ValueError, match="not divisible"):
        tpar.DistStencil2D.create((10, 128), 4, device="cpu")
    loc = tpar.DistStencil3D.create(GRID_3D, 4, backend="auto", device="cpu")
    assert loc.local_grid == (2, 8, 128) and loc.backend == "xla"
    assert loc.shape == (2 * 8 * 128,) * 2          # outside a scope: one
    with pytest.raises(NotImplementedError, match="pencil"):
        tpar.DistStencil3DPencil.create(GRID_3D, (2, 2))
    with pytest.raises(NotImplementedError, match="ring-shiftell"):
        tpar.DistShiftELLRing()
    with pytest.raises(NotImplementedError, match="ring-shiftell"):
        tpar.DistShiftELLDF64Ring()
    from cuda_mpi_parallel_tpu_torch.parallel import partition as tpart

    _, ta = csrs()
    for fn in (tpart.ring_partition_shiftell,
               tpart.ring_partition_shiftell_df64):
        with pytest.raises(NotImplementedError, match="ring-shiftell"):
            fn(ta, 2)


# -- 3. partitioning and the gather schedule ----------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("exchange", ["allgather", "gather", "auto"])
def test_partition_csr_matches_jax(n, exchange):
    ja, ta = csrs()
    jparts = jpar.partition_csr(ja, n, exchange=exchange)
    tparts = tpar.partition_csr(ta, n, exchange=exchange)
    for field in ("data", "cols", "local_rows"):
        np.testing.assert_array_equal(getattr(tparts, field),
                                      np.asarray(getattr(jparts, field)))
    for field in ("n_local", "n_global_padded", "n_global", "n_shards",
                  "row_ranges"):
        assert getattr(tparts, field) == getattr(jparts, field)
    assert (tparts.halo is None) == (jparts.halo is None)
    if jparts.halo is not None:
        assert tparts.halo.to_json() == jparts.halo.to_json()
        for tr, jr in zip(tparts.halo.rounds, jparts.halo.rounds):
            np.testing.assert_array_equal(tr.send_idx, jr.send_idx)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gather_schedule_and_ring_match_jax(n):
    ja, ta = csrs(12, 20)
    parts = tpar.partition_csr(ta, n)
    jparts = jpar.partition_csr(ja, n)
    sched, cols = tpar.build_gather_schedule(parts.data, parts.cols,
                                             parts.n_local, n)
    jsched, jcols = jpar.build_gather_schedule(jparts.data, jparts.cols,
                                               jparts.n_local, n)
    np.testing.assert_array_equal(cols, jcols)
    assert sched.to_json() == jsched.to_json()
    assert sched.perms() == jsched.perms()
    assert tpar.choose_exchange(sched, 4) == \
        jpar.exchange.choose_exchange(jsched, 4)
    assert tpar.accepts_gather(100, n, 64, 4) == \
        jpar.exchange.accepts_gather(100, n, 64, 4)
    ring, jring = tpar.ring_partition_csr(ta, n), \
        jpar.ring_partition_csr(ja, n)
    for field in ("data", "cols", "local_rows"):
        for t, j in zip(getattr(ring, field), getattr(jring, field)):
            np.testing.assert_array_equal(t, np.asarray(j))
    assert tpar.padded_size(10, 4) == 12
    np.testing.assert_array_equal(tpar.pad_vector(np.ones(3), 4),
                                  [1, 1, 1, 0])


@pytest.mark.parametrize("lane", ["allgather", "gather", "ring"])
def test_dist_csr_operators_match_global(lane):
    _, ta = csrs()
    n = 4
    parts = (tpar.ring_partition_csr(ta, n) if lane == "ring" else
             tpar.partition_csr(ta, n, exchange=lane))
    x = torch.as_tensor(vec(parts.n_global_padded, 4))
    x[parts.n_global:] = 0
    as_t = torch.as_tensor
    if lane == "ring":
        op = tpar.DistCSRRing(tuple(map(as_t, parts.data)),
                              tuple(map(as_t, parts.cols)),
                              tuple(map(as_t, parts.local_rows)),
                              parts.n_local, "rows", n)
    elif lane == "gather":
        op = tpar.DistCSRGather(
            as_t(parts.data), as_t(parts.cols), as_t(parts.local_rows),
            tuple(as_t(r.send_idx) for r in parts.halo.rounds),
            tuple(r.shift for r in parts.halo.rounds), parts.n_local,
            "rows", n)
    else:
        op = tpar.DistCSR(as_t(parts.data), as_t(parts.cols),
                          as_t(parts.local_rows), parts.n_local, "rows", n)
    with tcomm.bind(mesh(n)):
        y = op @ x
        diag = op.diagonal()
    want = ta @ x[:parts.n_global]
    np.testing.assert_allclose(y[:parts.n_global].numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(y[parts.n_global:], x[parts.n_global:])
    assert torch.equal(diag[:parts.n_global], ta.diagonal())


# -- 4. solve_distributed against the JAX package's ---------------------------


def _jax_lmax(jop, n, degree_grid):
    """The JAX package's in-mesh spectral estimate of ``jop`` over n
    shards (what its solve_distributed's Chebyshev lane computes)."""
    cls = jpar.DistStencil2D if len(degree_grid) == 2 else jpar.DistStencil3D
    loc = cls.create(degree_grid, n, scale=jop.scale)
    f = jshard_map(lambda v: jestimate(loc, axis_name="rows")[None],
                   mesh=jpar.make_mesh(n), in_specs=(P("rows"),),
                   out_specs=P("rows"), check_vma=False)
    return float(np.asarray(f(jnp.zeros(jop.n, jnp.float32)))[0])


def _carry_lmax(monkeypatch, value):
    monkeypatch.setattr(tprecond, "estimate_lmax",
                        lambda a, **kw: torch.tensor(value,
                                                     dtype=torch.float32))


STENCIL_CASES = (
    [(GRID_2D, 4, m, pc) for m in ("cg", "cg1", "pipecg")
     for pc in (None, "jacobi", "chebyshev")]
    + [(GRID_3D, 2, m, pc) for m in ("cg", "cg1", "pipecg")
       for pc in (None, "jacobi", "chebyshev")]
    + [(g, n, "cg", None) for g in (GRID_2D, GRID_3D) for n in (1, 8)])


@pytest.mark.parametrize("grid,n,method,pc", STENCIL_CASES)
def test_solve_distributed_stencil_matches_jax(monkeypatch, grid, n, method,
                                               pc):
    jop, top = stencils(grid)
    b = vec(top.n, 5)
    kw = dict(tol=0.0, rtol=1e-5, method=method, preconditioner=pc,
              maxiter=400)
    jres = jpar.solve_distributed(jop, jnp.asarray(b),
                                  mesh=jpar.make_mesh(n), **kw)
    if pc == "chebyshev":
        _carry_lmax(monkeypatch, _jax_lmax(jop, n, grid))
    m = mesh(n)
    res = tpar.solve_distributed(top, torch.as_tensor(b), mesh=m, **kw)
    assert_parity(res, jres, (grid, n, method, pc))
    if method != "cg" and pc is None:
        # one reduction per iteration, plus one at init
        assert m.comm.counts["psum"] == int(res.iterations) + 1


@pytest.mark.parametrize("n", [2, 4])
def test_solve_distributed_pallas_backend_matches_jax(n):
    jop, top = stencils(GRID_3D, backend="pallas")
    b = vec(top.n, 6)
    kw = dict(tol=0.0, rtol=1e-5)
    jres = jpar.solve_distributed(jop, jnp.asarray(b),
                                  mesh=jpar.make_mesh(n), **kw)
    res = tpar.solve_distributed(top, torch.as_tensor(b), mesh=mesh(n),
                                 record_history=True, **kw)
    assert_parity(res, jres)
    hist = res.residual_history
    assert hist.shape == (2001,) and float(hist[0]) > 0 \
        and torch.isnan(hist[int(res.iterations) + 1:]).all()


CSR_CASES = ([(n, lane, None, "cg") for n in (2, 4)
              for lane in ("allgather", "gather", "auto", "ring")]
             + [(3, "gather", "jacobi", "cg"), (3, "ring", "jacobi", "cg"),
                (1, "allgather", "jacobi", "cg"),
                (4, "gather", None, "cg1"), (4, "ring", "jacobi", "cg1"),
                (3, "allgather", None, "pipecg"),
                (2, "gather", "jacobi", "pipecg")])


@pytest.mark.parametrize("n,lane,pc,method", CSR_CASES)
def test_solve_distributed_csr_matches_jax(n, lane, pc, method):
    ja, ta = csrs()
    b = vec(ta.shape[0], 7)
    lane_kw = dict(csr_comm="ring") if lane == "ring" \
        else dict(exchange=lane)
    kw = dict(tol=0.0, rtol=1e-5, preconditioner=pc, method=method,
              **lane_kw)
    jres = jpar.solve_distributed(ja, jnp.asarray(b),
                                  mesh=jpar.make_mesh(n), **kw)
    res = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=mesh(n), **kw)
    assert_parity(res, jres, (n, lane, pc, method))


def test_gather_lane_is_the_allgather_lane_bit_for_bit():
    _, ta = csrs()
    b = torch.as_tensor(vec(ta.shape[0], 8))
    m = mesh(4)
    kw = dict(tol=0.0, rtol=1e-5, method="cg1")
    gather = tpar.solve_distributed(ta, b, mesh=m, exchange="gather", **kw)
    allgather = tpar.solve_distributed(ta, b, mesh=m, exchange="allgather",
                                       **kw)
    assert torch.equal(gather.x, allgather.x)
    assert int(gather.iterations) == int(allgather.iterations)


def test_compensated_solve_matches_jax():
    jop, top = stencils(GRID_2D)
    b = vec(top.n, 9)
    kw = dict(tol=0.0, rtol=1e-5, compensated=True, method="cg1")
    jres = jpar.solve_distributed(jop, jnp.asarray(b),
                                  mesh=jpar.make_mesh(4), **kw)
    m = mesh(4)
    res = tpar.solve_distributed(top, torch.as_tensor(b), mesh=m, **kw)
    assert_parity(res, jres)
    assert m.comm.counts["psum"] == int(res.iterations) + 1


# -- 5. refusals, validation and the solver cache -----------------------------


REFUSALS = [
    (dict(preconditioner="mg"), "stencil", NotImplementedError, "A8"),
    (dict(flight=object()), "stencil", NotImplementedError, "A9"),
    (dict(plan="auto"), "csr", NotImplementedError, "balance"),
    (dict(inject=object()), "csr", NotImplementedError, "A15"),
    (dict(deflate=object()), "csr", NotImplementedError, "A14"),
    (dict(basis=object()), "csr", NotImplementedError, "A14"),
    (dict(x0=np.zeros(512)), "csr", NotImplementedError, "A13"),
    (dict(return_checkpoint=True), "csr", NotImplementedError, "A13"),
    (dict(iter_cap=3), "csr", NotImplementedError, "A13"),
    (dict(resume_from=object()), "csr", NotImplementedError, "A13"),
    (dict(csr_comm="ring-shiftell"), "csr", NotImplementedError,
     "ring-shiftell"),
    # the JAX package's own refusals, with its exception types
    (dict(preconditioner="bjacobi"), "stencil", ValueError, "single-device"),
    (dict(preconditioner="ilu"), "stencil", ValueError, "unknown"),
    (dict(csr_comm="tree"), "csr", ValueError, "csr_comm"),
    (dict(exchange="mesh"), "csr", ValueError, "exchange"),
    (dict(exchange="gather"), "stencil", ValueError, "plane halos"),
    (dict(plan="auto"), "stencil", ValueError, "uniform"),
    (dict(exchange="ring", csr_comm="ring-shiftell"), "csr", ValueError,
     "conflicts"),
    (dict(exchange="gather", csr_comm="ring"), "csr", ValueError,
     "conflicts"),
    (dict(x0=np.zeros(512), csr_comm="ring"), "csr", ValueError,
     "allgather/gather"),
    (dict(deflate=object(), method="cg1"), "csr", ValueError,
     "method='cg'"),
]


@pytest.mark.parametrize("kw,kind,error,match", REFUSALS)
def test_solve_distributed_refusals(kw, kind, error, match):
    if kind == "csr":
        ja, a = csrs()
    else:
        ja, a = stencils(GRID_2D)
    b = np.ones(a.shape[0], np.float32)
    with pytest.raises(error, match=match):
        tpar.solve_distributed(a, b, mesh=mesh(2), **kw)
    if error is ValueError:      # the JAX package refuses alike
        with pytest.raises(error):
            jpar.solve_distributed(ja, jnp.asarray(b),
                                   mesh=jpar.make_mesh(2), **kw)


def test_validation_and_shape_checks():
    _, top = stencils(GRID_2D)
    b = np.ones(top.n, np.float32)
    b[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tpar.solve_distributed(top, b, mesh=mesh(2))
    res = tpar.solve_distributed(top, b, mesh=mesh(2), validate=False,
                                 maxiter=3)
    assert res.status_enum() == pt.CGStatus.BREAKDOWN
    with pytest.raises(ValueError, match="does not match"):
        tpar.solve_distributed(top, np.ones(7), mesh=mesh(2))
    with pytest.raises(TypeError, match="supports"):
        tpar.solve_distributed(pt.DenseOperator.create(np.eye(4),
                                                       device="cpu"),
                               np.ones(4), mesh=mesh(2))


def test_solver_cache():
    assert tpar.cache_key_parts("k", b=2, a=None, c=(1,)) == \
        ("k", ("b", 2), ("c", (1,)))
    assert tpar.cache_key_parts("k", a=1) == jpar.dist_cg.cache_key_parts(
        "k", a=1)
    tpar.clear_solver_cache()
    _, top = stencils(GRID_2D)
    b = torch.as_tensor(vec(top.n, 10))
    m = mesh(2)
    before = tdist._BUILD_COUNT[0]
    first = tpar.solve_distributed(top, b, mesh=m, tol=0.0, rtol=1e-5)
    again = tpar.solve_distributed(top, b, mesh=m, tol=0.0, rtol=1e-5)
    assert tdist._BUILD_COUNT[0] == before + 1      # one build, one hit
    assert torch.equal(first.x, again.x)
    tpar.clear_solver_cache()
    assert not tdist._SOLVER_CACHE


def test_solver_cache_cap(monkeypatch):
    monkeypatch.setenv(tdist.DIST_CACHE_CAP_ENV, "1")
    tpar.clear_solver_cache()
    _, top = stencils(GRID_2D)
    b = torch.as_tensor(vec(top.n, 11))
    for n in (1, 2):
        tpar.solve_distributed(top, b, mesh=mesh(n), maxiter=2)
    assert len(tdist._SOLVER_CACHE) == 1
    monkeypatch.setenv(tdist.DIST_CACHE_CAP_ENV, "0")
    with pytest.raises(ValueError, match=">= 1"):
        tpar.solve_distributed(top, b, mesh=mesh(4), maxiter=2)
    tpar.clear_solver_cache()


# -- 6. torch.distributed (gloo): two ranks give the stacked mesh's bits ------


def _gloo_rank(rank, world, init, out, lane):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        a, b, kw = _gloo_problem(lane)
        m = tpar.make_mesh()
        assert m.comm.kind == "distributed" and m.size == world
        res = tpar.solve_distributed(a, b, mesh=m, **kw)
        torch.save(dict(x=res.x, iterations=int(res.iterations),
                        counts=dict(m.comm.counts)), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _gloo_problem(lane):
    if lane == "stencil":
        a = pt.Stencil3D.create(*GRID_3D, device="cpu")
        kw = dict(tol=0.0, rtol=1e-5, method="cg1",
                  preconditioner="jacobi")
    else:
        a = tpoisson.poisson_2d_csr(16, 32, dtype=torch.float32,
                                    device="cpu")
        kw = dict(tol=0.0, rtol=1e-5, exchange="gather")
    return a, torch.as_tensor(vec(a.shape[0], 12)), kw


@pytest.mark.parametrize("lane", ["stencil", "csr-gather"])
def test_gloo_ranks_equal_the_stacked_mesh(tmp_path, lane):
    import torch.multiprocessing as mp

    out = str(tmp_path / "result")
    init = "file://" + str(tmp_path / "rendezvous")
    mp.spawn(_gloo_rank, args=(2, init, out, lane), nprocs=2, join=True)
    a, b, kw = _gloo_problem(lane)
    want = tpar.solve_distributed(a, b, mesh=mesh(2), **kw)
    for rank in range(2):
        got = torch.load(f"{out}.{rank}")
        assert got["iterations"] == int(want.iterations)
        assert torch.equal(got["x"], want.x)
        assert got["counts"]["psum"] > 0
    assert not os.path.exists(str(tmp_path / "result.2"))
