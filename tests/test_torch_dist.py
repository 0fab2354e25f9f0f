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
import json
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
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist

import torch_df64_ranks as ranks

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
    pencil = tpar.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    assert pencil.devices.shape == (2, 2) and pencil.size == 4 \
        and pencil.comm.kind == "stacked" \
        and pencil.axis_names == ("rows", "cols")
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
    pencil = tpar.DistStencil3DPencil.create(GRID_3D, (2, 2), device="cpu")
    assert pencil.local_grid == (4, 4, 128) and pencil.shards == (2, 2)
    assert pencil.shape == (4 * 4 * 128,) * 2       # outside a scope: one


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


@pytest.fixture(scope="module")
def jax_lmax():
    """``_jax_lmax`` computed once for the module: the cg, cg1 and
    pipecg cases of a grid and shard count share it."""
    cache = {}

    def lmax(jop, n, grid):
        if (grid, n) not in cache:
            cache[(grid, n)] = _jax_lmax(jop, n, grid)
        return cache[(grid, n)]
    return lmax


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
def test_solve_distributed_stencil_matches_jax(monkeypatch, jax_lmax, grid,
                                               n, method, pc):
    jop, top = stencils(grid)
    b = vec(top.n, 5)
    kw = dict(tol=0.0, rtol=1e-5, method=method, preconditioner=pc,
              maxiter=400)
    jres = jpar.solve_distributed(jop, jnp.asarray(b),
                                  mesh=jpar.make_mesh(n), **kw)
    if pc == "chebyshev":
        _carry_lmax(monkeypatch, jax_lmax(jop, n, grid))
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
    # the id keeps its first name: the stencil slab lane of mg runs since
    # its port (ROADMAP A8, tests/test_torch_multigrid.py), and a CSR
    # problem raises the JAX package's ValueError
    pytest.param(dict(preconditioner="mg"), "csr", ValueError,
                 "no CSR hierarchy", id="kw0-stencil-NotImplementedError-A8"),
    # the id keeps its first name: plan= runs since its port (ROADMAP
    # A10 residue, tests/test_torch_balance.py), and an object that is no
    # PartitionPlan gets the JAX package's TypeError
    pytest.param(dict(plan=object()), "csr", TypeError, "PartitionPlan",
                 id="kw1-csr-NotImplementedError-balance"),
    # the id keeps its first name: inject= runs on the assembled-CSR
    # allgather/gather lanes since its port (ROADMAP A15,
    # tests/test_torch_robust.py), and an object that is no FaultPlan
    # gets the JAX package's TypeError
    pytest.param(dict(inject=object()), "csr", TypeError, "FaultPlan",
                 id="kw2-csr-NotImplementedError-A15"),
    # the two ids below keep their first names: deflate=/basis= run on
    # the assembled-CSR allgather/gather lanes since their port (ROADMAP
    # A14, tests/test_torch_recycle.py), and an object that is no
    # RecycleSpace/BasisConfig gets the JAX package's TypeError
    pytest.param(dict(deflate=object()), "csr", TypeError, "RecycleSpace",
                 id="kw3-csr-NotImplementedError-A14"),
    pytest.param(dict(basis=object()), "csr", TypeError, "BasisConfig",
                 id="kw4-csr-NotImplementedError-A14"),
    # the four ids below keep their first names: the x0/resume lanes run
    # on the assembled-CSR allgather/gather lanes since their port
    # (ROADMAP A13, test_resume_lanes_match_jax), and each argument keeps
    # the JAX package's ValueError where no checkpointable state rides
    pytest.param(dict(x0=np.zeros(2048)), "stencil", ValueError,
                 "allgather/gather", id="kw5-csr-NotImplementedError-A13"),
    pytest.param(dict(return_checkpoint=True, csr_comm="ring"), "csr",
                 ValueError, "allgather/gather",
                 id="kw6-csr-NotImplementedError-A13"),
    pytest.param(dict(iter_cap=3, csr_comm="ring-shiftell"), "csr",
                 ValueError, "allgather/gather",
                 id="kw7-csr-NotImplementedError-A13"),
    pytest.param(dict(resume_from=object(), method="cg1"), "csr",
                 ValueError, "method='cg'",
                 id="kw8-csr-NotImplementedError-A13"),
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
    if error is not NotImplementedError:   # the JAX package refuses alike
        with pytest.raises(error):
            jpar.solve_distributed(ja, jnp.asarray(b),
                                   mesh=jpar.make_mesh(2), **kw)


RESUME_SHARDS = 3       # 512 rows pad to 513: the checkpoint keeps the pad


@pytest.fixture(scope="module")
def jax_resume_lanes():
    """The JAX resume lanes on 3 shards of the 16 x 32 CSR, once: a warm
    start, a capped solve with its checkpoint, its resume, and a whole
    solve returning its checkpoint."""
    ja, _ = csrs()
    b, x0 = vec(ja.shape[0], 14), vec(ja.shape[0], 15) * 0.1
    m = jpar.make_mesh(RESUME_SHARDS)
    kw = dict(tol=0.0, rtol=1e-5)
    out = dict(b_vec=b, x0_vec=x0)
    out["x0"] = jpar.solve_distributed(ja, jnp.asarray(b), mesh=m,
                                       x0=jnp.asarray(x0), **kw)
    out["iter_cap"] = jpar.solve_distributed(
        ja, jnp.asarray(b), mesh=m, iter_cap=3, return_checkpoint=True,
        **kw)
    out["resume_from"] = jpar.solve_distributed(
        ja, jnp.asarray(b), mesh=m,
        resume_from=out["iter_cap"].checkpoint, **kw)
    out["return_checkpoint"] = jpar.solve_distributed(
        ja, jnp.asarray(b), mesh=m, return_checkpoint=True, **kw)
    return out


def jax_checkpoint(c):
    from cuda_mpi_parallel_tpu_torch import convert

    return convert.checkpoint_from_arrays(
        {f: np.asarray(getattr(c, f)) for f in
         ("x", "r", "p", "rho", "rr", "nrm0", "k", "indefinite")},
        device="cpu")


def assert_checkpoint_parity(c, jc, b):
    """A distributed checkpoint: global padded vectors of the JAX shape
    and scalars agreeing to f32 reduction rounding (x within X_TOL of
    max|x|; r and p, which shrink with the residual, within X_TOL of
    max|b|, the scale of r0 = p0 = b)."""
    assert int(c.k) == int(np.asarray(jc.k))
    assert bool(c.indefinite) == bool(np.asarray(jc.indefinite))
    for name in ("x", "r", "p"):
        v, jv = getattr(c, name).numpy(), np.asarray(getattr(jc, name))
        assert v.shape == jv.shape == (513,), name
        assert v[512:].tolist() == [0.0], name
        scale = np.abs(jv).max() if name == "x" else np.abs(b).max()
        assert np.abs(v - jv).max() <= X_TOL * scale, name
    for name in ("rho", "rr", "nrm0"):
        assert float(getattr(c, name)) == pytest.approx(
            float(np.asarray(getattr(jc, name))), rel=1e-4), name


@pytest.mark.parametrize("lane", ["x0", "return_checkpoint", "iter_cap",
                                  "resume_from"])
def test_resume_lanes_match_jax(jax_resume_lanes, lane):
    _, a = csrs()
    ref = jax_resume_lanes
    b = torch.as_tensor(ref["b_vec"])
    m = mesh(RESUME_SHARDS)
    kw = dict(tol=0.0, rtol=1e-5)
    if lane == "x0":
        res = tpar.solve_distributed(a, b, mesh=m, x0=ref["x0_vec"], **kw)
        assert_parity(res, ref["x0"])
    elif lane == "return_checkpoint":
        res = tpar.solve_distributed(a, b, mesh=m, return_checkpoint=True,
                                     **kw)
        assert_parity(res, ref["return_checkpoint"])
        assert_checkpoint_parity(res.checkpoint,
                                 ref["return_checkpoint"].checkpoint,
                                 ref["b_vec"])
        assert torch.equal(res.checkpoint.x[:512], res.x)
    elif lane == "iter_cap":
        res = tpar.solve_distributed(a, b, mesh=m, iter_cap=3,
                                     return_checkpoint=True, **kw)
        assert int(res.iterations) == 3
        assert_parity(res, ref["iter_cap"])
        assert_checkpoint_parity(res.checkpoint, ref["iter_cap"].checkpoint,
                                 ref["b_vec"])
    else:
        # from the JAX package's checkpoint, to the JAX resumed count
        res = tpar.solve_distributed(
            a, b, mesh=m,
            resume_from=jax_checkpoint(ref["iter_cap"].checkpoint), **kw)
        assert_parity(res, ref["resume_from"])
        # from its own: bit-equal to the unsplit solve
        part = tpar.solve_distributed(a, b, mesh=m, iter_cap=3,
                                      return_checkpoint=True, **kw)
        rest = tpar.solve_distributed(a, b, mesh=m,
                                      resume_from=part.checkpoint, **kw)
        full = tpar.solve_distributed(a, b, mesh=m, **kw)
        assert int(rest.iterations) == int(full.iterations)
        assert torch.equal(rest.x, full.x)
        with pytest.raises(ValueError, match="padded layout"):
            tpar.solve_distributed(a, b, mesh=mesh(2),
                                   resume_from=part.checkpoint, **kw)


def test_solve_distributed_carries_the_flight_recorder():
    # flight= left REFUSALS with its port (ROADMAP A9): the lane records
    # the all-reduced scalars with the heartbeat stripped, and the
    # iterates are the same with the recorder on and off
    from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
    from cuda_mpi_parallel_tpu_torch.telemetry import flight as tflight

    _, top = stencils(GRID_2D)
    b = vec(top.n, 21)
    kw = dict(tol=0.0, rtol=1e-5, check_every=4)
    cfg = tflight.FlightConfig.for_solve(2000, stride=2, heartbeat=3)
    with tev.capture() as buf:
        res = tpar.solve_distributed(top, b, mesh=mesh(2), flight=cfg, **kw)
    plain = tpar.solve_distributed(top, b, mesh=mesh(2), **kw)
    assert torch.equal(res.x, plain.x) and plain.flight is None
    rec = tflight.FlightRecord.from_buffer(res.flight)
    k = int(res.iterations)
    assert np.array_equal(rec.iterations, np.arange(0, k + 1, 2))
    # one engine_selected and no heartbeat; the rest of the stream is the
    # partition and comm accounting a telemetered solve adds since
    # shardscope's port (ROADMAP A16, tests/test_torch_shardscope.py)
    events = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert {e["event"] for e in events} \
        == {"engine_selected", "shard_profile", "comm_cost"}
    engine, = [e for e in events if e["event"] == "engine_selected"]
    assert engine["flight_stride"] == 2 and engine["n_shards"] == 2


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


@pytest.mark.parametrize("lane", ["stencil", "csr-gather"])
def test_gloo_ranks_equal_the_stacked_mesh(tmp_path, lane):
    import torch.multiprocessing as mp

    out = str(tmp_path / "result")
    init = "file://" + str(tmp_path / "rendezvous")
    # the ranks import a helper without JAX (torch_df64_ranks.py), not
    # this module
    mp.spawn(ranks.slab_rank, args=(2, init, out, lane), nprocs=2,
             join=True)
    for rank in range(2):
        got = torch.load(f"{out}.{rank}")
        assert len(got) == len(ranks.slab_problems(lane))
        for (a, b, kw), g in zip(ranks.slab_problems(lane), got):
            m = mesh(2)
            want = tpar.solve_distributed(a, b, mesh=m, **kw)
            assert g["iterations"] == int(want.iterations)
            assert torch.equal(g["x"], want.x)
            assert g["counts"]["psum"] > 0
            assert g["counts"] == dict(m.comm.counts)
    assert not os.path.exists(str(tmp_path / "result.2"))
