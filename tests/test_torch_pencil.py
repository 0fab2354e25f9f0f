"""The port's pencil decomposition against the JAX package's.

``parallel.make_mesh_2d``, the axis views of ``parallel.comm``,
``DistStencil3DPencil`` and the pencil lanes of ``solve_distributed``
and ``solve_distributed_df64`` (multigrid included), on stacked meshes
of CPU shards (``make_mesh_2d((4, 2), devices=["cpu"] * 8)``); the JAX
package on its 2-D meshes of the 8 virtual CPU devices
``tests/conftest.py`` sets up.  The gloo ranks on a (2, 2) mesh are in
``test_torch_multihost.py``.

Carried over: ``tests/test_pencil.py`` (grid (16, 8, 8) on a (4, 2)
mesh), ``tests/test_df64_dist.py::TestPencilDF64`` and the pencil case
of ``tests/test_df64_mg.py``.  Each JAX reference is computed once a
module (``jax_refs``).

Tolerances: the pencil matvec is the JAX formula term for term - within
1e-13 of the JAX one in float64 and, within the port, bit-equal to the
global ``Stencil3D(backend="xla")`` matvec.  The f64 solves take the JAX
pencil solves' iteration counts (the f64 lane against the JAX
double-float pairs within the JAX tests' own margin of 2; multigrid
within 1), x within reduction-order rounding: each shard's partial dots
fold in another order than XLA's.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models import multigrid as jmg
from cuda_mpi_parallel_tpu.parallel import df64 as jpdf
from cuda_mpi_parallel_tpu.utils.compat import shard_map as jshard_map
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import multigrid as tmg
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.parallel import operators as tops
from cuda_mpi_parallel_tpu_torch.telemetry import flight as tflight

tprecond = sys.modules["cuda_mpi_parallel_tpu_torch.models.precond"]

torch.set_num_threads(1)

GRID = (16, 8, 8)
DF_GRID = (16, 8, 6)
MG_DF_GRID = (16, 16, 6)


def mesh2d(shape=(4, 2)):
    return tpar.make_mesh_2d(shape, devices=["cpu"] * (shape[0] * shape[1]))


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def system(grid, seed, dtype=torch.float64):
    """``(a, x_true, b)``: the port's stencil on the CPU and b = A x_true
    in float64 (numpy)."""
    a = pt.Stencil3D.create(*grid, dtype=dtype, device="cpu")
    a64 = pt.Stencil3D.create(*grid, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(seed).standard_normal(a.n)
    return a, x, (a64 @ torch.as_tensor(x)).numpy()


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX results several cases hold the port to, each computed
    once: ``name -> (iterations, x)`` (the matvec: ``(None, y)``)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_ref(name)
        return cache[name]
    return get


def _jax_ref(name):
    jm = jpar.make_mesh_2d((4, 2))
    if name == "matvec":
        local = jpar.DistStencil3DPencil.create(GRID, (4, 2), scale=1.3,
                                                dtype=jnp.float64)
        x = np.random.default_rng(5).standard_normal(int(np.prod(GRID)))
        x3 = jax.device_put(jnp.asarray(x).reshape(GRID),
                            NamedSharding(jm, P("rows", "cols")))

        @jax.jit
        @jshard_map(mesh=jm, in_specs=P("rows", "cols"),
                    out_specs=P("rows", "cols"))
        def apply(u):
            return (local @ u.reshape(-1)).reshape(local.local_grid)
        return None, np.asarray(apply(x3)).reshape(-1)
    if name.startswith("df64"):
        _, method, precond = name.split("-")
        grid = MG_DF_GRID if precond == "mg" else DF_GRID
        ja = jp.Stencil3D.create(*grid, dtype=jnp.float32)
        _, _, b = system(grid, 7)
        kw = dict(tol=0.0, rtol=1e-10, maxiter=2000, method=method,
                  preconditioner=None if precond == "none" else precond,
                  check_every=4 if method == "pipecg" else 1)
        r = jpdf.solve_distributed_df64(ja, b, mesh=jm, **kw)
        return int(r.iterations), r.x()
    ja = jp.Stencil3D.create(*GRID, dtype=jnp.float64)
    _, _, b = system(GRID, 31)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=500)
    if name == "chebyshev":
        kw.update(preconditioner="chebyshev", precond_degree=3)
    elif name == "mg":
        kw.update(preconditioner="mg")
    elif name in ("cg1", "pipecg"):
        kw.update(method=name)
    r = jpar.solve_distributed(ja, jnp.asarray(b), mesh=jm, **kw)
    assert bool(r.converged)
    return int(r.iterations), np.asarray(r.x)


# -- 1. the mesh and its axis views -------------------------------------------


def test_make_mesh_2d_layout_and_rules():
    m = mesh2d()
    assert m.devices.shape == (4, 2) and m.size == 8
    assert m.axis_names == ("rows", "cols") and m.comm.kind == "stacked"
    rows, cols = (m.axis_comms[n] for n in m.axis_names)
    assert isinstance(rows, tcomm.AxisComm) and rows.n_shards == 4
    assert rows.shard_ids == (0, 0, 1, 1, 2, 2, 3, 3)
    assert cols.shard_ids == (0, 1) * 4 and cols.local_count == 8
    jm = jpar.make_mesh_2d((4, 2))       # the JAX package lays out alike
    assert jm.devices.shape == m.devices.shape
    with pytest.raises(ValueError, match="requested 4x2 devices, only 4"):
        tpar.make_mesh_2d((4, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="requested 4x2"):
        jpar.make_mesh_2d((4, 2), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=r"\(sx, sy\)"):
        tpar.make_mesh_2d((2, 2, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        jpar.make_mesh_2d((2, 2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh_2d((1, 1))              # devices=None: every card
    with pytest.raises(NotImplementedError, match="multi-card"):
        tpar.make_mesh_2d((2, 1), devices=["cpu", "meta"])


def test_axis_views_move_along_one_axis():
    m = mesh2d()
    v = torch.arange(8.0).reshape(8, 1)          # shard (i, j) holds 2i + j
    with tcomm.bind(m):
        rows, cols = tcomm.resolve("rows"), tcomm.resolve("cols")
        assert tcomm.resolve(("cols", "rows")) is m.comm
        fwd = [(0, 1), (1, 2), (2, 3)]
        out = rows.ppermute(v, fwd).reshape(4, 2)
        assert torch.equal(out, torch.tensor([[0., 0.], [0., 1.], [2., 3.],
                                              [4., 5.]]))
        out = cols.ppermute(v, [(1, 0)]).reshape(4, 2)
        assert torch.equal(out[:, 0], torch.tensor([1., 3., 5., 7.]))
        assert torch.equal(out[:, 1], torch.zeros(4))
        gathered = rows.all_gather(v)                # (8, 4): each column
        assert gathered.shape == (8, 4)
        assert torch.equal(gathered[5], torch.tensor([1., 3., 5., 7.]))
        assert torch.equal(cols.all_gather(v)[6], torch.tensor([6., 7.]))
        assert float(tcomm.resolve(("rows", "cols")).psum(v)) == 28.0
    assert dict(m.comm.counts) == {"ppermute": 2, "all_gather": 2,
                                   "psum": 1}
    with pytest.raises(NameError, match="unbound axis name"):
        tcomm.resolve(("rows", "cols"))
    slab = mesh(4)
    with tcomm.bind(slab):                   # 1-D meshes are as they were
        assert tcomm.resolve("rows") is slab.comm
        assert tcomm.resolve(("rows",)) is slab.comm
        with pytest.raises(NameError):
            tcomm.resolve(("rows", "cols"))


# -- 2. DistStencil3DPencil ---------------------------------------------------


def test_pencil_create_rules():
    with pytest.raises(ValueError, match="not divisible"):
        tpar.DistStencil3DPencil.create((10, 8, 8), (4, 2), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        jpar.DistStencil3DPencil.create((10, 8, 8), (4, 2))
    loc = tpar.DistStencil3DPencil.create(GRID, (4, 2), scale=2.0,
                                          device="cpu")
    assert loc.local_grid == (4, 4, 8) and loc.shards == (4, 2)
    assert loc.axis_names == ("rows", "cols") and loc.dtype == torch.float32
    assert loc.shape == (128, 128)                 # outside a scope: one
    assert torch.equal(loc.diagonal(), torch.full((128,), 12.0))
    with tcomm.bind(mesh2d()):
        assert loc.shape == (8 * 128, 8 * 128)


def _jax_pencil_state(scale, dtype):
    j = jpar.DistStencil3DPencil.create(GRID, (4, 2), scale=scale,
                                        dtype=dtype)
    return convert.operator_from_arrays(
        "DistStencil3DPencil", {"scale": np.asarray(j.scale)},
        dict(local_grid=j.local_grid, axis_names=j.axis_names,
             shards=j.shards, _dtype_name=j._dtype_name), device="cpu")


def test_pencil_matvec_matches_jax_and_the_global_stencil(jax_refs):
    _, want = jax_refs("matvec")
    loc = _jax_pencil_state(1.3, jnp.float64)
    assert loc.local_grid == (4, 4, 8) and loc.dtype == torch.float64
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        int(np.prod(GRID))))
    m = mesh2d()
    with tcomm.bind(m):
        y = tops.from_pencils(loc @ tops.to_pencils(x, GRID, (4, 2)), GRID,
                              (4, 2))
    assert dict(m.comm.counts) == {"ppermute": 4}
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-13, atol=1e-13)
    glob = pt.Stencil3D.create(*GRID, scale=1.3, dtype=torch.float64,
                               backend="xla", device="cpu")
    assert torch.equal(y, glob @ x)
    # f32, and every mesh shape: bit-equal to the global xla matvec
    x32 = x.float()
    glob32 = pt.Stencil3D.create(*GRID, scale=1.3, backend="xla",
                                 device="cpu")
    for shape in ((4, 2), (2, 4), (4, 1), (1, 2), (1, 1)):
        loc32 = tpar.DistStencil3DPencil.create(GRID, shape, scale=1.3,
                                                device="cpu")
        with tcomm.bind(mesh2d(shape)):
            y32 = loc32 @ tops.to_pencils(x32, GRID, shape)
        assert torch.equal(tops.from_pencils(y32, GRID, shape),
                           glob32 @ x32), shape
    # a lone (1, 1) pencil needs no scope
    one = tpar.DistStencil3DPencil.create(GRID, (1, 1), device="cpu")
    assert torch.equal(one @ x32, pt.Stencil3D.create(
        *GRID, device="cpu") @ x32)


def test_exchange_halo_axis_rides_the_axis_view():
    """``exchange_halo_axis`` at ``dim=1`` moves the y planes over the
    cols view: shard (i, j)'s lo plane is shard (i, j-1)'s last y plane."""
    m = mesh2d()
    u = torch.arange(8 * 2 * 3 * 1, dtype=torch.float64).reshape(8, 2, 3, 1)
    with tcomm.bind(m):
        lo, hi = tpar.exchange_halo_axis(u, "cols", 2, dim=1)
        xlo, _ = tpar.exchange_halo_axis(u, "rows", 4, dim=0)
    assert lo.shape == (8, 2, 1, 1)
    for i in range(4):
        assert torch.equal(lo[2 * i + 1], u[2 * i][:, -1:])
        assert torch.equal(lo[2 * i], torch.zeros(2, 1, 1))
        assert torch.equal(hi[2 * i], u[2 * i + 1][:, :1])
    assert torch.equal(xlo[2:], u[:-2][:, -1:])


# -- 3. solve_distributed on pencils ------------------------------------------


@pytest.mark.parametrize("name", ["cg", "cg1", "pipecg", "chebyshev", "mg"])
def test_pencil_solve_matches_jax(name, jax_refs):
    """The JAX pencil solves' counts; x within reduction-order rounding
    of the JAX pencil x and at x_true.  The Chebyshev lane carries the
    JAX estimate across (torch and XLA round ``sin`` apart)."""
    j_its, j_x = jax_refs(name)
    a, x_true, b = system(GRID, 31)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=500)
    if name == "chebyshev":
        kw.update(preconditioner="chebyshev", precond_degree=3)
    elif name == "mg":
        kw.update(preconditioner="mg")
    elif name in ("cg1", "pipecg"):
        kw.update(method=name)
    res = tpar.solve_distributed(a, torch.as_tensor(b), mesh=mesh2d(), **kw)
    assert bool(res.converged)
    assert abs(int(res.iterations) - j_its) <= (1 if name == "mg" else 0)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-7)
    np.testing.assert_allclose(res.x.numpy(), j_x, rtol=1e-9, atol=1e-11)


def test_pencil_solve_matches_slabs_and_one_device():
    """As the JAX test: the pencil count is the 8-slab count and one
    device's within 1; (4, 1) pencils take the 4-slab count; a (1, 1)
    pencil in f32 is the single-device general engine's solve, bit for
    bit."""
    a, x_true, b = system(GRID, 31)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=500)
    b = torch.as_tensor(b)
    pencil = tpar.solve_distributed(a, b, mesh=mesh2d(), **kw)
    slab = tpar.solve_distributed(a, b, mesh=mesh(8), **kw)
    single = pt.solve(a, b, engine="general", **kw)
    assert int(pencil.iterations) == int(slab.iterations)
    assert abs(int(pencil.iterations) - int(single.iterations)) <= 1
    np.testing.assert_allclose(pencil.x.numpy(), slab.x.numpy(), rtol=1e-9,
                               atol=1e-11)
    four = tpar.solve_distributed(a, b, mesh=mesh2d((4, 1)), **kw)
    assert int(four.iterations) == int(
        tpar.solve_distributed(a, b, mesh=mesh(4), **kw).iterations)
    a32, _, b64 = system(GRID, 32, torch.float32)
    b32 = torch.as_tensor(b64, dtype=torch.float32)
    kw32 = dict(tol=0.0, rtol=1e-5, maxiter=500)
    one = tpar.solve_distributed(a32, b32, mesh=mesh2d((1, 1)), **kw32)
    ref = pt.solve(a32, b32, engine="general", **kw32)
    assert torch.equal(one.x, ref.x)
    assert int(one.iterations) == int(ref.iterations)


def test_pencil_history_flight_and_cache():
    """``record_history``, ``flight=`` and ``check_every`` as on the slab
    lane; the solver cache keys the pencil lane and reuses it."""
    a, _, b = system(GRID, 33)
    b = torch.as_tensor(b)
    kw = dict(tol=0.0, rtol=1e-8, maxiter=500, record_history=True)
    m = mesh2d()
    pencil = tpar.solve_distributed(a, b, mesh=m, **kw)
    slab = tpar.solve_distributed(a, b, mesh=mesh(8), **kw)
    its = int(pencil.iterations)
    np.testing.assert_allclose(pencil.residual_history[:its + 1].numpy(),
                               slab.residual_history[:its + 1].numpy(),
                               rtol=1e-10)
    built = tdist._BUILD_COUNT[0]
    m.comm.counts.clear()
    again = tpar.solve_distributed(a, b, mesh=m, **kw)
    assert tdist._BUILD_COUNT[0] == built and torch.equal(again.x, pencil.x)
    assert m.comm.counts["ppermute"] == 4 * its         # x0 = 0: k matvecs
    assert any(k[0] == "pencil" for k in tdist._SOLVER_CACHE)
    cfg = tflight.FlightConfig.for_solve(500, stride=1, heartbeat=0)
    rec = tpar.solve_distributed(a, b, mesh=m, check_every=4, flight=cfg,
                                 tol=0.0, rtol=1e-8, maxiter=500)
    got = tflight.FlightRecord.from_buffer(rec.flight)
    assert int(rec.iterations) >= its
    assert np.array_equal(got.iterations,
                          np.arange(0, int(rec.iterations) + 1))


def test_pencil_chebyshev_estimate_reduces_over_both_axes():
    """The power iteration on pencils starts each shard from the global
    index of its rows (linearised over both axes, as JAX's) and
    reduces over both axes: the 8-slab estimate to rounding."""
    a, _, _ = system(GRID, 0)
    pencil = tpar.DistStencil3DPencil.create(GRID, (4, 2),
                                             dtype=torch.float64,
                                             device="cpu")
    slab = tpar.DistStencil3D.create(GRID, 8, dtype=torch.float64,
                                     device="cpu")
    with tcomm.bind(mesh2d()):
        lp = float(tprecond.estimate_lmax(pencil,
                                          axis_name=("rows", "cols")))
    with tcomm.bind(mesh(8)):
        ls = float(tprecond.estimate_lmax(slab, axis_name="rows"))
    assert lp == pytest.approx(ls, rel=0.05) and 11.0 < lp < 13.0


REFUSALS = [
    (dict(), "csr", TypeError, "Stencil3D"),
    (dict(), "pallas", ValueError, "no pallas matvec"),
    (dict(preconditioner="jacob"), "stencil", ValueError,
     "unknown preconditioner"),
    (dict(preconditioner="bjacobi"), "stencil", ValueError, "single-device"),
    (dict(plan="auto"), "stencil", ValueError, "uniform"),
    (dict(rhs=17), "stencil", ValueError, "does not match rhs"),
]


@pytest.mark.parametrize("kw,kind,error,match", REFUSALS)
def test_pencil_refusals(kw, kind, error, match):
    """The JAX refusals on a 2-D mesh, with its exception types."""
    if kind == "csr":
        a = tpoisson.poisson_2d_csr(8, 8, device="cpu")
    else:
        a = pt.Stencil3D.create(*GRID, device="cpu",
                                backend="pallas" if kind == "pallas"
                                else "xla")
    b = torch.ones(kw.pop("rhs", a.shape[0]))
    with pytest.raises(error, match=match):
        tpar.solve_distributed(a, b, mesh=mesh2d(), **kw)


def test_slab_only_lanes_refuse_a_2d_mesh():
    a = pt.Stencil3D.create(*GRID, device="cpu")
    b = torch.ones(a.n)
    for fn in (tpar.solve_distributed_streaming,
               tpar.solve_distributed_resident):
        with pytest.raises(ValueError, match="1-D"):
            fn(a, b, mesh=mesh2d())
    with pytest.raises(ValueError, match="cg-family only"):
        tpar.solve_distributed_df64(a, b.double().numpy(), mesh=mesh2d(),
                                    method="minres")
    with pytest.raises(TypeError, match="Stencil3D"):
        tpar.solve_distributed_df64(pt.Stencil2D.create(8, 8, device="cpu"),
                                    np.ones(64), mesh=mesh2d())


# -- 4. multigrid on pencils --------------------------------------------------


def test_mg_hierarchy_on_pencils_is_the_jax_one():
    """Coarse pencils halve the local grid; past that the replicated
    continuation takes the global grid: the JAX hierarchy, level for
    level, as deep as one device's."""
    jloc = jpar.DistStencil3DPencil.create((32, 16, 16), (4, 2))
    jops, jglob = jmg._level_ops(jloc, 2, 16)
    loc = tpar.DistStencil3DPencil.create((32, 16, 16), (4, 2),
                                          device="cpu")
    ops, glob = tmg._level_ops(loc, 2, 16)
    assert [o.local_grid for o in ops] == [o.local_grid for o in jops]
    assert [o.grid for o in glob] == [o.grid for o in jglob]
    assert [float(o.scale) for o in ops + glob] == \
        [float(o.scale) for o in jops + jglob]
    single = tmg.MultigridPreconditioner.from_operator(
        pt.Stencil3D.create(32, 16, 16, device="cpu"))
    assert len(ops) + len(glob) == single.n_levels


def test_mg_cycle_on_pencils_is_the_single_device_cycle():
    """One V-cycle on (4, 2) pencils and on (2, 4): the single-device
    cycle's values to f64 rounding (the transfers exchange halos along
    both axes; the gather level all-gathers along both)."""
    a, _, b = system(GRID, 34)
    r = torch.as_tensor(b)
    want = tmg.MultigridPreconditioner.from_operator(a) @ r
    for shape in ((4, 2), (2, 4)):
        m = mesh2d(shape)
        loc = tpar.DistStencil3DPencil.create(GRID, shape,
                                              dtype=torch.float64,
                                              device="cpu")
        with tcomm.bind(m):
            mg = tmg.MultigridPreconditioner.from_operator(loc)
            got = tops.from_pencils(mg @ tops.to_pencils(r, GRID, shape),
                                    GRID, shape)
        assert mg.global_ops
        assert m.comm.counts["all_gather"] == 2
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


# -- 5. solve_distributed_df64 on pencils -------------------------------------


# the JAX df64 pencil solve compiles its shard_map'd double-float loop
# for 3-9 s a case: cg, cg1 with Jacobi and MG take their JAX reference,
# pipecg and Chebyshev the port's own single-device cg_df64 count (held
# to the JAX one by tests/test_torch_variants.py and test_torch_df64.py)
DF64_CASES = [("cg", "none", True), ("cg1", "jacobi", True),
              ("pipecg", "jacobi", False), ("cg", "chebyshev", False),
              ("cg", "mg", True)]


@pytest.mark.parametrize("method,precond,with_jax", DF64_CASES)
def test_df64_pencil_solve_matches_jax(method, precond, with_jax, jax_refs):
    """The JAX pencil df64 solves' counts (``TestPencilDF64``, the pencil
    case of ``test_df64_mg.py``): the f64 lane's against the JAX pairs
    within the JAX tests' margin of 2 (multigrid's within 1, the JAX
    test holding it to one device's count exactly); x at x_true to the
    JAX tests' tolerance and at the JAX x to the pairs' precision.  The
    port's own single-device ``cg_df64`` gives the count within 1 and x
    to f64 reduction-order rounding."""
    grid = MG_DF_GRID if precond == "mg" else DF_GRID
    a, x_true, b = system(grid, 7, torch.float32)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=2000, method=method,
              preconditioner=None if precond == "none" else precond,
              check_every=4 if method == "pipecg" else 1)
    m = mesh2d()
    res = tpar.solve_distributed_df64(a, b, mesh=m, **kw)
    single = pt.cg_df64(a, b, **kw)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(single.iterations)) <= 1
    assert res.x64.dtype == torch.float64
    np.testing.assert_allclose(res.x(), x_true, atol=1e-8)
    np.testing.assert_allclose(res.x(), single.x(), rtol=0,
                               atol=1e-12 * np.abs(single.x()).max())
    if precond == "none":
        assert m.comm.counts["ppermute"] == 4 * int(res.iterations)
    if with_jax:
        j_its, j_x = jax_refs(f"df64-{method}-{precond}")
        assert abs(int(res.iterations) - j_its) <= \
            (1 if precond == "mg" else 2)
        np.testing.assert_allclose(res.x(), j_x, rtol=0,
                                   atol=1e-9 * np.abs(j_x).max())


def test_df64_pencil_flight_and_one_shard():
    """``flight=`` on the pencil f64 lane records the reduced scalars; a
    (1, 1) pencil is one device's ``cg_df64`` bit for bit."""
    a, _, b = system(DF_GRID, 8, torch.float32)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=2000)
    cfg = tflight.FlightConfig.for_solve(2000, stride=2, heartbeat=0)
    rec = tpar.solve_distributed_df64(a, b, mesh=mesh2d(), flight=cfg,
                                      **kw)
    got = tflight.FlightRecord.from_buffer(rec.flight)
    assert np.array_equal(got.iterations,
                          np.arange(0, int(rec.iterations) + 1, 2))
    one = tpar.solve_distributed_df64(a, b, mesh=mesh2d((1, 1)), **kw)
    single = pt.cg_df64(a, b, **kw)
    assert np.array_equal(one.x(), single.x())
    assert int(one.iterations) == int(single.iterations)
