"""The port's geometric multigrid (``models/multigrid.py``) against the
JAX package's.

Carries over the JAX ``tests/test_multigrid.py`` (transfer adjointness,
V-cycle symmetry and positive definiteness, hierarchy depth, grid
independence, the distributed cycle) and the single-device class of
``tests/test_df64_mg.py`` (the f32 V-cycle inside the f64 lane), and
holds the port against the JAX package directly:

* one V-cycle of the same seeded vector through the JAX cycle and the
  port's after ``convert.operator_from_arrays``: within 1e-12 of max|z|
  in float64 and 1e-6 of max|z| in float32 (the two apply the same
  multiply-adds in the same order; the JAX cycle runs under ``jit``);
* MG-PCG through ``solve``: the JAX iteration count and status, x within
  1e-12 of max|x| (f64) or 1e-5 (f32);
* the distributed cycle on an 8-shard stacked mesh: the port's
  single-device count within 1, as the JAX package asserts of its own
  two lanes (its compile on 8 devices costs too much here; the JAX
  package's tests hold JAX dist = JAX single).

Every JAX reference is computed once for the module (``jax_refs``).  On
the CPU the stencil wrappers run their plain twins, so a solve's use of
B1/B2 is counted here by wrapping the wrappers: the finest level applies
its operator twice a V-cycle.
"""
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models.multigrid import \
    MultigridPreconditioner as JMG
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.models.multigrid import (
    MultigridPreconditioner,
    _prolong,
    _restrict,
)
from cuda_mpi_parallel_tpu_torch.ops.cuda import stencil as hk
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.solver.status import CGStatus

# the module (the package re-exports its function ``cg`` under that name)
tcg = sys.modules["cuda_mpi_parallel_tpu_torch.solver.cg"]

torch.set_num_threads(1)


def vec(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def top(grid, dtype=torch.float64, backend="xla"):
    make = (tpoisson.poisson_2d_operator if len(grid) == 2
            else tpoisson.poisson_3d_operator)
    return make(*grid, dtype=dtype, backend=backend, device="cpu")


def jop(grid, dtype=np.float64):
    make = (jpoisson.poisson_2d_operator if len(grid) == 2
            else jpoisson.poisson_3d_operator)
    return make(*grid, dtype=dtype)


def cross(jm):
    """The port's preconditioner for a JAX one: its leaves flattened and
    its levels' meta read, as the caller of ``convert`` does."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(jm)
    arrays = {jax.tree_util.keystr(path): np.asarray(v) for path, v in leaves}
    meta = {field: [(type(o).__name__,
                     dict(grid=o.grid, backend=o.backend,
                          _dtype_name=o._dtype_name))
                    for o in getattr(jm, field)]
            for field in ("ops", "global_ops")}
    meta.update(omega=jm.omega, pre_sweeps=jm.pre_sweeps,
                post_sweeps=jm.post_sweeps, coarse_sweeps=jm.coarse_sweeps)
    return convert.operator_from_arrays("MultigridPreconditioner", arrays,
                                        meta, device="cpu")


#: V-cycle parity cases: (grid, dtype, seed)
VCYCLES = {"f64-2d": ((64, 64), np.float64, 3),
           "f32-3d": ((16, 16, 16), np.float32, 4)}
#: MG-PCG parity cases: (grid, dtype, rtol, seed); b = A x_true
SOLVES = {"f64-2d": ((64, 64), np.float64, 1e-10, 7),
          "f64-3d": ((16, 16, 16), np.float64, 1e-8, 6),
          "f32-2d": ((32, 64), np.float32, 1e-5, 8)}


@pytest.fixture(scope="module")
def jax_refs():
    """``ref(kind, key)``: the JAX V-cycle of a ``VCYCLES`` case (the
    preconditioner, the vector and ``M v``) or the JAX MG-PCG solve of a
    ``SOLVES`` case (``(x_true, b, iterations, status, x)``), each
    computed once for the module."""
    cache = {}
    apply = jax.jit(lambda m, v: m @ v)

    def ref(kind, key):
        if (kind, key) in cache:
            return cache[kind, key]
        if kind == "vcycle":
            grid, dt, seed = VCYCLES[key]
            jm = JMG.from_operator(jop(grid, dt))
            v = vec(int(np.prod(grid)), seed, dt)
            out = (jm, v, np.asarray(apply(jm, jnp.asarray(v))))
        else:
            grid, dt, rtol, seed = SOLVES[key]
            ja = jop(grid, dt)
            x_true = vec(int(np.prod(grid)), seed, dt)
            b = np.array(ja @ jnp.asarray(x_true))
            res = jp.solve(ja, jnp.asarray(b), tol=0.0, rtol=rtol,
                           maxiter=200, m=JMG.from_operator(ja))
            out = (x_true, b, int(res.iterations), int(res.status),
                   np.array(res.x))
        cache[kind, key] = out
        return out
    return ref


class _HostReads(TorchDispatchMode):
    """Counts ``aten._local_scalar_dense``: every ``.item()`` and
    ``bool()`` of a tensor."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def stencil_calls(monkeypatch):
    """Counts the calls of the B1/B2 wrappers (the finest level of a
    ``backend="pallas"`` hierarchy; on the CPU they run the twins)."""
    calls = {"stencil2d_apply": 0, "stencil3d_apply": 0}
    for name in calls:
        real = getattr(hk, name)

        def counted(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(hk, name, counted)
    return calls


# -- transfers ----------------------------------------------------------------


class TestTransfers:
    @pytest.mark.parametrize("grid", [(16, 16), (32, 8)])
    def test_adjoint_2d(self, rng, grid):
        """<P e, f> == 2^d <e, R f> (R = P^T / 4 in 2D)."""
        nc = (grid[0] // 2) * (grid[1] // 2)
        e = torch.as_tensor(rng.standard_normal(nc))
        f = torch.as_tensor(rng.standard_normal(grid[0] * grid[1]))
        lhs = float(torch.dot(_prolong(e, grid), f))
        rhs = 4.0 * float(torch.dot(e, _restrict(f, grid)))
        assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))

    def test_adjoint_3d(self, rng):
        grid = (8, 8, 8)
        e = torch.as_tensor(rng.standard_normal(4 * 4 * 4))
        f = torch.as_tensor(rng.standard_normal(8 * 8 * 8))
        lhs = float(torch.dot(_prolong(e, grid), f))
        rhs = 8.0 * float(torch.dot(e, _restrict(f, grid)))
        assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))

    def test_prolong_preserves_constants_in_interior(self):
        """Bilinear interpolation reproduces constants away from the
        Dirichlet boundary (where the zero halo correctly decays)."""
        grid = (16, 16)
        p = _prolong(torch.ones(64, dtype=torch.float64), grid)
        np.testing.assert_allclose(p.reshape(grid)[2:-2, 2:-2].numpy(), 1.0,
                                   rtol=1e-14)

    def test_leading_shard_axis_is_left_alone(self, rng):
        """A stacked block ``(L, *grid)`` transfers shard by shard: the
        transfers of L stacked blocks are the L blocks' transfers."""
        grid = (8, 4, 6)
        f = torch.as_tensor(rng.standard_normal((3,) + grid))
        e = torch.as_tensor(rng.standard_normal((3, 4, 2, 3)))
        rs, ps = _restrict(f.reshape(-1), grid), _prolong(e.reshape(-1), grid)
        for s in range(3):
            assert torch.equal(rs.reshape(3, -1)[s],
                               _restrict(f[s].reshape(-1), grid))
            assert torch.equal(ps.reshape(3, -1)[s],
                               _prolong(e[s].reshape(-1), grid))


# -- the V-cycle --------------------------------------------------------------


class TestVCycle:
    def test_symmetric_positive_definite(self, rng):
        n = 16
        m = MultigridPreconditioner.from_operator(top((n, n)))
        v = torch.as_tensor(rng.standard_normal(n * n))
        w = torch.as_tensor(rng.standard_normal(n * n))
        sym_l = float(torch.dot(w, m @ v))
        sym_r = float(torch.dot(v, m @ w))
        assert abs(sym_l - sym_r) < 1e-11 * max(1.0, abs(sym_l))
        assert float(torch.dot(v, m @ v)) > 0

    def test_hierarchy_depth(self):
        m = MultigridPreconditioner.from_operator(top((64, 64)))
        # 64 -> 32 -> 16 -> 8 -> 4 -> 2
        assert m.n_levels == 6
        assert m.ops[-1].grid == (2, 2)
        assert [float(o.scale) for o in m.ops] == [0.25 ** i
                                                   for i in range(6)]
        assert m.shape == (4096, 4096) and m.dtype == torch.float64
        assert m.device == torch.device("cpu")
        with pytest.raises(NotImplementedError, match="diagonal"):
            m.diagonal()

    def test_odd_extent_stops_coarsening(self):
        m = MultigridPreconditioner.from_operator(top((48, 48)))
        # 48 -> 24 -> 12 -> 6 -> 3; 3 is odd so coarsening stops there
        assert m.ops[-1].grid == (3, 3)
        assert [o.grid for o in m.ops] == [o.grid for o in JMG.from_operator(
            jop((48, 48))).ops]

    def test_grid_independent_iterations_2d(self):
        """THE multigrid property: iteration count does not grow with n."""
        rng = np.random.default_rng(5)
        iters = {}
        for n in (64, 128, 256):
            a = top((n, n))
            b = torch.as_tensor(rng.standard_normal(n * n))
            res = pt.solve(a, b, tol=0.0, rtol=1e-8, maxiter=200,
                           m=MultigridPreconditioner.from_operator(a))
            assert bool(res.converged)
            iters[n] = int(res.iterations)
        assert iters[256] <= 25
        assert iters[256] <= iters[64] + 5

    def test_grid_independent_iterations_3d(self):
        rng = np.random.default_rng(6)
        iters = {}
        for n in (16, 32):
            a = top((n, n, n))
            b = torch.as_tensor(rng.standard_normal(n ** 3))
            res = pt.solve(a, b, tol=0.0, rtol=1e-8, maxiter=200,
                           m=MultigridPreconditioner.from_operator(a))
            assert bool(res.converged)
            iters[n] = int(res.iterations)
        assert iters[32] <= 25
        assert iters[32] <= iters[16] + 5

    def test_solution_correct(self, jax_refs):
        a = top((64, 64))
        x_true, b, *_ = jax_refs("solve", "f64-2d")
        res = pt.solve(a, torch.as_tensor(b), tol=0.0, rtol=1e-10,
                       maxiter=200, m=MultigridPreconditioner.from_operator(a))
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-7)

    def test_coarse_levels_force_xla_backend(self):
        """The finest level keeps the caller's backend (the hand kernel);
        the coarse levels run the plain torch stencil, as the JAX package
        leaves them to XLA."""
        a = top((256, 256), torch.float32, backend="pallas")
        m = MultigridPreconditioner.from_operator(a)
        assert m.ops[0] is a and m.ops[0].backend == "pallas"
        assert all(op.backend == "xla" for op in m.ops[1:])

    def test_fine_level_applied_twice_a_cycle(self, stencil_calls):
        """The pre-sweep from zero is ``w * r`` (``A 0`` is exactly zero),
        so a V-cycle applies the finest operator twice - the residual and
        the post-sweep - and an MG-PCG solve ``3 k + 2`` times: what the
        chip run asserts of B1/B2's launches."""
        for grid, name in (((32, 64), "stencil2d_apply"),
                           ((16, 8, 32), "stencil3d_apply")):
            a = top(grid, torch.float32, backend="pallas")
            m = MultigridPreconditioner.from_operator(a)
            m @ torch.ones(a.n)
            assert stencil_calls[name] == 2
            stencil_calls[name] = 0
            res = pt.solve(a, torch.ones(a.n), tol=0.0, rtol=1e-5, m=m,
                           check_every=4, engine="auto")
            assert stencil_calls[name] == 3 * int(res.iterations) + 2

    def test_jit_once(self):
        """The JAX solve is one jitted while_loop; the port's counterpart:
        the V-cycle reads nothing on the host, so an MG-PCG solve makes
        exactly the host reads of the unpreconditioned solve (one a check
        block)."""
        a = top((16, 16))
        m = MultigridPreconditioner.from_operator(a)
        b = torch.ones(a.n, dtype=torch.float64)
        with _HostReads() as reads:
            m @ b
        assert reads.n == 0
        counts = {}
        for label, mm in (("mg", m), ("none", None)):
            for k in (4, 12):
                with _HostReads() as reads:
                    res = pt.solve(a, b, tol=0.0, maxiter=k, check_every=4,
                                   m=mm)
                assert int(res.iterations) == k
                counts[label, k] = reads.n
        # two blocks more, two reads more, with m as without
        assert counts["mg", 12] - counts["mg", 4] == 2
        assert counts["mg", 4] == counts["none", 4]
        assert counts["mg", 12] == counts["none", 12]

    @pytest.mark.parametrize("key", sorted(VCYCLES))
    def test_vcycle_matches_jax(self, jax_refs, key):
        """One V-cycle of the same vector through the JAX cycle and the
        port's (carried across by ``convert``), and the port's own
        hierarchy bit for bit the carried one."""
        jm, v, want = jax_refs("vcycle", key)
        grid, dt, _ = VCYCLES[key]
        m = cross(jm)
        own = MultigridPreconditioner.from_operator(
            top(grid, torch.float64 if dt == np.float64 else torch.float32))
        assert m.n_levels == own.n_levels == jm.n_levels
        got = m @ torch.as_tensor(v)
        assert got.dtype == own.dtype
        assert torch.equal(got, own @ torch.as_tensor(v))
        tol = 1e-12 if dt == np.float64 else 1e-6
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())

    @pytest.mark.parametrize("key", sorted(SOLVES))
    def test_mg_pcg_matches_jax(self, jax_refs, key):
        x_true, b, its, status, jx = jax_refs("solve", key)
        grid, dt, rtol, _ = SOLVES[key]
        a = top(grid, torch.float64 if dt == np.float64 else torch.float32)
        res = pt.solve(a, torch.as_tensor(b), tol=0.0, rtol=rtol,
                       maxiter=200, m=MultigridPreconditioner.from_operator(a))
        assert int(res.iterations) == its and int(res.status) == status
        assert res.status_enum() is CGStatus.CONVERGED
        tol = 1e-12 if dt == np.float64 else 1e-5
        np.testing.assert_allclose(res.x.numpy(), jx, rtol=0,
                                   atol=tol * np.abs(jx).max())

    def test_engines(self, monkeypatch):
        """A multigrid ``m`` keeps ``engine="auto"`` on the general engine
        (on a Hopper card too), and the fused engines refuse it with the
        JAX package's ValueError."""
        monkeypatch.setattr(tcg, "is_hopper", lambda device: True)
        a = top((32, 64), torch.float32, backend="pallas")
        m = MultigridPreconditioner.from_operator(a)
        b = torch.ones(a.n)
        auto = pt.solve(a, b, tol=0.0, rtol=1e-5, m=m, engine="auto")
        general = pt.solve(a, b, tol=0.0, rtol=1e-5, m=m)
        assert torch.equal(auto.x, general.x)
        ja = jpoisson.poisson_2d_operator(32, 64, dtype=np.float32)
        for engine in ("streaming", "resident"):
            with pytest.raises(ValueError, match=f"engine='{engine}'"):
                pt.solve(a, b, m=m, engine=engine)
            with pytest.raises(ValueError):
                jp.solve(ja, jnp.ones(a.n, jnp.float32),
                         m=JMG.from_operator(ja), engine=engine)

    def test_refusals(self):
        csr = tpoisson.poisson_2d_csr(8, 8, device="cpu")
        with pytest.raises(TypeError, match="Stencil2D/3D"):
            MultigridPreconditioner.from_operator(csr)
        # pencil blocks build the single-device hierarchy's depth
        pencil = tpar.DistStencil3DPencil.create((16, 16, 32), (2, 2),
                                                 device="cpu")
        with tcomm.bind(tpar.make_mesh_2d((2, 2), devices=["cpu"] * 4)):
            m = MultigridPreconditioner.from_operator(pencil)
        assert m.global_ops and m.n_levels == \
            MultigridPreconditioner.from_operator(top((16, 16, 32))).n_levels


# -- the distributed cycle on an 8-shard stacked mesh -------------------------


def _dist_vs_single(grid, seed, x_tol):
    a = top(grid)
    x_true = vec(a.n, seed)
    b = a @ torch.as_tensor(x_true)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=200)
    single = pt.solve(a, b, m=MultigridPreconditioner.from_operator(a), **kw)
    mesh = tpar.make_mesh(8, devices=["cpu"] * 8)
    dist = tpar.solve_distributed(a, b, mesh=mesh, preconditioner="mg", **kw)
    assert bool(dist.converged)
    # the same hierarchy: halo-exchanging transfers and the gather
    # level make the distributed cycle the single-device one, up to the
    # order of the psums
    assert abs(int(dist.iterations) - int(single.iterations)) <= 1
    np.testing.assert_allclose(dist.x.numpy(), x_true, atol=x_tol)
    return dist, mesh


class TestDistributedMultigrid:
    def test_matches_single_device(self):
        # 64 / 8 = 8 -> 4 -> 2 locally, then (4, 8) -> (2, 4) replicated
        dist, mesh = _dist_vs_single((64, 64), 8, 1e-7)
        # one all_gather a V-cycle: k cycles and the initial one
        assert mesh.comm.counts["all_gather"] == int(dist.iterations) + 1

    def test_gather_level_restores_full_hierarchy(self):
        """Over 8 shards of a 128^2 grid the local extent halves only
        128/8=16 -> 2; the hierarchy must continue on the replicated
        global grid to the single-device depth."""
        _dist_vs_single((128, 128), 10, 1e-7)

    def test_3d_distributed(self):
        a = top((32, 32, 32))
        x_true = vec(a.n, 9)
        b = a @ torch.as_tensor(x_true)
        dist = tpar.solve_distributed(
            a, b, mesh=tpar.make_mesh(8, devices=["cpu"] * 8), tol=0.0,
            rtol=1e-9, maxiter=200, preconditioner="mg")
        assert bool(dist.converged)
        assert int(dist.iterations) <= 25
        np.testing.assert_allclose(dist.x.numpy(), x_true, atol=1e-6)

    def test_hierarchy_inside_the_shard_body(self):
        """The slab hierarchy built in the per-shard body: local levels
        of halved slabs on ``xla`` (the finest keeps ``pallas``), then the
        replicated global levels - the single-device grids."""
        from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm

        mesh = tpar.make_mesh(8, devices=["cpu"] * 8)
        local = tpar.DistStencil2D.create((128, 128), 8, backend="pallas",
                                          device="cpu")
        with tcomm.bind(mesh):
            m = MultigridPreconditioner.from_operator(local)
        single = MultigridPreconditioner.from_operator(top((128, 128)))
        assert [o.local_grid for o in m.ops] == [
            (16, 128), (8, 64), (4, 32), (2, 16)]
        assert [o.grid for o in m.global_ops] == [
            o.grid for o in single.ops[4:]]
        assert m.n_levels == single.n_levels
        assert [o.backend for o in m.ops] == ["pallas"] + ["xla"] * 3


# -- the f32 V-cycle inside the f64 lane --------------------------------------


def _scipy_solution(nx, ny, b):
    csr = tpoisson.poisson_2d_csr(nx, ny, device="cpu")
    a = sp.csr_matrix((csr.data.numpy(), csr.indices.numpy(),
                       np.asarray(csr.indptr)), shape=csr.shape)
    return spla.spsolve(a.tocsc(), b)


class TestDF64MGSingleDevice:
    def test_beats_plain_and_reaches_f64_accuracy(self, rng):
        """Far fewer iterations than plain f64 CG at the same deep
        tolerance, and the solution still lands at f64-class error (the
        f32 V-cycle does not cap accuracy)."""
        nx = ny = 64
        a = tpoisson.poisson_2d_operator(nx, ny, device="cpu")
        b = rng.standard_normal(nx * ny)
        plain = pt.cg_df64(a, b, tol=0.0, rtol=1e-11, maxiter=2000)
        mg = pt.cg_df64(a, b, tol=0.0, rtol=1e-11, maxiter=2000,
                        preconditioner="mg")
        assert bool(mg.converged)
        assert mg.status_enum() is CGStatus.CONVERGED
        assert int(mg.iterations) < int(plain.iterations) // 3
        x_true = _scipy_solution(nx, ny, b)
        err = np.max(np.abs(mg.x() - x_true)) / np.max(np.abs(x_true))
        assert err < 1e-8

    def test_grid_independent_iterations(self, rng):
        counts = []
        for nx in (32, 64, 128):
            a = tpoisson.poisson_2d_operator(nx, nx, device="cpu")
            b = rng.standard_normal(nx * nx)
            res = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=500,
                             preconditioner="mg")
            assert bool(res.converged)
            counts.append(int(res.iterations))
        assert max(counts) <= min(counts) + 4
        assert max(counts) < 40

    def test_3d(self, rng):
        grid = (16, 16, 16)
        a = tpoisson.poisson_3d_operator(*grid, device="cpu")
        b = rng.standard_normal(int(np.prod(grid)))
        plain = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=1000)
        res = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=1000,
                         preconditioner="mg")
        assert bool(res.converged)
        assert int(res.iterations) < int(plain.iterations)
        # the residual claim is real: ||b - A x|| in f64 on the host
        csr = tpoisson.poisson_3d_csr(*grid, device="cpu")
        mat = sp.csr_matrix((csr.data.numpy(), csr.indices.numpy(),
                             np.asarray(csr.indptr)), shape=csr.shape)
        r = b - mat @ res.x()
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 10

    def test_check_every_composes(self, rng):
        nx = 32
        a = tpoisson.poisson_2d_operator(nx, nx, device="cpu")
        b = rng.standard_normal(nx * nx)
        every = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=64,
                           preconditioner="mg", check_every=1)
        blocked = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=64,
                             preconditioner="mg", check_every=4)
        # blocked may overrun by up to 3 iterations but never fewer
        assert int(every.iterations) <= int(blocked.iterations) \
            <= int(every.iterations) + 3

    def test_resume_continues_trajectory(self, rng):
        nx = 32
        a = tpoisson.poisson_2d_operator(nx, nx, device="cpu")
        b = rng.standard_normal(nx * nx)
        full = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=100,
                          preconditioner="mg")
        part1 = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=5,
                           preconditioner="mg", return_checkpoint=True)
        part2 = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=100,
                           preconditioner="mg",
                           resume_from=part1.checkpoint)
        assert int(part2.iterations) == int(full.iterations)
        np.testing.assert_array_equal(part2.x_hi.numpy(), full.x_hi.numpy())
        assert torch.equal(part2.x64, full.x64)

    def test_rejections(self):
        a_csr = tpoisson.poisson_2d_csr(8, 8, device="cpu")
        b = np.ones(64)
        with pytest.raises(ValueError, match="mg"):
            pt.cg_df64(a_csr, b, preconditioner="mg")
        a = tpoisson.poisson_2d_operator(8, 8, device="cpu")
        with pytest.raises(ValueError, match="method='cg'"):
            pt.cg_df64(a, b, preconditioner="mg", method="cg1")

    def test_bf16_stencil_promoted(self, rng, stencil_calls):
        """A non-f32 stencil still builds the hierarchy in f32, and a
        ``backend="pallas"`` stencil keeps its kernel on the finest
        level."""
        a = tpoisson.poisson_2d_operator(16, 16, dtype=torch.bfloat16,
                                         backend="pallas", device="cpu")
        res = pt.cg_df64(a, rng.standard_normal(256), tol=0.0, rtol=1e-8,
                         maxiter=200, preconditioner="mg")
        assert bool(res.converged)
        assert stencil_calls["stencil2d_apply"] == \
            2 * (int(res.iterations) + 1)
