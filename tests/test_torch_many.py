"""The port's many-RHS tier (``solver.many``, the many-RHS forms of
``ops.blas1``/``ops.spmv``, the ``matmat`` overrides, the column-stack
stencil instances and ``parallel.solve_distributed_many``) against the
JAX package's.

The JAX ``tests/test_many_rhs.py`` carried over.  Two kinds of check:

* **within the port, bit for bit** - what the JAX package asserts of
  itself: ``dot_many`` / ``dot_many_compensated`` / ``axpy_many`` /
  ``xpby_many`` columns equal the single-vector ops on those columns,
  each format's ``matmat`` columns its ``matvec``, and at
  ``check_every=1`` a batched lane's ``x``, count and status equal the
  port's own single ``solve`` of that column (k = 1 and per lane; the
  JAX k = 1 lane is held to its own single solve only, ROADMAP queue C);
  a distributed batched lane equals the port's single-RHS distributed
  solve;
* **against the JAX package** - per-lane counts and statuses equal, ``x``
  within reduction-order rounding: ``1e-9 * max|x|`` in float64 (both
  round every operation in f64, the sums in another order), ``1e-4 *
  max|x|`` in float32; block-CG counts equal (the ``k x k`` Gram solves
  of both packages are LAPACK-class factorizations of the same f64
  matrices).

The JAX cases that ride later ROADMAP items are not carried over here:
``TestManyRhsCLI`` (``test_mesh4_rhs_record``,
``test_single_device_rhs_flight_record``, ``test_refusal_matrix``) waits
for the CLI (A18); ``test_plan_auto_composes`` is carried over in
tests/test_torch_balance.py.  The JAX comm-cost
account (wire bytes from the jaxpr) has no counterpart: the port counts
its collectives in ``mesh.comm.counts`` and the tests read the payloads
that ``ppermute``/``all_gather`` carry.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_mpi_parallel_tpu import solve as jsolve
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models.operators import (
    JacobiPreconditioner as JJacobi,
)
from cuda_mpi_parallel_tpu.parallel import make_mesh as jmake_mesh
from cuda_mpi_parallel_tpu.parallel import (
    solve_distributed_many as jsolve_distributed_many,
)
from cuda_mpi_parallel_tpu.solver import solve_many as jsolve_many
from cuda_mpi_parallel_tpu.telemetry.flight import FlightConfig as JFlight
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import mmio as tmmio
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops import blas1, spmv
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.solver import CGStatus, cg_many, solve_many
from cuda_mpi_parallel_tpu_torch.solver import stack_columns
from cuda_mpi_parallel_tpu_torch.telemetry.flight import (
    FlightConfig,
    FlightRecord,
    lanes_from_buffer,
)
from cuda_mpi_parallel_tpu_torch.telemetry.health import assess_lanes

tmany = sys.modules["cuda_mpi_parallel_tpu_torch.solver.many"]

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
X_TOL_F64 = 1e-9
X_TOL_F32 = 1e-4


def _x_true(n, k, seed=3, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _csr(nx, dtype=np.float64):
    """The same 2D Poisson CSR in both packages."""
    return (jpoisson.poisson_2d_csr(nx, nx, dtype=dtype),
            tpoisson.poisson_2d_csr(nx, nx, dtype=dtype, device="cpu"))


def _rhs(ja, k, seed=3, dtype=np.float64):
    """(X_true, B = A X_true) through the JAX matmat, fed to both."""
    x = _x_true(ja.shape[0], k, seed, dtype)
    return x, np.array(ja.matmat(jnp.asarray(x)))


def _fixture():
    return (jmmio.load_matrix_market(FIXTURE, dtype=np.float64),
            tmmio.load_matrix_market(FIXTURE, dtype=np.float64,
                                     device="cpu"))


def _mesh(p=4):
    return tpar.make_mesh(p, devices=["cpu"] * p)


def _lanes_like(res, jres, x_tol):
    """Per-lane counts and statuses equal, x within ``x_tol * max|x|``."""
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    jx = np.asarray(jres.x)
    assert np.abs(res.x.numpy() - jx).max() <= x_tol * np.abs(jx).max()


@pytest.fixture(scope="module")
def jax_refs():
    """Each JAX reference once a module (a JAX solve compiles for about
    a second)."""
    out = {}
    ja, _ = _csr(16)
    _, b6 = _rhs(ja, 6)
    out["lanes"] = jsolve_many(ja, b6, tol=1e-10, maxiter=500)
    out["single0"] = jsolve(ja, b6[:, 0], tol=1e-10, maxiter=500)
    m = JJacobi.from_operator(ja)
    out["single0_jacobi"] = jsolve(ja, b6[:, 0], tol=1e-10, maxiter=500,
                                   m=m)
    ja32, _ = _csr(16, np.float32)
    _, b32 = _rhs(ja32, 1, dtype=np.float32)
    out["single0_f32"] = jsolve(ja32, b32[:, 0], tol=1e-4, maxiter=500)
    ja12, _ = _csr(12)
    _, b3 = _rhs(ja12, 3)
    b3[:, 1] = 0.0
    out["zero_lane"] = jsolve_many(ja12, b3, tol=1e-10, maxiter=500)
    _, bm = _rhs(ja, 3)
    out["mixed"] = jsolve_many(ja, bm, tol=np.asarray([1e-4, 1e-8, 1e-11]),
                               maxiter=500)
    eigs = np.logspace(0, -8, 48)
    bs = np.zeros((48, 2), np.float32)
    bs[:, 0] = 1.0
    bs[:4, 1] = 1.0
    out["stagnate"] = jsolve_many(
        jnp.asarray(np.diag(eigs).astype(np.float32)), bs,
        tol=np.asarray([1e-12, 1e-5], np.float32), maxiter=400,
        flight=JFlight.for_solve(400))
    ja24, _ = _csr(24)
    _, b8 = _rhs(ja24, 8)
    out["batched24"] = jsolve_many(ja24, b8, tol=1e-9, maxiter=800)
    out["block24"] = jsolve_many(ja24, b8, tol=1e-9, maxiter=800,
                                 method="block")
    _, b4 = _rhs(ja, 4)
    out["block_jacobi"] = jsolve_many(ja, b4, tol=1e-9, maxiter=800,
                                      method="block", m=m)
    jf, _ = _fixture()
    _, bf = _rhs(jf, 8, seed=5)
    out["dist"] = jsolve_distributed_many(jf, bf, mesh=jmake_mesh(4),
                                          tol=1e-9, maxiter=500)
    return out


# -- BLAS-1 and SpMM columns ---------------------------------------------------


class TestBlas1Many:
    """Column j of every batched op equals the single-RHS op on column
    j, bit for bit (f32 and f64, plain and compensated)."""

    def _stacks(self, dtype, n=1037, k=5):
        rng = np.random.default_rng(11)
        return (torch.as_tensor(rng.standard_normal((n, k)).astype(dtype)),
                torch.as_tensor(rng.standard_normal((n, k)).astype(dtype)))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_dot_many_column_bitwise(self, dtype):
        x, y = self._stacks(dtype)
        batched = blas1.dot_many(x, y)
        for j in range(x.shape[1]):
            assert torch.equal(batched[j], blas1.dot(x[:, j], y[:, j]))
        # column-major, as the solvers keep them: contiguous columns
        xc, yc = x.t().contiguous().t(), y.t().contiguous().t()
        cm = blas1.dot_many(xc, yc)
        for j in range(x.shape[1]):
            assert torch.equal(cm[j], blas1.dot(x[:, j].contiguous(),
                                                y[:, j].contiguous()))

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_dot_many_compensated_column_bitwise(self, dtype):
        x, y = self._stacks(dtype)
        batched = blas1.dot_many_compensated(x, y)
        for j in range(x.shape[1]):
            assert torch.equal(batched[j],
                               blas1.dot_compensated(x[:, j].contiguous(),
                                                     y[:, j].contiguous()))

    def test_dot_many_compensated_beats_plain_f32(self):
        rng = np.random.default_rng(5)
        big = rng.standard_normal(4096) * 1e4
        x = np.stack([big, big], axis=1).astype(np.float32)
        y = np.stack([big, -big], axis=1).astype(np.float32)
        y[1::2, 1] = big[1::2].astype(np.float32)
        exact = np.einsum("nk,nk->k", x.astype(np.float64),
                          y.astype(np.float64))
        comp = blas1.dot_many_compensated(
            torch.as_tensor(x), torch.as_tensor(y)).double().numpy()
        plain = blas1.dot_many(torch.as_tensor(x),
                               torch.as_tensor(y)).double().numpy()
        assert np.abs(comp - exact)[1] <= np.abs(plain - exact)[1]
        assert np.abs(comp - exact)[1] <= 4 * np.abs(exact[1]) * 2 ** -24 \
            + 1e-30

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_axpy_xpby_many_column_bitwise(self, dtype):
        x, y = self._stacks(dtype)
        alpha = torch.as_tensor(np.asarray([0.37, -1.25, 3.0, 1e-3, -7.5],
                                           dtype))
        ax = blas1.axpy_many(alpha, x, y)
        xb = blas1.xpby_many(x, alpha, y)
        for j in range(x.shape[1]):
            assert torch.equal(ax[:, j],
                               blas1.axpy(alpha[j], x[:, j], y[:, j]))
            assert torch.equal(xb[:, j],
                               blas1.xpby(x[:, j], alpha[j], y[:, j]))

    def test_axpy_many_hand_checked(self):
        x = torch.tensor([[1.0, 10.0], [2.0, 20.0]])
        y = torch.tensor([[100.0, 1000.0], [200.0, 2000.0]])
        out = blas1.axpy_many(torch.tensor([2.0, -1.0]), x, y)
        np.testing.assert_array_equal(out.numpy(),
                                      [[102.0, 990.0], [204.0, 1980.0]])

    def test_gram_matches_dense(self):
        x, y = self._stacks(np.float64, n=64, k=3)
        np.testing.assert_allclose(blas1.gram(x, y).numpy(),
                                   x.numpy().T @ y.numpy(), rtol=1e-13)

    def test_mesh_reductions_one_psum(self):
        """With ``axis_name``, all k partials ride ONE psum (and the
        Gram one k x k psum), and each column equals the single dot's
        reduction over the mesh."""
        mesh = _mesh(4)
        x, y = self._stacks(np.float64, n=64, k=3)
        xc, yc = x.t().contiguous().t(), y.t().contiguous().t()
        with tcomm.bind(mesh):
            mesh.comm.counts.clear()
            got = blas1.dot_many(xc, yc, axis_name="rows")
            assert mesh.comm.counts == {"psum": 1}
            gram = blas1.gram(xc, yc, axis_name="rows")
            comp = blas1.dot_many_compensated(xc, yc, axis_name="rows")
            assert mesh.comm.counts == {"psum": 3}
            for j in range(3):
                assert torch.equal(got[j], blas1.dot(
                    xc[:, j], yc[:, j], axis_name="rows"))
                assert torch.equal(comp[j], blas1.dot_compensated(
                    xc[:, j], yc[:, j], axis_name="rows"))
        np.testing.assert_allclose(gram.numpy(), x.numpy().T @ y.numpy(),
                                   rtol=1e-13)


class TestMatmatParity:
    """SpMM formats: column j of matmat == matvec of column j, bit for
    bit; one sweep for all columns."""

    @pytest.mark.parametrize("convert", ["csr", "ell", "dia"])
    def test_assembled_formats_bitwise(self, convert):
        _, ta = _csr(12)
        a = {"csr": ta, "ell": ta.to_ell(), "dia": ta.to_dia()}[convert]
        x = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (a.shape[0], 4)))
        batched = a.matmat(x)
        assert batched.t().is_contiguous()          # column-major
        for j in range(4):
            assert torch.equal(batched[:, j], a.matvec(x[:, j]))

    def test_csr_matmat_rows_past_the_block(self):
        """Entries whose row id is past ``n_rows`` (padded blocks) fall
        outside every segment of every column, as in the matvec."""
        data = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], dtype=torch.float64)
        cols = torch.tensor([0, 1, 1, 2, 0], dtype=torch.int32)
        rows = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 2)))
        got = spmv.csr_matmat(data, cols, rows, x, 3)
        for j in range(2):
            assert torch.equal(got[:, j],
                               spmv.csr_matvec(data, cols, rows, x[:, j], 3))

    @pytest.mark.parametrize("grid", [(16, 128), (8, 8, 128), (7, 9, 5)])
    def test_stencil_matmat_one_twin_call(self, grid, monkeypatch):
        """``Stencil2D/3D.matmat`` is one call of the column-stack twin
        (on the card one launch), each column the matvec's bits; the
        JAX default vmap matmat agrees to rounding."""
        cls = pt.Stencil2D if len(grid) == 2 else pt.Stencil3D
        a = cls.create(*grid, scale=0.37, dtype=torch.float64,
                       backend="pallas", device="cpu")
        name = f"stencil{len(grid)}d_apply_cols_plain"
        calls = []
        orig = getattr(hk.stencil, name)
        monkeypatch.setattr(hk.stencil, name,
                            lambda xs, s: calls.append(1) or orig(xs, s))
        n = a.shape[0]
        x = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 3)))
        batched = a.matmat(x)
        assert calls == [1]
        for j in range(3):
            assert torch.equal(batched[:, j], a.matvec(x[:, j]))
        ja = (jpoisson.poisson_2d_operator if len(grid) == 2
              else jpoisson.poisson_3d_operator)(*grid, scale=0.37,
                                                  dtype=jnp.float64)
        np.testing.assert_allclose(batched.numpy(),
                                   np.asarray(ja.matmat(jnp.asarray(
                                       x.numpy()))), rtol=1e-14, atol=1e-14)

    def test_default_matmat_column_major(self):
        """Operators without an SpMM keep the column loop; the stack
        comes back column-major."""
        m = pt.JacobiPreconditioner.from_operator(_csr(8)[1])
        a = pt.ShiftELLMatrix.from_csr(_csr(8)[1])
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((64, 3)))
        for op in (m, a):
            y = op.matmat(x)
            for j in range(3):
                assert torch.equal(y[:, j], op.matvec(x[:, j].contiguous()))
        assert a.matmat(x).t().is_contiguous()


# -- the masked batched recurrence ---------------------------------------------


class TestMaskedBatched:
    def test_k1_bitwise_matches_solve(self, jax_refs):
        """k = 1 masked batched == the port's solve() bit for bit
        (iterates, count, status); the count is the JAX solve's."""
        ja, ta = _csr(16)
        _, b = _rhs(ja, 6)
        single = pt.solve(ta, b[:, 0], tol=1e-10, maxiter=500)
        many = solve_many(ta, b[:, :1], tol=1e-10, maxiter=500)
        assert torch.equal(single.x, many.x[:, 0])
        assert int(single.iterations) == int(many.iterations[0])
        assert int(single.status) == int(many.status[0])
        assert bool(many.converged[0])
        assert torch.equal(single.residual_norm, many.residual_norm[0])
        assert int(many.iterations[0]) \
            == int(jax_refs["single0"].iterations)

    def test_k1_bitwise_matches_solve_f32(self, jax_refs):
        ja, ta = _csr(16, np.float32)
        _, b = _rhs(ja, 1, dtype=np.float32)
        single = pt.solve(ta, b[:, 0], tol=1e-4, maxiter=500)
        many = solve_many(ta, b, tol=1e-4, maxiter=500)
        assert torch.equal(single.x, many.x[:, 0])
        assert int(single.iterations) == int(many.iterations[0]) \
            == int(jax_refs["single0_f32"].iterations)

    def test_k1_bitwise_matches_solve_jacobi(self, jax_refs):
        ja, ta = _csr(16)
        m = pt.JacobiPreconditioner.from_operator(ta)
        _, b = _rhs(ja, 6)
        single = pt.solve(ta, b[:, 0], tol=1e-10, maxiter=500, m=m)
        many = solve_many(ta, b[:, :1], tol=1e-10, maxiter=500, m=m)
        assert torch.equal(single.x, many.x[:, 0])
        assert int(single.iterations) == int(many.iterations[0]) \
            == int(jax_refs["single0_jacobi"].iterations)

    def test_lanes_bitwise_match_singles(self, jax_refs):
        """Each lane of a k = 6 batch freezes exactly where - and with
        the bits - its own single solve stops; counts and statuses are
        the JAX batch's, x to f64 rounding."""
        ja, ta = _csr(16)
        _, b = _rhs(ja, 6)
        many = solve_many(ta, b, tol=1e-10, maxiter=500)
        for j in range(6):
            single = pt.solve(ta, b[:, j], tol=1e-10, maxiter=500)
            assert torch.equal(single.x, many.x[:, j])
            assert int(single.iterations) == int(many.iterations[j])
        _lanes_like(many, jax_refs["lanes"], X_TOL_F64)
        assert many.x.shape == (256, 6)

    def test_stencil_lanes_bitwise_one_sweep(self, monkeypatch):
        """On ``Stencil2D(backend="pallas")`` (its twin here) a batched
        iteration is ONE column-stack call, and lanes 0 and k-1 are the
        single solves' bits."""
        a = pt.Stencil2D.create(16, 128, device="cpu", backend="pallas")
        x = torch.as_tensor(_x_true(a.n, 4, dtype=np.float32))
        b = a.matmat(x)
        calls = []
        orig = hk.stencil.stencil2d_apply_cols_plain
        monkeypatch.setattr(hk.stencil, "stencil2d_apply_cols_plain",
                            lambda xs, s: calls.append(1) or orig(xs, s))
        many = solve_many(a, b, rtol=1e-5, maxiter=2000)
        assert len(calls) == int(many.iterations.max())
        for j in (0, 3):
            single = pt.solve(a, b[:, j], rtol=1e-5, maxiter=2000)
            assert torch.equal(single.x, many.x[:, j])
            assert int(single.iterations) == int(many.iterations[j])

    def test_zero_rhs_lane_converges_at_iteration_zero(self, jax_refs):
        ja, ta = _csr(12)
        _, b = _rhs(ja, 3)
        b[:, 1] = 0.0
        res = solve_many(ta, b, tol=1e-10, maxiter=500)
        iters = res.iterations.numpy()
        assert iters[1] == 0 and iters[0] > 0 and iters[2] > 0
        assert res.converged.all()
        assert int(res.status[1]) == int(CGStatus.CONVERGED)
        assert torch.equal(res.x[:, 1], torch.zeros(ta.shape[0],
                                                    dtype=torch.float64))
        _lanes_like(res, jax_refs["zero_lane"], X_TOL_F64)

    def test_mixed_tolerances_freeze_per_lane(self, jax_refs):
        ja, ta = _csr(16)
        _, b = _rhs(ja, 3)
        tols = np.asarray([1e-4, 1e-8, 1e-11])
        res = solve_many(ta, b, tol=tols, maxiter=500)
        iters = res.iterations.numpy()
        assert iters[0] < iters[1] < iters[2]
        assert res.converged.all()
        assert (res.residual_norm.numpy() < tols).all()
        for j, t in enumerate(tols):
            single = pt.solve(ta, b[:, j], tol=float(t), maxiter=500)
            assert torch.equal(single.x, res.x[:, j])
            assert int(single.iterations) == int(iters[j])
        _lanes_like(res, jax_refs["mixed"], X_TOL_F64)

    def test_stagnating_lane_classified_while_others_converge(self,
                                                              jax_refs):
        eigs = np.logspace(0, -8, 48)
        a = torch.as_tensor(np.diag(eigs).astype(np.float32))
        b = np.zeros((48, 2), np.float32)
        b[:, 0] = 1.0
        b[:4, 1] = 1.0
        res = solve_many(a, b, tol=np.asarray([1e-12, 1e-5], np.float32),
                         maxiter=400, flight=FlightConfig.for_solve(400))
        conv = res.converged.numpy()
        assert not conv[0] and conv[1]
        assert int(res.status[0]) == int(CGStatus.MAXITER)
        healths = assess_lanes(lanes_from_buffer(res.flight, 2),
                               converged=res.converged, statuses=res.status,
                               iterations=res.iterations)
        # lane 0's f32 trace at kappa 1e8 is chaotic past the attainable
        # floor (its ||r|| swings 6.9 .. 175): which of MAXITER,
        # STAGNATED or DIVERGED its last rows read as follows the
        # rounding of the dense product (the JAX trace reads DIVERGED,
        # the port's MAXITER), so the per-lane verdict held here is the
        # lane's failure beside its batchmate's convergence
        assert healths[0].classification != CGStatus.CONVERGED
        assert healths[1].classification == CGStatus.CONVERGED
        jres = jax_refs["stagnate"]
        np.testing.assert_array_equal(res.iterations.numpy(),
                                      np.asarray(jres.iterations))
        np.testing.assert_array_equal(res.status.numpy(),
                                      np.asarray(jres.status))

    def test_flight_lane_records_match_single_rhs_recorder(self):
        """The batched recorder's per-lane rows carry the single-RHS
        recorder's (rr, alpha, beta) bits."""
        ja, ta = _csr(12)
        _, b = _rhs(ja, 2)
        cfg = FlightConfig.for_solve(300)
        many = solve_many(ta, b, tol=1e-9, maxiter=300, flight=cfg)
        assert many.flight.shape == (cfg.capacity, 7)
        recs = lanes_from_buffer(many.flight, 2, stride=cfg.stride)
        for j in range(2):
            single = pt.solve(ta, b[:, j], tol=1e-9, maxiter=300,
                              flight=cfg)
            srec = FlightRecord.from_buffer(single.flight,
                                            stride=cfg.stride)
            n = len(srec)
            np.testing.assert_array_equal(recs[j].iterations[:n],
                                          srec.iterations)
            np.testing.assert_array_equal(recs[j].residual_sq[:n],
                                          srec.residual_sq)
            np.testing.assert_array_equal(recs[j].alphas[1:n],
                                          srec.alphas[1:])

    def test_check_every_converges_identically_frozen(self):
        ja, ta = _csr(16)
        x_true, b = _rhs(ja, 4)
        res = solve_many(ta, b, tol=1e-10, maxiter=500, check_every=8)
        assert res.converged.all()
        assert np.max(np.abs(res.x.numpy() - x_true)) < 1e-7
        exact = solve_many(ta, b, tol=1e-10, maxiter=500)
        # a batched lane freezes at its convergence step: the blocked
        # loop's lanes are the per-iteration loop's bits
        assert torch.equal(res.x, exact.x)

    def test_compensated_batched_runs(self):
        ja, ta = _csr(12, np.float32)
        _, b = _rhs(ja, 3, dtype=np.float32)
        res = solve_many(ta, b, tol=1e-4, maxiter=500, compensated=True)
        assert res.converged.all()
        for j in (0, 2):
            single = pt.solve(ta, b[:, j], tol=1e-4, maxiter=500,
                              compensated=True)
            assert torch.equal(single.x, res.x[:, j])

    def test_host_reads_one_a_check_block(self):
        """The batched lane reads the loop predicate once a check block
        (``aten._local_scalar_dense``), as the single-RHS loop does."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten._local_scalar_dense.default:
                    Count.n += 1
                return func(*args, **(kwargs or {}))

        ja, ta = _csr(16)
        _, b = _rhs(ja, 4)
        reads = {}
        for maxiter in (16, 48):
            Count.n = 0
            with Count():
                solve_many(ta, b, tol=0.0, maxiter=maxiter, check_every=16)
            reads[maxiter] = Count.n
        assert reads[48] - reads[16] == 2

    def test_stack_columns_pads_zero_lanes(self):
        cols = [np.ones(5), 2 * np.ones(5)]
        out = stack_columns(cols, 4)
        assert out.shape == (5, 4) and (out[:, 2:] == 0).all()
        with pytest.raises(ValueError, match="do not fit"):
            stack_columns(cols, 1)

    def test_shape_and_method_validation(self):
        _, ta = _csr(8)
        with pytest.raises(ValueError, match="column stack"):
            solve_many(ta, np.ones(64))
        with pytest.raises(ValueError, match="unknown method"):
            solve_many(ta, np.ones((64, 2)), method="minres")
        with pytest.raises(ValueError, match="batched flight"):
            cg_many(ta, torch.ones((64, 2), dtype=torch.float64),
                    method="block", flight=FlightConfig(capacity=8))
        # fault= runs since its port (ROADMAP A15, test_torch_robust.py):
        # an object that is no FaultPlan fails on its fingerprint, as in
        # the JAX package
        with pytest.raises(AttributeError, match="fingerprint"):
            solve_many(ta, np.ones((64, 2)), fault=object())


# -- block CG ------------------------------------------------------------------


class TestBlockCG:
    def test_fewer_iterations_than_batched(self, jax_refs):
        """The coupled block Krylov space converges in fewer iterations
        than the independent recurrences; the counts are the JAX
        package's."""
        ja, ta = _csr(24)
        x_true, b = _rhs(ja, 8)
        batched = solve_many(ta, b, tol=1e-9, maxiter=800)
        block = solve_many(ta, b, tol=1e-9, maxiter=800, method="block")
        assert block.converged.all()
        assert not bool(block.fallback)
        assert int(block.iterations.max()) < int(batched.iterations.max())
        assert np.max(np.abs(block.x.numpy() - x_true)) < 1e-6
        _lanes_like(batched, jax_refs["batched24"], X_TOL_F64)
        np.testing.assert_array_equal(
            block.iterations.numpy(),
            np.asarray(jax_refs["block24"].iterations))

    def test_gram_collapse_deflates_in_lane(self):
        ja, ta = _csr(16)
        x_true, b = _rhs(ja, 4)
        b[:, 1] = b[:, 0]
        x_true[:, 1] = x_true[:, 0]
        res = solve_many(ta, b, tol=1e-9, maxiter=800, method="block")
        assert not bool(res.fallback)
        assert res.converged.all()
        assert np.max(np.abs(res.x.numpy() - x_true)) < 1e-6
        assert torch.equal(res.x[:, 0], res.x[:, 1])
        _, b_distinct = _rhs(ja, 4)
        distinct = solve_many(ta, b_distinct, tol=1e-9, maxiter=800,
                              method="block")
        assert int(res.iterations.max()) \
            <= int(distinct.iterations.max()) + 8

    def test_gram_breakdown_terminal_fallback_survives(self, monkeypatch):
        def broken_gram_solve(gram_mat, rhs):
            return torch.full_like(rhs, float("nan")), True

        monkeypatch.setattr(tmany, "_gram_solve", broken_gram_solve)
        ja, ta = _csr(16)
        x_true, b = _rhs(ja, 4)
        res = cg_many(ta, b, tol=1e-9, maxiter=800, method="block")
        assert bool(res.fallback)
        assert res.converged.all()
        assert np.max(np.abs(res.x.numpy() - x_true)) < 1e-6

    def test_non_spd_gram_takes_the_pseudo_inverse(self):
        """``cholesky_ex`` flags a non-SPD Gram (the JAX NaN factor) and
        the eigenvalue pseudo-inverse solves it."""
        g = torch.tensor([[1.0, 1.0], [1.0, 1.0]], dtype=torch.float64)
        rhs = torch.tensor([[2.0], [2.0]], dtype=torch.float64)
        sol, collapsed = tmany._gram_solve(g, rhs)
        assert collapsed
        np.testing.assert_allclose(sol.numpy(), [[1.0], [1.0]])
        spd = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
        sol, collapsed = tmany._gram_solve(spd, rhs)
        assert not collapsed
        np.testing.assert_allclose((spd @ sol).numpy(), rhs.numpy())

    def test_block_host_reads(self):
        """Block CG reads the loop predicate once a check block and one
        flag per Gram solve (two an iteration: the JAX ``lax.cond``
        between Cholesky and the pseudo-inverse picks by data)."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten._local_scalar_dense.default:
                    Count.n += 1
                return func(*args, **(kwargs or {}))

        ja, ta = _csr(16)
        _, b = _rhs(ja, 4)
        reads = {}
        for maxiter in (16, 48):
            Count.n = 0
            with Count():
                solve_many(ta, b, tol=0.0, maxiter=maxiter, check_every=16,
                           method="block")
            reads[maxiter] = Count.n
        assert reads[48] - reads[16] == 2 * (1 + 2 * 16)

    def test_block_with_jacobi(self, jax_refs):
        ja, ta = _csr(16)
        m = pt.JacobiPreconditioner.from_operator(ta)
        x_true, b = _rhs(ja, 4)
        res = solve_many(ta, b, tol=1e-9, maxiter=800, method="block", m=m)
        assert res.converged.all()
        assert np.max(np.abs(res.x.numpy() - x_true)) < 1e-6
        np.testing.assert_array_equal(
            res.iterations.numpy(),
            np.asarray(jax_refs["block_jacobi"].iterations))


# -- the distributed many-RHS lane ---------------------------------------------


class TestDistributedMany:
    def setup_method(self):
        tpar.clear_solver_cache()

    def _counts_per_iteration(self, fn, mesh):
        """Collectives of ``fn(maxiter)`` per iteration: the difference
        of two tol-0 runs, 8 iterations apart."""
        out = []
        for maxiter in (8, 16):
            mesh.comm.counts.clear()
            fn(maxiter)
            out.append(dict(mesh.comm.counts))
        return {k: (out[1].get(k, 0) - out[0].get(k, 0)) / 8
                for k in set(out[0]) | set(out[1])}

    @pytest.mark.parametrize("exchange", ["allgather", "gather"])
    def test_one_exchange_serves_all_columns(self, exchange, jax_refs,
                                             monkeypatch):
        """A k = 8 batched solve makes the single-RHS solve's collectives
        per iteration, each exchange carrying all 8 columns; each lane
        is the single-RHS distributed solve's bits, and the counts are
        the JAX package's."""
        jf, tf = _fixture()
        _, b = _rhs(jf, 8, seed=5)
        mesh = _mesh(4)
        many = tpar.solve_distributed_many(tf, b, mesh=mesh, tol=1e-9,
                                           maxiter=500, exchange=exchange)
        single = tpar.solve_distributed(tf, b[:, 0], mesh=mesh, tol=1e-9,
                                        maxiter=500, exchange=exchange)
        assert torch.equal(single.x, many.x[:, 0])
        assert int(single.iterations) == int(many.iterations[0])
        _lanes_like(many, jax_refs["dist"], X_TOL_F64)
        per_many = self._counts_per_iteration(
            lambda it: tpar.solve_distributed_many(
                tf, b, mesh=mesh, tol=0.0, maxiter=it, exchange=exchange),
            mesh)
        per_one = self._counts_per_iteration(
            lambda it: tpar.solve_distributed(
                tf, b[:, 0], mesh=mesh, tol=0.0, maxiter=it,
                exchange=exchange), mesh)
        assert per_many == per_one
        assert per_many["psum"] == 2
        key = "all_gather" if exchange == "allgather" else "ppermute"
        assert per_many[key] >= 1
        payloads = []
        comm = mesh.comm
        orig = getattr(comm, key)
        monkeypatch.setattr(comm, key, lambda v, *a: payloads.append(
            tuple(v.shape)) or orig(v, *a))
        tpar.solve_distributed_many(tf, b, mesh=mesh, tol=0.0, maxiter=2,
                                    exchange=exchange)
        assert payloads and all(p[-1] == 8 for p in payloads)

    def test_gather_lane_bitwise_allgather(self):
        """Extended x becomes extended X: the gather rounds carry all
        columns and give the allgather lane's bits."""
        jf, tf = _fixture()
        _, b = _rhs(jf, 4, seed=5)
        mesh = _mesh(4)
        allg = tpar.solve_distributed_many(tf, b, mesh=mesh, tol=1e-9,
                                           maxiter=500, exchange="allgather")
        gath = tpar.solve_distributed_many(tf, b, mesh=mesh, tol=1e-9,
                                           maxiter=500, exchange="gather")
        assert torch.equal(allg.x, gath.x)

    def test_block_fewer_exchanges_than_sequential(self):
        """k = 8 block CG moves fewer column-exchanges over its solve
        than 8 single solves: fewer iterations, one exchange of all 8
        columns an iteration."""
        jf, tf = _fixture()
        x_true, b = _rhs(jf, 8, seed=5)
        mesh = _mesh(4)
        mesh.comm.counts.clear()
        blk = tpar.solve_distributed_many(tf, b, mesh=mesh, tol=1e-9,
                                          maxiter=500, method="block",
                                          exchange="gather")
        columns_blk = mesh.comm.counts["ppermute"] * 8
        mesh.comm.counts.clear()
        single = tpar.solve_distributed(tf, b[:, 0], mesh=mesh, tol=1e-9,
                                        maxiter=500, exchange="gather")
        columns_seq = 8 * mesh.comm.counts["ppermute"]
        assert blk.converged.all() and bool(single.converged)
        assert columns_blk < columns_seq
        assert np.max(np.abs(blk.x.numpy() - x_true)) < 1e-6

    def test_jacobi_lanes_match_singles(self):
        jf, tf = _fixture()
        _, b = _rhs(jf, 3, seed=5)
        mesh = _mesh(4)
        many = tpar.solve_distributed_many(tf, b, mesh=mesh, tol=1e-9,
                                           maxiter=500,
                                           preconditioner="jacobi")
        single = tpar.solve_distributed(tf, b[:, 1], mesh=mesh, tol=1e-9,
                                        maxiter=500, preconditioner="jacobi")
        assert int(single.iterations) == int(many.iterations[1])
        assert torch.equal(single.x, many.x[:, 1])

    def test_dispatcher_reuses_its_solver(self):
        """One partition, many dispatches: a second batch of the same
        width builds no solver."""
        from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist

        jf, tf = _fixture()
        _, b = _rhs(jf, 2, seed=5)
        disp = tpar.ManyRHSDispatcher(tf, mesh=_mesh(4), maxiter=500)
        first = disp.solve(b, tol=1e-9)
        builds = tdist._BUILD_COUNT[0]
        second = disp.solve(b[:, ::-1].copy(), tol=1e-9)
        assert tdist._BUILD_COUNT[0] == builds
        assert torch.equal(first.x[:, 0], second.x[:, 1])
        assert len(disp.live_device_arrays()) == 4
        # memory_footprint runs since telemetry.memscope's port: the
        # JAX footprint of the same partition, its matrix bytes the
        # live tensors' exactly
        from cuda_mpi_parallel_tpu.parallel import partition as jpart
        from cuda_mpi_parallel_tpu.telemetry import memscope as jms

        fp = disp.memory_footprint(n_rhs=2, hbm_bytes=None)
        want = jms.footprint_for_partition(jpart.partition_csr(jf, 4),
                                           n_rhs=2, hbm_bytes=None)
        assert fp.to_json() == want.to_json()
        assert int(fp.matrix_bytes.sum()) == sum(
            t.numel() * t.element_size() for t in
            disp.live_device_arrays()[:3])

    def test_refusals(self):
        _, tf = _fixture()
        mesh = _mesh(4)
        s = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
        with pytest.raises(TypeError, match="CSRMatrix"):
            tpar.solve_distributed_many(s, np.ones((256, 2)), mesh=mesh)
        with pytest.raises(ValueError, match="column stack"):
            tpar.solve_distributed_many(tf, np.ones(240), mesh=mesh)
        with pytest.raises(ValueError, match="jacobi"):
            tpar.solve_distributed_many(tf, np.ones((240, 2)), mesh=mesh,
                                        preconditioner="chebyshev")
        with pytest.raises(ValueError, match="ring"):
            tpar.solve_distributed_many(tf, np.ones((240, 2)), mesh=mesh,
                                        exchange="ring")
        with pytest.raises(ValueError, match="batched flight"):
            tpar.solve_distributed_many(
                tf, np.ones((240, 2)), mesh=mesh, method="block",
                flight=FlightConfig(capacity=8))
        # plan= runs since its port (tests/test_torch_balance.py): an
        # object that is no PartitionPlan gets the JAX TypeError
        with pytest.raises(TypeError, match="PartitionPlan"):
            tpar.solve_distributed_many(tf, np.ones((240, 2)), mesh=mesh,
                                        plan=object())
        # inject= runs since its port (ROADMAP A15): the JAX TypeError
        with pytest.raises(TypeError, match="FaultPlan"):
            tpar.solve_distributed_many(tf, np.ones((240, 2)), mesh=mesh,
                                        inject=object())
