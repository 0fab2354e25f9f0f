"""The port's Krylov recycling (``solver.recycle``, ``deflate=`` /
``basis=`` on ``solve``/``cg``/``cg_many``/``solve_distributed`` and
``ManyRHSDispatcher.solve``) against the JAX package's.

The JAX ``tests/test_recycle.py`` carried over, on the committed skewed
fixture (240 rows) in float64:

* the harvest math, the basis ring's refusals and the deflated lane's
  properties, within the port;
* **across the packages**: a space harvested by the JAX package crosses
  through ``convert.recycle_space_from_arrays`` - its layout token is the
  operator fingerprint, which both packages compute alike - and deflates
  the port's solve to the JAX deflated solve's count, x within
  ``1e-9 * max|x|``; the port's own harvest of the same solve keeps Ritz
  values within ``1e-6`` relative of the JAX harvest's (both solves round
  in f64, their sums in other orders);
* the JAX "jaxpr bit-identical" proofs become op-stream identities: a
  ``TorchDispatchMode`` records every aten operation of a solve, and
  ``deflate=None, basis=None`` runs the same operations as a call that
  never names them;
* the collective count per iteration (``mesh.comm.counts`` on a 4-shard
  stacked CPU mesh) unchanged by ``deflate=``.

Not carried over, each waiting for its ROADMAP item: ``TestServeRecycle``
(the serving tier, A17) and ``TestRecycleCLI`` (the CLI, A18).
``test_gather_composes`` carries ``test_plan_and_gather_compose`` over,
its ``plan="auto"`` half included.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.solver import recycle as jrec
from cuda_mpi_parallel_tpu.solver import solve as jsolve
from cuda_mpi_parallel_tpu.telemetry.flight import FlightConfig as JFlight
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import mmio as tmmio
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.solver import recycle as rec
from cuda_mpi_parallel_tpu_torch.solver import cg, cg_many, solve, solve_many
from cuda_mpi_parallel_tpu_torch.telemetry import events, health
from cuda_mpi_parallel_tpu_torch.telemetry.flight import (
    FlightConfig,
    FlightRecord,
    lanes_from_buffer,
)
from cuda_mpi_parallel_tpu_torch.telemetry.registry import REGISTRY

torch.set_num_threads(1)

FIXTURE = "tests/fixtures/skewed_spd_240.mtx"
X_TOL_F64 = 1e-9


def _fixture():
    return tmmio.load_matrix_market(FIXTURE, dtype=np.float64, device="cpu")


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _solve_kwargs(maxiter=500):
    return dict(tol=1e-8, maxiter=maxiter,
                flight=FlightConfig.for_solve(maxiter, stride=1),
                basis=rec.BasisConfig.for_solve(maxiter))


def _mesh(p=4):
    return tpar.make_mesh(p, devices=["cpu"] * p)


def _space_arrays(space):
    return {"w": np.asarray(space.w), "aw": np.asarray(space.aw),
            "chol": np.asarray(space.chol), "n": space.n, "k": space.k,
            "layout": space.layout}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX harvest and deflated solves, once a module."""
    ja = jmmio.load_matrix_market(FIXTURE, dtype=np.float64)
    src = jsolve(ja, _vec(240, 1), tol=1e-8, maxiter=500,
                 flight=JFlight.for_solve(500, stride=1),
                 basis=jrec.BasisConfig.for_solve(500))
    space, info = jrec.harvest_space(ja, src, k=8, note=False)
    b2 = _vec(240, 2)
    plain = jsolve(ja, b2, tol=1e-8, maxiter=500)
    defl = jsolve(ja, b2, tol=1e-8, maxiter=500, deflate=space)
    return dict(src=src, space=_space_arrays(space), info=info, plain=plain,
                defl=defl)


class TestBasisConfig:
    def test_validation(self):
        with pytest.raises(ValueError, match="capacity"):
            rec.BasisConfig(capacity=1)
        with pytest.raises(ValueError, match="BASIS_CAPACITY_LIMIT"):
            rec.BasisConfig(capacity=rec.BASIS_CAPACITY_LIMIT + 1)
        with pytest.raises(ValueError, match="stride"):
            rec.BasisConfig(capacity=8, stride=0)
        with pytest.raises(ValueError, match="lane"):
            rec.BasisConfig(capacity=8, lane=-1)

    def test_for_solve_caps(self):
        assert rec.BasisConfig.for_solve(10).capacity == 11
        assert rec.BasisConfig.for_solve(10_000).capacity \
            == rec.BASIS_CAPACITY_LIMIT

    def test_hashable_static(self):
        assert hash(rec.BasisConfig(capacity=8)) \
            == hash(rec.BasisConfig(capacity=8))

    def test_ring_rows_are_unit_residuals(self):
        """The ring keeps ``r / ||r||`` of the iterations it sampled, in
        its slots, and -1 where nothing was written."""
        a = _fixture()
        res = solve(a, _vec(240, 3), tol=1e-8, maxiter=500,
                    flight=FlightConfig.for_solve(500),
                    basis=rec.BasisConfig(capacity=8, stride=2))
        its, vecs = res.basis
        assert its.dtype == torch.int32 and vecs.shape == (8, 240)
        written = its.numpy() >= 0
        assert written.all() and (its.numpy() % 2 == 0).all()
        np.testing.assert_allclose(vecs.norm(dim=1).numpy(), 1.0,
                                   rtol=1e-12)


class TestHarvest:
    def test_known_spectrum_recovery(self):
        diag = np.linspace(1.0, 50.0, 64)
        a = torch.diag(torch.as_tensor(diag))
        res = solve(a, _vec(64, 4), **_solve_kwargs(200))
        assert bool(res.converged)
        space, info = rec.harvest_space(a, res, k=4, note=False)
        assert space.k == 4
        np.testing.assert_allclose(np.asarray(info.ritz), diag[:4],
                                   rtol=1e-4)
        assert max(info.quality) < 1e-2
        w, aw = space.w.numpy(), space.aw.numpy()
        assert np.linalg.norm(aw - w * np.asarray(info.ritz)) < 1e-2

    def test_harvest_matches_jax(self, jax_refs):
        """The port's harvest of the same solve: the JAX count and
        window, Ritz values within 1e-6 relative."""
        a = _fixture()
        src = solve(a, _vec(240, 1), **_solve_kwargs())
        assert int(src.iterations) == int(jax_refs["src"].iterations)
        space, info = rec.harvest_space(a, src, k=8, note=False)
        jinfo = jax_refs["info"]
        assert (info.k, info.window) == (jinfo.k, jinfo.window)
        np.testing.assert_allclose(info.ritz, jinfo.ritz, rtol=1e-6)
        assert space.layout == jax_refs["space"]["layout"]

    def test_harvest_requires_basis_and_flight(self):
        a = _fixture()
        b = _vec(240, 5)
        bare = solve(a, b, tol=1e-8, maxiter=500)
        with pytest.raises(rec.HarvestError, match="basis"):
            rec.harvest_space(a, bare, k=4)
        flight_only = solve(a, b, tol=1e-8, maxiter=500,
                            flight=FlightConfig.for_solve(500))
        with pytest.raises(rec.HarvestError, match="basis"):
            rec.harvest_space(a, flight_only, k=4)

    def test_stride_decimated_record_refuses(self):
        a = _fixture()
        res = solve(a, _vec(240, 5), tol=1e-8, maxiter=500,
                    flight=FlightConfig(capacity=128, stride=4),
                    basis=rec.BasisConfig(capacity=64, stride=4))
        with pytest.raises(rec.HarvestError, match="stride-4"):
            rec.harvest_space(a, res, k=4)

    def test_lanczos_tridiagonal_stride_refusal_names_stride1(self):
        record = FlightRecord(
            iterations=np.arange(0, 20, 2), residual_sq=np.ones(10),
            alphas=np.ones(10), betas=np.ones(10), stride=2)
        with pytest.raises(ValueError, match="stride 1"):
            health.lanczos_tridiagonal(record)

    def test_lanczos_tridiagonal_matches_full_t(self):
        a = _fixture()
        res = solve(a, _vec(240, 6), tol=1e-8, maxiter=500,
                    flight=FlightConfig.for_solve(500, stride=1))
        record = FlightRecord.from_buffer(res.flight)
        diag, off, its = health.lanczos_tridiagonal(record)
        t = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
        np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(t)),
                                   np.sort(health.ritz_values(record)),
                                   rtol=1e-10)
        assert its[0] == 0 and np.all(np.diff(its) == 1)

    def test_harvest_emits_event_and_gauges(self):
        a = _fixture()
        res = solve(a, _vec(240, 7), **_solve_kwargs())
        with events.capture() as buf:
            _, info = rec.harvest_space(a, res, k=6)
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        harvests = [e for e in lines if e["event"] == "recycle_harvest"]
        assert len(harvests) == 1
        assert harvests[0]["k"] == info.k
        assert harvests[0]["window"] == info.window
        assert REGISTRY.gauge("recycle_space_k").value() == info.k


class TestDeflatedSolve:
    def test_deflated_matches_undeflated_to_tolerance(self):
        a = _fixture()
        src = solve(a, _vec(240, 1), **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=8, note=False)
        b2 = _vec(240, 2)
        plain = solve(a, b2, tol=1e-8, maxiter=500)
        defl = solve(a, b2, tol=1e-8, maxiter=500, deflate=space)
        assert bool(defl.converged)
        assert np.max(np.abs(defl.x.numpy() - plain.x.numpy())) < 1e-6
        assert int(defl.iterations) < int(plain.iterations)

    def test_jax_space_deflates_the_port_solve(self, jax_refs):
        """A JAX-harvested space carried across deflates the port's
        solve to the JAX deflated count, x to f64 rounding."""
        a = _fixture()
        space = convert.recycle_space_from_arrays(jax_refs["space"],
                                                  device="cpu")
        b2 = _vec(240, 2)
        defl = solve(a, b2, tol=1e-8, maxiter=500, deflate=space)
        plain = solve(a, b2, tol=1e-8, maxiter=500)
        jdefl, jplain = jax_refs["defl"], jax_refs["plain"]
        assert int(plain.iterations) == int(jplain.iterations)
        assert int(defl.iterations) == int(jdefl.iterations)
        assert int(defl.status) == int(jdefl.status)
        jx = np.asarray(jdefl.x)
        assert np.abs(defl.x.numpy() - jx).max() \
            <= X_TOL_F64 * np.abs(jx).max()
        # and a distributed deflated solve of the port takes it too
        dist = tpar.solve_distributed(a, b2, mesh=_mesh(4), tol=1e-8,
                                      maxiter=500, deflate=space)
        assert int(dist.iterations) == int(jdefl.iterations)

    def test_sequence_iterations_strictly_fall(self):
        a = _fixture()
        rhs = [_vec(240, 10 + i) for i in range(5)]
        seq = rec.recycled_sequence(a, rhs[0], repeats=5, k=12,
                                    maxiter=500, tol=1e-8,
                                    rhs_for=lambda i: rhs[i])
        its = seq.iterations()
        assert its[-1] < its[0]
        assert all(b <= a_ + 1 for a_, b in zip(its, its[1:]))
        for e in seq.entries:
            assert bool(e.result.converged)
            verdict = health.assess_solve_health(
                FlightRecord.from_buffer(e.result.flight),
                converged=bool(e.result.converged))
            assert verdict.classification.name == "CONVERGED"
        summary = seq.summary()
        assert summary["final_solve_iterations"] \
            < summary["first_solve_iterations"]
        assert summary["harvest_overhead_pct"] >= 0.0
        assert len(seq.describe_lines()) == 6

    def test_preconditioned_deflation(self):
        a = _fixture()
        m = pt.JacobiPreconditioner.from_operator(a)
        src = solve(a, _vec(240, 1), m=m, **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=8, note=False)
        b2 = _vec(240, 2)
        plain = solve(a, b2, tol=1e-8, maxiter=500, m=m)
        defl = solve(a, b2, tol=1e-8, maxiter=500, m=m, deflate=space)
        assert bool(defl.converged)
        assert int(defl.iterations) <= int(plain.iterations)
        assert np.max(np.abs(defl.x.numpy() - plain.x.numpy())) < 1e-6

    def test_batched_deflation_and_lane_health(self):
        a = tpoisson.poisson_2d_csr(24, 24, dtype=np.float64, device="cpu")
        rng = np.random.default_rng(8)
        x_true = rng.standard_normal((576, 4))
        b = a.matmat(torch.as_tensor(x_true))
        kw = dict(tol=1e-8, maxiter=800,
                  flight=FlightConfig.for_solve(800, stride=1),
                  basis=rec.BasisConfig.for_solve(800))
        src = solve_many(a, b, **kw)
        space, _ = rec.harvest_space(a, src, k=8, n_rhs=4, note=False)
        x2 = rng.standard_normal((576, 4))
        b2 = a.matmat(torch.as_tensor(x2))
        plain = solve_many(a, b2, tol=1e-8, maxiter=800)
        defl = solve_many(a, b2, tol=1e-8, maxiter=800, deflate=space,
                          flight=FlightConfig.for_solve(800, stride=1))
        assert defl.converged.all()
        assert np.max(np.abs(defl.x.numpy() - x2)) < 1e-6
        assert (defl.iterations < plain.iterations).all()
        verdicts = health.assess_lanes(
            lanes_from_buffer(defl.flight, 4), converged=defl.converged,
            statuses=defl.status, iterations=defl.iterations)
        assert all(v.classification.name == "CONVERGED" for v in verdicts)

    def test_wrong_space_typed_refusal(self, jax_refs):
        a = _fixture()
        src = solve(a, _vec(240, 9), **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=4, note=False)
        other = tpoisson.poisson_2d_csr(16, 16, dtype=np.float64,
                                        device="cpu")
        with pytest.raises(rec.RecycleMismatch):
            solve(other, np.ones(256), deflate=space)
        with pytest.raises(rec.RecycleMismatch):
            solve_many(other, np.ones((256, 2)), deflate=space)
        a2 = pt.CSRMatrix.from_dense(2.0 * a.to_dense().numpy(),
                                     device="cpu")
        with pytest.raises(rec.RecycleMismatch):
            solve(a2, np.ones(240), deflate=space)
        crossed = convert.recycle_space_from_arrays(jax_refs["space"],
                                                    device="cpu")
        with pytest.raises(rec.RecycleMismatch):
            solve(a2, np.ones(240), deflate=crossed)

    def test_refusal_matrix(self):
        a = _fixture()
        b = _vec(240, 9)
        src = solve(a, b, **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=4, note=False)
        with pytest.raises(ValueError, match="method='cg'"):
            cg(a, b, method="cg1", deflate=space)
        with pytest.raises(ValueError, match="compensated"):
            cg(a, b, deflate=space, compensated=True)
        with pytest.raises(ValueError, match="flight"):
            cg(a, b, basis=rec.BasisConfig(capacity=8))
        with pytest.raises(TypeError, match="RecycleSpace"):
            cg(a, b, deflate="nope")
        with pytest.raises(ValueError, match="engine"):
            solve(a, b, engine="streaming", deflate=space)
        with pytest.raises(ValueError, match="batched"):
            solve_many(a, np.ones((240, 2)), method="block",
                       deflate=space)
        with pytest.raises(ValueError, match="flight"):
            cg_many(a, np.ones((240, 2)),
                    basis=rec.BasisConfig(capacity=8))


class _Ops(TorchDispatchMode):
    """Every aten operation a solve runs, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _op_stream(fn):
    with _Ops() as mode:
        fn()
    return mode.ops


class TestZeroPerturbation:
    """``deflate=None`` / ``basis=None`` run the very operations of a
    solve that never names them (the JAX jaxpr-identity proofs)."""

    def test_cg_deflate_off_op_stream_identical(self):
        a = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
        b = torch.ones(256, dtype=torch.float64)
        base = _op_stream(lambda: cg(a, b, maxiter=25))
        off = _op_stream(lambda: cg(a, b, maxiter=25, deflate=None,
                                    basis=None))
        assert off == base
        diag = torch.diag(torch.arange(1.0, 257.0, dtype=torch.float64))
        res = solve(diag, torch.ones(256, dtype=torch.float64),
                    **_solve_kwargs(300))
        space, _ = rec.harvest_space(diag, res, k=4, note=False)
        on = _op_stream(lambda: cg(a, b, maxiter=25, deflate=space))
        assert on != base

    def test_cg_basis_off_op_stream_identical(self):
        a = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
        b = torch.ones(256, dtype=torch.float64)
        fl = FlightConfig(capacity=7, stride=1)
        base = _op_stream(lambda: cg(a, b, maxiter=25, flight=fl))
        off = _op_stream(lambda: cg(a, b, maxiter=25, flight=fl,
                                    basis=None))
        assert off == base
        on = _op_stream(lambda: cg(a, b, maxiter=25, flight=fl,
                                   basis=rec.BasisConfig(capacity=5)))
        assert on != base
        assert cg(a, b, maxiter=25, flight=fl,
                  basis=rec.BasisConfig(capacity=5)).basis[1].shape \
            == (5, 256)

    def test_cg_many_deflate_off_op_stream_identical(self):
        a = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
        b = torch.ones((256, 3), dtype=torch.float64)
        base = _op_stream(lambda: cg_many(a, b, maxiter=25))
        off = _op_stream(lambda: cg_many(a, b, maxiter=25, deflate=None,
                                         basis=None))
        assert off == base

    def test_distributed_deflate_off_op_stream_identical(self):
        a = tpoisson.poisson_2d_csr(8, 8, dtype=np.float64, device="cpu")
        mesh = _mesh(4)

        def run(**kw):
            tpar.clear_solver_cache()
            return _op_stream(lambda: tpar.solve_distributed(
                a, np.ones(64), mesh=mesh, tol=1e-8, maxiter=200, **kw))

        assert run() == run(deflate=None, basis=None)


class TestDistributedRecycle:
    def setup_method(self):
        tpar.clear_solver_cache()

    def test_distributed_deflated_matches_and_saves_iters(self):
        a = _fixture()
        mesh = _mesh(4)
        src = tpar.solve_distributed(a, _vec(240, 1), mesh=mesh,
                                     **_solve_kwargs())
        assert src.basis[1].shape == (src.basis[1].shape[0], 240)
        space, _ = rec.harvest_space(a, src, k=8, note=False)
        b2 = _vec(240, 2)
        plain = tpar.solve_distributed(a, b2, mesh=mesh, tol=1e-8,
                                       maxiter=500)
        defl = tpar.solve_distributed(a, b2, mesh=mesh, tol=1e-8,
                                      maxiter=500, deflate=space)
        assert bool(defl.converged)
        assert int(defl.iterations) < int(plain.iterations)
        assert np.max(np.abs(defl.x.numpy() - plain.x.numpy())) < 1e-6

    @pytest.mark.parametrize("exchange", ["allgather", "gather"])
    def test_collective_count_unchanged(self, exchange):
        """The deflated solve makes the undeflated one's collectives per
        iteration (psum, ppermute and all_gather): the projection rides
        the residual psum."""
        a = _fixture()
        mesh = _mesh(4)
        src = solve(a, _vec(240, 1), **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=8, note=False)
        b = _vec(240, 3)

        def per_iteration(**kw):
            out = []
            for maxiter in (10, 20):
                mesh.comm.counts.clear()
                tpar.solve_distributed(a, b, mesh=mesh, tol=0.0,
                                       maxiter=maxiter, exchange=exchange,
                                       **kw)
                out.append(dict(mesh.comm.counts))
            return {k: out[1].get(k, 0) - out[0].get(k, 0)
                    for k in ("psum", "ppermute", "all_gather")}

        assert per_iteration(deflate=space) == per_iteration()

    def test_gather_composes(self):
        a = _fixture()
        mesh = _mesh(4)
        src = tpar.solve_distributed(a, _vec(240, 1), mesh=mesh,
                                     exchange="gather", **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=8, note=False)
        b2 = _vec(240, 2)
        plain = tpar.solve_distributed(a, b2, mesh=mesh, tol=1e-8,
                                       maxiter=500)
        defl = tpar.solve_distributed(a, b2, mesh=mesh, tol=1e-8,
                                      maxiter=500, deflate=space,
                                      exchange="gather")
        assert bool(defl.converged)
        assert np.max(np.abs(defl.x.numpy() - plain.x.numpy())) < 1e-6
        # the JAX plan="auto" half: a planned deflated solve (the space
        # lives in the caller's row order, the plan permutes it inside)
        planned = tpar.solve_distributed(a, b2, mesh=mesh, tol=1e-8,
                                         maxiter=500, deflate=space,
                                         plan="auto", exchange="gather")
        assert bool(planned.converged)
        assert np.max(np.abs(planned.x.numpy() - plain.x.numpy())) < 1e-6

    def test_distributed_refusals(self):
        a = _fixture()
        mesh = _mesh(4)
        b = _vec(240, 9)
        src = solve(a, b, **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=4, note=False)
        with pytest.raises(ValueError, match="allgather/gather"):
            tpar.solve_distributed(a, b, mesh=mesh, deflate=space,
                                   csr_comm="ring")
        with pytest.raises(ValueError, match="method='cg'"):
            tpar.solve_distributed(a, b, mesh=mesh, deflate=space,
                                   method="cg1")
        with pytest.raises(ValueError, match="fault"):
            tpar.solve_distributed(a, b, mesh=mesh, deflate=space,
                                   inject=object())
        with pytest.raises(ValueError, match="checkpoint"):
            tpar.solve_distributed(a, b, mesh=mesh, deflate=space,
                                   return_checkpoint=True)
        with pytest.raises(ValueError, match="flight"):
            tpar.solve_distributed(a, b, mesh=mesh,
                                   basis=rec.BasisConfig(capacity=8))

    def test_dispatcher_deflates_and_refuses_wrong_space(self):
        a = _fixture()
        mesh = _mesh(4)
        src = solve(a, _vec(240, 1), **_solve_kwargs())
        space, _ = rec.harvest_space(a, src, k=8, note=False)
        b = np.stack([_vec(240, 2), _vec(240, 3)], axis=1)
        disp = tpar.ManyRHSDispatcher(a, mesh=mesh, maxiter=500)
        plain = disp.solve(b, tol=1e-8)
        defl = disp.solve(b, tol=1e-8, deflate=space)
        assert defl.converged.all()
        assert (defl.iterations < plain.iterations).all()
        assert np.max(np.abs(defl.x.numpy() - plain.x.numpy())) < 1e-6
        other = tpoisson.poisson_2d_csr(16, 16, dtype=np.float64,
                                        device="cpu")
        odisp = tpar.ManyRHSDispatcher(other, mesh=mesh, maxiter=200)
        with pytest.raises(rec.RecycleMismatch):
            odisp.solve(np.ones((256, 2)), deflate=space)
        # a harvest from a batched distributed dispatch: the ring comes
        # back global, in the caller's row order
        rec_res = disp.solve(b, tol=1e-8,
                             flight=FlightConfig.for_solve(500, stride=1),
                             basis=rec.BasisConfig.for_solve(500, lane=1))
        space2, info = rec.harvest_space(a, rec_res, k=6, n_rhs=2, lane=1,
                                         note=False)
        assert space2.k == info.k == 6
