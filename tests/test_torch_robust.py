"""The port's fault injection, recovery and validation against the JAX
package's (``robust.inject``, ``robust.recover``, ``robust.validate``).

The JAX ``tests/test_robust.py`` carried over as parity cases (all but
``TestServeRobustness``, which rides the serving tier): the chaos matrix
on the skewed SPD fixture (240 rows, b from seed 0) over stacked CPU
meshes of 1 and 4 shards against the JAX package's virtual devices, the
single-device and many-RHS drills on the 8 x 8 Poisson CSR, the
recovery policy, the breakdown segment of a resumable solve, validation
and the zero-perturbation contract; the JAX ``tests/test_elastic.py``
``shard_loss`` drill (4 -> 3 shards); and the non-orbax parts of
``tests/test_robustness.py``: ``TestDebugNans`` with a
``TorchDispatchMode`` that fails on any non-finite float output, and
``TestShardCountInvariance``.

Parity contract: a plan's fingerprint and JSON are the JAX plan's;
statuses and iteration counts are the JAX ones at equal tolerance (each
JAX run computed once, in the module fixture ``jax_refs``); a recovered
x agrees with the clean x within ``1e-5`` on the fixture (the JAX
bound) and ``1e-8`` on the Poisson system; the untouched lanes of a
many-RHS fault are bit-equal to a clean run.  With ``fault=None``, and
with a plan that never fires, a solve runs exactly the aten operations
of a solve without the argument and gives its bits.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import cuda_mpi_parallel_tpu as jp
import cuda_mpi_parallel_tpu.parallel as jpar
import cuda_mpi_parallel_tpu.robust as jrobust
import cuda_mpi_parallel_tpu.solver as jsolver
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.utils import checkpoint as jck

import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch import robust
from cuda_mpi_parallel_tpu_torch.models import mmio, poisson
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.robust import (
    FaultPlan,
    PreemptedError,
    Preemption,
    RecoveryPolicy,
    ShardLostError,
    check_finite_problem,
    check_finite_rhs,
    solve_with_recovery,
)
from cuda_mpi_parallel_tpu_torch.solver import cg_many, solve_many
from cuda_mpi_parallel_tpu_torch.solver.cg import cg
from cuda_mpi_parallel_tpu_torch.solver.status import CGStatus
from cuda_mpi_parallel_tpu_torch.telemetry import events
from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
FIX_KW = dict(tol=1e-8, maxiter=500)
RECOVER_ATOL = 1e-5      # the JAX chaos matrix's bound on the fixture
POISSON_ATOL = 1e-8      # the JAX single-device recovery bound
CHAOS = [(site, n) for n in (1, 4) for site in ("halo", "spmv",
                                                "reduction")]


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def _status(res) -> str:
    return CGStatus(int(res.status)).name


def _its(res) -> int:
    return int(res.iterations)


def _plan(site, n):
    return dict(site=site, iteration=10, shard=0 if n == 1 else 2)


@pytest.fixture(scope="module")
def fixture_problem():
    a = mmio.load_matrix_market(FIXTURE, device="cpu")
    b = np.random.default_rng(0).standard_normal(240)
    return a, b


def _poisson_b(seed):
    a = jpoisson.poisson_2d_csr(8, 8)
    return np.asarray(a @ np.random.default_rng(seed).standard_normal(64))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference the parity cases read, once: (status,
    iterations) of each run."""
    ja = jmmio.load_matrix_market(FIXTURE)
    b = np.random.default_rng(0).standard_normal(240)
    out = {}

    def keep(key, res):
        out[key] = (_status(res), _its(res))

    meshes = {n: jpar.make_mesh(n) for n in (1, 4)}
    for n in (1, 4):
        keep(("clean", n), jpar.solve_distributed(ja, b, mesh=meshes[n],
                                                  **FIX_KW))
    for site, n in CHAOS:
        keep(("broken", site, n), jpar.solve_distributed(
            ja, b, mesh=meshes[n], inject=jrobust.FaultPlan(
                **_plan(site, n)), **FIX_KW))
    keep("ce8", jpar.solve_distributed(
        ja, b, mesh=meshes[4], check_every=8,
        inject=jrobust.FaultPlan(site="spmv", iteration=10), **FIX_KW))
    keep("gather-halo", jpar.solve_distributed(
        ja, b, mesh=meshes[4], exchange="gather",
        inject=jrobust.FaultPlan(site="halo", iteration=10, shard=1),
        **FIX_KW))
    bad = np.ones(240)
    bad[7] = np.nan
    keep("nan-b", jpar.solve_distributed(ja, bad, mesh=meshes[4], tol=1e-8,
                                         maxiter=50, validate=False))
    ra = jpoisson.poisson_2d_csr(8, 8)
    for site in ("spmv", "reduction"):
        keep(("single", site), jp.solve(
            ra, _poisson_b(1), tol=1e-9, maxiter=200,
            fault=jrobust.FaultPlan(site=site, iteration=3)))
    x_true = np.random.default_rng(3).standard_normal((64, 4))
    many = jsolver.solve_many(ra, np.asarray(ra.matmat(x_true)), tol=1e-9,
                              maxiter=200, fault=jrobust.FaultPlan(
                                  site="reduction", iteration=5, lane=2))
    out["many"] = ([s.name for s in many.status_enums()],
                   np.asarray(many.iterations).tolist())
    sticky = jrobust.solve_with_recovery(
        ra, _poisson_b(4), tol=1e-9, maxiter=200,
        policy=jrobust.RecoveryPolicy(max_restarts=2),
        inject=jrobust.FaultPlan(site="spmv", iteration=3, sticky=True))
    out["sticky"] = (sticky.attempts, sticky.restarts, sticky.recovered,
                     _status(sticky.result), _its(sticky.result))
    snap = jrobust.solve_with_recovery(
        ra, _poisson_b(5), tol=1e-10, maxiter=200,
        policy=jrobust.RecoveryPolicy(max_restarts=1, snapshot_every=10),
        inject=jrobust.FaultPlan(site="spmv", iteration=25))
    out["snapshot"] = (snap.attempts, snap.recovered, _its(snap.result))
    d = tmp_path_factory.mktemp("jax_loss")
    loss = jck.solve_resumable_distributed(
        ja, b, str(d / "loss.npz"), mesh=meshes[4], segment_iters=15,
        elastic=True, inject=jrobust.FaultPlan.parse("shard_loss:1:2"),
        **FIX_KW)
    keep("shard_loss", loss)
    return out


# -- the plan ------------------------------------------------------------------


class TestFaultPlan:
    def test_parse(self):
        p = FaultPlan.parse("halo:10")
        assert (p.site, p.iteration, p.shard) == ("halo", 10, 0)
        p = FaultPlan.parse("spmv:25:2")
        assert (p.site, p.iteration, p.shard) == ("spmv", 25, 2)

    @pytest.mark.parametrize("bad", ["halo", "nope:3", "halo:x",
                                     "halo:1:2:3", "spmv:-1"])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)

    def test_static_hashable_identity(self):
        a = FaultPlan(site="halo", iteration=10, shard=1)
        b = FaultPlan(site="halo", iteration=10, shard=1)
        assert a == b and hash(a) == hash(b)
        assert a.fingerprint() == b.fingerprint()
        assert a.fingerprint() != FaultPlan(
            site="halo", iteration=11, shard=1).fingerprint()

    @pytest.mark.parametrize("spec", [
        dict(site="halo", iteration=10),
        dict(site="spmv", iteration=25, shard=2, index=7, value="inf"),
        dict(site="reduction", iteration=5, lane=2, value="-inf"),
        dict(site="shard_loss", iteration=1, shard=2, sticky=True)])
    def test_fingerprint_and_json_are_the_jax_plans(self, spec):
        ours, theirs = FaultPlan(**spec), jrobust.FaultPlan(**spec)
        assert ours.fingerprint() == theirs.fingerprint()
        assert ours.to_json() == theirs.to_json()
        assert ours.describe() == theirs.describe()
        assert ours.host_level == theirs.host_level

    def test_after_restart(self):
        assert FaultPlan(site="spmv", iteration=3).after_restart() is None
        sticky = FaultPlan(site="spmv", iteration=3, sticky=True)
        assert sticky.after_restart() is sticky

    def test_validation(self):
        with pytest.raises(ValueError, match="site"):
            FaultPlan(site="wire", iteration=1)
        with pytest.raises(ValueError, match="value"):
            FaultPlan(site="halo", iteration=1, value="7.0")
        with pytest.raises(ValueError):
            FaultPlan(site="halo", iteration=-1)

    def test_sites_are_the_jax_sites(self):
        assert robust.FAULT_SITES == jrobust.FAULT_SITES
        assert robust.HOST_FAULT_SITES == jrobust.HOST_FAULT_SITES
        assert robust.inject.SHARD_SLOW_FACTOR \
            == jrobust.inject.SHARD_SLOW_FACTOR


# -- the chaos matrix ------------------------------------------------------------


class TestChaosMatrix:
    """Every injection site x mesh {1, 4}: typed BREAKDOWN within
    check_every of the poisoned step (the JAX count), and recovery
    reaches the fault-free answer."""

    @pytest.mark.parametrize("site,n_shards", CHAOS)
    def test_detected_and_recovered(self, site, n_shards, fixture_problem,
                                    jax_refs):
        a, b = fixture_problem
        m = mesh(n_shards)
        plan = FaultPlan(**_plan(site, n_shards))
        clean = tpar.solve_distributed(a, b, mesh=m, **FIX_KW)
        assert (_status(clean), _its(clean)) == jax_refs[("clean",
                                                          n_shards)]
        broken = tpar.solve_distributed(a, b, mesh=m, inject=plan,
                                        **FIX_KW)
        assert _status(broken) == "BREAKDOWN"
        assert 10 <= _its(broken) <= 11
        assert (_status(broken), _its(broken)) \
            == jax_refs[("broken", site, n_shards)]
        rr = solve_with_recovery(a, b, mesh=m, inject=plan, **FIX_KW)
        assert rr.recovered and rr.restarts == 1
        assert _status(rr.result) == "CONVERGED"
        err = float((rr.result.x - clean.x).abs().max())
        assert err < RECOVER_ATOL

    def test_detection_within_check_every_block(self, fixture_problem,
                                                jax_refs):
        a, b = fixture_problem
        res = tpar.solve_distributed(
            a, b, mesh=mesh(4), check_every=8,
            inject=FaultPlan(site="spmv", iteration=10), **FIX_KW)
        assert _status(res) == "BREAKDOWN"
        assert _its(res) - 10 <= 8 + 1
        assert (_status(res), _its(res)) == jax_refs["ce8"]

    def test_gather_lane_halo_fault(self, fixture_problem, jax_refs):
        a, b = fixture_problem
        res = tpar.solve_distributed(
            a, b, mesh=mesh(4), exchange="gather",
            inject=FaultPlan(site="halo", iteration=10, shard=1), **FIX_KW)
        assert (_status(res), _its(res)) == jax_refs["gather-halo"]
        assert 10 <= _its(res) <= 11

    @pytest.mark.parametrize("kw", [dict(csr_comm="ring"),
                                    dict(csr_comm="ring-shiftell"),
                                    dict(exchange="ring")])
    def test_ring_lanes_refuse(self, fixture_problem, kw):
        a, b = fixture_problem
        with pytest.raises(ValueError, match="allgather/gather"):
            tpar.solve_distributed(a, b, mesh=mesh(4), inject=FaultPlan(
                site="spmv", iteration=5), **kw)

    def test_stencil_slabs_refuse(self):
        s = pt.Stencil2D.create(16, 8, dtype=torch.float64, device="cpu")
        with pytest.raises(ValueError, match="allgather/gather"):
            tpar.solve_distributed(s, np.ones(128), mesh=mesh(2),
                                   inject=FaultPlan(site="spmv",
                                                    iteration=5))

    def test_reduction_poisons_every_shard_at_once(self, fixture_problem):
        """A reduction plan names shard 2 for the event, but the reduced
        scalar is every shard's: the loop exits at the same step with
        any target shard."""
        a, b = fixture_problem
        its = {_its(tpar.solve_distributed(
            a, b, mesh=mesh(4), inject=FaultPlan(
                site="reduction", iteration=10, shard=s), **FIX_KW))
            for s in range(4)}
        assert its == {11}

    def test_plan_refusals(self, fixture_problem):
        a, b = fixture_problem
        with pytest.raises(ValueError, match="mesh has 4"):
            tpar.solve_distributed(a, b, mesh=mesh(4), inject=FaultPlan(
                site="spmv", iteration=5, shard=4))
        with pytest.raises(ValueError, match="host-level"):
            tpar.solve_distributed(a, b, mesh=mesh(4),
                                   inject=FaultPlan.parse("shard_slow:1:1"))
        with pytest.raises(ValueError, match="host-level"):
            tpar.ManyRHSDispatcher(a, mesh=mesh(4),
                                   inject=FaultPlan.parse("shard_loss:1:0"))
        with pytest.raises(ValueError, match="host-level"):
            FaultPlan.parse("shard_loss:1:0").apply_matvec(
                None, torch.ones(4), 0)
        with pytest.raises(ValueError, match="batched"):
            tpar.ManyRHSDispatcher(a, mesh=mesh(4), method="block",
                                   inject=FaultPlan(site="spmv",
                                                    iteration=5))


# -- one device -----------------------------------------------------------------


def _poisson():
    return poisson.poisson_2d_csr(8, 8, device="cpu")


class TestSingleDevice:
    @pytest.mark.parametrize("site", ["spmv", "reduction"])
    def test_spmv_and_reduction_breakdown(self, site, jax_refs):
        res = pt.solve(_poisson(), _poisson_b(1), tol=1e-9, maxiter=200,
                       fault=FaultPlan(site=site, iteration=3))
        assert _status(res) == "BREAKDOWN"
        assert 3 <= _its(res) <= 4
        assert (_status(res), _its(res)) == jax_refs[("single", site)]

    def test_halo_refuses_without_exchange(self):
        with pytest.raises(ValueError, match="halo"):
            pt.solve(_poisson(), np.ones(64),
                     fault=FaultPlan(site="halo", iteration=3))

    @pytest.mark.parametrize("method", ["cg1", "pipecg", "minres"])
    def test_variant_methods_refuse(self, method):
        with pytest.raises(ValueError, match="method='cg'"):
            pt.solve(_poisson(), np.ones(64), method=method,
                     fault=FaultPlan(site="spmv", iteration=3))

    @pytest.mark.parametrize("engine", ["resident", "streaming"])
    def test_fused_engines_refuse(self, engine):
        op = pt.Stencil2D.create(16, 128, device="cpu")
        with events.capture() as buf:
            with pytest.raises(ValueError, match="fault injection"):
                pt.solve(op, torch.ones(op.n), engine=engine,
                         fault=FaultPlan(site="spmv", iteration=3))
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        assert [r["engine"] for r in recs
                if r["event"] == "eligibility_rejected"] == [engine]

    def test_auto_takes_the_general_loop(self):
        op = pt.Stencil2D.create(16, 128, device="cpu")
        plan = FaultPlan(site="spmv", iteration=3)
        with events.capture() as buf:
            res = pt.solve(op, torch.ones(op.n), engine="auto", fault=plan)
        assert _status(res) == "BREAKDOWN"
        sel = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if '"engine_selected"' in ln]
        assert sel[-1]["engine"] == "general"
        assert sel[-1]["fault"] == plan.fingerprint()

    def test_deflate_refuses_a_fault(self):
        a = _poisson()
        with pytest.raises(ValueError, match="fault injection"):
            cg(a, torch.ones(64, dtype=a.dtype), deflate=object(),
               fault=FaultPlan(site="spmv", iteration=3))
        with pytest.raises(ValueError, match="fault injection"):
            cg_many(a, torch.ones((64, 2), dtype=a.dtype),
                    deflate=object(),
                    fault=FaultPlan(site="spmv", iteration=3))

    def test_single_device_recovery(self):
        a = _poisson()
        x_true = np.random.default_rng(2).standard_normal(64)
        b = a @ torch.as_tensor(x_true, dtype=a.dtype)
        clean = pt.solve(a, b, tol=1e-10, maxiter=200)
        rr = solve_with_recovery(
            a, b, tol=1e-10, maxiter=200,
            inject=FaultPlan(site="reduction", iteration=5))
        assert rr.recovered
        np.testing.assert_allclose(rr.result.x.numpy(), clean.x.numpy(),
                                   atol=POISSON_ATOL)


class TestManyRHSLaneIsolation:
    def _b(self):
        a = _poisson()
        x_true = np.random.default_rng(3).standard_normal((64, 4))
        return a, a.matmat(torch.as_tensor(x_true, dtype=a.dtype))

    def test_reduction_fault_breaks_only_its_lane(self, jax_refs):
        a, b = self._b()
        plan = FaultPlan(site="reduction", iteration=5, lane=2)
        res = solve_many(a, b, tol=1e-9, maxiter=200, fault=plan)
        statuses = [s.name for s in res.status_enums()]
        assert statuses[2] == "BREAKDOWN"
        assert [s for i, s in enumerate(statuses) if i != 2] \
            == ["CONVERGED"] * 3
        iters = res.iterations.tolist()
        assert iters[2] <= 6 < iters[0]
        assert (statuses, iters) == tuple(jax_refs["many"])
        clean = solve_many(a, b, tol=1e-9, maxiter=200)
        for j in (0, 1, 3):
            assert torch.equal(res.x[:, j], clean.x[:, j])

    def test_distributed_lane_isolation(self, fixture_problem):
        """The batched distributed lane: lane 3's reduction fault breaks
        lane 3 alone; the other lanes are a clean run's bits."""
        a, _ = fixture_problem
        b = np.random.default_rng(8).standard_normal((240, 4))
        m = mesh(4)
        plan = FaultPlan(site="reduction", iteration=6, lane=3, shard=2)
        res = tpar.solve_distributed_many(a, b, mesh=m, inject=plan,
                                          **FIX_KW)
        clean = tpar.solve_distributed_many(a, b, mesh=m, **FIX_KW)
        assert [s.name for s in res.status_enums()] \
            == ["CONVERGED"] * 3 + ["BREAKDOWN"]
        for j in range(3):
            assert torch.equal(res.x[:, j], clean.x[:, j])
        disp = tpar.ManyRHSDispatcher(a, mesh=m, maxiter=500, inject=plan,
                                      exchange="gather")
        got = disp.solve(b, tol=1e-8)
        assert [s.name for s in got.status_enums()][3] == "BREAKDOWN"

    def test_block_method_refuses(self):
        with pytest.raises(ValueError, match="batched"):
            solve_many(_poisson(), np.ones((64, 2)), method="block",
                       fault=FaultPlan(site="spmv", iteration=5))


class TestRecoveryPolicy:
    def test_sticky_fault_exhausts_budget_typed(self, jax_refs):
        rr = solve_with_recovery(
            _poisson(), _poisson_b(4), tol=1e-9, maxiter=200,
            policy=RecoveryPolicy(max_restarts=2),
            inject=FaultPlan(site="spmv", iteration=3, sticky=True))
        assert not rr.recovered
        assert rr.restarts == 2 and rr.attempts == 3
        assert _status(rr.result) == "BREAKDOWN"
        assert len(rr.faults) == 3
        assert (rr.attempts, rr.restarts, rr.recovered,
                _status(rr.result), _its(rr.result)) == jax_refs["sticky"]
        assert rr.to_json()["final_status"] == "BREAKDOWN"

    def test_zero_restarts_detect_only(self):
        rr = solve_with_recovery(
            _poisson(), np.ones(64), tol=1e-9, maxiter=200,
            policy=RecoveryPolicy(max_restarts=0),
            inject=FaultPlan(site="spmv", iteration=3))
        assert not rr.recovered and rr.attempts == 1
        assert _status(rr.result) == "BREAKDOWN"

    def test_policy_validation(self):
        for bad in (dict(max_restarts=-1), dict(restart_from="best"),
                    dict(snapshot_every=0)):
            with pytest.raises(ValueError):
                RecoveryPolicy(**bad)

    def test_snapshot_every_restarts_from_finite_iterate(self, jax_refs):
        a = _poisson()
        b = _poisson_b(5)
        clean = pt.solve(a, b, tol=1e-10, maxiter=200)
        with events.capture() as buf:
            rr = solve_with_recovery(
                a, b, tol=1e-10, maxiter=200,
                policy=RecoveryPolicy(max_restarts=1, snapshot_every=10),
                inject=FaultPlan(site="spmv", iteration=25))
        seen = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.strip()]
        assert rr.recovered
        restarts = [e for e in seen if e["event"] == "solve_recovery"
                    and e["action"] == "restart"]
        assert restarts and restarts[0]["seed"] == "last_finite_segment"
        np.testing.assert_allclose(rr.result.x.numpy(), clean.x.numpy(),
                                   atol=POISSON_ATOL)
        assert (rr.attempts, rr.recovered, _its(rr.result)) \
            == jax_refs["snapshot"]

    def test_events_and_counters(self):
        from cuda_mpi_parallel_tpu_torch.telemetry.registry import REGISTRY

        with events.capture() as buf:
            solve_with_recovery(
                _poisson(), np.ones(64), tol=1e-9, maxiter=200,
                inject=FaultPlan(site="reduction", iteration=3))
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.strip()]
        faults = [events.validate_event(e) for e in recs
                  if e["event"] == "solve_fault"]
        recovs = [events.validate_event(e) for e in recs
                  if e["event"] == "solve_recovery"]
        assert faults and faults[0]["site"] == "reduction"
        assert {e["action"] for e in recovs} == {"restart", "recovered"}
        snap = REGISTRY.snapshot()
        assert "solve_breakdowns_total" in snap
        assert "solve_recoveries_total" in snap

    def test_distributed_recovery_refuses_other_lanes(self,
                                                      fixture_problem):
        a, b = fixture_problem
        with pytest.raises(ValueError, match="allgather/gather"):
            solve_with_recovery(a, b, mesh=mesh(2), csr_comm="ring")
        s = pt.Stencil2D.create(16, 8, dtype=torch.float64, device="cpu")
        with pytest.raises(ValueError, match="allgather/gather"):
            solve_with_recovery(s, np.ones(128), mesh=mesh(2))


# -- resumable solves: the breakdown segment and the shard_loss drill -----------


class TestResumableDrills:
    def test_breakdown_segment_preserves_last_good_checkpoint(
            self, fixture_problem, tmp_path):
        """A breakdown mid-segment must NOT overwrite the last good
        checkpoint with non-finite state."""
        a, b = fixture_problem
        m = mesh(4)
        path = str(tmp_path / "broke.npz")
        res = ck.solve_resumable_distributed(
            a, b, path, mesh=m, segment_iters=20,
            inject=FaultPlan(site="spmv", iteration=30, sticky=True),
            **FIX_KW)
        assert _status(res) == "BREAKDOWN"
        saved = ck.load_checkpoint(path, device="cpu")
        assert int(saved.k) == 20
        assert bool(torch.isfinite(torch.as_tensor(saved.x)).all())
        clean = tpar.solve_distributed(a, b, mesh=m, **FIX_KW)
        resumed = ck.solve_resumable_distributed(
            a, b, path, mesh=m, segment_iters=20, **FIX_KW)
        assert bool(resumed.converged)
        np.testing.assert_allclose(resumed.x.numpy(), clean.x.numpy(),
                                   atol=1e-6)

    def test_shard_loss_migration(self, fixture_problem, tmp_path,
                                  jax_refs):
        """4 -> 3 shards (an uneven split of 240 rows) at the first
        segment boundary: the JAX count, x within 1e-5 of the clean
        solve."""
        a, b = fixture_problem
        clean = tpar.solve_distributed(a, b, mesh=mesh(4), **FIX_KW)
        with events.capture() as buf:
            res = ck.solve_resumable_distributed(
                a, b, str(tmp_path / "loss.npz"), mesh=mesh(4),
                segment_iters=15, elastic=True,
                inject=FaultPlan.parse("shard_loss:1:2"), **FIX_KW)
        assert bool(res.converged)
        migs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if '"solve_migration"' in ln]
        assert len(migs) == 1 and migs[0]["reason"] == "shard_loss"
        assert migs[0]["lost_shard"] == 2
        assert migs[0]["n_shards_to"] == 3
        assert (_status(res), _its(res)) == jax_refs["shard_loss"]
        assert _its(res) == _its(clean)
        err = float((res.x - clean.x).abs().max())
        assert err < RECOVER_ATOL

    def test_host_site_refusals(self, fixture_problem, tmp_path):
        a, b = fixture_problem
        # shard_slow runs since the watchdog's port (ROADMAP item 9b,
        # tests/test_torch_watchdog.py); without a watchdog it raises the
        # JAX package's refusal
        with pytest.raises(ValueError, match="watchdog"):
            ck.solve_resumable_distributed(
                a, b, str(tmp_path / "r1.npz"), mesh=mesh(4),
                segment_iters=15, elastic=True,
                inject=FaultPlan.parse("shard_slow:1:1"), **FIX_KW)
        with pytest.raises(ShardLostError, match="elastic"):
            ck.solve_resumable_distributed(
                a, b, str(tmp_path / "r2.npz"), mesh=mesh(4),
                segment_iters=15, inject=FaultPlan.parse("shard_loss:1:1"),
                **FIX_KW)
        with pytest.raises(ValueError, match=">= 2 shards"):
            ck.solve_resumable_distributed(
                a, b, str(tmp_path / "r3.npz"), mesh=mesh(1),
                elastic=True, inject=FaultPlan.parse("shard_loss:1:0"),
                **FIX_KW)

    def test_preemption_then_resume_is_bitwise(self, fixture_problem,
                                               tmp_path):
        a, b = fixture_problem
        m = mesh(4)
        full = ck.solve_resumable_distributed(
            a, b, str(tmp_path / "full.npz"), mesh=m, segment_iters=20,
            **FIX_KW)
        path = str(tmp_path / "pre.npz")
        with pytest.raises(PreemptedError):
            ck.solve_resumable_distributed(
                a, b, path, mesh=m, segment_iters=20,
                preempt=Preemption(after_segments=1), **FIX_KW)
        resumed = ck.solve_resumable_distributed(
            a, b, path, mesh=m, segment_iters=20, **FIX_KW)
        assert _its(resumed) == _its(full)
        assert torch.equal(resumed.x, full.x)


# -- validation ------------------------------------------------------------------


class TestValidation:
    def test_check_finite_rhs(self):
        check_finite_rhs(np.ones(4))
        for bad in (np.array([1.0, np.nan]), torch.tensor([1.0, np.inf])):
            with pytest.raises(ValueError, match="non-finite"):
                check_finite_rhs(bad)
        with pytest.raises(ValueError, match="2 non-finite entries"):
            check_finite_rhs(torch.tensor([np.nan, -np.inf, 0.0]))

    def test_messages_are_the_jax_messages(self):
        b = np.array([1.0, np.nan, 2.0])
        with pytest.raises(ValueError) as ours:
            check_finite_rhs(b, what="x0")
        with pytest.raises(ValueError) as theirs:
            jrobust.check_finite_rhs(b, what="x0")
        assert str(ours.value) == str(theirs.value)

    def test_solve_distributed_rejects_nan_b(self, fixture_problem):
        a, _ = fixture_problem
        bad = np.ones(240)
        bad[7] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            tpar.solve_distributed(a, bad, mesh=mesh(4))

    def test_opt_out_reaches_typed_breakdown(self, fixture_problem,
                                             jax_refs):
        a, _ = fixture_problem
        bad = np.ones(240)
        bad[7] = np.nan
        res = tpar.solve_distributed(a, bad, mesh=mesh(4), tol=1e-8,
                                     maxiter=50, validate=False)
        assert _status(res) == "BREAKDOWN"
        assert _its(res) <= 1
        assert (_status(res), _its(res)) == jax_refs["nan-b"]

    def test_poisoned_matrix_rejected(self):
        a = _poisson()
        data = a.data.clone()
        data[3] = float("nan")
        bad = type(a).from_arrays(data, a.indices, a.indptr, device="cpu")
        with pytest.raises(ValueError, match="non-finite"):
            check_finite_problem(bad, np.ones(64))
        ja = jpoisson.poisson_2d_csr(8, 8)
        jbad = type(ja).from_arrays(data.numpy(), np.asarray(ja.indices),
                                    np.asarray(ja.indptr))
        with pytest.raises(ValueError) as theirs:
            jrobust.check_finite_problem(jbad, np.ones(64))
        with pytest.raises(ValueError) as ours:
            check_finite_problem(bad, np.ones(64))
        assert str(ours.value) == str(theirs.value)


# -- zero perturbation -------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """Every aten op a region dispatches, in order, and its host reads."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _recorded(fn):
    with _Ops() as rec:
        out = fn()
    return out, rec.ops


class TestZeroPerturbation:
    """``fault=None`` (and a plan past convergence) runs exactly the
    operations of a call that never mentions injection, and gives its
    bits; an armed plan that fires runs others."""

    def test_cg_fault_none_ops_identical(self):
        a, b = _poisson(), torch.ones(64, dtype=torch.float64)
        base, ops = _recorded(lambda: cg(a, b, maxiter=25))
        off, ops_off = _recorded(lambda: cg(a, b, maxiter=25, fault=None))
        late, ops_late = _recorded(lambda: cg(
            a, b, maxiter=25, fault=FaultPlan(site="spmv", iteration=999)))
        assert ops_off == ops and ops_late == ops
        for res in (off, late):
            assert torch.equal(res.x, base.x)
            assert _its(res) == _its(base)
        _, ops_armed = _recorded(lambda: cg(
            a, b, maxiter=25, fault=FaultPlan(site="spmv", iteration=5)))
        assert ops_armed != ops

    def test_cg_many_fault_none_ops_identical(self):
        a = _poisson()
        b = torch.ones((64, 3), dtype=torch.float64)
        base, ops = _recorded(lambda: cg_many(a, b, maxiter=25))
        _, ops_off = _recorded(lambda: cg_many(a, b, maxiter=25,
                                               fault=None))
        late, ops_late = _recorded(lambda: cg_many(
            a, b, maxiter=25,
            fault=FaultPlan(site="reduction", iteration=999)))
        assert ops_off == ops and ops_late == ops
        assert torch.equal(late.x, base.x)
        _, ops_armed = _recorded(lambda: cg_many(
            a, b, maxiter=25, fault=FaultPlan(site="reduction",
                                              iteration=5)))
        assert ops_armed != ops

    @pytest.mark.parametrize("exchange", [None, "gather"])
    @pytest.mark.parametrize("site", ["halo", "spmv", "reduction"])
    def test_distributed_unfired_plan_is_bit_equal(self, fixture_problem,
                                                   exchange, site):
        a, b = fixture_problem
        m = mesh(4)
        kw = dict(mesh=m, exchange=exchange, **FIX_KW)
        base, ops = _recorded(lambda: tpar.solve_distributed(a, b, **kw))
        late, ops_late = _recorded(lambda: tpar.solve_distributed(
            a, b, inject=FaultPlan(site=site, iteration=10_000, shard=2),
            **kw))
        assert ops_late == ops
        assert torch.equal(late.x, base.x) and _its(late) == _its(base)

    def test_armed_solve_adds_no_host_read(self, fixture_problem):
        """The plan fires on the host's step counter: an armed solve
        reads the device exactly as often as a clean one (one read a
        check block, counted as aten._local_scalar_dense calls)."""
        a, b = fixture_problem
        ce = 8
        kw = dict(mesh=mesh(4), tol=0.0, maxiter=48, check_every=ce,
                  validate=False)

        def reads(**extra):
            res, ops = _recorded(lambda: tpar.solve_distributed(
                a, b, **kw, **extra))
            return _its(res), ops.count("aten._local_scalar_dense.default")

        # a clean tol-0 solve: one predicate read per block, none at the
        # cap (maxiter stops the loop before the device is read)
        assert reads() == (48, 48 // ce)
        assert reads(inject=FaultPlan(site="spmv", iteration=99)) \
            == (48, 48 // ce)
        for site in ("halo", "spmv", "reduction"):
            its, n = reads(inject=FaultPlan(site=site, iteration=20,
                                            shard=1))
            # the firing block ends at 24; its read stops the blocks and
            # the tail's one read confirms: no read was added in a block
            assert its == 24 and n == its // ce + 2


# -- debug-NaN runs and shard-count invariance (tests/test_robustness.py) ----------


class _FailOnNonFinite(TorchDispatchMode):
    """The ``jax_debug_nans`` counterpart: any op producing a non-finite
    float output raises at once."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"non-finite output of {func}")
        return out


class TestDebugNans:
    def test_oracle_solve(self):
        a, b, x_exp = poisson.oracle_system(device="cpu")
        with _FailOnNonFinite():
            res = pt.solve(a, b)
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(x_exp),
                                   atol=1e-9)

    @pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
    def test_methods_past_exact_convergence(self, method):
        """check_every blocks run iterations past an exact solve; the
        0/0 cases must freeze, not NaN."""
        a, b, _ = poisson.oracle_system(device="cpu")
        with _FailOnNonFinite():
            res = pt.solve(a, b, check_every=8, method=method)
        assert bool(res.converged)

    def test_multigrid_solve(self):
        from cuda_mpi_parallel_tpu_torch.models.multigrid import (
            MultigridPreconditioner,
        )

        op = poisson.poisson_2d_operator(16, 16, dtype=torch.float64,
                                         device="cpu")
        m = MultigridPreconditioner.from_operator(op)
        with _FailOnNonFinite():
            res = pt.solve(op, torch.ones(256, dtype=torch.float64),
                           rtol=1e-8, tol=0.0, maxiter=100, m=m)
        assert bool(res.converged)

    def test_resident_past_exact_convergence(self):
        nx, ny = 8, 128
        op = poisson.poisson_2d_operator(nx, ny, dtype=torch.float32,
                                         device="cpu")
        x_true = torch.zeros(nx * ny)
        x_true[4 * ny + 64] = 1.0
        b = (op @ x_true).reshape(nx, ny)
        with _FailOnNonFinite():
            res = pt.cg_resident(op, b, tol=1e-6, maxiter=200,
                                 check_every=8)
        assert bool(res.converged)
        assert bool(torch.isfinite(res.x).all())


class TestShardCountInvariance:
    """The same system over 1, 2, 4 and 8 shards: the same trajectory to
    rounding."""

    @pytest.fixture(scope="class")
    def stencil(self):
        n = 32
        a = pt.Stencil2D.create(n, n, dtype=torch.float64, device="cpu")
        x_true = np.random.default_rng(51).standard_normal(n * n)
        b = a @ torch.as_tensor(x_true)
        return a, b, pt.solve(a, b, tol=0.0, rtol=1e-9, maxiter=400)

    @pytest.mark.parametrize("n_shards", [2, 4, 8])
    def test_stencil_2d(self, stencil, n_shards):
        a, b, single = stencil
        dist = tpar.solve_distributed(a, b, mesh=mesh(n_shards), tol=0.0,
                                      rtol=1e-9, maxiter=400)
        assert bool(dist.converged)
        assert abs(_its(dist) - _its(single)) <= 1
        np.testing.assert_allclose(dist.x.numpy(), single.x.numpy(),
                                   rtol=1e-9, atol=1e-11)

    @pytest.mark.parametrize("n_shards", [2, 8])
    def test_csr_ring(self, n_shards):
        import scipy.sparse as sp

        from cuda_mpi_parallel_tpu_torch.models.operators import CSRMatrix

        n = 72
        m = sp.random(n, n, density=0.08,
                      random_state=np.random.RandomState(13), format="csr")
        m = m + m.T + sp.eye(n) * (np.abs(m).sum(axis=1).max() + 1.0)
        m = m.tocsr()
        m.sort_indices()
        a = CSRMatrix.from_scipy(m, device="cpu")
        x_true = np.random.default_rng(52).standard_normal(n)
        b = torch.as_tensor(m @ x_true)
        single = pt.solve(a, b, tol=0.0, rtol=1e-10, maxiter=400)
        dist = tpar.solve_distributed(a, b, mesh=mesh(n_shards), tol=0.0,
                                      rtol=1e-10, maxiter=400,
                                      csr_comm="ring")
        assert bool(dist.converged)
        assert abs(_its(dist) - _its(single)) <= 1
        np.testing.assert_allclose(dist.x.numpy(), x_true, atol=1e-7)
