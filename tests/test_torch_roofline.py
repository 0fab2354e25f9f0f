"""The port's ``telemetry.cost``, ``telemetry.roofline`` and
``utils.tune`` against the JAX package's.

Carried over as parity cases: the JAX ``tests/test_solve_report.py``
``TestTrafficModel``/``TestAnalyze``, ``tests/test_calibrate.py``
``TestRooflineDiskCache`` (and the ``JsonCache`` envelope both packages
read), the analytic cases and ``TestDistributedCounts`` of
``tests/test_cost_accounting.py``, and ``tests/test_fem_tune.py``
``TestAutotune``.

Parity contract: the traffic model, the analytic op model and
``MachineModel``'s JSON are the JAX package's exactly (host
arithmetic); the per-iteration psum/ppermute/all_gather counts and the
``comm_bytes``/``wire_bytes`` the port records at its comm layer equal
the JAX jaxpr-derived ones (``parallel.dist_cg.last_comm_cost``) of the
same lane on the same stacked mesh - stencil slabs, the CSR allgather
and gather lanes - exactly, setup included (the JAX walk's
``psum_invariant``, a psum under jax 0.9.0, counted as a psum and its
reduced scalars' payload added back to its ``comm_bytes``, which leaves
them out).  Disk-cache tests point
``CUDA_MPI_PARALLEL_TPU_CACHE_DIR`` at ``tmp_path``.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import cuda_mpi_parallel_tpu.parallel as jpar
from cuda_mpi_parallel_tpu import telemetry as jtelemetry
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models.operators import Stencil2D as JStencil2D
from cuda_mpi_parallel_tpu.parallel import dist_cg as jdist
from cuda_mpi_parallel_tpu.telemetry import cost as jcost
from cuda_mpi_parallel_tpu.telemetry import roofline as jroof
from cuda_mpi_parallel_tpu.utils import tune as jtune

import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import mmio, poisson, random_spd
from cuda_mpi_parallel_tpu_torch.parallel.operators import DistStencil2D
from cuda_mpi_parallel_tpu_torch.solver.cg import cg
from cuda_mpi_parallel_tpu_torch.telemetry import cost
from cuda_mpi_parallel_tpu_torch.telemetry import roofline as roof
from cuda_mpi_parallel_tpu_torch.utils import tune
from cuda_mpi_parallel_tpu_torch.utils.tune import JsonCache, host_fingerprint

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
MODEL = roof.MachineModel(name="unit-test", mem_bytes_per_s=1e9,
                          flops_per_s=1e9, net_bytes_per_s=1e9,
                          source="table")
#: the lanes whose recorded counts are held to the JAX walk: (name,
#: operator kind, solve_distributed kwargs)
LANES = [("stencil", "stencil", {}),
         ("stencil-cg1", "stencil", dict(method="cg1")),
         ("stencil-ce4", "stencil", dict(check_every=4)),
         ("allgather", "csr", {}),
         ("gather", "csr", dict(exchange="gather"))]
SOLVE_KW = dict(tol=1e-10, maxiter=400)
#: scalars reduced per iteration and at setup on each lane: cg's p.Ap
#: and r.r (one at setup), cg1's two dots in one psum (two at setup)
REDUCED_SCALARS = {
    name: {"per_iteration": 2, "setup": 2 if name == "stencil-cg1" else 1}
    for name, _, _ in LANES}


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    """Measured artifacts go to this test's directory, never $HOME."""
    monkeypatch.setenv(tune.CACHE_DIR_ENV, str(tmp_path / "cache"))
    monkeypatch.setattr(roof, "_CACHED_CPU", [None])


def _problems():
    b_csr = np.random.default_rng(0).standard_normal(240)
    b_st = np.random.default_rng(11).standard_normal(16 * 12)
    return b_csr, b_st


@pytest.fixture(scope="module")
def jax_costs():
    """The JAX package's jaxpr-derived SolveCost of each lane, once."""
    ja = jmmio.load_matrix_market(FIXTURE)
    js = JStencil2D.create(16, 12, dtype=np.float64)
    b_csr, b_st = _problems()
    out = {}
    jtelemetry.force_active(True)
    try:
        for name, kind, kw in LANES:
            jdist.reset_last_comm_cost()
            a, b = (js, b_st) if kind == "stencil" else (ja, b_csr)
            jpar.solve_distributed(a, b, mesh=jpar.make_mesh(4), **SOLVE_KW,
                                   **kw)
            out[name] = jdist.last_comm_cost()[0]
    finally:
        jtelemetry.force_active(False)
    return out


# -- the traffic model and the verdict ------------------------------------------


class TestTrafficModel:
    def test_cg_traffic_hand_computed(self):
        t = roof.solve_traffic(10, 30, 4, method="cg")
        assert t["flops"] == 2 * 30 + 2 * (2 * 10) + 3 * (2 * 10)
        assert t["mem_bytes"] == ((30 * 8 + 2 * 10 * 4)
                                  + 2 * (2 * 10 * 4) + 3 * (3 * 10 * 4))

    @pytest.mark.parametrize("kw", [
        dict(method="cg"), dict(method="pipecg", n_rhs=3),
        dict(method="cg", preconditioned=True, precond_matvecs=3),
        dict(method="block", n_rhs=8)])
    def test_traffic_is_the_jax_model(self, kw):
        assert roof.solve_traffic(100, 500, 4, **kw) \
            == jroof.solve_traffic(100, 500, 4, **kw)

    def test_preconditioned_adds_work(self):
        plain = roof.solve_traffic(100, 500, 4)
        pre = roof.solve_traffic(100, 500, 4, preconditioned=True,
                                 precond_matvecs=3)
        assert pre["flops"] > plain["flops"]
        assert pre["ops"]["spmv"] == 4 and pre["ops"]["dot"] == 3

    def test_operator_nnz(self):
        a = poisson.poisson_2d_csr(8, 8, device="cpu")
        assert roof.operator_nnz(a) == int(a.nnz)
        s = pt.Stencil2D.create(8, 8, device="cpu")
        assert roof.operator_nnz(s) == 5 * 64
        s3 = pt.Stencil3D.create(4, 4, 8, device="cpu")
        assert roof.operator_nnz(s3) == 7 * 128


class TestAnalyze:
    def test_memory_bound_efficiency_exact(self):
        t = roof.solve_traffic(10, 30, 4)
        r = roof.analyze(n=10, nnz=30, itemsize=4, iterations=10,
                         elapsed_s=10 * t["mem_bytes"] / 1e9,
                         model=MODEL)
        assert r.bound == "memory"
        assert r.efficiency_pct == pytest.approx(100.0)
        assert r.arithmetic_intensity == pytest.approx(
            t["flops"] / t["mem_bytes"])

    def test_communication_bound(self):
        slow_net = roof.MachineModel(name="t", mem_bytes_per_s=1e12,
                                     flops_per_s=1e12,
                                     net_bytes_per_s=1e6, source="table")
        r = roof.analyze(n=10, nnz=30, itemsize=4, iterations=5,
                         elapsed_s=1.0, comm_bytes_per_iteration=1e6,
                         model=slow_net)
        assert r.bound == "communication"
        assert r.t_comm_s == pytest.approx(1.0)

    def test_compute_bound(self):
        m = roof.MachineModel(name="t", mem_bytes_per_s=1e15,
                              flops_per_s=1e3, net_bytes_per_s=1e15,
                              source="table")
        r = roof.analyze(n=10, nnz=30, itemsize=4, iterations=1,
                         elapsed_s=1.0, model=m)
        assert r.bound == "compute"

    def test_verdict_is_the_jax_verdict(self):
        kw = dict(n=4096, nnz=20480, itemsize=4, iterations=64,
                  elapsed_s=0.01, comm_bytes_per_iteration=512.0,
                  method="cg1")
        jmodel = jroof.MachineModel(**MODEL.to_json())
        ours = roof.analyze(model=MODEL, **kw).to_json()
        theirs = jroof.analyze(model=jmodel, **kw).to_json()
        assert ours == theirs

    def test_cpu_model_calibrates_once(self):
        m1 = roof.machine_model("cpu")
        m2 = roof.machine_model("cpu")
        assert m1 is m2
        assert m1.source == "calibrated"
        assert m1.mem_bytes_per_s > 0 and m1.flops_per_s > 0

    def test_table_models(self):
        h100 = roof._cuda_model("NVIDIA H100 80GB HBM3", 85_045_969_920)
        assert h100.source == "table"
        assert (h100.mem_bytes_per_s, h100.flops_per_s,
                h100.net_bytes_per_s) == (3.35e12, 67e12, 4.5e11)
        assert h100.hbm_bytes == 85_045_969_920
        assert h100.ridge_flops_per_byte == pytest.approx(
            h100.flops_per_s / h100.mem_bytes_per_s)
        assert roof._cuda_model("NVIDIA H100 PCIe", 8e10).mem_bytes_per_s \
            == 2.0e12
        assert roof.published_peaks("NVIDIA H100 NVL")[:3] \
            == (3.9e12, 60e12, 30e12)
        with pytest.raises(RuntimeError, match="no published peaks"):
            roof._cuda_model("NVIDIA A100-SXM4-80GB", 8e10)
        assert roof.machine_model("weird").name == "generic"
        # no TPU figure prices anything here: "tpu" is an unknown backend
        assert roof.machine_model("tpu").name == "generic"

    def test_cuda_model_follows_the_device_rule(self, monkeypatch):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                roof.machine_model()
            with pytest.raises(RuntimeError, match="CUDA"):
                roof.machine_model("cuda")

        class Props:
            total_memory = 85_045_969_920

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "NVIDIA H100 80GB HBM3")
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i=0: Props())
        monkeypatch.setattr(roof, "_CACHED_CUDA", {})
        m = roof.machine_model()
        assert m.name == "NVIDIA H100 80GB HBM3"
        assert m is roof.machine_model("cuda")
        assert m.hbm_bytes == Props.total_memory

    def test_json_roundtrip(self):
        r = roof.analyze(n=10, nnz=30, itemsize=4, iterations=2,
                         elapsed_s=0.1, model=MODEL)
        j = json.loads(json.dumps(r.to_json()))
        assert j["bound"] == r.bound
        assert j["model"]["name"] == "unit-test"
        assert "%" in r.describe()

    def test_machine_model_json_is_the_jax_json(self):
        m = dataclasses.replace(MODEL, created_at=1.5e9, hbm_bytes=8e10,
                                per_link=((1, 2e9), (2, 1e9)))
        jm = jroof.MachineModel(**m.to_json())
        assert m.to_json() == jm.to_json()
        back = json.loads(json.dumps(jm.to_json()))
        assert roof.MachineModel.from_json(back) == m
        with pytest.raises(TypeError):
            roof.MachineModel.from_json([1, 2])
        assert roof.DEFAULT_GATHER_SLOWDOWN == jroof.DEFAULT_GATHER_SLOWDOWN
        assert roof.CPU_MODEL_MAX_AGE_S == jroof.CPU_MODEL_MAX_AGE_S


class TestRooflineDiskCache:
    def test_cpu_model_round_trips_through_disk(self, tmp_path,
                                                monkeypatch):
        c = JsonCache(str(tmp_path))
        m1 = roof.machine_model("cpu", cache=c)
        assert m1.source == "calibrated"
        assert m1.created_at is not None

        def boom():  # a second call must NOT re-measure
            raise AssertionError("recalibrated despite fresh cache")

        monkeypatch.setattr(roof, "_calibrate_cpu", boom)
        m2 = roof.machine_model("cpu", cache=c)
        assert m2.created_at == pytest.approx(m1.created_at)
        assert m2.mem_bytes_per_s == pytest.approx(m1.mem_bytes_per_s)

    def test_stale_disk_model_is_remeasured(self, tmp_path):
        c = JsonCache(str(tmp_path))
        old = roof.MachineModel(
            name="cpu-calibrated", mem_bytes_per_s=1.0,
            flops_per_s=1.0, net_bytes_per_s=1.0, source="calibrated",
            created_at=time.time() - 2 * roof.CPU_MODEL_MAX_AGE_S)
        c.put(f"machine-model-cpu-{host_fingerprint()}", old.to_json(),
              created_at=old.created_at)
        fresh = roof.machine_model("cpu", cache=c)
        assert fresh.mem_bytes_per_s > 1.0

    def test_report_carries_model_age(self):
        aged = roof.MachineModel(
            name="t", mem_bytes_per_s=1e9, flops_per_s=1e9,
            source="calibrated", created_at=time.time() - 3600.0)
        r = roof.analyze(n=10, nnz=30, itemsize=4, iterations=2,
                         elapsed_s=0.1, model=aged)
        assert r.model_source == "calibrated"
        assert r.model_age_s == pytest.approx(3600.0, abs=60.0)
        assert r.to_json()["model_age_s"] == r.model_age_s
        table = roof.analyze(n=10, nnz=30, itemsize=4, iterations=2,
                             elapsed_s=0.1, model=MODEL)
        assert table.model_age_s is None

    def test_one_host_shares_one_measurement_across_packages(self,
                                                             tmp_path):
        """A CPU model the JAX package wrote is the one the port reads
        (same key, envelope and fields), and the other way round."""
        assert host_fingerprint() == jtune.host_fingerprint()
        jc, c = jtune.JsonCache(str(tmp_path)), JsonCache(str(tmp_path))
        theirs = jroof.machine_model("cpu", cache=jc)
        ours = roof.machine_model("cpu", cache=c)
        assert ours.to_json() == theirs.to_json()
        c.put("k", {"a": 1}, created_at=5.0)
        assert jc.get("k") == c.get("k") == {"created_at": 5.0,
                                             "payload": {"a": 1}}

    def test_json_cache_misses_and_staleness(self, tmp_path):
        c = JsonCache(str(tmp_path))
        assert c.get("none") is None
        c.put("old", {"v": 1}, created_at=time.time() - 100)
        assert c.get("old", max_age_s=10) is None
        assert c.get("old")["payload"] == {"v": 1}
        with open(c.path("bad"), "w") as f:
            f.write("{not json")
        assert c.get("bad") is None
        c.delete("old")
        assert c.get("old") is None
        assert c.path("a/b c") == os.path.join(str(tmp_path), "a_b_c.json")


# -- the comm-layer account -------------------------------------------------------


class TestAnalytic:
    def test_analytic_op_model(self):
        assert cost.analytic_solve_ops("cg") == \
            {"spmv": 1, "dot": 2, "axpy": 3}
        pre = cost.analytic_solve_ops("cg", preconditioned=True,
                                      precond_matvecs=3)
        assert pre["dot"] == 3 and pre["spmv"] == 4
        with pytest.raises(ValueError, match="unknown method"):
            cost.analytic_solve_ops("sor")

    def test_analytic_op_model_many_rhs(self):
        many = cost.analytic_solve_ops("batched", n_rhs=8)
        assert many == {"spmv": 1, "dot": 16, "axpy": 24}
        blk = cost.analytic_solve_ops("block", n_rhs=4)
        assert blk["spmv"] == 1 and blk["dot"] == 12
        with pytest.raises(ValueError, match="n_rhs"):
            cost.analytic_solve_ops("batched", n_rhs=0)
        for method in ("cg", "cg1", "pipecg", "minres", "batched",
                       "block"):
            assert cost.analytic_solve_ops(method, n_rhs=3) \
                == jcost.analytic_solve_ops(method, n_rhs=3)

    def test_halo_bytes_helper(self):
        assert cost.stencil_halo_bytes_per_iteration((16, 64), 8) \
            == 2 * 64 * 8
        assert cost.stencil_halo_bytes_per_iteration((8, 4, 6), 4,
                                                     matvecs_per_iteration=2) \
            == 2 * 24 * 4 * 2

    def test_single_device_solve_has_no_collectives(self):
        a = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
        sc = cost.trace_solve_cost(lambda v: cg(a, v, maxiter=50),
                                   torch.ones(256, dtype=torch.float64))
        assert len(sc.loops) == 1
        assert sc.per_iteration.collectives == 0
        assert sc.per_iteration.comm_bytes == 0

    def test_totals_formula_and_json(self):
        sc = cost.SolveCost(
            setup=cost.OpCounts(ops={"psum": 1}, comm_bytes=8),
            per_iteration=cost.OpCounts(ops={"psum": 2, "ppermute": 2},
                                        comm_bytes=1040, wire_bytes=1024),
            loops=())
        t = sc.totals(30)
        assert t.psum == 61 and t.ppermute == 60
        assert t.comm_bytes == 8 + 30 * 1040 and t.wire_bytes == 30 * 1024
        assert sc.to_json()["per_iteration"]["ops"] \
            == {"ppermute": 2, "psum": 2}
        half = sc.per_iteration.scaled(0.5)
        assert half.ops == {"psum": 1, "ppermute": 1}
        assert cost.COLLECTIVE_PRIMITIVES == jcost.COLLECTIVE_PRIMITIVES
        assert cost.EXCHANGE_PRIMITIVES == jcost.EXCHANGE_PRIMITIVES

    def test_recording_leaves_the_solve_alone(self):
        """A recorded solve gives the unrecorded solve's bits, and no
        recorder stays active after it."""
        from cuda_mpi_parallel_tpu_torch.parallel import comm

        a = pt.Stencil2D.create(16, 12, dtype=torch.float64, device="cpu")
        b = _problems()[1]
        plain = tpar.solve_distributed(a, b, mesh=mesh(4), **SOLVE_KW)
        box = []
        cost.trace_solve_cost(
            lambda: box.append(tpar.solve_distributed(
                a, b, mesh=mesh(4), **SOLVE_KW)))
        assert torch.equal(box[0].x, plain.x)
        assert comm.active_recorder() is None


class TestDistributedCounts:
    def _trace(self, method="cg", ny=64):
        m = mesh(4)
        local = DistStencil2D.create((64, ny), 4, dtype=torch.float64,
                                     device="cpu")
        b = torch.ones(64 * ny, dtype=torch.float64)

        def run():
            with tpar.comm.bind(m):
                return cg(local, b, axis_name="rows", maxiter=100,
                          method=method).x

        return cost.trace_solve_cost(run), local

    def test_stencil_cg_matches_analytic(self):
        sc, local = self._trace()
        per = sc.per_iteration
        assert per.psum == 2
        assert per.ppermute == 2
        assert per.all_gather == 0
        assert sc.setup.psum == 1
        assert sc.setup.ppermute == 0
        itemsize = local.dtype.itemsize
        halo = cost.stencil_halo_bytes_per_iteration(local.local_grid,
                                                     itemsize)
        assert per.comm_bytes == halo + 2 * itemsize
        assert per.wire_bytes == halo

    def test_cg1_single_fused_reduction(self):
        sc, _ = self._trace(method="cg1")
        assert sc.per_iteration.psum == 1
        assert sc.per_iteration.ppermute == 2

    @pytest.mark.parametrize("name,kind,kw", LANES,
                             ids=[lane[0] for lane in LANES])
    def test_lane_counts_are_the_jax_walk(self, name, kind, kw, jax_costs):
        b_csr, b_st = _problems()
        if kind == "stencil":
            a = pt.Stencil2D.create(16, 12, dtype=torch.float64,
                                    device="cpu")
            b = b_st
        else:
            a = mmio.load_matrix_market(FIXTURE, device="cpu")
            b = b_csr
        sc = cost.trace_solve_cost(
            tpar.solve_distributed, a, b, mesh=mesh(4),
            iterations_per_trip=kw.get("check_every", 1), **SOLVE_KW, **kw)
        want = jax_costs[name]
        for region in ("per_iteration", "setup"):
            ours, theirs = getattr(sc, region), getattr(want, region)
            # under jax 0.9.0 a psum inside shard_map is the primitive
            # psum_invariant, which the JAX walk counts under that name
            # and leaves out of its COLLECTIVE_PRIMITIVES - so out of
            # comm_bytes: add back the reduced scalars' f64 payload
            assert ours.psum == theirs.psum + theirs.get("psum_invariant")
            for op in ("ppermute", "all_gather"):
                assert ours.get(op) == theirs.get(op), (region, op)
            missed = REDUCED_SCALARS[name][region] * 8 \
                if theirs.get("psum_invariant") else 0
            assert ours.comm_bytes == theirs.comm_bytes + missed, region
            assert ours.wire_bytes == theirs.wire_bytes, region


# -- the autotuner --------------------------------------------------------------


class TestAutotune:
    def test_returns_valid_config(self):
        op = poisson.poisson_2d_operator(32, 32, dtype=torch.float64,
                                         device="cpu")
        b = torch.as_tensor(np.random.default_rng(0).standard_normal(1024))
        cfg = tune.autotune(op, b, iters_lo=8, iters_hi=24, repeats=1)
        assert cfg.best["method"] in ("cg", "cg1")
        assert cfg.best["check_every"] in (1, 32)
        assert np.isfinite(cfg.us_per_iter)
        # both backends swept: plain torch and the hand kernel's twin
        assert len(cfg.table) == 8
        assert any(k.startswith("backend=pallas") for k in cfg.table)
        finite = [v for v in cfg.table.values() if np.isfinite(v)]
        assert cfg.us_per_iter == pytest.approx(min(finite))

    def test_csr_format_candidates(self):
        a = poisson.poisson_2d_csr(24, 24, device="cpu")
        b = torch.as_tensor(np.random.default_rng(1).standard_normal(576))
        cfg = tune.autotune(a, b, methods=("cg",), check_everys=(1,),
                            iters_lo=8, iters_hi=24, repeats=1)
        labels = " ".join(cfg.table)
        assert "format=ell" in labels and "format=shiftell" in labels
        assert "format=dia" in labels

    def test_best_is_pure_kwargs(self):
        op = poisson.poisson_2d_operator(16, 16, dtype=torch.float64,
                                         device="cpu")
        b = torch.as_tensor(np.random.default_rng(2).standard_normal(256))
        cfg = tune.autotune(op, b, iters_lo=8, iters_hi=24, repeats=1)
        assert all(not k.startswith("_") for k in cfg.best)
        res = pt.solve(cfg.operator or op, b, rtol=1e-8, maxiter=500,
                       **cfg.best)
        assert bool(res.converged)

    def test_noisy_negative_delta_discarded(self, monkeypatch):
        times = iter([1.0, 0.5,    # candidate 1: negative delta -> discard
                      1.0, 2.0])   # candidate 2: clean 1.0 s delta
        monkeypatch.setattr(tune, "time_fn",
                            lambda fn, **kw: (next(times), None))
        op = random_spd.random_spd_dense(16, seed=0, device="cpu")
        b = torch.as_tensor(np.random.default_rng(3).standard_normal(16))
        cfg = tune.autotune(op, b, methods=("cg",), check_everys=(1, 32),
                            iters_lo=8, iters_hi=24, repeats=1)
        assert np.isnan(cfg.table["method=cg check_every=1"])
        assert cfg.best == {"method": "cg", "check_every": 32}
        assert cfg.us_per_iter > 0

    def test_all_noisy_raises(self, monkeypatch):
        monkeypatch.setattr(tune, "time_fn", lambda fn, **kw: (1.0, None))
        op = random_spd.random_spd_dense(16, seed=0, device="cpu")
        b = torch.as_tensor(np.random.default_rng(4).standard_normal(16))
        with pytest.raises(RuntimeError, match="non-positive"):
            tune.autotune(op, b, methods=("cg",), check_everys=(1,),
                          iters_lo=8, iters_hi=24, repeats=1)

    @staticmethod
    def _failing_kernel(monkeypatch, kind):
        """The candidate operator whose hand kernel (B1 behind
        ``backend="pallas"``, B8 behind ``format=shiftell``) now raises,
        and its sweep's right-hand side."""
        from cuda_mpi_parallel_tpu_torch.ops.cuda import spmv as hk_spmv
        from cuda_mpi_parallel_tpu_torch.ops.cuda import stencil as hk

        def broken(*args, **kw):
            raise RuntimeError("kernel failed to launch")

        if kind == "stencil":
            monkeypatch.setattr(hk, "stencil2d_apply", broken)
            op = poisson.poisson_2d_operator(16, 16, dtype=torch.float64,
                                             device="cpu")
            return op, "backend=pallas", torch.ones(256, dtype=torch.float64)
        monkeypatch.setattr(hk_spmv, "shift_ell_matvec", broken)
        op = poisson.poisson_2d_csr(16, 16, device="cpu")
        return op, "format=shiftell", torch.ones(256, dtype=op.dtype)

    @pytest.mark.parametrize("kind", ["stencil", "csr"])
    def test_kernel_failure_on_the_card_reaches_the_caller(
            self, monkeypatch, kind):
        """On a CUDA tensor the candidates are the hand kernels: a
        failing one propagates instead of letting a plain-torch
        candidate win the sweep (the device test forced, since this
        host has no card)."""
        op, _, b = self._failing_kernel(monkeypatch, kind)
        monkeypatch.setattr(tune, "_on_card", lambda b: True)
        with pytest.raises(RuntimeError, match="kernel failed to launch"):
            tune.autotune(op, b, methods=("cg",), check_everys=(1,),
                          iters_lo=8, iters_hi=24, repeats=1)

    @pytest.mark.parametrize("kind", ["stencil", "csr"])
    def test_kernel_failure_on_cpu_tensors_scores_nan(self, monkeypatch,
                                                      kind):
        op, label, b = self._failing_kernel(monkeypatch, kind)
        cfg = tune.autotune(op, b, methods=("cg",), check_everys=(1,),
                            iters_lo=8, iters_hi=24, repeats=1)
        failed = [k for k in cfg.table if k.startswith(label)]
        assert failed and all(np.isnan(cfg.table[k]) for k in failed)
        assert np.isfinite(cfg.us_per_iter)

    def test_solve_tuned_converges(self):
        op = poisson.poisson_2d_operator(24, 24, dtype=torch.float64,
                                         device="cpu")
        x_true = np.random.default_rng(5).standard_normal(576)
        b = op @ torch.as_tensor(x_true)
        res, cfg = tune.solve_tuned(
            op, b, tol=0.0, rtol=1e-9, maxiter=2000,
            tune_kwargs=dict(iters_lo=8, iters_hi=24, repeats=1))
        assert bool(res.converged)
        np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-6)
        again = pt.solve(cfg.operator or op, b, tol=0.0, rtol=1e-9,
                         maxiter=2000, **cfg.best)
        assert torch.equal(res.x, again.x)
        assert "autotune: best" in str(cfg)
