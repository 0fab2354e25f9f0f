"""The port's measured phase profiler (``telemetry.phasetrace``) against
the JAX package's.

The JAX ``tests/test_phasetrace.py`` classes that need no measurement -
``TestLinkFit``, ``TestPhaseObservations``, ``TestValidateTraceTool``
and the modeled case of ``TestPerfettoMeasured`` - run here on the port,
with the names their module looks up (``pt``, ``cal``, ``roof``,
``treport``, ``events``, ``BASE``) bound to the port's for each case.
The measured cases run on the port's own profiles of the skewed fixture
at 4 stacked CPU shards (one gather-lane profile, computed once, and an
allgather and a ring profile of an 8x8 Poisson CSR) and check
structure, never a wall-clock ratio: the kind and exchange, one link a
round of the gather schedule with the JAX schedule's shift and bytes,
``gather_bytes``/``wire_bytes`` as the JAX formulas give them, every
phase positive and finite, and a confident ``lstsq2`` fit from one
profile (exact by construction: two observations, two unknowns).  The
measured Perfetto trace of a profile equals the JAX package's trace of
the same profile JSON, and the JAX ``tools/validate_trace.py`` accepts
the port's trace files.  The card holds the measured phase times and
the (0.2, 3.0) explained-fraction bound (``chip_smoke.py``'s
``observatory`` phase).
"""
import json
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_phasetrace as jt
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.parallel import partition as jpart
from cuda_mpi_parallel_tpu.telemetry import report as jreport
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import mmio, poisson
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.parallel import partition as tpart
from cuda_mpi_parallel_tpu_torch.parallel.exchange import (
    allgather_wire_bytes,
)
from cuda_mpi_parallel_tpu_torch.telemetry import calibrate as tcal
from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
from cuda_mpi_parallel_tpu_torch.telemetry import phasetrace as tpt
from cuda_mpi_parallel_tpu_torch.telemetry import report as treport
from cuda_mpi_parallel_tpu_torch.telemetry import roofline as troof
from cuda_mpi_parallel_tpu_torch.telemetry.registry import REGISTRY

torch.set_num_threads(1)

FIXTURE = jt.FIXTURE
BASE = troof.MachineModel(**jt.BASE.to_json())


def mesh(n=4):
    return tpar.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture
def on_the_port(monkeypatch):
    """Bind the JAX test module's names to the port's."""
    for name, value in (("pt", tpt), ("cal", tcal), ("roof", troof),
                        ("treport", treport), ("events", tev),
                        ("BASE", BASE)):
        monkeypatch.setattr(jt, name, value)


@pytest.fixture(scope="module")
def fixture_profile():
    """ONE measured gather-lane profile of the skewed fixture at 4
    stacked shards, shared by every case that needs real timings."""
    a = mmio.load_matrix_market(FIXTURE, device="cpu")
    return tpt.profile_distributed(
        a, mesh=mesh(), exchange="gather", repeats=4,
        solve_iterations=50, solve_elapsed_s=0.05)


@pytest.fixture(scope="module")
def lane_profiles():
    """An allgather and a ring profile of an 8x8 Poisson CSR."""
    a = poisson.poisson_2d_csr(8, 8, device="cpu")
    return {"allgather": tpt.profile_distributed(
                a, mesh=mesh(), exchange="allgather", repeats=2),
            "ring": tpt.profile_distributed(
                a, mesh=mesh(), csr_comm="ring", repeats=2)}


@pytest.mark.usefixtures("on_the_port")
class TestPortLinkFit(jt.TestLinkFit):
    def test_round_wire_bytes_sums_to_matvec_wire(self):
        """The port's gather schedule: round bytes sum to the matvec
        wire, and equal the JAX schedule's."""
        a = mmio.load_matrix_market(FIXTURE, device="cpu")
        sched = tpart.partition_csr(a, 4, exchange="gather").halo
        per_round = sched.round_wire_bytes(8)
        assert sum(per_round) == sched.wire_bytes_per_matvec(8)
        assert len(per_round) == len(sched.rounds)
        assert all(b > 0 for b in per_round)
        jsched = jpart.partition_csr(jmmio.load_matrix_market(FIXTURE), 4,
                                     exchange="gather").halo
        assert tuple(per_round) == tuple(jsched.round_wire_bytes(8))


@pytest.mark.usefixtures("on_the_port")
class TestPortPhaseObservations(jt.TestPhaseObservations):
    pass


def _finite_positive(v):
    return math.isfinite(float(v)) and float(v) > 0


class TestProfileMeasured:
    """The port's measured profile of the skewed fixture at 4 shards."""

    def test_phases_positive_and_per_shard(self, fixture_profile):
        p = fixture_profile
        assert p.kind == "csr-gather" and p.exchange == "gather"
        assert p.spmv_s.shape == (4,)
        assert all(_finite_positive(v) for v in p.spmv_s)
        for v in (p.spmv_mesh_s, p.halo_s, p.reduction_s, p.step_s):
            assert _finite_positive(v)
        assert p.stall_factors()["spmv"] >= 1.0
        assert _finite_positive(p.explained_fraction())
        assert _finite_positive(p.explained_fraction_vs_solve())
        assert p.device == "cpu" and p.repeats == 4

    def test_links_and_bytes_match_the_jax_schedule(self, fixture_profile):
        sched = jpart.partition_csr(jmmio.load_matrix_market(FIXTURE), 4,
                                    exchange="gather").halo
        links = fixture_profile.links
        assert len(links) == len(sched.rounds) >= 2
        for link, rnd, b in zip(links, sched.rounds,
                                sched.round_wire_bytes(8)):
            assert link["shift"] == rnd.shift
            assert link["bytes"] == b
            assert _finite_positive(link["seconds"])
            assert link["bytes_per_s"] == pytest.approx(
                b / link["seconds"], rel=1e-12)
        assert fixture_profile.wire_bytes == sched.wire_bytes_per_matvec(8)
        parts = tpart.partition_csr(
            mmio.load_matrix_market(FIXTURE, device="cpu"), 4,
            exchange="gather")
        assert fixture_profile.gather_bytes \
            == int(np.asarray(parts.data).shape[1]) * (8 + 4)
        assert fixture_profile.n_local == parts.n_local

    def test_one_measured_profile_reaches_confident_lstsq2(
            self, fixture_profile):
        fit = tcal.fit_machine_model(
            tcal.observations_from_profile(fixture_profile), base=BASE,
            backend="cpu", per_link=fixture_profile.links)
        assert fit.method == "lstsq2"
        assert fit.confident
        assert len(fit.model.per_link) == len(fixture_profile.links)

    def test_to_json_shape_and_event_schema(self, fixture_profile):
        from cuda_mpi_parallel_tpu.telemetry import events as jev

        payload = fixture_profile.to_json()
        for key in ("phases", "spmv_s", "links", "stall_factors",
                    "explained_fraction", "wire_bytes", "gather_bytes",
                    "solve_s_per_iteration"):
            assert key in payload
        assert "device" not in payload
        with tev.capture() as buf:
            tpt.note_profile(fixture_profile)
        lines = [json.loads(ln) for ln in
                 buf.getvalue().strip().splitlines()]
        assert len(lines) == 1
        ev = jev.validate_event(tev.validate_event(lines[0]))
        assert ev["event"] == "phase_profile" and ev["exchange"] == "gather"
        assert REGISTRY.gauge("phase_seconds", labelnames=("phase",)
                              ).value(phase="spmv") > 0
        assert REGISTRY.gauge("phase_link_bytes_per_s",
                              labelnames=("shift",)).value(shift="1") > 0

    def test_report_phase_section(self, fixture_profile):
        rep = treport.SolveReport(
            record={"problem": "t", "status": "CONVERGED",
                    "iterations": 5, "residual_norm": 0.0},
            phase=fixture_profile.to_json())
        text = rep.to_text()
        for token in ("-- phase profile (measured) --", "per-shard spmv",
                      "link shift", "explained"):
            assert token in text
        assert rep.to_json() == jreport.SolveReport(
            record=dict(rep.record), phase=fixture_profile.to_json()
        ).to_json()
        assert text == jreport.SolveReport(
            record=dict(rep.record), phase=fixture_profile.to_json()
        ).to_text()


class TestRingAndAllgatherLanes:
    """The profiler covers every general-CSR lane."""

    def test_allgather_profile_has_no_links(self, lane_profiles):
        p = lane_profiles["allgather"]
        assert (p.kind, p.exchange, p.links) == ("csr", "allgather", ())
        assert _finite_positive(p.halo_s) and _finite_positive(
            p.spmv_mesh_s)
        assert p.wire_bytes == allgather_wire_bytes(4, p.n_local, 8)

    def test_ring_profile_measures_one_rotation_link(self, lane_profiles):
        p = lane_profiles["ring"]
        assert (p.kind, p.exchange) == ("csr-ring", "ring")
        assert len(p.links) == 1
        assert p.links[0]["shift"] == 1
        assert p.links[0]["bytes"] == p.n_local * p.itemsize
        parts = tpart.ring_partition_csr(
            poisson.poisson_2d_csr(8, 8, device="cpu"), 4)
        assert p.gather_bytes == sum(
            int(np.asarray(d).shape[1]) for d in parts.data) * (8 + 4)
        assert all(_finite_positive(v) for v in p.spmv_s)

    def test_refusals(self):
        a = mmio.load_matrix_market(FIXTURE, device="cpu")
        with pytest.raises(ValueError, match="ring-shiftell"):
            tpt.profile_distributed(a, mesh=mesh(),
                                    csr_comm="ring-shiftell")
        stencil = poisson.poisson_2d_operator(16, 16, device="cpu")
        with pytest.raises(ValueError, match="CSRMatrix"):
            tpt.profile_distributed(stencil, mesh=mesh())
        with pytest.raises(ValueError, match="repeats"):
            tpt.profile_distributed(a, mesh=mesh(), repeats=0)
        with pytest.raises(ValueError, match=">= 2 devices"):
            tpt.profile_distributed(a, mesh=mesh(1))
        with pytest.raises(ValueError, match="1-D mesh"):
            tpt.profile_distributed(a, mesh=tpar.make_mesh_2d(
                (2, 2), devices=["cpu"] * 4))
        parts = tpart.partition_csr(a, 2)
        with pytest.raises(ValueError, match="partition targets 2"):
            tpt.profile_partition(parts, mesh())


@pytest.mark.usefixtures("on_the_port")
class TestPortPerfettoMeasured(jt.TestPerfettoMeasured):
    def test_measured_trace_matches_jax(self, fixture_profile):
        payload = fixture_profile.to_json()
        ours = treport.perfetto_trace(iterations=10, elapsed_s=0.01,
                                      phase_profile=fixture_profile,
                                      label="t")
        theirs = jreport.perfetto_trace(iterations=10, elapsed_s=0.01,
                                        phase_profile=payload, label="t")
        assert ours == theirs


@pytest.mark.usefixtures("on_the_port")
class TestPortValidateTraceTool(jt.TestValidateTraceTool):
    pass


class OpRecord(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_phase_profiling_leaves_the_solve_unchanged():
    """The whole profiling pipeline (measure, publish, fit) between two
    recorded distributed solves: the same aten ops, the same bits - the
    profiler builds its own operators and never touches the cached
    solver."""
    a = poisson.poisson_2d_csr(8, 8, device="cpu")
    m = mesh()

    def solve():
        with OpRecord() as rec:
            x = tpar.solve_distributed(a, np.ones(64), mesh=m,
                                       maxiter=25).x.clone()
        return rec.ops, x

    tdist.clear_solver_cache()
    solve()                       # build the cached solver
    ops, x = solve()
    built = tdist._BUILD_COUNT[0]
    prof = tpt.profile_distributed(a, mesh=m, repeats=2)
    tpt.note_profile(prof)
    fit = tcal.fit_machine_model(tcal.observations_from_profile(prof),
                                 base=BASE, backend="cpu",
                                 per_link=prof.links)
    tcal.note_calibration(fit)
    ops2, x2 = solve()
    assert ops2 == ops and torch.equal(x2, x)
    assert tdist._BUILD_COUNT[0] == built
