"""The port's host-side observatory - ``telemetry.tracing``,
``telemetry.slo``, ``telemetry.fleet`` and ``telemetry.report`` - against
the JAX package's.

These modules are host bookkeeping over dicts and numpy, so their test
is the JAX package's own: ``tests/test_observatory.py``'s
``TestTraceparent``, ``TestSpanForest`` and the service-free cases of
``TestSLOBurn``, ``tests/test_fleet.py``'s ``TestMergeAlgebra`` and
``TestQuantileFromBuckets``, and ``tests/test_solve_report.py``'s
``TestSolveReportText`` and ``TestPerfetto`` run here with the names
their modules look up bound to the port's.  Beside them, parity cases
feed both packages the same inputs and require equal outputs: the span
forest, orphans and rendered tree of one span stream; the ``slo_burn``
events, gauges and snapshot of one observation script on a fake clock;
the fleet merge of one pair of registry snapshots; the solve report's
JSON and text and the Perfetto trace (modeled spans from a shard report,
host sections, a flight counter track, request tracks).  The serve-tier
cases (``SolverService``) wait for the serve port.
"""
import json

import numpy as np
import pytest
import torch

import test_fleet as jt_fleet
import test_observatory as jt_obs
import test_solve_report as jt_rep
from cuda_mpi_parallel_tpu.telemetry import events as jev
from cuda_mpi_parallel_tpu.telemetry import fleet as jfleet
from cuda_mpi_parallel_tpu.telemetry import registry as jregistry
from cuda_mpi_parallel_tpu.telemetry import report as jreport
from cuda_mpi_parallel_tpu.telemetry import roofline as jroof
from cuda_mpi_parallel_tpu.telemetry import shardscope as jss
from cuda_mpi_parallel_tpu.telemetry import slo as jslo
from cuda_mpi_parallel_tpu.telemetry import tracing as jtracing
from cuda_mpi_parallel_tpu_torch import telemetry
from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
from cuda_mpi_parallel_tpu_torch.telemetry import fleet as tfleet
from cuda_mpi_parallel_tpu_torch.telemetry import registry as tregistry
from cuda_mpi_parallel_tpu_torch.telemetry import report as treport
from cuda_mpi_parallel_tpu_torch.telemetry import roofline as troof
from cuda_mpi_parallel_tpu_torch.telemetry import shardscope as tss
from cuda_mpi_parallel_tpu_torch.telemetry import slo as tslo
from cuda_mpi_parallel_tpu_torch.telemetry import tracing as ttracing

torch.set_num_threads(1)

MODEL = troof.MachineModel(**jt_rep.MODEL.to_json())


@pytest.fixture
def on_the_port(monkeypatch):
    """Bind the JAX test modules' names to the port's."""
    for name, value in (("tracing", ttracing), ("events", tev),
                        ("SLOConfig", tslo.SLOConfig),
                        ("SLOTracker", tslo.SLOTracker),
                        ("SLOWindow", tslo.SLOWindow)):
        monkeypatch.setattr(jt_obs, name, value)
    for name, value in (("fleet", tfleet),
                        ("MetricsRegistry", tregistry.MetricsRegistry),
                        ("quantile_from_buckets",
                         tregistry.quantile_from_buckets)):
        monkeypatch.setattr(jt_fleet, name, value)
    for name, value in (("treport", treport), ("roof", troof),
                        ("ss", tss), ("MODEL", MODEL)):
        monkeypatch.setattr(jt_rep, name, value)


@pytest.mark.usefixtures("on_the_port")
class TestPortTraceparent(jt_obs.TestTraceparent):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortSpanForest(jt_obs.TestSpanForest):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortSLOBurn:
    """The service-free cases of the JAX ``TestSLOBurn``."""

    _config = jt_obs.TestSLOBurn._config
    test_burn_trips_edge_triggered_and_rearms = \
        jt_obs.TestSLOBurn.test_burn_trips_edge_triggered_and_rearms
    test_min_samples_floor_suppresses_cold_start = \
        jt_obs.TestSLOBurn.test_min_samples_floor_suppresses_cold_start
    test_burn_rate_hook_and_unknown_flow = \
        jt_obs.TestSLOBurn.test_burn_rate_hook_and_unknown_flow

    def test_invalid_configs_rejected(self):
        with pytest.raises(ValueError, match="at least one window"):
            tslo.SLOConfig(windows=())
        with pytest.raises(ValueError, match="budget"):
            tslo.SLOConfig(budget=0.0)
        with pytest.raises(ValueError, match="seconds"):
            tslo.SLOWindow("w", 0.0, 1.0)
        with pytest.raises(ValueError, match="min_samples"):
            tslo.SLOConfig(min_samples=0)


@pytest.mark.usefixtures("on_the_port")
class TestPortMergeAlgebra(jt_fleet.TestMergeAlgebra):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortQuantileFromBuckets(jt_fleet.TestQuantileFromBuckets):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortSolveReportText(jt_rep.TestSolveReportText):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortPerfetto(jt_rep.TestPerfetto):
    pass


def test_the_telemetry_package_resolves_every_jax_name():
    import cuda_mpi_parallel_tpu.telemetry as jtel

    assert set(jtel.__all__) <= set(telemetry.__all__)
    for name in jtel.__all__:
        assert getattr(telemetry, name) is not None


# -- parity: tracing -------------------------------------------------------------


def _span_records(tracing, events):
    """Two requests' span chains (one with a retry parented to its
    root), as parsed JSON records."""
    with events.capture() as buf:
        for rid, t0 in (("r-1", 0.0), ("r-2", 0.25)):
            tr = tracing.RequestTrace(rid)
            root = tr.span("submit", start_s=t0, duration_s=0.0, root=True)
            tr.span("admission", start_s=t0, duration_s=0.0,
                    decision="accepted")
            tr.span("queue_wait", start_s=t0, duration_s=0.5)
            tr.span("solve", start_s=t0 + 0.5, duration_s=0.125,
                    solve_id=7, attempt=0)
            tr.span("retry", start_s=t0 + 0.625, duration_s=0.0,
                    parent=root, reason="ERROR")
            tr.span("result", start_s=t0 + 0.75, duration_s=0.0,
                    status="CONVERGED")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]


def _ids_renamed(records):
    """Records with their trace/span ids renamed by first appearance, so
    two packages' streams (each with its own random id prefix) compare."""
    names = {}

    def rename(v):
        return None if v is None else names.setdefault(v, f"id{len(names)}")

    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("t", "traceparent")}
        for key in ("trace_id", "span_id", "parent_span_id"):
            r[key] = rename(r.get(key))
        out.append(r)
    return out


def test_span_streams_and_forests_match_jax():
    ours = _span_records(ttracing, tev)
    theirs = _span_records(jtracing, jev)
    for r in ours:
        jev.validate_event(r)
    assert _ids_renamed(ours) == _ids_renamed(theirs)
    # each package's analysis of ONE stream agrees
    for recs in (ours, theirs):
        assert ttracing.orphan_spans(recs) == jtracing.orphan_spans(recs) \
            == []
        assert ttracing.build_forest(recs) == jtracing.build_forest(recs)
        for tid in {r["trace_id"] for r in recs}:
            assert ttracing.render_tree(recs, tid) \
                == jtracing.render_tree(recs, tid)
    broken = [dict(r) for r in ours]
    broken[2]["parent_span_id"] = "f" * 16
    assert ttracing.orphan_spans(broken) == jtracing.orphan_spans(broken)
    assert ttracing.render_tree(ours, "0" * 32) \
        == jtracing.render_tree(ours, "0" * 32)


@pytest.mark.parametrize("header", [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
    "", "00-abc-def-01", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
])
def test_traceparent_parsing_matches_jax(header):
    def parse(tracing):
        try:
            return tracing.parse_traceparent(header)
        except ValueError as e:
            return ("ValueError", str(e))
    assert parse(ttracing) == parse(jtracing)


# -- parity: SLO burn on a fake clock -----------------------------------------------


def _slo_script(slo, events, registry):
    """One scripted observation stream: a cold start under the floor, a
    burn, its re-arm, a second flow - on caller-supplied times."""
    cfg = slo.SLOConfig(windows=(slo.SLOWindow("fast", 10.0, 2.0),
                                 slo.SLOWindow("slow", 60.0, 1.0)),
                        budget=0.1, min_samples=4)
    tracker = slo.SLOTracker(cfg)
    script = ([(0.1 * i, True) for i in range(4)]
              + [(0.5, False), (0.6, False), (0.7, True)]
              + [(20.0 + 0.1 * i, True) for i in range(8)]
              + [(21.0 + 0.1 * i, False) for i in range(3)])
    with events.capture() as buf:
        for t, ok in script:
            tracker.observe("acme", "gold", t, ok)
        for t, ok in script[:5]:
            tracker.observe("beta", "bronze", t, not ok)
    burns = [{k: v for k, v in json.loads(ln).items()
              if k != "t"}
             for ln in buf.getvalue().splitlines() if ln.strip()]
    gauges = {
        name: registry.REGISTRY.gauge(
            name, "", labelnames=("tenant", "slo_class", "window")).value(
                tenant="acme", slo_class="gold", window="fast")
        for name in ("slo_goodput_ratio", "slo_burn_rate",
                     "slo_error_budget_remaining")}
    return (burns, gauges, tracker.snapshot(21.5),
            tracker.burning(21.5),
            [tracker.burn_rate("acme", "gold", 21.5, window=w)
             for w in ("fast", "slow")])


def test_slo_tracker_matches_jax():
    ours = _slo_script(tslo, tev, tregistry)
    theirs = _slo_script(jslo, jev, jregistry)
    assert ours == theirs
    burns = ours[0]
    assert {b["event"] for b in burns} == {"slo_burn"}
    assert len(burns) >= 3
    for b in burns:
        jev.validate_event(dict(b, t=0.0))


# -- parity: fleet merge --------------------------------------------------------------


def _fleet_snapshots(registry):
    out = {}
    for seed, n in ((0, 100), (1, 250), (2, 7)):
        rng = np.random.default_rng(seed)
        reg = registry.MetricsRegistry()
        h = reg.histogram("latency_seconds", "x",
                          buckets=jt_fleet.BUCKETS)
        for x in rng.uniform(0.0, 8.0, size=n):
            h.observe(float(x))
        reg.counter("requests_total", "n").inc(float(n))
        reg.counter("by_tenant_total", "n", labelnames=("tenant",)).inc(
            float(seed + 1), tenant="acme")
        reg.gauge("queue_depth", "d").set(float(seed * 10))
        out[f"replica-{seed}"] = reg.snapshot()
    return out


def test_fleet_merge_matches_jax():
    ours, theirs = _fleet_snapshots(tregistry), _fleet_snapshots(jregistry)
    assert ours == theirs
    assert tfleet.merge_snapshots(ours) == jfleet.merge_snapshots(theirs)
    lifted = tfleet.lift(ours["replica-0"], "a")
    assert lifted == jfleet.lift(theirs["replica-0"], "a")
    assert tfleet.merge_two(lifted, tfleet.lift(ours["replica-1"], "b")) \
        == jfleet.merge_two(lifted, jfleet.lift(theirs["replica-1"], "b"))


def test_fleet_refusals_match_jax():
    snap = _fleet_snapshots(tregistry)["replica-0"]
    bad = json.loads(json.dumps(snap))
    bad["requests_total"]["kind"] = "gauge"
    for fleet in (tfleet, jfleet):
        with pytest.raises(ValueError, match="kind"):
            fleet.merge_two(fleet.lift(snap, "a"), fleet.lift(bad, "b"))
        with pytest.raises(ValueError, match="duplicate"):
            fleet.merge_two(fleet.lift(snap, "a"), fleet.lift(snap, "a"))


# -- parity: reports and traces -------------------------------------------------------


SHARD = {
    "kind": "csr-allgather", "n_shards": 4, "n_global": 16,
    "n_global_padded": 16, "n_local": 4,
    "rows": [4, 4, 4, 4], "nnz": [19, 4, 4, 4],
    "slots": [19, 19, 19, 19],
    "halo_send_bytes": [16, 16, 16, 16],
    "halo_recv_bytes": [48, 48, 48, 48],
    "neighbors": [[[-1, 16]]] * 4,
}

PHASE = {
    "kind": "csr-gather", "exchange": "gather", "plan": "even",
    "n_shards": 4, "n_local": 60, "itemsize": 8, "repeats": 16,
    "phases": {"halo_s": 5e-5, "spmv_s": 2e-4, "spmv_shard_max_s": 2e-4,
               "spmv_shard_mean_s": 1.85e-4, "reduction_s": 2e-5},
    "spmv_s": [1.9e-4, 2.0e-4, 1.7e-4, 1.8e-4], "step_s": 2.8e-4,
    "links": [{"shift": 1, "bytes": 416, "seconds": 1e-5,
               "bytes_per_s": 4.16e7}],
    "gather_bytes": 40000, "wire_bytes": 1160,
    "reductions_per_iteration": 2,
    "stall_factors": {"halo": 1.0, "spmv": 1.081081, "reduction": 1.0},
    "explained_fraction": 1.035714, "solve_s_per_iteration": 3e-4,
    "explained_fraction_vs_solve": 0.966667,
}


def _report_kwargs(ss, roof, model):
    return dict(
        record={"problem": "unit", "status": "CONVERGED", "iterations": 7,
                "residual_norm": 1e-8, "elapsed_s": 0.01,
                "iters_per_sec": 700.0, "device": "cpu", "mesh": 4,
                "dtype": "float32"},
        shard=ss.ShardReport.from_json(SHARD),
        roofline=roof.analyze(n=16, nnz=31, itemsize=4, iterations=7,
                              elapsed_s=0.01, model=model),
        flight_summary={"n_records": 8, "stride": 1, "decay_rate": 0.5},
        health={"classification": "HEALTHY", "message": "ok"},
        comm={"psum": 14, "ppermute": 0, "all_gather": 7,
              "comm_bytes": 448, "wire_bytes": 448, "exchange": "gather",
              "halo_padding_fraction": 0.25},
        calibration={"decisions": [{"decision": "kept", "solve_index": 1,
                                    "predicted_gain_pct": 1.5,
                                    "model": "m"}]},
        phase=PHASE,
        memory={"kind": "csr", "n_shards": 4, "n_rhs": 1,
                "persistent_bytes": [1 << 20] * 4,
                "matrix_bytes": [1 << 19] * 4,
                "solver_bytes": [1 << 19] * 4, "peak_bytes": 3 << 20,
                "jaxpr_peak_bytes": 3 << 20, "hbm_bytes": 80e9,
                "classification": "FITS", "headroom_frac": 0.99,
                "measured_bytes": 4 << 20},
        sections=(("build", 0.001), ("solve", 0.01)))


def test_solve_report_matches_jax():
    ours = treport.SolveReport(**_report_kwargs(tss, troof, MODEL))
    theirs = jreport.SolveReport(**_report_kwargs(jss, jroof, jt_rep.MODEL))
    assert ours.to_json() == theirs.to_json()
    json.dumps(ours.to_json(), allow_nan=False)
    # the text differs in the two lines that name each package's source
    # of the comm and transient-peak numbers
    ot, tt = ours.to_text().splitlines(), theirs.to_text().splitlines()
    assert len(ot) == len(tt)
    differ = [(o, t) for o, t in zip(ot, tt) if o != t]
    assert [o for o, _ in differ] == [
        "-- communication (comm-layer record, per device) --",
        next(o for o in ot if o.startswith("peak "))]


@pytest.mark.parametrize("shards", ["report", "uniform", "phase"])
def test_perfetto_trace_matches_jax(shards):
    spans = _span_records(ttracing, tev)
    kw = dict(iterations=100, elapsed_s=0.02,
              sections=(("build", 0.001), ("solve", 0.02)),
              flight_history=np.array([1.0, 0.5, np.nan, 0.1, 1e-3]),
              request_spans=spans, label="seq")
    extra = {"report": lambda ss: dict(shard=ss.ShardReport.from_json(
                 SHARD)),
             "uniform": lambda ss: dict(n_shards=3),
             "phase": lambda ss: dict(phase_profile=PHASE)}[shards]
    ours = treport.perfetto_trace(**kw, **extra(tss))
    theirs = jreport.perfetto_trace(**kw, **extra(jss))
    assert ours == theirs
    treport.validate_perfetto(ours)
    assert ours["metadata"]["span_source"] == (
        "measured" if shards == "phase" else "modeled")
    assert ours["metadata"]["truncated"] is True


def test_write_perfetto_round_trips(tmp_path):
    trace = treport.perfetto_trace(iterations=3, elapsed_s=0.01,
                                   phase_profile=PHASE)
    path = str(tmp_path / "t.json")
    treport.write_perfetto(path, trace)
    with open(path) as f:
        back = json.load(f)
    assert back == json.loads(json.dumps(trace))
    jreport.validate_perfetto(back)
    assert treport.phase_lines(PHASE) == jreport.phase_lines(PHASE)
    assert treport.memory_lines(_report_kwargs(tss, troof, MODEL)[
        "memory"])[0] == jreport.memory_lines(_report_kwargs(
            jss, jroof, jt_rep.MODEL)["memory"])[0]
    stats = {"submitted": 3, "completed": 3, "converged": 3,
             "latency": {"p50_s": 0.01}, "shed": {"level": 1}}
    assert treport.service_lines(stats) == jreport.service_lines(stats)
