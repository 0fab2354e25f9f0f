"""The port's telemetry core and utilities against the JAX package's.

The host modules have no data path to hold against JAX outputs, so
their test is the JAX package's own: the classes of
``tests/test_events_metrics.py`` (``TestRegistry``, ``TestEvents``,
``TestObserveSolve``), ``tests/test_timing.py`` and
``tests/test_logging_format.py`` run here unchanged, with the names
their module looks up - ``events``, ``session``, ``REGISTRY``,
``MetricsRegistry``, ``CGStatus``, ``timing``, ``ulog`` - bound to the
port's modules for the duration of each case (``jnp``, in the one timing
case that makes a device array, is bound to ``torch``).  Besides: the
port's ``EVENT_SCHEMA`` equals the JAX one, every event of a port solve
passes both packages' ``validate_event`` (``tools/validate_trace.py``
reads a stream with the JAX one), ``sanitize`` unwraps 0-d tensors, and
``profile_trace`` writes a Chrome trace.
"""
import json
import os

import pytest
import torch

import test_events_metrics as jt_events
import test_logging_format as jt_logging
import test_timing as jt_timing
from test_timing import clock  # noqa: F401  (the fixture jt_timing uses)

from cuda_mpi_parallel_tpu.telemetry import events as jev
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.solver.status import CGStatus
from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
from cuda_mpi_parallel_tpu_torch.telemetry import session as tsession
from cuda_mpi_parallel_tpu_torch.telemetry.flight import FlightConfig
from cuda_mpi_parallel_tpu_torch.telemetry.registry import (
    REGISTRY,
    MetricsRegistry,
)
from cuda_mpi_parallel_tpu_torch.utils import logging as tlog
from cuda_mpi_parallel_tpu_torch.utils import timing as ttiming

torch.set_num_threads(1)


@pytest.fixture
def on_the_port(monkeypatch):
    """Bind the JAX test modules' names to the port's modules."""
    for name, value in (("events", tev), ("session", tsession),
                        ("REGISTRY", REGISTRY),
                        ("MetricsRegistry", MetricsRegistry),
                        ("CGStatus", CGStatus)):
        monkeypatch.setattr(jt_events, name, value)
    monkeypatch.setattr(jt_timing, "timing", ttiming)
    monkeypatch.setattr(jt_timing, "jnp", torch)
    monkeypatch.setattr(jt_logging, "ulog", tlog)
    monkeypatch.setattr(jt_logging, "CGStatus", CGStatus)


@pytest.mark.usefixtures("on_the_port")
class TestPortRegistry(jt_events.TestRegistry):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortEvents(jt_events.TestEvents):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortObserveSolve(jt_events.TestObserveSolve):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortTimer(jt_timing.TestTimer):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortTimeFn(jt_timing.TestTimeFn):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortPairedDeltaRate(jt_timing.TestPairedDeltaRate):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortSanitize(jt_logging.TestSanitize):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortEmitJsonBreakdown(jt_logging.TestEmitJsonBreakdown):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortFormatHistory(jt_logging.TestFormatHistory):
    pass


def test_the_jax_modules_are_restored():
    # the binding lasts one case: the JAX tests see their own modules
    assert jt_events.events is jev
    assert jt_timing.timing.__name__ == "cuda_mpi_parallel_tpu.utils.timing"


def test_event_schema_equals_jax():
    assert tev.EVENT_SCHEMA == jev.EVENT_SCHEMA
    assert list(tev.EVENT_SCHEMA) == list(jev.EVENT_SCHEMA)


def test_port_solve_events_pass_both_validators(tmp_path):
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    b = torch.ones(op.n)
    path = tmp_path / "trace.jsonl"
    tev.configure(str(path))
    try:
        with tsession.observe_solve("poisson 16x128", engine="auto",
                                    check_every=4) as obs:
            res = pt.solve(op, b, tol=0.0, rtol=1e-5, engine="auto",
                           check_every=4, record_history=True,
                           flight=FlightConfig.for_solve(2000, stride=2,
                                                         heartbeat=8))
            obs.finish(res)
    finally:
        tev.configure(None)
    records = jev.read_events(str(path))      # the JAX reader validates
    for rec in records:
        tev.validate_event(rec)
    kinds = [r["event"] for r in records]
    assert kinds[0] == "solve_start" and kinds[-1] == "solve_end"
    assert kinds.count("eligibility_rejected") == 2
    assert "flight_heartbeat" in kinds and "check_block" in kinds
    chosen = [r for r in records if r["event"] == "engine_selected"]
    assert [(r["engine"], r["flight_stride"]) for r in chosen] == \
        [("general", 2)]
    assert len({r["solve_id"] for r in records}) == 1
    assert records[-1]["status"] == "CONVERGED"
    assert records[-1]["iterations"] == int(res.iterations)


def test_sanitize_unwraps_zero_d_tensors():
    rec = tlog.sanitize({"rr": torch.tensor(2.5), "k": torch.tensor(7),
                         "bad": torch.tensor(float("nan")),
                         "vec": torch.ones(2)})
    assert rec["rr"] == 2.5 and isinstance(rec["rr"], float)
    assert rec["k"] == 7 and isinstance(rec["k"], int)
    assert rec["bad"] is None
    assert isinstance(rec["vec"], torch.Tensor)   # not a scalar: kept


def test_solve_record_reads_a_port_result():
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    res = pt.solve(op, torch.ones(op.n), tol=0.0, rtol=1e-5,
                   record_history=True)
    rec = tlog.solve_record(res, elapsed_s=0.5)
    assert rec["status"] == "CONVERGED"
    assert rec["iterations"] == int(res.iterations)
    assert "iter     0" in tlog.format_history(res, every=50)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with ttiming.profile_trace(str(tmp_path)):
        torch.ones(8) * 2
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with ttiming.profile_trace(None):            # off: a no-op
        pass


def test_unported_telemetry_names_raise():
    import cuda_mpi_parallel_tpu.telemetry as jtel
    import cuda_mpi_parallel_tpu_torch.telemetry as ttel

    # cost and roofline are ported (ROADMAP A16, first part): the JAX
    # modules' public names, but the jaxpr walk the port has no
    # counterpart of (tests/test_torch_surface.py NO_COUNTERPART)
    for name in ("cost", "roofline"):
        ours, theirs = getattr(ttel, name), getattr(jtel, name)
        assert set(ours.__all__) \
            == set(theirs.__all__) - {"jaxpr_solve_cost"}
    # shardscope and memscope are ported (ROADMAP A16, item 10a): the
    # JAX modules' public names, but the jaxpr walker (the port records
    # a solve's peak with memscope.PeakRecord instead)
    assert set(ttel.shardscope.__all__) == set(jtel.shardscope.__all__)
    assert set(ttel.memscope.__all__) \
        == set(jtel.memscope.__all__) - {"jaxpr_peak_bytes"} | {"PeakRecord"}
    for name in ("active", "force_active", "ShardReport", "shard_report",
                 "MemoryBudgetError", "MemoryFootprint"):
        assert getattr(ttel, name).__name__ == getattr(jtel, name).__name__
    # and the rest of telemetry (ROADMAP A16, items 10b and 10c): every
    # JAX name resolves, each module with the JAX module's public names
    assert set(jtel.__all__) <= set(ttel.__all__)
    for name in ("phasetrace", "calibrate", "report", "tracing", "slo",
                 "fleet"):
        assert set(getattr(ttel, name).__all__) \
            == set(getattr(jtel, name).__all__)
    from cuda_mpi_parallel_tpu_torch.telemetry import phasetrace

    assert phasetrace.PhaseProfile is ttel.PhaseProfile
    with pytest.raises(AttributeError):
        ttel.no_such_name
