"""The port's flight recorder and solve health against the JAX package.

The same numpy-seeded inputs go through both packages: a 16 x 128 f32
Poisson stencil on the general engine (``cg``, ``cg1``, ``pipecg``, and
a decimated ring that wraps), ``cg_streaming`` (the port runs the fused
passes' twins: the tensors lie on the CPU), ``cg_df64``, the 3x3 oracle
in float64, and the stacked-mesh distributed lanes (``solve_distributed``
and ``solve_distributed_streaming`` over two shards).  Each JAX
reference is computed once, in the module fixture ``jax_runs``.

Parity contract: the ``(capacity, 4)`` buffers agree slot for slot - the
same iteration column, NaN in the same unwritten slots - and the
``(rr, alpha, beta)`` columns within ``F32_RTOL`` = 1e-4 relative in f32
(the two packages sum a 2048-term dot in different orders, whose f32
results may part by up to ~n eps = 1.2e-4; measured here: 1.3e-5 for cg,
2.8e-5 for cg1), ``PIPECG_RTOL`` = 1e-2 for f32 pipecg (its pipelined
recurrence amplifies those differences: 5.9e-3 by iteration 81), and
1e-12 in float64 (the oracle; its last rows sit at the rounding floor,
so against the column's largest value).  The port's ``cg_df64`` records
in float64 and returns the rows rounded to float32, the JAX package the
f32 hi words of its pairs, so there the columns agree to the hi word's
rounding (``HI_WORD``) and the buffers share their dtype.  Iteration counts and
statuses are equal, and x is bit-equal with the recorder on and off.
The B12 lane (``solve_distributed_resident``) adapts its block trace:
its buffer equals the JAX adapter's on the same trace, and its rows are
the general solve's at multiples of ``check_every``.

Health: the JAX ``TestSolveHealth`` cases on the port, and
``classify_trace`` / ``estimate_condition`` of the port and the JAX
package on the same record (equal; the estimate within 1e-6 relative).
Events: ``solve()``'s ``eligibility_rejected`` / ``engine_selected``
sequence equals the JAX one under ``auto``, ``resident`` and
``streaming``; heartbeat events equal the JAX package's as sets of
iterations (JAX delivers them unordered).  Host reads: a
``TorchDispatchMode`` counts ``aten._local_scalar_dense`` (every
``.item()`` and ``bool()``): the recorder adds none, the heartbeat none
beyond the check block's own.
"""
import json
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.telemetry import events as jev
from cuda_mpi_parallel_tpu.telemetry import flight as jfl
from cuda_mpi_parallel_tpu.telemetry import health as jhl
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as trd
from cuda_mpi_parallel_tpu_torch.solver.status import CGStatus
from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
from cuda_mpi_parallel_tpu_torch.telemetry import flight as tfl
from cuda_mpi_parallel_tpu_torch.telemetry import health as thl
from cuda_mpi_parallel_tpu_torch.telemetry import session as tsession
from cuda_mpi_parallel_tpu_torch.telemetry.registry import REGISTRY

# the module (the package re-exports its function ``cg`` under that name)
tcg = sys.modules["cuda_mpi_parallel_tpu_torch.solver.cg"]

torch.set_num_threads(1)

GRID = (16, 128)
MAXITER = 300
KW = dict(tol=0.0, rtol=1e-5, maxiter=MAXITER)
STREAM_KW = dict(tol=0.0, rtol=1e-5, maxiter=40)   # interpret-mode Pallas
DF64_KW = dict(tol=0.0, rtol=1e-9, maxiter=MAXITER)
HEARTBEAT = 10
F32_RTOL = 1e-4
PIPECG_RTOL = 1e-2
F64_RTOL = 1e-12
HI_WORD = 2.0 ** -23   # an f32 hi word's rounding of its float64 value


def rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def ops():
    return (jpoisson.poisson_2d_operator(*GRID, dtype=jnp.float32),
            tpoisson.poisson_2d_operator(*GRID, device="cpu"))


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def beats(buf):
    """The heartbeat iterations of a captured event stream."""
    return {json.loads(ln)["iteration"] for ln in buf.getvalue().splitlines()
            if json.loads(ln)["event"] == "flight_heartbeat"}


# -- each engine: the JAX run (once) and the port's, on the same inputs -------

def _jax_oracle():
    a, b, _ = jpoisson.oracle_system()
    return jp.solve(a, b, flight=jfl.FlightConfig.for_solve(2000))


def _port_oracle(flight):
    a, b, _ = tpoisson.oracle_system(device="cpu")
    return pt.solve(a, b, flight=flight(2000))


# name -> (the JAX run, the port's run given a FlightConfig factory, the
# port's config factory, rtol of the scalar columns)
ENGINES = {
    "cg": (lambda jop, b: jp.solve(
        jop, b, **KW, flight=jfl.FlightConfig.for_solve(
            MAXITER, heartbeat=HEARTBEAT)),
        lambda top, b, f: pt.solve(top, b, **KW, flight=f),
        lambda: tfl.FlightConfig.for_solve(MAXITER, heartbeat=HEARTBEAT),
        F32_RTOL),
    "cg1": (lambda jop, b: jp.solve(
        jop, b, **KW, method="cg1",
        flight=jfl.FlightConfig.for_solve(MAXITER)),
        lambda top, b, f: pt.solve(top, b, **KW, method="cg1", flight=f),
        lambda: tfl.FlightConfig.for_solve(MAXITER), F32_RTOL),
    "pipecg": (lambda jop, b: jp.solve(
        jop, b, **KW, method="pipecg",
        flight=jfl.FlightConfig.for_solve(MAXITER)),
        lambda top, b, f: pt.solve(top, b, **KW, method="pipecg",
                                   flight=f),
        lambda: tfl.FlightConfig.for_solve(MAXITER), PIPECG_RTOL),
    "ring": (lambda jop, b: jp.solve(
        jop, b, **KW, check_every=4,
        flight=jfl.FlightConfig(capacity=8, stride=3)),
        lambda top, b, f: pt.solve(top, b, **KW, check_every=4, flight=f),
        lambda: tfl.FlightConfig(capacity=8, stride=3), F32_RTOL),
    "streaming": (lambda jop, b: jp.solve(
        jop, b, **STREAM_KW, engine="streaming",
        flight=jfl.FlightConfig.for_solve(40)),
        lambda top, b, f: pt.solve(top, b, **STREAM_KW,
                                   engine="streaming", flight=f),
        lambda: tfl.FlightConfig.for_solve(40), F32_RTOL),
    "df64": (lambda jop, b: jp.cg_df64(
        jop, np.asarray(b, np.float64), **DF64_KW,
        flight=jfl.FlightConfig.for_solve(MAXITER)),
        lambda top, b, f: pt.cg_df64(top, b.double().numpy(), **DF64_KW,
                                     flight=f),
        lambda: tfl.FlightConfig.for_solve(MAXITER), HI_WORD),
    "dist": (lambda jop, b: jpar.solve_distributed(
        jop, b, mesh=jpar.make_mesh(2), **KW,
        flight=jfl.FlightConfig.for_solve(MAXITER, heartbeat=HEARTBEAT)),
        lambda top, b, f: tpar.solve_distributed(top, b, mesh=mesh(2),
                                                 **KW, flight=f),
        lambda: tfl.FlightConfig.for_solve(MAXITER, heartbeat=HEARTBEAT),
        F32_RTOL),
    "dist_streaming": (lambda jop, b: jpar.solve_distributed_streaming(
        jop, b, mesh=jpar.make_mesh(2), **STREAM_KW,
        flight=jfl.FlightConfig.for_solve(40)),
        lambda top, b, f: tpar.solve_distributed_streaming(
            top, b, mesh=mesh(2), **STREAM_KW, flight=f),
        lambda: tfl.FlightConfig.for_solve(40), F32_RTOL),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX reference of this file, computed once: engine name ->
    ``(result, host flight buffer)``, plus ``"oracle"`` and the
    heartbeat iterations of the ``"cg"`` run under ``"beats"``."""
    jop, _ = ops()
    b = jnp.asarray(rhs(jop.n))
    out = {}
    for name, (jrun, _, _, _) in ENGINES.items():
        with jev.capture() as buf:
            res = jrun(jop, b)
            jax.block_until_ready(res.flight)
            jax.effects_barrier()          # heartbeat callbacks delivered
        out[name] = (res, np.asarray(res.flight, np.float64))
        if name == "cg":
            out["beats"] = beats(buf)
    res = _jax_oracle()
    out["oracle"] = (res, np.asarray(res.flight, np.float64))
    return out


@pytest.fixture(scope="module")
def port_runs():
    """The port's runs of ``ENGINES``, each with and without the
    recorder: name -> ``(recorded, plain, heartbeat iterations)``."""
    _, top = ops()
    b = torch.as_tensor(rhs(top.n))
    out = {}
    for name, (_, prun, config, _) in ENGINES.items():
        with tev.capture() as buf:
            with tev.solve_scope():
                rec = prun(top, b, config())
        out[name] = (rec, prun(top, b, None), beats(buf))
    out["oracle"] = (_port_oracle(tfl.FlightConfig.for_solve),
                     _port_oracle(lambda n: None), set())
    return out


def _x(res):
    return res.x64 if getattr(res, "x64", None) is not None else res.x


@pytest.mark.parametrize("name", list(ENGINES) + ["oracle"])
def test_flight_buffers_match_jax(name, jax_runs, port_runs):
    jres, jbuf = jax_runs[name]
    res, plain, _ = port_runs[name]
    rtol = F64_RTOL if name == "oracle" else ENGINES[name][3]
    atol = 0.0
    if name == "oracle":
        atol = F64_RTOL * np.nanmax(np.abs(jbuf[:, 1:]), axis=0)
    assert int(res.iterations) == int(jres.iterations) > 0
    assert int(res.status) == int(jres.status)
    # the recorder leaves the iterates alone
    assert torch.equal(_x(res), _x(plain))
    assert int(plain.iterations) == int(res.iterations)
    assert plain.flight is None
    buf = res.flight.numpy().astype(np.float64)
    assert buf.shape == jbuf.shape
    # the same rows, NaN in the same unwritten slots
    assert np.array_equal(np.isnan(buf), np.isnan(jbuf))
    assert np.array_equal(buf[:, 0], jbuf[:, 0], equal_nan=True)
    got, want = buf[:, 1:], jbuf[:, 1:]
    seen = np.isfinite(want)
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    assert np.all(err[seen] <= bound[seen]), float(np.max(
        (err - atol)[seen] / np.abs(want)[seen]))
    # the f64 lane returns the JAX package's f32 hi words; the oracle is
    # a float64 solve() in both packages
    want = {"oracle": torch.float64}
    assert res.flight.dtype == want.get(name, torch.float32)
    assert res.flight.dtype == getattr(torch, jres.flight.dtype.name)


def test_ring_wraps_and_decimates_like_jax(jax_runs, port_runs):
    # FlightConfig(capacity=8, stride=3): the last 8 multiples of 3
    res, _, _ = port_runs["ring"]
    k = int(res.iterations)
    rec = tfl.FlightRecord.from_buffer(res.flight)
    last = k - k % 3
    assert rec.stride == 3
    assert np.array_equal(rec.iterations, np.arange(last - 21, last + 1, 3))
    jrec = jfl.FlightRecord.from_buffer(jax_runs["ring"][1])
    assert np.array_equal(rec.iterations, jrec.iterations)


def test_heartbeats_match_jax(jax_runs, port_runs):
    got = port_runs["cg"][2]
    k = int(port_runs["cg"][0].iterations)
    assert got == jax_runs["beats"] == set(range(HEARTBEAT, k + 1,
                                                 HEARTBEAT))
    # the distributed lanes strip the heartbeat
    assert port_runs["dist"][2] == set()


def test_health_matches_jax_on_the_same_record(jax_runs, port_runs):
    for name in ("cg", "cg1", "pipecg", "streaming", "df64", "oracle"):
        res = port_runs[name][0]
        buf = res.flight.numpy().astype(np.float64)
        kw = dict(converged=bool(res.converged), status=int(res.status))
        rec = tfl.FlightRecord.from_buffer(buf)
        jrec = jfl.FlightRecord.from_buffer(buf)
        assert thl.classify_trace(rec, **kw) == jhl.classify_trace(jrec,
                                                                   **kw)
        est, jest = thl.estimate_condition(rec), jhl.estimate_condition(jrec)
        assert (est[2] is None) == (jest[2] is None), name
        if est[2] is not None:
            np.testing.assert_allclose(est, jest, rtol=1e-6)
        # the verdict on the JAX run's own record is the port's
        jres, jbuf = jax_runs[name]
        verdict = thl.assess_solve_health(rec, **kw)
        jverdict = jhl.assess_solve_health(
            jfl.FlightRecord.from_buffer(jbuf),
            converged=bool(jres.converged), status=int(jres.status))
        assert verdict.classification.name == \
            jverdict.classification.name, name


# -- the B12 lane --------------------------------------------------------------

def test_resident_dist_lane_adapts_its_block_trace(jax_runs):
    _, top = ops()
    b = torch.as_tensor(rhs(top.n))
    with tev.capture() as buf:
        res = tpar.solve_distributed_resident(
            top, b, mesh=mesh(2), tol=0.0, rtol=1e-5, maxiter=12,
            check_every=4, flight=tfl.FlightConfig.for_solve(12, stride=3))
    chosen = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [(e["event"], e["engine"], e["flight_stride"]) for e in chosen] \
        == [("engine_selected", "distributed-resident", 4)]
    rec = tfl.FlightRecord.from_buffer(res.flight)
    assert np.array_equal(rec.iterations, [0, 4, 8, 12])
    assert rec.iterations[-1] == int(res.iterations)
    assert np.all(np.isnan(rec.alphas)) and np.all(np.isnan(rec.betas))
    # the JAX adapter on the same block trace gives the same buffer
    out = trd.cg_resident_dist(top.scale, b.reshape((2, 8, 128)), tol=0.0,
                               rtol=1e-5, maxiter=12, check_every=4)
    np.testing.assert_array_equal(
        res.flight, jfl.buffer_from_block_history(out[-1].numpy(), 4,
                                                  cap=12))
    # its rows are the general solve's at the block boundaries
    jrec = jfl.FlightRecord.from_buffer(jax_runs["cg"][1])
    np.testing.assert_allclose(rec.residual_sq,
                               jrec.residual_sq[rec.iterations],
                               rtol=F32_RTOL)


def test_resident_block_trace_reads_as_a_record():
    # the resident engine refuses flight=; its check-block trace
    # (cg_resident(record_history=True), B10's twin on the CPU) reads as
    # a record through FlightRecord.from_history, as the JAX solve()
    # docstring advises
    _, top = ops()
    res = pt.cg_resident(top, torch.as_tensor(rhs(top.n)), tol=0.0,
                         rtol=1e-5, maxiter=64, check_every=8,
                         record_history=True)
    rec = tfl.FlightRecord.from_history(res.residual_history)
    k = int(res.iterations)
    assert rec.stride == 8 and rec.iterations[-1] == k
    assert np.array_equal(rec.iterations, np.arange(0, k + 1, 8))
    assert np.isnan(rec.alphas).all()


# -- solve()'s routing story ---------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "resident", "streaming"])
def test_solve_events_match_jax(engine, jax_runs):
    # the arguments of the fixture's runs, so the JAX solves are cached
    jop, top = ops()
    b = rhs(top.n)
    run = "streaming" if engine == "streaming" else "cg"
    run_kw = STREAM_KW if engine == "streaming" else KW
    jflight = {"cg": jfl.FlightConfig.for_solve(MAXITER,
                                                heartbeat=HEARTBEAT),
               "streaming": jfl.FlightConfig.for_solve(40)}[run]

    def story(solve, flight, op, vec, events):
        with events.capture() as buf:
            try:
                solve(op, vec, **run_kw, engine=engine, flight=flight)
            except ValueError as e:
                assert engine == "resident" and "flight" in str(e)
        keep = ("event", "engine", "method", "reason", "flight_stride",
                "check_every")
        return [{k: v for k, v in json.loads(ln).items() if k in keep}
                for ln in buf.getvalue().splitlines()
                if json.loads(ln)["event"] in ("engine_selected",
                                               "eligibility_rejected")]

    jstory = story(jp.solve, jflight, jop, jnp.asarray(b), jev)
    tstory = story(pt.solve, ENGINES[run][2](), top, torch.as_tensor(b),
                   tev)
    assert tstory == jstory
    assert jstory[-1]["event"] == ("eligibility_rejected"
                                   if engine == "resident"
                                   else "engine_selected")


def test_auto_with_a_recorder_declines_the_resident_engine(monkeypatch):
    # on a Hopper card auto would take B10 for this grid; a recorder
    # sends it to the streaming engine (no launch here: CPU tensors run
    # the passes' twins)
    monkeypatch.setattr(tcg, "is_hopper", lambda device: True)
    _, top = ops()
    with tev.capture() as buf:
        res = pt.solve(top, torch.as_tensor(rhs(top.n)), **STREAM_KW,
                       engine="auto", flight=tfl.FlightConfig.for_solve(40))
    story = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [(e["event"], e["engine"]) for e in story] == [
        ("eligibility_rejected", "resident"),
        ("engine_selected", "streaming")]
    assert story[-1]["flight_stride"] == 1 and res.flight is not None
    with pytest.raises(ValueError, match="flight recorder"):
        pt.solve(top, torch.as_tensor(rhs(top.n)), engine="resident",
                 flight=tfl.FlightConfig())


# -- host reads ----------------------------------------------------------------

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


def _reads(run, flight):
    with tev.capture(), _HostReads() as mode:
        run(flight)
        tev._drain_callbacks()
    return mode.n


READS = {
    "cg": lambda top, b: lambda f: pt.solve(top, b, **KW, check_every=4,
                                            flight=f),
    "cg1": lambda top, b: lambda f: pt.solve(top, b, **KW, method="cg1",
                                             check_every=4, flight=f),
    "pipecg": lambda top, b: lambda f: pt.solve(top, b, **KW,
                                                method="pipecg", flight=f),
    "streaming": lambda top, b: lambda f: pt.solve(
        top, b, **STREAM_KW, engine="streaming", check_every=4, flight=f),
    "df64": lambda top, b: lambda f: pt.cg_df64(
        top, b.double(), **DF64_KW, check_every=4, flight=f),
    "dist_streaming": lambda top, b: lambda f: \
        tpar.solve_distributed_streaming(top, b, mesh=mesh(2), **STREAM_KW,
                                         check_every=4, flight=f),
}


@pytest.mark.parametrize("heartbeat", [0, 5])
@pytest.mark.parametrize("name", list(READS))
def test_the_recorder_adds_no_host_read(name, heartbeat):
    _, top = ops()
    run = READS[name](top, torch.as_tensor(rhs(top.n)))
    off = _reads(run, None)
    on = _reads(run, tfl.FlightConfig.for_solve(MAXITER,
                                                heartbeat=heartbeat))
    assert on == off > 0


# -- the JAX TestFlightRecorder cases, on the port -----------------------------

def _poisson(n=24):
    a = pt.Stencil2D.create(n, n, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    return a, torch.as_tensor(rng.standard_normal(n * n).astype(np.float32))


def test_config_validation():
    with pytest.raises(ValueError, match="capacity"):
        tfl.FlightConfig(capacity=0)
    with pytest.raises(ValueError, match="stride"):
        tfl.FlightConfig(stride=0)
    with pytest.raises(ValueError, match="heartbeat"):
        tfl.FlightConfig(heartbeat=-1)
    cfg = tfl.FlightConfig.for_solve(100, stride=4)
    assert cfg.capacity == 26 and cfg.stride == 4
    assert tfl.FlightConfig.for_solve(10 ** 9).capacity == 4096
    assert tfl.FlightConfig(heartbeat=3).without_heartbeat() == \
        tfl.FlightConfig()
    assert (tfl.COLUMNS, tfl.DEFAULT_CAPACITY, tfl.CAPACITY_LIMIT) == \
        (jfl.COLUMNS, jfl.DEFAULT_CAPACITY, jfl.CAPACITY_LIMIT)


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_stride1_holds_the_dense_history_rr(method):
    # the history is torch.sqrt of the very rr the row holds (the CPU's
    # f32 sqrt is not always correctly rounded, so compare through it)
    a, b = _poisson()
    res = pt.solve(a, b, tol=1e-5, maxiter=400, method=method,
                   record_history=True,
                   flight=tfl.FlightConfig.for_solve(400, stride=1))
    rec = tfl.FlightRecord.from_buffer(res.flight, stride=1)
    k = int(res.iterations)
    assert np.array_equal(rec.iterations, np.arange(k + 1))
    rr = torch.as_tensor(rec.residual_sq.astype(np.float32))
    assert torch.equal(torch.sqrt(rr), res.residual_history[:k + 1])


def test_decimation_records_every_nth():
    a, b = _poisson()
    res = pt.solve(a, b, tol=1e-5, maxiter=400, record_history=True,
                   flight=tfl.FlightConfig.for_solve(400, stride=8))
    rec = tfl.FlightRecord.from_buffer(res.flight)
    assert rec.stride == 8
    assert np.all(rec.iterations % 8 == 0)
    assert np.all(np.diff(rec.iterations) == 8)
    rr = torch.as_tensor(rec.residual_sq.astype(np.float32))
    assert torch.equal(torch.sqrt(rr),
                       res.residual_history[rec.iterations])


def test_ring_wrap_keeps_last_window():
    a, b = _poisson()
    res = pt.solve(a, b, tol=1e-5, maxiter=400,
                   flight=tfl.FlightConfig(capacity=16, stride=1))
    k = int(res.iterations)
    rec = tfl.FlightRecord.from_buffer(res.flight, stride=1)
    assert len(rec) == 16 and rec.iterations[-1] == k
    assert np.array_equal(rec.iterations, np.arange(k - 15, k + 1))


def test_alpha_beta_columns_recorded():
    a, b = _poisson()
    res = pt.solve(a, b, tol=1e-5, maxiter=400,
                   flight=tfl.FlightConfig.for_solve(400))
    rec = tfl.FlightRecord.from_buffer(res.flight)
    assert np.isnan(rec.alphas[0]) and np.isnan(rec.betas[0])
    assert np.all(rec.alphas[1:] > 0) and np.all(rec.betas[1:] >= 0)


def test_record_views_match_jax():
    # from_history/to_history, summary and decay rate, on the JAX
    # tests' traces, equal to the JAX package's
    hist = np.full(101, np.nan)
    its = np.arange(0, 101, 10)
    hist[its] = 10.0 ** (-its / 10.0)
    for h in (hist, np.where(np.arange(101) % 8 == 0, hist, np.nan)):
        rec, jrec = (tfl.FlightRecord.from_history(h),
                     jfl.FlightRecord.from_history(h))
        assert rec.summary() == jrec.summary()
        assert json.dumps(rec.to_json()) == json.dumps(jrec.to_json())
        np.testing.assert_array_equal(rec.to_history(100),
                                      jrec.to_history(100))
    rec = tfl.FlightRecord.from_history(torch.as_tensor(hist))
    assert rec.decay_rate() == pytest.approx(-0.1, rel=1e-9)


def test_functional_writes_match_jax():
    # flight_init/flight_record and the many-RHS helpers on the same
    # scalars: the same rows (stride skip, ring wrap), dtype kept
    cfg = tfl.FlightConfig(capacity=4, stride=2)
    jcfg = jfl.FlightConfig(capacity=4, stride=2)
    rng = np.random.default_rng(5)
    buf = tfl.flight_init(cfg, torch.float32, 0, torch.tensor(9.0))
    jbuf = jfl.flight_init(jcfg, jnp.float32, 0, jnp.float32(9.0))
    mbuf = tfl.flight_init_many(cfg, torch.float64, 0,
                                torch.tensor([1.0, 2.0]))
    jmbuf = jfl.flight_init_many(jcfg, jnp.float64, 0,
                                 jnp.asarray([1.0, 2.0]))
    for k in range(1, 12):
        s = rng.random(3).astype(np.float32)
        buf = tfl.flight_record(buf, cfg, k, *map(torch.tensor, s))
        jbuf = jfl.flight_record(jbuf, jcfg, k, *map(jnp.float32, s))
        v = rng.random((3, 2))
        mbuf = tfl.flight_record_many(mbuf, cfg, k, *map(torch.tensor, v))
        jmbuf = jfl.flight_record_many(jmbuf, jcfg, k, *map(jnp.asarray, v))
    assert buf.dtype == torch.float32 and mbuf.dtype == torch.float64
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(mbuf.numpy(), np.asarray(jmbuf))
    assert tfl.many_columns(3) == jfl.many_columns(3) == 10
    lanes = tfl.lanes_from_buffer(mbuf, 2)
    jlanes = jfl.lanes_from_buffer(np.asarray(jmbuf), 2)
    for lane, jlane in zip(lanes, jlanes):
        assert lane.to_json() == jlane.to_json()
    trace = np.array([4.0, 1.0, 0.25, -1.0])
    np.testing.assert_array_equal(
        tfl.buffer_from_block_history(torch.as_tensor(trace), 32, cap=70),
        jfl.buffer_from_block_history(trace, 32, cap=70))


def test_ring_writes_what_the_functional_writes_do():
    # FlightRing keeps the iteration column on the host until packaging:
    # its buffer is the one flight_record writes row by row (ring wrap,
    # stride skips)
    rng = np.random.default_rng(4)
    for capacity, stride in ((4, 2), (8, 1), (5, 3), (64, 1)):
        cfg = tfl.FlightConfig(capacity=capacity, stride=stride)
        rr0 = torch.tensor(2.0)
        ring = tfl.FlightRing(cfg, torch.float32, "cpu", 0, rr0)
        want = tfl.flight_init(cfg, torch.float32, 0, rr0)
        for k in range(1, 41):
            s = [torch.tensor(v) for v in rng.random(3, np.float32)]
            ring.record(k, *s)
            want = tfl.flight_record(want, cfg, k, *s)
        got = ring.buffer()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_heartbeat_carries_solve_scope():
    a, b = _poisson()
    with tev.capture() as buf, tev.solve_scope("hb-probe"), \
            tev.scoped(phase="warmup"):
        pt.solve(a, b, tol=1e-5, maxiter=400, check_every=7,
                 flight=tfl.FlightConfig.for_solve(400, heartbeat=20))
    got = [json.loads(ln) for ln in buf.getvalue().splitlines()
           if json.loads(ln)["event"] == "flight_heartbeat"]
    assert got and all(e["iteration"] % 20 == 0 for e in got)
    assert all(e["solve_id"] == "hb-probe" and e["phase"] == "warmup"
               and e["residual_sq"] > 0 for e in got)


def test_heartbeats_at_maxiter_drain_at_scope_exit():
    # a solve that stops at maxiter has no final check-block read: its
    # last samples leave with the scope
    a, b = _poisson()
    with tev.capture() as buf:
        with tev.solve_scope("short"):
            res = pt.solve(a, b, tol=0.0, maxiter=30, check_every=8,
                           flight=tfl.FlightConfig.for_solve(30,
                                                             heartbeat=5))
    assert int(res.iterations) == 30
    assert beats(buf) == {5, 10, 15, 20, 25, 30}


# -- the JAX TestSolveHealth cases, on the port --------------------------------

def _record(residuals, its=None):
    residuals = np.asarray(residuals, dtype=np.float64)
    if its is None:
        its = np.arange(residuals.shape[0])
    buf = np.full((residuals.shape[0], 4), np.nan)
    buf[:, 0] = its
    buf[:, 1] = residuals ** 2
    return tfl.FlightRecord.from_buffer(buf, stride=1)


def _diag_solve(method="cg"):
    eigs = np.linspace(1.0, 100.0, 40)
    b = np.random.default_rng(3).standard_normal(40)
    res = pt.solve(torch.as_tensor(np.diag(eigs)), torch.as_tensor(b),
                   tol=1e-12, maxiter=80, method=method,
                   flight=tfl.FlightConfig.for_solve(80))
    return tfl.FlightRecord.from_buffer(res.flight)


@pytest.mark.parametrize("method", ["cg", "pipecg"])
def test_condition_estimate_known_spectrum(method):
    lmin, lmax, kappa = thl.estimate_condition(_diag_solve(method))
    assert lmin >= 1.0 - 1e-6 and lmax <= 100.0 + 1e-6
    assert kappa == pytest.approx(100.0, rel=0.05)


def test_condition_estimate_needs_stride1_alpha_beta():
    rec = _record(10.0 ** -np.arange(20.0))
    assert thl.estimate_condition(rec) == (None, None, None)
    assert (thl.STAGNATION_RATE, thl.DIVERGENCE_FACTOR,
            thl.SPECTRAL_WINDOW) == (jhl.STAGNATION_RATE,
                                     jhl.DIVERGENCE_FACTOR,
                                     jhl.SPECTRAL_WINDOW)


@pytest.mark.parametrize("case", ["converged", "stagnated", "diverged",
                                  "maxiter"])
def test_classify_trace(case):
    if case == "stagnated":
        res = np.concatenate([10.0 ** -np.arange(0, 2, 0.1),
                              np.full(60, 1e-2)])
        res *= 1.0 + 1e-4 * np.sin(np.arange(res.shape[0]))
    elif case == "diverged":
        res = np.concatenate([10.0 ** -np.arange(0, 3, 0.5),
                              10.0 ** np.arange(-3, 1, 0.5)])
    else:
        res = 10.0 ** (-0.05 * np.arange(100.0))
    rec = _record(res)
    cls, rate, _, msg = thl.classify_trace(rec,
                                           converged=case == "converged")
    assert cls == CGStatus[case.upper()]
    words = {"converged": "converged", "stagnated": "flatlined",
             "diverged": "grew", "maxiter": "still converging"}
    assert words[case] in msg
    jrec = jfl.FlightRecord.from_buffer(
        np.stack([rec.iterations, rec.residual_sq, rec.alphas, rec.betas],
                 axis=1))
    jcls, jrate, _, jmsg = jhl.classify_trace(
        jrec, converged=case == "converged")
    assert (int(cls), rate, msg) == (int(jcls), jrate, jmsg)


def test_stagnating_f32_solve_yields_nonconverged_health():
    # kappa = 1e8 in f32: the residual wanders chaotically above the
    # tolerance, so which refinement of MAXITER the trace earns (still
    # converging, STAGNATED, DIVERGED) turns on the rounding of its last
    # rows; the verdict is never CONVERGED
    eigs = np.logspace(0, -8, 48)
    res = pt.solve(torch.as_tensor(np.diag(eigs).astype(np.float32)),
                   torch.ones(48), tol=1e-12, maxiter=400,
                   flight=tfl.FlightConfig.for_solve(400))
    assert not bool(res.converged)
    health = thl.assess_solve_health(
        tfl.FlightRecord.from_buffer(res.flight),
        converged=bool(res.converged), status=int(res.status),
        iterations=int(res.iterations))
    assert health.classification != CGStatus.CONVERGED
    with tev.capture() as buf:
        with tsession.observe_solve("stagnation probe",
                                    engine="general") as obs:
            obs.finish(res, elapsed_s=0.1, health=health)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    hl = [ln for ln in lines if ln["event"] == "solve_health"]
    assert len(hl) == 1 and hl[0]["converged"] is False
    assert hl[0]["classification"] == health.classification.name
    jev.validate_event(hl[0])
    end = [ln for ln in lines if ln["event"] == "solve_end"][-1]
    assert end["health"]["classification"] == health.classification.name
    snap = REGISTRY.snapshot()
    assert any(s["labels"].get("engine") == "general"
               for s in snap["solve_residual_decay_rate"]["series"])
