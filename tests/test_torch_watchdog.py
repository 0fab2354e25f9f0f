"""The port's straggler watchdog (``robust.watchdog``) and its trigger in
the elastic resumable loop (``utils.checkpoint.
solve_resumable_distributed(watchdog=...)``) against the JAX package's.

The JAX ``tests/test_elastic.py`` ``TestWatchdog`` runs here on the port
(its ``StragglerWatchdog``, ``FaultPlan``, ``PhaseProfile`` and
``events`` bound to the port's).  Beside it: the port's and the JAX
watchdog give the same findings, events and baselines for the same
profiles, and a baseline persisted by either package loads in the other
(one cache key on the CPU, ``watchdog-cpu-<host>``).

The ``shard_slow`` drill runs the JAX ``test_shard_slow_watchdog_
migration`` on the skewed fixture at 4 stacked CPU shards with the
profiler's timer pinned to equal per-shard times (``phasetrace.
_time_loop``), so ``FaultPlan.doctor_profile``'s 8x names shard 1 alone
however loaded the host is; the partition, the doctoring, ``observe``,
the checkpoint and the 4 -> 3 migration run for real.  It holds the
drill to the clean 4-shard solve (the count within max(2, 1 %), x within
1e-5, the JAX bound) and to the JAX package's clean solve.  With the
watchdog on and no fault, nothing fires and x is bit-equal to the run
without a watchdog.
"""
import json
import os

import numpy as np
import pytest
import torch

import test_elastic as jt
from cuda_mpi_parallel_tpu.parallel import make_mesh as jmake_mesh
from cuda_mpi_parallel_tpu.parallel import solve_distributed as jsolve
from cuda_mpi_parallel_tpu.robust import StragglerWatchdog as JWatchdog
from cuda_mpi_parallel_tpu.telemetry import events as jev
from cuda_mpi_parallel_tpu.telemetry.phasetrace import PhaseProfile as JPP
from cuda_mpi_parallel_tpu.utils.tune import JsonCache as JJsonCache
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch import robust
from cuda_mpi_parallel_tpu_torch.robust import FaultPlan, StragglerWatchdog
from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
from cuda_mpi_parallel_tpu_torch.telemetry import phasetrace as tpt
from cuda_mpi_parallel_tpu_torch.telemetry.registry import REGISTRY
from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck
from cuda_mpi_parallel_tpu_torch.utils.tune import JsonCache

import torch_df64_ranks as ranks

torch.set_num_threads(1)

DRILL_KW = dict(segment_iters=15, tol=1e-8, maxiter=500)
#: the pinned per-repetition seconds of every profiled phase
PINNED_S = 1e-4


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture
def on_the_port(monkeypatch):
    """Bind the JAX test module's names to the port's."""
    for name, value in (("StragglerWatchdog", StragglerWatchdog),
                        ("FaultPlan", FaultPlan), ("events", tev),
                        ("PhaseProfile", tpt.PhaseProfile)):
        monkeypatch.setattr(jt, name, value)


@pytest.mark.usefixtures("on_the_port")
class TestPortWatchdog(jt.TestWatchdog):
    pass


# -- parity with the JAX watchdog --------------------------------------------------


def _profiles(cls, device=None):
    """A sequence of profiles: healthy, a drift, a 2.5x straggler, a slow
    link, a healthy recovery."""
    def p(spmv, bps):
        spmv = np.asarray(spmv, dtype=float)
        kw = {} if device is None else {"device": device}
        return cls(kind="csr-gather", exchange="gather", n_shards=4,
                   n_local=60, itemsize=8, repeats=4, spmv_s=spmv,
                   spmv_mesh_s=float(spmv.sum()), halo_s=1e-5,
                   reduction_s=1e-6, step_s=float(spmv.sum()) + 2e-5,
                   links=({"shift": 1, "bytes": 416, "seconds": 1e-5,
                           "bytes_per_s": bps},), **kw)
    return [p([1e-4] * 4, 4e7), p([1.2e-4] * 4, 4.2e7),
            p([1e-4, 1e-4, 2.9e-4, 1e-4], 4e7), p([1e-4] * 4, 1e7),
            p([1e-4] * 4, 4e7)]


def _run(wd, profiles, events):
    with events.capture() as buf:
        found = [[d.to_json() for d in wd.observe(p)] for p in profiles]
    recs = [{k: v for k, v in json.loads(ln).items() if k != "t"}
            for ln in buf.getvalue().splitlines() if ln.strip()]
    return found, recs, dict(wd._spmv), dict(wd._links)


@pytest.mark.parametrize("alpha", [0.3, 1.0])
def test_findings_and_baselines_match_jax(alpha):
    ours = _run(StragglerWatchdog(persist=False, alpha=alpha),
                _profiles(tpt.PhaseProfile), tev)
    theirs = _run(JWatchdog(persist=False, alpha=alpha),
                  _profiles(JPP), jev)
    assert ours == theirs
    found = ours[0]
    assert [d["shard"] for d in found[2]] == [2]
    assert [(d["phase"], d["shard"]) for d in found[3]] == [("link", 1)]
    assert [r["event"] for r in ours[1]] == ["shard_degraded"] * 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_persisted_baselines_load_in_the_other_package(writer, tmp_path):
    """On the CPU both packages key a baseline ``watchdog-cpu-<host>``:
    what one persists, the other starts from."""
    cache, jcache = JsonCache(str(tmp_path)), JJsonCache(str(tmp_path))
    if writer == "port":
        wd = StragglerWatchdog(persist=True, cache=cache)
        wd.observe(_profiles(tpt.PhaseProfile, "cpu")[0])
        other = JWatchdog(persist=True, cache=jcache)
        other.observe(_profiles(JPP)[1])
    else:
        wd = JWatchdog(persist=True, cache=jcache)
        wd.observe(_profiles(JPP)[0])
        other = StragglerWatchdog(persist=True, cache=cache)
        other.observe(_profiles(tpt.PhaseProfile, "cpu")[1])
    assert wd._cache_key() == other._cache_key()
    # the second watchdog's EWMA started from the first one's baseline
    assert other._spmv["4:0"] == pytest.approx(0.7 * 1e-4 + 0.3 * 1.2e-4)


def test_the_baseline_key_names_the_profile_device():
    wd = StragglerWatchdog(persist=False)
    wd.observe(_profiles(tpt.PhaseProfile)[0])
    assert wd._cache_key().startswith("watchdog-cuda-")
    wd = StragglerWatchdog(persist=False)
    wd.observe(_profiles(tpt.PhaseProfile, "cpu")[0])
    assert wd._cache_key().startswith("watchdog-cpu-")


# -- the shard_slow drill -----------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    return ranks.resumable_problem(jt.FIXTURE)


@pytest.fixture(scope="module")
def clean(problem):
    """The fault-free 4-shard solve, in the port and in the JAX package."""
    a, b = problem
    ours = tpar.solve_distributed(a, b, mesh=mesh(4), tol=1e-8,
                                  maxiter=500)
    from cuda_mpi_parallel_tpu.models import mmio as jmmio

    theirs = jsolve(jmmio.load_matrix_market(jt.FIXTURE), b,
                    mesh=jmake_mesh(4), tol=1e-8, maxiter=500)
    return ours, np.asarray(theirs.x)


@pytest.fixture
def pinned_profiler(monkeypatch):
    """Every profiled phase reads PINNED_S a repetition: equal shards."""
    def time_loop(fn, *args, repeats, outer=2):
        fn(*args)
        return PINNED_S
    monkeypatch.setattr(tpt, "_time_loop", time_loop)


def _captured(buf):
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]


def _its(res):
    return int(res.iterations)


@pytest.mark.usefixtures("pinned_profiler")
def test_shard_slow_watchdog_migration(problem, clean, tmp_path):
    """The acceptance drill: the watchdog emits shard_degraded for shard
    1 from the doctored-but-real measured profile, the elastic loop
    migrates 4 -> 3 off it, and the solve completes to the fault-free
    answer."""
    a, b = problem
    ref, jx = clean
    wd = StragglerWatchdog(profile_repeats=2, persist=False)
    before = REGISTRY.counter("watchdog_degraded_total", "",
                              labelnames=("phase",)).value(phase="spmv")
    with tev.capture() as buf:
        res = ck.solve_resumable_distributed(
            a, b, str(tmp_path / "slow.npz"), mesh=mesh(4), elastic=True,
            watchdog=wd, inject=FaultPlan.parse("shard_slow:1:1"),
            **DRILL_KW)
    assert bool(res.converged)
    recs = _captured(buf)
    for rec in recs:
        jev.validate_event(rec)
    degs = [e for e in recs if e["event"] == "shard_degraded"]
    migs = [e for e in recs if e["event"] == "solve_migration"]
    profs = [e for e in recs if e["event"] == "partition_plan"
             or e.get("phase") == "phase-profile"]
    assert [(d["shard"], d["phase"]) for d in degs] == [(1, "spmv")]
    assert degs[0]["ratio"] == pytest.approx(8.0)
    assert len(migs) == 1 and migs[0]["reason"] == "shard_degraded"
    assert (migs[0]["n_shards_from"], migs[0]["n_shards_to"]) == (4, 3)
    assert migs[0]["degraded_shards"] == [1]
    assert REGISTRY.counter("watchdog_degraded_total", "",
                            labelnames=("phase",)).value(
                                phase="spmv") == before + 1
    assert [d.shard for d in wd.degradations] == [1]
    assert abs(_its(res) - _its(ref)) <= max(2, 0.01 * _its(ref))
    assert float((res.x - ref.x).abs().max()) < 1e-5
    np.testing.assert_allclose(res.x.numpy(), jx, rtol=0, atol=1e-5)
    assert profs == []          # profiling emits no partition events
    assert not os.path.exists(tmp_path / "slow.npz")


@pytest.mark.usefixtures("pinned_profiler")
def test_watchdog_without_a_fault_changes_nothing(problem, tmp_path):
    """Watchdog on, no fault: no finding, no migration, and x bit-equal
    to the same resumable run without a watchdog."""
    a, b = problem
    plain = ck.solve_resumable_distributed(
        a, b, str(tmp_path / "plain.npz"), mesh=mesh(4), elastic=True,
        **DRILL_KW)
    wd = StragglerWatchdog(profile_repeats=2, persist=False)
    with tev.capture() as buf:
        res = ck.solve_resumable_distributed(
            a, b, str(tmp_path / "wd.npz"), mesh=mesh(4), elastic=True,
            watchdog=wd, **DRILL_KW)
    events = {e["event"] for e in _captured(buf)}
    assert not events & {"shard_degraded", "solve_migration"}
    assert wd.degradations == []
    assert _its(res) == _its(plain)
    assert torch.equal(res.x, plain.x)


@pytest.mark.usefixtures("pinned_profiler")
def test_findings_without_elastic_do_not_migrate(problem, tmp_path):
    """elastic=False: the watchdog still reports the slow shard, and the
    solve goes on on its mesh (the JAX loop's ``drop and elastic``)."""
    a, b = problem
    wd = StragglerWatchdog(profile_repeats=2, persist=False,
                           check_every_segments=2)
    with tev.capture() as buf:
        res = ck.solve_resumable_distributed(
            a, b, str(tmp_path / "r.npz"), mesh=mesh(4), watchdog=wd,
            inject=FaultPlan.parse("shard_slow:2:1"), **DRILL_KW)
    recs = _captured(buf)
    assert bool(res.converged)
    assert [e["shard"] for e in recs if e["event"] == "shard_degraded"] \
        == [1]
    assert not [e for e in recs if e["event"] == "solve_migration"]


def test_host_site_refusals(problem, tmp_path):
    a, b = problem
    with pytest.raises(ValueError, match="watchdog"):
        ck.solve_resumable_distributed(
            a, b, str(tmp_path / "r1.npz"), mesh=mesh(4), elastic=True,
            inject=FaultPlan.parse("shard_slow:1:1"), **DRILL_KW)
    with pytest.raises(ValueError, match="mesh has 4"):
        ck.solve_resumable_distributed(
            a, b, str(tmp_path / "r2.npz"), mesh=mesh(4), elastic=True,
            watchdog=StragglerWatchdog(persist=False),
            inject=FaultPlan.parse("shard_slow:1:4"), **DRILL_KW)
    with pytest.raises(ValueError, match="ratio"):
        StragglerWatchdog(threshold=1.0)
    with pytest.raises(ValueError, match="alpha"):
        StragglerWatchdog(alpha=0.0)
    with pytest.raises(ValueError, match="check_every_segments"):
        StragglerWatchdog(check_every_segments=0)
    assert robust.StragglerWatchdog is StragglerWatchdog
    assert robust.watchdog.DEFAULT_THRESHOLD == 2.0
