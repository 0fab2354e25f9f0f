"""The port's runtime calibration, drift tracking and calibrated replan
loop (``telemetry.calibrate``, ``parallel.solve_sequence``) against the
JAX package's.

The JAX ``tests/test_calibrate.py`` classes ``TestFit``,
``TestObservationFor``, ``TestJsonCache``, ``TestPersistence`` and
``TestDrift`` run here on the port, with the names their module looks up
(``cal``, ``ss``, ``roof``, ``events``, ``REGISTRY``, ``score_report``,
``JsonCache``, ``BASE``, ...) bound to the port's for each case; the
one case that reaches the JAX ``resolve_plan`` by import runs the port's
instead.  Beside them, parity cases hold the port's outputs to the JAX
package's on the same inputs:

* ``fit_machine_model`` with an explicit ``base=``: ``to_json`` equal
  apart from ``created_at`` (the backend name and host agree);
* ``observation_for`` on the skewed fixture's reports, ``drift_report``
  and ``fit_link_bandwidths``: equal;
* a fit stored by either package loads in the other (one cache key on
  the CPU, ``calibration-cpu-<host>``);
* ``solve_sequence`` on the skewed fixture at 4 shards (``repeats=3``,
  ``plan="auto"``) with both packages' ``utils.timing.time_fn`` pinned to
  the same hand-chosen elapsed times, both planners pricing with
  ``models.skewed.PLANNING_MODEL`` and both fits with one base model:
  equal iterations, fits, drift, decisions and plan fingerprints - on
  the allgather lane, and the port's ``ring-shiftell`` against the JAX
  ``ring`` (both price the ring's rotation).

Timing is pinned, never measured, so no case depends on the host's
speed.  The zero-perturbation cases record every aten op of a
distributed solve with a ``TorchDispatchMode`` around the whole
calibration pipeline.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import cuda_mpi_parallel_tpu.native.bindings as jnative
import test_calibrate as jt
from cuda_mpi_parallel_tpu.balance import plan as jplan
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.parallel import dist_cg as jdist
from cuda_mpi_parallel_tpu.parallel import make_mesh as jmake_mesh
from cuda_mpi_parallel_tpu.parallel import solve_sequence as jsolve_sequence
from cuda_mpi_parallel_tpu.telemetry import calibrate as jcal
from cuda_mpi_parallel_tpu.telemetry import events as jev
from cuda_mpi_parallel_tpu.telemetry import shardscope as jss
from cuda_mpi_parallel_tpu.telemetry.roofline import MachineModel as JModel
from cuda_mpi_parallel_tpu.utils import timing as jtiming
from cuda_mpi_parallel_tpu.utils.tune import JsonCache as JJsonCache
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.balance import nnz_split
from cuda_mpi_parallel_tpu_torch.balance import plan as tplan
from cuda_mpi_parallel_tpu_torch.models import mmio
from cuda_mpi_parallel_tpu_torch.models.skewed import PLANNING_MODEL
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.telemetry import calibrate as tcal
from cuda_mpi_parallel_tpu_torch.telemetry import events as tev
from cuda_mpi_parallel_tpu_torch.telemetry import roofline as troof
from cuda_mpi_parallel_tpu_torch.telemetry import shardscope as tss
from cuda_mpi_parallel_tpu_torch.telemetry.registry import REGISTRY
from cuda_mpi_parallel_tpu_torch.utils import timing as ttiming
from cuda_mpi_parallel_tpu_torch.utils import tune as ttune

torch.set_num_threads(1)

FIXTURE = jt.FIXTURE
#: the JAX cases' base model, as the port's MachineModel
BASE = troof.MachineModel(**jt.BASE.to_json())
#: hand-chosen elapsed seconds of a sequence's three timed solves
SEQUENCE_TIMES = (0.0213, 0.0161, 0.0158)


@pytest.fixture
def on_the_port(monkeypatch):
    """Bind the JAX test module's names to the port's."""
    for name, value in (("cal", tcal), ("ss", tss), ("roof", troof),
                        ("events", tev), ("REGISTRY", REGISTRY),
                        ("score_report", tplan.score_report),
                        ("plan_partition", tplan.plan_partition),
                        ("reference_model", tplan.reference_model),
                        ("JsonCache", ttune.JsonCache),
                        ("host_fingerprint", ttune.host_fingerprint),
                        ("BASE", BASE)):
        monkeypatch.setattr(jt, name, value)


@pytest.mark.usefixtures("on_the_port")
class TestPortFit(jt.TestFit):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortObservationFor(jt.TestObservationFor):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortJsonCache(jt.TestJsonCache):
    pass


@pytest.mark.usefixtures("on_the_port")
class TestPortPersistence(jt.TestPersistence):
    def test_auto_plan_prefers_stored_calibration(self, tmp_path,
                                                  monkeypatch):
        """A confident calibration in the (env-pointed) default cache
        steers the port's plan='auto', through resolve_plan as
        solve_distributed hits it."""
        monkeypatch.setenv("CUDA_MPI_PARALLEL_TPU_CACHE_DIR",
                           str(tmp_path))
        fit = self._fit()
        assert tcal.store_calibration(fit) is not None
        a = mmio.load_matrix_market(FIXTURE, device="cpu")
        plan = tdist.resolve_plan("auto", a, 4)
        assert plan.scored_by == fit.model.name
        assert plan.scored_by.startswith("calibrated-")


@pytest.mark.usefixtures("on_the_port")
class TestPortDrift(jt.TestDrift):
    pass


# -- resolve_plan prefers a stored calibration --------------------------------


def _confident_fit(created_at=None, iterations=100):
    obs = [jt.synthetic_obs(1e10, 5e9, g, w, iterations=iterations)
           for g, w in ((1e6, 1e5), (4e6, 2e5))]
    obs = [tcal.PhaseObservation(**o.to_json()) for o in obs]
    fit = tcal.fit_machine_model(obs, base=BASE, backend="cpu")
    if created_at is not None:
        fit = dataclasses.replace(fit, model=dataclasses.replace(
            fit.model, created_at=created_at))
    return fit


@pytest.mark.parametrize("stored", ["confident", "stale", "unconfident",
                                    "none"])
def test_resolve_plan_auto_prefers_a_fresh_confident_fit(
        stored, tmp_path, monkeypatch):
    """plan='auto' with no model= scores with the stored fit when it is
    fresh and confident (the JAX tests/test_calibrate.py:249-287 rules),
    and with the H100 reference table otherwise."""
    monkeypatch.setenv("CUDA_MPI_PARALLEL_TPU_CACHE_DIR", str(tmp_path))
    fit = {"confident": _confident_fit(),
           "stale": _confident_fit(
               created_at=time.time() - 2 * tcal.CALIBRATION_MAX_AGE_S),
           "unconfident": _confident_fit(iterations=2),
           "none": None}[stored]
    if fit is not None:
        assert tcal.store_calibration(fit) is not None
    a = mmio.load_matrix_market(FIXTURE, device="cpu")
    plan = tdist.resolve_plan("auto", a, 4)
    direct = tplan.plan_partition(
        a, 4, model=fit.model if stored == "confident" else None)
    if stored == "confident":
        assert fit.confident and plan.scored_by == fit.model.name
    else:
        assert plan.scored_by == tplan.REFERENCE_NAME
    assert plan.fingerprint() == direct.fingerprint()


# -- parity with the JAX package ----------------------------------------------


def _close(ours, theirs, rel=1e-12):
    """Nested JSON equal, floats to ``rel``."""
    if isinstance(ours, dict):
        assert set(ours) == set(theirs)
        for k in ours:
            _close(ours[k], theirs[k], rel)
    elif isinstance(ours, (list, tuple)):
        assert len(ours) == len(theirs)
        for o, t in zip(ours, theirs):
            _close(o, t, rel)
    elif isinstance(ours, float) and not isinstance(theirs, bool):
        assert ours == pytest.approx(theirs, rel=rel, abs=0.0)
    else:
        assert ours == theirs


def _strip(fit_json):
    """A fit's JSON without its creation stamp."""
    out = json.loads(json.dumps(fit_json))
    out["model"].pop("created_at")
    return out


#: (gather_bw, net_bw, [(gather_bytes, net_bytes, iterations)...]):
#: lstsq2, fixed-net, too few iterations, and a fallback
FIT_CASES = {
    "lstsq2": (2.0e10, 5.0e9, [(1e6, 1e5, 100), (4e6, 2e5, 100)]),
    "fixed-net": (1.0e10, 4.5e10, [(2e6, 3e5, 100)]),
    "few-iterations": (1.0e10, 4.5e10, [(2e6, 3e5, 3)]),
    "noisy": (1.0e10, 4.5e10, [(2e6, 3e5, 100), (2e6, 3e5, 50)]),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_machine_model_matches_jax(case):
    gbw, nbw, rows = FIT_CASES[case]
    jobs = [jt.synthetic_obs(gbw, nbw, g, w, iterations=i)
            for g, w, i in rows]
    if case == "noisy":
        jobs[1] = jcal.PhaseObservation(
            iterations=50, elapsed_s=jobs[1].elapsed_s * 3.0,
            gather_bytes_per_iteration=2e6, net_bytes_per_iteration=3e5)
    tobs = [tcal.PhaseObservation(**o.to_json()) for o in jobs]
    links = [{"shift": 1, "bytes": 352, "seconds": 1e-5}]
    ours = tcal.fit_machine_model(tobs, base=BASE, backend="cpu",
                                  per_link=tcal.fit_link_bandwidths(links))
    theirs = jcal.fit_machine_model(jobs, base=jt.BASE, backend="cpu",
                                    per_link=jcal.fit_link_bandwidths(links))
    assert _strip(ours.to_json()) == _strip(theirs.to_json())
    assert ours.describe() == theirs.describe()


def _reports():
    """Both packages' coupling reports of the skewed fixture's even split
    at 4 shards."""
    ta = mmio.load_matrix_market(FIXTURE, device="cpu")
    ja = jmmio.load_matrix_market(FIXTURE)
    ranges = nnz_split.even_ranges(240, 4)
    return (tss.report_for_ranges(ta, ranges, itemsize=8),
            jss.report_for_ranges(ja, ranges, itemsize=8))


@pytest.mark.parametrize("exchange", ["allgather", "gather", "ring"])
def test_observation_and_drift_match_jax(exchange):
    ours, theirs = _reports()
    assert ours.to_json() == theirs.to_json()
    kw = dict(itemsize=8, exchange=exchange, label="solve0")
    assert tcal.observation_for(ours, 57, 0.0213, **kw).to_json() \
        == jcal.observation_for(theirs, 57, 0.0213, **kw).to_json()
    dkw = dict(itemsize=8, exchange=exchange)
    model = troof.MachineModel(**PLANNING_MODEL)
    jmodel = JModel(**PLANNING_MODEL)
    d_ours = tcal.drift_report(ours, 57, 0.0213, model=model, **dkw)
    d_theirs = jcal.drift_report(theirs, 57, 0.0213, model=jmodel, **dkw)
    _close(d_ours.to_json(), d_theirs.to_json())
    assert d_ours.describe() == d_theirs.describe()


def test_link_bandwidths_match_jax():
    rounds = [(1, 1000, 4e-7), (2, 600, 8e-7),
              {"shift": 3, "bytes": 352, "seconds": 1e-5}]
    assert tcal.fit_link_bandwidths(rounds) \
        == jcal.fit_link_bandwidths(rounds)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_stored_fit_loads_in_the_other_package(writer, tmp_path):
    tobs = [tcal.PhaseObservation(**o.to_json()) for o in (
        jt.synthetic_obs(1e10, 5e9, 1e6, 1e5),
        jt.synthetic_obs(1e10, 5e9, 4e6, 2e5))]
    jobs = [jcal.PhaseObservation(**o.to_json()) for o in tobs]
    if writer == "port":
        fit = tcal.fit_machine_model(tobs, base=BASE, backend="cpu")
        assert tcal.store_calibration(
            fit, cache=ttune.JsonCache(str(tmp_path))) is not None
        back = jcal.load_calibration("cpu", cache=JJsonCache(str(tmp_path)))
    else:
        fit = jcal.fit_machine_model(jobs, base=jt.BASE, backend="cpu")
        assert jcal.store_calibration(
            fit, cache=JJsonCache(str(tmp_path))) is not None
        back = tcal.load_calibration("cpu",
                                     cache=ttune.JsonCache(str(tmp_path)))
    assert tcal.cache_key("cpu") == jcal.cache_key("cpu")
    assert back is not None and back.to_json() == fit.to_json()


def test_backend_names_follow_the_device():
    """The port names a fit's backend from the device: "cuda" (any card
    index) or "cpu"; None is the card."""
    host = ttune.host_fingerprint()
    assert tcal.cache_key() == f"calibration-cuda-{host}"
    assert tcal.cache_key(torch.device("cuda", 1)) \
        == f"calibration-cuda-{host}"
    assert tcal.cache_key(torch.device("cpu")) == f"calibration-cpu-{host}"
    fit = _confident_fit()
    assert fit.backend == "cpu" and fit.model.name.startswith(
        "calibrated-cpu-")


# -- solve_sequence with pinned timing ------------------------------------------


def pinned_time_fn(times):
    """A ``time_fn`` that runs ``fn`` as the real one does (warmup, then
    the timed calls) and reports the next of ``times``."""
    it = iter(times)

    def time_fn(fn, *args, warmup=1, repeats=5, reduce="best", **kw):
        res = None
        for _ in range(max(warmup, 1) + repeats):
            res = fn(*args, **kw)
        return next(it), res
    return time_fn


def _sequence_patches(mp, package):
    """One planning model for both planners, one base model for both
    fits, the JAX RCM on its scipy fallback, and the pinned clock."""
    mp.setattr(jnative, "available", lambda: False)
    if package == "jax":
        mp.setattr(jplan, "reference_model",
                   lambda: JModel(**PLANNING_MODEL))
        mp.setattr(jcal, "machine_model", lambda backend=None: jt.BASE)
        mp.setattr(jtiming, "time_fn", pinned_time_fn(SEQUENCE_TIMES))
    else:
        mp.setattr(tplan, "reference_model",
                   lambda: troof.MachineModel(**PLANNING_MODEL))
        mp.setattr(tcal, "machine_model",
                   lambda backend=None, **kw: BASE)
        mp.setattr(ttiming, "time_fn", pinned_time_fn(SEQUENCE_TIMES))


#: the port's lane, the JAX lane it is held to
SEQUENCE_LANES = {"allgather": ({}, {}),
                  "ring-shiftell": ({"csr_comm": "ring-shiftell"},
                                    {"csr_comm": "ring"})}
SEQ_KW = dict(repeats=3, plan="auto", tol=1e-10, maxiter=2000)


def _digest(seq, events):
    """What a sequence decided, comparable across packages."""
    out = []
    for e in seq.entries:
        out.append(dict(
            iterations=int(e.result.iterations),
            converged=bool(e.result.converged),
            elapsed_s=e.elapsed_s,
            plan=None if e.plan is None else e.plan.label,
            fingerprint=None if e.plan is None else e.plan.fingerprint(),
            scored_by=None if e.plan is None else e.plan.scored_by,
            fit=_strip(e.fit.to_json()),
            drift=e.drift.to_json(),
            replan=e.replan))
    replans = [r for r in events if r["event"] == "replan"]
    return out, replans


@pytest.fixture(scope="module")
def jax_sequences(tmp_path_factory):
    """Each lane's JAX sequence, once."""
    out = {}
    b = np.random.default_rng(3).standard_normal(240)
    a = jmmio.load_matrix_market(FIXTURE)
    for lane, (_, jkw) in SEQUENCE_LANES.items():
        jdist.clear_solver_cache()
        cache = JJsonCache(str(tmp_path_factory.mktemp("jax-" + lane)))
        with pytest.MonkeyPatch.context() as mp:
            _sequence_patches(mp, "jax")
            with jev.capture() as buf:
                seq = jsolve_sequence(a, b, mesh=jmake_mesh(4),
                                      calibration_cache=cache, **SEQ_KW,
                                      **jkw)
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.strip()]
        out[lane] = _digest(seq, recs) + (np.asarray(seq.result.x),)
    return out


@pytest.mark.parametrize("lane", sorted(SEQUENCE_LANES))
def test_solve_sequence_matches_jax(lane, jax_sequences, tmp_path,
                                    monkeypatch):
    _sequence_patches(monkeypatch, "port")
    tdist.clear_solver_cache()
    a = mmio.load_matrix_market(FIXTURE, device="cpu")
    b = np.random.default_rng(3).standard_normal(240)
    with tev.capture() as buf:
        seq = tpar.solve_sequence(
            a, b, mesh=tpar.make_mesh(4, devices=["cpu"] * 4),
            calibration_cache=ttune.JsonCache(str(tmp_path)), **SEQ_KW,
            **SEQUENCE_LANES[lane][0])
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]
    for rec in recs:
        jev.validate_event(rec)
    ours, replans = _digest(seq, recs)
    theirs, jreplans, jx = jax_sequences[lane]
    assert len(replans) == len(jreplans) == 2
    assert [r["solve_index"] for r in replans] == [1, 2]
    _close(ours, theirs)
    np.testing.assert_allclose(seq.result.x.numpy(), jx, rtol=0,
                               atol=1e-10)
    drifts = [r for r in recs if r["event"] == "partition_plan"
              and r.get("stage") == "drift"]
    assert len(drifts) == 3
    assert seq.summary()["repeats"] == 3
    assert any("replan" in ln for ln in seq.describe_lines())
    assert tcal.load_calibration("cpu", cache=ttune.JsonCache(
        str(tmp_path))) is not None


def test_sequence_rejects_stencils_and_bad_repeats():
    from cuda_mpi_parallel_tpu_torch.models import poisson

    m = tpar.make_mesh(4, devices=["cpu"] * 4)
    stencil = poisson.poisson_2d_operator(16, 16, device="cpu")
    with pytest.raises(ValueError, match="CSRMatrix"):
        tpar.solve_sequence(stencil, np.ones(256), mesh=m)
    a = mmio.load_matrix_market(FIXTURE, device="cpu")
    with pytest.raises(ValueError, match="repeats"):
        tpar.solve_sequence(a, np.ones(240), mesh=m, repeats=0)


# -- zero perturbation ----------------------------------------------------------


class OpRecord(TorchDispatchMode):
    """Every aten op dispatched inside the mode, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _recorded_solve():
    from cuda_mpi_parallel_tpu_torch.models import poisson

    tdist.clear_solver_cache()
    a = poisson.poisson_2d_csr(8, 8, device="cpu")
    mesh = tpar.make_mesh(4, devices=["cpu"] * 4)
    with OpRecord() as rec:
        res = tpar.solve_distributed(a, np.ones(64), mesh=mesh,
                                     maxiter=25)
    return rec.ops, res.x.clone()


def test_calibration_machinery_leaves_the_solve_unchanged(tmp_path):
    """The whole calibration pipeline (fit, persist, preferred-model
    lookup, drift with its gauges and event) between two recorded
    distributed solves: the same aten ops, the same bits."""
    ops, x = _recorded_solve()
    cache = ttune.JsonCache(str(tmp_path))
    fit = _confident_fit()
    tcal.note_calibration(fit)
    tcal.store_calibration(fit, cache=cache)
    assert tcal.preferred_model("cpu", cache=cache) is not None
    from cuda_mpi_parallel_tpu_torch.models import poisson

    a = poisson.poisson_2d_csr(8, 8, device="cpu")
    rep = tss.report_for_ranges(a, ((0, 16), (16, 32), (32, 48), (48, 64)),
                                itemsize=8)
    with tev.capture():
        tcal.note_drift(tcal.drift_report(rep, 25, 0.1, itemsize=8),
                        report=rep)
    ops2, x2 = _recorded_solve()
    assert ops2 == ops
    assert torch.equal(x2, x)


def test_resolve_plan_auto_unchanged_without_calibration(tmp_path,
                                                         monkeypatch):
    """With no calibration on disk, plan='auto' resolves the plan a direct
    plan_partition call gives, scored by the H100 reference table."""
    monkeypatch.setenv("CUDA_MPI_PARALLEL_TPU_CACHE_DIR",
                       str(tmp_path / "empty"))
    a = mmio.load_matrix_market(FIXTURE, device="cpu")
    direct = tplan.plan_partition(a, 4)
    resolved = tdist.resolve_plan("auto", a, 4)
    assert direct.scored_by == resolved.scored_by == "reference-h100"
    assert resolved.fingerprint() == direct.fingerprint()
    assert resolved.score == pytest.approx(direct.score)
