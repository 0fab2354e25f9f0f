"""The port's device-memory accounting (``telemetry.memscope``) against
the JAX package's.

Exact: the capacity classification, ``csr_slot_bytes``,
``solver_bytes_per_shard``, ``predict_slots``/``predict_footprint``,
``smallest_fitting_mesh``, and the matrix bytes and footprints of the CSR
families (allgather, gather, ring; even and plan-driven splits of the
240-row skewed fixture), whose JSON crosses packages.  The ring shift-ELL
families' matrix bytes are the port's own (sliced ELL): held to the live
tensors the lane pins, summed exactly - on a stacked mesh the one pack a
step of ``parallel.dist_cg.ring_step_tensors``, on a rank its own.

The peak record (``PeakRecord``, the port's counterpart of the JAX
jaxpr liveness walk) is held to properties, not to the JAX value: it
frees a chain of temporaries whose last uses have passed, counts its
inputs, and a telemetered solve's recorded peak covers the persistent
footprint of every lane; on the allgather lane the peak holds the
``(P * n_local, k)`` gathered stack (on a stacked mesh the stack the
all_gather views) beside the matrix and the other working stacks.
"""
import json
import os

import numpy as np
import pytest
import torch

from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.parallel import partition as jpart
from cuda_mpi_parallel_tpu.telemetry import memscope as jms
from cuda_mpi_parallel_tpu.telemetry.roofline import MachineModel as JModel

from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch import telemetry
from cuda_mpi_parallel_tpu_torch.balance import nnz_split
from cuda_mpi_parallel_tpu_torch.models import mmio
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.parallel import partition as tpart
from cuda_mpi_parallel_tpu_torch.telemetry import events
from cuda_mpi_parallel_tpu_torch.telemetry import memscope as ms
from cuda_mpi_parallel_tpu_torch.telemetry.roofline import MachineModel

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
MODEL = dict(name="m", mem_bytes_per_s=1e12, flops_per_s=1e13,
             hbm_bytes=2.0e6)


@pytest.fixture(scope="module")
def pair():
    return (jmmio.load_matrix_market(FIXTURE),
            mmio.load_matrix_market(FIXTURE, device="cpu"))


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def _ranges(ja, p, split):
    if split is None:
        return None
    return nnz_split.balanced_nnz_ranges(np.asarray(ja.indptr), p)


# -- classification and capacity ------------------------------------------------


@pytest.mark.parametrize("peak", [0, 1, 79, 80, 81, 100, 101, 1e9])
@pytest.mark.parametrize("cap", [None, 0, 100, 1e10])
def test_classify(peak, cap):
    assert ms.classify(peak, cap) == jms.classify(peak, cap)
    assert ms.TIGHT_FRACTION == jms.TIGHT_FRACTION
    assert ms.HBM_BYTES_ENV == jms.HBM_BYTES_ENV


def test_hbm_bytes_for(monkeypatch):
    model, jmodel = MachineModel(**MODEL), JModel(**MODEL)
    assert ms.hbm_bytes_for(model) == jms.hbm_bytes_for(jmodel) == 2.0e6
    from cuda_mpi_parallel_tpu_torch.telemetry.roofline import (
        _host_ram_bytes,
    )

    assert ms.hbm_bytes_for(backend="cpu") == _host_ram_bytes()
    monkeypatch.setenv(ms.HBM_BYTES_ENV, "12345")
    assert ms.hbm_bytes_for(model) == jms.hbm_bytes_for(jmodel) == 12345.0
    monkeypatch.setenv(ms.HBM_BYTES_ENV, "lots")
    for mod, m in ((ms, model), (jms, jmodel)):
        with pytest.raises(ValueError, match="number of bytes"):
            mod.hbm_bytes_for(m)


# -- the static model -----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_local=60, n_shards=4, itemsize=8),
    dict(n_local=60, n_shards=4, itemsize=4, n_rhs=3, exchange="gather",
         halo_width=17),
    dict(n_local=61, n_shards=3, itemsize=4, exchange="ring", df64=True),
    dict(n_local=60, n_shards=4, itemsize=8, exchange="ring-shiftell",
         flight_capacity=64, basis_m=8),
    dict(n_local=60, n_shards=4, itemsize=8, n_rhs=5, flight_capacity=9)])
def test_solver_bytes(kw):
    assert ms.solver_bytes_per_shard(**kw) == jms.solver_bytes_per_shard(**kw)
    assert np.array_equal(ms.csr_slot_bytes(np.arange(5), 8),
                          jms.csr_slot_bytes(np.arange(5), 8))
    with pytest.raises(ValueError, match="unknown exchange"):
        ms.solver_bytes_per_shard(n_local=1, n_shards=1, itemsize=4,
                                  exchange="mail")


@pytest.mark.parametrize("split", [None, "nnz"])
@pytest.mark.parametrize("family,p", [("allgather", 4), ("gather", 4),
                                      ("ring", 3), ("allgather", 2)])
def test_csr_footprints_are_the_jax_ones(pair, family, p, split):
    ja, ta = pair
    ranges = _ranges(ja, p, split)
    if family == "ring":
        jparts = jpart.ring_partition_csr(ja, p, ranges)
        tparts = tpart.ring_partition_csr(ta, p, ranges)
    else:
        jparts = jpart.partition_csr(ja, p, ranges, exchange=family)
        tparts = tpart.partition_csr(ta, p, ranges, exchange=family)
    assert np.array_equal(ms.matrix_bytes_per_shard(tparts),
                          jms.matrix_bytes_per_shard(jparts))
    for kw in (dict(), dict(n_rhs=4, flight_capacity=32, basis_m=3)):
        ours = ms.footprint_for_partition(tparts, hbm_bytes=3.0e5,
                                          jaxpr_peak=123456, **kw)
        theirs = jms.footprint_for_partition(jparts, hbm_bytes=3.0e5,
                                             jaxpr_peak=123456, **kw)
        assert ours.to_json() == theirs.to_json()
        assert ours.describe() == theirs.describe()
        blob = json.loads(json.dumps(ours.to_json()))
        assert ms.MemoryFootprint.from_json(blob).to_json() == blob
        assert jms.MemoryFootprint.from_json(blob).to_json() == blob


@pytest.mark.parametrize("kw", [
    dict(n=240, n_shards=4, nnz=1000),
    dict(n=241, n_shards=4, nnz=1000, itemsize=8, exchange="ring",
         n_rhs=2),
    dict(n=240, n_shards=3, nnz=999, df64=True, flight_capacity=5),
    dict(n=240, n_shards=4, indptr="fixture"),
    dict(n=240, n_shards=4, indptr="fixture", row_ranges="nnz"),
])
def test_predictions(pair, kw):
    ja, _ = pair
    kw = dict(kw)
    if kw.get("indptr") == "fixture":
        kw["indptr"] = np.asarray(ja.indptr)
    if kw.get("row_ranges") == "nnz":
        kw["row_ranges"] = _ranges(ja, 4, "nnz")
    slot_kw = {k: kw[k] for k in ("nnz", "indptr", "row_ranges")
               if k in kw}
    assert ms.predict_slots(kw["n"], kw["n_shards"], **slot_kw) \
        == jms.predict_slots(kw["n"], kw["n_shards"], **slot_kw)
    assert ms.predict_footprint(hbm_bytes=1e6, **kw).to_json() \
        == jms.predict_footprint(hbm_bytes=1e6, **kw).to_json()
    kw.pop("row_ranges", None)
    for budget in (1e3, 2e4, 1e5, 1e9):
        fit = dict(kw, budget_bytes=budget)
        fit.pop("n_shards")
        assert ms.smallest_fitting_mesh(**fit) \
            == jms.smallest_fitting_mesh(**fit)
    with pytest.raises(ValueError, match="nnz= or indptr="):
        ms.predict_slots(10, 2)


def test_budget_error_fields():
    e = ms.MemoryBudgetError("m", required_bytes=10, budget_bytes=5.5,
                             n_shards=4, smallest_fitting_mesh=8)
    j = jms.MemoryBudgetError("m", required_bytes=10, budget_bytes=5.5,
                              n_shards=4, smallest_fitting_mesh=8)
    assert vars(e) == vars(j)
    assert isinstance(e, RuntimeError)


# -- the measured twin: ring shift-ELL packs ----------------------------------------


@pytest.mark.parametrize("df64", [False, True])
@pytest.mark.parametrize("split", [None, "nnz"])
def test_ring_shiftell_bytes_are_the_live_tensors(pair, df64, split):
    """The sum over shards equals the bytes of the tensors the lane
    pins, exactly: the stacked mesh's one pack a step, and each rank's
    own pack (``shard_ids=(k,)``)."""
    ja, ta = pair
    fn = tpart.ring_partition_shiftell_df64 if df64 \
        else tpart.ring_partition_shiftell
    parts = fn(ta, 4, row_ranges=_ranges(ja, 4, split))
    m = mesh(4)
    live = tdist.ring_step_tensors(parts, m) + (
        tdist._local_rows(parts.diag, m),)
    per = ms.matrix_bytes_per_shard(parts)
    assert int(per.sum()) == ms.live_device_bytes(live)
    assert np.array_equal(per, ms.matrix_bytes_per_shard(parts, range(4)))
    alone = ms.matrix_bytes_per_shard(parts, shard_ids=(2,))
    for k in range(4):
        own = [tpart.stack_ring_step(parts, t, (k,)) for t in range(4)]
        want = sum(p.vals.nbytes + p.cols.nbytes + p.slice_ptr.nbytes
                   for p in own) + parts.diag[k].nbytes
        assert int(alone[k]) == want
    fp = ms.footprint_for_partition(parts, hbm_bytes=None)
    assert fp.kind == ("ring-shiftell-df64" if df64 else "ring-shiftell")
    assert fp.itemsize == (4 if df64 else 8)
    assert int(fp.solver_bytes[0]) == ms.solver_bytes_per_shard(
        n_local=parts.n_local, n_shards=4, itemsize=fp.itemsize,
        exchange="ring-shiftell", df64=df64)


def test_live_device_bytes_and_drift_check(pair):
    _, ta = pair
    parts = tpart.partition_csr(ta, 4)
    fp = ms.footprint_for_partition(parts, hbm_bytes=None)
    tensors = {"d": torch.as_tensor(parts.data),
               "c": [torch.as_tensor(parts.cols),
                     (torch.as_tensor(parts.local_rows),)]}
    measured = ms.live_device_bytes(tensors)
    assert measured == int(fp.matrix_bytes.sum())
    ms.reset_last_memory_profile()
    ms.note_footprint(fp, measured_bytes=measured)
    assert ms.last_memory_profile()["measured_bytes"] == measured
    ms.note_footprint(fp, measured_bytes=measured // 4, shard_ids=(1,))
    with pytest.raises(AssertionError, match="memscope model drift"):
        ms.note_footprint(fp, measured_bytes=measured + 4)
    assert ms.device_memory_peak("cpu") is None


# -- the peak record ------------------------------------------------------------


def test_peak_record_frees_dead_temporaries():
    """A chain of temporaries whose last uses have passed holds at most
    two of them at once, beside the input; a kept one stays counted."""
    x = torch.ones(1000, dtype=torch.float64)
    block = 8000

    def chain(v):
        for _ in range(20):
            v = v + 1.0
        return v

    assert ms.solve_peak_bytes(chain, x) == 3 * block

    def kept(v):
        out = [v + float(i) for i in range(5)]
        return out

    assert ms.solve_peak_bytes(kept, x) == 6 * block
    rec = ms.PeakRecord("cpu").add((x, [x[:10]], {"y": x}))
    assert rec.live == rec.peak == block
    with rec:
        y = x * 2.0
        z = y.view(10, 100)          # a view: no new storage
        del y, z
    assert rec.peak == 2 * block and rec.live == block


def test_a_stopped_record_keeps_its_peak():
    """``stop`` ends the record between operations: what is made after
    it is not counted, the peak before it stands, and the ``with``
    exit after it is a no-op."""
    x = torch.ones(1000, dtype=torch.float64)
    rec = ms.PeakRecord("cpu").add(x)
    with rec:
        y = x * 2.0
        rec.stop()
        z = [x + float(i) for i in range(4)]
    assert rec.peak == 2 * 8000
    del y, z


@pytest.mark.parametrize("lane", [
    dict(), dict(exchange="gather"), dict(csr_comm="ring"),
    dict(csr_comm="ring-shiftell"), dict(plan="auto")],
    ids=["allgather", "gather", "ring", "ring-shiftell", "planned"])
def test_first_trips_record_finds_the_whole_solve_peak(pair, lane,
                                                      monkeypatch):
    """The telemetered first solve records its peak over the setup and
    the first two loop trips only: the same peak as a record of the
    whole solve (``stop`` disabled)."""
    _, ta = pair
    b = np.random.default_rng(0).standard_normal(240)

    def recorded_peak():
        tdist.clear_solver_cache()
        try:
            telemetry.force_active(True)
            res = tpar.solve_distributed(ta, b, mesh=mesh(4), tol=1e-10,
                                         maxiter=400, **lane)
        finally:
            telemetry.force_active(False)
        assert int(res.iterations) > 10
        return list(tdist._PEAK_CACHE.values())[-1]

    first_trip = recorded_peak()
    monkeypatch.setattr(ms.PeakRecord, "stop", lambda self: None)
    assert recorded_peak() == first_trip


@pytest.mark.parametrize("lane", [
    dict(), dict(exchange="gather"), dict(csr_comm="ring"),
    dict(csr_comm="ring-shiftell"), dict(plan="auto")],
    ids=["allgather", "gather", "ring", "ring-shiftell", "planned"])
def test_telemetered_solve_notes_its_footprint(pair, lane):
    """``memory_profile``: the matrix bytes measured on the live tensors,
    the recorded peak covering the persistent footprint."""
    _, ta = pair
    b = np.random.default_rng(0).standard_normal(240)
    tdist.clear_solver_cache()
    ms.reset_last_memory_profile()
    with events.capture() as buf:
        res = tpar.solve_distributed(ta, b, mesh=mesh(4), tol=1e-10,
                                     maxiter=400, **lane)
    assert bool(res.converged)
    prof = ms.last_memory_profile()
    fp = prof["footprint"]
    assert prof["measured_bytes"] == int(fp.matrix_bytes.sum())
    key = list(tdist._PEAK_CACHE)[-1]
    peak = tdist._PEAK_CACHE[key]
    assert peak >= int(fp.persistent_bytes.sum())
    assert fp.jaxpr_peak_bytes == -(-peak // 4)
    assert fp.peak_bytes >= int(fp.persistent_bytes.max())
    assert fp.classification == "FITS"
    ev, = [json.loads(ln) for ln in buf.getvalue().splitlines()
           if '"memory_profile"' in ln]
    events.validate_event(ev)
    assert ev["measured_bytes"] == prof["measured_bytes"]
    assert telemetry.REGISTRY.gauge(
        "hbm_bytes_peak", "", labelnames=("kind",)).value(kind=fp.kind) \
        == float(fp.peak_bytes)


def test_allgather_peak_holds_the_gathered_stack(pair):
    """The many-RHS allgather lane at k = 4: at the peak the matrix, the
    (P * n_local, k) gathered stack and the other working stacks (b, x,
    r, Ap) are all live - on a stacked mesh the all_gather is a view of
    the p stack, so its bytes are that storage's."""
    _, ta = pair
    stack = np.random.default_rng(4).standard_normal((240, 4))
    tdist.clear_solver_cache()
    try:
        telemetry.force_active(True)
        disp = tpar.ManyRHSDispatcher(ta, mesh=mesh(4), maxiter=400)
        disp.solve(stack, tol=1e-9)
    finally:
        telemetry.force_active(False)
    peak = list(tdist._PEAK_CACHE.values())[-1]
    gathered = 4 * disp.parts.n_local * 4 * 8
    matrix = ms.live_device_bytes(disp.live_device_arrays())
    assert peak >= matrix + 5 * gathered
    fp = disp.memory_footprint(n_rhs=4, hbm_bytes=None)
    assert int(fp.solver_bytes[0]) >= gathered
