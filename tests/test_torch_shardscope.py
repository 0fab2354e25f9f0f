"""The port's per-shard accounting (``telemetry.shardscope``), its
partition hooks and the distributed comm-cost gauges against the JAX
package's.

Every report field is the JAX one for the CSR families (allgather,
gather, ring; even and plan-driven splits) and the stencil slabs, on the
same seeded numpy inputs: the skewed matrices of the JAX
``tests/test_shardscope.py``, the 240-row skewed fixture, and the
(16, 128) and (4, 8, 128) grids.  The ring shift-ELL families keep the
JAX rows, nnz, halo payloads and neighbors; their slots and persistent
bytes are the port's own (sliced ELL, ragged per owner: held to the
packed arrays instead).

The hooks: while telemetry is active, a distributed solve notes its
partition (``shard_profile``, ``partition_plan``) and the first solve of
each cached solver runs under the comm recorder; the five
``dist_comm_*_per_iteration`` gauges then carry ``trace_solve_cost``'s
numbers, which are the JAX jaxpr walk's (its ``psum_invariant`` counted
as a psum and its reduced scalars' bytes added back, as
``tests/test_torch_roofline.py`` does).  Telemetered and untelemetered
solves run the same aten operations and give the same bits.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import cuda_mpi_parallel_tpu.parallel as jpar
from cuda_mpi_parallel_tpu import telemetry as jtelemetry
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models.operators import CSRMatrix as JCSR
from cuda_mpi_parallel_tpu.models.operators import Stencil2D as JStencil2D
from cuda_mpi_parallel_tpu.parallel import dist_cg as jdist
from cuda_mpi_parallel_tpu.parallel import partition as jpart
from cuda_mpi_parallel_tpu.telemetry import shardscope as jss

import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch import telemetry
from cuda_mpi_parallel_tpu_torch.balance import nnz_split
from cuda_mpi_parallel_tpu_torch.models import mmio
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.parallel import partition as tpart
from cuda_mpi_parallel_tpu_torch.telemetry import cost, events
from cuda_mpi_parallel_tpu_torch.telemetry import shardscope as ss

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
SOLVE_KW = dict(tol=1e-10, maxiter=400)


def skewed_coo(n=8, fat_row=0):
    """The JAX ``skewed_csr`` triplets: one dense row, unit diagonals."""
    rows, cols, vals = [], [], []
    for i in range(n):
        if i == fat_row:
            rows += [i] * n
            cols += list(range(n))
            vals += [2.0 if i == j else 0.5 for j in range(n)]
        else:
            rows.append(i)
            cols.append(i)
            vals.append(2.0)
    return np.array(rows), np.array(cols), np.array(vals), n


def both(coo, dtype=np.float32):
    r, c, v, n = coo
    return (JCSR.from_coo(r, c, v.astype(dtype), n, dtype=dtype),
            pt.CSRMatrix.from_coo(r, c, v.astype(dtype), n, dtype=dtype,
                                  device="cpu"))


def fixture_pair():
    return (jmmio.load_matrix_market(FIXTURE),
            mmio.load_matrix_market(FIXTURE, device="cpu"))


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def _json(rep, drop=()):
    out = rep.to_json()
    for key in drop:
        out.pop(key)
    return out


# -- the imbalance arithmetic ---------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_imbalance_math(seed):
    v = np.random.default_rng(seed).integers(0, 50, size=seed + 1)
    assert ss.max_over_mean(v) == jss.max_over_mean(v)
    assert ss.gini(v) == jss.gini(v)
    assert ss.max_over_mean([]) == 1.0 and ss.gini([0, 0]) == 0.0


# -- the CSR families -----------------------------------------------------------


CSR_CASES = [("skewed8", 2, "allgather", None), ("skewed16", 4, "allgather",
                                                   None),
             ("skewed5", 2, "allgather", None), ("fixture", 4, "allgather",
                                                 None),
             ("fixture", 4, "gather", None), ("fixture", 3, "ring", None),
             ("fixture", 4, "allgather", "nnz"), ("fixture", 4, "gather",
                                                  "nnz"),
             ("fixture", 4, "ring", "nnz")]


def _pair(name):
    if name == "fixture":
        return fixture_pair()
    return both(skewed_coo(int(name[6:])))


def _partitions(ja, ta, p, family, split):
    ranges = None
    if split == "nnz":
        ranges = nnz_split.balanced_nnz_ranges(
            np.asarray(ja.indptr), p, max_local_rows=int(-(-240 // p) * 1.25))
    if family == "ring":
        return (jpart.ring_partition_csr(ja, p, ranges),
                tpart.ring_partition_csr(ta, p, ranges))
    return (jpart.partition_csr(ja, p, ranges, exchange=family),
            tpart.partition_csr(ta, p, ranges, exchange=family))


@pytest.mark.parametrize("name,p,family,split", CSR_CASES)
def test_csr_reports_are_the_jax_reports(name, p, family, split):
    ja, ta = _pair(name)
    jparts, tparts = _partitions(ja, ta, p, family, split)
    ours, theirs = ss.shard_report(ta, tparts), jss.shard_report(ja, jparts)
    assert ours.to_json() == theirs.to_json()
    assert ours.table() == theirs.table()
    assert ours.plan == ("planned" if split else "even")
    if family == "gather":
        assert ss.gather_wire_bytes(ours) == jss.gather_wire_bytes(theirs)
    back = ss.ShardReport.from_json(json.loads(json.dumps(ours.to_json())))
    assert back.to_json() == ours.to_json()
    assert jss.ShardReport.from_json(ours.to_json()).to_json() \
        == theirs.to_json()


@pytest.mark.parametrize("split", ["even", "nnz"])
@pytest.mark.parametrize("p", [2, 4])
def test_report_for_ranges_is_the_jax_report(split, p):
    ja, ta = fixture_pair()
    ranges = nnz_split.even_ranges(240, p) if split == "even" else \
        nnz_split.balanced_nnz_ranges(np.asarray(ja.indptr), p)
    ours = ss.report_for_ranges(ta, ranges, plan=split)
    theirs = jss.report_for_ranges(ja, ranges, plan=split)
    assert ours.to_json() == theirs.to_json()
    assert ss.gather_wire_bytes(ours) == jss.gather_wire_bytes(theirs)
    assert ss.report_for_ranges(ta, ranges, itemsize=8).to_json() \
        == jss.report_for_ranges(ja, ranges, itemsize=8).to_json()


@pytest.mark.parametrize("df64", [False, True])
@pytest.mark.parametrize("split", [None, "nnz"])
def test_ring_shiftell_reports(df64, split):
    """The hand-checked JAX case (the fat row at row 3 of 512, P = 4) and
    the fixture's planned split: rows, nnz, halo and neighbors are the
    JAX report's; slots are the packed slabs' slots, owner by owner."""
    for ja, ta in (both(skewed_coo(512, fat_row=3)), fixture_pair()):
        ranges = None if split is None else nnz_split.balanced_nnz_ranges(
            np.asarray(ja.indptr), 4)
        jfn = jpart.ring_partition_shiftell_df64 if df64 \
            else jpart.ring_partition_shiftell
        tfn = tpart.ring_partition_shiftell_df64 if df64 \
            else tpart.ring_partition_shiftell
        jparts = jfn(ja, 4, h=2, kc=4, row_ranges=ranges)
        tparts = tfn(ta, 4, h=2, kc=4, row_ranges=ranges)
        ours = ss.shard_report(ta, tparts)
        theirs = jss.shard_report(ja, jparts)
        own = ("slots", "padding_overhead", "imbalance", "persistent_bytes")
        assert _json(ours, own) == _json(theirs, own)
        imb, jimb = ours.imbalance(), theirs.imbalance()
        for key in ("rows_max_over_mean", "nnz_max_over_mean", "nnz_gini",
                    "halo_send_max_over_mean", "halo_send_gini"):
            assert imb[key] == jimb[key]
        assert ours.kind == ("ring-shiftell-df64" if df64
                             else "ring-shiftell")
        assert list(ours.slots) == [
            sum(len(tparts.vals[t][s]) for t in range(4)) for s in range(4)]
        assert (ours.slots >= ours.nnz).all()
        assert int(ours.persistent_bytes.sum()) > 0
    if split is None and not df64:
        # the fixture's f64 ring: 3 steps x 60 rows x 8 B
        np.testing.assert_array_equal(ours.halo_send_bytes, [3 * 60 * 8] * 4)


@pytest.mark.parametrize("grid,p", [((16, 128), 4), ((4, 8, 128), 2),
                                    ((4, 8, 128), 4)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_stencil_reports_are_the_jax_reports(grid, p, itemsize):
    local = (grid[0] // p,) + tuple(grid[1:])
    points = 5 if len(grid) == 2 else 7
    ours = ss.report_stencil(local, p, itemsize, points=points, kind="k")
    theirs = jss.report_stencil(local, p, itemsize, points=points, kind="k")
    assert ours.to_json() == theirs.to_json()


def test_dispatch_refuses_other_types():
    ja, ta = both(skewed_coo(16))
    assert ss.shard_report(ta, tpart.ring_partition_csr(ta, 2)).kind \
        == "csr-ring"
    with pytest.raises(TypeError, match="no shard accounting"):
        ss.shard_report(ta, object())


# -- the partition hooks and the comm-cost gauges ---------------------------------


def _events(buf):
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ev in lines:
        events.validate_event(ev)
    return lines


@pytest.fixture(scope="module")
def jax_costs():
    """The JAX jaxpr-derived SolveCost of the stencil slab and the CSR
    allgather lanes on 4 shards, once."""
    ja = jmmio.load_matrix_market(FIXTURE)
    js = JStencil2D.create(16, 128, dtype=np.float64)
    out = {}
    jtelemetry.force_active(True)
    try:
        for name, a, b in (
                ("stencil", js, np.random.default_rng(11).standard_normal(
                    16 * 128)),
                ("csr", ja, np.random.default_rng(0).standard_normal(240))):
            jdist.reset_last_comm_cost()
            jpar.solve_distributed(a, b, mesh=jpar.make_mesh(4), **SOLVE_KW)
            out[name] = jdist.last_comm_cost()[0]
    finally:
        jtelemetry.force_active(False)
    return out


def _problem(kind):
    if kind == "stencil":
        return (pt.Stencil2D.create(16, 128, dtype=torch.float64,
                                    device="cpu"),
                np.random.default_rng(11).standard_normal(16 * 128))
    return (mmio.load_matrix_market(FIXTURE, device="cpu"),
            np.random.default_rng(0).standard_normal(240))


@pytest.mark.parametrize("kind", ["stencil", "csr"])
def test_comm_gauges_are_trace_solve_cost(kind, jax_costs):
    """The five gauges and the ``comm_cost`` event of a telemetered solve
    carry ``trace_solve_cost``'s per-iteration numbers - the JAX walk's -
    on every solve (carried over: ``TestSolveDistributedIntegration``)."""
    a, b = _problem(kind)
    tdist.clear_solver_cache()
    want = cost.trace_solve_cost(tpar.solve_distributed, a, b, mesh=mesh(4),
                                 **SOLVE_KW)
    with events.capture() as buf:
        res1 = tpar.solve_distributed(a, b, mesh=mesh(4), **SOLVE_KW)
        res2 = tpar.solve_distributed(a, b, mesh=mesh(4), **SOLVE_KW)
    sc, ctx = tdist.last_comm_cost()
    assert sc == want
    costs = [e for e in _events(buf) if e["event"] == "comm_cost"]
    assert len(costs) == 2            # one a solve, the record cached
    per = want.per_iteration
    for ev in costs:
        assert (ev["psum_per_iteration"], ev["ppermute_per_iteration"],
                ev["all_gather_per_iteration"],
                ev["comm_bytes_per_iteration"],
                ev["wire_bytes_per_iteration"]) == (
            per.psum, per.ppermute, per.all_gather, per.comm_bytes,
            per.wire_bytes)
    label = ctx["kind"]
    assert label == kind and ctx["n_shards"] == 4
    for gname, value in (
            ("dist_comm_psum_per_iteration", per.psum),
            ("dist_comm_ppermute_per_iteration", per.ppermute),
            ("dist_comm_all_gather_per_iteration", per.all_gather),
            ("dist_comm_bytes_per_iteration", per.comm_bytes),
            ("dist_comm_wire_bytes_per_iteration", per.wire_bytes)):
        assert telemetry.REGISTRY.gauge(
            gname, "", labelnames=("kind",)).value(kind=label) == value
    k = int(res2.iterations)
    assert sc.totals(k).psum == 2 * k + 1
    theirs = jax_costs[kind].per_iteration
    assert per.psum == theirs.psum + theirs.get("psum_invariant")
    assert (per.ppermute, per.all_gather, per.wire_bytes) == (
        theirs.ppermute, theirs.all_gather, theirs.wire_bytes)
    missed = 2 * 8 if theirs.get("psum_invariant") else 0
    assert per.comm_bytes == theirs.comm_bytes + missed
    assert torch.equal(res1.x, res2.x)


def test_nothing_recorded_when_inactive():
    """Carried over: ``test_cost_walk_skipped_when_inactive``."""
    tdist.clear_solver_cache()
    telemetry.force_active(False)
    a, b = _problem("stencil")
    tpar.solve_distributed(a, b, mesh=mesh(4), maxiter=50)
    assert tdist.last_comm_cost() is None
    assert tdist._COST_CACHE == {} and tdist._PEAK_CACHE == {}
    assert not telemetry.active()


class _OpCount(TorchDispatchMode):
    """Every aten op but ``detach``: the partition accounting reads the
    operator's index arrays to the host (``partition._host``, a detach
    here and a copy to the host on the card), at partition time, as the
    partitioners themselves do."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) != "aten.detach.default":
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lane", [
    dict(), dict(exchange="gather"), dict(csr_comm="ring"),
    dict(csr_comm="ring-shiftell"), dict(plan="auto"), "stencil", "many"],
    ids=["allgather", "gather", "ring", "ring-shiftell", "planned",
         "stencil", "many"])
def test_telemetry_does_not_perturb_the_solve(lane):
    """A telemetered solve (the recorders on: first solve of its key)
    runs the aten operations of the untelemetered one (``_OpCount``),
    with the same collectives and the same bits."""
    if lane == "stencil":
        a, b = _problem("stencil")
        kw = {}
    else:
        a, b = _problem("csr")
        kw = {} if lane == "many" else lane

    def run():
        m = mesh(4)
        with _OpCount() as count:
            if lane == "many":
                res = tpar.solve_distributed_many(
                    a, np.stack([b, b[::-1]], 1), mesh=m, maxiter=400,
                    tol=1e-10)
            else:
                res = tpar.solve_distributed(a, b, mesh=m, **SOLVE_KW, **kw)
        return res, count.ops, dict(m.comm.counts)

    tdist.clear_solver_cache()
    plain, plain_ops, plain_counts = run()
    tdist.clear_solver_cache()
    try:
        with events.capture():
            telemetry.force_active(True)
            noted, noted_ops, noted_counts = run()
    finally:
        telemetry.force_active(False)
    assert tdist._COST_CACHE        # the telemetered run recorded
    assert torch.equal(plain.x, noted.x)
    assert noted_counts == plain_counts
    assert noted_ops == plain_ops


def test_partition_hooks_note_reports():
    """Each lane parks its report (``last_shard_report``) - the JAX
    report of the same partition - and the stencil slabs theirs."""
    ja, ta = fixture_pair()
    b = np.random.default_rng(0).standard_normal(240)
    try:
        with events.capture() as buf:
            telemetry.force_active(True)
            ss.reset_last_shard_report()
            tpar.solve_distributed(ta, b, mesh=mesh(4), exchange="gather",
                                   **SOLVE_KW)
            rep = ss.last_shard_report()
            st, sb = _problem("stencil")
            tpar.solve_distributed_df64(st, sb, mesh=mesh(4), maxiter=20)
            st_rep = ss.last_shard_report()
    finally:
        telemetry.force_active(False)
    want = jss.shard_report(ja, jpart.partition_csr(ja, 4,
                                                    exchange="gather"))
    assert rep.to_json() == want.to_json()
    assert st_rep.to_json() == jss.report_stencil(
        (4, 128), 4, 8, points=5, kind="stencil2d-df64").to_json()
    kinds = [e["event"] for e in _events(buf)]
    assert kinds.count("shard_profile") == 2
    assert telemetry.REGISTRY.gauge(
        "shard_nnz", "", labelnames=("kind", "shard")).value(
        kind="csr-gather", shard="0") == float(want.nnz[0])
