"""The port's partition planner (``balance/``) and its ``plan=`` lanes
against the JAX package's.

Held element for element: the chains-on-chains splits (with the
brute-forced optimal bottleneck), the RCM and greedy reorderings (the JAX
RCM through its scipy fallback, as ``tests/test_torch_formats.py`` holds
it: its native library can order otherwise), and ``plan_partition`` under
ONE explicit ``MachineModel`` given to both planners - the same reorder,
split, exchange, ranges, permutation and fingerprint, the score within
1e-12 relative.  A plan file written by either package loads in the
other with its fingerprint.  Under each package's own default model (the
port's is an H100 table, the JAX package's a TPU table) the banded skew
system ``banded_skew_coo(64, 24)`` - the second quarter of a 64 x 64
Poisson grid's rows carrying 24 more in-row couplings - has its nnz
max/mean cut >= 2x at P = 4.

Planned solves on stacked CPU meshes of 4 shards (the 240-row skewed
fixture, b from seed 3): every CSR lane - allgather, gather, ring, ring
shift-ELL (B8's twin), the f64 ring (B9's twin) and the many-RHS lane -
returns x in the caller's row order with the JAX single-device solve's
iteration count, x within reduction-order rounding (1e-9 in float64).
``plan=None`` is the legacy layout: a trivial plan collapses to it and
shares its cached solver, bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import cuda_mpi_parallel_tpu.native.bindings as jnative
from cuda_mpi_parallel_tpu import solve as jsolve
from cuda_mpi_parallel_tpu.balance import nnz_split as jsplit
from cuda_mpi_parallel_tpu.balance import plan as jplan
from cuda_mpi_parallel_tpu.balance import reorder as jreorder
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models.operators import CSRMatrix as JCSR
from cuda_mpi_parallel_tpu.telemetry import memscope as jms
from cuda_mpi_parallel_tpu.telemetry.roofline import MachineModel as JModel

import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch import telemetry
from cuda_mpi_parallel_tpu_torch.balance import nnz_split, reorder
from cuda_mpi_parallel_tpu_torch.balance import plan as tplan
from cuda_mpi_parallel_tpu_torch.models import mmio
from cuda_mpi_parallel_tpu_torch.models.skewed import (
    banded_skew_coo,
    skewed_block_coo,
)
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.telemetry import events
from cuda_mpi_parallel_tpu_torch.telemetry import memscope as tms
from cuda_mpi_parallel_tpu_torch.telemetry.roofline import MachineModel


torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
#: one machine model, given to both planners
SHARED = dict(name="shared-test-model", mem_bytes_per_s=2.0e12,
              flops_per_s=5.0e13, net_bytes_per_s=1.0e11,
              hbm_bytes=1.0e9, source="table")


@pytest.fixture(scope="module", autouse=True)
def jax_rcm_fallback():
    """The JAX RCM through its scipy fallback (the port's RCM)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        yield


def both(coo, dtype=np.float64):
    """The same triplets as a JAX and a port CSRMatrix."""
    r, c, v, n = coo
    return (JCSR.from_coo(r, c, v.astype(dtype), n, dtype=dtype),
            pt.CSRMatrix.from_coo(r, c, v.astype(dtype), n, dtype=dtype,
                                  device="cpu"))


@pytest.fixture(scope="module")
def matrices():
    out = {"fixture": (jmmio.load_matrix_market(FIXTURE),
                       mmio.load_matrix_market(FIXTURE, device="cpu")),
           "block": both(skewed_block_coo(32, 8)),
           "banded": both(banded_skew_coo(16, 24))}
    return out


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


# -- nnz_split ------------------------------------------------------------------


@pytest.mark.parametrize("n,p", [(12, 4), (13, 4), (7, 8), (8, 3), (0, 2)])
def test_even_ranges(n, p):
    assert nnz_split.even_ranges(n, p) == jsplit.even_ranges(n, p)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_balanced_ranges_are_the_jax_ranges(seed, p):
    rng = np.random.default_rng(seed)
    row_nnz = rng.integers(1, 40, size=int(rng.integers(p, 200)))
    indptr = np.concatenate([[0], np.cumsum(row_nnz)])
    cap = None if seed % 2 else int(rng.integers(1, 60))
    got = nnz_split.balanced_nnz_ranges(indptr, p, max_local_rows=cap)
    assert got == jsplit.balanced_nnz_ranges(indptr, p,
                                             max_local_rows=cap)
    assert np.array_equal(nnz_split.range_nnz(indptr, got),
                          jsplit.range_nnz(indptr, got))


@pytest.mark.parametrize("p", [2, 3])
def test_bottleneck_is_exactly_optimal(p):
    """Carried over: every contiguous divider placement on a small chain,
    brute-forced; the splitter hits the optimal bottleneck."""
    import itertools

    row_nnz = np.random.default_rng(p).integers(1, 20, size=10)
    indptr = np.concatenate([[0], np.cumsum(row_nnz)])
    ranges = nnz_split.balanced_nnz_ranges(indptr, p)
    got = max(int(indptr[hi] - indptr[lo]) for lo, hi in ranges)
    best = min(
        max(int(indptr[b[i + 1]] - indptr[b[i]]) for i in range(p))
        for divs in itertools.combinations(range(1, 10), p - 1)
        for b in [(0,) + divs + (10,)])
    assert got == best
    assert ranges == jsplit.balanced_nnz_ranges(indptr, p)


@pytest.mark.parametrize("ranges,n,p", [
    (((0, 5), (6, 10)), 10, 2), (((0, 5),), 10, 2),
    (((0, 5), (5, 9)), 10, 2), (((0, 6), (5, 10)), 10, 2)])
def test_validate_ranges_refusals(ranges, n, p):
    for mod in (nnz_split, jsplit):
        with pytest.raises(ValueError):
            mod.validate_ranges(ranges, n, p)


# -- reorder --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fixture", "block", "banded"])
def test_reorderings_are_the_jax_ones(matrices, name):
    ja, ta = matrices[name]
    assert np.array_equal(reorder.rcm_reorder(ta), jreorder.rcm_reorder(ja))
    perm = reorder.greedy_nnz_reorder(ta)
    assert np.array_equal(perm, jreorder.greedy_nnz_reorder(ja))
    inv = reorder.inverse_permutation(perm)
    assert np.array_equal(inv, jreorder.inverse_permutation(perm))
    assert np.array_equal(perm[inv], np.arange(ta.shape[0]))
    tp, jp = ta.permuted(perm), ja.permuted(perm)
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(tp, field).numpy(),
                              np.asarray(getattr(jp, field)))


# -- plan_partition -------------------------------------------------------------


def _same_plan(ours, theirs):
    assert (ours.reorder, ours.split, ours.exchange, ours.objective,
            ours.n_shards, ours.label) == (
        theirs.reorder, theirs.split, theirs.exchange, theirs.objective,
        theirs.n_shards, theirs.label)
    assert ours.row_ranges == theirs.row_ranges
    assert (ours.permutation is None) == (theirs.permutation is None)
    if ours.permutation is not None:
        assert np.array_equal(ours.permutation, theirs.permutation)
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.score == pytest.approx(theirs.score, rel=1e-12)
    assert ours.is_trivial() == theirs.is_trivial()
    assert ours.report.to_json() == theirs.report.to_json()
    assert ours.baseline_imbalance == theirs.baseline_imbalance


@pytest.mark.parametrize("exchange", ["auto", "allgather", "gather",
                                      "ring"])
@pytest.mark.parametrize("name", ["fixture", "block", "banded"])
@pytest.mark.parametrize("p", [2, 4])
def test_plan_under_a_shared_model(matrices, name, exchange, p):
    ja, ta = matrices[name]
    ours = tplan.plan_partition(ta, p, exchange=exchange,
                                model=MachineModel(**SHARED))
    theirs = jplan.plan_partition(ja, p, exchange=exchange,
                                  model=JModel(**SHARED))
    _same_plan(ours, theirs)
    assert ours.scored_by == theirs.scored_by == SHARED["name"]


@pytest.mark.parametrize("objective", ["nnz", "halo"])
@pytest.mark.parametrize("name", ["fixture", "banded"])
def test_plan_objectives(matrices, name, objective):
    ja, ta = matrices[name]
    _same_plan(tplan.plan_partition(ta, 4, objective=objective),
               jplan.plan_partition(ja, 4, objective=objective))


def test_wire_and_score_terms(matrices):
    ja, ta = matrices["fixture"]
    ours = tplan.plan_partition(ta, 4, model=MachineModel(**SHARED))
    theirs = jplan.plan_partition(ja, 4, model=JModel(**SHARED))
    for lane in ("allgather", "gather", "ring"):
        assert tplan.wire_bytes_for(ours.report, lane, 8) \
            == jplan.wire_bytes_for(theirs.report, lane, 8)
        for objective in ("time", "nnz", "halo"):
            assert tplan.score_report(
                ours.report, objective=objective, exchange=lane,
                model=MachineModel(**SHARED)) == pytest.approx(
                jplan.score_report(theirs.report, objective=objective,
                                   exchange=lane, model=JModel(**SHARED)),
                rel=1e-12)
    assert tplan.GREEDY_REORDER_LIMIT == jplan.GREEDY_REORDER_LIMIT
    assert tplan.GATHER_SLOWDOWN == jplan.GATHER_SLOWDOWN


def test_greedy_dropped_past_limit(matrices, monkeypatch):
    ja, ta = matrices["block"]
    monkeypatch.setattr(tplan, "GREEDY_REORDER_LIMIT", 16)
    monkeypatch.setattr(jplan, "GREEDY_REORDER_LIMIT", 16)
    seen = []
    monkeypatch.setattr(reorder, "greedy_nnz_reorder",
                        lambda a: seen.append(a) or np.arange(32))
    _same_plan(tplan.plan_partition(ta, 2, model=MachineModel(**SHARED)),
               jplan.plan_partition(ja, 2, model=JModel(**SHARED)))
    assert seen == []


@pytest.mark.parametrize("budget", [None, 6000, 2500, 10])
def test_hbm_budget_grows_the_mesh_or_refuses(matrices, budget):
    ja, ta = matrices["fixture"]
    kw = dict(hbm_budget=budget)
    try:
        theirs = jplan.plan_partition(ja, 2, model=JModel(**SHARED), **kw)
    except jms.MemoryBudgetError as e:
        with pytest.raises(tms.MemoryBudgetError) as ei:
            tplan.plan_partition(ta, 2, model=MachineModel(**SHARED), **kw)
        assert (ei.value.required_bytes, ei.value.budget_bytes,
                ei.value.n_shards) == (e.required_bytes, e.budget_bytes,
                                       e.n_shards)
        assert str(ei.value) == str(e)
        return
    ours = tplan.plan_partition(ta, 2, model=MachineModel(**SHARED), **kw)
    _same_plan(ours, theirs)
    if budget == 2500:
        assert ours.n_shards > 2       # the budget grew the mesh


def test_default_model_is_an_h100_table():
    from cuda_mpi_parallel_tpu_torch.telemetry.roofline import (
        published_peaks,
    )

    model = tplan.reference_model()
    mem, f32, _f64, net = published_peaks("H100")
    assert (model.name, model.mem_bytes_per_s, model.flops_per_s,
            model.net_bytes_per_s, model.source) == (
        "reference-h100", mem, f32, net, "table")
    assert model.hbm_bytes == 80e9
    assert model.gather_slowdown == tplan.GATHER_SLOWDOWN
    assert tplan.reference_model() is model       # never re-read


def test_each_default_cuts_the_stall_factor_2x():
    """The planner's acceptance - a skewed system's nnz stall factor cut
    >= 2x at P = 4 - under each package's own default model: the banded
    skew system."""
    ja, ta = both(banded_skew_coo(64, 24), np.float32)
    for plan in (tplan.plan_partition(ta, 4), jplan.plan_partition(ja, 4)):
        base = plan.baseline_imbalance["nnz_max_over_mean"]
        assert base >= 2.0
        assert base / plan.report.imbalance()["nnz_max_over_mean"] >= 2.0
    assert plan.scored_by == "reference-tpu-v5e"


def test_plan_files_cross_packages(matrices, tmp_path):
    ja, ta = matrices["fixture"]
    ours = tplan.plan_partition(ta, 4, model=MachineModel(**SHARED))
    theirs = jplan.plan_partition(ja, 4, model=JModel(**SHARED))
    ours.save(str(tmp_path / "port.json"))
    theirs.save(str(tmp_path / "jax.json"))
    in_jax = jplan.PartitionPlan.load(str(tmp_path / "port.json"))
    in_port = tplan.PartitionPlan.load(str(tmp_path / "jax.json"))
    assert in_jax.fingerprint() == ours.fingerprint()
    assert in_port.fingerprint() == theirs.fingerprint()
    assert in_port.to_json() == json.loads(
        (tmp_path / "jax.json").read_text())
    assert in_port.report.to_json() == theirs.report.to_json()
    lay = tplan.PartitionPlan.from_layout_json(ours.layout_json())
    assert lay.layout_json() == jplan.PartitionPlan.from_layout_json(
        theirs.layout_json()).layout_json()
    assert ours.layout_json() == theirs.layout_json()
    assert jplan.PartitionPlan.from_layout_json(
        ours.layout_json()).fingerprint() == ours.fingerprint()
    assert ours.describe() == theirs.describe()


def test_validate_for_and_trivial_plans(matrices):
    ja, ta = matrices["fixture"]
    plan = tplan.plan_partition(ta, 4)
    _, small = both(skewed_block_coo(64, 16))
    with pytest.raises(ValueError, match="rows"):
        plan.validate_for(small)
    bad = tplan.PartitionPlan.from_json(dict(
        plan.to_json(), permutation=[0] * 240))
    with pytest.raises(ValueError, match="not a permutation"):
        bad.validate_for(ta)
    for exchange in ("allgather", "gather"):
        ours = tplan.plan_partition(
            ta, 4, exchange=exchange, reorders=("none",), splits=("even",))
        theirs = jplan.plan_partition(
            ja, 4, exchange=exchange, reorders=("none",), splits=("even",))
        assert ours.is_trivial() == theirs.is_trivial() \
            == (exchange == "allgather")
        resolved = tdist.resolve_plan(ours, ta, 4, exchange=exchange)
        assert (resolved is None) == ours.is_trivial()


# -- planned solves -------------------------------------------------------------


SOLVE = dict(tol=1e-10, maxiter=2000)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX single-device solves, once: the fixture at b from seed 3,
    and its three-column stack's columns."""
    ja = jmmio.load_matrix_market(FIXTURE)
    b = np.random.default_rng(3).standard_normal(240)
    stack = np.random.default_rng(5).standard_normal((240, 3))
    out = {"b": b, "stack": stack,
           "x": jsolve(ja, b, **SOLVE)}
    out["cols"] = [jsolve(ja, stack[:, c], tol=1e-9, maxiter=500)
                   for c in range(3)]
    return out


def _planned(ta, b, lane, plan="auto"):
    m = mesh(4)
    if lane == "df64":
        res = tpar.solve_distributed_df64(ta, b, mesh=m, plan=plan, **SOLVE)
        return res, res.x()
    kw = {"gather": dict(exchange="gather"), "ring": dict(csr_comm="ring"),
          "ring-shiftell": dict(csr_comm="ring-shiftell")}.get(lane, {})
    res = tpar.solve_distributed(ta, b, mesh=m, plan=plan, **SOLVE, **kw)
    return res, res.x.numpy()


@pytest.mark.parametrize("lane", ["allgather", "gather", "ring",
                                  "ring-shiftell", "df64"])
def test_planned_solve_is_the_jax_solve(matrices, jax_refs, lane):
    _, ta = matrices["fixture"]
    res, x = _planned(ta, jax_refs["b"], lane)
    want = jax_refs["x"]
    assert bool(res.converged)
    assert int(res.iterations) == int(want.iterations)
    ref = np.asarray(want.x)
    assert np.max(np.abs(x - ref)) <= 1e-9 * np.max(np.abs(ref))


def test_planned_many_rhs_is_the_jax_solves(matrices, jax_refs):
    """Carried over: ``test_plan_auto_composes`` - a planned batched
    solve, each lane the JAX single-device solve of its column."""
    _, ta = matrices["fixture"]
    disp = tpar.ManyRHSDispatcher(ta, mesh=mesh(4), maxiter=500,
                                  plan="auto")
    assert disp.plan is not None and disp.plan.permutation is not None
    res = disp.solve(jax_refs["stack"], tol=1e-9)
    for c, want in enumerate(jax_refs["cols"]):
        assert int(res.iterations[c]) == int(want.iterations)
        ref = np.asarray(want.x)
        assert np.max(np.abs(res.x[:, c].numpy() - ref)) \
            <= 1e-9 * np.max(np.abs(ref))


def test_partition_plan_event_joins_prediction_and_measure(matrices,
                                                           jax_refs):
    """Carried over: the fixture chain of ``test_fixture_chain_parse_plan_
    solve`` - the ``partition_plan`` event's measured stall factor is the
    planner's prediction, and the cut is the JAX planner's (1.9x here:
    the scipy RCM, unlike the JAX native one, does not reach 2x on this
    fixture; ``test_each_default_cuts_the_stall_factor_2x`` holds the
    2x acceptance)."""
    ja, ta = matrices["fixture"]
    try:
        with events.capture() as buf:
            telemetry.force_active(True)
            res = tpar.solve_distributed(ta, jax_refs["b"], mesh=mesh(4),
                                         plan="auto", **SOLVE)
    finally:
        telemetry.force_active(False)
    assert bool(res.converged)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ev in lines:
        events.validate_event(ev)
    ev, = [e for e in lines if e["event"] == "partition_plan"]
    measured = ev["measured"]["nnz_max_over_mean"]
    assert measured == pytest.approx(ev["predicted"]["nnz_max_over_mean"],
                                     rel=1e-12)
    theirs = jplan.plan_partition(ja, 4)
    assert ev["fingerprint"] == theirs.fingerprint()
    assert measured == pytest.approx(
        theirs.report.imbalance()["nnz_max_over_mean"], rel=1e-12)
    assert theirs.baseline_imbalance["nnz_max_over_mean"] / measured > 1.8


def test_explicit_plan_rides_the_cache_key(matrices, jax_refs):
    """Carried over: the plan fingerprint is part of the solver-cache
    key; ``plan=None`` builds the legacy entry, and a trivial plan
    collapses to it - the same cached solver, the same bits."""
    _, ta = matrices["fixture"]
    b = jax_refs["b"]
    m = mesh(4)
    tdist.clear_solver_cache()
    plan = tplan.plan_partition(ta, 4)
    tpar.solve_distributed(ta, b, mesh=m, plan=plan, **SOLVE)
    keys = list(tdist._SOLVER_CACHE)
    assert any(plan.fingerprint() in str(k) for k in keys)
    legacy = tpar.solve_distributed(ta, b, mesh=m, **SOLVE)
    assert len(tdist._SOLVER_CACHE) == len(keys) + 1
    trivial = tplan.plan_partition(ta, 4, exchange="allgather",
                                   reorders=("none",), splits=("even",))
    built = tdist._BUILD_COUNT[0]
    same = tpar.solve_distributed(ta, b, mesh=m, plan=trivial, **SOLVE)
    assert tdist._BUILD_COUNT[0] == built
    assert torch.equal(same.x, legacy.x)


def test_plan_rejections(matrices):
    """Carried over: ``test_plan_rejections``, each the JAX error."""
    _, ta = matrices["fixture"]
    m = mesh(4)
    stencil = pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="plan="):
        tpar.solve_distributed(stencil, np.ones(256), mesh=m, plan="auto")
    with pytest.raises(ValueError, match="auto"):
        tpar.solve_distributed(ta, np.ones(240), mesh=m, plan="fastest")
    with pytest.raises(ValueError, match="shards"):
        tpar.solve_distributed(ta, np.ones(240), mesh=m,
                               plan=tplan.plan_partition(ta, 2))
    with pytest.raises(TypeError):
        tpar.solve_distributed(ta, np.ones(240), mesh=m, plan=object())
    with pytest.raises(ValueError, match="gather halo exchange"):
        tpar.solve_distributed(
            ta, np.ones(240), mesh=m, csr_comm="ring",
            plan=tplan.plan_partition(ta, 4, exchange="gather"))
