"""The port's distributed resumable solve and elastic migration against
the JAX package's.

The JAX ``tests/test_elastic.py`` (``TestMigrateCheckpoint``,
``TestElasticResume``, ``TestCorruptCheckpoint``) and ``tests/
test_robust.py`` ``TestPreemptionDrill`` carried over as parity cases:
the skewed SPD fixture (240 rows) and b from seed 0, on stacked CPU
meshes of 2 and 4 shards for the port and the 8 virtual CPU devices for
the JAX package.  The JAX ``plan="auto"`` and explicit-plan cases run
as there, each against the same JAX run: both planners price with one
machine model (``models.skewed.PLANNING_MODEL``, in place of each
package's default table, which differ) and the JAX RCM runs through its
scipy fallback (the port's), so ``"auto"`` resolves the same plan in
both; the explicit plan is a JAX ``plan_partition`` crossing through
its JSON file, and a JAX snapshot whose layout records a plan migrates
in the port.

Parity contract: the iteration counts and statuses are the JAX ones
(each JAX run computed once, in a module fixture), x within
``1e-5`` of the uninterrupted run across a migration (the JAX bound)
and within ``1e-10`` of the JAX run's,
and a same-layout resume bit-equal to the port's own uninterrupted run.
Beside them: a JAX snapshot migrates in the port and a port snapshot in
JAX, the segments of a resumable solve share one cached solver, and two
gloo ranks give the stacked mesh's bits with rank 0 writing the file.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import cuda_mpi_parallel_tpu.native.bindings as jnative
import cuda_mpi_parallel_tpu.parallel as jpar
from cuda_mpi_parallel_tpu.balance import plan as jplan
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.parallel import dist_cg as jdist
from cuda_mpi_parallel_tpu.robust import PreemptedError as JPreempted
from cuda_mpi_parallel_tpu.robust import Preemption as JPreemption
from cuda_mpi_parallel_tpu.telemetry import calibrate as jcalibrate
from cuda_mpi_parallel_tpu.telemetry.roofline import MachineModel as JModel
from cuda_mpi_parallel_tpu.utils import checkpoint as jck
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch import robust
from cuda_mpi_parallel_tpu_torch.balance import PartitionPlan
from cuda_mpi_parallel_tpu_torch.balance import plan as tplan
from cuda_mpi_parallel_tpu_torch.models.skewed import PLANNING_MODEL
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.robust import (
    MigrationSeamError,
    PreemptedError,
    Preemption,
    lift_checkpoint,
    migrate_checkpoint,
)
from cuda_mpi_parallel_tpu_torch.telemetry import calibrate as tcalibrate
from cuda_mpi_parallel_tpu_torch.telemetry import events
from cuda_mpi_parallel_tpu_torch.telemetry.roofline import MachineModel
from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

import torch_df64_ranks as ranks

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "skewed_spd_240.mtx")
KW = dict(segment_iters=20, tol=1e-8, maxiter=500)


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def problem():
    return ranks.resumable_problem(FIXTURE)


@pytest.fixture(scope="module", autouse=True)
def shared_planning():
    """Both planners price ``"auto"`` with ``PLANNING_MODEL`` (no JAX
    calibration read from disk, in either package) and the JAX RCM runs
    through its scipy fallback, the port's RCM."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(jcalibrate, "preferred_model", lambda *a, **k: None)
        mp.setattr(tcalibrate, "preferred_model", lambda *a, **k: None)
        mp.setattr(jplan, "reference_model",
                   lambda: JModel(**PLANNING_MODEL))
        mp.setattr(tplan, "reference_model",
                   lambda: MachineModel(**PLANNING_MODEL))
        yield


#: the planned cases of test_mesh_roundtrip, run in both packages
PLANNED_ROUNDTRIPS = ((4, 2, "gather"), (2, 4, None))


def plan_hint(exchange):
    return "auto" if exchange is None else exchange


def jax_preempted(ja, b, path, n_shards, **kw):
    with pytest.raises(JPreempted):
        jck.solve_resumable_distributed(
            ja, b, path, mesh=jpar.make_mesh(n_shards),
            preempt=JPreemption(1), **KW, **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, shared_planning):
    """The JAX references, once: the uninterrupted solves on 4 and 2
    shards (both exchange lanes), a JAX snapshot preempted after one
    segment on 4 shards, and its elastic resume on 2; the planned
    roundtrips (uninterrupted, and preempted then resumed on the other
    mesh, all ``plan="auto"``) with the plans ``"auto"`` resolves; the
    explicit 2-shard plan's resume of the 4-shard snapshot; and a
    planned 4-shard snapshot with its elastic resume on 2."""
    ja = jmmio.load_matrix_market(FIXTURE)
    b = np.random.default_rng(0).standard_normal(240)
    out = {"a": ja}
    for n, exchange in ((4, None), (2, None), (2, "gather")):
        out[(n, exchange)] = jpar.solve_distributed(
            ja, b, mesh=jpar.make_mesh(n), tol=1e-8, maxiter=500,
            exchange=exchange)
    d = tmp_path_factory.mktemp("jax_snapshot")
    snap = str(d / "jax4.npz")
    jax_preempted(ja, b, snap, 4)
    out["snapshot"] = snap
    moved = str(d / "jax4to2.npz")
    shutil.copy(snap, moved)
    out["migrated"] = jck.solve_resumable_distributed(
        ja, b, moved, mesh=jpar.make_mesh(2), elastic=True, **KW)
    for n_from, n_to, exchange in PLANNED_ROUNDTRIPS:
        clean = jpar.solve_distributed(
            ja, b, mesh=jpar.make_mesh(n_from), tol=1e-8, maxiter=500,
            exchange=exchange, plan="auto")
        path = str(d / f"jax_auto_{n_from}_{n_to}.npz")
        jax_preempted(ja, b, path, n_from, exchange=exchange, plan="auto")
        out[("auto", n_from, n_to)] = dict(
            clean=clean,
            plans={n: jdist.resolve_plan(
                "auto", ja, n, exchange=plan_hint(exchange)).fingerprint()
                for n in (n_from, n_to)},
            resumed=jck.solve_resumable_distributed(
                ja, b, path, mesh=jpar.make_mesh(n_to), exchange=exchange,
                plan="auto", elastic=True, **KW))
    plan2 = jplan.plan_partition(ja, 2, model=JModel(**PLANNING_MODEL))
    plan2.save(str(d / "plan2.json"))
    out["plan2"] = plan2
    out["plan2_json"] = str(d / "plan2.json")
    moved = str(d / "jax4plan2.npz")
    shutil.copy(snap, moved)
    out["plan2_resumed"] = jck.solve_resumable_distributed(
        ja, b, moved, mesh=jpar.make_mesh(2), plan=plan2, elastic=True,
        **KW)
    planned = str(d / "jax4planned.npz")
    jax_preempted(ja, b, planned, 4, plan="auto")
    out["planned_snapshot"] = planned
    moved = str(d / "jax4planned_to2.npz")
    shutil.copy(planned, moved)
    out["planned_migrated"] = jck.solve_resumable_distributed(
        ja, b, moved, mesh=jpar.make_mesh(2), elastic=True, **KW)
    return out


def same_as_jax(res, want):
    """The port's run against the JAX run: the count, the status, and x
    to reduction-order rounding."""
    assert its(res) == its(want) and int(res.status) == int(want.status)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-10)


def its(res):
    return int(res.iterations)


def preempted(a, b, path, *, n_shards, segments=1, **kw):
    """A resumable solve killed after ``segments`` segments."""
    with pytest.raises(PreemptedError):
        ck.solve_resumable_distributed(
            a, b, path, mesh=mesh(n_shards),
            preempt=Preemption(after_segments=segments), **KW, **kw)
    assert os.path.exists(path)


def captured(buf):
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.strip()]
    for r in recs:
        events.validate_event(r)
    return recs


def migrations(buf):
    return [e for e in captured(buf) if e["event"] == "solve_migration"]


# -- TestMigrateCheckpoint --------------------------------------------------------


def test_lift_matches_seam_and_roundtrips(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "m.npz")
    preempted(a, b, path, n_shards=4)
    c = ck.load_checkpoint(path, device="cpu")
    lifted = lift_checkpoint(c, 240, n_shards=4, plan=None)
    r_norm = float(np.linalg.norm(lifted.r))
    assert r_norm == pytest.approx(float(np.sqrt(float(c.rr))), rel=1e-10)
    mig = migrate_checkpoint(c, 2, a=a, n_shards_old=4, plan_old=None,
                             plan=None)
    back = lift_checkpoint(mig.checkpoint, 240, n_shards=2, plan=None)
    for leaf in ("x", "r", "p"):
        np.testing.assert_array_equal(getattr(back, leaf),
                                      getattr(lifted, leaf))
    for leaf in ("rho", "rr", "nrm0", "k", "indefinite"):
        np.testing.assert_array_equal(getattr(mig.checkpoint, leaf),
                                      getattr(c, leaf).numpy())
    assert mig.seam_rel_err < 1e-10
    assert (mig.n_shards_from, mig.n_shards_to) == (4, 2)
    assert mig.to_json()["plan"] == "even"


def test_broken_seam_refuses(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "seam.npz")
    preempted(a, b, path, n_shards=4)
    c = ck.load_checkpoint(path, device="cpu")
    bad = dataclasses.replace(c, r=c.r * 3.0)
    with pytest.raises(MigrationSeamError, match="seam"):
        migrate_checkpoint(bad, 2, a=a, n_shards_old=4, plan_old=None,
                           plan=None)


def test_wrong_declared_layout_refuses(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "lay.npz")
    preempted(a, b, path, n_shards=4)
    c = ck.load_checkpoint(path, device="cpu")
    with pytest.raises(ValueError, match="padded rows"):
        lift_checkpoint(c, 240, n_shards=7, plan=None)


# -- TestElasticResume ---------------------------------------------------------------


@pytest.mark.parametrize(
    "n_from,n_to,exchange,plan",
    [(4, 2, None, None),
     (4, 2, "gather", "auto"),
     (2, 4, None, "auto"),
     (2, 4, "gather", None)])
def test_mesh_roundtrip(problem, jax_runs, tmp_path, n_from, n_to,
                        exchange, plan):
    a, b = problem
    path = str(tmp_path / f"el_{n_from}_{n_to}.npz")
    clean = tpar.solve_distributed(a, b, mesh=mesh(n_from), tol=1e-8,
                                   maxiter=500, exchange=exchange, plan=plan)
    assert bool(clean.converged)
    planned = jax_runs.get(("auto", n_from, n_to)) if plan else None
    if planned is not None:
        # "auto" resolves the JAX plan on both meshes
        assert {n: tdist.resolve_plan(
            "auto", a, n, exchange=plan_hint(exchange)).fingerprint()
            for n in (n_from, n_to)} == planned["plans"]
        same_as_jax(clean, planned["clean"])
    elif jax_runs.get((n_from, exchange)) is not None:
        assert its(clean) == its(jax_runs[(n_from, exchange)])
    preempted(a, b, path, n_shards=n_from, exchange=exchange, plan=plan)
    with events.capture() as buf:
        res = ck.solve_resumable_distributed(
            a, b, path, mesh=mesh(n_to), exchange=exchange, plan=plan,
            elastic=True, **KW)
    assert bool(res.converged)
    err = float((res.x - clean.x).abs().max())
    assert err < 1e-5, err
    if planned is not None:
        same_as_jax(res, planned["resumed"])
    if (n_from, n_to, exchange) == (4, 2, None):
        assert its(res) == its(jax_runs["migrated"])
    migs = migrations(buf)
    assert len(migs) == 1
    m = migs[0]
    assert (m["n_shards_from"], m["n_shards_to"]) == (n_from, n_to)
    assert m["reason"] == "resume_mesh_change"
    assert m["seam_rel_err"] < 1e-8
    assert m["r_norm"] == pytest.approx(m["checkpoint_r_norm"], rel=1e-8)


def test_explicit_plan_resume(problem, jax_runs, tmp_path):
    """An explicit partition plan - a JAX ``plan_partition`` under the
    shared model, crossing through its JSON file - drives the elastic
    resume (the JAX case) to the JAX resume's count and x, and the
    migration lifts through it and back."""
    a, b = problem
    clean = tpar.solve_distributed(a, b, mesh=mesh(4), tol=1e-8,
                                   maxiter=500)
    path = str(tmp_path / "el_plan.npz")
    preempted(a, b, path, n_shards=4)
    plan2 = PartitionPlan.load(jax_runs["plan2_json"])
    assert plan2.fingerprint() == jax_runs["plan2"].fingerprint()
    assert not plan2.is_trivial()
    c = ck.load_checkpoint(path, device="cpu")
    lifted = lift_checkpoint(c, 240, n_shards=4)
    mig = migrate_checkpoint(c, 2, a=a, n_shards_old=4, plan=plan2)
    assert mig.plan is plan2
    back = lift_checkpoint(mig.checkpoint, 240, n_shards=2, plan=plan2)
    for leaf in ("x", "r", "p"):
        np.testing.assert_array_equal(getattr(back, leaf),
                                      getattr(lifted, leaf))
    res = ck.solve_resumable_distributed(a, b, path, mesh=mesh(2),
                                         plan=plan2, elastic=True, **KW)
    assert bool(res.converged)
    err = float((res.x - clean.x).abs().max())
    assert err < 1e-5, err
    same_as_jax(res, jax_runs["plan2_resumed"])


def test_a_stored_plan_is_refused(problem, jax_runs, tmp_path):
    """A snapshot whose layout records a partition plan migrates since
    the planner's port (the name is the refusal's it replaced): a JAX
    planned snapshot on 4 shards resumes on 2 in the port, lifted
    through the stored plan's permutation and variable rows, to the
    JAX package's own resume of that snapshot."""
    a, b = problem
    path = str(tmp_path / "planned.npz")
    shutil.copy(jax_runs["planned_snapshot"], path)
    layout = json.loads(str(np.load(path)["layout"]))
    assert layout["plan"] is not None
    with events.capture() as buf:
        res = ck.solve_resumable_distributed(a, b, path, mesh=mesh(2),
                                             elastic=True, **KW)
    assert bool(res.converged)
    clean = tpar.solve_distributed(a, b, mesh=mesh(2), tol=1e-8,
                                   maxiter=500)
    assert float((res.x - clean.x).abs().max()) < 1e-5
    same_as_jax(res, jax_runs["planned_migrated"])
    m = migrations(buf)[0]
    assert (m["n_shards_from"], m["n_shards_to"]) == (4, 2)
    assert m["seam_rel_err"] < 1e-8


def test_mismatch_matrix(problem, tmp_path):
    """Migratable (layout differs) vs fatal (problem differs)."""
    a, b = problem
    path = str(tmp_path / "mm.npz")
    preempted(a, b, path, n_shards=4)
    with pytest.raises(ck.CheckpointMismatch) as ei:
        ck.solve_resumable_distributed(a, b, path, mesh=mesh(2), **KW)
    assert ei.value.migratable
    assert ei.value.stored_layout["n_shards"] == 4
    with pytest.raises(ck.CheckpointMismatch) as ei:
        ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                       exchange="gather", **KW)
    assert ei.value.migratable
    with pytest.raises(ck.CheckpointMismatch) as ei:
        ck.solve_resumable_distributed(a, b + 1.0, path, mesh=mesh(4),
                                       elastic=True, **KW)
    assert not ei.value.migratable


def test_same_layout_elastic_resume_is_bitwise(problem, jax_runs, tmp_path):
    """elastic=True with NO layout change does not migrate: the resumed
    trajectory stays bit-exact."""
    a, b = problem
    full = ck.solve_resumable_distributed(a, b, str(tmp_path / "f.npz"),
                                          mesh=mesh(4), **KW)
    assert its(full) == its(jax_runs[(4, None)])
    path = str(tmp_path / "same.npz")
    preempted(a, b, path, n_shards=4)
    with events.capture() as buf:
        res = ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                             elastic=True, **KW)
    assert not migrations(buf)
    assert torch.equal(res.x, full.x)


# -- TestCorruptCheckpoint -------------------------------------------------------------


def tear(path):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 3])


def test_torn_write_is_typed(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "torn.npz")
    preempted(a, b, path, n_shards=4)
    tear(path)
    with pytest.raises(ck.CheckpointCorrupt, match="unreadable"):
        ck.load_checkpoint(path, device="cpu")


def test_fallback_to_previous_snapshot(problem, tmp_path):
    a, b = problem
    full = ck.solve_resumable_distributed(a, b, str(tmp_path / "full.npz"),
                                          mesh=mesh(4), **KW)
    path = str(tmp_path / "fb.npz")
    preempted(a, b, path, n_shards=4, segments=2, keep_last=2)
    assert os.path.exists(path + ".prev1")
    tear(path)
    with events.capture() as buf:
        res = ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                             keep_last=2, **KW)
    falls = [e for e in captured(buf) if e["event"] == "solve_recovery"
             and e["action"] == "checkpoint_fallback"]
    assert len(falls) == 1 and falls[0]["skipped"] == 1
    assert bool(res.converged)
    assert torch.equal(res.x, full.x)


def test_fallback_never_rotates_corrupt_over_good(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "rot.npz")
    preempted(a, b, path, n_shards=4, segments=2, keep_last=2)
    tear(path)
    with pytest.raises(PreemptedError):
        ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                       keep_last=2, preempt=Preemption(1),
                                       **KW)
    ck.load_checkpoint(path, device="cpu")
    ck.load_checkpoint(path + ".prev1", device="cpu")


def test_every_snapshot_corrupt_raises(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "allbad.npz")
    preempted(a, b, path, n_shards=4, segments=2, keep_last=2)
    for p in (path, path + ".prev1"):
        with open(p, "wb") as f:
            f.write(b"not a zip at all")
    with pytest.raises(ck.CheckpointCorrupt):
        ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                       keep_last=2, **KW)


def test_converged_run_removes_all_snapshots(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "done.npz")
    res = ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                         keep_last=3, **KW)
    assert bool(res.converged)
    assert not os.path.exists(path)
    assert not os.path.exists(path + ".prev1")


# -- test_robust.py TestPreemptionDrill --------------------------------------------------


def test_resume_bitwise_trajectory(problem, jax_runs, tmp_path):
    a, b = problem
    full = ck.solve_resumable_distributed(a, b, str(tmp_path / "full.npz"),
                                          mesh=mesh(4), **KW)
    assert bool(full.converged) and its(full) == its(jax_runs[(4, None)])
    path = str(tmp_path / "preempted.npz")
    preempted(a, b, path, n_shards=4)
    resumed = ck.solve_resumable_distributed(a, b, path, mesh=mesh(4), **KW)
    assert bool(resumed.converged) and its(resumed) == its(full)
    assert torch.equal(resumed.x, full.x)
    np.testing.assert_allclose(resumed.x.numpy(),
                               np.asarray(jax_runs[(4, None)].x),
                               rtol=0, atol=1e-10)


def test_mismatched_layout_fails_typed(problem, tmp_path):
    a, b = problem
    path = str(tmp_path / "layout.npz")
    preempted(a, b, path, n_shards=4)
    with pytest.raises(ck.CheckpointMismatch):
        ck.solve_resumable_distributed(a, b, path, mesh=mesh(4),
                                       exchange="gather", **KW)
    with pytest.raises(ck.CheckpointMismatch):
        ck.solve_resumable_distributed(a, b, path, mesh=mesh(2), **KW)


# -- across the packages, the cache, the refusals, the ranks -----------------------------


def test_a_jax_snapshot_migrates_in_the_port(problem, jax_runs, tmp_path):
    """A JAX snapshot with layout metadata (4 shards) resumes elastically
    on 2 port shards, to the JAX migrated run's count."""
    a, b = problem
    path = str(tmp_path / "from_jax.npz")
    shutil.copy(jax_runs["snapshot"], path)
    assert ck.distributed_fingerprint(a, b, n_shards=4) == str(
        np.load(path)["fingerprint"])
    with events.capture() as buf:
        res = ck.solve_resumable_distributed(a, b, path, mesh=mesh(2),
                                             elastic=True, **KW)
    want = jax_runs["migrated"]
    assert its(res) == its(want) and int(res.status) == int(want.status)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-10)
    assert len(migrations(buf)) == 1


def test_a_port_snapshot_migrates_in_jax(problem, jax_runs, tmp_path):
    a, b = problem
    path = str(tmp_path / "from_port.npz")
    preempted(a, b, path, n_shards=4)
    res = jck.solve_resumable_distributed(
        jax_runs["a"], b, path, mesh=jpar.make_mesh(2), elastic=True, **KW)
    want = jax_runs["migrated"]
    assert its(res) == its(want)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(want.x),
                               rtol=0, atol=1e-10)


def test_one_cached_solver_serves_every_segment(problem, tmp_path):
    a, b = problem
    m = mesh(4)
    tdist.clear_solver_cache()
    built = tdist._BUILD_COUNT[0]
    res = ck.solve_resumable_distributed(a, b, str(tmp_path / "c.npz"),
                                         mesh=m, segment_iters=7,
                                         tol=1e-8, maxiter=500)
    assert its(res) > 3 * 7          # several segments, the first fresh
    assert tdist._BUILD_COUNT[0] - built == 1
    assert len(tdist._SOLVER_CACHE) == 1
    # the unsplit solve on the same mesh shares it too
    tpar.solve_distributed(a, b, mesh=m, tol=1e-8, maxiter=500)
    assert tdist._BUILD_COUNT[0] - built == 1


# the ids keep their first names: inject= runs since its port (ROADMAP
# A15, tests/test_torch_robust.py), and an object that is no FaultPlan
# passes the host-level gate and gets the JAX package's TypeError from
# solve_distributed; watchdog= runs since its port (item 9b,
# tests/test_torch_watchdog.py), and an object that is no watchdog
# fails where the JAX loop first reads it, after the first segment
@pytest.mark.parametrize("kw,error,match", [
    (dict(watchdog=object()), AttributeError, "check_every_segments"),
    (dict(inject=object()), TypeError, "FaultPlan"),
    # plan= runs since its port (test_mesh_roundtrip): an object that is
    # no PartitionPlan gets the JAX package's TypeError
    (dict(plan=object()), TypeError, "PartitionPlan"),
], ids=["watchdog", "inject", "plan"])
def test_in_run_triggers_are_refused(problem, tmp_path, kw, error, match):
    a, b = problem
    with pytest.raises(error, match=match):
        ck.solve_resumable_distributed(a, b, str(tmp_path / "r.npz"),
                                       mesh=mesh(2), **KW, **kw)


# the ids keep their first names: the fault plan, its sites, the
# recovery loop (ROADMAP A15) and the straggler watchdog (item 9b) are
# ported, and each is the JAX package's (fingerprint, sites, signature)
@pytest.mark.parametrize("name", ["FaultPlan", "StragglerWatchdog",
                                  "solve_with_recovery", "FAULT_SITES"])
def test_robust_names_of_a15_are_refused(name):
    import inspect

    import cuda_mpi_parallel_tpu.robust as jrobust

    ours, theirs = getattr(robust, name), getattr(jrobust, name)
    if name == "FAULT_SITES":
        assert ours == theirs
    elif name == "FaultPlan":
        plan = dict(site="halo", iteration=7, shard=1, sticky=True)
        assert ours(**plan).fingerprint() == theirs(**plan).fingerprint()
        assert ours(**plan).to_json() == theirs(**plan).to_json()
    else:
        assert list(inspect.signature(ours).parameters) \
            == list(inspect.signature(theirs).parameters)


def test_gloo_ranks_resume_the_stacked_mesh_bits(problem, tmp_path):
    """Two gloo ranks: rank 0 writes the snapshots, both read them, and
    the preempted-and-resumed solve is the stacked 2-shard run's bits."""
    import torch.multiprocessing as mp

    a, b = problem
    out = str(tmp_path / "result")
    path = str(tmp_path / "ranks.npz")
    init = "file://" + str(tmp_path / "rendezvous")
    mp.spawn(ranks.resumable_rank, args=(2, init, out, FIXTURE, path),
             nprocs=2, join=True)
    want = ck.solve_resumable_distributed(a, b, str(tmp_path / "s.npz"),
                                          mesh=mesh(2), **KW)
    for rank in range(2):
        got = torch.load(f"{out}.{rank}")
        assert got["k"] == 40 and got["prev"] and not got["left"]
        assert got["iterations"] == its(want)
        assert torch.equal(got["x"], want.x)
