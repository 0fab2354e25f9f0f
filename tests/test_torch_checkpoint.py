"""The port's checkpoint/resume (``utils.checkpoint``) against the JAX
package's.

The JAX ``tests/test_checkpoint.py`` carried over as parity cases: the
same problems (numpy-seeded, handed to both packages) through the port's
``solve``/``solve_resumable``, ``cg_df64``/``solve_resumable_df64``
(general and the resident replay on B11's plain twin, the counterpart
of the JAX interpret mode) on the CPU.

Parity contract: a segmented port run is bit-equal to the port's own
uninterrupted run wherever the JAX package asserts that of itself, and
takes the JAX iteration count (each JAX reference computed once, in a
module fixture).  Beside them the cross-package cases: the fingerprint
of each operator class whose fields match equals the JAX one byte for
byte, and a checkpoint file written by either package resumes in the
other.
"""
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import operators as jops
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.utils import checkpoint as jck
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch.models import operators as tops
from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

RES_GRID = (16, 128)       # the resident replay's stencil (B11's twin)


def csr_pair(nx, ny, dtype=np.float64):
    """The same assembled 2D Poisson CSR in both packages."""
    ja = jpoisson.poisson_2d_csr(nx, ny, dtype=dtype)
    ta = pt.CSRMatrix.from_arrays(np.asarray(ja.data), np.asarray(ja.indices),
                                  np.asarray(ja.indptr), ja.shape,
                                  device="cpu")
    return ja, ta


def vec(n, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(n) * scale


def df64_problem(n, seed):
    """2D Poisson n x n in float64 and b = A x_true (x_true seeded)."""
    ja, ta = csr_pair(n, n)
    b = np.asarray(ja.to_dense(), np.float64) @ vec(n * n, seed)
    return ja, ta, b


def resident_problem():
    """The resident replay's (16, 128) f32 stencil in both packages and a
    float64 rhs."""
    return (jpoisson.poisson_2d_operator(*RES_GRID, dtype=jnp.float32),
            pt.Stencil2D.create(*RES_GRID, device="cpu"),
            vec(RES_GRID[0] * RES_GRID[1], 7))


@pytest.fixture(scope="module")
def jax_refs():
    """Each JAX reference solve, once."""
    out = {}
    ja, _ = csr_pair(12, 12)
    out["resume"] = jp.solve(ja, jnp.asarray(vec(144, 0)), tol=1e-10,
                             maxiter=400)
    out["rtol"] = jp.solve(ja, jnp.asarray(vec(144, 2, 1e3)), tol=0.0,
                           rtol=1e-9, maxiter=400)
    ja, _ = csr_pair(14, 14)
    for seed in (4, 5):
        out[f"14_{seed}"] = jp.solve(ja, jnp.asarray(vec(196, seed)),
                                     tol=1e-10, maxiter=600)
    for seed in (11, 12):
        ja, _, b = df64_problem(12, seed)
        out[f"df64_{seed}"] = jp.cg_df64(ja, b, tol=0.0, rtol=1e-10,
                                         maxiter=2000)
    ja, _, b = resident_problem()
    out["resident"] = jp.cg_resident_df64(ja, b, tol=0.0, rtol=1e-10,
                                          maxiter=400, interpret=True)
    return out


def its(res):
    return int(res.iterations)


# -- TestResume -----------------------------------------------------------------


def test_segmented_equals_uninterrupted(jax_refs):
    _, a = csr_pair(12, 12)
    b = torch.as_tensor(vec(144, 0))
    full = pt.solve(a, b, tol=1e-10, maxiter=400, record_history=True)
    part1 = pt.solve(a, b, tol=1e-10, maxiter=20, return_checkpoint=True)
    assert not bool(part1.converged)
    part2 = pt.solve(a, b, tol=1e-10, maxiter=400,
                     resume_from=part1.checkpoint, record_history=True)
    assert bool(part2.converged)
    assert its(part2) == its(full) == its(jax_refs["resume"])
    assert torch.equal(part2.x, full.x)
    k = its(full)
    # the residual trace continues seamlessly past the seam
    assert torch.equal(part2.residual_history[20:k + 1],
                       full.residual_history[20:k + 1])
    np.testing.assert_allclose(part2.x.numpy(),
                               np.asarray(jax_refs["resume"].x),
                               rtol=1e-12, atol=1e-12)


def test_checkpoint_counts_toward_total_maxiter():
    _, a = csr_pair(10, 10)
    b = torch.as_tensor(vec(100, 1))
    part = pt.solve(a, b, tol=1e-12, maxiter=15, return_checkpoint=True)
    res = pt.solve(a, b, tol=1e-12, maxiter=25, resume_from=part.checkpoint)
    assert its(res) == 25


def test_rtol_uses_original_nrm0(jax_refs):
    """The relative threshold stays anchored at the ORIGINAL ||r0||."""
    _, a = csr_pair(12, 12)
    b = torch.as_tensor(vec(144, 2, 1e3))
    full = pt.solve(a, b, tol=0.0, rtol=1e-9, maxiter=400)
    part = pt.solve(a, b, tol=0.0, rtol=1e-9, maxiter=30,
                    return_checkpoint=True)
    res = pt.solve(a, b, tol=0.0, rtol=1e-9, maxiter=400,
                   resume_from=part.checkpoint)
    assert its(res) == its(full) == its(jax_refs["rtol"])


# -- TestDiskRoundtrip ------------------------------------------------------------


def test_save_load(tmp_path):
    _, a = csr_pair(8, 8)
    part = pt.solve(a, torch.as_tensor(vec(64, 3)), tol=1e-12, maxiter=10,
                    return_checkpoint=True)
    path = str(tmp_path / "state.npz")
    ck.save_checkpoint(path, part.checkpoint)
    loaded = ck.load_checkpoint(path, device="cpu")
    for field in ("x", "r", "p", "rho", "rr", "nrm0", "k", "indefinite"):
        got, want = getattr(loaded, field), getattr(part.checkpoint, field)
        assert got.dtype == want.dtype and torch.equal(got, want), field


def test_version_mismatch(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path[:-4] + ".tmp", version=999, x=np.zeros(3))
    os.replace(path[:-4] + ".tmp.npz", path)
    with pytest.raises(ValueError, match="format version"):
        ck.load_checkpoint(path, device="cpu")
    with pytest.raises(ValueError, match="format version"):
        jck.load_checkpoint(path)


def test_solve_resumable_end_to_end(tmp_path, jax_refs):
    _, a = csr_pair(14, 14)
    b = torch.as_tensor(vec(196, 4))
    path = str(tmp_path / "run.npz")
    full = pt.solve(a, b, tol=1e-10, maxiter=600)
    res = ck.solve_resumable(a, b, path, segment_iters=25, tol=1e-10,
                             maxiter=600)
    assert bool(res.converged)
    assert its(res) == its(full) == its(jax_refs["14_4"])
    assert torch.equal(res.x, full.x)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jax_refs["14_4"].x),
                               rtol=1e-12, atol=1e-12)
    assert not os.path.exists(path)  # removed on convergence


def test_segments_run_the_general_engine_with_the_total_maxiter(tmp_path):
    """The port's counterpart of "segments reuse one executable": every
    segment is one solve on the general engine (one ``engine_selected``
    event each), and the segmented run is bit-equal to the unsplit one
    whatever the segment length."""
    import json

    from cuda_mpi_parallel_tpu_torch.telemetry import events

    _, a = csr_pair(12, 12)
    b = torch.as_tensor(vec(144, 8))
    full = pt.solve(a, b, tol=1e-10, maxiter=400)
    with events.capture() as buf:
        res = ck.solve_resumable(a, b, str(tmp_path / "seg.npz"),
                                 segment_iters=10, tol=1e-10, maxiter=400)
    engines = [r["engine"] for r in map(json.loads, buf.getvalue().split(
        "\n")[:-1]) if r["event"] == "engine_selected"]
    assert engines == ["general"] * -(-its(full) // 10)
    res7 = ck.solve_resumable(a, b, str(tmp_path / "seg7.npz"),
                              segment_iters=7, tol=1e-10, maxiter=400)
    assert torch.equal(res.x, full.x) and torch.equal(res7.x, full.x)


def test_wrong_problem_rejected(tmp_path):
    _, a = csr_pair(10, 10)
    path = str(tmp_path / "fp.npz")
    ck.solve_resumable(a, torch.as_tensor(vec(100, 10)), path,
                       segment_iters=5, tol=1e-12, maxiter=10)
    with pytest.raises(ck.CheckpointMismatch, match="different problem"):
        ck.solve_resumable(a, torch.as_tensor(vec(100, 11)), path,
                           segment_iters=5, tol=1e-10, maxiter=100)


def test_bad_segment_iters(tmp_path):
    _, a = csr_pair(4, 4)
    with pytest.raises(ValueError, match="segment_iters"):
        ck.solve_resumable(a, torch.ones(16, dtype=torch.float64),
                           str(tmp_path / "x.npz"), segment_iters=0)


def test_x0_and_resume_conflict():
    _, a = csr_pair(6, 6)
    b = torch.ones(36, dtype=torch.float64)
    part = pt.solve(a, b, maxiter=3, return_checkpoint=True)
    with pytest.raises(ValueError, match="not both"):
        pt.solve(a, b, x0=torch.zeros(36, dtype=torch.float64),
                 resume_from=part.checkpoint)


def test_solve_resumable_survives_interruption(tmp_path, jax_refs):
    _, a = csr_pair(14, 14)
    b = torch.as_tensor(vec(196, 5))
    path = str(tmp_path / "run.npz")
    full = pt.solve(a, b, tol=1e-10, maxiter=600)
    res1 = ck.solve_resumable(a, b, path, segment_iters=20, tol=1e-10,
                              maxiter=40)
    assert not bool(res1.converged)
    assert os.path.exists(path)
    res2 = ck.solve_resumable(a, b, path, segment_iters=50, tol=1e-10,
                              maxiter=600)
    assert bool(res2.converged)
    assert its(res2) == its(full) == its(jax_refs["14_5"])
    assert torch.equal(res2.x, full.x)


def test_breakdown_segment_keeps_the_last_good_checkpoint(tmp_path):
    """A segment that breaks down is not saved: the file keeps the last
    finite state (a non-finite coefficient poisons the second segment's
    first matvec; the first segment ran on the finite operator)."""
    _, a = csr_pair(8, 8)
    b = torch.as_tensor(vec(64, 13))
    path = str(tmp_path / "bd.npz")
    ck.solve_resumable(a, b, path, segment_iters=5, tol=1e-12, maxiter=5,
                       keep_checkpoint=True)
    saved = ck.load_checkpoint(path, device="cpu")
    bad = dataclasses.replace(a, data=a.data * float("nan"))
    fp_bad = ck.problem_fingerprint(bad, b)
    ck.save_checkpoint(path, saved, fingerprint=fp_bad)
    res = ck.solve_resumable(bad, b, path, segment_iters=5, tol=1e-12,
                             maxiter=20)
    assert res.status_enum().name == "BREAKDOWN"
    kept = ck.load_checkpoint(path, device="cpu")
    assert int(kept.k) == 5 and torch.isfinite(kept.x).all()


# -- TestDF64DiskRoundtrip --------------------------------------------------------


def test_df64_save_load_resume(tmp_path):
    _, a, b = df64_problem(16, 3)
    part = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=20,
                      return_checkpoint=True)
    fp = ck.problem_fingerprint(a, b)
    path = str(tmp_path / "df64.npz")
    ck.save_checkpoint_df64(path, part.checkpoint, fp)
    loaded = ck.load_checkpoint_df64(path, expect_fingerprint=fp,
                                     device="cpu")
    # the float64 state crosses the file whole
    for got, want in zip(loaded.state64, part.checkpoint.state64):
        assert torch.equal(got, want)
    resumed = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=2000,
                         resume_from=loaded)
    full = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=2000)
    assert its(resumed) == its(full)
    assert torch.equal(resumed.x64, full.x64)
    # kind mismatch is loud in both directions
    with pytest.raises(ValueError, match="df64"):
        ck.load_checkpoint(path, device="cpu")
    r32 = pt.solve(a, torch.as_tensor(b), tol=0.0, rtol=1e-8, maxiter=10,
                   return_checkpoint=True)
    f32_path = str(tmp_path / "f32.npz")
    ck.save_checkpoint(f32_path, r32.checkpoint, fp)
    with pytest.raises(ValueError, match="not a df64"):
        ck.load_checkpoint_df64(f32_path, device="cpu")


# -- TestFingerprintUnverifiable ------------------------------------------------------


def test_npz_warns_on_empty_stored_fingerprint(tmp_path):
    _, a = csr_pair(8, 8)
    part = pt.solve(a, torch.as_tensor(vec(64, 6)), tol=0.0, maxiter=5,
                    return_checkpoint=True)
    path = str(tmp_path / "nofp.npz")
    ck.save_checkpoint(path, part.checkpoint)  # no fingerprint
    with pytest.warns(UserWarning, match="UNVERIFIED"):
        ck.load_checkpoint(path, expect_fingerprint="deadbeef", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ck.load_checkpoint(path, device="cpu")


def test_df64_warns_on_empty_stored_fingerprint(tmp_path):
    _, a, b = df64_problem(8, 6)
    part = pt.cg_df64(a, b, tol=0.0, maxiter=5, return_checkpoint=True)
    path = str(tmp_path / "nofp64.npz")
    ck.save_checkpoint_df64(path, part.checkpoint)
    with pytest.warns(UserWarning, match="UNVERIFIED"):
        ck.load_checkpoint_df64(path, expect_fingerprint="deadbeef",
                                device="cpu")


def test_mismatch_still_raises(tmp_path):
    _, a = csr_pair(8, 8)
    part = pt.solve(a, torch.as_tensor(vec(64, 6)), tol=0.0, maxiter=5,
                    return_checkpoint=True)
    path = str(tmp_path / "fp.npz")
    ck.save_checkpoint(path, part.checkpoint, fingerprint="aaaa")
    with pytest.raises(ValueError, match="different problem"):
        ck.load_checkpoint(path, expect_fingerprint="bbbb", device="cpu")


# -- TestDF64Resumable ----------------------------------------------------------------


def test_df64_segmented_matches_single_run(tmp_path, jax_refs):
    _, a, b = df64_problem(12, 11)
    path = str(tmp_path / "df64_seg.npz")
    full = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=2000)
    res = ck.solve_resumable_df64(a, b, path, segment_iters=20, tol=0.0,
                                  rtol=1e-10, maxiter=2000)
    assert bool(res.converged)
    assert its(res) == its(full) == its(jax_refs["df64_11"])
    assert torch.equal(res.x64, full.x64)
    assert torch.equal(res.x_hi, full.x_hi)
    np.testing.assert_allclose(res.x(), jax_refs["df64_11"].x(),
                               rtol=0, atol=1e-10)
    assert not os.path.exists(path)


def test_df64_preemption_resume(tmp_path, jax_refs):
    _, a, b = df64_problem(12, 12)
    path = str(tmp_path / "df64_pre.npz")
    ck.solve_resumable_df64(a, b, path, segment_iters=10, tol=0.0,
                            rtol=1e-10, maxiter=10, keep_checkpoint=True)
    assert os.path.exists(path)
    res = ck.solve_resumable_df64(a, b, path, segment_iters=25, tol=0.0,
                                  rtol=1e-10, maxiter=2000)
    full = pt.cg_df64(a, b, tol=0.0, rtol=1e-10, maxiter=2000)
    assert bool(res.converged)
    assert its(res) == its(full) == its(jax_refs["df64_12"])
    # the float64 state crossed the file: bit-equal to the unsplit run
    assert torch.equal(res.x64, full.x64)


# -- TestDF64ResidentResumable (B11's plain twin, the JAX interpret mode) ---------------


def test_resident_segmented_bitwise_matches_uninterrupted(tmp_path,
                                                         jax_refs):
    _, a, b = resident_problem()
    path = str(tmp_path / "res_seg.npz")
    full = pt.cg_resident_df64(a, b, tol=0.0, rtol=1e-10, maxiter=400,
                               interpret=True)
    res = ck.solve_resumable_df64(a, b, path, segment_iters=48, tol=0.0,
                                  rtol=1e-10, maxiter=400, engine="resident",
                                  interpret=True)
    assert bool(res.converged)
    assert its(res) == its(full) == its(jax_refs["resident"])
    assert torch.equal(res.x_hi, full.x_hi)
    assert torch.equal(res.x_lo, full.x_lo)
    np.testing.assert_allclose(res.x(), jax_refs["resident"].x(),
                               rtol=0, atol=1e-10 * np.abs(res.x()).max())
    assert not os.path.exists(path)


def test_resident_preemption_resume_bitwise(tmp_path, jax_refs):
    _, a, b = resident_problem()
    path = str(tmp_path / "res_pre.npz")
    ck.solve_resumable_df64(a, b, path, segment_iters=32, tol=0.0,
                            rtol=1e-10, maxiter=32, engine="resident",
                            keep_checkpoint=True, interpret=True)
    assert os.path.exists(path)
    with np.load(path) as z:
        assert str(z["kind"]) == "df64-replay" and int(z["k"]) == 32
        assert int(z["fold_radix"]) == 2
    res = ck.solve_resumable_df64(a, b, path, segment_iters=100, tol=0.0,
                                  rtol=1e-10, maxiter=400, engine="resident",
                                  interpret=True)
    full = pt.cg_resident_df64(a, b, tol=0.0, rtol=1e-10, maxiter=400,
                               interpret=True)
    assert bool(res.converged)
    assert its(res) == its(full) == its(jax_refs["resident"])
    assert torch.equal(res.x_hi, full.x_hi)


def test_resident_format_cross_engine_errors(tmp_path):
    _, a, b = resident_problem()
    path = str(tmp_path / "cross.npz")
    ck.solve_resumable_df64(a, b, path, segment_iters=32, tol=0.0,
                            rtol=1e-10, maxiter=32, engine="resident",
                            keep_checkpoint=True, interpret=True)
    with pytest.raises(ValueError, match="replay"):
        ck.solve_resumable_df64(a, b, path, segment_iters=32, tol=0.0,
                                rtol=1e-10, maxiter=64, engine="general")
    # and a general-path file refuses the replay engine
    gpath = str(tmp_path / "general.npz")
    ck.solve_resumable_df64(a, b, gpath, segment_iters=8, tol=0.0,
                            rtol=1e-10, maxiter=8, keep_checkpoint=True)
    with pytest.raises(ValueError, match="not a df64 replay"):
        ck.solve_resumable_df64(a, b, gpath, segment_iters=8, tol=0.0,
                                rtol=1e-10, maxiter=16, engine="resident",
                                interpret=True)


def test_resident_refuses_another_fold_radix(tmp_path):
    """The JAX package records its df64 fold radix; the port's B11 has
    one summation order (the radix-2 record), so another is refused."""
    _, a, b = resident_problem()
    path = str(tmp_path / "radix.npz")
    fp = ck.problem_fingerprint(a, b)
    np.savez(path[:-4], version=2, fingerprint=fp, kind="df64-replay",
             k=np.asarray(32), fold_radix=np.asarray(4),
             x_hi=np.zeros(a.n, np.float32), x_lo=np.zeros(a.n, np.float32))
    with pytest.raises(ValueError, match="one summation order"):
        ck.solve_resumable_df64(a, b, path, segment_iters=32, tol=0.0,
                                rtol=1e-10, maxiter=64, engine="resident",
                                interpret=True)


def test_auto_stays_general_off_hopper(tmp_path):
    """engine="auto" takes the replay only on a Hopper card or with
    interpret=True: on the CPU it stays general (full CG state files)."""
    _, a, b = resident_problem()
    path = str(tmp_path / "auto.npz")
    res = ck.solve_resumable_df64(a, b, path, segment_iters=100, tol=0.0,
                                  rtol=1e-10, maxiter=300, engine="auto")
    assert bool(res.converged)
    ck.solve_resumable_df64(a, b, path, segment_iters=10, tol=0.0,
                            rtol=1e-10, maxiter=10, engine="auto",
                            keep_checkpoint=True)
    with np.load(path) as z:
        assert str(z["kind"]) == "df64"
    # interpret=True asks for the replay
    rpath = str(tmp_path / "auto_replay.npz")
    ck.solve_resumable_df64(a, b, rpath, segment_iters=32, tol=0.0,
                            rtol=1e-10, maxiter=32, engine="auto",
                            keep_checkpoint=True, interpret=True)
    with np.load(rpath) as z:
        assert str(z["kind"]) == "df64-replay"


def test_engine_resident_rejects_unsupported(tmp_path):
    _, a = csr_pair(16, 16)
    with pytest.raises(ValueError, match="resident"):
        ck.solve_resumable_df64(a, vec(256, 1), str(tmp_path / "x.npz"),
                                engine="resident")
    with pytest.raises(ValueError, match="unknown engine"):
        ck.solve_resumable_df64(a, vec(256, 1), str(tmp_path / "x.npz"),
                                engine="streaming")


def test_warm_start_df64_kernel():
    """x0 on B11's twin: an explicit zero x0 matches the fast path bit
    for bit, and a near-solution x0 needs fewer iterations."""
    _, a, b = resident_problem()
    r0 = pt.cg_resident_df64(a, b, tol=0.0, rtol=1e-10, maxiter=200,
                             check_every=8, interpret=True)
    rz = pt.cg_resident_df64(a, b, x0=np.zeros_like(b), tol=0.0, rtol=1e-10,
                             maxiter=200, check_every=8, interpret=True)
    assert its(r0) == its(rz)
    assert torch.equal(r0.x_hi, rz.x_hi) and torch.equal(r0.x_lo, rz.x_lo)
    x_true = vec(b.shape[0], 8)
    b2 = (a @ torch.as_tensor(x_true, dtype=torch.float32)).double().numpy()
    warm = pt.cg_resident_df64(a, b2, x0=x_true * (1 + 1e-6), tol=1e-6,
                               maxiter=200, check_every=4, interpret=True)
    cold = pt.cg_resident_df64(a, b2, tol=1e-6, maxiter=200, check_every=4,
                               interpret=True)
    assert bool(warm.converged)
    assert its(warm) < its(cold)


# -- TestFingerprintOperatorIdentity ----------------------------------------------------


def test_stencil_scale_changes_fingerprint():
    b = np.ones(256, np.float32)
    a1 = pt.Stencil2D.create(16, 16, device="cpu")
    a2 = pt.Stencil2D.create(16, 16, scale=2.0, device="cpu")
    assert ck.problem_fingerprint(a1, b) != ck.problem_fingerprint(a2, b)
    a1b = pt.Stencil2D.create(16, 16, device="cpu")
    assert ck.problem_fingerprint(a1, b) == ck.problem_fingerprint(a1b, b)


def test_backend_choice_does_not_change_fingerprint():
    b = np.ones(16 * 128, np.float32)
    a_xla = pt.Stencil2D.create(16, 128, backend="xla", device="cpu")
    a_hand = pt.Stencil2D.create(16, 128, backend="pallas", device="cpu")
    assert ck.problem_fingerprint(a_xla, b) \
        == ck.problem_fingerprint(a_hand, b)


def test_csr_values_change_fingerprint():
    b = np.ones(64, np.float32)
    _, a1 = csr_pair(8, 8, np.float32)
    a2 = dataclasses.replace(a1, data=a1.data * 1.5)
    assert ck.problem_fingerprint(a1, b) != ck.problem_fingerprint(a2, b)


def test_grid_dims_change_fingerprint():
    b = np.ones(256, np.float32)
    a1 = pt.Stencil2D.create(8, 32, device="cpu")
    a2 = pt.Stencil2D.create(32, 8, device="cpu")
    assert ck.problem_fingerprint(a1, b) != ck.problem_fingerprint(a2, b)


def test_resume_against_rescaled_operator_rejected(tmp_path):
    path = str(tmp_path / "ck.npz")
    a1 = pt.Stencil2D.create(16, 16, device="cpu")
    b = torch.as_tensor(vec(256, 0).astype(np.float32))
    ck.solve_resumable(a1, b, path, segment_iters=3, tol=1e30, maxiter=3,
                       keep_checkpoint=True)
    a2 = pt.Stencil2D.create(16, 16, scale=2.0, device="cpu")
    with pytest.raises(ValueError, match="different problem"):
        ck.solve_resumable(a2, b, path, segment_iters=3, maxiter=6)


# -- across the packages ---------------------------------------------------------------


def _operator_pairs():
    """``(name, JAX operator, port operator)`` built from the same arrays,
    one per class whose fields match."""
    ja, ta = csr_pair(16, 16, np.float32)
    dense = np.asarray(ja.to_dense())
    return [
        ("Stencil2D", jops.Stencil2D.create(16, 16, scale=2.5,
                                            dtype=jnp.float32),
         pt.Stencil2D.create(16, 16, scale=2.5, device="cpu")),
        ("Stencil2D-f64", jops.Stencil2D.create(16, 16, dtype=jnp.float64),
         pt.Stencil2D.create(16, 16, dtype=torch.float64, device="cpu")),
        ("Stencil3D", jops.Stencil3D.create(4, 8, 8, dtype=jnp.float32),
         pt.Stencil3D.create(4, 8, 8, device="cpu")),
        ("CSRMatrix", ja, ta),
        ("ELLMatrix", ja.to_ell(), ta.to_ell()),
        ("DIAMatrix", ja.to_dia(), ta.to_dia()),
        ("DenseOperator", jops.DenseOperator(jnp.asarray(dense)),
         tops.DenseOperator.create(dense, device="cpu")),
        ("JacobiPreconditioner", jops.JacobiPreconditioner.from_operator(ja),
         tops.JacobiPreconditioner.from_operator(ta)),
        ("IdentityOperator", jops.IdentityOperator(256),
         tops.IdentityOperator(256, _device="cpu")),
    ]


@pytest.mark.parametrize("index", range(9),
                         ids=[p[0] for p in _operator_pairs()])
def test_fingerprint_equals_jax(index):
    _, jop, top = _operator_pairs()[index]
    b = vec(256, 9).astype(np.float32)
    assert ck.problem_fingerprint(top, b) == jck.problem_fingerprint(jop, b)
    assert ck.problem_fingerprint(top, torch.as_tensor(b)) \
        == jck.problem_fingerprint(jop, jnp.asarray(b))
    assert ck.operator_fingerprint(top) == jck.operator_fingerprint(jop)


def test_shiftell_fingerprint_is_the_ports_own():
    """Hopper's sliced-ELL arrays replace the TPU's shift-ELL sheets, so
    the shift-ELL fingerprint is the port's own (recorded, not a match)."""
    ja, ta = csr_pair(16, 16, np.float32)
    b = vec(256, 9).astype(np.float32)
    fp = ck.problem_fingerprint(ta.to_shiftell(), b)
    assert fp != jck.problem_fingerprint(ja.to_shiftell(), b)
    assert fp == ck.problem_fingerprint(ta.to_shiftell(), b)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, jax_refs):
    ja, ta = csr_pair(14, 14)
    b = vec(196, 5)
    path = str(tmp_path / "jax.npz")
    first = jck.solve_resumable(ja, jnp.asarray(b), path, segment_iters=20,
                                tol=1e-10, maxiter=40)
    assert not bool(first.converged) and os.path.exists(path)
    res = ck.solve_resumable(ta, torch.as_tensor(b), path, segment_iters=50,
                             tol=1e-10, maxiter=600)
    want = jax_refs["14_5"]
    assert bool(res.converged) and its(res) == its(want)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                               rtol=1e-12, atol=1e-12)


def test_a_port_checkpoint_resumes_in_jax(tmp_path, jax_refs):
    ja, ta = csr_pair(14, 14)
    b = vec(196, 5)
    path = str(tmp_path / "port.npz")
    first = ck.solve_resumable(ta, torch.as_tensor(b), path,
                               segment_iters=20, tol=1e-10, maxiter=40)
    assert not bool(first.converged) and os.path.exists(path)
    res = jck.solve_resumable(ja, jnp.asarray(b), path, segment_iters=50,
                              tol=1e-10, maxiter=600)
    want = jax_refs["14_5"]
    assert bool(res.converged) and its(res) == its(want)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(want.x),
                               rtol=1e-12, atol=1e-12)


def test_df64_checkpoints_cross_the_packages(tmp_path, jax_refs):
    """A JAX df64 file (pairs only) resumes in the port, and the port's
    (pairs plus float64 members) in JAX, each to the JAX count."""
    ja, ta, b = df64_problem(12, 12)
    want = jax_refs["df64_12"]
    jpath, tpath = str(tmp_path / "j64.npz"), str(tmp_path / "t64.npz")
    jck.solve_resumable_df64(ja, b, jpath, segment_iters=10, tol=0.0,
                             rtol=1e-10, maxiter=10, keep_checkpoint=True)
    res = ck.solve_resumable_df64(ta, b, jpath, segment_iters=25, tol=0.0,
                                  rtol=1e-10, maxiter=2000)
    assert its(res) == its(want)
    np.testing.assert_allclose(res.x(), want.x(), rtol=0, atol=1e-10)
    ck.solve_resumable_df64(ta, b, tpath, segment_iters=10, tol=0.0,
                            rtol=1e-10, maxiter=10, keep_checkpoint=True)
    jres = jck.solve_resumable_df64(ja, b, tpath, segment_iters=25, tol=0.0,
                                    rtol=1e-10, maxiter=2000)
    assert its(jres) == its(want)
    np.testing.assert_allclose(jres.x(), want.x(), rtol=0, atol=1e-10)


def test_a_jax_replay_checkpoint_resumes_in_the_port(tmp_path, jax_refs):
    ja, ta, b = resident_problem()
    path = str(tmp_path / "jreplay.npz")
    jck.solve_resumable_df64(ja, b, path, segment_iters=32, tol=0.0,
                             rtol=1e-10, maxiter=32, engine="resident",
                             keep_checkpoint=True, interpret=True)
    res = ck.solve_resumable_df64(ta, b, path, segment_iters=100, tol=0.0,
                                  rtol=1e-10, maxiter=400, engine="resident",
                                  interpret=True)
    full = pt.cg_resident_df64(ta, b, tol=0.0, rtol=1e-10, maxiter=400,
                               interpret=True)
    assert its(res) == its(jax_refs["resident"]) == its(full)
    assert torch.equal(res.x_hi, full.x_hi)


@pytest.mark.parametrize("call", [
    lambda p: ck.save_checkpoint_orbax(p, None),
    lambda p: ck.load_checkpoint_orbax(p),
    lambda p: ck.solve_resumable(pt.Stencil2D.create(4, 4, device="cpu"),
                                 np.ones(16, np.float32), p,
                                 backend="orbax"),
    lambda p: ck.solve_resumable_distributed(
        pt.Stencil2D.create(4, 4, device="cpu"), np.ones(16, np.float32),
        p, backend="orbax"),
], ids=["save", "load", "solve_resumable", "solve_resumable_distributed"])
def test_orbax_is_refused(tmp_path, call):
    with pytest.raises(NotImplementedError, match="orbax is a JAX library"):
        call(str(tmp_path / "o"))
