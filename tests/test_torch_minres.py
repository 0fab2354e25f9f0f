"""The port's MINRES (``solver.minres``) against the JAX package's.

The JAX ``tests/test_minres.py`` carried over as parity tests: the same
numpy-seeded systems go through the JAX function and the port's (on the
CPU, where a wrapper runs its plain twin), and the port is also held to
scipy's ``minres`` and to the properties the JAX tests check.

Tolerances (the ROADMAP parity contract):

* iteration counts and statuses equal the JAX package's;
* f64: x within ``1e-9 * max|x|`` of the JAX solution (both round every
  operation in float64; only the order of the sums differs);
* f32: x within ``1e-4 * max|x|`` (f32 sums in another order drift the
  iterates apart by a few ulps an iteration);
* the f64 lane (``minres_df64``): the port computes in float64 where the
  JAX package carries double-float pairs (about 48 significand bits, 53
  here), so x agrees within ``1e-9 * max|x|`` and the counts are equal
  at the tolerances ``tests/test_torch_df64.py`` holds ``cg_df64`` to.

The distributed f64 MINRES waits for ROADMAP A10 with the rest of the
distributed f64 lane: the JAX ``test_df64_mesh_matches_single_device``
and ``test_df64_minres_gating`` become a test that the port raises
naming A10.
"""
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.solver import minres as jminres
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.solver import minres as tminres

tcg = sys.modules["cuda_mpi_parallel_tpu_torch.solver.cg"]

torch.set_num_threads(1)

X_TOL_F64 = 1e-9
X_TOL_F32 = 1e-4


def _indefinite_system(n=200, n_neg=40, seed=3):
    """The JAX test's symmetric indefinite system: Q diag(eigs) Q^T with
    ``n_neg`` negative eigenvalues, and a seeded rhs."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([rng.uniform(0.5, 3.0, n - n_neg),
                           -rng.uniform(0.2, 1.0, n_neg)])
    a = (q * eigs) @ q.T
    a = 0.5 * (a + a.T)
    return a, rng.standard_normal(n)


def _dense(a, dtype=np.float64):
    """The same dense matrix in both packages (the port's on the CPU)."""
    return (jnp.asarray(a.astype(dtype)),
            pt.DenseOperator.create(a.astype(dtype), device="cpu"))


def _stencils(nx, ny, dtype):
    return (jpoisson.poisson_2d_operator(nx, ny, dtype=dtype),
            tpoisson.poisson_2d_operator(nx, ny, dtype=dtype, device="cpu"))


def _assert_same(res, jres, x_tol):
    """Equal count, status and flag; x within ``x_tol * max|x|``."""
    assert int(res.iterations) == int(jres.iterations)
    assert int(res.status) == int(jres.status)
    assert bool(res.indefinite) == bool(jres.indefinite)
    jx = np.asarray(jres.x)
    err = np.abs(res.x.numpy() - jx).max()
    assert err <= x_tol * max(np.abs(jx).max(), 1.0)


# -- the oracle ---------------------------------------------------------------


@pytest.mark.parametrize("check_every", [1, 8])
@pytest.mark.parametrize("dtype,tol,x_atol", [
    (np.float64, 1e-10, 1e-8), (np.float32, 1e-5, 1e-5)],
    ids=["f64", "f32"])
def test_oracle(dtype, tol, x_atol, check_every):
    # the reference's indefinite 3x3 system: three iterations and the
    # indefiniteness certificate; with check_every=8 the steps past
    # Krylov exhaustion inside the block freeze instead of making NaN
    ja, jb, x_exp = jpoisson.oracle_system(dtype=dtype)
    ta, tb, _ = tpoisson.oracle_system(dtype=dtype, device="cpu")
    kw = dict(method="minres", tol=tol, maxiter=64, check_every=check_every)
    res = pt.solve(ta, tb, **kw)
    jres = jp.solve(ja, jb, **kw)
    _assert_same(res, jres, X_TOL_F64 if dtype == np.float64 else X_TOL_F32)
    assert bool(res.converged) and bool(res.indefinite)
    assert int(res.iterations) == (3 if check_every == 1 else 8)
    assert np.all(np.isfinite(res.x.numpy()))
    np.testing.assert_allclose(res.x.numpy(), x_exp, atol=x_atol)


# -- indefinite systems -------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol,x_tol", [
    (np.float64, 1e-9, X_TOL_F64), (np.float32, 1e-4, X_TOL_F32)],
    ids=["f64", "f32"])
def test_matches_jax_and_scipy_on_indefinite(dtype, rtol, x_tol):
    a, b = _indefinite_system()
    ja, ta = _dense(a, dtype)
    kw = dict(method="minres", tol=0.0, rtol=rtol, maxiter=2000)
    res = pt.solve(ta, torch.as_tensor(b.astype(dtype)), **kw)
    jres = jp.solve(ja, jnp.asarray(b.astype(dtype)), **kw)
    _assert_same(res, jres, x_tol)
    assert bool(res.converged)
    x_sp, info = spla.minres(a, b, rtol=rtol, maxiter=2000)
    assert info == 0
    resid = np.linalg.norm(b - a @ res.x.numpy().astype(np.float64))
    # at least scipy's quality on the TRUE residual (f64), within f32's
    # floor in f32
    floor = 1e-8 if dtype == np.float64 else 1e-5
    assert resid <= max(2 * np.linalg.norm(b - a @ x_sp),
                        floor * np.linalg.norm(b))


def test_monotone_residual():
    a, b = _indefinite_system(seed=7)
    ja, ta = _dense(a)
    kw = dict(method="minres", tol=0.0, rtol=1e-9, maxiter=2000,
              record_history=True)
    res = pt.solve(ta, torch.as_tensor(b), **kw)
    jres = jp.solve(ja, jnp.asarray(b), **kw)
    _assert_same(res, jres, X_TOL_F64)
    h = res.residual_history.numpy()
    jh = np.asarray(jres.residual_history)
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    h = h[np.isfinite(h)]
    np.testing.assert_allclose(h, jh[np.isfinite(jh)], rtol=1e-9)
    assert np.all(np.diff(h) <= 1e-12 + 1e-7 * h[:-1])


def test_cg_vs_minres_on_spd():
    # on an SPD system both converge in about the same count (the same
    # Krylov space, another optimality)
    jop, top = _stencils(16, 16, np.float64)
    b = np.random.default_rng(11).standard_normal(256)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=600)
    r_cg = pt.solve(top, torch.as_tensor(b), **kw)
    r_mr = pt.solve(top, torch.as_tensor(b), method="minres", **kw)
    jr_mr = jp.solve(jop, jnp.asarray(b), method="minres", **kw)
    _assert_same(r_mr, jr_mr, X_TOL_F64)
    assert bool(r_cg.converged) and bool(r_mr.converged)
    assert not bool(r_mr.indefinite)
    assert abs(int(r_mr.iterations) - int(r_cg.iterations)) <= 5


# -- semantics ----------------------------------------------------------------


def test_check_every_overshoots_only():
    a, b = _indefinite_system(seed=5)
    ja, ta = _dense(a)
    kw = dict(method="minres", tol=0.0, rtol=1e-9, maxiter=2000)
    r1 = pt.solve(ta, torch.as_tensor(b), check_every=1, **kw)
    r32 = pt.solve(ta, torch.as_tensor(b), check_every=32, **kw)
    _assert_same(r32, jp.solve(ja, jnp.asarray(b), check_every=32, **kw),
                 X_TOL_F64)
    assert int(r32.iterations) >= int(r1.iterations)
    assert int(r32.iterations) % 32 == 0
    assert bool(r32.converged)


@pytest.mark.parametrize("kw,iterations", [
    (dict(tol=1e-30, maxiter=10), 10),
    (dict(tol=0.0, maxiter=100, iter_cap=17), 17),
    (dict(tol=0.0, maxiter=100, iter_cap=17, check_every=8), 17)],
    ids=["maxiter", "iter_cap", "iter_cap-blocked"])
def test_caps(kw, iterations):
    a, b = _indefinite_system(seed=9)
    ja, ta = _dense(a)
    res = pt.solve(ta, torch.as_tensor(b), method="minres", **kw)
    jres = jp.solve(ja, jnp.asarray(b), method="minres", **kw)
    _assert_same(res, jres, X_TOL_F64)
    assert not bool(res.converged)
    assert res.status_enum() is pt.CGStatus.MAXITER
    assert int(res.iterations) == iterations


def test_x0_warm_start():
    a, b = _indefinite_system(seed=15)
    ja, ta = _dense(a)
    x_sp, _ = spla.minres(a, b, rtol=1e-12, maxiter=2000)
    kw = dict(method="minres", tol=1e-6, maxiter=200)
    warm = pt.solve(ta, torch.as_tensor(b), torch.as_tensor(x_sp), **kw)
    jwarm = jp.solve(ja, jnp.asarray(b), jnp.asarray(x_sp), **kw)
    cold = pt.solve(ta, torch.as_tensor(b), **kw)
    _assert_same(warm, jwarm, X_TOL_F64)
    assert bool(warm.converged)
    assert int(warm.iterations) < int(cold.iterations)


def test_exhaustion_consistent_singular():
    # Krylov exhaustion on a consistent singular system: phibar collapses
    # to 0 and the subspace's least-squares solution is exact
    a = np.diag([1.0, 2.0, 0.0])
    b = np.array([1.0, 2.0, 0.0])
    kw = dict(method="minres", tol=1e-10, maxiter=50)
    res = pt.solve(torch.as_tensor(a), torch.as_tensor(b), **kw)
    jres = jp.solve(jnp.asarray(a), jnp.asarray(b), **kw)
    _assert_same(res, jres, X_TOL_F64)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy()[:2], [1.0, 1.0], atol=1e-10)


def test_history_endpoints():
    a, b = _indefinite_system(seed=17)
    _, ta = _dense(a)
    res = pt.solve(ta, torch.as_tensor(b), method="minres", tol=0.0,
                   rtol=1e-8, maxiter=2000, record_history=True)
    h = res.residual_history.numpy()
    k = int(res.iterations)
    assert h.shape == (2001,)
    assert np.isclose(h[0], np.linalg.norm(b), rtol=1e-10)
    assert np.isclose(h[k], float(res.residual_norm), rtol=1e-10)
    assert np.isnan(h[k + 1:]).all()


def test_cg_entry_dispatches_to_minres():
    # cg(method="minres") is minres(...) with the same arguments
    a, b = _indefinite_system(n=48, n_neg=8, seed=19)
    _, ta = _dense(a)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=500, check_every=4)
    via_cg = pt.cg(ta, torch.as_tensor(b), method="minres", **kw)
    direct = tminres.minres(ta, torch.as_tensor(b), **kw)
    assert int(via_cg.iterations) == int(direct.iterations)
    assert torch.equal(via_cg.x, direct.x)


# the JAX refusals, in the JAX order: the same exception type and words
@pytest.mark.parametrize("entry,kw,match", [
    ("solve", dict(m="jacobi"), "m=None"),
    ("cg", dict(m="jacobi"), "m=None"),
    ("solve", dict(return_checkpoint=True), "checkpoint"),
    ("cg", dict(compensated=True), "compensated"),
    ("solve", dict(flight="stride"), "flight recorder"),
    ("cg", dict(flight="stride", m="jacobi"), "flight recorder"),
    ("solve", dict(engine="resident"), "engine='resident'"),
    ("solve", dict(engine="streaming"), "engine='streaming'"),
], ids=["solve-m", "cg-m", "checkpoint", "compensated", "flight",
        "flight-first", "resident", "streaming"])
def test_refusals(entry, kw, match):
    jop, top = _stencils(16, 128, np.float32)
    if "m" in kw:
        kw = dict(kw, m=None)
        jm = jp.JacobiPreconditioner.from_operator(jop)
        tm = pt.JacobiPreconditioner.from_operator(top)
    else:
        jm = tm = None
    jkw = dict(kw, m=jm) if jm is not None else kw
    tkw = dict(kw, m=tm) if tm is not None else kw
    if "flight" in kw:
        # the JAX recorder's config; the port refuses before reading it
        from cuda_mpi_parallel_tpu.telemetry.flight import FlightConfig
        jkw = dict(jkw, flight=FlightConfig(stride=1))
    with pytest.raises(ValueError, match=match):
        getattr(jp, entry)(jop, jnp.ones(top.n, jnp.float32),
                           method="minres", **jkw)
    with pytest.raises(ValueError, match=match):
        getattr(pt, entry)(top, torch.ones(top.n), method="minres", **tkw)


def test_auto_engine_takes_the_general_loop(monkeypatch):
    # auto on a (pretended) Hopper card: the resident and streaming
    # engines decline minres, so the stencil's own matvec runs - B1 on
    # the card, its twin here - and no fused kernel is launched
    monkeypatch.setattr(tcg, "is_hopper", lambda device: True)
    top = pt.Stencil2D.create(16, 128, backend="pallas", device="cpu")
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(top.n),
                        dtype=torch.float32)
    hk.reset_launches()
    auto = pt.solve(top, b, method="minres", engine="auto", tol=0.0,
                    rtol=1e-5, check_every=32)
    assert sum(hk.LAUNCHES.values()) == 0      # twins only, on the CPU
    general = pt.solve(top, b, method="minres", tol=0.0, rtol=1e-5,
                       check_every=32)
    assert torch.equal(auto.x, general.x)
    assert bool(auto.converged)


# -- the f64 lane -------------------------------------------------------------


@pytest.mark.parametrize("entry", ["minres_df64", "cg_df64"])
@pytest.mark.parametrize("check_every", [1, 8])
def test_df64_oracle(entry, check_every):
    # the JAX count is 3 (check_every=1) and one whole block (8) by the
    # blocked-predicate semantics: the port is held to the JAX call once
    ta, tb, x_exp = tpoisson.oracle_system(device="cpu")
    b = tb.numpy()
    kw = dict(tol=1e-12, maxiter=50, check_every=check_every)
    if entry == "cg_df64":
        res = pt.cg_df64(ta, b, method="minres", **kw)
    else:
        res = tminres.minres_df64(ta, b, **kw)
    assert int(res.iterations) == (3 if check_every == 1 else 8)
    assert res.status_enum() is pt.CGStatus.CONVERGED
    assert bool(res.converged) and bool(res.indefinite)
    np.testing.assert_allclose(res.x(), x_exp, atol=1e-10)
    assert res.x64.dtype == torch.float64
    assert res.x_hi.dtype == torch.float32
    np.testing.assert_array_equal(
        res.x_hi.numpy().astype(np.float64) + res.x_lo.numpy(), res.x())
    if entry == "minres_df64" and check_every == 1:
        ja, jb, _ = jpoisson.oracle_system()
        jres = jminres.minres_df64(ja, b, **kw)
        assert int(jres.iterations) == 3 and bool(jres.indefinite)
        assert int(res.status) == int(jres.status)
        np.testing.assert_allclose(res.x(), jres.x(), atol=1e-12)


def test_df64_reaches_f64_depth_and_matches_jax():
    # rtol 1e-12 on a stencil: far below f32's ~1e-7 floor, with the JAX
    # double-float count, solution and ||r|| trace (the f32 rounding of
    # phibar in both), and the f64 general minres's count
    jop, top = _stencils(16, 16, np.float32)
    b = np.random.default_rng(2).standard_normal(256)
    kw = dict(tol=0.0, rtol=1e-12, maxiter=2000, method="minres")
    rd = pt.cg_df64(top, b, record_history=True, **kw)
    jrd = jp.cg_df64(jop, b, record_history=True, **kw)
    assert bool(rd.converged)
    assert int(rd.iterations) == int(jrd.iterations)
    assert int(rd.status) == int(jrd.status)
    np.testing.assert_allclose(rd.x(), jrd.x(), atol=X_TOL_F64
                               * np.abs(jrd.x()).max())
    h, jh = rd.residual_history.numpy(), np.asarray(jrd.residual_history)
    assert h.dtype == np.float32 and h.shape == jh.shape == (2001,)
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    np.testing.assert_allclose(h[np.isfinite(h)], jh[np.isfinite(jh)],
                               rtol=1e-5)
    ad = tpoisson.poisson_2d_csr(16, 16, device="cpu").to_dense().numpy()
    assert np.linalg.norm(b - ad @ rd.x()) / np.linalg.norm(b) < 1e-11
    rf = pt.solve(tpoisson.poisson_2d_operator(16, 16, dtype=torch.float64,
                                               device="cpu"),
                  torch.as_tensor(b), **kw)
    assert abs(int(rf.iterations) - int(rd.iterations)) <= 2
    assert np.abs(rd.x() - rf.x.numpy()).max() < 1e-10
    assert rd.residual_norm() < 1e-11 * np.linalg.norm(b)


def test_df64_indefinite_on_ell():
    # JAX test_indefinite_df64: a dense indefinite system as ELL (40 rows,
    # where the JAX test has 96: the JAX double-float gather of a full
    # row costs seconds a solve on the CPU)
    a_np, b = _indefinite_system(n=40, n_neg=8, seed=21)
    csr = sp.csr_matrix(a_np)
    jell = jp.CSRMatrix.from_scipy(csr, dtype=np.float64).to_ell()
    tell = pt.CSRMatrix.from_scipy(csr, dtype=np.float64,
                                   device="cpu").to_ell()
    kw = dict(tol=0.0, rtol=1e-10, maxiter=2000, method="minres")
    rd = pt.cg_df64(tell, b, **kw)
    jrd = jp.cg_df64(jell, b, **kw)
    assert bool(rd.converged)
    assert int(rd.iterations) == int(jrd.iterations)
    assert int(rd.status) == int(jrd.status)
    np.testing.assert_allclose(rd.x(), jrd.x(),
                               atol=X_TOL_F64 * np.abs(jrd.x()).max())
    assert np.linalg.norm(b - a_np @ rd.x()) / np.linalg.norm(b) < 1e-8


def test_df64_on_shiftell_b9_twin():
    # cg_df64(method="minres") on the f64 shift-ELL runs B9 on the card;
    # here its twin, which must take the counts of the CSR and ELL
    # products (the ELL lane's JAX parity is the test above)
    a = tpoisson.poisson_2d_csr(24, 24, device="cpu")
    x_true = np.random.default_rng(8).standard_normal(a.n)
    b = a.to_dense().numpy() @ x_true
    kw = dict(tol=0.0, rtol=1e-11, maxiter=3000, method="minres",
              check_every=4)
    hk.reset_launches()
    r_sell = pt.cg_df64(a.to_shiftell_df64(), b, **kw)
    assert sum(hk.LAUNCHES.values()) == 0      # the twin, on the CPU
    r_csr = pt.cg_df64(a, b, **kw)
    r_ell = pt.cg_df64(a.to_ell(), b, **kw)
    assert int(r_sell.iterations) == int(r_csr.iterations) \
        == int(r_ell.iterations)
    assert bool(r_sell.converged)
    np.testing.assert_allclose(r_sell.x(), x_true, atol=1e-8)


@pytest.mark.parametrize("kw,match", [
    (dict(preconditioner="jacobi"), "unpreconditioned"),
    (dict(return_checkpoint=True), "checkpoint"),
], ids=["jacobi", "checkpoint"])
def test_df64_refusals(kw, match):
    jop, top = _stencils(16, 16, np.float32)
    with pytest.raises(ValueError, match=match):
        jp.cg_df64(jop, np.ones(256), method="minres", **kw)
    with pytest.raises(ValueError, match=match):
        pt.cg_df64(top, np.ones(256), method="minres", **kw)


@pytest.mark.parametrize("entry", ["cg_df64", "minres_df64"])
def test_df64_distributed_waits_for_a10(entry):
    # the JAX test_df64_mesh_matches_single_device / test_df64_minres_gating
    # run minres_df64 inside solve_distributed_df64, which the port has
    # not yet (ROADMAP A10)
    _, top = _stencils(16, 16, np.float32)
    fn = pt.cg_df64 if entry == "cg_df64" else tminres.minres_df64
    kw = dict(method="minres") if entry == "cg_df64" else {}
    with pytest.raises(NotImplementedError, match="A10"):
        fn(top, np.ones(256), axis_name="rows", **kw)


# -- the distributed solve ----------------------------------------------------


def test_distributed_matches_single_device_and_jax():
    # 8 shards of a stacked CPU mesh; the dots reduce over the mesh
    jop, top = _stencils(16, 16, np.float64)
    b = np.random.default_rng(1).standard_normal(256)
    kw = dict(method="minres", tol=0.0, rtol=1e-9, maxiter=600)
    single = pt.solve(top, torch.as_tensor(b), **kw)
    dist = tpar.solve_distributed(top, torch.as_tensor(b),
                                  mesh=tpar.make_mesh(8,
                                                      devices=["cpu"] * 8),
                                  **kw)
    jdist = jpar.solve_distributed(jop, jnp.asarray(b),
                                   mesh=jpar.make_mesh(8), **kw)
    assert bool(dist.converged)
    assert int(dist.iterations) == int(single.iterations) \
        == int(jdist.iterations)
    assert int(dist.status) == int(jdist.status)
    np.testing.assert_allclose(dist.x.numpy(), single.x.numpy(), atol=1e-9)
    np.testing.assert_allclose(dist.x.numpy(), np.asarray(jdist.x),
                               atol=1e-9)


def test_distributed_refuses_a_preconditioner():
    jop, top = _stencils(16, 16, np.float64)
    kw = dict(method="minres", preconditioner="jacobi")
    with pytest.raises(ValueError, match="minres"):
        jpar.solve_distributed(jop, jnp.ones(256), mesh=jpar.make_mesh(8),
                               **kw)
    with pytest.raises(ValueError, match="minres"):
        tpar.solve_distributed(top, torch.ones(256, dtype=torch.float64),
                               mesh=tpar.make_mesh(8, devices=["cpu"] * 8),
                               **kw)
