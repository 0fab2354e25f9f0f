"""The port's ELL/DIA formats, CSR reordering tools and random SPD
generators against the JAX package's.

The JAX ``tests/test_operators.py`` ``TestELL`` and ``TestDIA``, the RCM
cases of ``tests/test_shiftell.py``, the ELL cases of
``tests/test_df64_shiftell.py`` and ``tests/test_cg.py``'s
``random_spd_dense`` cases, carried over as parity tests: the same
numpy-seeded inputs go through both packages (the port's on the CPU,
where the shift-ELL wrapper runs B8's/B9's plain twin).

Tolerances: products within ``1e-12`` relative in float64 (the ELL row
sum and the DIA shifted adds round like the JAX ones, in another order
at most); converted arrays exactly equal; solves with equal iteration
counts and statuses and x within ``1e-9 * max|x|`` (f64).

RCM: the JAX package orders through its native C++ library when it
loads and the port through ``scipy.sparse.csgraph`` (the JAX package's
own fallback), so the two permutations may differ.  The port's must
equal scipy's ``reverse_cuthill_mckee(..., symmetric_mode=True)`` and
the JAX fallback's, its bandwidth must be no larger than the native
one's on the JAX test's matrix, and ``permuted(perm)`` must equal
``P A P^T`` densely.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import fem as jfem
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models import random_spd as jrandom_spd
from cuda_mpi_parallel_tpu.models.operators import DIAMatrix as JDIA
from cuda_mpi_parallel_tpu.ops import spmv as jspmv
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch.models import DIAMatrix, ELLMatrix
from cuda_mpi_parallel_tpu_torch.models import fem as tfem
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.models import random_spd as trandom_spd
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.ops import spmv as tspmv

torch.set_num_threads(1)

X_TOL = 1e-9


def random_csr(n=50, density=0.1):
    """The JAX test's random matrix (its own seed)."""
    m = sp.random(n, n, density=density, random_state=np.random.RandomState(7),
                  format="csr")
    m.sort_indices()
    return m


def both(m, dtype=None):
    """A scipy matrix as CSR in both packages (the port's on the CPU)."""
    return (jp.CSRMatrix.from_scipy(m, dtype=dtype),
            pt.CSRMatrix.from_scipy(m, dtype=dtype, device="cpu"))


def from_jax(ja):
    """A JAX CSR matrix's arrays as the port's CSR matrix."""
    return pt.CSRMatrix.from_arrays(
        np.asarray(ja.data), np.asarray(ja.indices), np.asarray(ja.indptr),
        ja.shape, device="cpu")


def vec(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


# -- ELL ----------------------------------------------------------------------


@pytest.mark.parametrize("width", [None, 12])
def test_ell_matches_jax_and_csr(width):
    jm, tm = both(random_csr())
    je, te = jm.to_ell(width=width), tm.to_ell(width=width)
    assert isinstance(te, ELLMatrix)
    assert te.width == je.width and te.shape == tuple(je.shape)
    assert te.cols.dtype == torch.int32
    # the JAX packing pads with value 0 and column 0, as the port does
    np.testing.assert_array_equal(te.vals.numpy(), np.asarray(je.vals))
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    x = vec(50, 1)
    y = te.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(je @ jnp.asarray(x)),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(y, tm.matvec(torch.as_tensor(x)).numpy(),
                               rtol=1e-12, atol=1e-13)


def test_ell_width_too_small_raises():
    jm, tm = both(random_csr())
    with pytest.raises(ValueError, match="ELL width"):
        jm.to_ell(width=1)
    with pytest.raises(ValueError, match="ELL width"):
        tm.to_ell(width=1)


def test_ell_diagonal():
    m = (random_csr() + sp.eye(50) * 2.0).tocsr()
    jm, tm = both(m)
    d = tm.to_ell().diagonal().numpy()
    np.testing.assert_allclose(d, m.diagonal(), rtol=1e-14)
    np.testing.assert_array_equal(d, np.asarray(jm.to_ell().diagonal()))


def test_ell_matvec_op():
    # ops.spmv.ell_matvec against the JAX op on the same arrays
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((20, 4))
    cols = rng.integers(0, 20, (20, 4)).astype(np.int32)
    x = rng.standard_normal(20)
    np.testing.assert_allclose(
        tspmv.ell_matvec(torch.as_tensor(vals), torch.as_tensor(cols),
                         torch.as_tensor(x)).numpy(),
        np.asarray(jspmv.ell_matvec(jnp.asarray(vals), jnp.asarray(cols),
                                    jnp.asarray(x))), rtol=1e-13)


# -- DIA ----------------------------------------------------------------------


def test_dia_matvec_matches_csr_poisson():
    ja = jpoisson.poisson_2d_csr(12, 12, dtype=np.float64)
    ta = from_jax(ja)
    d, jd = ta.to_dia(), ja.to_dia()
    assert isinstance(d, DIAMatrix)
    assert d.n_diags == jd.n_diags == 5
    assert d.offsets == jd.offsets == (-12, -1, 0, 1, 12)
    np.testing.assert_array_equal(d.bands.numpy(), np.asarray(jd.bands))
    x = vec(144, 2)
    y = d.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(ja @ jnp.asarray(x)),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(y, np.asarray(jd @ jnp.asarray(x)),
                               rtol=1e-13, atol=1e-13)


def test_dia_matvec_matches_scipy_random_banded():
    rng = np.random.default_rng(4)
    n = 60
    diags = [rng.standard_normal(n) for _ in range(5)]
    m = sp.diags(diags, [-7, -1, 0, 1, 7], shape=(n, n), format="csr")
    m.sort_indices()
    jm, tm = both(m)
    d, jd = tm.to_dia(), jm.to_dia()
    x = rng.standard_normal(n)
    y = d.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, m @ x, rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(jd @ jnp.asarray(x)),
                               rtol=1e-13)
    # the op itself on the JAX bands
    np.testing.assert_allclose(
        tspmv.dia_matvec(torch.as_tensor(np.asarray(jd.bands)), jd.offsets,
                         torch.as_tensor(x)).numpy(),
        np.asarray(jspmv.dia_matvec(jd.bands, jd.offsets, jnp.asarray(x))),
        rtol=1e-13)


def test_dia_diagonal():
    ja = jpoisson.poisson_2d_csr(8, 8, dtype=np.float64)
    ta = from_jax(ja)
    np.testing.assert_allclose(ta.to_dia().diagonal().numpy(),
                               ta.diagonal().numpy(), rtol=1e-14)
    # no main diagonal: zeros, as in JAX
    m = sp.diags([np.ones(9)], [1], shape=(10, 10), format="csr")
    jm, tm = both(m)
    np.testing.assert_array_equal(tm.to_dia().diagonal().numpy(),
                                  np.asarray(jm.to_dia().diagonal()))


def test_dia_too_many_diagonals_rejected():
    m = sp.random(80, 80, density=0.3,
                  random_state=np.random.RandomState(9), format="csr")
    m = (m + sp.eye(80)).tocsr()
    m.sort_indices()
    jm, tm = both(m)
    with pytest.raises(ValueError, match="max_diags"):
        jm.to_dia(max_diags=10)
    with pytest.raises(ValueError, match="max_diags"):
        tm.to_dia(max_diags=10)


def test_dia_duplicate_entries_summed():
    kw = dict(data=np.array([1.0, 2.0, 3.0]),
              indices=np.array([0, 0, 1], np.int32),
              indptr=np.array([0, 2, 3], np.int32))
    d = pt.CSRMatrix.from_arrays(**kw, device="cpu").to_dia()
    jd = jp.CSRMatrix.from_arrays(**kw).to_dia()
    np.testing.assert_array_equal(d.bands.numpy(), np.asarray(jd.bands))
    eye = torch.eye(2, dtype=torch.float64)
    np.testing.assert_allclose(d.matvec(eye[:, 0]).numpy(), [3.0, 0.0])
    np.testing.assert_allclose(d.matvec(eye[:, 1]).numpy(), [0.0, 3.0])


def test_solve_with_dia():
    ja = jpoisson.poisson_2d_csr(16, 16, dtype=np.float64)
    ta = from_jax(ja)
    x_true = vec(256, 5)
    b = ja @ jnp.asarray(x_true)
    res = pt.solve(ta.to_dia(), torch.as_tensor(np.asarray(b)), tol=1e-10,
                   maxiter=2000)
    jres = jp.solve(ja.to_dia(), b, tol=1e-10, maxiter=2000)
    assert bool(res.converged)
    assert int(res.iterations) == int(jres.iterations)
    assert int(res.status) == int(jres.status)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-7)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               atol=X_TOL * np.abs(x_true).max())


def test_rcm_then_dia_pipeline():
    """RCM-reorder a scrambled tridiagonal matrix, then DIA-convert the
    banded result."""
    rng = np.random.default_rng(6)
    n = 100
    m = sp.diags([np.ones(n - 1), 4 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    scramble = rng.permutation(n).astype(np.int32)
    jm, tm = both(m)
    ja, ta = jm.permuted(scramble), tm.permuted(scramble)
    np.testing.assert_array_equal(ta.to_dense().numpy(),
                                  np.asarray(ja.to_dense()))
    with pytest.raises(ValueError, match="max_diags"):
        ta.to_dia(max_diags=5)      # scrambled: ~n distinct diagonals
    rcm = ta.rcm_permutation()
    banded = ta.permuted(rcm)
    assert banded.bandwidth() <= ja.permuted(ja.rcm_permutation()).bandwidth()
    d = banded.to_dia(max_diags=5)  # RCM restores a narrow band
    x = torch.as_tensor(rng.standard_normal(n))
    np.testing.assert_allclose(d.matvec(x).numpy(),
                               banded.matvec(x).numpy(), rtol=1e-12)


def test_cg_df64_refuses_dia():
    ja = jpoisson.poisson_2d_csr(8, 8, dtype=np.float64)
    with pytest.raises(TypeError, match="DIAMatrix"):
        jp.cg_df64(ja.to_dia(), np.ones(64))
    with pytest.raises(TypeError, match="DIAMatrix"):
        pt.cg_df64(from_jax(ja).to_dia(), np.ones(64))


# -- RCM and the reordering tools ---------------------------------------------


def _jax_rcm_fallback(ja, monkeypatch):
    """The JAX package's own ordering without its native library: the
    ``scipy.sparse.csgraph`` fallback the port runs."""
    from cuda_mpi_parallel_tpu.native import bindings

    with monkeypatch.context() as mp:
        mp.setattr(bindings, "available", lambda: False)
        perm = ja.rcm_permutation()
        return perm, ja.permuted(perm).bandwidth()


@pytest.mark.parametrize("n_points,seed", [(500, 2), (900, 6)])
def test_rcm_is_scipys(n_points, seed, monkeypatch):
    # the port's ordering is scipy's, and so the JAX package's own when
    # its native library is absent: the same permutation, bandwidth and
    # permuted matrix
    ja = jfem.random_fem_2d(n_points, seed=seed)
    ta = tfem.random_fem_2d(n_points, seed=seed, device="cpu")
    np.testing.assert_array_equal(ta.data.numpy(), np.asarray(ja.data))
    perm = ta.rcm_permutation()
    m = sp.csr_matrix((ta.data.numpy(), ta.indices.numpy(),
                       ta.indptr.numpy()), shape=ta.shape)
    np.testing.assert_array_equal(
        perm, reverse_cuthill_mckee(m, symmetric_mode=True))
    assert perm.dtype == np.int32
    jperm, jbw = _jax_rcm_fallback(ja, monkeypatch)
    np.testing.assert_array_equal(perm, jperm)
    assert ta.bandwidth() == ja.bandwidth()
    bw = ta.permuted(perm).bandwidth()
    assert bw == jbw < ta.bandwidth()


def test_rcm_no_wider_than_jax_native():
    # JAX test_fem_rcm's matrix: the scipy ordering's band is no wider
    # than the JAX native library's.  (Not so on every matrix: on
    # random_fem_2d(500, seed=2) scipy's band is 83 wide and the native
    # one's 81 - the two pick their BFS starts apart; ROADMAP queue C.)
    ja = jfem.random_fem_2d(900, seed=6)
    ta = from_jax(ja)
    bw = ta.permuted(ta.rcm_permutation()).bandwidth()
    assert bw <= ja.permuted(ja.rcm_permutation()).bandwidth()


def test_permuted_is_p_a_pt():
    ja = jfem.random_fem_2d(200, seed=3)
    ta = from_jax(ja)
    perm = np.random.default_rng(7).permutation(200)
    dense = ta.to_dense().numpy()
    p = np.eye(200)[perm]
    got = ta.permuted(perm)
    np.testing.assert_array_equal(got.to_dense().numpy(), p @ dense @ p.T)
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(ja.permuted(perm).to_dense()))
    # the permuted system's solution, scattered back, solves the original
    x_true = vec(200, 8)
    b = dense @ x_true
    res = pt.solve(got, torch.as_tensor(b[perm]), tol=0.0, rtol=1e-12,
                   maxiter=2000)
    x = np.empty(200)
    x[perm] = res.x.numpy()
    np.testing.assert_allclose(x, x_true, atol=1e-8 * np.abs(x_true).max())


@pytest.mark.parametrize("perm,match", [
    (np.arange(5), "shape"), (np.zeros(8, np.int64), "not a permutation")],
    ids=["shape", "repeat"])
def test_permuted_refusals(perm, match):
    ja = jpoisson.poisson_1d_csr(8)
    with pytest.raises(ValueError, match=match):
        ja.permuted(perm)
    with pytest.raises(ValueError, match=match):
        from_jax(ja).permuted(perm)


def test_fem_rcm_shiftell():
    # JAX test_fem_rcm: the RCM-reordered FEM matrix on the shift-ELL
    # operator (B8 on the card, its twin here) gives the CSR product
    ta = tfem.random_fem_2d(900, seed=6, device="cpu")
    ap = ta.permuted(ta.rcm_permutation())
    x = torch.as_tensor(vec(900, 9))
    hk.reset_launches()
    y = ap.to_shiftell().matvec(x)
    assert sum(hk.LAUNCHES.values()) == 0
    np.testing.assert_allclose(y.numpy(), ap.matvec(x).numpy(), rtol=1e-12,
                               atol=1e-12)


def test_cg_fem_jacobi():
    # JAX test_cg_fem_jacobi: Jacobi-PCG on the reordered FEM matrix's
    # shift-ELL form; the JAX solve runs the same permuted matrix (the
    # port's permutation) as CSR
    ja = jfem.random_fem_2d(600, seed=8)
    ta = from_jax(ja)
    perm = ta.rcm_permutation()
    ap, jap = ta.permuted(perm), ja.permuted(perm)
    sell = ap.to_shiftell()
    x_true = vec(600, 10)
    b = ap.matvec(torch.as_tensor(x_true))
    kw = dict(tol=0.0, rtol=1e-9, maxiter=4000)
    res = pt.solve(sell, b, m=pt.JacobiPreconditioner.from_operator(sell),
                   **kw)
    jres = jp.solve(jap, jnp.asarray(b.numpy()),
                    m=jp.JacobiPreconditioner.from_operator(jap), **kw)
    assert bool(res.converged)
    assert int(res.iterations) == int(jres.iterations)
    assert int(res.status) == int(jres.status)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-4)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               atol=X_TOL * np.abs(x_true).max())


# -- the f64 lane on ELL ------------------------------------------------------


def test_df64_ell_reaches_f64_depth():
    # JAX test_df64_shiftell :128: rtol 1e-12 on an assembled matrix, the
    # shift-ELL (B9's twin here) and ELL lanes in step, and the JAX ELL
    # lane's count
    ja = jpoisson.poisson_2d_csr(24, 24, dtype=np.float64)
    ta = from_jax(ja)
    x_true = vec(576, 11)
    b = ta.to_dense().numpy() @ x_true
    kw = dict(tol=0.0, rtol=1e-12, maxiter=5000)
    r_sell = pt.cg_df64(ta.to_shiftell_df64(), b, **kw)
    r_ell = pt.cg_df64(ta.to_ell(), b, **kw)
    jr_ell = jp.cg_df64(ja.to_ell(), b, **kw)
    assert bool(r_sell.converged)
    np.testing.assert_allclose(r_sell.x(), x_true, atol=1e-8)
    assert int(r_sell.iterations) == int(r_ell.iterations) \
        == int(jr_ell.iterations)
    assert int(r_ell.status) == int(jr_ell.status)
    np.testing.assert_allclose(r_ell.x(), jr_ell.x(), atol=1e-10)


def test_df64_ell_exact_solve_freezes_not_nans():
    # JAX test_df64_shiftell :200: A = I solves in one iteration; the
    # check_every overrun freezes instead of making NaN
    n = 64
    rows = np.arange(n, dtype=np.int32)
    a = pt.CSRMatrix.from_coo(rows, rows, np.ones(n), n, dtype=np.float64,
                              device="cpu")
    b = vec(n, 12)
    r = pt.cg_df64(a.to_ell(), b, tol=1e-12, maxiter=100, check_every=8)
    assert bool(r.converged) and int(r.iterations) == 8
    assert np.all(np.isfinite(r.x_hi.numpy()))
    np.testing.assert_allclose(r.x(), b, rtol=1e-14)


def test_df64_ell_history_is_norm_with_nan_fill():
    # JAX test_df64_shiftell :211, held to the JAX call
    ja = jpoisson.poisson_2d_csr(8, 8, dtype=np.float64)
    ta = from_jax(ja)
    x_true = vec(64, 13)
    b = ta.to_dense().numpy() @ x_true
    kw = dict(tol=0.0, rtol=1e-9, maxiter=500, record_history=True,
              preconditioner="jacobi")
    r = pt.cg_df64(ta.to_ell(), b, **kw)
    jr = jp.cg_df64(ja.to_ell(), b, **kw)
    k = int(r.iterations)
    assert k == int(jr.iterations)
    hist = r.residual_history.numpy()
    assert np.all(np.isfinite(hist[: k + 1]))
    assert np.all(np.isnan(hist[k + 1:]))
    np.testing.assert_allclose(hist[k], r.residual_norm(), rtol=1e-5)
    jh = np.asarray(jr.residual_history)
    np.testing.assert_allclose(hist[: k + 1], jh[: k + 1], rtol=1e-5)


def test_df64_ell_warns_on_large_gather():
    # from 200,000 rows the f64 ELL gather warns, naming the B9 route and
    # no speed figure
    n = 200_000
    ell = ELLMatrix(vals=torch.ones(n, 1, dtype=torch.float64),
                    cols=torch.arange(n, dtype=torch.int32)[:, None],
                    shape=(n, n))
    with pytest.warns(UserWarning, match="to_shiftell_df64") as rec:
        r = pt.cg_df64(ell, np.ones(n), tol=1e-10, maxiter=4)
    text = str(rec[0].message)
    assert "B9" in text and " ms" not in text and "x the" not in text
    assert int(r.iterations) == 1 and bool(r.converged)


# -- random SPD generators ----------------------------------------------------


@pytest.mark.parametrize("n,cond,seed", [(64, 50.0, 3), (16, 100.0, 2)])
def test_random_spd_dense_matches_jax(n, cond, seed):
    op = trandom_spd.random_spd_dense(n, cond=cond, seed=seed, device="cpu")
    jop = jrandom_spd.random_spd_dense(n, cond=cond, seed=seed)
    np.testing.assert_array_equal(op.a.numpy(), np.asarray(jop.a))
    assert op.a.dtype == torch.float64
    f32 = trandom_spd.random_spd_dense(n, cond=cond, seed=seed,
                                       dtype=np.float32, device="cpu")
    assert f32.a.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_random_spd_sparse_matches_jax(dtype):
    a = trandom_spd.random_spd_sparse(120, density=0.05, seed=4, dtype=dtype,
                                      device="cpu")
    ja = jrandom_spd.random_spd_sparse(120, density=0.05, seed=4,
                                       dtype=dtype)
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    assert a.shape == tuple(ja.shape)
    res = pt.solve(a, torch.ones(120, dtype=a.dtype), tol=0.0, rtol=1e-5)
    jres = jp.solve(ja, jnp.ones(120, dtype), tol=0.0, rtol=1e-5)
    assert int(res.iterations) == int(jres.iterations)
    assert bool(res.converged)


def test_random_spd_matches_numpy():
    # JAX tests/test_cg.py TestDenseSPD on the port's matrices
    op = trandom_spd.random_spd_dense(64, cond=50.0, seed=3, device="cpu")
    b = vec(64, 0)
    res = pt.solve(op, torch.as_tensor(b), tol=1e-10)
    jres = jp.solve(jrandom_spd.random_spd_dense(64, cond=50.0, seed=3),
                    jnp.asarray(b), tol=1e-10)
    np.testing.assert_allclose(res.x.numpy(),
                               np.linalg.solve(op.a.numpy(), b), rtol=1e-6,
                               atol=1e-8)
    assert bool(res.converged)
    assert int(res.iterations) == int(jres.iterations)


def test_random_spd_nonzero_x0():
    op = trandom_spd.random_spd_dense(32, cond=10.0, seed=9, device="cpu")
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(32))
    x0 = torch.as_tensor(rng.standard_normal(32))
    res = pt.solve(op, b, x0, tol=1e-10)
    np.testing.assert_allclose(op.matvec(res.x).numpy(), b.numpy(),
                               atol=1e-8)


def test_random_spd_exact_start_converges_immediately():
    op = trandom_spd.random_spd_dense(16, seed=2, device="cpu")
    x_true = torch.as_tensor(np.random.default_rng(2).standard_normal(16))
    res = pt.solve(op, op.matvec(x_true), x_true, tol=1e-8)
    assert int(res.iterations) == 0
    assert bool(res.converged)


# -- carried across -----------------------------------------------------------


def _leaves(op):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(op)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def test_convert_ell_and_dia():
    ja = jpoisson.poisson_2d_csr(10, 12, dtype=np.float64)
    x = vec(120, 14)
    je, jd = ja.to_ell(), ja.to_dia()
    te = convert.operator_from_arrays("ELLMatrix", _leaves(je),
                                      {"shape": je.shape}, device="cpu")
    td = convert.operator_from_arrays(
        "DIAMatrix", _leaves(jd), {"offsets": jd.offsets, "shape": jd.shape},
        device="cpu")
    assert isinstance(te, ELLMatrix) and isinstance(td, DIAMatrix)
    assert td.offsets == jd.offsets and isinstance(jd, JDIA)
    for t, j in ((te, je), (td, jd)):
        np.testing.assert_allclose(t.matvec(torch.as_tensor(x)).numpy(),
                                   np.asarray(j @ jnp.asarray(x)),
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_array_equal(t.diagonal().numpy(),
                                      np.asarray(j.diagonal()))
