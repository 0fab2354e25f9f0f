"""The port's preconditioners, FEM generator and preconditioned general
solve against the JAX package's.

Each preconditioner is built once on the JAX side and carried across by
``convert.operator_from_arrays`` (a Chebyshev preconditioner with its
operator and its spectral interval), so both packages apply the same
polynomial or the same inverted blocks; right-hand sides are
numpy-seeded.  The JAX ``backend="pallas"`` stencil runs in interpret
mode; the port runs the kernels' plain twins (the tensors lie on the
CPU).

Tolerances: ``estimate_lmax`` within 1e-4 relative (torch and XLA may
round ``sin`` of large arguments apart, which is why the solves carry
the interval across instead of estimating it twice); a preconditioner
application to f32 rounding (``1e-5 * max|y|``: the sums of a block
product or a stencil run in another order); solves to equal iteration
counts and statuses at equal tolerance, x to reduction-order rounding
(``1e-5 * max|x|`` in f32, ``1e-10`` in f64); the FEM arrays and the
host-side block inverses bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import scipy.sparse as sp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import fem as jfem
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models import precond as jprecond
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch.models import fem as tfem
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.models import precond as tprecond

torch.set_num_threads(1)


def state(obj, csr=None):
    """(kind, arrays, meta) of a JAX operator or preconditioner, as
    ``convert.operator_from_arrays`` takes them.  A shift-ELL matrix is
    carried by ``csr``, the CSR it was packed from."""
    kind = type(obj).__name__
    if kind == "ShiftELLMatrix":
        return kind, {k: np.asarray(getattr(csr, k))
                      for k in ("data", "indices", "indptr")}, \
            {"shape": csr.shape}
    if kind == "ChebyshevPreconditioner":
        a_kind, a_arrays, a_meta = state(obj.a, csr)
        arrays = {".a." + k.lstrip("."): v for k, v in a_arrays.items()}
        arrays.update({".lmin": np.asarray(obj.lmin),
                       ".lmax": np.asarray(obj.lmax)})
        return kind, arrays, {"degree": obj.degree, "a": (a_kind, a_meta)}
    leaves, _ = jax.tree_util.tree_flatten_with_path(obj)
    arrays = {jax.tree_util.keystr(path): np.asarray(leaf)
              for path, leaf in leaves}
    meta = {f: getattr(obj, f) for f in ("grid", "backend", "_dtype_name",
                                         "dim") if hasattr(obj, f)}
    if kind == "CSRMatrix":
        meta["shape"] = obj.shape
    return kind, arrays, meta


def port(obj, csr=None):
    """The port's copy of JAX object ``obj``, on the CPU."""
    return convert.operator_from_arrays(*state(obj, csr), device="cpu")


def rhs(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def dense_spd(n=96, seed=0):
    """A dense SPD matrix with a spread spectrum and a strong diagonal
    that varies, so Jacobi and block-Jacobi both change the iteration."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n)) * 0.1
    a = q @ q.T
    np.fill_diagonal(a, np.diag(a) + rng.uniform(0.5, 20.0, n))
    return a


def jax_operator(kind):
    """(JAX operator, the CSR a shift-ELL was packed from, dtype)."""
    if kind == "stencil":
        return jpoisson.poisson_2d_operator(16, 128, dtype=jnp.float32), \
            None, np.float32
    if kind == "stencil-pallas":
        return jpoisson.poisson_3d_operator(4, 8, 128, dtype=jnp.float32,
                                            backend="pallas"), None, \
            np.float32
    if kind == "csr":
        return jpoisson.poisson_2d_csr(24, 40), None, np.float64
    if kind == "shiftell":
        csr = jpoisson.poisson_3d_csr(6, 8, 10, dtype=np.float32)
        return csr.to_shiftell(), csr, np.float32
    return jp.DenseOperator(a=jnp.asarray(dense_spd())), None, \
        np.float64


def jax_precond(name, jop, csr):
    if name == "jacobi":
        return jp.models.JacobiPreconditioner.from_operator(jop)
    if name.startswith("bj"):
        return jprecond.BlockJacobiPreconditioner.from_operator(
            jop if csr is None else csr, block_size=int(name[2:]))
    # a shift-ELL's interval from its CSR: 31 interpret-mode matvecs saved
    lmax = None if csr is None else float(jprecond.estimate_lmax(csr))
    return jprecond.ChebyshevPreconditioner.from_operator(jop, degree=3,
                                                          lmax=lmax)


# -- estimate_lmax and the preconditioners' application -----------------------


@pytest.mark.parametrize("kind", ["stencil", "csr", "dense"])
def test_estimate_lmax_matches_jax(kind):
    jop, _, _ = jax_operator(kind)
    want = float(jprecond.estimate_lmax(jop))
    got = pt.estimate_lmax(port(jop))
    assert got.ndim == 0 and got.dtype == port(jop).dtype
    assert abs(float(got) - want) <= 1e-4 * abs(want)


def test_estimate_lmax_is_near_the_poisson_spectrum():
    """Within a few per cent of the analytic largest eigenvalue, with the
    1.05 safety factor on top of 30 power iterations."""
    op = tpoisson.poisson_2d_operator(12, 12, dtype=torch.float64,
                                      device="cpu")
    exact = 4.0 + 4.0 * np.cos(np.pi / 13)
    lmax = float(pt.estimate_lmax(op))
    assert 0.97 * exact <= lmax <= 1.05 * exact


@pytest.mark.parametrize("name", ["jacobi", "bj1", "bj3", "bj8", "cheb"])
@pytest.mark.parametrize("kind", ["stencil", "csr", "dense"])
def test_application_matches_jax(kind, name):
    jop, csr, dtype = jax_operator(kind)
    jm = jax_precond(name, jop, csr)
    tm = port(jm, csr)
    x = rhs(jop.n, dtype, seed=1)
    want = np.asarray(jm @ jnp.asarray(x))
    got = (tm @ torch.as_tensor(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bs", [1, 3, 8])
@pytest.mark.parametrize("kind", ["csr", "dense"])
def test_block_jacobi_blocks_equal_jax(kind, bs):
    jop, _, _ = jax_operator(kind)
    want = jprecond.BlockJacobiPreconditioner.from_operator(jop, bs)
    got = tprecond.BlockJacobiPreconditioner.from_operator(port(jop), bs)
    assert got.dim == want.dim and got.block_size == bs
    np.testing.assert_array_equal(got.inv_blocks.numpy(),
                                  np.asarray(want.inv_blocks))
    np.testing.assert_array_equal(got.diagonal().numpy(),
                                  np.asarray(want.diagonal()))


def test_chebyshev_from_operator_arguments():
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    m = pt.ChebyshevPreconditioner.from_operator(op, degree=2, ratio=10.0,
                                                 lmax=8.0)
    assert float(m.lmax) == 8.0 and float(m.lmin) == np.float32(0.8)
    assert m.lmin.ndim == 0 and m.shape == op.shape and m.degree == 2
    with pytest.raises(ValueError, match="degree"):
        pt.ChebyshevPreconditioner.from_operator(op, degree=0)
    with pytest.raises(NameError, match="unbound axis name: x"):
        pt.ChebyshevPreconditioner.from_operator(op, axis_name="x")
    with pytest.raises(NotImplementedError):
        m.diagonal()


def test_degree_one_chebyshev_is_a_scaling():
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    m = pt.ChebyshevPreconditioner.from_operator(op, degree=1, lmin=1.0,
                                                 lmax=3.0)
    r = torch.as_tensor(rhs(op.n, np.float32))
    assert torch.equal(m @ r, r / torch.tensor(2.0))


def test_chebyshev_is_symmetric_positive_definite():
    op = tpoisson.poisson_2d_operator(8, 12, dtype=torch.float64,
                                      device="cpu")
    m = pt.ChebyshevPreconditioner.from_operator(op, degree=4)
    dense = m.to_dense().numpy()
    np.testing.assert_allclose(dense, dense.T, atol=1e-12)
    assert np.linalg.eigvalsh(dense).min() > 0


def test_block_jacobi_size_one_is_jacobi_exactly():
    jop, _, _ = jax_operator("csr")
    a = port(jop)
    b = torch.as_tensor(rhs(a.n, np.float64, seed=2))
    bj = pt.BlockJacobiPreconditioner.from_operator(a, block_size=1)
    jac = pt.JacobiPreconditioner.from_operator(a)
    assert torch.equal(bj.diagonal(), jac.diagonal())
    one = pt.solve(a, b, rtol=1e-8, m=bj)
    two = pt.solve(a, b, rtol=1e-8, m=jac)
    assert int(one.iterations) == int(two.iterations)
    assert torch.equal(one.x, two.x)


def test_block_jacobi_refuses_what_it_cannot_extract():
    with pytest.raises(ValueError, match="block_size"):
        pt.BlockJacobiPreconditioner.from_operator(
            tpoisson.poisson_1d_csr(8, device="cpu"), block_size=0)
    with pytest.raises(ValueError, match="CSRMatrix"):
        pt.BlockJacobiPreconditioner.from_operator(
            tpoisson.poisson_2d_operator(128, 128, device="cpu"))
    with pytest.raises(TypeError):
        tprecond._extract_diag_blocks(np.eye(4), 2)


# -- the preconditioned general solve -----------------------------------------


# block-Jacobi of the 4096-row pallas stencil would be made dense on both
# sides; the xla stencil covers block-Jacobi on a stencil
SOLVES = [(kind, name) for kind in ("stencil", "csr", "shiftell", "dense")
          for name in ("jacobi", "bj1", "bj3", "bj8", "cheb")] \
    + [("stencil-pallas", "jacobi"), ("stencil-pallas", "cheb")]


@pytest.mark.parametrize("kind,name", SOLVES)
def test_preconditioned_cg_matches_jax(kind, name):
    jop, csr, dtype = jax_operator(kind)
    jm = jax_precond(name, jop, csr)
    b = rhs(jop.n, dtype, seed=3)
    rtol = 1e-5 if dtype == np.float32 else 1e-10
    jres = jp.solve(jop, jnp.asarray(b), rtol=rtol, m=jm, check_every=4)
    top, tm = port(jop, csr), port(jm, csr)
    tres = pt.solve(top, torch.as_tensor(b), rtol=rtol, m=tm, check_every=4)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    assert int(tres.status) == int(jres.status)
    assert int(tres.iterations) == int(jres.iterations)
    plain = pt.solve(top, torch.as_tensor(b), rtol=rtol, check_every=4)
    if kind == "dense" or name not in ("jacobi", "bj1"):
        # Poisson's constant diagonal makes (block size 1) Jacobi a mere
        # rescaling; everywhere else m changes the iteration
        assert int(tres.iterations) != int(plain.iterations)
    want = np.asarray(jres.x)
    np.testing.assert_allclose(
        tres.x.numpy(), want, rtol=0,
        atol=(1e-5 if dtype == np.float32 else 1e-10) * np.abs(want).max())


def test_preconditioner_breakdown_matches_jax():
    """An indefinite m gives rho <= 0: both stop with BREAKDOWN."""
    jop, _, _ = jax_operator("csr")
    jm = jp.models.JacobiPreconditioner(
        inv_diag=-1.0 / jop.diagonal())
    b = rhs(jop.n, np.float64, seed=4)
    jres = jp.solve(jop, jnp.asarray(b), rtol=1e-8, m=jm)
    tres = pt.solve(port(jop), torch.as_tensor(b), rtol=1e-8, m=port(jm))
    assert tres.status_enum() == pt.CGStatus.BREAKDOWN
    assert int(tres.status) == int(jres.status)
    assert int(tres.iterations) == int(jres.iterations) == 0


def test_raw_matrix_preconditioner_is_a_dense_operator():
    a = port(jax_operator("dense")[0])
    b = torch.as_tensor(rhs(a.n, np.float64, seed=5))
    inv = torch.diag(1.0 / a.diagonal())
    raw = pt.solve(a, b, rtol=1e-10, m=inv)
    jac = pt.solve(a, b, rtol=1e-10, m=pt.JacobiPreconditioner.from_operator(a))
    assert int(raw.iterations) == int(jac.iterations)
    np.testing.assert_allclose(raw.x.numpy(), jac.x.numpy(), rtol=0,
                               atol=1e-12)


# -- the FEM stand-in and the CSR constructors --------------------------------


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 1000)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_fem_2d_equals_jax_bit_for_bit(seed, n, dtype):
    want = jfem.random_fem_2d(n, seed=seed, dtype=dtype)
    got = tfem.random_fem_2d(n, seed=seed, dtype=dtype, device="cpu")
    assert got.shape == want.shape == (n, n)
    for name in ("data", "indices", "indptr", "rows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.data.dtype == getattr(torch, np.dtype(dtype).name)


def test_random_fem_2d_is_spd_with_fem_sparsity():
    a = tfem.random_fem_2d(400, seed=2, device="cpu")
    dense = a.to_dense().numpy()
    np.testing.assert_array_equal(dense, dense.T)
    assert np.linalg.eigvalsh(dense).min() > 0
    per_row = np.diff(a.indptr.numpy())
    assert 5 <= per_row.mean() <= 9


def test_fem_jacobi_solve_matches_jax():
    ja = jfem.random_fem_2d(2000, seed=0, dtype=np.float32)
    b = rhs(ja.n, np.float32, seed=6)
    jm = jp.models.JacobiPreconditioner.from_operator(ja)
    jres = jp.solve(ja, jnp.asarray(b), rtol=1e-5, m=jm, maxiter=5000)
    a = tfem.random_fem_2d(2000, seed=0, dtype=np.float32, device="cpu")
    tres = pt.solve(a.to_shiftell(), torch.as_tensor(b), rtol=1e-5,
                    m=pt.JacobiPreconditioner.from_operator(a), maxiter=5000)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    assert int(tres.iterations) == int(jres.iterations)


@pytest.mark.parametrize("fmt", ["csr", "coo", "lil"])
def test_from_scipy_round_trips(fmt):
    dense = dense_spd(40, seed=7)
    dense[np.abs(dense) < 0.05] = 0.0
    mat = {"csr": sp.csr_matrix, "coo": sp.coo_matrix,
           "lil": sp.lil_matrix}[fmt](dense)
    got = pt.CSRMatrix.from_scipy(mat, dtype=np.float32, device="cpu")
    want = jp.CSRMatrix.from_scipy(mat, dtype=np.float32)
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  dense.astype(np.float32))


@pytest.mark.parametrize("tol", [0.0, 0.5])
def test_from_dense_round_trips(tol):
    dense = dense_spd(40, seed=8)
    got = pt.CSRMatrix.from_dense(dense, tol=tol, device="cpu")
    want = jp.CSRMatrix.from_dense(dense, tol=tol)
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    kept = np.where(np.abs(dense) > tol, dense, 0.0)
    np.testing.assert_array_equal(got.to_dense().numpy(), kept)


# -- convert ------------------------------------------------------------------


def test_convert_carries_a_chebyshev_over_a_shift_ell_by_its_csr():
    jop, csr, _ = jax_operator("shiftell")
    jm = jprecond.ChebyshevPreconditioner.from_operator(jop, degree=4,
                                                        lmax=12.0)
    tm = port(jm, csr)
    assert isinstance(tm.a, pt.ShiftELLMatrix) and tm.degree == 4
    assert float(tm.lmax) == float(jm.lmax)
    assert float(tm.lmin) == float(jm.lmin)
    assert tm.lmin.ndim == 0 and tm.lmax.ndim == 0
