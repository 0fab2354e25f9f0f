"""The port's assembled-matrix SpMV (B8's twin, sliced ELL) against the
JAX package's shift-ELL kernel in Pallas interpret mode, and the port's
Matrix Market reader against the JAX package's.

The same CSR arrays go to both packages (the port packs its own layout
from them: the TPU sheet layout is not carried over).  On a CPU tensor
``ShiftELLMatrix.matvec`` runs ``shift_ell_matvec_plain`` - what
``csrc/spmv.cu`` is held against, bit for bit, on the card.

Tolerances: the JAX kernel sums a row's entries in sheet order, the port
in CSR order, so ``y`` agrees to f32 rounding (``1e-6 * max|y|`` per
entry, a few ulps of the row's largest term) or to ``1e-13 * max|y|`` in
f64.  Against a sequential CSR-order sum the port's twin is exact.  A CG
solve on either format takes the same number of iterations.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch.models import mmio as tmmio
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops.cuda import spmv as tspmv

torch.set_num_threads(1)

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "skewed_spd_240.mtx")


def random_spd(n=300, seed=0):
    """Symmetric, strictly diagonally dominant, with rows of 1 to 40
    entries (the first 10 rows hold their diagonal only)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(10, n):
        k = int(rng.integers(0, 13))
        js = rng.choice(np.arange(10, n), size=k, replace=False)
        js = js[js != i]
        rows += [i] * len(js)
        cols += list(js)
    a = np.zeros((n, n))
    a[rows, cols] = -rng.uniform(0.1, 1.0, len(rows))
    a = np.minimum(a, a.T)
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)
    return a


def jax_csr(kind, dtype):
    if kind == "poisson2d":
        return jpoisson.poisson_2d_csr(24, 40, dtype=dtype)
    if kind == "poisson3d":
        return jpoisson.poisson_3d_csr(6, 8, 10, dtype=dtype)
    if kind == "random":
        a = random_spd()
        lens = (a != 0).sum(axis=1)
        assert lens.min() == 1 and 20 <= lens.max() <= 40
        return jp.CSRMatrix.from_dense(a.astype(dtype))
    return jmmio.load_matrix_market(FIXTURE, dtype=dtype)


def port_csr(jcsr, device="cpu"):
    arrays = {k: np.asarray(getattr(jcsr, k))
              for k in ("data", "indices", "indptr")}
    return convert.operator_from_arrays("CSRMatrix", arrays,
                                        {"shape": jcsr.shape}, device=device)


KINDS = ["poisson2d", "poisson3d", "random", "fixture"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_matvec_matches_pallas_shift_ell(kind, dtype):
    jcsr = jax_csr(kind, dtype)
    jm = jcsr.to_shiftell()
    tm = port_csr(jcsr).to_shiftell()
    assert isinstance(tm, pt.ShiftELLMatrix)
    assert tm.shape == jm.shape and tm.dtype == getattr(torch, dtype.__name__)
    x = np.random.default_rng(1).standard_normal(jcsr.n).astype(dtype)
    want = np.asarray(jm.matvec(jnp.asarray(x)))
    got = tm.matvec(torch.as_tensor(x)).numpy()
    tol = 1e-6 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(tm.diagonal().numpy(),
                                  np.asarray(jm.diagonal()))


@pytest.mark.parametrize("kind", KINDS)
def test_twin_sums_each_row_in_csr_order(kind):
    """Bit for bit against a sequential f32 sum over each CSR row - the
    order the kernel adds in."""
    jcsr = jax_csr(kind, np.float32)
    data, idx, ptr = (np.asarray(getattr(jcsr, k))
                      for k in ("data", "indices", "indptr"))
    x = np.random.default_rng(2).standard_normal(jcsr.n).astype(np.float32)
    want = np.zeros(jcsr.n, np.float32)
    for i in range(jcsr.n):
        acc = np.float32(0.0)
        for k in range(ptr[i], ptr[i + 1]):
            acc = np.float32(acc + np.float32(data[k] * x[idx[k]]))
        want[i] = acc
    got = port_csr(jcsr).to_shiftell().matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_packer_layout():
    """Slices of 32 rows padded to their own longest row, slot-major;
    padding slots hold column -1 and are skipped (so x = inf there adds
    nothing)."""
    jcsr = jax_csr("random", np.float32)
    ptr = np.asarray(jcsr.indptr)
    packed = tspmv.pack_sliced_ell(ptr, np.asarray(jcsr.indices),
                                   np.asarray(jcsr.data), jcsr.n)
    lens = np.diff(ptr)
    n_slices = -(-jcsr.n // 32)
    padded = np.zeros(n_slices * 32, int)
    padded[:jcsr.n] = lens
    width = padded.reshape(n_slices, 32).max(axis=1)
    np.testing.assert_array_equal(np.diff(packed.slice_ptr), 32 * width)
    assert (packed.cols >= 0).sum() == jcsr.nnz
    assert (packed.vals[packed.cols < 0] == 0).all()
    # slot k of row r sits at slice_ptr[r // 32] + 32 k + r % 32
    r = int(np.argmax(lens))
    slots = packed.slice_ptr[r // 32] + 32 * np.arange(lens[r]) + r % 32
    np.testing.assert_array_equal(packed.cols[slots],
                                  np.asarray(jcsr.indices)[ptr[r]:ptr[r + 1]])
    tm = port_csr(jcsr).to_shiftell()
    x = torch.ones(jcsr.n)
    assert torch.isfinite(tm.matvec(x)).all()
    assert torch.equal(tm.matvec(x), tspmv.shift_ell_matvec_plain(
        x, tm.vals, tm.cols, tm.slice_ptr, jcsr.n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_on_the_fixture_matches_jax(dtype):
    jcsr = jax_csr("fixture", dtype)
    b = np.random.default_rng(3).standard_normal(jcsr.n).astype(dtype)
    rtol = 1e-5 if dtype == np.float32 else 1e-10
    jres = jp.solve(jcsr.to_shiftell(), jnp.asarray(b), rtol=rtol)
    tm = port_csr(jcsr).to_shiftell()
    tres = pt.solve(tm, torch.as_tensor(b), rtol=rtol)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    assert int(tres.iterations) == int(jres.iterations)
    want = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.numpy(), want, rtol=0,
                               atol=(1e-5 if dtype == np.float32 else 1e-10)
                               * np.abs(want).max())
    plain = pt.solve(port_csr(jcsr), torch.as_tensor(b), rtol=rtol)
    assert int(plain.iterations) == int(tres.iterations)


def test_poisson_csr_solve_matches_stencil():
    csr = tpoisson.poisson_2d_csr(16, 24, dtype=np.float32, device="cpu")
    op = tpoisson.poisson_2d_operator(16, 24, device="cpu")
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(
        csr.n).astype(np.float32))
    sell = pt.solve(csr.to_shiftell(), b, rtol=1e-6)
    stencil = pt.solve(op, b, rtol=1e-6)
    assert int(sell.iterations) == int(stencil.iterations)
    assert float((sell.x - stencil.x).abs().max()) \
        <= 1e-5 * float(stencil.x.abs().max())


def test_convert_carries_shift_ell_by_its_csr_arrays():
    jcsr = jax_csr("poisson2d", np.float32)
    arrays = {"." + k: np.asarray(getattr(jcsr, k))
              for k in ("data", "indices", "indptr")}
    tm = convert.operator_from_arrays("ShiftELLMatrix", arrays,
                                      {"shape": jcsr.shape}, device="cpu")
    ref = port_csr(jcsr).to_shiftell()
    for name in ("vals", "cols", "slice_ptr", "diag"):
        assert torch.equal(getattr(tm, name), getattr(ref, name))


# -- Matrix Market ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mmio_load_matches_jax(dtype):
    j = jmmio.load_matrix_market(FIXTURE, dtype=dtype)
    t = tmmio.load_matrix_market(FIXTURE, dtype=dtype, device="cpu")
    assert t.shape == j.shape and t.nnz == j.nnz
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


def test_mmio_round_trip_and_symmetry_check(tmp_path):
    t = tmmio.load_matrix_market(FIXTURE, device="cpu")
    path = str(tmp_path / "copy.mtx")
    tmmio.save_matrix_market(path, t)
    back = tmmio.load_matrix_market(path, device="cpu")
    for name in ("data", "indices", "indptr"):
        assert torch.equal(getattr(back, name), getattr(t, name))
    lower = pt.CSRMatrix.from_arrays(np.array([1.0, 2.0, 1.0]),
                                     np.array([0, 0, 1], np.int32),
                                     np.array([0, 1, 3], np.int32),
                                     device="cpu")
    tmmio.save_matrix_market(path, lower)
    with pytest.raises(ValueError, match="symmetric"):
        tmmio.load_matrix_market(path, device="cpu")
    assert tmmio.load_matrix_market(path, check_symmetric=False,
                                    device="cpu").nnz == 3


def test_float64_runs_on_the_twin():
    """f64 values have a twin on the CPU but no kernel yet (A12)."""
    csr = tpoisson.poisson_1d_csr(40, device="cpu")
    m = csr.to_shiftell()
    assert m.dtype == torch.float64
    x = torch.linspace(0, 1, 40, dtype=torch.float64)
    assert torch.allclose(m.matvec(x), csr.matvec(x), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="float32/float64"):
        tspmv.pack_sliced_ell(np.array([0, 1]), np.array([0]),
                              np.array([1], np.int32), 1)


@pytest.mark.parametrize("name,item", [
    ("to_ell", "A2"), ("to_dia", "A2"), ("to_shiftell_df64", "A12")])
def test_unported_formats_name_their_roadmap_item(name, item):
    csr = tpoisson.poisson_1d_csr(8, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        getattr(csr, name)()


def test_jax_keeps_its_sheet_layout():
    """The JAX operator's own leaves are the TPU sheets - which is why the
    port is fed the CSR arrays instead."""
    jm = jax_csr("poisson2d", np.float32).to_shiftell()
    names = {jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jm)[0]}
    assert {".vals", ".lane_idx", ".chunk_blocks"} <= names
