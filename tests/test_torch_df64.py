"""The port's f64 lane against the JAX package's double-float lane.

The JAX package carries f64-class values as ``(hi, lo)`` f32 pairs with
error-free arithmetic (a TPU has no f64); the port computes in native
float64 and keeps the pair only at its surface.  Inputs are
numpy-seeded f64 data, split with the JAX ``split_f64`` where the JAX
side wants pairs.  The JAX kernels run in Pallas interpret mode; the
port's wrappers run their plain twins (the tensors lie on the CPU) -
what B6, B7, B9 and B11 are held against on the card by
``chip_smoke.py``.

Tolerances.  A pair carries about 48 significand bits, float64 53
(``tests/test_df64.py``), so the two agree to about 1e-14 relative per
operation, not bit for bit:

* pair helpers: the JAX bits exactly; a recombined pair within the JAX
  package's own ``2**-47`` relative;
* B6/B7: the JAX package's df64 tolerances (``tests/test_streaming.py``):
  arrays within rtol 1e-12 and atol 1e-13 (times max|y| of O(1) data),
  the sums within 1e-12 relative;
* B9: ``y`` within ``1e-12 * max|y|`` (a row adds up to 64 products,
  each rounded at 2**-48 in df64);
* solvers: equal iteration counts, statuses and flags - the ROADMAP
  parity contract - and ``x()`` within 1e-10 of the JAX solution, the
  bound the JAX package holds its own two df64 engines to on O(1)
  solutions, scaled by max|x| where that is larger (the FEM system's
  solution is about 460);
* the ||r|| traces (the f32 hi word in both) within 1e-5 relative,
  NaN in the same places.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import fem as jfem
from cuda_mpi_parallel_tpu.models import mmio as jmmio
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.ops import df64 as jdf
from cuda_mpi_parallel_tpu.ops.pallas import fused_cg as jfused
from cuda_mpi_parallel_tpu.solver import df64 as jdf64
from cuda_mpi_parallel_tpu.telemetry import flight as jflight
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.ops import df64 as tdf
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.telemetry import flight as tflight
from torch._subclasses.fake_tensor import FakeTensorMode

# the modules (the packages re-export functions under these names)
tdf64 = sys.modules["cuda_mpi_parallel_tpu_torch.solver.df64"]

torch.set_num_threads(1)

GRIDS = [(16, 128), (32, 256), (4, 8, 128), (8, 8, 128)]
FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "skewed_spd_240.mtx")
X_TOL = 1e-10


def ops(grid, scale=1.0):
    """The same f32 stencil in both packages (the port's on the CPU)."""
    if len(grid) == 2:
        return (jpoisson.poisson_2d_operator(*grid, scale=scale,
                                             dtype=np.float32),
                tpoisson.poisson_2d_operator(*grid, scale=scale,
                                             device="cpu"))
    return (jpoisson.poisson_3d_operator(*grid, scale=scale,
                                         dtype=np.float32),
            tpoisson.poisson_3d_operator(*grid, scale=scale, device="cpu"))


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def jpair(a64):
    return tuple(jnp.asarray(v) for v in jdf.split_f64(a64))


def same_solve(tres, jres, x_tol=X_TOL):
    """Equal counts, statuses and flags; x within ``x_tol * max(1,
    max|x|)``."""
    assert int(tres.iterations) == int(jres.iterations)
    assert tres.status_enum() == jres.status_enum()
    assert bool(tres.converged) == bool(jres.converged)
    assert bool(tres.indefinite) == bool(jres.indefinite)
    want = jres.x()
    np.testing.assert_allclose(tres.x(), want, rtol=0,
                               atol=x_tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_intervals():
    """The JAX ``chebyshev_interval`` of each stencil, computed once for
    the module: the resident, general and streaming cases ask for the
    same (grid, scale) more than once."""
    cache = {}

    def interval(jop):
        key = (tuple(jop.grid), float(np.asarray(jop.scale)))
        if key not in cache:
            cache[key] = jdf64.chebyshev_interval(jop)
        return cache[key]
    return interval


@pytest.fixture
def jax_interval(monkeypatch, jax_intervals):
    """Carry the JAX ``chebyshev_interval`` across instead of estimating
    it again (torch and XLA round ``sin`` of large arguments apart, so an
    independent estimate differs in its last bits)."""
    def carry(jop):
        th, dl = jax_intervals(jop)
        pairs = tuple(tuple(torch.as_tensor(np.array(w)) for w in p)
                      for p in (th, dl))
        monkeypatch.setattr(tdf64, "chebyshev_interval",
                            lambda a, **kw: pairs)
    return carry


# -- 1. the pair helpers ----------------------------------------------------


def test_split_and_recombine_match_jax_bits():
    v = vec(1000, 0) * 1e3
    for got, want in zip(tdf.split_f64(v), jdf.split_f64(v)):
        np.testing.assert_array_equal(got, want)
    hi, lo = jdf.split_f64(v)
    np.testing.assert_array_equal(tdf.to_f64(hi, lo), jdf.to_f64(hi, lo))
    th, tl = tdf.f64_to_pair(torch.as_tensor(v))
    np.testing.assert_array_equal(th.numpy(), hi)
    np.testing.assert_array_equal(tl.numpy(), lo)
    c = tdf.const(0.1)
    assert (float(c[0]), float(c[1])) == tuple(
        float(w) for w in jdf.const(0.1))
    assert torch.equal(tdf.from_f32(torch.ones(3))[1], torch.zeros(3))


def test_pair_round_trips_within_jax_precision():
    v = vec(1000, 1) * 1e3
    back = tdf.pair_to_f64(*tdf.f64_to_pair(torch.as_tensor(v))).numpy()
    np.testing.assert_allclose(back, v, rtol=2.0 ** -47)
    # a split of a float64 recombines to the pair's exact value
    np.testing.assert_array_equal(back, jdf.to_f64(*jdf.split_f64(v)))


def test_rhs_coercion_rules():
    v = vec(8, 2)
    hi, lo = jdf.split_f64(v)
    np.testing.assert_array_equal(tdf64._coerce_rhs_df((hi, lo)).numpy(),
                                  jdf.to_f64(hi, lo))
    assert torch.equal(tdf64._coerce_rhs_df(v), torch.as_tensor(v))
    lifted = tdf64._coerce_rhs_df(v.astype(np.float32))
    assert lifted.dtype == torch.float64
    np.testing.assert_array_equal(lifted.numpy(),
                                  v.astype(np.float32).astype(np.float64))
    # the strict pair rule: a 2-tuple of numbers is a length-2 vector
    assert tdf64._coerce_rhs_df((1.0, 2.0)).tolist() == [1.0, 2.0]
    # an f64 word is no pair: the tuple is taken as a (2, 8) array
    assert tuple(tdf64._coerce_rhs_df((hi.astype(np.float64), lo)).shape) \
        == (2, 8)


# -- 2. B6, B7 and B9: the twins against the JAX kernels ----------------------


@pytest.mark.parametrize("shape", GRIDS)
def test_fused_passes_match_the_jax_df64_kernels(shape):
    rng = np.random.default_rng(3)
    r64, p64, x64 = (rng.standard_normal(shape) for _ in range(3))
    scale, beta, alpha = 0.37, 0.45, 0.11
    bm = jfused.pick_block_streaming(shape, itemsize=8)
    jpn, jpap = jfused.fused_cg_pass_a_df64(
        jpair(np.float64(scale)), jpair(np.float64(beta)), jpair(r64),
        jpair(p64), bm=bm, interpret=True)
    jx, jr, jrr = jfused.fused_cg_pass_b_df64(
        jpair(np.float64(scale)), jpair(np.float64(alpha)), jpn, jpair(x64),
        jpair(r64), bm=bm, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in
         (("r", r64), ("p", p64), ("x", x64))}
    pn, pap = hk.fused_cg_pass_a_df64(scale, beta, t["r"], t["p"])
    x, r, rr = hk.fused_cg_pass_b_df64(scale, alpha, pn, t["x"].clone(),
                                       t["r"].clone())
    for got, want in ((pn, jpn), (x, jx), (r, jr)):
        np.testing.assert_allclose(got.numpy(), jdf.to_f64(*want),
                                   rtol=1e-12, atol=1e-13)
    for got, want in ((pap, jpap), (rr, jrr)):
        np.testing.assert_allclose(float(got), float(jdf.to_f64(*want)),
                                   rtol=1e-12)
    # the twins are the f32 passes' twins in the planes' dtype
    assert pn.dtype == torch.float64 and rr.dtype == torch.float64


def _low_word_csr(kind):
    """An f64 JAX CSR whose values have low words (scaled by 1/3)."""
    if kind == "poisson2d":
        a = jpoisson.poisson_2d_csr(24, 40, dtype=np.float64)
    elif kind == "fixture":
        a = jmmio.load_matrix_market(FIXTURE, dtype=np.float64)
    else:
        a = jfem.random_fem_2d(400, seed=3, dtype=np.float64)
    data = np.asarray(a.data, np.float64) / 3.0
    assert np.any(jdf.split_f64(data)[1] != 0)
    return jp.CSRMatrix.from_arrays(jnp.asarray(data), a.indices, a.indptr,
                                    a.shape)


@pytest.mark.parametrize("kind", ["poisson2d", "fixture", "fem"])
def test_shiftell_df64_matvec_matches_the_jax_kernel(kind):
    jcsr = _low_word_csr(kind)
    arrays = {k: np.asarray(getattr(jcsr, k))
              for k in ("data", "indices", "indptr")}
    tm = convert.operator_from_arrays("ShiftELLDF64Matrix", arrays,
                                      {"shape": jcsr.shape}, device="cpu")
    assert isinstance(tm, pt.ShiftELLDF64Matrix)
    jm = jcsr.to_shiftell_df64()
    x = vec(jcsr.shape[0], 4)
    xp = jdf.split_f64(x)
    want = jdf.to_f64(*jm.matvec_df(tuple(jnp.asarray(w) for w in xp)))
    got = tdf.to_f64(*tm.matvec_df(xp))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(tdf.to_f64(*tm.diagonal_df()),
                               jdf.to_f64(*jm.diagonal_df()), rtol=1e-14)


# -- 3. B11: the resident twin against the JAX df64 kernel --------------------


@pytest.mark.parametrize("grid,case", [
    ((16, 128), "cold"), ((16, 128), "warm"), ((16, 128), "cheb2"),
    ((16, 128), "cheb4"), ((4, 8, 128), "cold"), ((4, 8, 128), "warm"),
    ((4, 8, 128), "cheb2"), ((4, 8, 128), "cheb4")])
def test_resident_twin_matches_the_jax_df64_kernel(grid, case, jax_interval):
    jop, top = ops(grid, scale=0.37)
    n = top.n
    b = vec(n, 7)
    kw = dict(tol=0.0, maxiter=16, check_every=8, record_history=True)
    if case == "warm":
        kw["x0"] = vec(n, 8)
    if case.startswith("cheb"):
        jax_interval(jop)
        kw.update(preconditioner="chebyshev", precond_degree=int(case[-1]))
    jres = jp.cg_resident_df64(jop, b, interpret=True, **kw)
    tres = pt.cg_resident_df64(top, b, **kw)
    same_solve(tres, jres)
    tr, jr = tres.residual_history.numpy(), np.asarray(jres.residual_history)
    np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
    np.testing.assert_allclose(tr[~np.isnan(tr)], jr[~np.isnan(jr)],
                               rtol=1e-5)


# -- 4. solver parity ---------------------------------------------------------


def test_oracle_in_three_iterations():
    ja, jb, x_exp = jpoisson.oracle_system(dtype=jnp.float64)
    ta, tb, _ = tpoisson.oracle_system(device="cpu")
    jres = jp.cg_df64(ja, np.asarray(jb))
    tres = pt.cg_df64(ta, tb)
    assert int(tres.iterations) == 3 and bool(tres.indefinite)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    np.testing.assert_allclose(tres.x(), x_exp, rtol=0, atol=1e-12)
    same_solve(tres, jres, x_tol=1e-12)


@pytest.mark.parametrize("grid", [(16, 128), (4, 8, 128)])
@pytest.mark.parametrize("preconditioner", [None, "jacobi", "chebyshev"])
def test_cg_df64_matches_jax(grid, preconditioner, jax_interval):
    jop, top = ops(grid)
    if preconditioner == "chebyshev":
        jax_interval(jop)
    b = vec(top.n, 9)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=600,
              preconditioner=preconditioner)
    tres = pt.cg_df64(top, b, **kw)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    same_solve(tres, jp.cg_df64(jop, b, **kw))


@pytest.mark.parametrize("kind", ["csr", "shiftell", "shiftell_df64"])
def test_cg_df64_on_assembled_matrices_matches_jax(kind):
    """CSR and the f64 shift-ELL on f64 values with low words; the f32
    shift-ELL (lifted, its values exact in f64) on the same values
    rounded to f32."""
    jcsr = _low_word_csr("fem")
    if kind == "shiftell":
        jcsr = jp.CSRMatrix.from_arrays(jcsr.data.astype(jnp.float32),
                                        jcsr.indices, jcsr.indptr,
                                        jcsr.shape)
    csr = convert.operator_from_arrays(
        "CSRMatrix", {k: np.asarray(getattr(jcsr, k))
                      for k in ("data", "indices", "indptr")},
        {"shape": jcsr.shape}, device="cpu")
    top = {"csr": csr, "shiftell": csr.to_shiftell(),
           "shiftell_df64": csr.to_shiftell_df64()}[kind]
    jop = {"csr": jcsr, "shiftell": jcsr.to_shiftell(),
           "shiftell_df64": jcsr.to_shiftell_df64()}[kind]
    b = vec(csr.n, 10)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=800, preconditioner="jacobi")
    same_solve(pt.cg_df64(top, b, **kw), jp.cg_df64(jop, b, **kw))


def test_check_every_iter_cap_and_history():
    jop, top = ops((16, 128))
    b = vec(top.n, 11)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=200, check_every=8, iter_cap=37,
              record_history=True)
    tres, jres = pt.cg_df64(top, b, **kw), jp.cg_df64(jop, b, **kw)
    assert int(tres.iterations) == 37
    assert tres.status_enum() == pt.CGStatus.MAXITER
    same_solve(tres, jres)
    tr, jr = tres.residual_history.numpy(), np.asarray(jres.residual_history)
    assert tr.shape == (201,) and tr.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
    assert np.isnan(tr[38:]).all() and not np.isnan(tr[:38]).any()
    np.testing.assert_allclose(tr[:38], jr[:38], rtol=1e-5)


def test_exact_solve_freezes_without_nan():
    """A = 2 I is solved exactly in one iteration; the rest of the check
    block runs frozen (0/0 -> 0) and injects no NaN."""
    n = 8
    data, idx, ptr = (np.full(n, 2.0), np.arange(n, dtype=np.int32),
                      np.arange(n + 1, dtype=np.int32))
    ja = jp.CSRMatrix.from_arrays(jnp.asarray(data), jnp.asarray(idx),
                                  jnp.asarray(ptr), (n, n))
    ta = pt.CSRMatrix.from_arrays(data, idx, ptr, (n, n), device="cpu")
    kw = dict(tol=0.0, maxiter=16, check_every=4)
    tres = pt.cg_df64(ta, np.ones(n), **kw)
    assert int(tres.iterations) == 4 and float(tres.residual_norm()) == 0.0
    assert np.isfinite(tres.x()).all() and (tres.x() == 0.5).all()
    same_solve(tres, jp.cg_df64(ja, np.ones(n), **kw))


@pytest.mark.parametrize("grid", [(16, 128), (4, 8, 128)])
def test_streaming_df64_matches_jax_general(grid):
    """The JAX package holds its streaming df64 engine to its general one
    (equal counts, x within 1e-10); the port's is held to the same.  Its
    3D interpret-mode solve takes half an hour to compile, so the JAX
    side here is ``cg_df64``, and the JAX streaming engine itself is met
    in 2D below."""
    jop, top = ops(grid, scale=0.37)
    b = vec(top.n, 12)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=600, check_every=1)
    tres = pt.cg_streaming_df64(top, b, **kw)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    assert tres.residual_history is None and tres.x().shape == (top.n,)
    same_solve(tres, jp.cg_df64(jop, b, **kw))


def test_streaming_df64_matches_the_jax_streaming_engine():
    jop, top = ops((16, 128))
    b = vec(top.n, 13)
    kw = dict(tol=0.0, maxiter=24, check_every=8)
    jres = jp.cg_streaming_df64(jop, b, interpret=True, **kw)
    tres = pt.cg_streaming_df64(top, torch.as_tensor(b).reshape(16, 128),
                                **kw)
    same_solve(tres, jres)
    assert np.isclose(tres.residual_norm(), jres.residual_norm(),
                      rtol=1e-9)


@pytest.mark.parametrize("grid", [(16, 128), (4, 8, 128)])
@pytest.mark.parametrize("preconditioner", [None, "chebyshev"])
def test_resident_df64_matches_jax_general(grid, preconditioner,
                                           jax_interval):
    jop, top = ops(grid)
    if preconditioner:
        jax_interval(jop)
    b = vec(top.n, 14)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=600, check_every=1,
              preconditioner=preconditioner)
    tres = pt.cg_resident_df64(top, b, **kw)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    same_solve(tres, jp.cg_df64(jop, b, **kw))


def test_depth_beyond_f32():
    """rtol 1e-12 with the true f64 residual far below f32's floor."""
    _, top = ops((16, 128))
    b = vec(top.n, 15)
    res = pt.cg_df64(top, b, tol=0.0, rtol=1e-12, maxiter=800)
    dense = tpoisson.poisson_2d_csr(16, 128, device="cpu").to_dense().numpy()
    assert np.linalg.norm(b - dense @ res.x()) / np.linalg.norm(b) < 5e-12
    assert abs(res.residual_norm() - float(np.sqrt(
        float(res.residual_norm_sq)))) == 0.0


def test_resume_equals_the_unsplit_solve():
    jop, top = ops((16, 128))
    b = vec(top.n, 16)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=400)
    full = pt.cg_df64(top, b, **kw)
    part = pt.cg_df64(top, b, **dict(kw, maxiter=50), return_checkpoint=True)
    assert int(part.iterations) == 50
    resumed = pt.cg_df64(top, b, resume_from=part.checkpoint, **kw)
    # in the port: bit for bit (the checkpoint keeps the float64 state)
    assert int(resumed.iterations) == int(full.iterations)
    np.testing.assert_array_equal(resumed.x(), full.x())
    # in the JAX package, and across: the JAX checkpoint resumed here
    jfull = jp.cg_df64(jop, b, **kw)
    jpart = jp.cg_df64(jop, b, **dict(kw, maxiter=50),
                       return_checkpoint=True)
    jresumed = jp.cg_df64(jop, b, resume_from=jpart.checkpoint, **kw)
    same_solve(resumed, jfull)
    same_solve(resumed, jresumed)
    carried = convert.df64_checkpoint_from_arrays(
        {f.name: np.asarray(getattr(jpart.checkpoint, f.name))
         for f in dataclasses.fields(jpart.checkpoint)}, device="cpu")
    across = pt.cg_df64(top, b, resume_from=carried, **kw)
    same_solve(across, jfull)


def test_result_surface():
    _, top = ops((16, 128))
    res = pt.cg_df64(top, vec(top.n, 17), tol=0.0, maxiter=10)
    x = res.x()
    assert x.dtype == np.float64 and np.array_equal(x, res.x64.numpy())
    np.testing.assert_array_equal(tdf.to_f64(res.x_hi, res.x_lo),
                                  jdf.to_f64(*jdf.split_f64(x)))
    assert res.x_hi.dtype == torch.float32 and res.iterations.dtype == \
        torch.int32
    assert res.checkpoint is None and res.flight is None


# -- 5. refusals and the surface rules ----------------------------------------


# cg1 and pipecg (ROADMAP A3), minres (A11), the flight recorder (A9),
# the multigrid V-cycle (A8) and axis_name (A10) now run, as they do in
# the JAX cg_df64: error None holds the port's count and status to the
# JAX package's (with flight=, each package gets its own FlightConfig and
# the recorded rows are the JAX ones: the JAX buffer's dtype and shape,
# its f32 hi words within 2^-23; with axis_name, the port's slab of one
# shard inside its mesh scope - its distributed parity is
# tests/test_torch_dist_df64.py)
@pytest.mark.parametrize("kw,error,item", [
    (dict(method="cg1"), None, None),
    (dict(method="pipecg"), None, None),
    (dict(method="minres"), None, None),
    (dict(preconditioner="mg"), None, None),
    (dict(axis_name="x"), None, None),
    (dict(flight="for_solve"), None, None),
    (dict(method="minres", preconditioner="jacobi"), ValueError,
     "unpreconditioned"),
    (dict(method="cg1", preconditioner="chebyshev"), ValueError,
     "requires method='cg'"),
    (dict(preconditioner="ilu"), ValueError, "preconditioner"),
    (dict(precond_degree=0), ValueError, "precond_degree"),
    (dict(method="cg1", iter_cap=3), ValueError, "checkpoint"),
], ids=["cg1", "pipecg", "minres", "mg", "axis_name", "flight",
        "minres-precond", "cg1-cheb", "unknown-precond", "degree",
        "cg1-cap"])
def test_cg_df64_refusals(kw, error, item):
    jop, top = ops((16, 128))
    if error is None:
        jkw = dict(kw)
        if "flight" in kw:
            kw = dict(kw, flight=tflight.FlightConfig.for_solve(2000))
            jkw["flight"] = jflight.FlightConfig.for_solve(2000)
        if "axis_name" in kw:
            jkw = {}
            mesh = tpar.make_mesh(1, axis_name="x", devices=["cpu"])
            local = tpar.DistStencilDF64.create(top.grid, 1, axis_name="x",
                                                device="cpu")
            with tcomm.bind(mesh):
                res = pt.cg_df64(local, np.ones(top.n), **kw)
            assert mesh.comm.counts["psum"] == 2 * int(res.iterations) + 1
        else:
            res = pt.cg_df64(top, np.ones(top.n), **kw)
        jres = jp.cg_df64(jop, np.ones(top.n), **jkw)
        assert int(res.iterations) == int(jres.iterations) > 0
        assert int(res.status) == int(jres.status)
        if "flight" in kw:
            jbuf = np.asarray(jres.flight)
            assert res.flight.dtype == torch.float32 == getattr(
                torch, jbuf.dtype.name)
            assert tuple(res.flight.shape) == jbuf.shape
            rec = tflight.FlightRecord.from_buffer(res.flight)
            jrec = jflight.FlightRecord.from_buffer(np.asarray(jres.flight))
            assert np.array_equal(rec.iterations, jrec.iterations)
            assert rec.iterations[-1] == int(res.iterations)
            np.testing.assert_allclose(rec.residual_sq, jrec.residual_sq,
                                       rtol=2.0 ** -23)
        return
    with pytest.raises(error, match=item):
        pt.cg_df64(top, np.ones(top.n), **kw)


def test_df64_operator_surface():
    csr = tpoisson.poisson_1d_csr(8, device="cpu")
    m = csr.to_shiftell_df64()
    with pytest.raises(TypeError, match="double-float"):
        m.matvec(torch.ones(8, dtype=torch.float64))
    with pytest.raises(TypeError, match="double-float"):
        m @ torch.ones(8, dtype=torch.float64)
    # the f32 solve path refuses it, as the JAX one does
    with pytest.raises(TypeError, match="cg_df64"):
        pt.solve(m, np.ones(8))
    with pytest.raises(TypeError, match="cg_df64"):
        pt.cg(m, np.ones(8))
    assert not pt.supports_streaming_df64(csr)
    assert not pt.supports_resident_df64(csr)
    assert not pt.supports_resident_df64(m)
    with pytest.raises(TypeError, match="Stencil"):
        pt.cg_streaming_df64(csr, np.ones(8))
    with pytest.raises(TypeError, match="Stencil"):
        pt.cg_resident_df64(csr, np.ones(8))
    with pytest.raises(TypeError, match="cg_df64 supports"):
        pt.cg_df64(pt.DenseOperator.create(np.eye(2), device="cpu"),
                   np.ones(2))
    _, top = ops((16, 128))
    with pytest.raises(ValueError, match="chebyshev"):
        pt.cg_resident_df64(top, np.ones(top.n), preconditioner="jacobi")
    with pytest.raises(ValueError, match="grid"):
        pt.cg_resident_df64(top, np.zeros(17))
    with pytest.raises(ValueError, match="rhs shape"):
        pt.cg_df64(top, np.zeros(17))


def test_f64_resident_gates():
    """Five float64 planes within the H100's 50 MiB L2 (seven with the
    Chebyshev): 1024^2 and up to 109^3 fit, 768 x 1024 fits seven and
    1024^2 does not.  The JAX package gates 27 (41) f32 planes on a TPU's
    VMEM, a measurement of its compiler, so the two differ: the JAX gate
    refuses 1024^2 on a 128 MiB part where the port admits it."""
    gate2, gate3 = hk.supports_resident_df64_2d, hk.supports_resident_df64_3d
    dev = "cpu"
    assert gate2(1024, 1024, device=dev)
    assert not gate2(1024, 1024, device=dev, preconditioned=True)
    assert gate2(768, 1024, device=dev, preconditioned=True)
    assert gate3(109, 109, 109, device=dev)
    assert not gate3(110, 110, 110, device=dev)
    assert not gate3(128, 128, 128, device=dev)
    assert gate2(10, 130, device=dev)          # no TPU tiling rule
    top = tpoisson.poisson_2d_operator(1024, 1024, device="cpu")
    assert pt.supports_resident_df64(top)
    assert not pt.supports_resident_df64(top, preconditioned=True)
    assert pt.supports_streaming_df64(
        tpoisson.poisson_3d_operator(3, 5, 7, device="cpu"))
    # the f32 gate keeps refusing 8-byte planes
    assert not hk.supports_resident_2d(16, 128, itemsize=8)


def test_resident_df64_past_the_gate_raises(monkeypatch):
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", "1024")
    _, top = ops((16, 128))
    with pytest.raises(ValueError, match="CMP_RESIDENT_VMEM_BYTES"):
        pt.cg_resident_df64(top, np.ones(top.n))


def _fake(shape):
    with FakeTensorMode():
        return torch.zeros(shape, device="cuda", dtype=torch.float64)


@pytest.mark.parametrize("name", ["fused_cg_pass_a_df64",
                                  "fused_cg_pass_b_df64",
                                  "shift_ell_matvec_df64",
                                  "cg_resident_df64"])
def test_df64_wrappers_refuse_cuda_tensors_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hk.reset_launches()
    g = (8, 8, 128)
    if name == "fused_cg_pass_a_df64":
        call = lambda: hk.fused_cg_pass_a_df64(1.0, 0.0, _fake(g), _fake(g))
    elif name == "fused_cg_pass_b_df64":
        call = lambda: hk.fused_cg_pass_b_df64(1.0, 0.5, _fake(g), _fake(g),
                                               _fake(g))
    elif name == "shift_ell_matvec_df64":
        packed = hk.pack_sliced_ell(np.arange(65), np.arange(64),
                                    np.ones(64), 64)
        call = lambda: hk.shift_ell_matvec(
            _fake((64,)), *(torch.as_tensor(a) for a in packed[:3]), 64)
    else:
        call = lambda: hk.cg_resident_df64_2d(1.0, _fake((16, 128)),
                                              maxiter=4, precond_degree=3,
                                              theta=2.0, delta=1.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert sum(hk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("call,match", [
    (lambda: hk.fused_cg_pass_a_df64(1.0, 0.0, torch.ones(4, 4),
                                     torch.ones(4, 4)), "float64"),
    (lambda: hk.fused_cg_pass_b_df64(
        1.0, 0.0, *(torch.ones(4, 4, dtype=torch.float64)
                    for _ in range(2)), torch.ones(4, 4)), "float64"),
    (lambda: hk.fused_cg_pass_a(1.0, 0.0, *(
        torch.ones(4, 4, dtype=torch.float64) for _ in range(2))),
     "float32"),
    (lambda: hk.cg_resident_df64_2d(1.0, torch.ones(4, 4)), "float64"),
], ids=["pass-a-f32", "pass-b-mixed", "f32-pass-on-f64", "resident-f32"])
def test_wrappers_check_the_dtype(call, match):
    with pytest.raises((TypeError, ValueError), match=match):
        call()
