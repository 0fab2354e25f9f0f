"""The port's single-reduction and pipelined CG methods, compensated dots
and checkpoint/resume against the JAX package.

Inputs are numpy-seeded and handed to both packages; operators are built
on the JAX side and carried across with ``convert.operator_from_arrays``
(preconditioners too).  The JAX resident engine runs its cg1 Pallas
kernel in interpret mode; the port runs the kernel's plain twin
(``cg_resident_cg1_plain``: the tensors lie on the CPU) - the function
the cg1 kernel of ``csrc/resident.cu`` is held against on the card by
``chip_smoke.py``.

Parity contract: equal iteration counts and statuses at equal tolerance;
the ||r|| histories within the JAX package's own variant tolerances
(``tests/test_solver_variants.py``: 1e-6 relative for cg1, 1e-4 for
pipecg, whose recurrence drifts); x within ``1e-5 * max|x|`` (f32) or
1e-10 (f64); ``dot_compensated`` and ``fused_dots_compensated`` bit-equal
to the JAX functions (the same error-free operations in the same order)
and within one ulp of the float64 dot; the plain ``fused_dots`` bit-equal
to the port's own ``dot`` and within f32 summation error of the JAX one.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models import precond as jprecond
from cuda_mpi_parallel_tpu.ops import blas1 as jblas1
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops import blas1 as tblas1
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident as trk
from cuda_mpi_parallel_tpu_torch.solver import resident as tresident

# the module (the package re-exports its function ``cg`` under that name)
tcg = sys.modules["cuda_mpi_parallel_tpu_torch.solver.cg"]

torch.set_num_threads(1)

VARIANTS = ["cg1", "pipecg"]


def state(obj):
    """(kind, arrays, meta) of a JAX operator or preconditioner, as
    ``convert.operator_from_arrays`` takes them."""
    kind = type(obj).__name__
    if kind == "ChebyshevPreconditioner":
        a_kind, a_arrays, a_meta = state(obj.a)
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


def port(obj):
    """The port's copy of JAX object ``obj``, on the CPU."""
    return convert.operator_from_arrays(*state(obj), device="cpu")


def vec(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def poisson16():
    jop = jpoisson.poisson_2d_operator(16, 16, dtype=jnp.float64)
    return jop, port(jop)


def assert_same(tres, jres, x_tol):
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.status) == int(jres.status)
    assert bool(tres.converged) == bool(jres.converged)
    assert bool(tres.indefinite) == bool(jres.indefinite)
    want = np.asarray(jres.x)
    got = tres.x.numpy().reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=x_tol * (np.abs(want).max() or 1.0))


# -- the general engine ---------------------------------------------------------


@pytest.mark.parametrize("method", VARIANTS)
def test_oracle_three_iterations_indefinite(method):
    ja, jb, x_exp = jpoisson.oracle_system()
    a, b, _ = tpoisson.oracle_system(device="cpu")
    res = pt.solve(a, b, method=method)
    jres = jp.solve(ja, jb, method=method)
    assert int(res.iterations) == int(jres.iterations) == 3
    assert bool(res.indefinite) and bool(jres.indefinite)
    assert res.status_enum() == pt.CGStatus.CONVERGED
    np.testing.assert_allclose(res.x.numpy(), x_exp, rtol=0, atol=1e-9)


@pytest.mark.parametrize("method,rtol", [("cg1", 1e-6), ("pipecg", 1e-4)])
def test_f64_poisson_trajectory_matches_jax(method, rtol):
    jop, top = poisson16()
    b = vec(256, 12)
    kw = dict(tol=1e-10, record_history=True, method=method)
    res = pt.solve(top, torch.as_tensor(b), **kw)
    jres = jp.solve(jop, jnp.asarray(b), **kw)
    assert_same(res, jres, 1e-10)
    k = int(res.iterations)
    h, jh = res.residual_history.numpy(), np.asarray(jres.residual_history)
    np.testing.assert_allclose(h[:k + 1], jh[:k + 1], rtol=rtol,
                               atol=1e-12 * jh[0])
    assert np.isnan(h[k + 1:]).all() and np.isnan(jh[k + 1:]).all()


def _preconditioner(kind, jop):
    if kind == "jacobi":
        return jp.JacobiPreconditioner.from_operator(jop)
    if kind == "block_jacobi":
        return jprecond.BlockJacobiPreconditioner.from_operator(
            jop, block_size=4)
    return jprecond.ChebyshevPreconditioner.from_operator(jop, degree=3)


@pytest.mark.parametrize("method", VARIANTS)
@pytest.mark.parametrize("kind", ["jacobi", "block_jacobi", "chebyshev"])
def test_preconditioned_variants_match_jax(kind, method):
    jop, top = poisson16()
    jm = _preconditioner(kind, jop)
    b = vec(256, 13)
    kw = dict(tol=0.0, rtol=1e-9, method=method)
    res = pt.solve(top, torch.as_tensor(b), m=port(jm), **kw)
    jres = jp.solve(jop, jnp.asarray(b), m=jm, **kw)
    assert_same(res, jres, 1e-8)
    assert res.status_enum() == pt.CGStatus.CONVERGED


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_non_spd_preconditioner_reports_breakdown(method):
    jop, top = jpoisson.poisson_2d_operator(4, 4, dtype=jnp.float64), None
    top = port(jop)
    m = pt.JacobiPreconditioner(inv_diag=torch.zeros(16, dtype=torch.float64))
    res = pt.solve(top, torch.ones(16, dtype=torch.float64), m=m,
                   maxiter=500, method=method)
    jres = jp.solve(jop, jnp.ones(16), maxiter=500, method=method,
                    m=jp.JacobiPreconditioner(inv_diag=jnp.zeros(16)))
    assert res.status_enum() == pt.CGStatus.BREAKDOWN
    assert int(res.status) == int(jres.status)
    assert int(res.iterations) == int(jres.iterations) <= 1


def test_f32_pipecg_with_replacement_matches_jax():
    """The JAX package's replacement-stability case: 128^2 f32 to rtol
    1e-5 - the cadence-16 replacement must hold the true residual."""
    jop = jpoisson.poisson_2d_operator(128, 128, dtype=jnp.float32)
    top = port(jop)
    x_true = vec(128 * 128, 16, np.float32)
    jb = jop @ jnp.asarray(x_true)
    b = np.array(jb)
    kw = dict(tol=0.0, rtol=1e-5, maxiter=2000, method="pipecg")
    res = pt.solve(top, torch.as_tensor(b), **kw)
    jres = jp.solve(jop, jb, **kw)
    assert int(res.iterations) == int(jres.iterations)
    assert res.status_enum() == pt.CGStatus.CONVERGED
    b64 = torch.as_tensor(b).double()
    true_r = float((b64 - top.matvec(res.x).double()).norm())
    assert true_r <= 2e-5 * float(b64.norm())


@pytest.mark.parametrize("method", VARIANTS)
@pytest.mark.parametrize("k", [3, 8])
def test_check_every_semantics(method, k):
    """Blocks of k: the count lands on a block edge at or past the
    per-iteration count, as the JAX blocked loop's does, and the history
    up to the per-iteration stop is the same trajectory."""
    jop, top = poisson16()
    b = vec(256, 14)
    kw = dict(tol=1e-9, method=method, record_history=True)
    base = pt.solve(top, torch.as_tensor(b), **kw)
    var = pt.solve(top, torch.as_tensor(b), check_every=k, **kw)
    jvar = jp.solve(jop, jnp.asarray(b), check_every=k, **kw)
    kb, kv = int(base.iterations), int(var.iterations)
    assert kv == int(jvar.iterations)
    assert kb <= kv <= kb + k - 1 and kv % k == 0
    np.testing.assert_array_equal(var.residual_history.numpy()[:kb + 1],
                                  base.residual_history.numpy()[:kb + 1])


@pytest.mark.parametrize("method", VARIANTS)
def test_iter_cap_is_never_overshot(method):
    _, top = poisson16()
    res = pt.solve(top, torch.as_tensor(vec(256, 15)), tol=0.0,
                   maxiter=40, iter_cap=10, check_every=4, method=method)
    assert int(res.iterations) == 10
    assert res.status_enum() == pt.CGStatus.MAXITER


class _Counting(pt.LinearOperator):
    """An operator that counts its products (the kernel launches an
    operator on the card makes)."""

    def __init__(self, a):
        self.a, self.calls = a, 0

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x):
        self.calls += 1
        return self.a.matvec(x)


@pytest.mark.parametrize("method,dtype", [
    ("cg1", torch.float32), ("pipecg", torch.float32),
    ("pipecg", torch.float64)])
def test_matvecs_per_solve(method, dtype):
    """What chip_smoke.py counts in kernel launches: cg1 one product per
    iteration and one at init; pipecg one per iteration, two at init and
    four per residual replacement (every 16 iterations in f32, 512 in
    f64)."""
    top = tpoisson.poisson_2d_operator(32, 32, dtype=dtype, device="cpu")
    a = _Counting(top)
    res = pt.solve(a, torch.as_tensor(vec(1024, 17)).to(dtype), tol=0.0,
                   maxiter=80, method=method, check_every=8)
    k = int(res.iterations)
    assert k == 80
    cadence = 16 if dtype == torch.float32 else 512
    assert a.calls == (1 + k if method == "cg1"
                       else 2 + k + 4 * (k // cadence))


# -- compensated dots -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_compensated_dots_equal_jax_bits(n):
    rng = np.random.default_rng(n)
    x, y = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    tx, ty, jx, jy = (torch.as_tensor(x), torch.as_tensor(y),
                      jnp.asarray(x), jnp.asarray(y))
    got = tblas1.dot_compensated(tx, ty)
    assert got.numpy() == np.asarray(jblas1.dot_compensated(jx, jy))
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    assert abs(float(got) - exact) <= np.spacing(np.float32(abs(exact)))
    fused = tblas1.fused_dots_compensated([(tx, ty), (tx, tx)])
    jfused = jblas1.fused_dots_compensated([(jx, jy), (jx, jx)])
    assert [float(v) for v in fused] == [float(v) for v in jfused]
    plain = tblas1.fused_dots([(tx, ty), (tx, tx)])
    assert torch.equal(plain, torch.stack([tblas1.dot(tx, ty),
                                           tblas1.dot(tx, tx)]))
    jplain = np.asarray(jblas1.fused_dots([(jx, jy), (jx, jx)]))
    bound = 2 * n * np.finfo(np.float32).eps * np.array(
        [np.abs(x * y).sum(), (x * x).sum()])
    assert (np.abs(plain.numpy() - jplain) <= bound).all()


def test_distributed_dots_name_their_item():
    """The dots take ``axis_name`` (ROADMAP A10 is ported): outside a
    mesh scope the axis is unbound and they raise the JAX package's
    NameError; inside a scope they reduce over the mesh."""
    from cuda_mpi_parallel_tpu_torch.parallel import comm, make_mesh

    v = torch.ones(4)
    with pytest.raises(NameError, match="unbound axis name: x"):
        tblas1.fused_dots([(v, v)], axis_name="x")
    with pytest.raises(NameError, match="unbound axis name: x"):
        tblas1.dot_compensated(v, v, axis_name="x")
    mesh = make_mesh(2, "x", devices=["cpu"] * 2)
    with comm.bind(mesh):
        assert float(tblas1.fused_dots([(v, v)], axis_name="x")[0]) == 4.0
        assert float(tblas1.dot_compensated(v, v, axis_name="x")) == 4.0


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_compensated_solves_match_jax(method):
    jop = jpoisson.poisson_2d_operator(16, 128, dtype=jnp.float32)
    top = port(jop)
    b = vec(jop.n, 18, np.float32)
    kw = dict(tol=0.0, rtol=1e-5, method=method, compensated=True)
    res = pt.solve(top, torch.as_tensor(b), **kw)
    jres = jp.solve(jop, jnp.asarray(b), **kw)
    assert_same(res, jres, 1e-5)


# -- checkpoint/resume -------------------------------------------------------------


@pytest.mark.parametrize("check_every", [1, 4])
def test_resume_is_bit_equal_to_the_unsplit_solve(check_every):
    _, top = poisson16()
    b = torch.as_tensor(vec(256, 19))
    kw = dict(tol=1e-10, check_every=check_every, record_history=True)
    full = pt.solve(top, b, **kw)
    n = int(full.iterations)
    part = pt.solve(top, b, iter_cap=n // 2, return_checkpoint=True, **kw)
    ck = part.checkpoint
    assert isinstance(ck, pt.CGCheckpoint) and int(ck.k) == n // 2
    assert part.status_enum() == pt.CGStatus.MAXITER
    rest = pt.solve(top, b, resume_from=ck, **kw)
    assert int(rest.iterations) == n
    assert torch.equal(rest.x, full.x)
    hist = rest.residual_history.numpy()
    assert np.isnan(hist[:n // 2]).all()
    np.testing.assert_array_equal(hist[n // 2:n + 1],
                                  full.residual_history.numpy()[n // 2:n + 1])


def test_jax_checkpoint_resumes_in_the_port():
    jop, top = poisson16()
    b = vec(256, 20)
    kw = dict(tol=1e-10)
    jfull = jp.solve(jop, jnp.asarray(b), **kw)
    n = int(jfull.iterations)
    jpart = jp.solve(jop, jnp.asarray(b), iter_cap=n // 2,
                     return_checkpoint=True, **kw)
    carried = convert.checkpoint_from_arrays(
        {f: np.asarray(getattr(jpart.checkpoint, f))
         for f in ("x", "r", "p", "rho", "rr", "nrm0", "k", "indefinite")},
        device="cpu")
    res = pt.solve(top, torch.as_tensor(b), resume_from=carried, **kw)
    assert int(res.iterations) == n
    assert res.status_enum() == pt.CGStatus.CONVERGED
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jfull.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jfull.x)).max())


@pytest.mark.parametrize("kwargs,match", [
    (dict(method="cg1", return_checkpoint=True), "method='cg'"),
    (dict(method="pipecg", resume_from=True), "method='cg'"),
    (dict(x0=np.zeros(256), resume_from=True), "either x0 or resume_from"),
])
def test_checkpoint_refusals_match_jax(kwargs, match):
    """``resume_from=True`` stands for a checkpoint of each package's own
    partial solve."""
    jop, top = poisson16()
    b, jb = torch.ones(256, dtype=torch.float64), jnp.ones(256)
    tkw, jkw = dict(kwargs), dict(kwargs)
    if kwargs.get("resume_from"):
        tkw["resume_from"] = pt.solve(top, b, iter_cap=2,
                                      return_checkpoint=True).checkpoint
        jkw["resume_from"] = jp.solve(jop, jb, iter_cap=2,
                                      return_checkpoint=True).checkpoint
    with pytest.raises(ValueError, match=match):
        pt.solve(top, b, **tkw)
    with pytest.raises(ValueError, match=match):
        jp.solve(jop, jb, **jkw)


# -- the f64 lane --------------------------------------------------------------------


def _df64_operator(kind):
    if kind in ("stencil2d", "stencil3d"):
        jop = (jpoisson.poisson_2d_operator(16, 128, dtype=np.float32)
               if kind == "stencil2d"
               else jpoisson.poisson_3d_operator(4, 8, 128, dtype=np.float32))
        return jop, port(jop)
    jcsr = jpoisson.poisson_2d_csr(24, 24)
    csr = port(jcsr)
    if kind == "csr":
        return jcsr, csr
    return jcsr.to_shiftell_df64(), csr.to_shiftell_df64()


# every method and preconditioner on CSR and the 2D stencil; the JAX
# package compiles its 3D stencil and its interpret-mode shift-ELL kernel
# inside the solve loop for seconds a case, so those take two cases each
@pytest.mark.parametrize("kind,preconditioner,method", [
    (kind, pc, method) for kind in ("stencil2d", "csr")
    for pc in (None, "jacobi") for method in VARIANTS] + [
    ("stencil3d", None, "pipecg"), ("stencil3d", "jacobi", "cg1"),
    ("shiftell_df64", None, "cg1"), ("shiftell_df64", "jacobi", "pipecg")])
def test_cg_df64_variants_match_jax(kind, preconditioner, method):
    jop, top = _df64_operator(kind)
    b = vec(top.shape[0], 21)
    kw = dict(tol=0.0, rtol=1e-10, preconditioner=preconditioner,
              method=method)
    res = pt.cg_df64(top, b, **kw)
    jres = jp.cg_df64(jop, b, **kw)
    assert int(res.iterations) == int(jres.iterations)
    assert int(res.status) == int(jres.status) == int(pt.CGStatus.CONVERGED)
    assert bool(res.indefinite) == bool(jres.indefinite)
    np.testing.assert_allclose(res.x(), jres.x(), rtol=0,
                               atol=1e-10 * max(1.0, np.abs(jres.x()).max()))


@pytest.mark.parametrize("method", VARIANTS)
def test_cg_df64_variant_oracle_and_history(method):
    ja, jb, x_exp = jpoisson.oracle_system(dtype=jnp.float64)
    a, _, _ = tpoisson.oracle_system(device="cpu")
    res = pt.cg_df64(a, np.array(jb), method=method, record_history=True)
    jres = jp.cg_df64(ja, np.asarray(jb), method=method, record_history=True)
    assert int(res.iterations) == int(jres.iterations) == 3
    assert bool(res.indefinite) and bool(jres.indefinite)
    np.testing.assert_allclose(res.x(), x_exp, rtol=0, atol=1e-12)
    # the last entry is rounding (~1e-14), where pairs and float64 part
    jh = np.asarray(jres.residual_history)[:4]
    np.testing.assert_allclose(res.residual_history.numpy()[:4], jh,
                               rtol=1e-5, atol=1e-12 * jh[0])


# -- the resident cg1 kernel's twin -----------------------------------------------------


def _grid_ops(grid, scale=1.0):
    make = ((jpoisson.poisson_2d_operator, tpoisson.poisson_2d_operator)
            if len(grid) == 2 else
            (jpoisson.poisson_3d_operator, tpoisson.poisson_3d_operator))
    return (make[0](*grid, scale=scale, dtype=np.float32),
            make[1](*grid, scale=scale, device="cpu"))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("grid", [(16, 128), (4, 8, 128)])
def test_resident_cg1_twin_matches_the_jax_kernel(grid, warm):
    jop, top = _grid_ops(grid)
    n = int(np.prod(grid))
    b = vec(n, 22, np.float32)
    x0 = vec(n, 23, np.float32) if warm else None
    kw = dict(tol=0.0, rtol=1e-5, maxiter=300, check_every=8, method="cg1",
              record_history=True)
    res = pt.cg_resident(top, torch.as_tensor(b),
                         None if x0 is None else torch.as_tensor(x0), **kw)
    jres = jp.cg_resident(jop, jnp.asarray(b),
                          None if x0 is None else jnp.asarray(x0),
                          interpret=True, **kw)
    assert_same(res, jres, 1e-5)
    h, jh = res.residual_history.numpy(), np.asarray(jres.residual_history)
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    np.testing.assert_allclose(h[~np.isnan(h)], jh[~np.isnan(jh)],
                               rtol=1e-5)


def test_resident_cg1_breakdown_parity():
    """scale 0: w0 = 0, so alpha0 = rr0 / 0 is not finite and both stop
    before the first block (the JAX package's test_breakdown_parity)."""
    jop, top = _grid_ops((8, 128), scale=0.0)
    b = vec(8 * 128, 7, np.float32)
    kw = dict(tol=1e-7, maxiter=64, check_every=4, method="cg1")
    res = pt.cg_resident(top, torch.as_tensor(b).reshape(8, 128), **kw)
    jres = jp.cg_resident(jop, jnp.asarray(b).reshape(8, 128),
                          interpret=True, **kw)
    assert res.status_enum() == pt.CGStatus.BREAKDOWN
    assert int(res.status) == int(jres.status)
    assert int(res.iterations) == int(jres.iterations) == 0
    assert torch.equal(res.x, torch.zeros(8, 128))


def test_resident_cg1_twin_runs_the_kernels_recurrence():
    """The raw wrapper on a CPU tensor: the twin's outputs (flags, trace
    with -1 in blocks that never ran) and no launch counted."""
    hk.reset_launches()
    b = torch.as_tensor(vec(16 * 128, 24, np.float32)).reshape(16, 128)
    x, iters, rr, indef, conv, health, hist = hk.cg_resident_2d(
        1.0, b, rtol=1e-4, maxiter=200, check_every=16, method="cg1")
    k = int(iters)
    assert k % 16 == 0 and int(conv) == 1 and int(health) == 1
    ran = k // 16
    assert (hist[1:ran + 1] >= 0).all() and (hist[ran + 1:] == -1).all()
    assert float(hist[ran]) == float(rr)
    assert sum(hk.LAUNCHES.values()) == 0


# -- the gate and the routing --------------------------------------------------------


def test_resident_eligibility_for_cg1():
    jop, top = _grid_ops((16, 128))
    cheb = pt.ChebyshevPreconditioner.from_operator(top, degree=3)
    assert tresident.resident_eligible(top, method="cg1")
    assert not tresident.resident_eligible(top, m=cheb, method="cg1")
    assert not tresident.resident_eligible(top, method="pipecg")
    jcheb = jprecond.ChebyshevPreconditioner.from_operator(jop, degree=3)
    from cuda_mpi_parallel_tpu.solver.resident import \
        resident_eligible as jeligible
    assert jeligible(jop, method="cg1")
    assert not jeligible(jop, m=jcheb, method="cg1")
    assert not jeligible(jop, method="pipecg")


@pytest.mark.parametrize("grid,fits", [
    ((1024, 1024), True), ((128, 128, 128), True), ((136, 136, 136), False),
    ((1536, 1536), False)])
def test_six_plane_gate(grid, fits):
    """6 planes x cells x 4 bytes <= the 50 MiB L2 of a CPU device: 128^3
    (48 MiB) fits, 136^3 (which the five planes of method='cg' admit)
    does not."""
    check = (trk.supports_resident_2d if len(grid) == 2
             else trk.supports_resident_3d)
    assert check(*grid, cg1=True) == fits
    assert fits == (6 * int(np.prod(grid)) * 4 <= 50 * 2 ** 20)
    if grid == (136, 136, 136):
        assert check(*grid)
    op = (pt.Stencil2D if len(grid) == 2 else pt.Stencil3D).create(
        *grid, device="cpu")
    assert tresident.supports_resident(op, cg1=True) == fits


def test_explicit_cg1_past_the_gate_raises(monkeypatch):
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", str(6 * 16 * 128 * 4 - 1))
    _, top = _grid_ops((16, 128))
    b = torch.ones(top.n)
    assert pt.supports_resident(top) and not pt.supports_resident(top,
                                                                  cg1=True)
    with pytest.raises(ValueError, match="6 \\* grid bytes"):
        pt.cg_resident(top, b, method="cg1")
    with pytest.raises(ValueError, match="engine='resident'"):
        pt.solve(top, b, engine="resident", method="cg1")


@pytest.mark.parametrize("call,error,match", [
    (lambda op, b, m: pt.cg_resident(op, b, m=m, method="cg1"), ValueError,
     "cg1"),
    (lambda op, b, m: pt.cg_resident(op, b, method="pipecg"), ValueError,
     "method"),
    (lambda op, b, m: pt.solve(op, b, engine="streaming", method="cg1"),
     ValueError, "engine='streaming'"),
    (lambda op, b, m: pt.solve(op, b, engine="resident", method="pipecg"),
     ValueError, "engine='resident'"),
], ids=["cg1-cheb", "pipecg", "streaming-cg1", "resident-pipecg"])
def test_variant_refusals(call, error, match):
    _, top = _grid_ops((16, 128))
    m = pt.ChebyshevPreconditioner.from_operator(top, degree=3)
    with pytest.raises(error, match=match):
        call(top, torch.ones(top.n), m)


@pytest.mark.parametrize("method,kwargs,engine", [
    ("cg1", {}, "resident"),
    ("cg1", {"m": "jacobi"}, "general"),
    ("cg1", {"record_history": True}, "general"),
    ("pipecg", {}, "general"),
])
def test_auto_routing_of_the_variants(monkeypatch, method, kwargs, engine):
    """On a Hopper card (``is_hopper`` monkeypatched), auto takes the
    resident cg1 kernel for an unpreconditioned cg1 solve that fits, and
    the general engine otherwise."""
    monkeypatch.setattr(tcg, "is_hopper", lambda device: True)
    _, top = _grid_ops((16, 128))
    if kwargs.get("m") == "jacobi":
        kwargs = dict(kwargs, m=pt.JacobiPreconditioner.from_operator(top))
    taken = []
    monkeypatch.setattr(
        tresident, "cg_resident",
        lambda *a, **k: taken.append("resident") or pt.cg_resident(*a, **k))
    b = torch.as_tensor(vec(top.n, 25, np.float32))
    res = pt.solve(top, b, rtol=1e-5, engine="auto", method=method, **kwargs)
    assert res.status_enum() == pt.CGStatus.CONVERGED
    assert taken == (["resident"] if engine == "resident" else [])
