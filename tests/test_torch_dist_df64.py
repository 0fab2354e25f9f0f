"""The port's distributed f64 lane against the JAX package's.

``parallel.solve_distributed_df64`` (the ``solver.df64`` recurrence on
float64 slabs, ``DistStencilDF64``), ``parallel.
solve_distributed_streaming_df64`` (B6/B7 with ``halos=`` per shard) and
``cg_df64``/``minres_df64`` under ``axis_name``, on stacked meshes of P
CPU shards (``make_mesh(P, devices=["cpu"] * P)``) and on a 2-rank gloo
process group; the JAX package on meshes of the 8 virtual CPU devices
``tests/conftest.py`` sets up.

Carried over: ``tests/test_df64_dist.py`` (``TestDistMatvecDF64``,
``TestDistSolveDF64``, ``TestDistVariantsDF64``, the slab case of
``TestChebyshevDF64Dist``), the slab cases of ``tests/test_df64_mg.py::
TestDF64MGDistributed``, ``tests/test_minres.py``'s
``test_df64_mesh_matches_single_device`` and ``test_df64_minres_gating``,
and ``tests/test_streaming.py``'s ``test_pass_a_df64_with_halos`` (with
its pass-B counterpart) and ``TestDistributedDF64Streaming``.  Each JAX
reference is computed once a module (``jax_refs``); the JAX streaming
engine runs only at (16, 128) over 2 shards for a fixed 24 iterations
(its interpret mode is slow, and in 3D takes tens of minutes to
compile).

Tolerances: the JAX package carries (hi, lo) f32 pairs (about 48 bits),
the port float64 (53), so x agrees to the JAX tests' own margins and
iteration counts within them; within the port, one shard is bit-equal
to ``axis_name=None`` and the P-shard runs differ from one device only
by the shard-order reduction of the dots.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.ops import df64 as jdf
from cuda_mpi_parallel_tpu.parallel import df64 as jpdf
from cuda_mpi_parallel_tpu.parallel import streaming as jpstream
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.ops import blas1 as tblas1
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.ops import df64 as tdf
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.parallel import df64 as tpdf
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.parallel import streaming as tstream
from cuda_mpi_parallel_tpu_torch.solver import minres as tminres

import torch_df64_ranks as ranks

torch.set_num_threads(1)


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def stencils(grid, dtype=np.float32):
    """The same global stencil in both packages (the port's on the CPU),
    and the port's float64 one (for right-hand sides and residuals)."""
    jcls, tcls = ((jp.Stencil2D, pt.Stencil2D) if len(grid) == 2
                  else (jp.Stencil3D, pt.Stencil3D))
    return (jcls.create(*grid, dtype=jnp.dtype(dtype)),
            tcls.create(*grid, dtype=torch.float32 if dtype == np.float32
                        else torch.float64, device="cpu"),
            tcls.create(*grid, dtype=torch.float64, device="cpu"))


def system(grid, seed):
    """``(jop, top, x_true, b)``: b = A x_true in float64."""
    jop, top, top64 = stencils(grid)
    x_true = np.random.default_rng(seed).standard_normal(top.n)
    b = (top64 @ torch.as_tensor(x_true)).numpy()
    return jop, top, x_true, b


GRID_2D = (16, 16)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX solves several cases hold the port to, each computed once:
    ``name -> (iterations, x, residual_history or None)``."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_ref(name)
        return cache[name]
    return get


def _jax_ref(name):
    jm8 = jpar.make_mesh(8)
    if name == "stream24":        # the JAX streaming engine, 2 shards
        jop, _, _, b = system((16, 128), 0)
        r = jpstream.solve_distributed_streaming_df64(
            jop, b, mesh=jpar.make_mesh(2), tol=0.0, maxiter=24,
            check_every=8)
        return int(r.iterations), r.x(), None
    if name == "mg":
        jop, _, _, b = system((32, 33), 3)
        r = jpdf.solve_distributed_df64(jop, b, mesh=jm8, tol=0.0,
                                        rtol=1e-10, maxiter=500,
                                        preconditioner="mg")
        return int(r.iterations), r.x(), None
    jop, _, _, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=2000)
    if name == "cg":
        kw["record_history"] = True
    elif name == "minres":
        kw.update(method="minres", rtol=1e-11, maxiter=600)
    else:
        kw.update(method=name)     # "cg1"
    r = jpdf.solve_distributed_df64(jop, b, mesh=jm8, **kw)
    hist = np.asarray(r.residual_history) if kw.get("record_history") \
        else None
    return int(r.iterations), r.x(), hist


# -- 1. B6/B7 with halos ------------------------------------------------------


def _extended_stencil(u, lo, hi, scale):
    """The plain f64 stencil over the halo-extended slab, cut back."""
    apply = (hk.stencil2d_apply_plain if u.ndim == 2
             else hk.stencil3d_apply_plain)
    return apply(torch.cat([lo, u, hi]), scale)[1:-1]


def _lap2d_with_halo(u, lo, hi, scale):
    """The JAX test's numpy reference (``TestHaloBranches``)."""
    ext = np.concatenate([lo, u, hi], axis=0)
    out = 4 * ext.copy()
    out[:-1] -= ext[1:]
    out[1:] -= ext[:-1]
    out[:, :-1] -= ext[:, 1:]
    out[:, 1:] -= ext[:, :-1]
    return (scale * out)[1:-1]


@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 7)])
def test_pass_a_df64_with_halos(shape):
    rng = np.random.default_rng(22)
    scale, beta = 0.25, 0.4
    r, p = (torch.as_tensor(rng.standard_normal(shape)) for _ in range(2))
    halos = tuple(torch.as_tensor(rng.standard_normal((1,) + shape[1:]))
                  for _ in range(4))
    pn, pap = hk.fused_cg_pass_a_df64(scale, beta, r, p, halos)
    r_lo, r_hi, p_lo, p_hi = halos
    want = r + beta * p
    assert torch.equal(pn, want)
    ap = _extended_stencil(want, r_lo + beta * p_lo, r_hi + beta * p_hi,
                           scale)
    assert torch.equal(pap, torch.sum(want * ap))
    # without halos: the Dirichlet zero, exactly as before
    pn0, pap0 = hk.fused_cg_pass_a_df64(scale, beta, r, p)
    assert torch.equal(pn0, want) and torch.equal(
        pap0, torch.sum(want * _extended_stencil(
            want, *(torch.zeros_like(r_lo),) * 2, scale)))
    if len(shape) == 2:            # the JAX test's reference
        h64 = [h.numpy() for h in halos]
        ap_ref = _lap2d_with_halo(want.numpy(), h64[0] + beta * h64[2],
                                  h64[1] + beta * h64[3], scale)
        np.testing.assert_allclose(float(pap),
                                   (want.numpy() * ap_ref).sum(),
                                   rtol=1e-12)


@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 7)])
def test_pass_b_df64_with_halos(shape):
    rng = np.random.default_rng(21)
    scale, alpha = 0.25, 0.2
    pn, x, r = (torch.as_tensor(rng.standard_normal(shape))
                for _ in range(3))
    lo, hi = (torch.as_tensor(rng.standard_normal((1,) + shape[1:]))
              for _ in range(2))
    xk, rk, rr = hk.fused_cg_pass_b_df64(scale, alpha, pn, x.clone(),
                                         r.clone(), (lo, hi))
    ap = _extended_stencil(pn, lo, hi, scale)
    assert torch.equal(xk, x + alpha * pn)
    assert torch.equal(rk, r - alpha * ap)
    assert torch.equal(rr, torch.sum(rk * rk))
    if len(shape) == 2:
        ap_ref = _lap2d_with_halo(pn.numpy(), lo.numpy(), hi.numpy(), scale)
        np.testing.assert_allclose(rk.numpy(), r.numpy() - alpha * ap_ref,
                                   rtol=1e-12, atol=1e-13)
    # B7 without halos is B7 with zero planes
    got = hk.fused_cg_pass_b_df64(scale, alpha, pn, x.clone(), r.clone())
    want = hk.fused_cg_pass_b_df64(scale, alpha, pn, x.clone(), r.clone(),
                                   (torch.zeros_like(lo),) * 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_df64_halos_are_checked():
    r = torch.zeros(4, 8, dtype=torch.float64)
    f32 = tuple(torch.zeros(1, 8) for _ in range(4))
    with pytest.raises(ValueError, match="float64 plane"):
        hk.fused_cg_pass_a_df64(1.0, 0.0, r, r, f32)
    with pytest.raises(ValueError, match="4 planes"):
        hk.fused_cg_pass_a_df64(1.0, 0.0, r, r, f32[:2])
    with pytest.raises(ValueError, match="float64 plane"):
        hk.fused_cg_pass_b_df64(1.0, 0.0, r, r.clone(), r.clone(),
                                (torch.zeros(1, 7, dtype=torch.float64),) * 2)


# -- 2. DistStencilDF64 (TestDistMatvecDF64) ----------------------------------


@pytest.mark.parametrize("grid", [(16, 5), (16, 5, 7)])
def test_sharded_matvec_equals_global(grid):
    scale = 1.7
    n = int(np.prod(grid))
    x64 = np.random.default_rng(5).standard_normal(n)
    fn = jdf.stencil2d_matvec if len(grid) == 2 else jdf.stencil3d_matvec
    xh, xl = (jnp.asarray(v) for v in jdf.split_f64(x64))
    want = jdf.to_f64(*fn((xh, xl), grid, jdf.const(scale)))
    local = tpar.DistStencilDF64.create(grid, 8, scale=scale, device="cpu")
    # the scale is the pair's value, as in the JAX package
    glob = (pt.Stencil2D if len(grid) == 2 else pt.Stencil3D).create(
        *grid, scale=tdf.pair_to_f64(local.scale_hi, local.scale_lo),
        dtype=torch.float64, device="cpu")
    jlocal = jpdf.DistStencilDF64.create(grid, 8, scale=scale)
    assert local.local_grid == jlocal.local_grid \
        and local.kind == jlocal.kind and local.n_shards == 8
    assert float(local.scale_hi) == float(jlocal.scale_hi) \
        and float(local.scale_lo) == float(jlocal.scale_lo)
    for mine, theirs in ((local.diag_hi, jlocal.diag_hi),
                         (local.diag_lo, jlocal.diag_lo)):
        assert float(mine) == float(np.asarray(theirs))
    x = torch.as_tensor(x64)
    with tcomm.bind(mesh(8)):
        got = local.matvec(x)
        got_df = local.matvec_df(tdf.f64_to_pair(x))
        assert local.shape == (n, n)
        assert torch.equal(local.matvec64(x), got)
    np.testing.assert_allclose(got.numpy(), (glob @ x).numpy(), rtol=1e-15,
                               atol=1e-14)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(tdf.to_f64(*got_df), got.numpy(), rtol=1e-13,
                               atol=1e-13)
    # one shard, the stencil's own bits; outside a scope a lone slab
    one = tpar.DistStencilDF64.create(grid, 1, scale=scale, device="cpu")
    assert torch.equal(one.matvec(x), glob @ x)
    assert local.device.type == "cpu"
    with pytest.raises(ValueError, match="not divisible"):
        tpar.DistStencilDF64.create(grid, 3, device="cpu")


# -- 3. cg_df64 and minres_df64 under axis_name -------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(method="cg1"), dict(method="pipecg"),
    dict(method="minres"), dict(preconditioner="jacobi"),
    dict(preconditioner="chebyshev"), dict(record_history=True),
], ids=["cg", "cg1", "pipecg", "minres", "jacobi", "chebyshev", "history"])
def test_axis_name_one_shard_is_bit_equal(kw):
    """On one shard the mesh reduction is the identity: the iterates of
    ``cg_df64(axis_name=...)`` and of ``solve_distributed_df64`` are the
    single-device lane's bits (the Chebyshev interval of a slab comes
    from its own f64 power iteration, so that case goes through
    ``solve_distributed_df64``, which takes the global operator's, as
    ``cg_df64`` does)."""
    _, top, _, b = system(GRID_2D, 1)
    skw = dict(tol=0.0, rtol=1e-9, maxiter=2000, **kw)
    want = pt.cg_df64(top, b, **skw)
    got = [tpar.solve_distributed_df64(top, b, mesh=mesh(1), **skw)]
    if "preconditioner" not in kw or kw["preconditioner"] != "chebyshev":
        local = tpar.DistStencilDF64.create(top.grid, 1, device="cpu")
        with tcomm.bind(mesh(1)):
            got.append(pt.cg_df64(local, b, axis_name="rows", **skw))
    for res in got:
        assert int(res.iterations) == int(want.iterations)
        assert np.array_equal(res.x(), want.x())
        assert int(res.status) == int(want.status)
        if "record_history" in kw:
            torch.testing.assert_close(res.residual_history,
                                       want.residual_history, rtol=0,
                                       atol=0, equal_nan=True)


def test_axis_name_dots_reduce_over_the_mesh():
    """P shards: one psum a dot (cg), one a stacked reduction (cg1), in
    the comm's shard order; the trajectory is the single device's up to
    that order."""
    _, top, x_true, b = system(GRID_2D, 1)
    local = tpar.DistStencilDF64.create(top.grid, 4, device="cpu")
    skw = dict(tol=0.0, rtol=1e-9, maxiter=2000)
    single = pt.cg_df64(top, b, **skw)
    for method, per_it in (("cg", 2), ("cg1", 1)):
        m = mesh(4)
        with tcomm.bind(m):
            res = pt.cg_df64(local, b, axis_name="rows", method=method, **skw)
        k = int(res.iterations)
        assert abs(k - int(single.iterations)) <= 1
        assert m.comm.counts["psum"] == per_it * k + 1
        np.testing.assert_allclose(res.x(), x_true, atol=1e-8)
    # fused_dots' mesh branch: one psum, per-pair results (the JAX
    # test_fused_dots_psum_branch)
    rng = np.random.default_rng(7)
    va, vb = rng.standard_normal(64), rng.standard_normal(64)
    m = mesh(8)
    with tcomm.bind(m):
        d1, d2 = tblas1.fused_dots(
            [(torch.as_tensor(va), torch.as_tensor(vb)),
             (torch.as_tensor(va), torch.as_tensor(va))], axis_name="rows")
    assert m.comm.counts["psum"] == 1
    np.testing.assert_allclose(float(d1), va @ vb, rtol=1e-13)
    np.testing.assert_allclose(float(d2), va @ va, rtol=1e-13)


@pytest.mark.parametrize("entry", ["cg_df64", "minres_df64"])
def test_minres_df64_under_axis_name(entry, jax_refs):
    """``minres_df64(axis_name=...)`` (directly, and routed through
    ``cg_df64(method="minres")``) on a stacked mesh: the single-device
    lane's count and x (the JAX ``test_df64_mesh_matches_single_device``:
    equal counts, x within 1e-11), and the JAX distributed minres's."""
    _, top, _, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-11, maxiter=600)
    single = tminres.minres_df64(top, b, **kw)
    fn = pt.cg_df64 if entry == "cg_df64" else tminres.minres_df64
    extra = dict(method="minres") if entry == "cg_df64" else {}
    local = tpar.DistStencilDF64.create(top.grid, 8, device="cpu")
    with tcomm.bind(mesh(8)):
        dist = fn(local, b, axis_name="rows", **kw, **extra)
    assert bool(dist.converged)
    assert int(dist.iterations) == int(single.iterations)
    np.testing.assert_allclose(dist.x(), single.x(), atol=1e-11)
    jits, jx, _ = jax_refs("minres")
    assert int(dist.iterations) == jits
    np.testing.assert_allclose(dist.x(), jx, atol=1e-11)


# -- 4. solve_distributed_df64 ------------------------------------------------


def test_2d_trajectory_and_convergence(jax_refs):
    """TestDistSolveDF64's trajectory and convergence cases: the 8-shard
    history follows the single device's and the JAX 8-shard run's at the
    histories' f32 resolution; at rtol 1e-9 the counts agree within the
    JAX test's 5 and x reaches x_true."""
    _, top, x_true, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=2000, record_history=True)
    single = pt.cg_df64(top, b, **kw)
    dist = tpar.solve_distributed_df64(top, b, mesh=mesh(8), **kw)
    jits, jx, jhist = jax_refs("cg")
    k = int(dist.iterations)
    assert bool(single.converged) and bool(dist.converged)
    assert abs(k - int(single.iterations)) <= 5 and abs(k - jits) <= 5
    n = min(k, jits) + 1
    np.testing.assert_allclose(dist.residual_history[:40].numpy(),
                               single.residual_history[:40].numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(dist.residual_history[:n].numpy(),
                               jhist[:n], rtol=1e-4)
    np.testing.assert_allclose(dist.x(), x_true, atol=1e-8)
    np.testing.assert_allclose(dist.x(), jx, atol=1e-8)
    hist = dist.residual_history.numpy()
    assert np.all(np.isfinite(hist[:k + 1])) and np.all(np.isnan(hist[k + 1:]))
    np.testing.assert_allclose(hist[k], dist.residual_norm(), rtol=1e-5)
    assert dist.x_hi.dtype == torch.float32 and dist.x64.shape == (top.n,)
    np.testing.assert_array_equal(tdf.to_f64(dist.x_hi, dist.x_lo),
                                  jdf.to_f64(*jdf.split_f64(dist.x())))


def test_3d_reaches_f64_depth():
    _, top, x_true, b = system((16, 6, 5), 2)
    r = tpar.solve_distributed_df64(top, b, mesh=mesh(8), tol=0.0,
                                    rtol=1e-11, maxiter=3000)
    assert bool(r.converged)
    np.testing.assert_allclose(r.x(), x_true, atol=1e-8)
    assert r.residual_norm() <= 1e-11 * np.linalg.norm(b) * 1.01


def test_jacobi_and_check_every():
    _, top, x_true, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=2000, preconditioner="jacobi")
    r1 = tpar.solve_distributed_df64(top, b, mesh=mesh(8), **kw)
    rk = tpar.solve_distributed_df64(top, b, mesh=mesh(8), check_every=8,
                                     **kw)
    assert bool(r1.converged) and bool(rk.converged)
    k1, kk = int(r1.iterations), int(rk.iterations)
    assert k1 <= kk < k1 + 8
    np.testing.assert_allclose(rk.x(), x_true, atol=1e-7)


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_variants_match_cg_on_mesh(method, jax_refs):
    """TestDistVariantsDF64: within 3 of cg's count, x to x_true; cg1
    also within 3 of the JAX 8-shard cg1, one psum an iteration."""
    _, top, x_true, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=2000)
    base = tpar.solve_distributed_df64(top, b, mesh=mesh(8), **kw)
    m = mesh(8)
    var = tpar.solve_distributed_df64(top, b, mesh=m, method=method, **kw)
    assert bool(var.converged)
    assert abs(int(var.iterations) - int(base.iterations)) <= 3
    np.testing.assert_allclose(var.x(), x_true, atol=1e-7)
    if method == "cg1":
        jits, jx, _ = jax_refs("cg1")
        assert abs(int(var.iterations) - jits) <= 3
        np.testing.assert_allclose(var.x(), jx, atol=1e-8)
        assert m.comm.counts["psum"] == int(var.iterations) + 1


def test_chebyshev_slab_matches_single_device():
    """TestChebyshevDF64Dist's slab case, with its bar: the interval from
    the global operator, the count within 2 of one device's (whose JAX
    parity ``test_torch_df64.py`` holds; the JAX distributed Chebyshev
    solve costs ~9 s to compile here), x to x_true within 1e-8."""
    _, top, x_true, b = system((16, 8, 6), 4)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=2000, preconditioner="chebyshev")
    single = pt.cg_df64(top, b, **kw)
    dist = tpar.solve_distributed_df64(top, b, mesh=mesh(8), **kw)
    assert bool(dist.converged)
    assert abs(int(dist.iterations) - int(single.iterations)) <= 2
    np.testing.assert_allclose(dist.x(), x_true, atol=1e-8)


def test_mg_slab_iteration_parity_2d(jax_refs):
    """TestDF64MGDistributed's 2D slab case: 8 shards of 4 rows take the
    single-device mg-df64 count and x within 1e-9 * max|x|; the JAX run's
    count."""
    _, top, _, b = system((32, 33), 3)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=500, preconditioner="mg")
    single = pt.cg_df64(top, b, **kw)
    dist = tpar.solve_distributed_df64(top, b, mesh=mesh(8), **kw)
    jits, jx, _ = jax_refs("mg")
    assert bool(dist.converged)
    assert int(dist.iterations) == int(single.iterations) == jits
    scale = np.max(np.abs(single.x()))
    np.testing.assert_allclose(dist.x(), single.x(), rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(dist.x(), jx, rtol=0, atol=1e-9 * scale)


def test_mg_slab_3d_converges_fast():
    _, top, _, b = system((16, 12, 10), 6)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=500)
    plain = tpar.solve_distributed_df64(top, b, mesh=mesh(8), **kw)
    mg = tpar.solve_distributed_df64(top, b, mesh=mesh(8),
                                     preconditioner="mg", **kw)
    assert bool(mg.converged)
    assert int(mg.iterations) < int(plain.iterations)


def test_flight_recorder_and_solver_cache():
    from cuda_mpi_parallel_tpu_torch.telemetry import flight as tflight

    _, top, _, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=2000, check_every=4)
    m = mesh(2)
    tpdf.clear_solver_cache()
    builds = tdist._BUILD_COUNT[0]
    cfg = tflight.FlightConfig.for_solve(2000, stride=2, heartbeat=3)
    rec = tpar.solve_distributed_df64(top, b, mesh=m, flight=cfg, **kw)
    plain = tpar.solve_distributed_df64(top, b, mesh=m, **kw)
    again = tpar.solve_distributed_df64(top, b, mesh=m, **kw)
    # the distributed solvers' shared cache: with and without flight
    assert len(tdist._SOLVER_CACHE) == 2
    assert tdist._BUILD_COUNT[0] == builds + 2
    assert all(key[0] == "df64" for key in tdist._SOLVER_CACHE)
    assert np.array_equal(rec.x(), plain.x()) and plain.flight is None
    assert np.array_equal(again.x(), plain.x())
    assert rec.flight.dtype == torch.float32
    got = tflight.FlightRecord.from_buffer(rec.flight)
    assert np.array_equal(got.iterations,
                          np.arange(0, int(rec.iterations) + 1, 2))
    tpdf.clear_solver_cache()
    assert not tdist._SOLVER_CACHE


REFUSALS = [
    (dict(preconditioner="ssor"), "stencil", ValueError, "jacobi"),
    (dict(preconditioner="mg", method="cg1"), "stencil", ValueError,
     "requires method='cg'"),
    (dict(preconditioner="mg"), "csr", ValueError, "matrix-free"),
    (dict(method="bicg"), "stencil", ValueError, "unknown method"),
    (dict(flight=object(), method="cg1"), "stencil", ValueError, "flight"),
    (dict(method="minres", preconditioner="jacobi"), "stencil", ValueError,
     "unpreconditioned"),
    (dict(method="minres"), "csr", TypeError, "minres"),
    (dict(), "dense", TypeError, "Stencil2D"),
    (dict(plan="auto"), "stencil", ValueError, "uniform"),
    (dict(method="minres"), "pencil", ValueError, "cg-family only"),
    (dict(), "pencil-2d", TypeError, "Stencil3D"),
]


@pytest.mark.parametrize("kw,kind,error,match", REFUSALS)
def test_solve_distributed_df64_refusals(kw, kind, error, match):
    """The JAX checks, in its order and with its exception types (on a
    2-D mesh too: minres is cg-family only there, and a 2-D stencil
    has no pencils)."""
    if kind == "csr":
        a = pt.CSRMatrix.from_dense(np.eye(64) * 2.0, device="cpu")
        ja = jpoisson.poisson_2d_csr(8, 8, dtype=np.float32)
    elif kind == "dense":
        a = pt.DenseOperator.create(np.eye(64), device="cpu")
        ja = jp.DenseOperator(a=jnp.eye(64))
    elif kind == "pencil-2d":
        ja, a, _ = stencils((8, 8))
    else:
        ja, a, _ = stencils((8, 4, 2) if kind == "pencil" else (8, 8))
    m, jm = mesh(2), jpar.make_mesh(2)
    if kind.startswith("pencil"):
        m, jm = (tpar.make_mesh_2d((2, 2), devices=["cpu"] * 4),
                 jpar.make_mesh_2d((2, 2)))
    with pytest.raises(error, match=match):
        tpar.solve_distributed_df64(a, np.ones(64), mesh=m, **kw)
    if error is not NotImplementedError:     # the JAX package refuses alike
        with pytest.raises(error):
            jpdf.solve_distributed_df64(ja, np.ones(64), mesh=jm, **kw)


def test_minres_gating():
    """``tests/test_minres.py::test_df64_minres_gating``."""
    _, top, _ = stencils(GRID_2D)
    with pytest.raises(ValueError, match="unpreconditioned"):
        tpar.solve_distributed_df64(top, np.ones(256), mesh=mesh(8),
                                    method="minres", preconditioner="jacobi")


def test_rhs_and_device_rules():
    _, top, _ = stencils(GRID_2D)
    with pytest.raises(ValueError, match="rhs shape"):
        tpar.solve_distributed_df64(top, np.ones(17), mesh=mesh(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.solve_distributed_df64(top, np.ones(256))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.solve_distributed_streaming_df64(top, np.ones(256))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.DistStencilDF64.create(GRID_2D, 2)
    # an (hi, lo) pair crosses as its float64 value
    b = np.random.default_rng(9).standard_normal(256)
    kw = dict(tol=0.0, rtol=1e-9, mesh=mesh(2))
    pair = tuple(torch.as_tensor(v) for v in tdf.split_f64(b))
    assert np.array_equal(
        tpar.solve_distributed_df64(top, pair, **kw).x(),
        tpar.solve_distributed_df64(top, tdf.pair_to_f64(*pair), **kw).x())


# -- 5. solve_distributed_streaming_df64 --------------------------------------


def test_streaming_2shard_bitwise_matches_single_device(jax_refs):
    """TestDistributedDF64Streaming: 2 shards take the single-device
    engine's count, x rounded to f32 equal to its (the JAX hi words) and
    x within 1e-12; B6 and B7 run once a shard an iteration; the JAX
    streaming engine's 24-iteration x within 1e-12."""
    _, top, _, b = system((16, 128), 0)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=300, check_every=1)
    single = pt.cg_streaming_df64(top, b, **kw)
    m = mesh(2)
    dist = tpar.solve_distributed_streaming_df64(top, b, mesh=m, **kw)
    k = int(dist.iterations)
    assert bool(dist.converged) and k == int(single.iterations)
    assert torch.equal(dist.x_hi, single.x_hi)
    np.testing.assert_allclose(dist.x(), single.x(), rtol=0, atol=1e-12)
    # one exchange of r and of p (lo and hi each) and two sums an
    # iteration, one sum at init
    assert dict(m.comm.counts) == {"ppermute": 4 * k, "psum": 2 * k + 1}
    jits, jx, _ = jax_refs("stream24")
    fixed = tpar.solve_distributed_streaming_df64(
        top, b, mesh=mesh(2), tol=0.0, maxiter=24, check_every=8)
    assert int(fixed.iterations) == jits == 24
    np.testing.assert_allclose(fixed.x(), jx, rtol=0, atol=1e-12)


def test_streaming_4shard_matches_single_device_and_jax(jax_refs):
    """4 shards: the port's single-device engine's count and f32-rounded
    x, and the JAX general ``solve_distributed_df64``'s count within its
    test's 5 and its x within 1e-8."""
    _, top, x_true, b = system(GRID_2D, 1)
    kw = dict(tol=0.0, rtol=1e-9, maxiter=2000, check_every=4)
    single = pt.cg_streaming_df64(top, b, **kw)
    dist = tpar.solve_distributed_streaming_df64(top, b, mesh=mesh(4), **kw)
    assert int(dist.iterations) == int(single.iterations)
    assert torch.equal(dist.x_hi, single.x_hi)
    np.testing.assert_allclose(dist.x(), single.x(), rtol=0, atol=1e-12)
    jits, jx, _ = jax_refs("cg")
    assert bool(dist.converged) and abs(int(dist.iterations) - jits) <= 5
    np.testing.assert_allclose(dist.x(), jx, atol=1e-8)
    np.testing.assert_allclose(dist.x(), x_true, atol=1e-8)


def test_streaming_3d_and_launches(monkeypatch):
    """3D slabs over 4 shards at a fixed count: one-device bits at f32,
    and on one shard the single-device engine's x bit for bit.  Each
    iteration calls B6 and B7 once a shard (their twins here: no kernel
    launch on the CPU), exchanges r and p once and sums twice."""
    calls = {"a": 0, "b": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    monkeypatch.setattr(tstream, "fused_cg_pass_a_df64",
                        counted("a", tstream.fused_cg_pass_a_df64))
    monkeypatch.setattr(tstream, "fused_cg_pass_b_df64",
                        counted("b", tstream.fused_cg_pass_b_df64))
    _, top, _, b = system((8, 6, 5), 5)
    kw = dict(tol=0.0, maxiter=30, check_every=8)
    single = pt.cg_streaming_df64(top, b, **kw)
    launches = sum(hk.LAUNCHES.values())
    for n in (1, 4):
        calls.update(a=0, b=0)
        m = mesh(n)
        dist = tpar.solve_distributed_streaming_df64(top, b, mesh=m, **kw)
        assert int(dist.iterations) == 30
        assert calls == {"a": 30 * n, "b": 30 * n}
        # one shard has no neighbour to exchange with
        want = {"psum": 61, "ppermute": 4 * 30} if n > 1 else {"psum": 61}
        assert dict(m.comm.counts) == want
        if n == 1:
            assert np.array_equal(dist.x(), single.x())
        np.testing.assert_allclose(dist.x(), single.x(), rtol=0,
                                   atol=1e-12 * np.abs(single.x()).max())
    assert sum(hk.LAUNCHES.values()) == launches


def test_streaming_rejections():
    a_csr = pt.CSRMatrix.from_dense(np.eye(256) * 2.0, device="cpu")
    with pytest.raises(TypeError, match="Stencil"):
        tpar.solve_distributed_streaming_df64(a_csr, np.ones(256),
                                              mesh=mesh(2))
    _, op, _ = stencils((18, 128))
    with pytest.raises(ValueError, match="divide"):
        tpar.solve_distributed_streaming_df64(op, np.ones(18 * 128),
                                              mesh=mesh(4))
    pencil = tpar.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="slab"):
        tpar.solve_distributed_streaming_df64(op, np.ones(18 * 128),
                                              mesh=pencil)
    with pytest.raises(ValueError, match="check_every"):
        tpar.solve_distributed_streaming_df64(op, np.ones(18 * 128),
                                              mesh=mesh(2), check_every=0)


# -- 6. torch.distributed (gloo): two ranks give the stacked mesh's bits ------


def test_gloo_ranks_equal_the_stacked_mesh(tmp_path):
    import torch.multiprocessing as mp

    out = str(tmp_path / "result")
    init = "file://" + str(tmp_path / "rendezvous")
    # the ranks import a helper without JAX (torch_df64_ranks.py), not
    # this module
    mp.spawn(ranks.gloo_rank, args=(2, init, out), nprocs=2, join=True)
    for rank in range(2):
        got = torch.load(f"{out}.{rank}")
        assert len(got) == len(ranks.problems())
        for (lane, a, b, kw), g in zip(ranks.problems(), got):
            m = mesh(2)
            want = ranks.solve(lane, a, b, m, kw)
            assert g["iterations"] == int(want.iterations), (lane, kw)
            assert torch.equal(g["x"], want.x64), (lane, kw)
            assert g["counts"] == dict(m.comm.counts), (lane, kw)
    assert not os.path.exists(str(tmp_path / "result.2"))
