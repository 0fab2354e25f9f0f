"""The port's one-launch distributed solve (B12's twin) and the
distributed streaming passes (B3/B4 with ``halos=``) against the JAX
package.

Inputs are numpy-seeded and handed to both packages.  On the CPU the
port runs B12's plain twin (``ops.cuda.resident_dist
.cg_resident_dist_plain``: the per-shard protocol on stacked slabs) -
the function ``csrc/resident_dist.cu`` is held against on the card by
``chip_smoke.py`` - and the pass twins with halos; the JAX side runs
its Pallas kernels in interpret mode and its distributed solves on the
8 virtual CPU devices.

Parity contract: equal iteration counts, statuses and flags; x within
``1e-5 * max|x|`` (per-shard partial dots summed in shard order, against
the single-device kernel's whole-grid sums); the pass twins' arrays
within f32 rounding of the interpret-mode kernels' (whose stencil adds
in another order; on the card the kernels equal their twins bit for
bit, ``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models.precond import (
    ChebyshevPreconditioner as JCheb,
)
from cuda_mpi_parallel_tpu.ops.pallas import fused_cg as jfused
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as trd

torch.set_num_threads(1)

GRID_2D = (24, 128)        # divides over 1, 2, 3 and 4 shards
GRID_3D = (12, 8, 128)
X_TOL = 1e-5
KW = dict(tol=0.0, rtol=1e-5, maxiter=300, check_every=1)


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


def stencils(grid):
    if len(grid) == 2:
        return jp.Stencil2D.create(*grid), pt.Stencil2D.create(
            *grid, device="cpu")
    return jp.Stencil3D.create(*grid), pt.Stencil3D.create(*grid,
                                                          device="cpu")


@functools.lru_cache(maxsize=None)
def jax_resident(grid, degree):
    """The JAX single-device resident solve (interpret mode) on the global
    grid, and its Chebyshev interval (shared by every shard count)."""
    jop, _ = stencils(grid)
    b = vec(jop.n, 1)
    jm = JCheb.from_operator(jop, degree=degree) if degree else None
    res = jp.cg_resident(jop, jnp.asarray(b), m=jm, interpret=True,
                         record_history=True, **KW)
    interval = (float(jm.lmin), float(jm.lmax)) if degree else None
    return b, res, interval


def port_m(top, interval, degree):
    if not degree:
        return None
    return pt.ChebyshevPreconditioner.from_operator(
        top, degree=degree, lmin=interval[0], lmax=interval[1])


def assert_parity(res, jres, what=""):
    assert int(res.iterations) == int(jres.iterations), what
    assert int(res.status) == int(jres.status), what
    assert bool(res.indefinite) == bool(jres.indefinite), what
    x, jx = res.x.numpy(), np.asarray(jres.x).reshape(-1)
    assert np.abs(x - jx).max() <= X_TOL * np.abs(jx).max(), what


# -- 1. B12's twin ------------------------------------------------------------


@pytest.mark.parametrize("grid", [GRID_2D, GRID_3D])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", [0, 2])
def test_resident_dist_twin_matches_jax_cg_resident(grid, n, degree):
    b, jres, interval = jax_resident(grid, degree)
    _, top = stencils(grid)
    m = mesh(n)
    res = tpar.solve_distributed_resident(
        top, torch.as_tensor(b), mesh=m, m=port_m(top, interval, degree),
        record_history=True, **KW)
    assert_parity(res, jres, (grid, n, degree))
    hist, jhist = res.residual_history.numpy(), \
        np.asarray(jres.residual_history)
    np.testing.assert_array_equal(np.isnan(hist), np.isnan(jhist))
    ran = ~np.isnan(jhist)
    np.testing.assert_allclose(hist[ran], jhist[ran], rtol=1e-4)
    assert not m.comm.counts      # the twin exchanges inside, not via comm


@pytest.mark.parametrize("grid,n", [(GRID_2D, 4), (GRID_3D, 3)])
def test_resident_dist_twin_matches_jax_solve_distributed(grid, n):
    jop, top = stencils(grid)
    b = vec(jop.n, 2)
    jres = jpar.solve_distributed(jop, jnp.asarray(b),
                                  mesh=jpar.make_mesh(n), **KW)
    res = tpar.solve_distributed_resident(top, torch.as_tensor(b),
                                          mesh=mesh(n), **KW)
    assert_parity(res, jres)


def test_resident_dist_twin_matches_jax_resident_dist():
    """One case against the JAX one-kernel distributed solve itself: 12
    iterations in three check blocks (its TPU-interpret simulation of
    the remote DMAs costs ~4 s here, ~30 s for a solve to rtol 1e-5)."""
    jop, top = stencils((16, 128))
    b = vec(jop.n, 3)
    kw = dict(tol=0.0, maxiter=12, check_every=4, record_history=True)
    jres = jpar.solve_distributed_resident(jop, jnp.asarray(b),
                                           mesh=jpar.make_mesh(2), **kw)
    res = tpar.solve_distributed_resident(top, torch.as_tensor(b),
                                          mesh=mesh(2), **kw)
    assert_parity(res, jres)
    assert int(res.iterations) == 12
    np.testing.assert_allclose(res.residual_history.numpy(),
                               np.asarray(jres.residual_history), rtol=1e-5)


def test_one_shard_twin_is_the_single_device_twin():
    """At one shard the protocol has no neighbour and no peer: B12's
    twin takes B10's twin's bits (as B12 takes B10's on the card)."""
    _, top = stencils(GRID_2D)
    b = torch.as_tensor(vec(top.n, 4)).reshape(1, *GRID_2D)
    kw = dict(tol=0.0, rtol=0.0, cap=40, nblocks=5, check_every=8)
    dist = trd.cg_resident_dist_plain(0.5, b, degree=3, lmin=0.3, lmax=7.9,
                                      **kw)
    single = hk.cg_resident_plain(0.5, b[0], None, precond_degree=3,
                                  lmin=0.3, lmax=7.9, **kw)
    assert torch.equal(dist[0][0], single[0])
    assert all(torch.equal(u, v) for u, v in zip(dist[1:], single[1:]))


@pytest.mark.parametrize("shape,n", [((4, 5, 7), 4), ((3, 17, 33), 3),
                                     ((9, 17, 33), 3), ((6, 200), 6)])
def test_single_plane_and_odd_shards(shape, n):
    """Slabs of one plane (both halo corrections on the same plane) and
    odd extents: the twin of P shards against the single-device solve."""
    top = (pt.Stencil2D if len(shape) == 2 else pt.Stencil3D).create(
        *shape, device="cpu")
    b = torch.as_tensor(vec(top.n, 5))
    res = tpar.solve_distributed_resident(top, b, mesh=mesh(n), **KW)
    ref = pt.cg_resident(top, b, **KW)
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged)
    assert float((res.x - ref.x).abs().max()) <= X_TOL * float(
        ref.x.abs().max())


def test_resident_dist_wrapper_rules(monkeypatch):
    b = torch.ones(2, 4, 128)
    x, iters, rr, *_ = hk.cg_resident_dist(1.0, b, maxiter=5, check_every=2)
    assert x.shape == b.shape and int(iters) == 5
    with pytest.raises(ValueError, match="stacked"):
        hk.cg_resident_dist(1.0, torch.ones(8, 128))
    with pytest.raises(ValueError, match="float32"):
        hk.cg_resident_dist(1.0, torch.ones(2, 4, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="launch"):
        hk.cg_resident_dist(1.0, b, per_shard=True)
    assert hk.supports_resident_dist((256, 1024))
    assert not hk.supports_resident_dist((2048, 2048))
    assert hk.supports_resident_dist((256, 1024), preconditioned=True)
    assert not hk.supports_resident_dist((5,))
    trd.check_shards_fit((256, 1024), 4)       # 1024^2 over four shards
    with pytest.raises(ValueError, match="L2"):
        trd.check_shards_fit((1024, 1024), 4)
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", "1000")
    assert not hk.supports_resident_dist((4, 128))


REFUSALS = [
    (lambda top: dict(a=pt.CSRMatrix.from_dense(np.eye(4), device="cpu")),
     TypeError, "Stencil"),
    (lambda top: dict(a=pt.Stencil2D.create(*GRID_2D, dtype=torch.float64,
                                            device="cpu")),
     ValueError, "float32"),
    (lambda top: dict(mesh=mesh(5)), ValueError, "divide"),
    (lambda top: dict(m=pt.JacobiPreconditioner.from_operator(top)),
     TypeError, "ChebyshevPreconditioner"),
    (lambda top: dict(m=pt.ChebyshevPreconditioner.from_operator(
        pt.Stencil2D.create(*GRID_2D, scale=2.0, device="cpu"), lmax=8.0)),
     ValueError, "same stencil"),
    (lambda top: dict(check_every=0), ValueError, "check_every"),
    (lambda top: dict(flight=object()), NotImplementedError, "A9"),
]


@pytest.mark.parametrize("make,error,match", REFUSALS)
def test_solve_distributed_resident_refusals(make, error, match):
    _, top = stencils(GRID_2D)
    kw = dict(a=top, mesh=mesh(2))
    kw.update(make(top))
    a = kw.pop("a")
    with pytest.raises(error, match=match):
        tpar.solve_distributed_resident(a, np.ones(a.shape[0], np.float32),
                                        **kw)


def test_solve_distributed_resident_gate_and_flags(monkeypatch):
    _, top = stencils(GRID_2D)
    b = np.ones(top.n, np.float32)
    # detect_races is the TPU simulator's; interpret=True is the twin,
    # which is what a CPU tensor runs anyway
    one = tpar.solve_distributed_resident(top, b, mesh=mesh(2),
                                          detect_races=True, maxiter=6)
    two = tpar.solve_distributed_resident(top, b, mesh=mesh(2),
                                          interpret=True, maxiter=6)
    assert torch.equal(one.x, two.x) and int(one.iterations) == 6
    assert one.residual_history is None
    capped = tpar.solve_distributed_resident(top, b, mesh=mesh(2),
                                             maxiter=50, iter_cap=7,
                                             check_every=4)
    assert int(capped.iterations) == 7
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", "4096")
    with pytest.raises(ValueError, match="resident gate"):
        tpar.solve_distributed_resident(top, b, mesh=mesh(2))


# -- 2. the distributed streaming passes --------------------------------------


def _jax_halos(shape, seed):
    rng = np.random.default_rng(seed)
    plane = (1,) + shape[1:]
    return [rng.standard_normal(plane).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", [(16, 128), (4, 8, 128)])
def test_pass_a_halos_twin_matches_pallas(shape):
    rng = np.random.default_rng(7)
    r, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    halos = _jax_halos(shape, 8)
    scale, beta = 0.25, 0.37
    bm = jfused.pick_block_streaming(shape)
    want_p, want_pap = jfused.fused_cg_pass_a(
        scale, beta, jnp.asarray(r), jnp.asarray(p),
        tuple(jnp.asarray(h) for h in halos), bm=bm, interpret=True)
    got_p, got_pap = hk.fused_cg_pass_a(
        torch.tensor(scale), torch.tensor(beta), torch.as_tensor(r),
        torch.as_tensor(p), tuple(torch.as_tensor(h) for h in halos))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-6)
    assert abs(float(got_pap) - float(want_pap)) <= 1e-5 * abs(
        float(want_pap))
    no_halo = hk.fused_cg_pass_a(torch.tensor(scale), torch.tensor(beta),
                                 torch.as_tensor(r), torch.as_tensor(p))
    assert float(no_halo[1]) != float(got_pap)


@pytest.mark.parametrize("shape", [(16, 128), (4, 8, 128)])
def test_pass_b_halos_twin_matches_pallas(shape):
    rng = np.random.default_rng(9)
    pn, x, r = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    halos = _jax_halos(shape, 10)[:2]
    scale, alpha = 0.25, 0.11
    bm = jfused.pick_block_streaming(shape)
    want = jfused.fused_cg_pass_b(
        scale, alpha, jnp.asarray(pn), jnp.asarray(x), jnp.asarray(r),
        tuple(jnp.asarray(h) for h in halos), bm=bm, interpret=True)
    xt, rt = torch.as_tensor(x.copy()), torch.as_tensor(r.copy())
    got = hk.fused_cg_pass_b(torch.tensor(scale), torch.tensor(alpha),
                             torch.as_tensor(pn), xt, rt,
                             tuple(torch.as_tensor(h) for h in halos))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    assert abs(float(got[2]) - float(want[2])) <= 1e-5 * float(want[2])
    with pytest.raises(ValueError, match="halos must hold"):
        hk.fused_cg_pass_b(1.0, 1.0, torch.as_tensor(pn), xt, rt,
                           tuple(torch.as_tensor(h) for h in halos[:1]))
    with pytest.raises(ValueError, match="plane"):
        hk.fused_cg_pass_b(1.0, 1.0, torch.as_tensor(pn), xt, rt,
                           (torch.ones(2, 3), torch.ones(2, 3)))


@pytest.mark.parametrize("grid,n", [((32, 256), 1), ((32, 256), 2),
                                    ((32, 256), 4), ((8, 8, 128), 2),
                                    ((8, 8, 128), 4)])
def test_solve_distributed_streaming_matches_jax(grid, n):
    jop, top = stencils(grid)
    b = vec(jop.n, 11)
    kw = dict(tol=0.0, rtol=1e-5, maxiter=400, check_every=1)
    jres = jpar.solve_distributed_streaming(jop, jnp.asarray(b),
                                            mesh=jpar.make_mesh(n), **kw)
    m = mesh(n)
    res = tpar.solve_distributed_streaming(top, torch.as_tensor(b), mesh=m,
                                           **kw)
    assert_parity(res, jres, (grid, n))
    # two reductions per iteration and one at init; two exchanges each of
    # r and p per iteration past one shard
    its = int(res.iterations)
    assert m.comm.counts["psum"] == 2 * its + 1
    assert m.comm.counts["ppermute"] == (0 if n == 1 else 4 * its)


def test_solve_distributed_streaming_rules():
    _, top = stencils((32, 256))
    b = np.ones(top.n, np.float32)
    res = tpar.solve_distributed_streaming(top, b, mesh=mesh(4), maxiter=10,
                                           tol=0.0, check_every=4)
    assert int(res.iterations) == 10 and res.x.shape == (top.n,)
    with pytest.raises(ValueError, match="divide"):
        tpar.solve_distributed_streaming(top, b, mesh=mesh(3))
    with pytest.raises(TypeError, match="Stencil"):
        tpar.solve_distributed_streaming(
            pt.CSRMatrix.from_dense(np.eye(4), device="cpu"), np.ones(4),
            mesh=mesh(2))
    with pytest.raises(NotImplementedError, match="A9"):
        tpar.solve_distributed_streaming(top, b, mesh=mesh(2),
                                         flight=object())
    with pytest.raises(ValueError, match="check_every"):
        tpar.solve_distributed_streaming(top, b, mesh=mesh(2),
                                         check_every=0)
