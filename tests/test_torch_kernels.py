"""The port's kernel twins (B1-B5) against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

The same numpy-seeded inputs go through both.  On a CPU tensor each
wrapper of ``cuda_mpi_parallel_tpu_torch.ops.cuda`` runs its plain
PyTorch twin - the function the hand kernel is held against on the card
by ``chip_smoke.py`` - so these tests pin what the kernels compute.

Tolerances: elementwise arrays agree to f32 rounding (``rtol=1e-6``,
``atol=1e-5 * max|y|``: XLA may reassociate the stencil's sums, measured
1.9e-6 at values about 10); the reductions ``pap``/``rr``/``rz`` sum in
another order than the TPU kernels' slab-sequential accumulation, so
they agree to relative 1e-5 (B5's ``rho`` too).  f64 grids agree to
1e-12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_mpi_parallel_tpu.ops.pallas import fused_cg as jfused
from cuda_mpi_parallel_tpu.ops.pallas import stencil as jstencil
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk

torch.set_num_threads(1)

GRIDS_2D = [(16, 128), (32, 256)]
GRIDS_3D = [(4, 8, 128), (8, 8, 128)]


def _close(got, want, dtype=np.float32):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5 * scale)


def _rel(got, want, rel):
    assert abs(float(got) - float(want)) <= rel * abs(float(want)), \
        (float(got), float(want))


def _jax_stencil(x, scale):
    if x.ndim == 2:
        bm = jstencil.pick_block_rows_2d(*x.shape, x.dtype.itemsize)
        return jstencil.stencil2d_apply(jnp.asarray(x), scale, bm=bm,
                                        interpret=True)
    bm = jstencil.pick_block_planes_3d(*x.shape, x.dtype.itemsize)
    return jstencil.stencil3d_apply(jnp.asarray(x), scale, bm=bm,
                                    interpret=True)


@pytest.mark.parametrize("shape,dtype", [
    (GRIDS_2D[0], np.float32), (GRIDS_2D[1], np.float64),
    (GRIDS_3D[0], np.float32), (GRIDS_3D[1], np.float64)])
def test_stencil_twin_matches_pallas(shape, dtype):
    rng = np.random.default_rng(11)
    x = (10 * rng.standard_normal(shape)).astype(dtype)
    scale = 0.37
    want = _jax_stencil(x, scale)
    tdtype = getattr(torch, np.dtype(dtype).name)
    fn = hk.stencil2d_apply if len(shape) == 2 else hk.stencil3d_apply
    got = fn(torch.as_tensor(x), torch.tensor(scale, dtype=tdtype))
    assert got.dtype == tdtype
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("shape", [GRIDS_2D[0], GRIDS_3D[0]])
@pytest.mark.parametrize("theta", [None, 1.7])
def test_pass_a_twin_matches_pallas(shape, theta):
    rng = np.random.default_rng(5)
    r = rng.standard_normal(shape).astype(np.float32)
    p = rng.standard_normal(shape).astype(np.float32)
    scale, beta = 0.25, 0.37
    bm = jfused.pick_block_streaming(shape)
    want_p, want_pap = jfused.fused_cg_pass_a(
        scale, beta, jnp.asarray(r), jnp.asarray(p), bm=bm, interpret=True,
        theta=theta)
    got_p, got_pap = hk.fused_cg_pass_a(
        torch.tensor(scale), torch.tensor(beta, dtype=torch.float32),
        torch.as_tensor(r), torch.as_tensor(p),
        theta=None if theta is None else torch.tensor(theta))
    _close(got_p.numpy(), want_p)
    _rel(got_pap, want_pap, 1e-5)


@pytest.mark.parametrize("shape", [GRIDS_2D[0], GRIDS_3D[0]])
@pytest.mark.parametrize("with_rz,theta", [(False, None), (True, 1.7)])
def test_pass_b_twin_matches_pallas(shape, with_rz, theta):
    rng = np.random.default_rng(6)
    pn = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    scale, alpha = 0.25, 0.11
    bm = jfused.pick_block_streaming(shape)
    want = jfused.fused_cg_pass_b(
        scale, alpha, jnp.asarray(pn), jnp.asarray(x), jnp.asarray(r),
        bm=bm, interpret=True, theta=theta, with_rz=with_rz)
    xt, rt = torch.as_tensor(x.copy()), torch.as_tensor(r.copy())
    got = hk.fused_cg_pass_b(torch.tensor(scale), torch.tensor(alpha),
                             torch.as_tensor(pn), xt, rt,
                             theta=None if theta is None
                             else torch.tensor(theta), with_rz=with_rz)
    assert len(got) == len(want) == (4 if with_rz else 3)
    assert got[0] is xt and got[1] is rt          # updated in place
    _close(xt.numpy(), want[0])
    _close(rt.numpy(), want[1])
    _rel(got[2], want[2], 1e-5)
    if with_rz:
        _rel(got[3], want[3], 1e-5)


@pytest.mark.parametrize("shape", [GRIDS_2D[1], GRIDS_3D[1]])
@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True), (True, True)],
                         ids=["first", "middle", "last", "first+last"])
def test_cheb_step_twin_matches_pallas(shape, first, last):
    rng = np.random.default_rng(8)
    r, z, d = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    scale, theta, c1, c2 = 0.25, 4.1, 0.62, 0.31
    bm = jfused.pick_block_streaming(shape)
    v = r if first else z
    want = jfused.fused_cheb_step(
        scale, theta, c1, c2, jnp.asarray(v), None if first else
        jnp.asarray(r), None if first else jnp.asarray(d), bm=bm,
        first=first, last=last, interpret=True)
    dt = torch.as_tensor(d.copy())
    got = hk.fused_cheb_step(
        torch.tensor(scale), torch.tensor(theta), torch.tensor(c1),
        torch.tensor(c2), torch.as_tensor(v), None if first
        else torch.as_tensor(r), None if first else dt, first=first,
        last=last, d_out=None if first else dt)
    assert len(got) == len(want) == (3 if last else 2)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    if not first:
        assert got[1] is dt                       # d updated in place
    if last:
        _rel(got[2], want[2], 1e-5)


def test_cheb_step_plain_follows_the_polynomial():
    """First then last: z = P(A) r of a degree-3 Chebyshev, as the
    preconditioner's own matvec computes it."""
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    m = pt.ChebyshevPreconditioner.from_operator(op, degree=3, lmin=0.3,
                                                 lmax=8.0)
    r = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (16, 128)).astype(np.float32))
    theta = (m.lmax + m.lmin) / 2
    delta = (m.lmax - m.lmin) / 2
    sigma = theta / delta
    rho = 1.0 / sigma
    z = d = None
    for j in range(2):
        rho_n = 1.0 / (2.0 * sigma - rho)
        out = hk.fused_cheb_step(op.scale, theta, rho_n * rho,
                                 2.0 * rho_n / delta, r if j == 0 else z,
                                 None if j == 0 else r, d, first=j == 0,
                                 last=j == 1)
        z, d = out[:2]
        rho = rho_n
    want = m @ r.reshape(-1)
    torch.testing.assert_close(z.reshape(-1), want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    torch.testing.assert_close(out[2], torch.dot(r.reshape(-1), want),
                               rtol=1e-5, atol=0)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    hk.reset_launches()
    u = torch.ones(8, 8, 128)
    hk.stencil3d_apply(u, 1.0)
    hk.stencil2d_apply(u[0], 1.0)
    p, _ = hk.fused_cg_pass_a(1.0, 0.0, u, torch.zeros_like(u))
    hk.fused_cg_pass_b(1.0, 0.5, p, torch.zeros_like(u), u.clone())
    z, d = hk.fused_cheb_step(1.0, 2.0, 0.5, 0.25, u, first=True, last=False)
    hk.fused_cheb_step(1.0, 2.0, 0.5, 0.25, z, u, d, first=False, last=True)
    assert sum(hk.LAUNCHES.values()) == 0


def test_pass_a_out_buffer():
    rng = np.random.default_rng(7)
    r = torch.as_tensor(rng.standard_normal((16, 128)).astype(np.float32))
    p = torch.as_tensor(rng.standard_normal((16, 128)).astype(np.float32))
    out = torch.empty_like(r)
    pnew, pap = hk.fused_cg_pass_a(1.0, 0.5, r, p, out=out)
    ref, ref_pap = hk.fused_cg_pass_a_plain(1.0, 0.5, r, p)
    assert pnew is out
    assert torch.equal(out, ref) and torch.equal(pap, ref_pap)


@pytest.mark.parametrize("call", ["pass_a", "pass_b", "stencil2d",
                                  "cheb_shape", "cheb_missing_d"])
def test_twins_check_their_inputs(call):
    u = torch.zeros(8, 8, 128)
    with pytest.raises((ValueError, TypeError)):
        if call == "pass_a":
            hk.fused_cg_pass_a(1.0, 0.0, u, u[:4])
        elif call == "pass_b":
            hk.fused_cg_pass_b(1.0, 0.0, u, u.double(), u)
        elif call == "cheb_shape":
            hk.fused_cheb_step(1.0, 2.0, 0.5, 0.25, u, u[:4], u,
                               first=False, last=False)
        elif call == "cheb_missing_d":
            hk.fused_cheb_step(1.0, 2.0, 0.5, 0.25, u, u, None,
                               first=False, last=False)
        else:
            hk.stencil2d_apply(u, 1.0)


def test_supports_streaming_takes_any_nonempty_f32_grid():
    assert hk.supports_streaming((3, 5)) and hk.supports_streaming((3, 5, 7))
    assert not hk.supports_streaming((3,))
    assert not hk.supports_streaming((0, 5))
    assert not hk.supports_streaming((4, 4), itemsize=8)
