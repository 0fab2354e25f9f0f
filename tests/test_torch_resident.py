"""The port's resident engine against the JAX package's.

Inputs are numpy-seeded and handed to both packages.  The JAX
``cg_resident`` runs its Pallas kernel in interpret mode; the port's
``cg_resident`` runs the kernel's plain twin (``cg_resident_plain``: the
tensors lie on the CPU) - the function ``csrc/resident.cu`` is held
against on the card by ``chip_smoke.py``.

Parity contract: equal iteration counts, statuses and flags; x within
``1e-5 * max|x|`` (the two sum p.Ap and r.r in different orders, so the
iterates differ by f32 reduction rounding); the check-block history with
NaN in the same places and values within 1e-5 relative.  Routing:
``resident_eligible`` and ``solve(engine="auto")`` decide as the JAX
package does on a TPU, wherever the two capacity models agree (the port
gates 5 planes on the card's L2, the JAX package 7 on a TPU's VMEM, and
drops the TPU tiling rules).
"""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.ops.pallas import resident as jrk
from cuda_mpi_parallel_tpu.solver import resident as jresident
from cuda_mpi_parallel_tpu.solver import streaming as jstreaming
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.models import precond as tprecond
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident as trk
from cuda_mpi_parallel_tpu_torch.solver import resident as tresident
from cuda_mpi_parallel_tpu_torch.solver import streaming as tstreaming

# the module (the package re-exports its function ``cg`` under that name)
tcg = sys.modules["cuda_mpi_parallel_tpu_torch.solver.cg"]

torch.set_num_threads(1)

GRID_2D = (16, 128)
GRID_3D = (4, 8, 128)
ENV = "CMP_RESIDENT_VMEM_BYTES"


def ops(grid, scale=1.0, dtype=np.float32):
    """The same stencil in both packages (the port's on the CPU)."""
    if len(grid) == 2:
        return (jpoisson.poisson_2d_operator(*grid, scale=scale, dtype=dtype),
                tpoisson.poisson_2d_operator(*grid, scale=scale, dtype=dtype,
                                             device="cpu"))
    return (jpoisson.poisson_3d_operator(*grid, scale=scale, dtype=dtype),
            tpoisson.poisson_3d_operator(*grid, scale=scale, dtype=dtype,
                                         device="cpu"))


def vec(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def both(grid, b, x0=None, scale=1.0, **kw):
    """``cg_resident`` of both packages on the same inputs."""
    jop, top = ops(grid, scale)
    jres = jp.cg_resident(jop, jnp.asarray(b),
                          None if x0 is None else jnp.asarray(x0),
                          interpret=True, **kw)
    tres = pt.cg_resident(top, torch.as_tensor(b),
                          None if x0 is None else torch.as_tensor(x0), **kw)
    return tres, jres


def assert_same(tres, jres, tol=1e-5):
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.status) == int(jres.status)
    assert bool(tres.converged) == bool(jres.converged)
    assert bool(tres.indefinite) == bool(jres.indefinite)
    want = np.asarray(jres.x)
    got = tres.x.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (np.abs(want).max() or 1.0))
    np.testing.assert_allclose(float(tres.residual_norm),
                               float(jres.residual_norm), rtol=1e-4,
                               atol=1e-30)


# -- the solve against the JAX engine -----------------------------------------


@pytest.mark.parametrize("grid,kw,warm", [
    (GRID_2D, dict(rtol=1e-5, check_every=1), False),
    (GRID_2D, dict(rtol=1e-5, check_every=4), True),
    (GRID_2D, dict(tol=1e-2, check_every=8), False),
    (GRID_2D, dict(rtol=1e-6, maxiter=40, iter_cap=7, check_every=4), False),
    (GRID_2D, dict(tol=1e-7, maxiter=0), False),
    (GRID_3D, dict(rtol=1e-5, check_every=8), False),
    (GRID_3D, dict(rtol=1e-5, check_every=1), True),
], ids=["2d-rtol-ce1", "2d-warm-ce4", "2d-tol-ce8", "2d-iter_cap",
        "2d-maxiter0", "3d-rtol-ce8", "3d-warm-ce1"])
def test_cg_resident_matches_jax(grid, kw, warm):
    b = vec(grid, 1)
    x0 = vec(grid, 2) if warm else None
    tres, jres = both(grid, b, x0, **kw)
    assert_same(tres, jres)
    if kw.get("maxiter") == 0:
        assert int(tres.iterations) == 0
        assert not tres.x.any()
    if "iter_cap" in kw:
        assert int(tres.iterations) == 7


def test_flat_rhs_returns_flat_x():
    b = vec(GRID_2D, 3)
    _, top = ops(GRID_2D)
    grid_res = pt.cg_resident(top, torch.as_tensor(b), rtol=1e-5)
    flat = pt.cg_resident(top, torch.as_tensor(b.ravel()), rtol=1e-5)
    assert grid_res.x.shape == GRID_2D and flat.x.shape == (b.size,)
    assert torch.equal(grid_res.x.reshape(-1), flat.x)


@pytest.mark.parametrize("case", ["converged", "maxiter", "breakdown",
                                  "indefinite"])
def test_statuses_and_flags_match_jax(case):
    b = vec(GRID_2D, 4)
    kw = dict(rtol=1e-5, check_every=4)
    scale = 1.0
    if case == "maxiter":
        kw = dict(rtol=1e-6, maxiter=12, check_every=4)
    elif case == "breakdown":
        b[3, 5] = np.nan
    elif case == "indefinite":
        scale = -1.0            # negative definite: p.Ap < 0 from the start
    tres, jres = both(GRID_2D, b, scale=scale, **kw)
    want = {"converged": pt.CGStatus.CONVERGED,
            "maxiter": pt.CGStatus.MAXITER,
            "breakdown": pt.CGStatus.BREAKDOWN,
            "indefinite": pt.CGStatus.CONVERGED}[case]
    assert tres.status_enum() == want == jres.status_enum()
    assert bool(tres.indefinite) == (case == "indefinite") \
        == bool(jres.indefinite)
    if case == "breakdown":
        assert int(tres.iterations) == int(jres.iterations) == 0
    else:
        assert_same(tres, jres)


@pytest.mark.parametrize("kw", [
    dict(rtol=1e-5, maxiter=60, check_every=8),
    dict(rtol=1e-7, maxiter=40, check_every=8, iter_cap=13),
], ids=["converged", "capped"])
def test_record_history_matches_jax(kw):
    b = vec(GRID_3D, 5)
    tres, jres = both(GRID_3D, b, record_history=True, **kw)
    want = np.asarray(jres.residual_history)
    got = tres.residual_history.numpy()
    assert got.shape == want.shape == (kw["maxiter"] + 1,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert ok.sum() >= 3
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)


@pytest.mark.parametrize("maxiter,check_every,iter_cap", [
    (40, 8, None), (40, 8, 13), (10, 4, None), (0, 32, None)])
def test_expand_block_history_matches_jax(maxiter, check_every, iter_cap):
    ce = max(1, min(check_every, maxiter))
    nblocks = -(-maxiter // ce) if maxiter else 0
    hist = np.full(nblocks + 1, -1.0, np.float32)
    ran = min(3, nblocks)
    hist[:ran + 1] = np.float32(4.0) ** -np.arange(ran + 1)
    want = jresident._expand_block_history(jnp.asarray(hist), maxiter,
                                           check_every, iter_cap)
    got = tresident._expand_block_history(torch.as_tensor(hist), maxiter,
                                          check_every, iter_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid", [GRID_2D, GRID_3D])
def test_kernel_outputs_match_pallas(grid):
    """The wrapper's raw outputs (the kernel's, on the card) against the
    Pallas kernel's: flags, the block trace's sentinels, x."""
    b = vec(grid, 6)
    kw = dict(tol=0.0, rtol=1e-4, maxiter=48, check_every=8)
    jfn = jrk.cg_resident_2d if len(grid) == 2 else jrk.cg_resident_3d
    tfn = trk.cg_resident_2d if len(grid) == 2 else trk.cg_resident_3d
    want = jfn(0.7, jnp.asarray(b), interpret=True, **kw)
    got = tfn(0.7, torch.as_tensor(b), **kw)
    assert [int(v) for v in got[1:2] + got[3:6]] == \
        [int(v) for v in want[1:2] + want[3:6]]
    hist_w, hist_g = np.asarray(want[6]), got[6].numpy()
    np.testing.assert_array_equal(hist_g < 0, hist_w < 0)
    np.testing.assert_allclose(hist_g[hist_w >= 0], hist_w[hist_w >= 0],
                               rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want[0])).max())


def test_solve_engine_resident_matches_jax():
    b = vec(GRID_2D, 7)
    jop, top = ops(GRID_2D)
    jres = jp.solve(jop, jnp.asarray(b.ravel()), rtol=1e-5, check_every=4,
                    engine="resident")
    tres = pt.solve(top, torch.as_tensor(b.ravel()), rtol=1e-5,
                    check_every=4, engine="resident")
    assert_same(tres, jres)
    direct = pt.cg_resident(top, torch.as_tensor(b.ravel()), rtol=1e-5,
                            check_every=4)
    assert torch.equal(direct.x, tres.x)


# -- the gate and the routing -------------------------------------------------


@pytest.mark.parametrize("grid,fits", [
    ((1024, 1024), True), ((1448, 1448), True), ((128, 128, 128), True),
    ((7, 130), True), ((1, 1), True), ((2048, 2048), False),
    ((4096, 4096), False), ((256, 256, 256), False), ((0, 128), False)])
def test_capacity_gate(grid, fits):
    gate = (trk.supports_resident_2d if len(grid) == 2
            else trk.supports_resident_3d)
    assert trk.vmem_bytes("cpu") == 50 * 2 ** 20
    assert gate(*grid) is fits
    assert gate(*grid, itemsize=8) is False


def test_gate_override(monkeypatch):
    monkeypatch.setenv(ENV, str(5 * 16 * 128 * 4))
    assert trk.supports_resident_2d(16, 128)
    monkeypatch.setenv(ENV, str(5 * 16 * 128 * 4 - 1))
    assert not trk.supports_resident_2d(16, 128)
    monkeypatch.setenv(ENV, "lots")
    with pytest.raises(ValueError, match=ENV):
        trk.vmem_bytes()


def _pair(case):
    """(JAX operator, port operator, rhs, eligibility keywords) per case."""
    grid, dtype, kw = {
        "2d": (GRID_2D, np.float32, {}),
        "3d": (GRID_3D, np.float32, {}),
        "1024^2": ((1024, 1024), np.float32, {}),
        "128^3": ((128, 128, 128), np.float32, {}),
        "4096^2": ((4096, 4096), np.float32, {}),
        "256^3": ((256, 256, 256), np.float32, {}),
        "f64": (GRID_2D, np.float64, {}),
        "rhs-f64": (GRID_2D, np.float32, {"b": np.float64}),
        "x0-f32": (GRID_2D, np.float32, {"x0": np.float32}),
        "x0-f64": (GRID_2D, np.float32, {"x0": np.float64}),
        "history": (GRID_2D, np.float32, {"record_history": True}),
        "m": (GRID_2D, np.float32, {"m": object()}),
        "compensated": (GRID_2D, np.float32, {"compensated": True}),
        "checkpoint": (GRID_2D, np.float32, {"return_checkpoint": True}),
    }[case]
    jop, top = ops(grid, dtype=dtype)
    kw = dict(kw)
    b = None
    if "b" in kw:
        b = vec(jop.n, 8, kw.pop("b"))
    if "x0" in kw:
        kw["x0"] = vec(jop.n, 9, kw["x0"])
    return jop, top, b, kw


def _port_kw(kw):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


CASES = ["2d", "3d", "1024^2", "128^3", "4096^2", "256^3", "f64", "rhs-f64",
         "x0-f32", "x0-f64", "history", "m", "compensated", "checkpoint"]


@pytest.mark.parametrize("case", CASES)
def test_resident_eligible_agrees_with_jax(case):
    jop, top, b, kw = _pair(case)
    m = kw.pop("m", None)
    want = jresident.resident_eligible(
        jop, None if b is None else jnp.asarray(b), m, **kw)
    got = tresident.resident_eligible(
        top, None if b is None else torch.as_tensor(b), m, **_port_kw(kw))
    assert got == want
    assert tresident.supports_resident(top) == jp.supports_resident(jop)


@pytest.mark.parametrize("budget,fits", [(30_000, False), (60_000, True)])
def test_resident_eligible_agrees_with_jax_under_override(monkeypatch,
                                                          budget, fits):
    """The override moves both gates (16x128 f32: the port needs 40,960
    bytes, the JAX package 57,344)."""
    monkeypatch.setenv(ENV, str(budget))
    jop, top = ops(GRID_2D)
    assert jresident.resident_eligible(jop) is fits
    assert tresident.resident_eligible(top) is fits


def _jax_auto(jop, b, x0, kw):
    """The engine the JAX ``solve(engine="auto")`` takes on a TPU."""
    if jresident.resident_eligible(jop, b, None, x0=x0, **kw):
        return "resident"
    if jstreaming.streaming_eligible(jop, b, None, x0=x0, **kw):
        return "streaming"
    return "general"


@pytest.mark.parametrize("case", ["2d", "3d", "f64", "rhs-f64", "x0-f32",
                                  "x0-f64", "history", "override"])
def test_auto_routes_as_jax_on_a_hopper_card(monkeypatch, case):
    """With the device rule saying "Hopper", auto picks resident, then
    streaming, then general exactly where the JAX package picks them on
    a TPU."""
    if case == "override":
        monkeypatch.setenv(ENV, "1024")
        jop, top, b, kw = _pair("2d")
    else:
        jop, top, b, kw = _pair(case)
    if b is None:
        b = vec(jop.n, 10, np.float64 if case == "f64" else np.float32)
    x0 = kw.pop("x0", None)
    want = _jax_auto(jop, jnp.asarray(b), None if x0 is None
                     else jnp.asarray(x0), kw)
    taken = []

    def recorder(name):
        def run(*args, **kwargs):
            taken.append(name)
        return run

    monkeypatch.setattr(tcg, "is_hopper", lambda device: True)
    monkeypatch.setattr(tresident, "cg_resident", recorder("resident"))
    monkeypatch.setattr(tstreaming, "cg_streaming", recorder("streaming"))
    monkeypatch.setattr(tcg, "cg", recorder("general"))
    pt.solve(top, torch.as_tensor(b), None if x0 is None
             else torch.as_tensor(x0), engine="auto", **kw)
    assert taken == [want]
    assert want == {"2d": "resident", "3d": "resident", "x0-f32": "resident",
                    "history": "streaming", "override": "streaming"}.get(
                        case, "general")


@pytest.mark.parametrize("case", ["4096^2", "256^3"])
def test_auto_keeps_large_grids_on_streaming(case):
    jop, top, _, _ = _pair(case)
    assert not tresident.resident_eligible(top)
    assert not jresident.resident_eligible(jop)
    assert tstreaming.streaming_eligible(top)
    assert jstreaming.streaming_eligible(jop)


# -- the in-kernel Chebyshev (B10 at degree > 0) ------------------------------


@pytest.fixture(scope="module")
def jax_lmax():
    """The JAX package's ``estimate_lmax`` of each stencil, computed once
    for the module (several cases build a Chebyshev over the same
    grid)."""
    from cuda_mpi_parallel_tpu.models.precond import estimate_lmax

    cache = {}

    def lmax(jop):
        key = (tuple(jop.grid), float(np.asarray(jop.scale)))
        if key not in cache:
            cache[key] = float(estimate_lmax(jop))
        return cache[key]
    return lmax


def chebyshev_pair(jop, top, degree, jax_lmax):
    """One JAX Chebyshev over ``jop`` and the port's over ``top`` with the
    same interval (the JAX estimate, carried across)."""
    from cuda_mpi_parallel_tpu.models.precond import \
        ChebyshevPreconditioner as JCheb

    jm = JCheb.from_operator(jop, degree=degree, lmax=jax_lmax(jop))
    tm = pt.ChebyshevPreconditioner(
        a=top, lmin=torch.tensor(float(jm.lmin)),
        lmax=torch.tensor(float(jm.lmax)), degree=degree)
    return jm, tm


@pytest.mark.parametrize("grid", [GRID_2D, GRID_3D])
@pytest.mark.parametrize("degree", [1, 2, 4])
def test_twin_at_degree_matches_pallas(grid, degree):
    """The twin ``csrc/resident.cu`` is held against, at each degree,
    against the Pallas kernel: iterations and flags equal, the trace's
    sentinels in the same blocks, x within 1e-5 * max|x|."""
    b = vec(grid, 11)
    lmax = 8.2 if len(grid) == 2 else 12.5     # above the spectrum
    kw = dict(tol=0.0, rtol=1e-5, maxiter=120, check_every=4,
              precond_degree=degree, lmin=lmax / 30, lmax=lmax)
    jfn = jrk.cg_resident_2d if len(grid) == 2 else jrk.cg_resident_3d
    tfn = trk.cg_resident_2d if len(grid) == 2 else trk.cg_resident_3d
    want = jfn(1.0, jnp.asarray(b), interpret=True, **kw)
    got = tfn(1.0, torch.as_tensor(b), **kw)
    assert [int(v) for v in got[1:2] + got[3:6]] == \
        [int(v) for v in want[1:2] + want[3:6]]
    assert 0 < int(got[1]) < 120 and int(got[4]) == 1   # converged
    hist_w, hist_g = np.asarray(want[6]), got[6].numpy()
    np.testing.assert_array_equal(hist_g < 0, hist_w < 0)
    np.testing.assert_allclose(hist_g[hist_w >= 0], hist_w[hist_w >= 0],
                               rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want[0])).max())


@pytest.mark.parametrize("grid,degree,warm", [
    (GRID_2D, 4, False), (GRID_2D, 1, True), (GRID_3D, 2, False)])
def test_cg_resident_with_chebyshev_matches_jax(grid, degree, warm,
                                                jax_lmax):
    jop, top = ops(grid)
    jm, tm = chebyshev_pair(jop, top, degree, jax_lmax)
    b = vec(grid, 12)
    x0 = vec(grid, 13) if warm else None
    kw = dict(rtol=1e-5, check_every=2)
    jres = jp.cg_resident(jop, jnp.asarray(b), None if x0 is None
                          else jnp.asarray(x0), m=jm, interpret=True, **kw)
    tres = pt.cg_resident(top, torch.as_tensor(b), None if x0 is None
                          else torch.as_tensor(x0), m=tm, **kw)
    assert tres.status_enum() == pt.CGStatus.CONVERGED
    assert_same(tres, jres)
    plain = pt.cg_resident(top, torch.as_tensor(b), **kw)
    assert int(tres.iterations) < int(plain.iterations)


def test_chebyshev_match_status():
    _, top = ops(GRID_2D)
    same = tpoisson.poisson_2d_operator(*GRID_2D, device="cpu")
    other_scale = tpoisson.poisson_2d_operator(*GRID_2D, scale=2.0,
                                               device="cpu")
    other_grid = tpoisson.poisson_2d_operator(16, 256, device="cpu")
    three_d = tpoisson.poisson_3d_operator(1, 16, 128, device="cpu")

    def status(op):
        m = pt.ChebyshevPreconditioner.from_operator(op, lmax=8.0)
        return tprecond._chebyshev_match_status(top, m)

    assert [status(op) for op in (top, same, other_scale, other_grid,
                                  three_d)] == \
        ["match", "match", "mismatch", "mismatch", "mismatch"]


@pytest.mark.parametrize("grid,fits", [
    ((1024, 1024), True), ((1448, 1448), False), ((1200, 1200), True),
    ((128, 128, 128), False), ((96, 96, 96), True), ((16, 128), True)])
def test_preconditioned_capacity_gate(grid, fits):
    """Seven planes within the card's L2.  The JAX package's gate (13
    planes within a TPU's VMEM; a 128 MiB fallback off a TPU) is another
    machine's, so the two are stated side by side, not held equal: both
    admit 1024^2, and off a TPU the JAX gate admits 128^3, which the
    port sends to the streaming engine."""
    gate = (trk.supports_resident_2d if len(grid) == 2
            else trk.supports_resident_3d)
    assert gate(*grid, preconditioned=True) is fits
    assert gate(*grid)                          # five planes fit each one
    jgate = (jrk.supports_resident_2d if len(grid) == 2
             else jrk.supports_resident_3d)
    if grid in ((1024, 1024), (16, 128)):
        assert jgate(*grid, preconditioned=True)
    if grid == (128, 128, 128):
        assert jgate(*grid, preconditioned=True) and not fits


def test_preconditioned_gate_error_names_seven_planes(monkeypatch):
    monkeypatch.setenv(ENV, str(6 * 16 * 128 * 4))
    _, top = ops(GRID_2D)
    b = torch.ones(GRID_2D)
    trk.cg_resident_2d(1.0, b, maxiter=2)          # five planes fit
    with pytest.raises(ValueError, match="needs 7"):
        trk.cg_resident_2d(1.0, b, maxiter=2, precond_degree=2)


def _route(monkeypatch, top, b, m, engine="auto"):
    taken = []

    def recorder(name):
        def run(*args, **kwargs):
            taken.append((name, kwargs.get("m")))
        return run

    monkeypatch.setattr(tcg, "is_hopper", lambda device: True)
    monkeypatch.setattr(tresident, "cg_resident", recorder("resident"))
    monkeypatch.setattr(tstreaming, "cg_streaming", recorder("streaming"))
    monkeypatch.setattr(tcg, "cg", recorder("general"))
    pt.solve(top, b, m=m, engine=engine)
    assert len(taken) == 1 and taken[0][1] is m
    return taken[0][0]


@pytest.mark.parametrize("case", ["chebyshev", "override", "jacobi",
                                  "foreign-scale", "foreign-grid"])
def test_auto_routes_preconditioned_solves_as_jax(monkeypatch, case,
                                                  jax_lmax):
    jop, top = ops(GRID_2D)
    b = vec(jop.n, 14)
    jm, tm = chebyshev_pair(jop, top, 4, jax_lmax)
    if case == "override":
        # seven planes of 16x128 f32 are 57,344 bytes: both gates refuse
        monkeypatch.setenv(ENV, str(7 * 16 * 128 * 4 - 1))
    elif case == "jacobi":
        jm = jp.models.JacobiPreconditioner.from_operator(jop)
        tm = pt.JacobiPreconditioner.from_operator(top)
    elif case.startswith("foreign"):
        kw = dict(scale=2.0) if case == "foreign-scale" else {}
        grid = GRID_2D if kw else (32, 64)
        jforeign, tforeign = ops(grid, **kw)
        jm, _ = chebyshev_pair(jforeign, tforeign, 4, jax_lmax)
        tm = pt.ChebyshevPreconditioner(a=tforeign, lmin=tm.lmin,
                                        lmax=tm.lmax, degree=4)
    want = _jax_auto_m(jop, jnp.asarray(b), jm)
    assert _route(monkeypatch, top, torch.as_tensor(b), tm) == want
    assert want == {"chebyshev": "resident",
                    "override": "streaming"}.get(case, "general")


def _jax_auto_m(jop, b, m):
    if jresident.resident_eligible(jop, b, m):
        return "resident"
    if jstreaming.streaming_eligible(jop, b, m):
        return "streaming"
    return "general"


@pytest.mark.parametrize("engine", ["resident", "streaming"])
@pytest.mark.parametrize("case", ["jacobi", "foreign"])
def test_explicit_fused_engines_refuse_other_preconditioners(engine, case):
    """The JAX package's refusal, word for word where it names m."""
    _, top = ops(GRID_2D)
    if case == "jacobi":
        m = pt.JacobiPreconditioner.from_operator(top)
    else:
        m = pt.ChebyshevPreconditioner.from_operator(
            tpoisson.poisson_2d_operator(*GRID_2D, scale=3.0, device="cpu"),
            lmax=24.0)
    b = torch.ones(top.n)
    with pytest.raises(ValueError, match=f"engine='{engine}' needs .*m=None "
                       "or a Chebyshev preconditioner built over this "
                       "operator"):
        pt.solve(top, b, m=m, engine=engine)
    direct = pt.cg_resident if engine == "resident" else pt.cg_streaming
    with pytest.raises(TypeError if case == "jacobi" else ValueError,
                       match="ChebyshevPreconditioner" if case == "jacobi"
                       else "same stencil operator"):
        direct(top, b, m=m)


# -- refusals -----------------------------------------------------------------


@pytest.mark.parametrize("call,error,match", [
    (lambda op, b: pt.cg_resident(
        op, b, m=pt.JacobiPreconditioner.from_operator(op)),
     TypeError, "ChebyshevPreconditioner"),
    # cg1 (ROADMAP A3) now runs, as the JAX package's does: error None
    # holds the port to the same call of the JAX package (the third
    # entry), on a seeded rhs as the parity tests above (with b = 1 the
    # JAX package's own resident and general cg1 end 0.5 % apart in
    # ||r||, which assert_same's 1e-4 cannot hold)
    (lambda op, b: pt.cg_resident(op, b, method="cg1", rtol=1e-5), None,
     lambda op, b: jp.cg_resident(op, b, method="cg1", rtol=1e-5,
                                  interpret=True)),
    (lambda op, b: pt.solve(op, b, engine="resident", method="cg1",
                            rtol=1e-5), None,
     lambda op, b: jp.solve(op, b, engine="resident", method="cg1",
                            rtol=1e-5)),
    # the JAX cg_resident's message (test_minres_refusal_is_the_jax_one)
    (lambda op, b: pt.cg_resident(op, b, method="minres"),
     ValueError, "resident method must be 'cg' or 'cg1', got 'minres'"),
    (lambda op, b: trk.cg_resident_2d(1.0, b.reshape(GRID_2D),
                                      precond_degree=2, method="cg1"),
     ValueError, "unpreconditioned"),
    (lambda op, b: pt.cg_resident(op, b.double()), ValueError, "float32"),
    (lambda op, b: pt.cg_resident(tpoisson.poisson_1d_csr(8, device="cpu"),
                                  b[:8]), TypeError, "Stencil2D"),
    (lambda op, b: pt.solve(tpoisson.poisson_1d_csr(8, device="cpu"),
                            b[:8].double(), engine="resident"),
     ValueError, "engine='resident'"),
    (lambda op, b: tresident.cg_resident_df64(
        tpoisson.poisson_1d_csr(8, device="cpu"), b[:8]), TypeError,
     "Stencil2D or Stencil3D"),
], ids=["m", "cg1", "solve-cg1", "unknown-method", "degree", "f64-rhs",
        "csr", "solve-csr", "df64"])
def test_refusals(call, error, match):
    jop, top = ops(GRID_2D)
    if error is None:
        b = vec(top.n, 3)
        assert_same(call(top, torch.as_tensor(b)), match(jop, jnp.asarray(b)))
        return
    with pytest.raises(error, match=match):
        call(top, torch.ones(top.n))


def test_minres_refusal_is_the_jax_one():
    jop, top = ops(GRID_2D)
    with pytest.raises(ValueError) as jerr:
        jp.cg_resident(jop, jnp.ones(top.n, jnp.float32), method="minres",
                       interpret=True)
    with pytest.raises(ValueError) as err:
        pt.cg_resident(top, torch.ones(top.n), method="minres")
    assert str(err.value) == str(jerr.value)


def test_explicit_resident_past_the_gate_raises(monkeypatch):
    monkeypatch.setenv(ENV, "1024")
    _, top = ops(GRID_2D)
    b = torch.ones(top.n)
    with pytest.raises(ValueError, match="engine='resident'"):
        pt.solve(top, b, engine="resident")
    with pytest.raises(ValueError, match=ENV):
        pt.cg_resident(top, b)
    # auto takes the general engine off the card
    assert int(pt.solve(top, b, rtol=1e-3, engine="auto").iterations) > 0
