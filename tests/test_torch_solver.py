"""The port's solvers against the JAX package's ``solve()``.

Every system is built once on the JAX side and carried across by
``cuda_mpi_parallel_tpu_torch.convert.operator_from_arrays``, so both
packages solve the same operator; right-hand sides and warm starts are
numpy-seeded and handed to both.  The JAX streaming engine and the
``backend="pallas"`` stencils run their Pallas kernels in interpret mode;
the port runs the kernels' plain twins (the tensors lie on the CPU).

Parity contract: equal iteration counts and statuses at equal
tolerance; x equal to reduction-order rounding (``1e-5 * max|x|`` in
f32, ``1e-10 * max|x|`` in f64); the oracle to 1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import convert
from cuda_mpi_parallel_tpu_torch.models import poisson as tpoisson
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk

torch.set_num_threads(1)


def port(op):
    """The port's copy of JAX operator ``op``, on the CPU."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(op)
    arrays = {jax.tree_util.keystr(path): np.asarray(leaf)
              for path, leaf in leaves}
    meta = {f: getattr(op, f) for f in ("grid", "backend", "_dtype_name")
            if hasattr(op, f)}
    if isinstance(op, jp.CSRMatrix):
        meta["shape"] = op.shape
    return convert.operator_from_arrays(type(op).__name__, arrays, meta,
                                        device="cpu")


def rhs(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def assert_same_solve(tres, jres, tol):
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.status) == int(jres.status)
    assert bool(tres.converged) == bool(jres.converged)
    want = np.asarray(jres.x)
    got = tres.x.numpy().reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- the reference's oracle ---------------------------------------------------


def test_oracle_three_iterations_indefinite():
    ja, jb, x_exp = jpoisson.oracle_system()
    a = port(ja)
    res = pt.solve(a, torch.as_tensor(np.array(jb)), engine="general")
    jres = jp.solve(ja, jb)
    assert int(res.iterations) == int(jres.iterations) == 3
    assert res.status_enum() == pt.CGStatus.CONVERGED
    assert bool(res.indefinite) and bool(jres.indefinite)
    np.testing.assert_allclose(res.x.numpy(), x_exp, rtol=0, atol=1e-12)


def test_oracle_system_equals_jax_oracle():
    a, b, x_exp = tpoisson.oracle_system(device="cpu")
    ja, jb, _ = jpoisson.oracle_system()
    np.testing.assert_array_equal(a.to_dense().numpy(),
                                  np.asarray(ja.to_dense()))
    res = pt.cg(a, b)
    assert int(res.iterations) == 3
    np.testing.assert_allclose(res.x.numpy(), x_exp, rtol=0, atol=1e-12)


# -- the streaming engine -----------------------------------------------------


@pytest.mark.parametrize("grid", [(16, 128), (8, 8, 128)])
def test_streaming_matches_jax(grid):
    jop = (jpoisson.poisson_2d_operator(*grid, dtype=jnp.float32)
           if len(grid) == 2
           else jpoisson.poisson_3d_operator(*grid, dtype=jnp.float32))
    b = rhs(jop.n, np.float32, seed=len(grid))
    jres = jp.solve(jop, jnp.asarray(b), rtol=1e-5, engine="streaming")
    op = port(jop)
    res = pt.solve(op, torch.as_tensor(b), rtol=1e-5, engine="streaming")
    assert res.status_enum() == pt.CGStatus.CONVERGED
    assert_same_solve(res, jres, 1e-5)
    direct = pt.cg_streaming(op, torch.as_tensor(b), rtol=1e-5)
    assert torch.equal(direct.x, res.x)


@pytest.mark.parametrize("grid", [(16, 128), (8, 8, 128)])
@pytest.mark.parametrize("degree", [1, 2, 4])
def test_streaming_chebyshev_matches_jax(grid, degree):
    """The streamed Chebyshev (degree 1 folded into passes A/B; B5 steps
    from degree 2) against the JAX engine's, with the interval carried
    across; equal iterations at check_every=1."""
    from cuda_mpi_parallel_tpu.models.precond import \
        ChebyshevPreconditioner as JCheb

    jop = (jpoisson.poisson_2d_operator(*grid, dtype=jnp.float32)
           if len(grid) == 2
           else jpoisson.poisson_3d_operator(*grid, dtype=jnp.float32))
    jm = JCheb.from_operator(jop, degree=degree)
    op = port(jop)
    m = pt.ChebyshevPreconditioner(a=op, lmin=torch.tensor(float(jm.lmin)),
                                   lmax=torch.tensor(float(jm.lmax)),
                                   degree=degree)
    b = rhs(jop.n, np.float32, seed=5)
    jres = jp.solve(jop, jnp.asarray(b), rtol=1e-5, m=jm, engine="streaming")
    hk.reset_launches()
    res = pt.solve(op, torch.as_tensor(b), rtol=1e-5, m=m, engine="streaming")
    assert sum(hk.LAUNCHES.values()) == 0      # the twins, on the CPU
    assert res.status_enum() == pt.CGStatus.CONVERGED
    assert_same_solve(res, jres, 1e-5)
    general = pt.solve(op, torch.as_tensor(b), rtol=1e-5, m=m)
    assert int(general.iterations) == int(res.iterations)
    blocked = pt.cg_streaming(op, torch.as_tensor(b), rtol=1e-5, m=m,
                              check_every=8)
    blocked_general = pt.cg(op, torch.as_tensor(b), rtol=1e-5, m=m,
                            check_every=8)
    assert int(blocked.iterations) % 8 == 0
    assert int(blocked.iterations) == int(blocked_general.iterations)
    np.testing.assert_allclose(
        blocked.x.numpy(), blocked_general.x.numpy(), rtol=0,
        atol=1e-5 * float(blocked_general.x.abs().max()))


def test_streaming_chebyshev_steps_per_iteration(monkeypatch):
    """degree k: k - 1 B5 steps at init and after every pass B, the first
    taking r and the last summing rho; degree 1 takes none and sums rho
    in pass B."""
    from cuda_mpi_parallel_tpu_torch.solver import streaming as tstreaming

    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    b = torch.as_tensor(rhs(op.n, np.float32, seed=6))
    calls = []
    real_step, real_b = tstreaming.fused_cheb_step, tstreaming.fused_cg_pass_b

    def step(*args, first, last, **kw):
        calls.append(("step", first, last))
        return real_step(*args, first=first, last=last, **kw)

    def pass_b(*args, **kw):
        calls.append(("b", kw.get("with_rz", False)))
        return real_b(*args, **kw)

    monkeypatch.setattr(tstreaming, "fused_cheb_step", step)
    monkeypatch.setattr(tstreaming, "fused_cg_pass_b", pass_b)
    for degree in (1, 2, 4):
        calls.clear()
        m = pt.ChebyshevPreconditioner.from_operator(op, degree=degree,
                                                     lmax=8.2)
        res = pt.cg_streaming(op, b, tol=0.0, maxiter=3, m=m)
        its = int(res.iterations)
        steps = [c for c in calls if c[0] == "step"]
        assert its == 3
        assert len(steps) == (degree - 1) * (its + 1)
        if degree == 1:
            assert calls == [("b", True)] * its
        else:
            per = [(j == 0, j == degree - 2) for j in range(degree - 1)]
            assert [c[1:] for c in steps] == per * (its + 1)


def test_streaming_grid_shaped_rhs_returns_grid():
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    b = torch.as_tensor(rhs(op.n, np.float32).reshape(16, 128))
    res = pt.cg_streaming(op, b, rtol=1e-5)
    flat = pt.cg_streaming(op, b.reshape(-1), rtol=1e-5)
    assert res.x.shape == (16, 128) and flat.x.shape == (16 * 128,)
    assert torch.equal(res.x.reshape(-1), flat.x)
    assert torch.equal(b, torch.as_tensor(rhs(op.n, np.float32)).reshape(
        16, 128))                                   # b is not clobbered


# -- the general engine -------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_general_matches_jax(backend, dtype):
    jop = jpoisson.poisson_2d_operator(16, 128, dtype=dtype, backend=backend)
    b = rhs(jop.n, dtype, seed=3)
    jres = jp.solve(jop, jnp.asarray(b), rtol=1e-6)
    op = port(jop)
    assert op.backend == backend
    res = pt.solve(op, torch.as_tensor(b), rtol=1e-6)
    assert_same_solve(res, jres, 1e-5 if dtype == np.float32 else 1e-10)


def test_general_csr_matches_stencil():
    jcsr = jpoisson.poisson_3d_csr(4, 8, 16)
    b = rhs(jcsr.n, np.float64, seed=4)
    jres = jp.solve(jcsr, jnp.asarray(b), rtol=1e-8)
    res = pt.solve(port(jcsr), torch.as_tensor(b), rtol=1e-8)
    assert_same_solve(res, jres, 1e-10)
    csr = tpoisson.poisson_3d_csr(4, 8, 16, device="cpu")
    assert torch.equal(csr.to_dense(), port(jcsr).to_dense())


# -- check blocks, caps, history, warm start ----------------------------------


@pytest.mark.parametrize("engine", ["general", "streaming"])
def test_check_every_block_semantics(engine):
    jop = jpoisson.poisson_2d_operator(16, 128, dtype=jnp.float32)
    b = rhs(jop.n, np.float32, seed=5)
    op = port(jop)
    for kw in (dict(check_every=4, maxiter=10),
               dict(check_every=4, maxiter=40, iter_cap=7),
               dict(check_every=4, rtol=1e-3)):
        jres = jp.solve(jop, jnp.asarray(b), engine=engine, **kw)
        res = pt.solve(op, torch.as_tensor(b), engine=engine, **kw)
        assert_same_solve(res, jres, 1e-5)
    # iterates past convergence inside a block are frozen, and the count
    # lands on the block boundary
    one = pt.solve(op, torch.as_tensor(b), engine=engine, rtol=1e-3)
    four = pt.solve(op, torch.as_tensor(b), engine=engine, rtol=1e-3,
                    check_every=4)
    assert int(four.iterations) % 4 == 0
    assert int(one.iterations) <= int(four.iterations) \
        < int(one.iterations) + 4


@pytest.mark.parametrize("engine", ["general", "streaming"])
def test_record_history_matches_jax(engine):
    jop = jpoisson.poisson_3d_operator(4, 8, 128, dtype=jnp.float32)
    b = rhs(jop.n, np.float32, seed=6)
    jres = jp.solve(jop, jnp.asarray(b), rtol=1e-4, maxiter=60,
                    engine=engine, record_history=True)
    res = pt.solve(port(jop), torch.as_tensor(b), rtol=1e-4, maxiter=60,
                   engine=engine, record_history=True)
    want = np.asarray(jres.residual_history)
    got = res.residual_history.numpy()
    assert got.shape == want.shape == (61,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4)


@pytest.mark.parametrize("engine", ["general", "streaming"])
def test_x0_warm_start_matches_jax(engine):
    jop = jpoisson.poisson_2d_operator(16, 128, dtype=jnp.float32,
                                       backend="pallas")
    b = rhs(jop.n, np.float32, seed=7)
    x0 = rhs(jop.n, np.float32, seed=8)
    jres = jp.solve(jop, jnp.asarray(b), jnp.asarray(x0), rtol=1e-5,
                    engine=engine)
    x0_t = torch.as_tensor(x0)
    res = pt.solve(port(jop), torch.as_tensor(b), x0_t, rtol=1e-5,
                   engine=engine)
    assert_same_solve(res, jres, 1e-5)
    assert torch.equal(x0_t, torch.as_tensor(x0))   # x0 is not clobbered


# -- operators, statuses, other exits -----------------------------------------


def _spd(n, seed):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


@pytest.mark.parametrize("kind", ["dense", "csr", "stencil2d", "stencil3d"])
def test_operators_match_jax(kind):
    if kind == "dense":
        jop = jp.DenseOperator(a=jnp.asarray(_spd(12, 1)))
    elif kind == "csr":
        jop = jpoisson.poisson_2d_csr(4, 8, scale=0.5)
    elif kind == "stencil2d":
        jop = jpoisson.poisson_2d_operator(16, 128, scale=0.3,
                                           dtype=jnp.float64)
    else:
        jop = jpoisson.poisson_3d_operator(4, 8, 128, scale=0.3,
                                           dtype=jnp.float64)
    op = port(jop)
    assert op.shape == jop.shape
    v = rhs(jop.n, np.float64, seed=10)
    np.testing.assert_allclose(op.matvec(torch.as_tensor(v)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(v))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(op.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    if jop.n <= 64:
        np.testing.assert_allclose(op.to_dense().numpy(),
                                   np.asarray(jop.to_dense()), atol=1e-12)


def test_dense_solve_matches_jax():
    a = _spd(24, 2)
    b = rhs(24, np.float64, seed=11)
    jres = jp.solve(jnp.asarray(a), jnp.asarray(b), rtol=1e-10)
    res = pt.solve(torch.as_tensor(a), torch.as_tensor(b), rtol=1e-10)
    assert_same_solve(res, jres, 1e-10)


@pytest.mark.parametrize("engine", ["general", "streaming"])
@pytest.mark.parametrize("case", ["maxiter", "breakdown"])
def test_other_exits_match_jax(engine, case):
    jop = jpoisson.poisson_2d_operator(16, 128, dtype=jnp.float32)
    b = rhs(jop.n, np.float32, seed=12)
    kw = dict(maxiter=5, rtol=1e-6)
    if case == "breakdown":
        b[7] = np.nan
        kw = dict(maxiter=20)
    jres = jp.solve(jop, jnp.asarray(b), engine=engine, **kw)
    res = pt.solve(port(jop), torch.as_tensor(b), engine=engine, **kw)
    want = (pt.CGStatus.MAXITER if case == "maxiter"
            else pt.CGStatus.BREAKDOWN)
    assert res.status_enum() == want == int(jres.status)
    assert int(res.iterations) == int(jres.iterations)


def test_status_codes_match_jax():
    from cuda_mpi_parallel_tpu.solver.status import CGStatus as JStatus

    assert [(s.name, int(s), s.describe()) for s in pt.CGStatus] == \
        [(s.name, int(s), s.describe()) for s in JStatus]


@pytest.mark.parametrize("grid,dtype", [
    ((256, 256, 256), torch.float32), ((128, 256, 256), torch.float32),
    ((4096, 4096), torch.float32), ((2048, 4096), torch.float32),
    ((2048, 4096), torch.float64)])
def test_auto_backend_decides_like_jax(grid, dtype):
    from cuda_mpi_parallel_tpu.models.operators import \
        _resolve_backend as jresolve

    cls = pt.Stencil2D if len(grid) == 2 else pt.Stencil3D
    op = cls.create(*grid, dtype=dtype, backend="auto", device="cpu")
    assert op.backend == jresolve("auto", grid, dtype.itemsize, True)


def test_convert_refuses_unported_kinds():
    # ELLMatrix and DIAMatrix crossed over with their port (ROADMAP A2);
    # the multigrid preconditioner waits for A8
    with pytest.raises(TypeError, match="MultigridPreconditioner"):
        convert.operator_from_arrays("MultigridPreconditioner", {}, {},
                                     device="cpu")


# -- routing and refusals -----------------------------------------------------


def test_auto_off_hopper_takes_the_general_engine():
    op = tpoisson.poisson_3d_operator(4, 8, 128, device="cpu")
    b = torch.as_tensor(rhs(op.n, np.float32, seed=9))
    hk.reset_launches()
    auto = pt.solve(op, b, rtol=1e-5, engine="auto")
    general = pt.solve(op, b, rtol=1e-5)
    assert torch.equal(auto.x, general.x)
    assert sum(hk.LAUNCHES.values()) == 0


# the ids keep their first names; cases 0 and 3 named m= until every
# engine took it.  The A3 cases are ported and now do what the JAX solve()
# does there: item None runs and takes the JAX iteration count and
# status; ValueError is the JAX refusal (a string m= is no Chebyshev
# preconditioner, so the resident engine refuses it; minres, ported with
# A11, refuses any m=).  A string item is an argument still to be
# ported, named in a NotImplementedError.
@pytest.mark.parametrize("kwargs,item", [
    pytest.param(dict(engine="resident", m="chebyshev", method="cg1"),
                 ValueError, id="kwargs0-A8"),
    pytest.param(dict(method="cg1"), None, id="kwargs1-A3"),
    pytest.param(dict(method="pipecg"), None, id="kwargs2-A3"),
    pytest.param(dict(m="jacobi", method="minres"), ValueError,
                 id="kwargs3-A8"),
    pytest.param(dict(compensated=True), None, id="kwargs4-A3"),
    pytest.param(dict(return_checkpoint=True), None, id="kwargs5-A3"),
    pytest.param(dict(flight="stride"), "A9", id="kwargs6-A9"),
    pytest.param(dict(fault="plan"), "A15", id="kwargs7-A15"),
    pytest.param(dict(deflate="space"), "A14", id="kwargs8-A14")])
def test_unported_arguments_name_their_roadmap_item(kwargs, item):
    op = tpoisson.poisson_2d_operator(16, 128, device="cpu")
    if item is None:
        # at an rtol well above f32 rounding: the default absolute tol
        # 1e-7 is 2e-9 of ||b|| here, where two summation orders part
        kwargs = dict(kwargs, tol=0.0, rtol=1e-5)
        jop = jpoisson.poisson_2d_operator(16, 128, dtype=np.float32)
        res = pt.solve(op, torch.ones(op.n), **kwargs)
        jres = jp.solve(jop, jnp.ones(op.n, jnp.float32), **kwargs)
        assert int(res.iterations) == int(jres.iterations) > 0
        assert int(res.status) == int(jres.status)
        assert (res.checkpoint is None) == (jres.checkpoint is None)
        return
    if item is ValueError:
        jop = jpoisson.poisson_2d_operator(16, 128, dtype=np.float32)
        jkw, match = kwargs, "engine='resident'"
        if kwargs.get("method") == "minres":
            # each package's Jacobi object (the JAX solve takes no string)
            match = "method='minres' supports m=None"
            jkw = dict(kwargs, m=jp.JacobiPreconditioner.from_operator(jop))
            kwargs = dict(kwargs,
                          m=pt.JacobiPreconditioner.from_operator(op))
        with pytest.raises(ValueError, match=match):
            jp.solve(jop, jnp.ones(op.n, jnp.float32), **jkw)
        with pytest.raises(ValueError, match=match):
            pt.solve(op, torch.ones(op.n), **kwargs)
        return
    with pytest.raises(NotImplementedError, match=item):
        pt.solve(op, torch.ones(op.n), **kwargs)


def test_streaming_refuses_what_it_cannot_run():
    op64 = tpoisson.poisson_2d_operator(16, 128, dtype=torch.float64,
                                        device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        pt.solve(op64, torch.ones(op64.n, dtype=torch.float64),
                 engine="streaming")
    csr = tpoisson.poisson_1d_csr(8, device="cpu")
    with pytest.raises(TypeError):
        pt.cg_streaming(csr, torch.ones(8))
    with pytest.raises(ValueError, match="engine"):
        pt.solve(csr, torch.ones(8), engine="fast")
