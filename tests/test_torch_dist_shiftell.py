"""The port's ring shift-ELL lanes against the JAX package's.

``parallel.solve_distributed(csr_comm="ring-shiftell")`` (the ring
schedule with each step's slabs one call of the hand SpMV B8, its plain
twin on the CPU) and the assembled-CSR lane of
``parallel.solve_distributed_df64`` (the same ring on B9, in float64),
on stacked meshes of P CPU shards (``make_mesh(P, devices=["cpu"] *
P)``) and on a 2-rank gloo process group; the JAX package on meshes of
the 8 virtual CPU devices ``tests/conftest.py`` sets up.

Carried over: ``tests/test_dist_shiftell.py`` (``TestRingPartitionShiftELL``,
and ``TestSolveRingShiftELL``'s cases as parity tests) and
``tests/test_df64_dist.py``'s ``TestRingShiftELLDF64`` and
``TestChebyshevDF64Dist::test_ring_csr_chebyshev``.

References.  The JAX package's own ring-shiftell solves run the Pallas
kernel in interpret mode inside ``shard_map``: about 8 s a solve alone
on a CPU host, more under the suite's load, so this module calls none.
The JAX ``csr_comm="ring"`` lane (the same schedule, XLA's gather) and
the single-device ``solve`` stand in for the f32 lane, the JAX
single-device ``cg_df64`` on the ``CSRMatrix`` (its XLA path) for the
f64 lane; each is computed once a module (``jax_refs``).  The
partitions are host numpy in both packages and are compared exactly.

Tolerances: counts within 2 of the JAX references and x to the JAX
tests' own margins; within the port, one shard is bit-equal to the
single-device ``ShiftELLMatrix`` (``ShiftELLDF64Matrix``) solve, and a
stacked step product is bit-equal to the owners' separate products.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_mpi_parallel_tpu as jp
from cuda_mpi_parallel_tpu import parallel as jpar
from cuda_mpi_parallel_tpu.models import poisson as jpoisson
from cuda_mpi_parallel_tpu.models import precond as jprecond
from cuda_mpi_parallel_tpu.models.fem import random_fem_2d as jfem
from cuda_mpi_parallel_tpu.parallel import partition as jpart
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.ops.cuda import spmv as hk_spmv
from cuda_mpi_parallel_tpu_torch.parallel import comm as tcomm
from cuda_mpi_parallel_tpu_torch.parallel import dist_cg as tdist
from cuda_mpi_parallel_tpu_torch.parallel import partition as tpart

import torch_df64_ranks as ranks

torch.set_num_threads(1)

X_TOL = 2e-5     # f32 x against the JAX ring lane, relative to max|x|


def mesh(n):
    return tpar.make_mesh(n, devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def matrix(name, dtype=np.float32):
    """The JAX matrix and the same arrays as the port's CPU CSRMatrix
    (built once a module; no test writes to them)."""
    if name.startswith("poisson"):
        nx, ny = (int(v) for v in name[len("poisson"):].split("x"))
        ja = jpoisson.poisson_2d_csr(nx, ny, dtype=dtype)
    else:
        n, seed = (int(v) for v in name[len("fem"):].split("s"))
        ja = jfem(n, seed=seed, dtype=dtype)
    ta = pt.CSRMatrix.from_arrays(np.asarray(ja.data), np.asarray(ja.indices),
                                  np.asarray(ja.indptr), ja.shape,
                                  device="cpu")
    return ja, ta


@functools.lru_cache(maxsize=None)
def system(name, seed, dtype=np.float32):
    """``(ja, ta, x_true, b)`` with b = A x_true in float64, rounded to
    the matrix dtype (built once a module)."""
    ja, ta = matrix(name, dtype)
    x_true = np.random.default_rng(seed).standard_normal(ta.n)
    dense = np.asarray(jnp.asarray(ja.to_dense()), np.float64)
    return ja, ta, x_true, (dense @ x_true).astype(dtype)


@pytest.fixture(scope="module")
def jax_refs():
    """Each JAX reference solve once a module, by its arguments."""
    cache = {}

    def run(kind, name, seed, n=None, dtype=np.float32, **kw):
        key = (kind, name, seed, n, dtype, tuple(sorted(kw.items())))
        if key not in cache:
            ja, _, _, b = system(name, seed, dtype)
            if kind == "ring":
                cache[key] = jpar.solve_distributed(
                    ja, jnp.asarray(b), mesh=jpar.make_mesh(n),
                    csr_comm="ring", **kw)
            elif kind == "solve":
                pc = kw.pop("preconditioner", None)
                m = (None if pc is None else
                     jp.JacobiPreconditioner.from_operator(ja)
                     if pc == "jacobi" else
                     jprecond.ChebyshevPreconditioner.from_operator(ja))
                cache[key] = jp.solve(ja, jnp.asarray(b), m=m, **kw)
            else:
                cache[key] = jp.cg_df64(ja, b, **kw)
        return cache[key]
    return run


# -- 1. the partition against the JAX package's ------------------------------


PARTITIONS = [(name, n) for name in ("poisson24x24", "fem333s7", "fem600s5",
                                     "fem900s4") for n in (4, 8)]


@pytest.mark.parametrize("name,n", PARTITIONS)
def test_partition_matches_jax(name, n):
    """Every (owner, step) slab unpacks to the JAX ``ring_partition_csr``
    slab's live entries, exactly and in order; the diagonal, the
    geometry and the value mass are the JAX ``ring_partition_shiftell``'s
    (carried over: ``test_slab_values_conserved``, ``test_diag_matches``)."""
    ja, ta = matrix(name)
    parts = tpart.ring_partition_shiftell(ta, n)
    ring = jpart.ring_partition_csr(ja, n)
    # h=2: the sheet height shapes neither the diagonal nor the geometry
    # nor the mass, and spares the JAX packer's auto-tuning
    jsell = jpart.ring_partition_shiftell(ja, n, h=2)
    mass = 0.0
    for t in range(n):
        for s in range(n):
            indptr, cols, data = hk_spmv.unpack_sliced_ell(hk_spmv.SlicedELL(
                vals=parts.vals[t][s], cols=parts.cols[t][s],
                slice_ptr=parts.slice_ptr[t][s], n=parts.n_local))
            d = np.asarray(ring.data[t][s])
            live = d != 0
            rows = np.repeat(np.arange(parts.n_local), np.diff(indptr))
            assert np.array_equal(rows, np.asarray(ring.local_rows[t][s])[live])
            assert np.array_equal(cols, np.asarray(ring.cols[t][s])[live])
            assert np.array_equal(data, d[live])
            assert data.dtype == np.float32
            mass += float(parts.vals[t][s].astype(np.float64).sum())
    assert (parts.n_local, parts.n_global_padded, parts.n_global) == \
        (jsell.n_local, jsell.n_global_padded, jsell.n_global)
    assert np.array_equal(parts.diag, jsell.diag)
    jmass = sum(float(v[:, :, :, :jsell.h, :].astype(np.float64).sum())
                for v in jsell.vals)
    np.testing.assert_allclose(mass, jmass, rtol=1e-12)
    n_pad_rows = parts.n_global_padded - parts.n_global
    np.testing.assert_allclose(
        mass, float(np.asarray(ja.data, np.float64).sum()) + n_pad_rows,
        rtol=1e-12)


def test_partition_df64_matches_jax():
    """The f64 partition: the slots of the f32 one with float64 values,
    the float64 diagonal (unit on the padding rows), and its split the
    JAX (hi, lo) planes."""
    ja, ta = matrix("fem333s7", np.float64)
    parts = tpart.ring_partition_shiftell_df64(ta, 4)
    jparts = jpart.ring_partition_shiftell_df64(ja, 4, h=2)
    f32 = tpart.ring_partition_shiftell(
        pt.CSRMatrix.from_arrays(np.asarray(ja.data, np.float32),
                                 np.asarray(ja.indices),
                                 np.asarray(ja.indptr), ja.shape,
                                 device="cpu"), 4)
    for t in range(4):
        for s in range(4):
            assert parts.vals[t][s].dtype == np.float64
            assert np.array_equal(parts.cols[t][s], f32.cols[t][s])
            assert np.array_equal(parts.slice_ptr[t][s], f32.slice_ptr[t][s])
    assert np.array_equal(parts.diag_hi, jparts.diag_hi)
    assert np.array_equal(parts.diag_lo, jparts.diag_lo)
    diag = parts.diag.reshape(-1)
    assert np.array_equal(diag[:333], np.asarray(ja.diagonal()))
    assert np.array_equal(diag[333:], np.ones(3))


def test_partition_layout_hints_and_slab_shapes():
    """``h``/``kc`` are checked and carried, never read; every slab is a
    sliced ELL of ``n_local`` rows (carried over:
    ``test_uniform_shapes_per_step`` - the per-owner shapes are ragged
    here, one launch a step packs them together)."""
    _, ta = matrix("fem900s4")
    parts = tpart.ring_partition_shiftell(ta, 4, h=2, kc=4)
    plain = tpart.ring_partition_shiftell(ta, 4)
    assert (parts.h, parts.kc) == (2, 4)
    n_slices = -(-parts.n_local // hk_spmv.SLICE)
    for t in range(4):
        for s in range(4):
            ptr = parts.slice_ptr[t][s]
            assert ptr.shape == (n_slices + 1,) and ptr.dtype == np.int64
            assert parts.vals[t][s].shape == parts.cols[t][s].shape \
                == (int(ptr[-1]),)
            assert parts.cols[t][s].dtype == np.int32
            assert np.array_equal(parts.vals[t][s], plain.vals[t][s])
    for bad in (dict(h=0), dict(kc=0), dict(h=1.5)):
        with pytest.raises(ValueError):
            tpart.ring_partition_shiftell(ta, 4, **bad)


def test_partition_row_ranges_match_jax():
    """A plan's variable row split passes through: the slabs are the JAX
    ``ring_partition_csr``'s, the diagonal scattered through the padded
    layout is the JAX ``ring_partition_shiftell``'s."""
    ja, ta = matrix("fem333s7")
    ranges = ((0, 100), (100, 250), (250, 333))
    parts = tpart.ring_partition_shiftell(ta, 3, row_ranges=ranges)
    ring = jpart.ring_partition_csr(ja, 3, row_ranges=ranges)
    jsell = jpart.ring_partition_shiftell(ja, 3, h=2, row_ranges=ranges)
    assert parts.row_ranges == ranges and parts.n_local == jsell.n_local
    assert np.array_equal(parts.diag, jsell.diag)
    for t in range(3):
        for s in range(3):
            _, cols, data = hk_spmv.unpack_sliced_ell(hk_spmv.SlicedELL(
                vals=parts.vals[t][s], cols=parts.cols[t][s],
                slice_ptr=parts.slice_ptr[t][s], n=parts.n_local))
            live = np.asarray(ring.data[t][s]) != 0
            assert np.array_equal(cols, np.asarray(ring.cols[t][s])[live])
            assert np.array_equal(data, np.asarray(ring.data[t][s])[live])


def test_stacked_step_is_the_owners_products_bit_for_bit():
    """One sliced ELL over the stacked owners (one launch a step) gives
    each owner's own product, bit for bit - the n=333 split leaves
    slices straddling two owners - and an all-empty step still writes
    zeros (config #2's step 2 at P = 4)."""
    _, ta = matrix("fem333s7")
    parts = tpart.ring_partition_shiftell(ta, 4)
    xb = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, parts.n_local)).astype(np.float32))
    for t in range(4):
        st = tpart.stack_ring_step(parts, t, range(4))
        got = hk_spmv.shift_ell_matvec(
            xb.reshape(-1), *(torch.as_tensor(v) for v in
                              (st.vals, st.cols, st.slice_ptr)), st.n)
        want = torch.cat([hk_spmv.shift_ell_matvec(
            xb[s], torch.as_tensor(parts.vals[t][s]),
            torch.as_tensor(parts.cols[t][s]),
            torch.as_tensor(parts.slice_ptr[t][s]), parts.n_local)
            for s in range(4)])
        assert torch.equal(got, want), t
    _, grid = matrix("poisson32x8")
    parts = tpart.ring_partition_shiftell(grid, 4)
    st = tpart.stack_ring_step(parts, 2, range(4))
    assert st.vals.size == 0 and int(st.slice_ptr[-1]) == 0
    y = hk_spmv.shift_ell_matvec(torch.ones(st.n), *(torch.as_tensor(v) for v
                                 in (st.vals, st.cols, st.slice_ptr)), st.n)
    assert torch.equal(y, torch.zeros(st.n))


def _repacked_step(parts, t, shard_ids):
    """The owners' step-``t`` slabs unpacked to CSR over their stacked
    rows and packed again: the general stacking."""
    n_local = parts.n_local
    indptr, indices, data = [np.zeros(1, dtype=np.int64)], [], []
    for k, s in enumerate(shard_ids):
        ip, ix, d = hk_spmv.unpack_sliced_ell(hk_spmv.SlicedELL(
            vals=parts.vals[t][s], cols=parts.cols[t][s],
            slice_ptr=parts.slice_ptr[t][s], n=n_local))
        indptr.append(ip[1:] + indptr[-1][-1])
        indices.append(ix + k * n_local)
        data.append(d)
    return hk_spmv.pack_sliced_ell(
        np.concatenate(indptr), np.concatenate(indices).astype(np.int32),
        np.concatenate(data), len(shard_ids) * n_local)


@pytest.mark.parametrize("name,dtype", [("poisson32x16", np.float32),
                                        ("poisson32x16", np.float64),
                                        ("fem333s7", np.float32)])
def test_stacked_step_is_the_repacked_one(name, dtype):
    """Owners whose rows fill whole slices stack end to end (512 rows at
    P = 4), owners that do not are repacked (333 rows): either way the
    arrays are those of the owners' slabs unpacked and packed again over
    the stacked rows, for the whole mesh and for one rank's owner."""
    _, ta = matrix(name, dtype)
    split = (tpart.ring_partition_shiftell if dtype == np.float32
             else tpart.ring_partition_shiftell_df64)
    parts = split(ta, 4)
    assert (parts.n_local % hk_spmv.SLICE == 0) == (ta.n == 512)
    for ids in ((0, 1, 2, 3), (2,)):
        for t in range(4):
            got = tpart.stack_ring_step(parts, t, ids)
            want = _repacked_step(parts, t, ids)
            assert got.n == want.n
            for field in ("vals", "cols", "slice_ptr"):
                np.testing.assert_array_equal(getattr(got, field),
                                              getattr(want, field))
                assert getattr(got, field).dtype \
                    == getattr(want, field).dtype


# -- 2. the ring operators ----------------------------------------------------


def _ring_op(parts, m, cls):
    vals, cols, ptr = tdist.ring_step_tensors(parts, m)
    return cls(vals=vals, cols=cols, slice_ptr=ptr,
               diag=torch.as_tensor(parts.diag.reshape(-1)), h=parts.h,
               kc=parts.kc, n_local=parts.n_local, axis_name="rows",
               n_shards=parts.n_shards)


@pytest.mark.parametrize("name,n", [("fem333s7", 4), ("poisson24x24", 8)])
def test_ring_matvec_matches_csr_ring_and_dense(name, n, monkeypatch):
    """``DistShiftELLRing`` on a stacked mesh: the port's ``DistCSRRing``
    to f32 rounding and the dense product; n SpMV calls and n - 1
    rotations a matvec (the JAX lane's per-device count)."""
    _, ta = matrix(name)
    parts = tpart.ring_partition_shiftell(ta, n)
    cparts = tpar.ring_partition_csr(ta, n)
    m = mesh(n)
    op = _ring_op(parts, m, tpar.DistShiftELLRing)
    as_t = lambda field: tuple(torch.as_tensor(v) for v in field)
    cop = tpar.DistCSRRing(as_t(cparts.data), as_t(cparts.cols),
                           as_t(cparts.local_rows), cparts.n_local, "rows", n)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        parts.n_global_padded).astype(np.float32))
    calls = []
    twin = hk_spmv.shift_ell_matvec_plain
    monkeypatch.setattr(hk_spmv, "shift_ell_matvec_plain",
                        lambda *a: calls.append(a[-1]) or twin(*a))
    with tcomm.bind(m):
        y = op @ x
        y_csr = cop @ x
        assert op.shape == (parts.n_global_padded,) * 2
        assert op.dtype == torch.float32 and torch.equal(
            op.diagonal(), cop.diagonal())
    assert calls == [parts.n_global_padded] * n
    assert m.comm.counts["ppermute"] == 2 * (n - 1)
    np.testing.assert_allclose(y.numpy(), y_csr.numpy(), rtol=1e-6,
                               atol=1e-5)
    dense = ta.to_dense().double().numpy()
    want = dense @ x[:ta.n].double().numpy()
    np.testing.assert_allclose(y[:ta.n].numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(y[ta.n:], x[ta.n:])


def test_df64_ring_matvec_parity():
    """The f64 ring: ``matvec64`` is the dense float64 product to 1e-12,
    ``matvec_df`` its (hi, lo) split (carried over:
    ``TestRingShiftELLDF64::test_matvec_parity``, P = 8)."""
    _, ta = matrix("poisson16x16", np.float64)
    parts = tpart.ring_partition_shiftell_df64(ta, 8)
    m = mesh(8)
    op = _ring_op(parts, m, tpar.DistShiftELLDF64Ring)
    x64 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        parts.n_global_padded))
    from cuda_mpi_parallel_tpu_torch.ops import df64 as tdf

    pair = tdf.f64_to_pair(x64)
    with tcomm.bind(m):
        y = op.matvec64(x64)
        hi, lo = op.matvec_df(pair)
        want_pair = tdf.f64_to_pair(op.matvec64(tdf.pair_to_f64(*pair)))
        dh, dl = op.diagonal_df()
        assert op.shape == (256, 256)
    want = ta.to_dense().numpy() @ x64[:ta.n].numpy()
    np.testing.assert_allclose(y[:ta.n].numpy(), want, rtol=1e-12,
                               atol=1e-12)
    assert y.dtype == torch.float64
    assert all(torch.equal(u, v) for u, v in zip((hi, lo), want_pair))
    assert all(torch.equal(u, v) for u, v in zip((dh, dl),
                                                 tdf.f64_to_pair(op.diag)))
    assert not isinstance(op, pt.LinearOperator)


# -- 3. the f32 lane against the JAX package's --------------------------------


F32_CASES = [
    # (reference, matrix, shards, preconditioner, method, rtol)
    ("solve", "poisson24x24", 8, None, "cg", 1e-6),
    ("ring", "fem700s6", 8, None, "cg", 1e-6),
    ("solve", "poisson16x16", 6, "jacobi", "cg", 1e-6),
    ("solve", "poisson16x16", 4, "chebyshev", "cg", 1e-6),
    ("ring", "fem333s7", 8, None, "cg", 1e-6),
    ("ring", "poisson16x16", 4, "jacobi", "cg1", 1e-5),
    ("ring", "poisson18x17", 4, None, "pipecg", 1e-5),
    ("ring", "poisson16x16", 2, None, "minres", 1e-5),
]


@pytest.mark.parametrize("ref,name,n,pc,method,rtol", F32_CASES)
def test_solve_matches_jax(ref, name, n, pc, method, rtol, jax_refs):
    """The lane against the JAX ring lane (the same schedule) or the JAX
    single-device solve (carried over: ``test_trajectory_matches_single_
    device``, ``test_preconditioners``): counts within 2, x within 2e-5
    max|x| and near x_true; padding rows stripped (n = 333 over 8
    shards, 256 over 6, 306 over 4)."""
    _, ta, x_true, b = system(name, 11)
    kw = dict(tol=0.0, rtol=rtol, maxiter=4000, preconditioner=pc,
              method=method)
    jres = (jax_refs("ring", name, 11, n, **kw) if ref == "ring"
            else jax_refs("solve", name, 11, **kw))
    res = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=mesh(n),
                                 csr_comm="ring-shiftell", **kw)
    assert int(res.status) == 0, (name, n, pc, method)
    assert abs(int(res.iterations) - int(jres.iterations)) <= 2
    jx = np.asarray(jres.x)
    assert res.x.shape == (ta.n,) and res.x.dtype == torch.float32
    assert np.abs(res.x.numpy() - jx).max() <= X_TOL * np.abs(jx).max()
    assert np.abs(res.x.numpy() - x_true).max() <= 1e-3 * np.abs(x_true).max()


def test_one_shard_is_the_single_device_solve_bit_for_bit():
    """P = 1: the ring is one step of B8 over the whole matrix, the dots
    a one-shard psum - ``solve(ShiftELLMatrix)``'s bits, in f32 and in
    the f64 lane (``cg_df64(ShiftELLDF64Matrix)``)."""
    _, ta, _, b = system("fem333s7", 12)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=2000)
    one = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=mesh(1),
                                 csr_comm="ring-shiftell", **kw)
    single = pt.solve(ta.to_shiftell(), torch.as_tensor(b),
                      engine="general", **kw)
    assert int(one.iterations) == int(single.iterations)
    assert torch.equal(one.x, single.x)
    _, ta64, _, b64 = system("fem333s7", 12, np.float64)
    kw64 = dict(tol=0.0, rtol=1e-10, maxiter=4000)
    one = tpar.solve_distributed_df64(ta64, b64, mesh=mesh(1), **kw64)
    single = pt.cg_df64(ta64.to_shiftell_df64(), b64, **kw64)
    assert int(one.iterations) == int(single.iterations)
    assert torch.equal(one.x64, single.x64)


def test_launches_per_matvec_and_the_solver_cache(monkeypatch):
    """P SpMV calls a matvec (counted at the twin: one per launch on the
    card) and P - 1 ppermutes; a second identical solve builds nothing
    (carried over: ``test_second_call_no_retrace``)."""
    _, ta, _, b = system("poisson16x16", 13)
    calls = []
    twin = hk_spmv.shift_ell_matvec_plain
    monkeypatch.setattr(hk_spmv, "shift_ell_matvec_plain",
                        lambda *a: calls.append(a[-1]) or twin(*a))
    m = mesh(4)
    kw = dict(tol=0.0, rtol=1e-6, csr_comm="ring-shiftell")
    tdist.clear_solver_cache()
    res = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=m, **kw)
    matvecs = int(res.iterations)               # cg from x0 = 0
    assert calls == [256] * (4 * matvecs)
    assert m.comm.counts["ppermute"] == 3 * matvecs
    builds = tdist._BUILD_COUNT[0]
    again = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=m, **kw)
    assert tdist._BUILD_COUNT[0] == builds
    assert torch.equal(again.x, res.x)
    assert [k[0] for k in tdist._SOLVER_CACHE] == ["csr-shiftell"]


def test_history_flight_and_check_every():
    """``record_history``, the flight recorder (the same iterates on and
    off) and ``check_every`` (the same iterates, up to k - 1 frozen
    extra iterations) on the lane."""
    from cuda_mpi_parallel_tpu_torch.telemetry import flight as tflight

    _, ta, _, b = system("poisson16x16", 14)
    m = mesh(2)
    kw = dict(tol=0.0, rtol=1e-5, csr_comm="ring-shiftell")
    cfg = tflight.FlightConfig.for_solve(2000, stride=2, heartbeat=3)
    plain = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=m,
                                   record_history=True, **kw)
    rec = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=m, flight=cfg,
                                 record_history=True, **kw)
    its = int(plain.iterations)
    assert torch.equal(rec.x, plain.x) and plain.flight is None
    got = tflight.FlightRecord.from_buffer(rec.flight)
    assert np.array_equal(got.iterations, np.arange(0, its + 1, 2))
    hist = plain.residual_history
    assert hist.shape == (2001,) and torch.isnan(hist[its + 1:]).all()
    blocked = tpar.solve_distributed(ta, torch.as_tensor(b), mesh=m,
                                     check_every=4, **kw)
    assert its <= int(blocked.iterations) <= its + 3
    assert int(blocked.status) == 0


def test_refusals():
    """The ring lanes rotate full x-blocks, so a plan scored for the
    gather wire (``plan=`` runs on both ring lanes since its port,
    tests/test_torch_balance.py) and ``exchange="gather"`` conflict, as
    in the JAX package."""
    from cuda_mpi_parallel_tpu_torch.balance import plan_partition

    _, ta = matrix("poisson8x8")
    b = np.ones(64, np.float32)
    gather_plan = plan_partition(ta, 2, exchange="gather")
    with pytest.raises(ValueError, match="gather halo exchange"):
        tpar.solve_distributed(ta, b, mesh=mesh(2), plan=gather_plan,
                               csr_comm="ring-shiftell")
    with pytest.raises(ValueError, match="gather halo exchange"):
        tpar.solve_distributed_df64(ta, b, mesh=mesh(2), plan=gather_plan)
    with pytest.raises(ValueError, match="conflicts"):
        tpar.solve_distributed(ta, b, mesh=mesh(2), exchange="gather",
                               csr_comm="ring-shiftell")


# -- 4. the f64 lane against the JAX package's --------------------------------


def test_df64_solve_matches_single_device(jax_refs):
    """Carried over: ``TestRingShiftELLDF64::test_solve_matches_single_
    device`` - 8 shards at rtol 1e-11 against the JAX single-device
    ``cg_df64`` on the CSRMatrix and the port's on B9's twin."""
    _, ta, x_true, b = system("poisson24x24", 15, np.float64)
    kw = dict(tol=0.0, rtol=1e-11, maxiter=3000)
    jres = jax_refs("df64", "poisson24x24", 15, dtype=np.float64, **kw)
    single = pt.cg_df64(ta.to_shiftell_df64(), b, **kw)
    res = tpar.solve_distributed_df64(ta, b, mesh=mesh(8), **kw)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(jres.iterations)) <= 2
    assert abs(int(res.iterations) - int(single.iterations)) <= 2
    np.testing.assert_allclose(res.x(), x_true, atol=1e-8)
    np.testing.assert_allclose(res.x(), jres.x(), atol=1e-8)
    assert res.x64.dtype == torch.float64 and res.x_hi.shape == (ta.n,)


def test_df64_jacobi_variants_check_every():
    """Carried over: cg1 and pipecg with Jacobi, check_every=4."""
    _, ta, x_true, b = system("poisson24x24", 16, np.float64)
    for method in ("cg1", "pipecg"):
        r = tpar.solve_distributed_df64(
            ta, b, mesh=mesh(8), tol=0.0, rtol=1e-10, maxiter=3000,
            preconditioner="jacobi", method=method, check_every=4)
        single = pt.cg_df64(ta.to_shiftell_df64(), b, tol=0.0, rtol=1e-10,
                            maxiter=3000, preconditioner="jacobi",
                            method=method, check_every=4)
        assert bool(r.converged), method
        assert abs(int(r.iterations) - int(single.iterations)) <= 2
        np.testing.assert_allclose(r.x(), x_true, atol=1e-7)


def test_df64_padding_rows_stripped():
    """Carried over: 306 rows over 8 shards - the unit-diagonal padding
    rows solve as zeros and leave the returned x."""
    _, ta, x_true, b = system("poisson18x17", 17, np.float64)
    r = tpar.solve_distributed_df64(ta, b, mesh=mesh(8), tol=0.0,
                                    rtol=1e-10, maxiter=3000)
    assert bool(r.converged)
    assert r.x_hi.shape == r.x_lo.shape == r.x64.shape == (306,)
    np.testing.assert_allclose(r.x(), x_true, atol=1e-7)


def test_df64_ring_csr_chebyshev():
    """Carried over: ``TestChebyshevDF64Dist::test_ring_csr_chebyshev`` -
    the degree-4 polynomial on the global CSR's interval more than
    halves plain CG's count; the count is the single-device CSR
    ``cg_df64``'s (the same interval), and the flight recorder rides
    the lane."""
    from cuda_mpi_parallel_tpu_torch.telemetry import flight as tflight

    _, ta, x_true, b = system("poisson24x24", 18, np.float64)
    kw = dict(tol=0.0, rtol=1e-10, maxiter=3000)
    m = mesh(8)
    plain = tpar.solve_distributed_df64(ta, b, mesh=m, **kw)
    cfg = tflight.FlightConfig.for_solve(3000, stride=4)
    cheb = tpar.solve_distributed_df64(ta, b, mesh=m, flight=cfg,
                                       preconditioner="chebyshev", **kw)
    single = pt.cg_df64(ta, b, preconditioner="chebyshev", **kw)
    assert bool(cheb.converged)
    assert int(cheb.iterations) * 2 < int(plain.iterations)
    assert abs(int(cheb.iterations) - int(single.iterations)) <= 2
    np.testing.assert_allclose(cheb.x(), x_true, atol=1e-7)
    got = tflight.FlightRecord.from_buffer(cheb.flight)
    assert np.array_equal(got.iterations,
                          np.arange(0, int(cheb.iterations) + 1, 4))


# -- 5. torch.distributed (gloo): two ranks give the stacked mesh's bits ------


def test_gloo_ranks_equal_the_stacked_mesh(tmp_path):
    import torch.multiprocessing as mp

    out = str(tmp_path / "result")
    init = "file://" + str(tmp_path / "rendezvous")
    # the ranks import a helper without JAX (torch_df64_ranks.py)
    mp.spawn(ranks.gloo_rank, args=(2, init, out, "ring-shiftell"),
             nprocs=2, join=True)
    wants = []
    for lane, a, b, kw in ranks.ring_problems():
        m = mesh(2)
        res = ranks.solve(lane, a, b, m, kw)
        wants.append((lane, kw, res, dict(m.comm.counts)))
    for rank in range(2):
        got = torch.load(f"{out}.{rank}")
        assert len(got) == len(wants)
        for (lane, kw, want, counts), g in zip(wants, got):
            assert g["iterations"] == int(want.iterations), (lane, kw)
            assert torch.equal(g["x"], ranks.solution(want)), (lane, kw)
            assert g["counts"] == counts, (lane, kw)
            assert g["counts"]["ppermute"] > 0
    assert not os.path.exists(str(tmp_path / "result.2"))
