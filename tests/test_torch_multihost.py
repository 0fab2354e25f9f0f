"""The port's ``parallel.multihost`` against the JAX package's, and four
gloo ranks on a (2, 2) pencil mesh.

Carried over: ``tests/test_multihost.py`` - its single-process
degradations (here on a one-rank gloo process group, the port's
counterpart of one JAX process, and on a stacked mesh of 8 CPU shards)
and its multi-process arithmetic of ``shard_vector_global`` (the
process index and count mocked, ``_translate_to_local`` held to the JAX
one).  Then one ``torch.multiprocessing.spawn`` of four gloo ranks runs
the f32 and f64 pencil solves on a (2, 2) mesh and a four-process
``shard_vector_global``; every rank must give the stacked (2, 2) mesh's
bits.  The rank body is ``tests/torch_df64_ranks.py`` (no JAX import,
so the spawned ranks start in seconds).
"""
import numpy as np
import pytest
import torch

from cuda_mpi_parallel_tpu.parallel import multihost as jmh
import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.parallel import multihost as tmh

import torch_df64_ranks as ranks

torch.set_num_threads(1)


def stacked(n=8):
    return tpar.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group for the body of the test, through
    ``multihost.initialize``."""
    import torch.distributed as dist

    tmh.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0,
                   device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_exported_as_the_jax_package_does():
    assert tpar.multihost is tmh and "multihost" in tpar.__all__
    assert set(tmh.__all__) <= set(dir(jmh))


class TestSingleProcessDegradation:
    def test_process_info(self):
        assert tmh.process_info() == (0, 1) == jmh.process_info()

    def test_initialize_noop_on_single_process(self):
        """No coordinator: a silent no-op, and a repeated call stays
        one (as the JAX call, which ``tests/test_multihost.py`` holds)."""
        import torch.distributed as dist

        tmh.initialize()
        tmh.initialize()
        assert not dist.is_initialized()
        with pytest.raises(ValueError, match="coordinator"):
            tmh.initialize(num_processes=2)

    def test_global_mesh_needs_a_card_or_a_group(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmh.global_mesh()

    def test_global_mesh_spans_the_group(self, one_rank):
        mesh = tmh.global_mesh()
        assert mesh.size == 1 and mesh.axis_names == ("rows",)
        assert mesh.comm.kind == "distributed"
        assert tmh.process_info() == (0, 1)
        tmh.initialize("file:///never-read", 1, 0, device="cpu")  # no-op

    def test_shard_vector_global_roundtrip(self, rng, one_rank):
        v = rng.standard_normal(64)
        for mesh in (tmh.global_mesh(), stacked()):
            got = tmh.shard_vector_global(v, 64, mesh)
            np.testing.assert_array_equal(got.numpy(), v)
        jarr = jmh.shard_vector_global(v, 64, jmh.global_mesh())
        np.testing.assert_array_equal(np.asarray(jarr), v)

    def test_shard_vector_global_length_check(self, rng):
        with pytest.raises(ValueError, match="full vector"):
            tmh.shard_vector_global(rng.standard_normal(8), 64, stacked())
        with pytest.raises(ValueError, match="full vector"):
            jmh.shard_vector_global(rng.standard_normal(8), 64,
                                    jmh.global_mesh())

    def test_shard_vector_global_divisibility(self, rng):
        for mod, mesh in ((tmh, stacked()), (jmh, jmh.global_mesh())):
            with pytest.raises(ValueError, match="divide evenly"):
                mod.shard_vector_global(rng.standard_normal(65), 65, mesh)

    def test_solve_on_global_mesh(self, one_rank):
        """The group's mesh feeds the same ``solve_distributed`` path: bit
        for bit the stacked one-shard solve, and at x_true as the JAX
        test holds it."""
        a = pt.Stencil3D.create(16, 8, 8, dtype=torch.float64, device="cpu")
        x_true = np.random.default_rng(41).standard_normal(a.n)
        b = a @ torch.as_tensor(x_true)
        mesh = tmh.global_mesh()
        b_local = tmh.shard_vector_global(b, a.n, mesh)
        kw = dict(tol=0.0, rtol=1e-9, maxiter=500)
        res = tpar.solve_distributed(a, mesh.comm.global_vector(b_local),
                                     mesh=mesh, **kw)
        ref = tpar.solve_distributed(a, b, mesh=stacked(1), **kw)
        assert bool(res.converged)
        assert torch.equal(res.x, ref.x)
        np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-7)


class TestMultiProcessArithmetic:
    """``shard_vector_global``'s offsets and slices with the process
    index and count mocked, and ``_translate_to_local`` held to the JAX
    function."""

    def _mock(self, monkeypatch, idx, count):
        monkeypatch.setattr(tmh, "process_info", lambda: (idx, count))

    @pytest.mark.parametrize("n_proc,proc", [(2, 0), (2, 1), (4, 3)])
    def test_device_slices_translate_to_local_ranges(self, n_proc, proc):
        global_length, n_dev = 64, 8
        per_dev = global_length // n_dev
        per_proc = global_length // n_proc
        offset = proc * per_proc
        covered = []
        for d in range(n_dev // n_proc):
            g0 = offset + d * per_dev
            sl = (slice(g0 if g0 else None, g0 + per_dev),)
            got = tmh._translate_to_local(sl, offset, global_length,
                                          per_proc)
            assert got == jmh._translate_to_local(sl, offset, global_length,
                                                  per_proc)
            assert got == (d * per_dev, (d + 1) * per_dev)
            covered.append(got)
        assert covered[0][0] == 0 and covered[-1][1] == per_proc
        assert all(covered[i][1] == covered[i + 1][0]
                   for i in range(len(covered) - 1))

    def test_none_endpoints_mean_array_bounds(self):
        for mod in (tmh, jmh):
            assert mod._translate_to_local((slice(None, 8),), 0, 64,
                                           32) == (0, 8)
            assert mod._translate_to_local((slice(56, None),), 32, 64,
                                           32) == (24, 32)

    def test_foreign_slice_rejected(self):
        for mod in (tmh, jmh):
            with pytest.raises(ValueError, match="process-contiguous"):
                mod._translate_to_local((slice(0, 8),), 32, 64, 32)
            with pytest.raises(ValueError, match="process-contiguous"):
                mod._translate_to_local((slice(56, None),), 0, 64, 32)

    def test_wrong_local_length_raises(self, rng, monkeypatch):
        self._mock(monkeypatch, 0, 2)
        with pytest.raises(ValueError, match="expected 32"):
            tmh.shard_vector_global(rng.standard_normal(64), 64, stacked())

    def test_error_message_names_process(self, rng, monkeypatch):
        self._mock(monkeypatch, 1, 2)
        with pytest.raises(ValueError, match="process 1 holds 10"):
            tmh.shard_vector_global(rng.standard_normal(10), 64, stacked())

    def test_a_stacked_mesh_is_not_in_process_order(self, monkeypatch):
        """A process's slice feeds only its own shards: the rows of a
        stacked mesh's other shards raise, never read wrong data."""
        self._mock(monkeypatch, 1, 2)
        with pytest.raises(ValueError, match="process-contiguous"):
            tmh.shard_vector_global(np.zeros(32), 64, stacked())


# -- four gloo ranks on a (2, 2) pencil mesh ----------------------------------


def test_gloo_ranks_on_a_pencil_mesh_equal_the_stacked_mesh(tmp_path):
    import torch.multiprocessing as mp

    out = str(tmp_path / "result")
    init = "file://" + str(tmp_path / "rendezvous")
    mp.spawn(ranks.pencil_rank, args=(4, init, out), nprocs=4, join=True)
    m = tpar.make_mesh_2d((2, 2), devices=["cpu"] * 4)
    want = []
    for lane, a, b, kw in ranks.pencil_problems():
        m.comm.counts.clear()
        res = ranks.solve_pencil(lane, a, b, m, kw)
        want.append((ranks.solution(res), int(res.iterations),
                     dict(m.comm.counts)))
        assert bool(res.converged), (lane, kw)
    v = torch.arange(64, dtype=torch.float64)
    for rank in range(4):
        got = torch.load(f"{out}.{rank}")
        assert got["info"] == (rank, 4)
        assert torch.equal(got["shard"], v[rank * 16:(rank + 1) * 16])
        for g, (x, its, counts) in zip(got["solves"], want):
            assert g["iterations"] == its
            assert torch.equal(g["x"], x)
            assert g["counts"] == counts
