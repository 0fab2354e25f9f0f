"""The launch geometry of the plane-marching passes B3 and B4
(``pass_a_march`` and ``pass_b_march`` in ``csrc/fused_cg.cu``) and the
wrappers that size their scratch.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
bit for bit against the twins, which ``test_torch_kernels.py`` holds
against the JAX kernels).  Their shared geometry - the run of planes and
the tile of every block, and the block count - lives in
``csrc/march.cuh``, which is plain C++ apart from its ``__host__
__device__`` marks.  These tests build that header with the host's C++
compiler and pin what the kernels and the wrappers take from it: the
blocks cover every grid point exactly once, the run is fixed by the
shape, the wrappers' partials hold one sum a block (B4: for each of its
sums), an empty grid is refused, and each launch hands its C entry point
the arguments in the order its signature declares.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cuda_mpi_parallel_tpu_torch.ops.cuda import _build
from cuda_mpi_parallel_tpu_torch.ops.cuda import fused_cg

# the ragged grids and slabs chip_smoke.py checks B3 on, single-plane slabs,
# the 4-shard slab of 256^3, and the main path's grids
SHAPES = [(1, 1), (3, 200), (17, 257), (1, 1, 1), (3, 5, 7), (9, 17, 33),
          (1, 200), (1, 5, 7), (1, 17, 33), (4, 17, 33), (3, 17, 33),
          (64, 256, 256), (256, 256, 256), (4096, 4096)]

# the header's geometry behind a C interface, for ctypes
_SHIM = r"""
#include "march.cuh"
using namespace cmpt;
extern "C" {
int64_t cmpt_march_blocks(int64_t n0, int64_t n1, int64_t n2, int three_d) {
  return march_geometry(n0, n1, n2, three_d != 0).blocks;
}
int64_t march_run(int64_t n0, int64_t n1, int64_t n2, int three_d) {
  return march_geometry(n0, n1, n2, three_d != 0).run;
}
void march_tile(int three_d, int64_t* out) {
  out[0] = three_d ? MarchTile<true>::BY : MarchTile<false>::BY;
  out[1] = three_d ? MarchTile<true>::TX : MarchTile<false>::TX;
}
void march_block_of(int64_t b, int64_t n0, int64_t n1, int64_t n2,
                    int three_d, int64_t* out) {
  const MarchGeometry m = march_geometry(n0, n1, n2, three_d != 0);
  const MarchBlock k = three_d ? march_block<true>(b, n0, n1, n2, m)
                               : march_block<false>(b, n0, n1, n2, m);
  const int64_t v[6] = {k.i0, k.i1, k.j0, k.j1, k.k0, k.k1};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}
}
"""


@pytest.fixture(scope="module")
def march(tmp_path_factory):
    """``csrc/march.cuh`` built for the host, through the shim."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler is needed to build the geometry header"
    tmp = tmp_path_factory.mktemp("march")
    src, lib_path = tmp / "shim.cpp", tmp / "libmarch.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-I", str(_build.CSRC), str(src), "-o", str(lib_path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    i64 = ctypes.c_int64
    dims = [i64, i64, i64, ctypes.c_int]
    lib.cmpt_march_blocks.argtypes = dims
    lib.cmpt_march_blocks.restype = i64
    lib.march_run.argtypes = dims
    lib.march_run.restype = i64
    lib.march_tile.argtypes = [ctypes.c_int, ctypes.POINTER(i64)]
    lib.march_block_of.argtypes = [i64] + dims + [ctypes.POINTER(i64)]
    return lib


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pass_a_blocks_cover_the_grid_once(march, shape):
    n0, n1, n2, three_d = _build.grid_dims(shape)
    blocks = march.cmpt_march_blocks(n0, n1, n2, three_d)
    run = march.march_run(n0, n1, n2, three_d)
    tile = (ctypes.c_int64 * 2)()
    march.march_tile(three_d, tile)
    out = (ctypes.c_int64 * 6)()
    cover = np.zeros((n0, n1, n2), dtype=np.uint8)
    for b in range(blocks):
        march.march_block_of(b, n0, n1, n2, three_d, out)
        i0, i1, j0, j1, k0, k1 = out
        assert 0 < i1 - i0 <= run and 0 < j1 - j0 <= tile[0] \
            and 0 < k1 - k0 <= tile[1], (b, tuple(out))
        cover[i0:i1, j0:j1, k0:k1] += 1
    assert cover.min() == 1 and cover.max() == 1


@pytest.mark.parametrize("shape,run,blocks", [
    ((256, 256, 256), 32, 1024),       # 8 runs x 32 x 4 tiles
    ((4096, 4096), 32, 1024),          # 128 runs x 8 tiles of 1 x 512
    ((64, 256, 256), 8, 1024),         # a slab of the 4-shard solve
    ((128, 128, 128), 8, 512),         # the shortest run
    ((1, 5, 7), 1, 1),                 # a single-plane slab
], ids=lambda v: _ids(v) if isinstance(v, tuple) else str(v))
def test_pass_a_run_is_fixed_by_the_shape(march, shape, run, blocks):
    dims = _build.grid_dims(shape)
    # nothing but the shape decides it, so the sums repeat bit for bit
    assert (march.march_run(*dims), march.cmpt_march_blocks(*dims)) \
        == (run, blocks)


class _FakeLibrary:
    """Records the arguments of ``cmpt_cg_pass_a`` and ``cmpt_cg_pass_b``
    (in ``calls``, as (entry, args)) and checks them against the argtypes
    ``_build`` declares for each; answers ``cmpt_march_blocks`` from the
    header built for the host."""

    def __init__(self, march):
        self.cmpt_march_blocks = march.cmpt_march_blocks
        self.calls = []

    def _record(self, entry, args):
        argtypes, _ = _build._SIGNATURES[entry]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            if kind is ctypes.c_void_p:
                assert arg is None or isinstance(arg, int)
            else:
                assert isinstance(arg, int) and not isinstance(arg, bool)
        self.calls.append((entry, args))
        return 0

    def cmpt_cg_pass_a(self, *args):
        return self._record("cmpt_cg_pass_a", args)

    def cmpt_cg_pass_b(self, *args):
        return self._record("cmpt_cg_pass_b", args)


@pytest.fixture
def fake(monkeypatch, march):
    """The f32 launch path with the card and the library faked; every
    tensor ``torch.empty`` makes meanwhile is kept in ``made``."""
    lib = _FakeLibrary(march)
    lib.made = []
    empty = torch.empty

    def spy(*args, **kwargs):
        t = empty(*args, **kwargs)
        lib.made.append(t)
        return t

    monkeypatch.setattr(fused_cg, "require_hopper", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch, "empty", spy)
    fused_cg._march_blocks.cache_clear()
    yield lib
    fused_cg._march_blocks.cache_clear()


def _partials(lib, ptr):
    (t,) = [t for t in lib.made if t.data_ptr() == ptr]
    return t


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pass_a_partials_hold_one_sum_a_block(fake, shape):
    # untouched buffers: the faked launch reads none of them
    r, p = torch.empty(shape), torch.empty(shape)
    fused_cg._launch_pass_a("fused_cg_pass_a", 0.37, 0.45, r, p, None, None)
    ((entry, args),) = fake.calls
    assert entry == "cmpt_cg_pass_a"
    partials = _partials(fake, args[14])
    assert partials.dtype == torch.float32
    assert partials.shape == (fake.cmpt_march_blocks(
        *_build.grid_dims(shape)),)


@pytest.mark.parametrize("shape", [(9, 17, 33), (17, 257), (1, 5, 7)],
                         ids=_ids)
@pytest.mark.parametrize("theta,halos", [(None, False), (1.7, False),
                                         (None, True), (1.7, True)])
def test_pass_a_launch_hands_over_the_geometry(fake, shape, theta, halos):
    """The C entry point gets the planes, NULL for an absent theta and
    absent halos, the grid, and partials of the geometry's block count."""
    rng = np.random.default_rng(3)
    r, p = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    edges = (tuple(torch.zeros((1,) + shape[1:]) for _ in range(4))
             if halos else None)
    before = _build.LAUNCHES["fused_cg_pass_a"]
    fused_cg._launch_pass_a("fused_cg_pass_a", 0.37, 0.45, r, p, theta,
                            None, edges)
    assert _build.LAUNCHES["fused_cg_pass_a"] == before + 1
    ((entry, args),) = fake.calls
    assert entry == "cmpt_cg_pass_a"
    dims = _build.grid_dims(shape)
    assert args[:2] == (r.data_ptr(), p.data_ptr())
    assert (args[5] is None) == (theta is None)
    assert args[6:10] == ((None,) * 4 if edges is None
                          else tuple(h.data_ptr() for h in edges))
    assert args[10:14] == dims
    assert _partials(fake, args[14]).shape == \
        (fake.cmpt_march_blocks(*dims),)
    assert all(isinstance(a, int) for a in args[14:17])


@pytest.mark.parametrize("shape", [(0, 5, 7), (3, 0), (4, 17, 0)], ids=_ids)
def test_pass_a_refuses_an_empty_grid(fake, shape):
    """The header gives an empty grid no blocks, and the wrapper raises
    before it launches anything."""
    assert fake.cmpt_march_blocks(*_build.grid_dims(shape)) == 0
    r, p = torch.empty(shape), torch.empty(shape)
    with pytest.raises(ValueError, match="fused_cg_pass_a: grid"):
        fused_cg._launch_pass_a("fused_cg_pass_a", 0.37, 0.45, r, p, None,
                                None)
    assert fake.calls == []


@pytest.mark.parametrize("with_rz", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pass_b_partials_hold_one_sum_a_block_per_sum(fake, shape, with_rz):
    """B4 shares B3's geometry: its partials hold the same block count for
    rr, and as many again for rz with ``with_rz`` (sized any other way,
    the kernel would write past them)."""
    pnew, x, r = (torch.empty(shape) for _ in range(3))
    fused_cg._launch_pass_b("fused_cg_pass_b", 0.37, 1e-3, pnew, x, r,
                            None, with_rz)
    ((entry, args),) = fake.calls
    assert entry == "cmpt_cg_pass_b"
    partials = _partials(fake, args[13])
    assert partials.dtype == torch.float32
    assert partials.shape == ((2 if with_rz else 1) * fake.cmpt_march_blocks(
        *_build.grid_dims(shape)),)


@pytest.mark.parametrize("shape", [(9, 17, 33), (17, 257), (1, 5, 7)],
                         ids=_ids)
@pytest.mark.parametrize("theta,with_rz,halos", [
    (None, False, False), (1.7, True, False), (None, False, True),
    (1.7, True, True)])
def test_pass_b_launch_hands_over_the_geometry(fake, shape, theta, with_rz,
                                               halos):
    """The C entry point gets the planes, NULL for an absent theta and
    absent halos, the grid, with_rz, and partials of the geometry's block
    count for each sum; the results come back in the twin's layout."""
    rng = np.random.default_rng(4)
    pnew, x, r = (torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32)) for _ in range(3))
    edges = (tuple(torch.zeros((1,) + shape[1:]) for _ in range(2))
             if halos else None)
    before = _build.LAUNCHES["fused_cg_pass_b"]
    out = fused_cg._launch_pass_b("fused_cg_pass_b", 0.37, 1e-3, pnew, x, r,
                                  theta, with_rz, edges)
    assert _build.LAUNCHES["fused_cg_pass_b"] == before + 1
    assert out[0] is x and out[1] is r and len(out) == (4 if with_rz else 3)
    ((entry, args),) = fake.calls
    assert entry == "cmpt_cg_pass_b"
    dims = _build.grid_dims(shape)
    assert args[:3] == (pnew.data_ptr(), x.data_ptr(), r.data_ptr())
    assert (args[5] is None) == (theta is None)
    assert args[6:8] == ((None,) * 2 if edges is None
                         else tuple(h.data_ptr() for h in edges))
    assert args[8:13] == dims + (int(with_rz),)
    assert _partials(fake, args[13]).shape == \
        ((2 if with_rz else 1) * fake.cmpt_march_blocks(*dims),)
    assert all(isinstance(a, int) for a in args[13:16])


@pytest.mark.parametrize("shape", [(0, 5, 7), (3, 0), (4, 17, 0)], ids=_ids)
def test_pass_b_refuses_an_empty_grid(fake, shape):
    """The header gives an empty grid no blocks, and the wrapper raises
    before it launches anything."""
    assert fake.cmpt_march_blocks(*_build.grid_dims(shape)) == 0
    pnew, x, r = (torch.empty(shape) for _ in range(3))
    with pytest.raises(ValueError, match="fused_cg_pass_b: grid"):
        fused_cg._launch_pass_b("fused_cg_pass_b", 0.37, 1e-3, pnew, x, r,
                                None, False)
    assert fake.calls == []
