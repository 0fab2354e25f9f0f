"""The exchange region and launch geometry of B12
(``csrc/resident_dist.cuh``) and what the wrapper takes from them.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
twin and against B10).  Each shard's exchange region - the neighbours' z
edge planes, the shard's copies of their p edge planes, the tagged dot
rows of every shard, the halo flags and the shard barrier - is laid out
by ``xch_layout`` in ``csrc/resident_dist.cuh``, and the launch geometry
- the CTAs a shard takes, the tiles each walks in its shared slots,
whether a launch runs a slab at all - by ``dist_geometry`` there.  The
header is plain C++ apart from its ``__host__ __device__`` marks.  These
tests build it with the host's C++ compiler and check, for 1 to 8
shards and the plane sizes the CPU tests and ``chip_smoke.py`` use, that
every entry the kernel addresses lies inside the region, is aligned for
its accesses and overlaps no other; that the geometry walks common.cuh's
tiles with B10's CTAs; that the capacity gate and ``check_shards_fit``
count the same region and refuse exactly the slabs the geometry refuses,
alike on the CPU and for a card (read through ``_build.host_library``);
and that a launch allocates one such region per shard and hands the C
entry its arguments in the order ``_build`` declares.
"""
import contextlib
import ctypes
import itertools
import math
import shutil
import subprocess

import pytest
import torch

from cuda_mpi_parallel_tpu_torch.ops.cuda import _build
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

torch.set_num_threads(1)

SHARDS = list(range(1, 9))
# planes of the slabs: chip_smoke.py's 1024^2 and 128^3 grids and ragged
# slabs (4 x 17 x 33, 3 x 5 x 7, 17 x 257, 34 x 200, one-point planes) and
# the CPU tests' 2D and 3D grids
PLANES = [1, 35, 128, 200, 257, 561, 1024, 16384]

_SHIM = r"""
#include "resident_dist.cuh"
using namespace cmpt;
extern "C" {
int64_t cmpt_resident_dist_exchange_bytes(int64_t plane, int n_shards) {
  return xch_layout(plane, n_shards).bytes;
}
// Every entry the kernel addresses, as (start, bytes, alignment) triples;
// returns how many.
int xch_entries(int64_t plane, int n_shards, int64_t* out) {
  const XchLayout l = xch_layout(plane, n_shards);
  int n = 0;
  auto put = [&](int64_t at, int64_t bytes, int64_t align) {
    out[3 * n] = at;
    out[3 * n + 1] = bytes;
    out[3 * n + 2] = align;
    ++n;
  };
  for (int parity = 0; parity < 2; ++parity)
    for (int side = 0; side < 2; ++side) {
      put(xch_halo(l, parity, side), plane * 4, 4);
      put(xch_hflag(l, parity, side), 4, 4);
    }
  for (int side = 0; side < 2; ++side) put(xch_phalo(l, side), plane * 4, 4);
  for (int parity = 0; parity < 2; ++parity)
    for (int sender = 0; sender < n_shards; ++sender)
      put(xch_dots(l, parity, sender), 16, 8);
  put(xch_arrivals(l), 8, 8);
  put(xch_generation(l), 4, 4);
  return n;
}
}
"""


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """``csrc/resident_dist.cuh`` built for the host, through the shim."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler is needed to build the layout header"
    tmp = tmp_path_factory.mktemp("xch")
    src, lib_path = tmp / "shim.cpp", tmp / "libxch.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-I", str(_build.CSRC), str(src), "-o", str(lib_path)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    i64 = ctypes.c_int64
    lib.cmpt_resident_dist_exchange_bytes.argtypes = [i64, ctypes.c_int]
    lib.cmpt_resident_dist_exchange_bytes.restype = i64
    lib.xch_entries.argtypes = [i64, ctypes.c_int, ctypes.POINTER(i64)]
    lib.xch_entries.restype = ctypes.c_int
    return lib


def _entries(layout, plane, n_shards):
    out = (ctypes.c_int64 * (3 * (12 + 2 * n_shards)))()
    n = layout.xch_entries(plane, n_shards, out)
    return [tuple(out[3 * i:3 * i + 3]) for i in range(n)]


@pytest.mark.parametrize("plane,n_shards",
                         list(itertools.product(PLANES, SHARDS)))
def test_region_entries_fit_align_and_do_not_overlap(layout, plane,
                                                     n_shards):
    size = layout.cmpt_resident_dist_exchange_bytes(plane, n_shards)
    assert size > 0 and size % 256 == 0
    spans = sorted(_entries(layout, plane, n_shards))
    assert len(spans) == 12 + 2 * n_shards
    for start, nbytes, align in spans:
        assert 0 <= start and start + nbytes <= size, (start, nbytes, size)
        assert start % align == 0, (start, align)
    for (a, na, _), (b, _, _) in zip(spans, spans[1:]):
        assert a + na <= b, (a, na, b)


@pytest.mark.parametrize("plane", PLANES)
def test_region_holds_six_planes_and_grows_with_the_shards(layout, plane):
    sizes = [layout.cmpt_resident_dist_exchange_bytes(plane, n)
             for n in SHARDS]
    # four halo planes and two p copies, then a few hundred bytes
    assert all(6 * plane * 4 <= s <= 6 * plane * 4 + 512 for s in sizes)
    assert sizes == sorted(sizes)


@pytest.fixture
def header_library(monkeypatch, layout):
    """The header built for the host, and a card's queries answered
    without one: an H100's SMs for every device (the L2 comes from
    ``CMP_RESIDENT_VMEM_BYTES``)."""
    monkeypatch.setattr(rd, "sm_count", lambda device=None: rd._H100_SMS)
    return layout


@pytest.mark.parametrize("local_shape,preconditioned", [
    ((256, 1024), False), ((256, 1024), True), ((32, 128, 128), False),
    ((4, 17, 33), True), ((1, 5, 7), False)])
def test_gate_counts_the_header_region_on_a_card(monkeypatch, header_library,
                                                 local_shape, preconditioned):
    cells = math.prod(local_shape)
    region = header_library.cmpt_resident_dist_exchange_bytes(
        cells // local_shape[0], 1)
    planes = (7 if preconditioned else 5) * cells * 4
    # the CPU decides as the card does: the twin keeps no region, but the
    # gate counts the kernel's
    for device in ("cuda", "cpu"):
        monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", str(planes + region))
        assert rd.supports_resident_dist(local_shape, device=device,
                                         preconditioned=preconditioned)
        monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES",
                           str(planes + region - 1))
        assert not rd.supports_resident_dist(local_shape, device=device,
                                             preconditioned=preconditioned)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shards_fit_counts_every_region(monkeypatch, header_library,
                                        n_shards):
    local = (1024 // n_shards, 1024)
    cells = math.prod(local)
    need = n_shards * (5 * cells * 4 + header_library
                       .cmpt_resident_dist_exchange_bytes(1024, n_shards))
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", str(need))
    rd.check_shards_fit(local, n_shards, device="cuda")
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", str(need - 1))
    with pytest.raises(ValueError, match="exchange regions"):
        rd.check_shards_fit(local, n_shards, device="cuda")


def _tiles(n0, n1, n2, three_d):
    """``common.cuh``'s ``tile_blocks``, restated."""
    bx, by = (32, 8) if three_d else (256, 1)
    return -(-n0 // 8) * -(-n1 // by) * -(-n2 // bx)


# slabs (local shape) and shards: the CPU tests', chip_smoke.py's and the
# ragged ones
GEOMETRY_CASES = [((256, 1024), 4), ((1024, 1024), 1), ((32, 128, 128), 4),
                  ((128, 128, 128), 1), ((4, 17, 33), 1), ((1, 5, 7), 3),
                  ((17, 257), 1), ((6, 128), 4), ((3, 8, 128), 4),
                  ((1, 200), 8)]


@pytest.mark.parametrize("local_shape,n_shards", GEOMETRY_CASES)
def test_geometry_walks_b10s_tiles_with_b10s_ctas(local_shape, n_shards):
    n0, n1, n2, three_d = _build.grid_dims(local_shape)
    fits, tiles = rd._geometry(local_shape, n_shards, "cpu")
    assert tiles == _tiles(n0, n1, n2, three_d)
    out = (ctypes.c_int64 * 3)()
    assert _build.host_library().cmpt_resident_dist_geometry(
        n0, n1, n2, three_d, n_shards, rd._H100_SMS, out) == int(fits)
    # B10's CTAs per SM (four in 2D, two in 3D) over the shards, at most
    # one a tile, so one shard's grid is B10's
    ctas = min((2 if three_d else 4) * rd._H100_SMS // n_shards, tiles)
    assert out[1] == ctas and out[2] == -(-tiles // ctas)
    assert fits == (out[2] <= (7 if three_d else 3))


# the margin at one shard on an H100 (132 SMs): 2D rows of 280 points
# take two tiles a block of 8 rows, at most 3 x 4 x 132 tiles; 3D planes
# of 1 x 512 points sixteen, at most 7 x 2 x 132
MARGINS = [((6336, 280), (6337, 280)), ((920, 1, 512), (921, 1, 512))]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("admitted,refused", MARGINS)
def test_gate_refuses_the_slabs_past_the_shared_slots(
        monkeypatch, header_library, device, admitted, refused):
    # the L2 holds both; the shared slots only the first
    monkeypatch.setenv("CMP_RESIDENT_VMEM_BYTES", str(2 ** 40))
    assert rd.supports_resident_dist(admitted, device=device)
    assert not rd.supports_resident_dist(refused, device=device)
    assert rd._geometry(admitted, 1, device) == (True, _tiles(
        *_build.grid_dims(admitted)))
    rd.check_shards_fit(admitted, 1, device=device)
    with pytest.raises(ValueError, match="shared memory"):
        rd.check_shards_fit(refused, 1, device=device)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shards_fit_refuses_the_slabs_past_the_shared_slots(n_shards):
    # a shard's CTAs: 4 x 132 / n_shards in 2D, each holding three tiles;
    # 2D slabs of rows of 280 points, two tiles a block of 8 rows
    ctas = 4 * rd._H100_SMS // n_shards
    rows = 8 * (3 * ctas // 2)
    rd.check_shards_fit((rows, 280), n_shards, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        rd.check_shards_fit((rows + 1, 280), n_shards, device="cpu")


def test_gate_follows_the_cards_sms(monkeypatch):
    # a thin grid of 2,250 tiles: refused on 132 SMs, taken
    # on a card of 188 (3 x 4 x 188 = 2,256 tiles)
    assert not rd.supports_resident_dist((9000, 280), device="cpu")
    monkeypatch.setattr(rd, "sm_count", lambda device=None: 188)
    assert rd.supports_resident_dist((9000, 280), device="cpu")


class _FakeLibrary:
    """Records the arguments of ``cmpt_cg_resident_dist`` against the
    argtypes ``_build`` declares; the region size is the host build's of
    the header."""

    def __init__(self, layout):
        self.cmpt_resident_dist_exchange_bytes = \
            layout.cmpt_resident_dist_exchange_bytes
        self.calls = []

    def cmpt_cg_resident_dist(self, *args):
        argtypes, _ = _build._SIGNATURES["cmpt_cg_resident_dist"]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            if kind is ctypes.c_void_p:
                assert arg is None or isinstance(arg, int)
            else:
                assert isinstance(arg, int) and not isinstance(arg, bool)
        self.calls.append(args)
        return 0


@pytest.fixture
def fake(monkeypatch, layout):
    """The launch path with the card and the library faked; every tensor
    ``torch.empty``/``torch.zeros`` makes meanwhile is kept in ``made``."""
    lib = _FakeLibrary(layout)
    lib.made = []
    for name in ("empty", "zeros", "empty_like", "tensor"):
        make = getattr(torch, name)

        def spy(*args, _make=make, **kwargs):
            t = _make(*args, **kwargs)
            lib.made.append(t)
            return t
        monkeypatch.setattr(torch, name, spy)
    monkeypatch.setattr(rd, "require_hopper", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    yield lib


def _made(lib, ptr):
    (t,) = [t for t in lib.made if t.data_ptr() == ptr]
    return t


@pytest.mark.parametrize("shape,degree", [
    ((4, 64, 128), 0), ((2, 8, 8, 128), 0), ((4, 64, 128), 1),
    ((2, 64, 128), 2), ((3, 3, 5, 7), 4), ((8, 1, 200), 3)])
def test_launch_hands_the_kernel_one_region_a_shard(fake, shape, degree):
    b = torch.ones(shape)
    rd._launch(1.0, 0.0, 0.0, 0.5, 8.0, 20, b, nblocks=3, check_every=8,
               degree=degree)
    (args,) = fake.calls
    (b_p, x, r, p0, p1, z2, z1, params, cap, partials, peers, rr, flags,
     hist, n0, n1, n2, three_d, n_shards, nblocks, check_every, deg,
     stream) = args
    n = shape[0]
    assert (n0, n1, n2, three_d) == _build.grid_dims(shape[1:])
    assert (n_shards, nblocks, check_every, deg) == (n, 3, 8, degree)
    for ptr in (x, r, p0, p1):
        assert _made(fake, ptr).shape == b.shape
    assert (z1 is not None) == (degree >= 2)
    assert (z2 is not None) == (degree >= 3)
    tiles = _tiles(n0, n1, n2, three_d)
    assert _made(fake, partials).numel() == 3 * n * tiles
    # the table points at n zeroed regions of the header's size, back to back
    size = fake.cmpt_resident_dist_exchange_bytes(n1 * n2, n)
    table = _made(fake, peers)
    (regions,) = [t for t in fake.made
                  if t.dtype == torch.uint8 and t.numel() == n * size]
    assert not regions.any()
    assert table.tolist() == [regions.data_ptr() + s * size
                              for s in range(n)]
    assert _made(fake, hist).shape == (n, 4)
    assert _made(fake, flags).shape == (n, 4)
    assert _made(fake, rr).shape == (n,)


def test_launch_refuses_a_slab_past_the_shared_slots(fake):
    b = torch.ones((1, 6337, 280))
    with pytest.raises(ValueError, match="do not fit one launch"):
        rd._launch(1.0, 0.0, 0.0, 0.5, 8.0, 20, b, nblocks=3,
                   check_every=8, degree=0)
    assert fake.calls == []
