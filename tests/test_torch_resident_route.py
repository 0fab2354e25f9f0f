"""Which body B10's f32 launch (and its cg1 form's) takes, and what its
wrapper hands the C entry.

``csrc/resident.cu``'s ``cmpt_cg_resident`` runs B12's body at one shard
(``csrc/resident_dist.cu``) when the grid's tiles fit that body's shared
slots - ``dist_geometry(n0, n1, n2, three_d, 1, SMs).fits`` of
``csrc/resident_dist.cuh`` - and the tile walk otherwise; the two give
the same bits, which ``chip_smoke.py`` checks on the card.  The C entry
alone picks the body: the wrapper hands it a zeroed one-shard exchange
region on every f32 launch, which the tile walk ignores.  These tests
check, on the Python geometry that ``test_torch_dist_resident_layout.py``
holds equal to the header and on an H100's 132 SMs as a CPU device
stands for, that every grid the capacity gate admits takes exactly one
body, that every square and cube it admits takes B12's, that the thin or
ragged grids past the slots take the tile walk, that the gate admits
what it admitted before the route existed, and that a launch hands the
C entry its region and ``instance`` in the order ``_build`` declares.
The cg1 form's C entry (``cmpt_cg_resident_cg1``) picks by the same
rule between its one-barrier body on B12's machinery
(``resident_cg1_shard_kernel``) and its tile walk; the same checks hold
for it under the six-plane cg1 gate.  So does B11's f64 entry
(``cmpt_cg_resident_f64``) between B12's body in double - by the f64
geometry, two CTAs per SM and three tiles a CTA - and its tile walk,
under the f64 gate; its launch hands the entry a zeroed region of the
f64 size and ``instance``.
"""
import contextlib
import ctypes
import itertools
import math

import pytest
import torch

from cuda_mpi_parallel_tpu_torch.ops.cuda import _build
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident as trk
from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

torch.set_num_threads(1)

L2 = 50 * 2 ** 20  # an H100's, the budget of a CPU device


def _gate(shape, **kw):
    fn = trk.supports_resident_2d if len(shape) == 2 \
        else trk.supports_resident_3d
    return fn(*shape, device="cpu", **kw)


def _body(shape):
    """The body the C entry takes for ``shape`` on the card a CPU device
    stands for."""
    return "b12" if rd._geometry(tuple(shape), 1, "cpu").fits \
        else "tile_walk"


def _parent_rule(shape, preconditioned=False, cg1=False):
    """The gate as it stood before the route: five f32 planes, seven with
    the preconditioner, six for cg1, within the L2."""
    planes = 6 if cg1 else 7 if preconditioned else 5
    return min(shape) >= 1 and planes * math.prod(shape) * 4 <= L2


VARIANTS = [dict(), dict(preconditioned=True), dict(cg1=True)]

# squares, cubes, thin and ragged grids around the gate's and the slots'
# margins
SWEEP = sorted(
    {(n, n) for n in (1, 7, 8, 130, 1024, 1368, 1369, 1448, 1619, 1620)}
    | {(n, n, n) for n in (1, 8, 33, 109, 128, 137, 138)}
    | {(6336, 280), (6337, 280), (12672, 206), (12673, 206),
       (12800, 200), (12680, 1), (12679, 1), (3168, 769), (2528, 1025),
       (2560000, 1), (1, 2560000), (8, 327680), (7, 130), (16, 128)}
    | {(920, 1, 512), (921, 1, 512), (14792, 1, 1), (14784, 1, 1),
       (9, 17, 33), (4, 17, 33), (1, 5, 7), (64, 64, 600)})


@pytest.mark.parametrize("variant", VARIANTS, ids=["plain", "cheb", "cg1"])
def test_every_admitted_grid_takes_one_body(variant):
    admitted = [shape for shape in SWEEP if _gate(shape, **variant)]
    assert len(admitted) > 20
    for shape in admitted:
        body = _body(shape)
        n0, n1, n2, three_d = _build.grid_dims(shape)
        fits = rd.dist_geometry(n0, n1, n2, three_d, 1, 132).fits
        assert body == ("b12" if fits else "tile_walk"), shape


@pytest.mark.parametrize("ndim,largest,preconditioned", [
    (2, 1619, False), (3, 137, False), (2, 1368, True)])
def test_every_square_and_cube_the_gate_admits_takes_b12s_body(
        ndim, largest, preconditioned):
    kw = dict(preconditioned=preconditioned)
    assert _gate((largest,) * ndim, **kw)
    assert not _gate((largest + 1,) * ndim, **kw)
    for n in range(8, largest + 1):
        assert _body((n,) * ndim) == "b12", n


@pytest.mark.parametrize("shape", [(1024, 1024), (128, 128, 128)])
def test_the_main_paths_grids_take_b12s_body(shape):
    assert _gate(shape) and _body(shape) == "b12"


# past the slots at one shard on 132 SMs: more than 1,584 tiles in 2D or
# 1,848 in 3D (PERF.md lists the 2D widths)
@pytest.mark.parametrize("shape", [
    (12800, 200), (6337, 280), (12673, 206), (12680, 1), (921, 1, 512),
    (14792, 1, 1)])
def test_thin_grids_past_the_slots_take_the_tile_walk(shape):
    assert _gate(shape)
    assert _body(shape) == "tile_walk"


@pytest.mark.parametrize("variant", VARIANTS, ids=["plain", "cheb", "cg1"])
def test_gate_admits_what_it_admitted_before(variant):
    sweep = SWEEP + [(n, n) for n in range(1, 1700, 37)] + [
        (n, n, n) for n in range(1, 150, 7)] + list(itertools.product(
            (1, 3, 8, 1000, 12800), (1, 200, 4096)))
    for shape in sweep:
        assert _gate(shape, **variant) == _parent_rule(shape, **variant), \
            shape


class _FakeLibrary:
    """Records ``cmpt_cg_resident``'s and ``cmpt_cg_resident_cg1``'s
    arguments against the argtypes ``_build`` declares; the sizes are the
    Python geometry's."""

    def __init__(self):
        self.calls = []
        self.cmpt_resident_dist_exchange_bytes = rd.exchange_bytes

    @staticmethod
    def cmpt_tile_blocks(n0, n1, n2, three_d):
        return rd.dist_geometry(n0, n1, n2, three_d, 1, 1).tiles

    def _record(self, name, args):
        argtypes, _ = _build._SIGNATURES[name]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            if kind is ctypes.c_void_p:
                assert arg is None or isinstance(arg, int)
            else:
                assert isinstance(arg, int) and not isinstance(arg, bool)
        self.calls.append(args)
        return 0

    def cmpt_cg_resident(self, *args):
        return self._record("cmpt_cg_resident", args)

    def cmpt_cg_resident_cg1(self, *args):
        return self._record("cmpt_cg_resident_cg1", args)

    def cmpt_cg_resident_f64(self, *args):
        return self._record("cmpt_cg_resident_f64", args)


@pytest.fixture
def fake(monkeypatch):
    """B10's launch with the card and the library faked; every tensor
    ``torch.zeros``/``torch.empty_like`` makes meanwhile is kept."""
    lib = _FakeLibrary()
    lib.made = []
    for name in ("zeros", "empty", "empty_like"):
        make = getattr(torch, name)

        def spy(*args, _make=make, **kwargs):
            t = _make(*args, **kwargs)
            lib.made.append(t)
            return t
        monkeypatch.setattr(torch, name, spy)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    yield lib


def _launch(shape, degree=0, instance=0, warm=False, method="cg",
            dtype=torch.float32):
    b = torch.ones(shape, dtype=dtype)
    x0 = torch.zeros(shape, dtype=dtype) if warm else None
    return trk._launch(1.0, 0.0, 0.0, 0.5, 8.0, 20, b, x0, nblocks=3,
                       check_every=8, degree=degree, method=method,
                       instance=instance)


@pytest.mark.parametrize("shape,degree,instance,warm,runs_b12", [
    ((16, 128), 0, 0, False, True), ((16, 128), 4, 0, True, True),
    ((9, 17, 33), 2, 0, False, True), ((9, 17, 33), 1, 1, True, True),
    ((16, 128), 0, 2, False, False), ((12680, 1), 0, 0, False, False),
    ((12680, 1), 3, 1, True, False), ((14792, 1, 1), 0, 0, False, False)])
def test_launch_hands_the_entry_its_region_and_instance(
        fake, shape, degree, instance, warm, runs_b12):
    _build.LAUNCHES.clear()
    _launch(shape, degree, instance, warm)
    (args,) = fake.calls
    (b, x0, x, r, p, ap, z2, d, params, cap, partials, rr, flags, hist,
     reg, n0, n1, n2, three_d, nblocks, check_every, deg, inst,
     stream) = args
    assert (n0, n1, n2, three_d) == _build.grid_dims(shape)
    assert (nblocks, check_every, deg, inst) == (3, 8, degree, instance)
    assert (x0 is not None) == warm
    assert (d is not None) == (degree >= 2) and (z2 is not None) == (
        degree >= 3)
    # every f32 launch: one zeroed exchange region of one shard, sized by
    # the header's entry, which B12's body uses and the tile walk ignores
    # (instance 2, or a grid past the slots, where instance 1 refuses)
    assert (instance != 2 and _body(shape) == "b12") == runs_b12
    made = {t.data_ptr(): t for t in fake.made}
    t = made[reg]
    assert t.dtype == torch.uint8 and not t.any()
    assert t.numel() == rd.exchange_bytes(n1 * n2, 1)
    for plane in (x, r, p, ap):
        assert made[plane].shape == shape
    assert made[partials].numel() == 3 * rd.dist_geometry(
        n0, n1, n2, three_d, 1, 1).tiles
    assert dict(_build.LAUNCHES) == {"cg_resident": 1}


@pytest.mark.parametrize("method,dtype", [("cg1", torch.float32),
                                          ("cg", torch.float64)])
def test_only_b10_takes_an_instance(fake, method, dtype):
    """B10's f32 launches, the cg1 form's too, take an instance; so does
    B11 (f64), which has two bodies since B12's body took a double
    instance."""
    _launch((16, 128), instance=1, method=method, dtype=dtype)
    (args,) = fake.calls
    assert args[-2] == 1


# the cg1 form: the one-barrier body on every grid whose tiles fit B12's
# slots, the tile walk past them, under the six-plane cg1 gate

@pytest.mark.parametrize("ndim,largest", [(2, 1478), (3, 129)])
def test_every_square_and_cube_the_cg1_gate_admits_takes_the_one_barrier_body(
        ndim, largest):
    assert _gate((largest,) * ndim, cg1=True)
    assert not _gate((largest + 1,) * ndim, cg1=True)
    for n in range(1, largest + 1):
        assert _body((n,) * ndim) == "b12", n


@pytest.mark.parametrize("shape", [(1024, 1024), (128, 128, 128)])
def test_the_cg1_main_paths_grids_take_the_one_barrier_body(shape):
    assert _gate(shape, cg1=True) and _body(shape) == "b12"


# 1,600 and 1,856 tiles at one shard on 132 SMs; 12,800 x 200 (six planes
# of 61 MB) lies outside the cg1 gate
@pytest.mark.parametrize("shape", [(12800, 147), (921, 1, 512),
                                   (6337, 280), (14792, 1, 1)])
def test_thin_cg1_grids_past_the_slots_take_the_tile_walk(shape):
    assert _gate(shape, cg1=True)
    assert _body(shape) == "tile_walk"


def test_b10s_widest_thin_grid_is_outside_the_cg1_gate():
    assert _gate((12800, 200)) and not _gate((12800, 200), cg1=True)


@pytest.mark.parametrize("shape,instance,warm,runs_one_barrier", [
    ((16, 128), 0, False, True), ((16, 128), 0, True, True),
    ((9, 17, 33), 1, True, True), ((128, 128, 128), 0, True, True),
    ((16, 128), 2, False, False), ((12800, 147), 0, True, False),
    ((921, 1, 512), 1, False, False), ((921, 1, 512), 2, True, False)])
def test_cg1_launch_hands_the_entry_its_planes_region_and_instance(
        fake, shape, instance, warm, runs_one_barrier):
    _build.LAUNCHES.clear()
    _launch(shape, instance=instance, warm=warm, method="cg1")
    (args,) = fake.calls
    (b, x0, x, r, p, s, w, s2, w2, params, cap, partials, rr, flags, hist,
     reg, n0, n1, n2, three_d, nblocks, check_every, inst, stream) = args
    assert (n0, n1, n2, three_d) == _build.grid_dims(shape)
    assert (nblocks, check_every, inst) == (3, 8, instance)
    assert (x0 is not None) == warm
    assert (instance != 2 and _body(shape) == "b12") == runs_one_barrier
    made = {t.data_ptr(): t for t in fake.made}
    # the one-barrier body's r, s and w in two planes each, seven distinct
    # planes beside b; the tile walk ignores s2 and w2
    planes = (x, r, p, s, w, s2, w2)
    assert len(set(planes)) == 7 and b not in planes
    for plane in planes:
        assert made[plane].shape == shape
        assert made[plane].dtype == torch.float32
    # one zeroed exchange region of one shard, the header's size
    t = made[reg]
    assert t.dtype == torch.uint8 and not t.any()
    assert t.numel() == rd.exchange_bytes(n1 * n2, 1)
    assert made[partials].numel() == 2 * rd.dist_geometry(
        n0, n1, n2, three_d, 1, 1).tiles
    assert made[hist].numel() == 4 and made[flags].numel() == 4
    assert dict(_build.LAUNCHES) == {"cg_resident_cg1": 1}


# B11 (f64): B12's body in double on every grid whose tiles fit its slots
# at the f64 tile walk's two CTAs per SM (three tiles a CTA, 792 on 132
# SMs), the tile walk past them, under the f64 gate (five or seven planes
# of eight bytes within the L2)

def _gate64(shape, preconditioned=False):
    fn = trk.supports_resident_df64_2d if len(shape) == 2 \
        else trk.supports_resident_df64_3d
    return fn(*shape, device="cpu", preconditioned=preconditioned)


def _body64(shape):
    """The body B11's C entry takes for ``shape`` on an H100."""
    return "b12" if rd._geometry(tuple(shape), 1, "cpu", 8).fits \
        else "tile_walk"


@pytest.mark.parametrize("preconditioned", [False, True],
                         ids=["plain", "cheb"])
def test_every_admitted_f64_grid_takes_one_body(preconditioned):
    admitted = [shape for shape in SWEEP
                if _gate64(shape, preconditioned)]
    assert len(admitted) > 15
    for shape in admitted:
        n0, n1, n2, three_d = _build.grid_dims(shape)
        tiles = rd.dist_geometry(n0, n1, n2, three_d, 1, 132, 8).tiles
        assert _body64(shape) == ("b12" if tiles <= 3 * 2 * 132
                                  else "tile_walk"), shape


@pytest.mark.parametrize("ndim,largest,preconditioned", [
    (2, 1144, False), (3, 109, False), (2, 967, True), (3, 97, True)])
def test_every_square_and_cube_the_f64_gate_admits_takes_b12s_body(
        ndim, largest, preconditioned):
    assert _gate64((largest,) * ndim, preconditioned)
    assert not _gate64((largest + 1,) * ndim, preconditioned)
    for n in range(1, largest + 1):
        assert _body64((n,) * ndim) == "b12", n


@pytest.mark.parametrize("shape,preconditioned", [
    ((1024, 1024), False), ((768, 1024), True), ((109, 109, 109), False)])
def test_the_f64_main_paths_grids_take_b12s_body(shape, preconditioned):
    assert _gate64(shape, preconditioned) and _body64(shape) == "b12"


# 1,600 and 1,856 tiles; and the margins, 3,168 x 280 (792 tiles) and
# 392 x 1 x 512 (784) on the body, one plane more past it
@pytest.mark.parametrize("shape,body", [
    ((12800, 100), "tile_walk"), ((921, 1, 512), "tile_walk"),
    ((3168, 280), "b12"), ((3169, 280), "tile_walk"),
    ((392, 1, 512), "b12"), ((393, 1, 512), "tile_walk")])
def test_thin_f64_grids_past_the_slots_take_the_tile_walk(shape, body):
    assert _gate64(shape)
    assert _body64(shape) == body


@pytest.mark.parametrize("shape,degree,instance,warm,runs_b12", [
    ((16, 128), 0, 0, False, True), ((16, 128), 4, 0, True, True),
    ((9, 17, 33), 2, 1, True, True), ((109, 109, 109), 0, 0, False, True),
    ((16, 128), 0, 2, False, False), ((12800, 100), 0, 0, False, False),
    ((921, 1, 512), 3, 1, True, False), ((3169, 280), 1, 0, True, False)])
def test_f64_launch_hands_the_entry_its_region_and_instance(
        fake, shape, degree, instance, warm, runs_b12):
    _build.LAUNCHES.clear()
    _launch(shape, degree, instance, warm, dtype=torch.float64)
    (args,) = fake.calls
    (b, x0, x, r, p, ap, z2, d, params, cap, partials, rr, flags, hist,
     reg, n0, n1, n2, three_d, nblocks, check_every, deg, inst,
     stream) = args
    assert (n0, n1, n2, three_d) == _build.grid_dims(shape)
    assert (nblocks, check_every, deg, inst) == (3, 8, degree, instance)
    assert (x0 is not None) == warm
    assert (d is not None) == (degree >= 2) and (z2 is not None) == (
        degree >= 3)
    assert (instance != 2 and _body64(shape) == "b12") == runs_b12
    # every f64 launch: one zeroed exchange region of one shard at the
    # f64 size (double halos, two words a dot value), which B12's body
    # uses and the tile walk ignores
    made = {t.data_ptr(): t for t in fake.made}
    t = made[reg]
    assert t.dtype == torch.uint8 and not t.any()
    assert t.numel() == rd.exchange_bytes(n1 * n2, 1, 8)
    assert t.numel() > rd.exchange_bytes(n1 * n2, 1)
    for plane in (x, r, p, ap):
        assert made[plane].shape == shape
        assert made[plane].dtype == torch.float64
    assert made[partials].numel() == 3 * rd.dist_geometry(
        n0, n1, n2, three_d, 1, 1).tiles
    assert made[partials].dtype == torch.float64
    assert dict(_build.LAUNCHES) == {"cg_resident_df64": 1}
