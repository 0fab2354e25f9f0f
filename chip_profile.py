"""Time the streaming CG passes and the resident kernels, and profile the
distributed streaming lane of the PyTorch/CUDA port on one Hopper card.

    python3 chip_profile.py [--out FILE]

Measures the port in the directory the script sits in; a copy of it at the
root of another tree (an earlier commit unpacked by ``git archive``)
measures that tree the same way, so two commits compare on one card when
both run in one call in turns (parent, change, change, parent).  It
prints the card's name and power limit as ``nvidia-smi`` gives them, then,
as its last line, one JSON object (also written to FILE with ``--out``):

- ``pass_a``: B3 (``fused_cg_pass_a``), device ms (CUDA events, median of
  25) at 256^3, at 256^3 with theta = 1 (the division path), at 4096^2,
  and on the 64 x 256 x 256 slab of a 4-shard solve with halos and
  without;
- ``pass_b``: B4 (``fused_cg_pass_b``), the same, its second case with
  ``with_rz`` and theta = 1.7 (the sum r . (r / theta));
- ``host_us``: host microseconds a call of the B3 and B4 wrappers on that
  slab with halos, the card running behind them (three readings of 200
  calls each);
- ``resident``: device ms of one 200-iteration solve (``tol=0``, check
  blocks of 32; median of 10) of B12 (``cg_resident_dist``) on P stacked
  slabs and of B10 (``cg_resident_2d``/``_3d``) on the same grid: 1024^2
  at P = 1, 2, 4 with no preconditioner and with the degree-4 Chebyshev
  (its interval from the stencil), and 128^3 at P = 1, 4; the sha256 of
  B10's x bytes in each case, and, in a tree whose B10 launch has two
  bodies, B10 forced onto the tile walk; and B10's cg1 form at 1024^2
  and 128^3 (``method="cg1"``): the solver's launch with the sha256 of
  its x, and, in a tree whose cg1 form has two bodies, its tile walk
  alone with the sha256 of that x;
- ``dist_streaming_256``: ``solve_distributed_streaming`` at 256^3 over
  four stacked shards on the one card (rtol 1e-6, check_every=1, as
  ``chip_smoke.py`` runs it): iterations/s of three timed solves, then one
  solve under ``torch.profiler``: the device time of each kernel, the
  card's busy time and its idle share, 1 - busy / wall (the profiler's
  own host cost included in wall).

Without a CUDA device it exits 2 and prints nothing on stdout.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import torch

GRID_3D = (256, 256, 256)
GRID_2D = (4096, 4096)
SLAB = (64, 256, 256)
GRID_RES_2D = (1024, 1024)
GRID_RES_3D = (128, 128, 128)
RESIDENT_KW = dict(tol=0.0, maxiter=200, check_every=32)
SEED = 0


def time_ms(fn, reps: int = 25) -> float:
    """Median device ms of ``fn`` (CUDA events).  A sleep kernel of about
    0.1 s first lets the host queue every launch ahead of the card, so
    each event pair brackets device work only, not the host's launch
    gaps (as in ``chip_smoke.py``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def host_us(fn, reps: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def passes(hk, gen) -> tuple:
    scale, beta, alpha = (torch.tensor(v, device="cuda")
                          for v in (0.37, 0.45, 1e-3))
    one, theta = (torch.tensor(v, device="cuda") for v in (1.0, 1.7))
    pass_a, pass_b = {}, {}
    for label, grid, with_theta, with_halos in (
            ("256^3", GRID_3D, False, False),
            ("256^3 theta", GRID_3D, True, False),
            ("4096^2", GRID_2D, False, False),
            ("slab halos", SLAB, False, True), ("slab", SLAB, False, False)):
        r, p, x = (torch.randn(grid, generator=gen, device="cuda")
                   for _ in range(3))
        halos = (tuple(torch.randn((1,) + grid[1:], generator=gen,
                                   device="cuda") for _ in range(4))
                 if with_halos else None)
        out = torch.empty_like(r)
        if with_halos:
            slab = (r, p, x, halos, out)
        pass_a[label] = dict(shape=list(grid), ms=time_ms(
            lambda: hk.fused_cg_pass_a(scale, beta, r, p, halos,
                                       theta=one if with_theta else None,
                                       out=out)))
        pass_b[label] = dict(shape=list(grid), ms=time_ms(
            lambda: hk.fused_cg_pass_b(
                scale, alpha, out, x, r, None if halos is None else halos[:2],
                theta=theta if with_theta else None,
                with_rz=with_theta)))
    r, p, x, halos, out = slab
    host = dict(
        pass_a=[host_us(lambda: hk.fused_cg_pass_a(scale, beta, r, p, halos,
                                                   out=out))
                for _ in range(3)],
        pass_b=[host_us(lambda: hk.fused_cg_pass_b(scale, alpha, out, x, r,
                                                   halos[:2]))
                for _ in range(3)])
    return pass_a, pass_b, host


def resident(hk, pt, gen) -> dict:
    """B12 on 1, 2, 4 stacked slabs and B10 (also its cg1 form) on the
    whole grid, ms per 200-iteration launch."""
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

    scale = torch.tensor(0.37, device="cuda")
    b = torch.randn(GRID_RES_2D, generator=gen, device="cuda")
    b3 = torch.randn(GRID_RES_3D, generator=gen, device="cuda")
    cheb = pt.ChebyshevPreconditioner.from_operator(
        pt.Stencil2D.create(*GRID_RES_2D, scale=scale), degree=4)
    out = {}
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident as rk

    # a tree whose B10 has two bodies also times the tile walk alone
    bodies = "instance" in inspect.signature(rk._cg_resident_call).parameters
    for label, base, degree, shards in (("1024^2", b, 0, (1, 2, 4)),
                                        ("1024^2 degree 4", b, 4, (1, 2, 4)),
                                        ("128^3", b3, 0, (1, 4))):
        interval = dict(lmin=cheb.lmin, lmax=cheb.lmax) if degree else {}
        b10 = hk.cg_resident_2d if base.ndim == 2 else hk.cg_resident_3d
        x = b10(scale, base, precond_degree=degree, **interval,
                **RESIDENT_KW)[0]
        row = dict(b10_ms=time_ms(lambda: b10(
            scale, base, precond_degree=degree, **interval, **RESIDENT_KW),
            reps=10), b10_x_sha256=sha256(x))
        if bodies:
            row["b10_tile_walk_ms"] = time_ms(lambda: rk._cg_resident_call(
                scale, 0.0, 0.0, interval.get("lmin", 0.0),
                interval.get("lmax", 1.0), RESIDENT_KW["maxiter"], base,
                None, maxiter=RESIDENT_KW["maxiter"],
                check_every=RESIDENT_KW["check_every"], degree=degree,
                instance=2), reps=10)
        for n in shards:
            slabs = base.reshape((n, base.shape[0] // n) + base.shape[1:])
            row[f"b12_ms_p{n}"] = time_ms(lambda: rd.cg_resident_dist(
                scale, slabs, degree=degree, **interval, **RESIDENT_KW),
                reps=10)
        out[label] = row
    kw = dict(RESIDENT_KW, method="cg1")
    for label, base in (("1024^2 cg1", b), ("128^3 cg1", b3)):
        b10 = hk.cg_resident_2d if base.ndim == 2 else hk.cg_resident_3d
        row = dict(b10_ms=time_ms(lambda: b10(scale, base, **kw), reps=10),
                   b10_x_sha256=sha256(b10(scale, base, **kw)[0]))

        def walk():
            return rk._cg_resident_call(
                scale, 0.0, 0.0, 0.0, 1.0, RESIDENT_KW["maxiter"], base, None,
                maxiter=RESIDENT_KW["maxiter"],
                check_every=RESIDENT_KW["check_every"], degree=0,
                method="cg1", instance=2)
        try:
            x = walk()[0]
        except ValueError:  # a tree whose cg1 form has one body refuses
            pass
        else:
            row.update(b10_tile_walk_ms=time_ms(walk, reps=10),
                       b10_tile_walk_x_sha256=sha256(x))
        out[label] = row
    return out


def sha256(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def lane(tpar, poisson, gen) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    b = op_xla.matvec(torch.randn(op.n, generator=gen, device="cuda"))
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
    mesh = tpar.make_mesh(4, devices=["cuda:0"] * 4)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tpar.solve_distributed_streaming(op, b, mesh=mesh, **skw)
        torch.cuda.synchronize()
        return int(res.iterations), time.perf_counter() - t0

    tpar.solve_distributed_streaming(op, b, mesh=mesh, **dict(skw, maxiter=8))
    runs = [solve() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        its, wall = solve()
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.self_device_time_total
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        iterations=[i for i, _ in runs],
        iters_per_s=[i / t for i, t in runs],
        profiled=dict(
            iterations=its, wall_s=wall, device_busy_us=busy_us,
            idle_share=1 - busy_us * 1e-6 / wall if busy_us else None,
            kernels={name[:80]: dict(count=n, us=us) for name, (n, us) in top}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import cuda_mpi_parallel_tpu_torch as pt
    import cuda_mpi_parallel_tpu_torch.parallel as tpar
    from cuda_mpi_parallel_tpu_torch.models import poisson
    from cuda_mpi_parallel_tpu_torch.ops import cuda as hk

    t0 = time.perf_counter()
    hk.build_info()
    build_s = time.perf_counter() - t0
    gen = torch.Generator("cuda").manual_seed(SEED)
    pass_a, pass_b, host = passes(hk, gen)
    result = dict(tree=root, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, build_seconds=build_s,
                  pass_a=pass_a, pass_b=pass_b, host_us=host,
                  resident=resident(hk, pt, gen),
                  dist_streaming_256=lane(tpar, poisson, gen))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(smi.strip())
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
