"""Drive the PyTorch/CUDA port's main path on one Hopper card.

    python3 chip_smoke.py

Builds the hand kernels from ``cuda_mpi_parallel_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch twin at the main path's
shapes, then solves through ``solve()`` and the f64 lane's entry points: the north-star problem - 3D
Poisson at 256^3 - and its 2D sibling (4096^2, the same 16.8 M cells) on
the general and streaming engines; 2D Poisson at 1024^2 (BASELINE config
#2) and 3D at 128^3 on the one-launch resident engine; config #2 as its
assembled CSR (1,048,576 rows, 5,238,784 nonzeros) on the hand SpMV;
the preconditioned solves - a degree-4 Chebyshev at 256^3 on the
streaming engine (B5) and at 1024^2 inside the resident kernel, and
Jacobi on a 1 M-point unstructured FEM system (BASELINE config #5's
stand-in) on the hand SpMV; and the f64 lane at rtol 1e-10, the
reference's precision: ``cg_streaming_df64`` at 256^3 (B6/B7),
``cg_resident_df64`` at 1024^2 and with a degree-4 Chebyshev at
768 x 1024 (B11), ``cg_df64`` on config #2's CSR in float64 - the
reference's own configuration - and on the FEM system with Jacobi (B9),
and the oracle through ``cg_df64``; then the single-reduction and
pipelined methods: ``method="cg1"`` on the resident kernel's cg1 form at
1024^2 and 128^3, ``cg1`` and ``pipecg`` on the general engine at 256^3
(B2), compensated dots and a checkpointed, resumed solve at 1024^2 (B1),
and ``cg_df64(method="cg1"/"pipecg")`` on B9 at rtol 1e-10; then the
distributed solve on P shards of a stacked mesh on the one card:
``solve_distributed`` at 256^3 over four shards (B2 on each slab, and at
one shard through a ``torch.distributed`` NCCL rank), on config #2's CSR
over the allgather, gather and ring lanes, ``solve_distributed_streaming``
at 256^3 (B3/B4 with halos) and ``solve_distributed_resident`` at 1024^2
and 128^3 over 1, 2 and 4 shards (B12: every shard in one launch);
then MINRES, the solver for symmetric indefinite systems: the oracle
through ``solve(method="minres")`` and ``cg_df64(method="minres")``,
256^3 with B2 (``engine="auto"`` takes the general loop), and config
#2's matrix shifted to one negative eigenvalue on B8 (f32) and B9 (f64);
and the ELL/DIA formats and RCM reordering on config #2 and the FEM
system; then the telemetry core: the flight recorder on the
streaming engine at 256^3 beside the same solve without it, decimated
with the heartbeat on the general engine, on ``solve(engine="auto")`` at
1024^2 (the resident engine declines it) and on the B12 lane, the solve
health of the recorded solves, and the event stream they wrote; then
the geometric multigrid preconditioner: MG-PCG through ``solve()`` at
256^3 on B2 and at 1024^2 on B1, in the f64 lane at 1024^2 and over four
stacked slabs at 256^3; then the distributed f64 lane over four
stacked shards: ``solve_distributed_streaming_df64`` at 256^3 (B6/B7
with halos) and ``solve_distributed_df64`` at 256^3 (plain and MG-PCG)
and on config #2 (cg1, pipecg, minres, Jacobi, Chebyshev); and last the
ring shift-ELL lanes over four stacked shards, each ring step's slabs
one launch of the hand SpMV: ``csr_comm="ring-shiftell"`` on config
#2's CSR (B8; beside the ``ring`` and ``allgather`` lanes, and at one
shard bit-equal to the single-device solve) and on the FEM system with
Jacobi, and the CSR lane of ``solve_distributed_df64`` on config #2 in
float64 (B9: cg, cg1, a degree-4 Chebyshev); and the pencil
decomposition on a (4, 2) mesh of stacked shards: ``solve_distributed``
at 256^3 in f32 (plain, Chebyshev, MG) and ``solve_distributed_df64``
(cg and MG at 256^3, cg1, pipecg, Jacobi and Chebyshev at 128^3), and one
NCCL rank joined through ``parallel.multihost``; and last checkpoint,
resume and elastic migration: ``solve_resumable`` preempted and resumed
from disk at 256^3 on B2 and at 1024^2 on B1, ``solve_resumable_df64``
replaying on B11 and resuming the general f64 lane from disk at 1024^2,
and ``solve_resumable_distributed`` migrating config #2's CSR from 4
stacked shards to 2; and last the many-RHS tier and Krylov recycling:
``solve_many`` (masked batched and block CG) at 1024^2 x 8 and 256^3 x 4
on the column-stack instances of B1/B2 (one launch a stack, each grid
bit-equal to a single launch), config #2's CSR x 8 with Jacobi on one
device and through ``solve_distributed_many`` over 4 stacked shards,
``recycled_sequence`` on config #2's CSR and a deflated distributed
solve; and last fault injection, recovery and validation - plans on the
matvec (B1, B8, B2), the halo payload and the reduction, recovered by
``solve_with_recovery``, over 4 stacked shards and on the batched lane,
and the ``shard_loss`` migration 4 -> 3 - then the machine model of the
card, the roofline verdict of measured solves, the comm-layer cost
account of the distributed lanes and the autotuner (B1 against plain
torch, B8 against the CSR/ELL/DIA products, the winner on B10); then
the partition planner and the memory accounting (``plan_scope``); and
last the rest of telemetry and the straggler watchdog (``observatory``):
phase profiles of config #2's CSR lanes and the machine model fitted to
them, ``solve_sequence`` replanning the banded skew system on B8, solve
reports and Perfetto traces of B3/B4, B1 and CSR solves, the
``shard_slow`` drill migrating 4 -> 3 shards, request traces, an SLO
burn and a fleet merge.
The resident engine's f32 kernel B10 has two bodies - B12's at one
shard, which every square and cube takes, and a tile walk for the thin
grids past that body's shared slots - held bit-equal to each other; so
has its cg1 form (a one-barrier body on B12's machinery, and its tile
walk), and so has B11, the f64 kernel (B12's body in double, and its
tile walk).
Each phase prints one JSON line; any failure raises and the process
exits non-zero.  The last three lines are the card's name and power
limit as ``nvidia-smi`` prints them, the ``{"kernels": [...]}`` summary,
and ``{"ok": true, "device": {...}}``.

Launch counts: every kernel wrapper counts its launches; a main-path
phase resets the counts just before its port solve and reads them just
after, and the kernels line sums those readings.  The launches made to
compare a kernel with its twin, and to time it, are not counted.

Without a CUDA device the script exits 2 and prints nothing on stdout;
copied alone into a directory without the port beside it, it cannot
import the port and exits 1, again with nothing on stdout.
"""
from __future__ import annotations

import collections
import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

SEED = 0
GRID_3D = (256, 256, 256)
GRID_2D = (4096, 4096)
GRID_RES_2D = (1024, 1024)   # BASELINE config #2, and its assembled CSR
GRID_RES_3D = (128, 128, 128)
ARRAY_TOL = 1e-6     # max|kernel - twin| <= ARRAY_TOL * max|twin| (a few
#                      f32 ulps; both round every op alike, see common.cuh)
SCALAR_TOL = 1e-5    # relative: the sums run in another order than torch.sum
RESIDENT_TOL = 1e-5  # resident x: max|kernel - twin| <= RESIDENT_TOL *
#                      max|twin| after a whole solve.  The kernel sums pap
#                      and rr by blocks, torch.sum in its own order, so
#                      alpha and beta differ in the last bit now and then
#                      and x drifts apart over the iterations: 1.9e-6 *
#                      max|x| at 1024^2 on an H100.
TRACE_TOL = 1e-4     # relative, on rr and each ||r||^2 trace entry that ran
#                      (drift about 2e-6 with another summation order)
RESIDENT_KW = dict(tol=0.0, maxiter=200, check_every=32)  # the timed solve
SCALAR_TOL_F64 = 1e-12   # relative, the f64 sums (another order than
#                          torch.sum; the f64 arrays must be bit-equal)
RESIDENT_TOL_F64 = 1e-12  # B11's x: max|kernel - twin| <= this * max|twin|
TRACE_TOL_F64 = 1e-10    # relative, B11's rr and ||r||^2 trace entries
GRID_CHEB_F64 = (768, 1024)  # the largest 2D grid of seven f64 planes in L2
RTOL_F64 = 1e-10         # the f64 lane's phases
MAXITER_F64 = 20_000
CHEB_DEGREE = 4      # the Chebyshev preconditioner of the new phases
DIST_SHARDS = (1, 2, 4)  # shards of the stacked meshes on the one card
FEM_POINTS = 1_048_576   # BASELINE config #5's stand-in, thermal2's scale
TIMED = 25           # timed launches per kernel (median reported)
MANY_K_2D = 8        # columns of the many-RHS stacks: 1024^2 x 8 (32 MB a
MANY_K_3D = 4        # stack) and 256^3 x 4 (268 MB a stack)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMED):
    """Median device ms of ``fn`` over ``reps`` launches (CUDA events).
    A sleep kernel of about 0.1 s first lets the host queue all the
    launches ahead of the card, so each event pair brackets device work
    only, even when a busy host needs milliseconds per launch."""
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


def host_us(fn, reps: int = TIMED) -> float:
    """Mean host microseconds to make one call of ``fn`` (the wrapper's
    own cost; the card runs behind it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def check_array(name, got, want) -> float:
    err = max_err(got, want)
    limit = ARRAY_TOL * float(want.abs().max())
    if not err <= limit:
        raise AssertionError(f"{name}: max|d| {err} > {limit}")
    return err


def check_scalar(name, got, want, tol=SCALAR_TOL) -> float:
    rel = abs(float(got) - float(want)) / abs(float(want))
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel} > {tol}")
    return rel


def check_equal(name, got, want) -> float:
    """Bit for bit (the f64 kernels and twins round every op alike)."""
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to its twin (max|d| "
                             f"{max_err(got, want)})")
    return max_err(got, want)


def bits(t):
    """A tensor's bits, NaNs included, for a launch-to-launch compare."""
    if not t.is_floating_point():
        return t
    return t.reshape(-1).view(torch.int64 if t.element_size() == 8
                              else torch.int32)


def same_bits(u, v) -> bool:
    """Two launches' outputs (x, the scalars, the flags, the trace) bit
    for bit, NaNs too."""
    return all(torch.equal(bits(a), bits(c)) for a, c in zip(u, v))


def bound(n_bytes: float, n_ops: float, bw: float, flops: float):
    t_bytes, t_ops = n_bytes / bw, n_ops / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernels_phase(hk, pt, peak, gen, csr, sell, csr64, sell64):
    """The kernels against their twins at the main path's shapes, and
    timed: B1-B5, B10 (``cg_resident``, also at degree 4), B8
    (``shift_ell_matvec``) and the f64 lane's B6, B7, B9 and B11."""
    bw, flops, flops64 = peak
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    scale = torch.tensor(0.37, device="cuda")
    # B1 / B2: the stencils; library yardstick = one convolution call
    for name, grid, kernel, plain in (
            ("stencil2d_apply", GRID_2D, hk.stencil2d_apply,
             hk.stencil2d_apply_plain),
            ("stencil3d_apply", GRID_3D, hk.stencil3d_apply,
             hk.stencil3d_apply_plain)):
        x = randn(grid)
        err = check_array(name, kernel(x, scale), plain(x, scale))
        ndim = len(grid)
        w = stencil_weights(ndim, scale)
        conv = F.conv2d if ndim == 2 else F.conv3d
        xb = x[None, None]
        lib_err = max_err(conv(xb, w, padding=1)[0, 0], plain(x, scale))
        cells = math.prod(grid)
        rows[name] = dict(
            shape=list(grid), max_abs_err=err, library_max_abs_err=lib_err,
            ms=time_ms(lambda: kernel(x, scale)),
            host_us=host_us(lambda: kernel(x, scale)),
            plain_ms=time_ms(lambda: plain(x, scale)),
            library_ms=time_ms(lambda: conv(xb, w, padding=1)),
            bytes=2 * cells * 4 + 4,
            ops=(2 + 2 * ndim) * cells)
    # B1 / B2's column-stack instances (the many-RHS matmat): k grids in
    # one launch, bit-equal to k single launches; library yardstick = one
    # convolution over a batch of k (cuDNN with TF32 off, set above); from
    # their own stream, so the main path's inputs do not depend on them
    rows.update(cols_rows(hk, torch.Generator("cuda").manual_seed(SEED + 8),
                          scale))
    # B3 / B4: the fused passes, at 256^3 (timed) and at 4096^2 (checked)
    beta = torch.tensor(0.45, device="cuda")
    alpha = torch.tensor(1e-3, device="cuda")
    for grid in (GRID_3D, GRID_2D):
        r, p, x = randn(grid), randn(grid), randn(grid)
        pn_k, pap_k = hk.fused_cg_pass_a(scale, beta, r, p)
        pn_p, pap_p = hk.fused_cg_pass_a_plain(scale, beta, r, p)
        a_err = check_array("fused_cg_pass_a p_new", pn_k, pn_p)
        a_rel = check_scalar("fused_cg_pass_a pap", pap_k, pap_p)
        xk, rk, rr_k = hk.fused_cg_pass_b(scale, alpha, pn_p, x.clone(),
                                          r.clone())
        xp, rp, rr_p = hk.fused_cg_pass_b_plain(scale, alpha, pn_p,
                                                x.clone(), r.clone())
        b_err = max(check_equal("fused_cg_pass_b x", xk, xp),
                    check_equal("fused_cg_pass_b r", rk, rp))
        b_rel = check_scalar("fused_cg_pass_b rr", rr_k, rr_p)
        # theta and with_rz: checked, not on this slice's main path
        theta = torch.tensor(1.7, device="cuda")
        check_array("fused_cg_pass_a p_new (theta)",
                    hk.fused_cg_pass_a(scale, beta, r, p, theta=theta)[0],
                    hk.fused_cg_pass_a_plain(scale, beta, r, p,
                                             theta=theta)[0])
        xk, rk, rr2, rz2 = hk.fused_cg_pass_b(scale, alpha, pn_p, x.clone(),
                                              r.clone(), theta=1.7,
                                              with_rz=True)
        _, _, _, rz2_p = hk.fused_cg_pass_b_plain(scale, alpha, pn_p,
                                                  x.clone(), r.clone(),
                                                  theta=1.7, with_rz=True)
        check_equal("fused_cg_pass_b x (with_rz)", xk, xp)
        check_equal("fused_cg_pass_b r (with_rz)", rk, rp)
        check_scalar("fused_cg_pass_b rz", rz2, rz2_p)
        check_scalar("fused_cg_pass_b rr (with_rz)", rr2, rr_p)
        # B4's sums, with and without rz, repeat bit for bit
        for with_rz in (False, True):
            sums = {tuple(float(v) for v in hk.fused_cg_pass_b(
                        scale, alpha, pn_p, x.clone(), r.clone(), theta=1.7,
                        with_rz=with_rz)[2:]) for _ in range(2)}
            if len(sums) != 1:
                raise AssertionError(f"fused_cg_pass_b sums differ between "
                                     f"launches: {sums}")
        if grid != GRID_3D:
            spare = torch.empty_like(r)
            rows["fused_cg_pass_a"].update(
                shape_2d=list(grid), max_abs_err_2d=a_err,
                ms_2d=time_ms(lambda: hk.fused_cg_pass_a(scale, beta, r, p,
                                                         out=spare)))
            xt, rt = x.clone(), r.clone()
            rows["fused_cg_pass_b"].update(
                shape_2d=list(grid), max_abs_err_2d=b_err,
                ms_2d=time_ms(lambda: hk.fused_cg_pass_b(scale, alpha, pn_p,
                                                         xt, rt)))
            emit("kernels_2d_fused", shape=list(grid),
                 pass_a_max_abs_err=a_err, pass_a_pap_rel_err=a_rel,
                 pass_b_max_abs_err=b_err, pass_b_rr_rel_err=b_rel)
            continue
        cells = math.prod(grid)
        spare = torch.empty_like(r)
        one = torch.ones((), device="cuda")
        xt, rt = x.clone(), r.clone()

        def pass_a():
            return hk.fused_cg_pass_a(scale, beta, r, p, out=spare)

        def pass_b():
            return hk.fused_cg_pass_b(scale, alpha, pn_p, xt, rt)

        rows["fused_cg_pass_a"] = dict(
            shape=list(grid), max_abs_err=a_err, scalar_rel_err=a_rel,
            ms=time_ms(pass_a), host_us=host_us(pass_a),
            # theta = 1 takes the kernel's division path: the arithmetic
            # the unpreconditioned path ran before it was compiled out
            ms_divide_by_theta=time_ms(lambda: hk.fused_cg_pass_a(
                scale, beta, r, p, theta=one, out=spare)),
            plain_ms=time_ms(lambda: hk.fused_cg_pass_a_plain(scale, beta,
                                                              r, p)),
            library_ms=None, bytes=3 * cells * 4 + 8 + 4,
            ops=13 * cells)
        rows["fused_cg_pass_b"] = dict(
            shape=list(grid), max_abs_err=b_err, scalar_rel_err=b_rel,
            ms=time_ms(pass_b), host_us=host_us(pass_b),
            ms_with_rz=time_ms(lambda: hk.fused_cg_pass_b(
                scale, alpha, pn_p, xt, rt, theta=theta, with_rz=True)),
            plain_ms=time_ms(lambda: hk.fused_cg_pass_b_plain(
                scale, alpha, pn_p, xt, rt)),
            library_ms=None, bytes=5 * cells * 4 + 8 + 4,
            ops=14 * cells)
    rows["fused_cheb_step"] = cheb_row(hk, scale, randn)
    # B10 at 1024^2 (timed) and at 128^3, where each block walks several
    # tiles; the 3D rhs comes from its own stream, so the main path's
    # inputs do not depend on it
    b3 = torch.randn(GRID_RES_3D, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(SEED + 2))
    b_res = randn(GRID_RES_2D)
    rows["cg_resident"] = resident_row(hk, pt, scale, b_res, b3)
    rows["cg_resident_cg1"] = resident_cg1_row(hk, scale, b_res, b3)
    rows["cg_resident_dist_local"] = resident_dist_row(hk, pt, scale, b_res,
                                                       b3)
    # B3/B4 with halos (a slab of the 4-shard streaming solve), from their
    # own stream of inputs
    halo = halo_pass_rows(hk, scale,
                          torch.Generator("cuda").manual_seed(SEED + 6))
    rows["fused_cg_pass_a"].update(
        halo_slab=halo["shape"], halo_bit_equal=halo["bit_equal"],
        halo_scalar_rel_err=halo["pass_a_pap_rel_err"],
        ms_halo=halo["pass_a_ms_halo"],
        ms_slab_no_halo=halo["pass_a_ms_no_halo"])
    rows["fused_cg_pass_b"].update(
        halo_slab=halo["shape"], halo_bit_equal=halo["bit_equal"],
        halo_scalar_rel_err=halo["pass_b_rr_rel_err"],
        ms_halo=halo["pass_b_ms_halo"],
        ms_slab_no_halo=halo["pass_b_ms_no_halo"])
    rows["shift_ell_matvec"] = spmv_row(hk, csr, sell, randn(csr.n))
    # the f64 rows draw from their own stream, so the f32 main path's
    # inputs are those of the runs before the f64 lane
    rows.update(df64_rows(hk, pt,
                          torch.Generator("cuda").manual_seed(SEED + 3),
                          csr64, sell64))
    # B6/B7 with halos (slabs of the 4-shard f64 lanes), from their own
    # stream of inputs
    halo64 = halo_pass_rows_f64(hk,
                                torch.Generator("cuda").manual_seed(SEED + 7))
    for k, step in (("fused_cg_pass_a_df64", "pass_a"),
                    ("fused_cg_pass_b_df64", "pass_b")):
        rows[k]["halo_slabs"] = {
            label: dict(
                shape=h["shape"], bit_equal=h["bit_equal"],
                ms_halo=h[f"{step}_ms_halo"],
                ms_no_halo=h[f"{step}_ms_no_halo"],
                bytes_halo=h[f"{step}_bytes"], ops=h[f"{step}_ops"],
                bound_ms_halo=bound(h[f"{step}_bytes"], h[f"{step}_ops"], bw,
                                    flops64)[0],
                scalar_rel_err_halo=h[f"{step}_"
                                      f"{'pap' if step == 'pass_a' else 'rr'}"
                                      f"_rel_err_halo"])
            for label, h in halo64.items()}
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = bound(
            row["bytes"], row["ops"], bw, flops64 if row.get("fp64") else flops)
    cheb = rows["fused_cheb_step"]
    for step in ("first", "last"):
        cheb[f"bound_ms_{step}"], _ = bound(cheb[f"bytes_{step}"],
                                            cheb[f"ops_{step}"], bw, flops)
    res = rows["cg_resident"]
    res["bound_ms_degree"], _ = bound(res["bytes"], res["ops_degree"], bw,
                                      flops)
    res = rows["cg_resident_df64"]
    res["bound_ms_degree"], _ = bound(res["bytes_degree"], res["ops_degree"],
                                      bw, flops64)
    res["bound_ms_cube"], _ = bound(res["bytes_cube"], res["ops_cube"], bw,
                                    flops64)
    res = rows["cg_resident_cg1"]
    res["bound_ms_3d"], _ = bound(res["bytes_3d"], res["ops_3d"], bw, flops)
    emit("kernels", array_tol=ARRAY_TOL, scalar_tol=SCALAR_TOL,
         scalar_tol_f64=SCALAR_TOL_F64, timed_launches=TIMED, kernels=rows)
    return rows


def stencil_weights(ndim: int, scale):
    """The Laplacian as a 3^ndim convolution kernel, ``(1, 1, 3, ...)``."""
    w = torch.zeros((3,) * ndim, device="cuda")
    centre = (1,) * ndim
    w[centre] = 2.0 * ndim
    for axis in range(ndim):
        for off in (0, 2):
            idx = list(centre)
            idx[axis] = off
            w[tuple(idx)] = -1.0
    return (w * scale)[None, None]


def cols_rows(hk, gen, scale):
    """``stencil2d_apply_cols`` at 1024^2 x 8 and ``stencil3d_apply_cols``
    at 256^3 x 4 (the ``many_rhs`` phase's stacks): against their twins,
    each grid bit-equal to a single B1/B2 launch on it, timed beside the
    twin and ``conv2d``/``conv3d`` over a batch of k (TF32 off)."""
    import torch.nn.functional as F

    rows = {}
    for name, grid, k, kernel, plain, single in (
            ("stencil2d_apply_cols", GRID_RES_2D, MANY_K_2D,
             hk.stencil2d_apply_cols, hk.stencil2d_apply_cols_plain,
             hk.stencil2d_apply),
            ("stencil3d_apply_cols", GRID_3D, MANY_K_3D,
             hk.stencil3d_apply_cols, hk.stencil3d_apply_cols_plain,
             hk.stencil3d_apply)):
        xs = torch.randn((k,) + grid, generator=gen, device="cuda")
        got = kernel(xs, scale)
        err = check_array(name, got, plain(xs, scale))
        singles_equal = all(torch.equal(got[j], single(xs[j], scale))
                            for j in range(k))
        if not singles_equal:
            raise AssertionError(f"{name}: a grid differs from a single "
                                 f"launch on it")
        ndim = len(grid)
        w = stencil_weights(ndim, scale)
        conv = F.conv2d if ndim == 2 else F.conv3d
        xb = xs[:, None]
        lib_err = max_err(conv(xb, w, padding=1)[:, 0], plain(xs, scale))
        cells = k * math.prod(grid)
        rows[name] = dict(
            shape=[k, *grid], max_abs_err=err,
            bit_equal_single_launches=singles_equal,
            library_max_abs_err=lib_err,
            ms=time_ms(lambda: kernel(xs, scale)),
            host_us=host_us(lambda: kernel(xs, scale)),
            ms_k_single_launches=time_ms(
                lambda: [single(xs[j], scale) for j in range(k)]),
            plain_ms=time_ms(lambda: plain(xs, scale)),
            library_ms=time_ms(lambda: conv(xb, w, padding=1)),
            library="conv2d" if ndim == 2 else "conv3d",
            library_tf32=torch.backends.cudnn.allow_tf32,
            bytes=2 * cells * 4 + 4, ops=(2 + 2 * ndim) * cells)
    return rows


def df64_rows(hk, pt, gen, csr64, sell64):
    """The f64 lane's kernels against their twins, timed: B6/B7 at 256^3
    (arrays bit-equal, sums within SCALAR_TOL_F64), B9 on config #2's CSR
    in float64 (bit-equal; the yardstick cuSPARSE's f64 CSR product
    through ``torch.sparse_csr_tensor``) and B11 (``cg_resident_df64``)."""
    f64 = torch.float64

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=f64)

    scale, beta, alpha = (torch.tensor(v, device="cuda", dtype=f64)
                          for v in (0.37, 0.45, 1e-3))
    rows = {}
    r, p, x = (randn(GRID_3D) for _ in range(3))
    pn_k, pap_k = hk.fused_cg_pass_a_df64(scale, beta, r, p)
    pn_p, pap_p = hk.fused_cg_pass_a_plain(scale, beta, r, p)
    a_err = check_equal("fused_cg_pass_a_df64 p_new", pn_k, pn_p)
    a_rel = check_scalar("fused_cg_pass_a_df64 pap", pap_k, pap_p,
                         SCALAR_TOL_F64)
    xk, rk, rr_k = hk.fused_cg_pass_b_df64(scale, alpha, pn_p, x.clone(),
                                           r.clone())
    xp, rp, rr_p = hk.fused_cg_pass_b_plain(scale, alpha, pn_p, x.clone(),
                                            r.clone())
    b_err = max(check_equal("fused_cg_pass_b_df64 x", xk, xp),
                check_equal("fused_cg_pass_b_df64 r", rk, rp))
    b_rel = check_scalar("fused_cg_pass_b_df64 rr", rr_k, rr_p,
                         SCALAR_TOL_F64)
    del xk, rk, xp, rp
    cells = math.prod(GRID_3D)
    spare = torch.empty_like(r)
    xt, rt = x.clone(), r.clone()

    def pass_a():
        return hk.fused_cg_pass_a_df64(scale, beta, r, p, out=spare)

    def pass_b():
        return hk.fused_cg_pass_b_df64(scale, alpha, pn_p, xt, rt)

    rows["fused_cg_pass_a_df64"] = dict(
        shape=list(GRID_3D), max_abs_err=a_err, scalar_rel_err=a_rel,
        ms=time_ms(pass_a), host_us=host_us(pass_a),
        plain_ms=time_ms(lambda: hk.fused_cg_pass_a_plain(scale, beta, r,
                                                          p)),
        library_ms=None, bytes=3 * cells * 8 + 16 + 8, ops=13 * cells,
        fp64=True)
    rows["fused_cg_pass_b_df64"] = dict(
        shape=list(GRID_3D), max_abs_err=b_err, scalar_rel_err=b_rel,
        ms=time_ms(pass_b), host_us=host_us(pass_b),
        plain_ms=time_ms(lambda: hk.fused_cg_pass_b_plain(
            scale, alpha, pn_p, xt, rt)),
        library_ms=None, bytes=5 * cells * 8 + 16 + 8, ops=14 * cells,
        fp64=True)
    del r, p, x, pn_k, pn_p, spare, xt, rt
    v = randn(csr64.n)
    args = (sell64.vals, sell64.cols, sell64.slice_ptr, csr64.n)
    err = check_equal("shift_ell_matvec_df64", hk.shift_ell_matvec(v, *args),
                      hk.shift_ell_matvec_plain(v, *args))
    lib = torch.sparse_csr_tensor(csr64.indptr, csr64.indices, csr64.data,
                                  size=csr64.shape)
    slots = sell64.vals.numel()
    rows["shift_ell_matvec_df64"] = dict(
        shape=list(csr64.shape), nnz=csr64.nnz, slots=slots, max_abs_err=err,
        library_max_abs_err=max_err(lib @ v, csr64.matvec(v)),
        ms=time_ms(lambda: hk.shift_ell_matvec(v, *args)),
        host_us=host_us(lambda: hk.shift_ell_matvec(v, *args)),
        plain_ms=time_ms(lambda: hk.shift_ell_matvec_plain(v, *args),
                         reps=5),
        library_ms=time_ms(lambda: lib @ v),
        # each slot's f64 value and int32 column, the slice offsets, x
        # and y once
        bytes=slots * 12 + sell64.slice_ptr.numel() * 8 + 2 * csr64.n * 8,
        ops=2 * csr64.nnz, fp64=True)
    rows["cg_resident_df64"] = resident_df64_row(hk, pt, scale, randn)
    return rows


def interval_of(pt, op):
    """(theta, delta) of ``solver.df64.chebyshev_interval`` as floats."""
    from cuda_mpi_parallel_tpu_torch.solver import df64

    return tuple(float(h) + float(lo)
                 for h, lo in df64.chebyshev_interval(op))


def resident_df64_row(hk, pt, scale, randn):
    """B11 at 1024^2 (200 iterations, check blocks of 32), cold and from
    a warm start, with the degree-4 Chebyshev at 768 x 1024 (its interval
    from the stencil) and on the largest cube the five-plane f64 gate
    admits (109^3 on an H100, the main path's third B11 launch) against
    its twin, timed per launch.  At each, its two bodies (B12's in
    double, which these shapes take, and the tile walk) and the solver's
    launch give the same bits; the row keeps the sha256 of each x and
    times the tile walk too."""
    b = randn(GRID_RES_2D)
    err, x_rel, trace_rel, got = check_resident(
        hk, "cg_resident_df64", scale, b, f64=True, **RESIDENT_KW)
    theta, delta = interval_of(pt, pt.Stencil2D.create(
        *GRID_CHEB_F64, scale=float(scale), backend="xla"))
    ckw = dict(RESIDENT_KW, precond_degree=CHEB_DEGREE, theta=theta,
               delta=delta)
    bc = randn(GRID_CHEB_F64)
    err_c, x_rel_c, trace_rel_c, got_c = check_resident(
        hk, f"cg_resident_df64 degree {CHEB_DEGREE}", scale, bc, f64=True,
        **ckw)
    xw = randn(GRID_RES_2D)
    err_w, x_rel_w, trace_rel_w, got_w = check_resident(
        hk, "cg_resident_df64 warm", scale, b, xw, f64=True, **RESIDENT_KW)
    iters, iters_c = int(got[1]), int(got_c[1])
    ms = time_ms(lambda: hk.cg_resident_df64_2d(scale, b, **RESIDENT_KW),
                 reps=10)
    ms_c = time_ms(lambda: hk.cg_resident_df64_2d(scale, bc, **ckw), reps=10)
    n = 1
    while hk.supports_resident_df64_3d(n + 1, n + 1, n + 1):
        n += 1
    bq = torch.randn((n, n, n), device="cuda", dtype=torch.float64,
                     generator=torch.Generator("cuda").manual_seed(SEED + 7))
    err_q, x_rel_q, trace_rel_q, got_q = check_resident(
        hk, f"cg_resident_df64 {n}^3", scale, bq, f64=True, **RESIDENT_KW)
    iters_q = int(got_q[1])
    ms_q = time_ms(lambda: hk.cg_resident_df64_3d(scale, bq, **RESIDENT_KW),
                   reps=10)
    x_sha256 = {
        "1024": check_bodies(hk, "cg_resident_df64", scale, b, got=got,
                             **RESIDENT_KW),
        "1024_warm": check_bodies(hk, "cg_resident_df64 warm", scale, b, xw,
                                  got=got_w, **RESIDENT_KW),
        f"768x1024_degree_{CHEB_DEGREE}": check_bodies(
            hk, f"cg_resident_df64 degree {CHEB_DEGREE}", scale, bc,
            got=got_c, **ckw),
        f"{n}^3": check_bodies(hk, f"cg_resident_df64 {n}^3", scale, bq,
                               got=got_q, **RESIDENT_KW)}
    ms_walk = time_ms(lambda: b10_body(hk, scale, b, 2, **RESIDENT_KW),
                      reps=10)
    ms_c_walk = time_ms(lambda: b10_body(hk, scale, bc, 2, **ckw), reps=10)
    ms_q_walk = time_ms(lambda: b10_body(hk, scale, bq, 2, **RESIDENT_KW),
                        reps=10)
    twin = dict(tol=0.0, rtol=0.0, cap=RESIDENT_KW["maxiter"],
                nblocks=-(-RESIDENT_KW["maxiter"]
                          // RESIDENT_KW["check_every"]),
                check_every=RESIDENT_KW["check_every"])
    cells, cells_c, cells_q = b.numel(), bc.numel(), bq.numel()
    return dict(
        shape=list(b.shape), max_abs_err=max(err, err_c, err_q, err_w),
        x_rel_err=x_rel,
        trace_rel_err=trace_rel, iterations=iters, ms=ms,
        us_per_iteration=ms * 1e3 / iters, ms_tile_walk=ms_walk,
        x_rel_err_warm=x_rel_w, trace_rel_err_warm=trace_rel_w,
        iterations_warm=int(got_w[1]), degree=CHEB_DEGREE,
        shape_degree=list(bc.shape), max_abs_err_degree=err_c,
        x_rel_err_degree=x_rel_c, trace_rel_err_degree=trace_rel_c,
        iterations_degree=iters_c, ms_degree=ms_c,
        us_per_iteration_degree=ms_c * 1e3 / iters_c,
        ms_degree_tile_walk=ms_c_walk, theta=theta, delta=delta,
        # per cell: as for B10 (16 a plain iteration, 11 a 2D Chebyshev
        # step, 1 for the first step's division, 2 for the last's r . z')
        ops_degree=cells_c * (2 + (16 + (2 + 2 * 2 + 5) * (CHEB_DEGREE - 1)
                                   + 1 + 2) * iters_c),
        bytes_degree=2 * cells_c * 8 + 5 * 8 + 4,
        shape_cube=list(bq.shape), max_abs_err_cube=err_q,
        x_rel_err_cube=x_rel_q, trace_rel_err_cube=trace_rel_q,
        iterations_cube=iters_q, ms_cube=ms_q,
        us_per_iteration_cube=ms_q * 1e3 / iters_q,
        ms_cube_tile_walk=ms_q_walk,
        # as at 1024^2, with the 3D stencil's 8 flops a cell for 6
        ops_cube=cells_q * (2 + 18 * iters_q),
        bytes_cube=2 * cells_q * 8 + 5 * 8 + 4,
        x_sha256=x_sha256, bodies_bit_equal=True,
        blocks_per_sm={f"{'3d' if t else '2d'}_{'cheb' if p else 'plain'}":
                       resident_blocks_per_sm(hk, t, p, f64=True)
                       for t in (False, True) for p in (False, True)},
        blocks_per_sm_tile_walk={
            f"{'3d' if t else '2d'}_{'cheb' if p else 'plain'}":
            resident_blocks_per_sm(hk, t, p, f64=True, tile_walk=True)
            for t in (False, True) for p in (False, True)},
        plain_ms=time_ms(lambda: hk.cg_resident_df64_plain(scale, b, **twin),
                         reps=3),
        library_ms=None, bytes=2 * cells * 8 + 5 * 8 + 4,
        ops=cells * (2 + 16 * iters), fp64=True)


def cheb_row(hk, scale, randn):
    """B5 at 256^3: the first, a middle and the last step against the
    twin, each timed; the row's ms and bound are the middle step's, the
    one a degree-k application repeats k - 3 times."""
    theta, c1, c2 = (torch.tensor(v, device="cuda")
                     for v in (0.19, 0.71, 0.47))
    r, z, d = (randn(GRID_3D) for _ in range(3))
    cells = math.prod(GRID_3D)
    out = {}
    for step, first, last in (("first", True, False),
                              ("middle", False, False),
                              ("last", False, True)):
        args = (scale, theta, c1, c2, r if first else z,
                None if first else r, None if first else d)
        kw = dict(first=first, last=last)
        got = hk.fused_cheb_step(*args, **kw)
        want = hk.fused_cheb_step_plain(*args, **kw)
        err = max(check_array(f"fused_cheb_step {step} z", got[0], want[0]),
                  check_array(f"fused_cheb_step {step} d", got[1], want[1]))
        rel = check_scalar(f"fused_cheb_step {step} rho", got[2],
                           want[2]) if last else None
        zs, ds = torch.empty_like(r), torch.empty_like(r)
        planes = 3 if first else 5
        # 13 flops a point: the stencil (7 and the scale), r - Az, the two
        # products and two sums; the first divides by theta, the last adds
        # r . z'
        ops = (13 + (1 if first else 0) + (2 if last else 0)) * cells
        out[step] = dict(
            max_abs_err=err, scalar_rel_err=rel,
            ms=time_ms(lambda: hk.fused_cheb_step(*args, out=zs, d_out=ds,
                                                  **kw)),
            bytes=planes * cells * 4 + 16, ops=ops)
    mid = out["middle"]
    return dict(
        shape=list(GRID_3D), max_abs_err=max(v["max_abs_err"]
                                             for v in out.values()),
        scalar_rel_err=out["last"]["scalar_rel_err"], ms=mid["ms"],
        ms_first=out["first"]["ms"], ms_last=out["last"]["ms"],
        host_us=host_us(lambda: hk.fused_cheb_step(
            scale, theta, c1, c2, z, r, d, first=False, last=False)),
        plain_ms=time_ms(lambda: hk.fused_cheb_step_plain(
            scale, theta, c1, c2, z, r, d, first=False, last=False)),
        library_ms=None, bytes=mid["bytes"], ops=mid["ops"],
        bytes_first=out["first"]["bytes"], ops_first=out["first"]["ops"],
        bytes_last=out["last"]["bytes"], ops_last=out["last"]["ops"])


def check_resident(hk, name, scale, b, x0=None, f64=False, method="cg",
                   **kw):
    """The resident kernel (B10, its cg1 form with ``method="cg1"``, or
    B11 with ``f64``) against its twin on ``b``: equal iteration counts
    and flags, x within RESIDENT_TOL, rr and the ||r||^2 trace within
    TRACE_TOL (the _F64 limits for B11; -1 in the same blocks), and the
    same bits from a second launch.  Returns (max|dx|, x and trace
    relative errors, kernel outputs)."""
    if method == "cg1":
        fn = functools.partial(hk.cg_resident_2d if b.ndim == 2
                               else hk.cg_resident_3d, method="cg1")

        def plain(*args, precond_degree, **pkw):
            return hk.cg_resident_cg1_plain(*args, **pkw)
        x_tol, trace_tol, interval = RESIDENT_TOL, TRACE_TOL, {}
    elif f64:
        fn = hk.cg_resident_df64_2d if b.ndim == 2 else hk.cg_resident_df64_3d
        plain, x_tol, trace_tol = (hk.cg_resident_df64_plain,
                                   RESIDENT_TOL_F64, TRACE_TOL_F64)
        interval = dict(theta=kw.get("theta", 1.0),
                        delta=kw.get("delta", 1.0))
    else:
        fn = hk.cg_resident_2d if b.ndim == 2 else hk.cg_resident_3d
        plain, x_tol, trace_tol = (hk.cg_resident_plain, RESIDENT_TOL,
                                   TRACE_TOL)
        interval = dict(lmin=kw.get("lmin", 0.0), lmax=kw.get("lmax", 1.0))
    got = fn(scale, b, x0=x0, **kw)
    if not same_bits(got, fn(scale, b, x0=x0, **kw)):
        raise AssertionError(f"{name}: two launches differ")
    nblocks = -(-kw["maxiter"] // kw["check_every"])
    want = plain(
        scale, b, x0, tol=kw.get("tol", 0.0), rtol=kw.get("rtol", 0.0),
        cap=kw["maxiter"], nblocks=nblocks, check_every=kw["check_every"],
        precond_degree=kw.get("precond_degree", 0), **interval)
    flags = [int(v) for v in (got[1], *got[3:6])]
    if flags != [int(v) for v in (want[1], *want[3:6])] \
            or got[6].shape != want[6].shape:
        raise AssertionError(f"{name}: iterations/flags {flags} differ "
                             f"from the twin's")
    err = max_err(got[0], want[0])
    x_max = float(want[0].abs().max())
    # x = 0 (a breakdown at the first check) must match exactly
    x_rel = err / x_max if x_max else (0.0 if err == 0 else math.inf)
    if not x_rel <= x_tol:
        raise AssertionError(f"{name}: max|dx| {err} = {x_rel} * max|x|")
    ran = want[6] != -1.0
    if not torch.equal(got[6] != -1.0, ran):
        raise AssertionError(f"{name}: the trace's blocks that ran differ")
    trace = torch.cat([got[2].reshape(1), got[6][ran]]).double()
    ref = torch.cat([want[2].reshape(1), want[6][ran]]).double()
    gap = (trace - ref).abs()
    if not bool((gap <= trace_tol * ref.abs()).all()):
        raise AssertionError(f"{name}: rr or the trace differ from the "
                             f"twin's: {trace.tolist()} vs {ref.tolist()}")
    trace_rel = float((gap / ref.abs().clamp_min(1e-30)).max())
    return err, x_rel, trace_rel, got


def resident_cg1_row(hk, scale, b, b3):
    """B10's cg1 form at 1024^2 and at 128^3 on the inputs of the
    ``cg_resident`` row: a fixed-length solve (200 iterations, check
    blocks of 32) against its twin, timed per launch beside the plain
    kernel's B10 times.  At each, its two bodies (the one-barrier body,
    which these shapes take, and the tile walk) give the same bits; the
    row keeps the sha256 of each x and times the tile walk too.  Both
    resident kernels are also timed at 96^3, where the planes the
    iterations touch (17 and 14 MiB: cg1 five on the tile walk, B10 four)
    sit well inside the L2, against 40 and 32 MiB of its 50 at 128^3."""
    kw = dict(RESIDENT_KW, method="cg1")
    err, x_rel, trace_rel, got = check_resident(
        hk, "cg_resident_cg1", scale, b, method="cg1", **RESIDENT_KW)
    err3, x_rel3, trace_rel3, got3 = check_resident(
        hk, "cg_resident_cg1 3D", scale, b3, method="cg1", **RESIDENT_KW)
    x_sha256 = {
        "1024": check_bodies(hk, "cg_resident_cg1", scale, b, got=got, **kw),
        "128": check_bodies(hk, "cg_resident_cg1 3D", scale, b3, got=got3,
                            **kw)}
    iters, iters3 = int(got[1]), int(got3[1])
    ms = time_ms(lambda: hk.cg_resident_2d(scale, b, **kw), reps=10)
    ms3 = time_ms(lambda: hk.cg_resident_3d(scale, b3, **kw), reps=10)
    ms_walk = time_ms(lambda: b10_body(hk, scale, b, 2, **kw), reps=10)
    ms3_walk = time_ms(lambda: b10_body(hk, scale, b3, 2, **kw), reps=10)
    b96 = torch.randn((96, 96, 96), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(SEED + 6))
    us_96 = {name: time_ms(lambda: hk.cg_resident_3d(
        scale, b96, **dict(RESIDENT_KW, method=method)), reps=10) * 1e3
        / RESIDENT_KW["maxiter"] for name, method in (("cg1", "cg1"),
                                                      ("cg", "cg"))}
    twin = dict(tol=0.0, rtol=0.0, cap=RESIDENT_KW["maxiter"],
                nblocks=-(-RESIDENT_KW["maxiter"]
                          // RESIDENT_KW["check_every"]),
                check_every=RESIDENT_KW["check_every"])
    cells, cells3 = b.numel(), b3.numel()
    return dict(
        shape=list(b.shape), max_abs_err=max(err, err3),
        max_abs_err_2d=err, x_rel_err=x_rel, trace_rel_err=trace_rel,
        iterations=iters, ms=ms, us_per_iteration=ms * 1e3 / iters,
        ms_tile_walk=ms_walk,
        shape_3d=list(b3.shape), max_abs_err_3d=err3, x_rel_err_3d=x_rel3,
        trace_rel_err_3d=trace_rel3, iterations_3d=iters3, ms_3d=ms3,
        us_per_iteration_3d=ms3 * 1e3 / iters3, ms_3d_tile_walk=ms3_walk,
        us_per_iteration_96=us_96, x_sha256=x_sha256, bodies_bit_equal=True,
        blocks_per_sm={f"{'3d' if t else '2d'}_cg1":
                       resident_blocks_per_sm(hk, t, False, cg1=True)
                       for t in (False, True)},
        blocks_per_sm_tile_walk={
            f"{'3d' if t else '2d'}_cg1": resident_blocks_per_sm(
                hk, t, False, cg1=True, tile_walk=True)
            for t in (False, True)},
        plain_ms=time_ms(lambda: hk.cg_resident_cg1_plain(scale, b, **twin),
                         reps=3),
        library_ms=None,
        # b read and x written once.  Flops per cell, counted from
        # resident_cg1_kernel: the init's w0 = A r0 (2 + 2 ndim: the
        # Laplacian and its scale) and the r.r and w.r partials (4); each
        # iteration's pass 1 p, s, x, r updates (8: four multiply-adds),
        # pass 2 stencil (2 + 2 ndim) and partials (4): 18 in 2D
        bytes=2 * cells * 4 + 3 * 4 + 4,
        ops=cells * (6 + 2 * b.ndim + (14 + 2 * b.ndim) * iters),
        bytes_3d=2 * cells3 * 4 + 3 * 4 + 4,
        ops_3d=cells3 * (6 + 2 * b3.ndim + (14 + 2 * b3.ndim) * iters3))


def b10_body(hk, scale, b, instance, x0=None, *, maxiter, check_every,
             tol=0.0, rtol=0.0, precond_degree=0, lmin=0.0, lmax=1.0,
             theta=1.0, delta=1.0, method="cg"):
    """One launch of B10 (its cg1 form with ``method="cg1"``; B11 on an
    f64 ``b``, its interval ``theta``, ``delta``) on the body
    ``instance`` names (1: B12's at one shard, for cg1 the one-barrier
    body on B12's machinery; 2: the tile walk; 0: the shape's, as the
    solver takes it)."""
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident as rk

    check_every = max(1, min(check_every, maxiter))
    p3, p4 = ((theta, delta) if b.dtype == torch.float64
              else (lmin, lmax))
    return rk._cg_resident_call(
        scale, tol, rtol, p3, p4, maxiter, b, x0, maxiter=maxiter,
        check_every=check_every, degree=precond_degree, method=method,
        instance=instance)


def check_bodies(hk, name, scale, b, x0=None, got=None, **kw):
    """B10's two bodies on ``b`` (its cg1 form's with ``method="cg1"``,
    B11's on an f64 ``b``): B12's at one shard or the one-barrier body
    (instance 1) and the tile walk (instance 2) give the same bits, and so
    does the solver's launch ``got`` (instance 0) when given.  Returns the
    sha256 of x's bytes."""
    on_b12 = b10_body(hk, scale, b, 1, x0, **kw)
    walked = b10_body(hk, scale, b, 2, x0, **kw)
    if not same_bits(on_b12, walked):
        raise AssertionError(f"{name}: instance 1 and the tile walk differ "
                             f"(iterations {int(on_b12[1])} / "
                             f"{int(walked[1])}, max|dx| "
                             f"{max_err(on_b12[0], walked[0])})")
    if got is not None and not same_bits(got, on_b12):
        raise AssertionError(f"{name}: the solver's launch is not instance "
                             f"1's bits")
    return sha256(on_b12[0])


def check_past_slots(hk, name, scale, b, x0, got, **kw):
    """A grid past B12's slots (in f32, or in double for B11): the
    solver's launch ``got`` is the tile walk's bits (instance 2), and
    instance 1 refuses the grid."""
    if not same_bits(got, b10_body(hk, scale, b, 2, x0, **kw)):
        raise AssertionError(f"{name}: the solver's launch is not the "
                             f"tile walk's bits")
    try:
        b10_body(hk, scale, b, 1, x0, **kw)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"{name}: instance 1 took a grid past the "
                             f"slots")


def sha256(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def resident_row(hk, pt, scale, b, b3):
    """B10 at 1024^2 and at 128^3: a fixed-length solve (200 iterations,
    check blocks of 32) against its twin, timed per launch; and at 1024^2
    with the degree-4 Chebyshev inside (its interval from the stencil).
    At each, its two bodies (B12's at one shard, which these shapes take,
    and the tile walk) give the same bits; the row keeps the sha256 of
    each x."""
    err, x_rel, trace_rel, got = check_resident(hk, "cg_resident", scale, b,
                                                **RESIDENT_KW)
    err3, x_rel3, trace_rel3, got3 = check_resident(
        hk, "cg_resident 3D", scale, b3, **RESIDENT_KW)
    cheb = pt.ChebyshevPreconditioner.from_operator(
        pt.Stencil2D.create(*GRID_RES_2D, scale=scale), degree=CHEB_DEGREE)
    ckw = dict(RESIDENT_KW, precond_degree=CHEB_DEGREE, lmin=cheb.lmin,
               lmax=cheb.lmax)
    err_c, x_rel_c, trace_rel_c, got_c = check_resident(
        hk, f"cg_resident degree {CHEB_DEGREE}", scale, b, **ckw)
    x_sha256 = {
        "1024": check_bodies(hk, "cg_resident", scale, b, got=got,
                             **RESIDENT_KW),
        "128": check_bodies(hk, "cg_resident 3D", scale, b3, got=got3,
                            **RESIDENT_KW),
        f"1024_degree_{CHEB_DEGREE}": check_bodies(
            hk, f"cg_resident degree {CHEB_DEGREE}", scale, b, got=got_c,
            **ckw)}
    ms_c = time_ms(lambda: hk.cg_resident_2d(scale, b, **ckw), reps=10)
    iters_c = int(got_c[1])
    iters = int(got[1])
    twin = dict(tol=0.0, rtol=0.0, cap=RESIDENT_KW["maxiter"],
                nblocks=-(-RESIDENT_KW["maxiter"]
                          // RESIDENT_KW["check_every"]),
                check_every=RESIDENT_KW["check_every"])
    ms = time_ms(lambda: hk.cg_resident_2d(scale, b, **RESIDENT_KW),
                 reps=10)
    cells = b.numel()
    ms3 = time_ms(lambda: hk.cg_resident_3d(scale, b3, **RESIDENT_KW),
                  reps=10)
    return dict(
        shape=list(b.shape), max_abs_err=max(err, err3, err_c),
        max_abs_err_2d=err, x_rel_err=x_rel, trace_rel_err=trace_rel,
        iterations=iters, ms=ms, us_per_iteration=ms * 1e3 / iters,
        degree=CHEB_DEGREE, max_abs_err_degree=err_c,
        x_rel_err_degree=x_rel_c, trace_rel_err_degree=trace_rel_c,
        iterations_degree=iters_c, ms_degree=ms_c,
        us_per_iteration_degree=ms_c * 1e3 / iters_c,
        lmin=float(cheb.lmin), lmax=float(cheb.lmax),
        # per cell and iteration: 16 as above, and per Chebyshev step the
        # stencil with its scale (2 + 2 ndim) and 5 for the step itself;
        # 1 more for the first step's division by theta and 2 for the
        # last step's r . z' (phase 2 sums only r . r)
        ops_degree=cells * (2 + (16 + (2 + 2 * b.ndim + 5)
                                 * (CHEB_DEGREE - 1) + 1 + 2) * iters_c),
        x_sha256=x_sha256, bodies_bit_equal=True,
        blocks_per_sm={f"{'3d' if t else '2d'}_{'cheb' if p else 'plain'}":
                       resident_blocks_per_sm(hk, t, p)
                       for t in (False, True) for p in (False, True)},
        blocks_per_sm_tile_walk={
            f"{'3d' if t else '2d'}_{'cheb' if p else 'plain'}":
            resident_blocks_per_sm(hk, t, p, tile_walk=True)
            for t in (False, True) for p in (False, True)},
        shape_3d=list(b3.shape), max_abs_err_3d=err3, x_rel_err_3d=x_rel3,
        trace_rel_err_3d=trace_rel3, iterations_3d=int(got3[1]), ms_3d=ms3,
        us_per_iteration_3d=ms3 * 1e3 / int(got3[1]),
        plain_ms=time_ms(lambda: hk.cg_resident_plain(scale, b, **twin),
                         reps=3),
        library_ms=None,
        # b read and x written once; 2 flops/cell for rr0, then per
        # iteration 6 (stencil) + 2 (pap) + 2 + 2 (x, r) + 2 (rr) + 2 (p)
        bytes=2 * cells * 4 + 3 * 4 + 4,
        ops=cells * (2 + 16 * iters))


def resident_blocks_per_sm(hk, three_d: bool, precond: bool,
                           f64: bool = False, cg1: bool = False,
                           tile_walk: bool = False) -> int:
    """Resident blocks per SM of a B10 (B11 with ``f64``, the cg1 form
    with ``cg1``) variant on this card, by the built library's occupancy
    query: what the cooperative grid is sized by.  B10's is that of
    B12's body at its slots (the cg1 form's: its one-barrier body's), or
    with ``tile_walk`` the tile walk's."""
    n = hk._build.library().cmpt_cg_resident_blocks_per_sm(
        int(three_d), int(precond), int(f64), int(cg1), int(tile_walk))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: cudaError_t {-n}")
    return n


def spmv_row(hk, csr, sell, x):
    """B8 on the assembled 1024^2 CSR against its twin (bit for bit: the
    same slot order and rounding), timed; the yardstick is cuSPARSE's CSR
    product through ``torch.sparse_csr_tensor``, which the port never
    calls."""
    args = (sell.vals, sell.cols, sell.slice_ptr, csr.n)
    err = check_array("shift_ell_matvec", hk.shift_ell_matvec(x, *args),
                      hk.shift_ell_matvec_plain(x, *args))
    lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                  size=csr.shape)
    lib_err = max_err(lib @ x, csr.matvec(x))
    slots = sell.vals.numel()
    return dict(
        shape=list(csr.shape), nnz=csr.nnz, slots=slots, max_abs_err=err,
        library_max_abs_err=lib_err,
        ms=time_ms(lambda: hk.shift_ell_matvec(x, *args)),
        host_us=host_us(lambda: hk.shift_ell_matvec(x, *args)),
        plain_ms=time_ms(lambda: hk.shift_ell_matvec_plain(x, *args),
                         reps=5),
        library_ms=time_ms(lambda: lib @ x),
        # each slot's value and column, the slice offsets, x and y once
        bytes=slots * 8 + sell.slice_ptr.numel() * 8 + 2 * csr.n * 4,
        ops=2 * csr.nnz)


def ragged_phase(hk, pt, poisson, gen):
    """The kernels against their twins where the tile walk does not
    divide the grid (partial plane walks, rows, columns; single cells),
    the resident kernel's preconditioned branches at degrees 1 to 4 and
    the Chebyshev step's four variants, the fused sums' determinism, and
    a streaming solve on such a grid.  The preconditioned solves stop
    after 16 iterations, well before ||r||^2 reaches f32 rounding, where
    two summation orders would part."""
    checks, worst = 0, 0.0
    scale = torch.tensor(0.37, device="cuda")
    beta = torch.tensor(0.45, device="cuda")
    alpha = torch.tensor(0.11, device="cuda")
    theta = torch.tensor(1.7, device="cuda")
    for shape in ((1, 1), (3, 200), (17, 257),
                  (1, 1, 1), (3, 5, 7), (9, 17, 33)):
        kernel, plain = ((hk.stencil2d_apply, hk.stencil2d_apply_plain)
                         if len(shape) == 2
                         else (hk.stencil3d_apply, hk.stencil3d_apply_plain))
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            s = scale.to(dtype)
            worst = max(worst, check_array(f"stencil {shape} {dtype}",
                                           kernel(x, s), plain(x, s)))
            checks += 1
        r, p, x = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        for th in (None, theta):
            got, want = (f(scale, beta, r, p, theta=th) for f in
                         (hk.fused_cg_pass_a, hk.fused_cg_pass_a_plain))
            worst = max(worst, check_array(f"pass A {shape}", got[0],
                                           want[0]))
            check_scalar(f"pass A pap {shape}", got[1], want[1])
            checks += 1
        for with_rz in (False, True):
            th = theta if with_rz else None
            got, want = (f(scale, alpha, p, x.clone(), r.clone(), theta=th,
                           with_rz=with_rz) for f in
                         (hk.fused_cg_pass_b, hk.fused_cg_pass_b_plain))
            for g, w in zip(got[:2], want[:2]):
                worst = max(worst, check_equal(f"pass B {shape}", g, w))
            for g, w in zip(got[2:], want[2:]):
                check_scalar(f"pass B sums {shape}", g, w)
            checks += 1
    r, p = (torch.randn((9, 17, 33), generator=gen, device="cuda")
            for _ in range(2))
    paps = {float(hk.fused_cg_pass_a(scale, beta, r, p)[1])
            for _ in range(5)}
    if len(paps) != 1:
        raise AssertionError(f"pass A sums differ between runs: {paps}")
    # the resident kernel: single cell, ragged 2D and 3D, and a warm start,
    # each on both of B10's bodies (bit-equal: the tile walk is held to
    # the twin through B12's body)
    res_worst = res_x_rel = res_trace_rel = 0.0
    for shape, x0 in (((1, 1), False), ((7, 130), False), ((7, 130), True),
                      ((9, 17, 33), False), ((9, 17, 33), True)):
        b = torch.randn(shape, generator=gen, device="cuda")
        start = torch.randn(shape, generator=gen, device="cuda") \
            if x0 else None
        kw = dict(tol=0.0, maxiter=30, check_every=8)
        err, x_rel, trace_rel, got = check_resident(
            hk, f"cg_resident {shape}", scale, b, start, **kw)
        check_bodies(hk, f"cg_resident {shape}", scale, b, start, got=got,
                     **kw)
        res_worst = max(res_worst, err)
        res_x_rel = max(res_x_rel, x_rel)
        res_trace_rel = max(res_trace_rel, trace_rel)
        checks += 1
    bodies = b10_bodies(hk, pt, scale, gen)
    res_worst = max(res_worst, bodies.pop("max_abs_err"))
    res_x_rel = max(res_x_rel, bodies["x_rel_err"])
    res_trace_rel = max(res_trace_rel, bodies["trace_rel_err"])
    checks += bodies["checks"]
    # B10's preconditioned branches at each degree (1: z = r / theta
    # formed where it is used; 2: one first-and-last step; 3: z ends in
    # the second buffer; 4: a middle step), one with a warm start, each on
    # both bodies, and B5's four step variants (first and/or last), on the
    # same intervals
    for shape in ((16, 128), (9, 17, 33)):
        stencil = pt.Stencil2D if len(shape) == 2 else pt.Stencil3D
        m = pt.ChebyshevPreconditioner.from_operator(
            stencil.create(*shape, scale=scale), degree=CHEB_DEGREE)
        b = torch.randn(shape, generator=gen, device="cuda")
        for degree in range(1, CHEB_DEGREE + 1):
            start = torch.randn(shape, generator=gen, device="cuda") \
                if degree == 2 else None
            kw = dict(tol=0.0, maxiter=16, check_every=4,
                      precond_degree=degree, lmin=m.lmin, lmax=m.lmax)
            name = f"cg_resident {shape} degree {degree}"
            err, x_rel, trace_rel, got = check_resident(
                hk, name, scale, b, start, **kw)
            check_bodies(hk, name, scale, b, start, got=got, **kw)
            res_worst = max(res_worst, err)
            res_x_rel = max(res_x_rel, x_rel)
            res_trace_rel = max(res_trace_rel, trace_rel)
            checks += 1
        theta_m, steps = m.steps()
        c1, c2 = steps[1]
        r, z, d = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        for first in (True, False):
            for last in (True, False):
                args = (scale, theta_m, c1, c2, r if first else z,
                        None if first else r, None if first else d)
                kw = dict(first=first, last=last)
                got, want = (f(*args, **kw) for f in
                             (hk.fused_cheb_step, hk.fused_cheb_step_plain))
                for g, w in zip(got[:2], want[:2]):
                    worst = max(worst, check_array(
                        f"fused_cheb_step {shape} first={first} "
                        f"last={last}", g, w))
                if last:
                    check_scalar(f"fused_cheb_step rho {shape}", got[2],
                                 want[2])
                checks += 1
    # the SpMV on an unstructured matrix: row lengths from 2 to 64
    from cuda_mpi_parallel_tpu_torch.models import mmio

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "skewed_spd_240.mtx")
    mtx = mmio.load_matrix_market(fixture, dtype="float32", device="cuda")
    sell = mtx.to_shiftell()
    v = torch.randn(mtx.n, generator=gen, device="cuda")
    args = (sell.vals, sell.cols, sell.slice_ptr, mtx.n)
    worst = max(worst, check_array("shift_ell_matvec (fixture)",
                                   hk.shift_ell_matvec(v, *args),
                                   hk.shift_ell_matvec_plain(v, *args)))
    checks += 1
    f64 = ragged_df64(hk, pt, gen, fixture)
    cg1 = ragged_cg1(hk, torch.Generator("cuda").manual_seed(SEED + 5))
    dist = ragged_dist(hk, torch.Generator("cuda").manual_seed(SEED + 7))
    op = poisson.poisson_3d_operator(9, 17, 33, backend="pallas")
    b = torch.randn(op.n, generator=gen, device="cuda")
    res = pt.solve(op, b, rtol=1e-5, engine="streaming")
    ref = pt.solve(poisson.poisson_3d_operator(9, 17, 33), b, rtol=1e-5)
    its, ref_its = int(res.iterations), int(ref.iterations)
    x_err = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    emit("kernels_ragged", checks=checks, max_abs_err=worst,
         resident_max_abs_err=res_worst, resident_x_rel_err=res_x_rel,
         resident_trace_rel_err=res_trace_rel,
         deterministic=True, streaming_iterations=its,
         plain_general_iterations=ref_its, x_rel_err=x_err, f64=f64,
         cg1=cg1, dist=dist, b10_bodies=bodies)
    if abs(its - ref_its) > 2 or not x_err <= 1e-4 \
            or res.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("kernels_ragged: streaming solve disagrees")


def b10_bodies(hk, pt, scale, gen):
    """B10's warm starts on B12's body at one shard - 7 x 130 and 9 x 17 x
    33 (one tile a CTA) at degrees 0, 1 and 4, and where a CTA walks
    several tiles through its shared x slots: 128^3 (4), 6,336 x 280 (3)
    and 920 x 1 x 512 (7, the margin slabs) - and grids past that body's
    slots, which take the tile walk: 12,800 x 200 (1,600 tiles), a
    preconditioned 12,680 x 147 with a warm start and 921 x 1 x 512
    (1,585 and 1,856 tiles).  Each against its twin (check_resident's
    limits); on B12's grids both bodies give the same bits, and past the
    slots the solver's launch is the tile walk's bits and B12's body
    refuses the grid."""
    out = dict(checks=0, max_abs_err=0.0, x_rel_err=0.0, trace_rel_err=0.0)
    sms = hk.resident_dist.sm_count()

    def check(name, b, start, body, **kw):
        fits = hk.resident_dist.dist_geometry(
            *hk._build.grid_dims(tuple(b.shape)), 1, sms).fits
        if ("b12" if fits else "tile_walk") != body:
            raise AssertionError(f"{name}: expected {body}")
        err, x_rel, trace_rel, got = check_resident(hk, name, scale, b,
                                                    start, **kw)
        for key, v in (("max_abs_err", err), ("x_rel_err", x_rel),
                       ("trace_rel_err", trace_rel)):
            out[key] = max(out[key], v)
        out["checks"] += 1
        return got

    def interval(shape):
        stencil = pt.Stencil2D if len(shape) == 2 else pt.Stencil3D
        m = pt.ChebyshevPreconditioner.from_operator(
            stencil.create(*shape, scale=scale), degree=CHEB_DEGREE)
        return dict(lmin=m.lmin, lmax=m.lmax)

    warm = [(shape, degree) for shape in ((7, 130), (9, 17, 33))
            for degree in (0, 1, CHEB_DEGREE)]
    warm += [((128, 128, 128), 0), ((6336, 280), CHEB_DEGREE),
             ((920, 1, 512), 1)]
    for shape, degree in warm:
        b = torch.randn(shape, generator=gen, device="cuda")
        start = torch.randn(shape, generator=gen, device="cuda")
        kw = dict(tol=0.0, maxiter=16, check_every=4, precond_degree=degree,
                  **(interval(shape) if degree else {}))
        name = f"cg_resident {shape} warm degree {degree}"
        got = check(name, b, start, "b12", **kw)
        check_bodies(hk, name, scale, b, start, got=got, **kw)
    past = [((12800, 200), False, 0, dict(maxiter=30, check_every=8)),
            ((12680, 147), True, 3, dict(maxiter=16, check_every=4)),
            ((921, 1, 512), False, 0, dict(maxiter=30, check_every=8)),
            ((921, 1, 512), True, 2, dict(maxiter=16, check_every=4))]
    for shape, x0, degree, kw in past:
        b = torch.randn(shape, generator=gen, device="cuda")
        start = torch.randn(shape, generator=gen, device="cuda") \
            if x0 else None
        kw = dict(kw, tol=0.0, precond_degree=degree,
                  **(interval(shape) if degree else {}))
        name = f"cg_resident {shape} degree {degree}" \
            + (" warm" if x0 else "")
        got = check(name, b, start, "tile_walk", **kw)
        check_past_slots(hk, name, scale, b, start, got, **kw)
    out.update(warm=[[list(shape), degree] for shape, degree in warm],
               past_slots=[[list(shape), degree, x0]
                           for shape, x0, degree, _ in past],
               past_slots_body="tile_walk", bodies_bit_equal=True)
    return out


def ragged_cg1(hk, gen):
    """B10's cg1 form against its twin on 16 x 128 and 9 x 17 x 33, cold
    and warm (30 iterations in check blocks of 8, the last one partial);
    at breakdown: with scale 0, w0 = A r0 = 0 and alpha0 = rr0 / 0 is not
    finite, so kernel and twin both stop before the first block and report
    it unhealthy (BREAKDOWN), as the JAX package's
    ``test_breakdown_parity``; warm starts where a CTA walks several tiles
    through its shared p and x slots, 128^3 (4) and 6,336 x 280 (3); and
    grids past those slots, 12,800 x 147 warm and 921 x 1 x 512 (1,600
    and 1,856 tiles).  On every grid that fits the slots the one-barrier
    body (instance 1), the tile walk (instance 2) and the solver's launch
    give the same bits; past them the solver's launch is the tile walk's
    and instance 1 refuses the grid."""
    scale = torch.tensor(0.37, device="cuda")
    sms = hk.resident_dist.sm_count()
    out = dict(checks=0, x_rel_err=0.0, trace_rel_err=0.0)

    def check(name, scale, b, start, fits, **kw):
        kw = dict(kw, method="cg1", tol=kw.get("tol", 0.0))
        if hk.resident_dist.dist_geometry(
                *hk._build.grid_dims(tuple(b.shape)), 1, sms).fits != fits:
            raise AssertionError(f"{name}: expected fits={fits}")
        _, xr, tr, got = check_resident(hk, name, scale, b, start, **kw)
        if fits:
            check_bodies(hk, name, scale, b, start, got=got, **kw)
        else:
            check_past_slots(hk, name, scale, b, start, got, **kw)
        out["x_rel_err"] = max(out["x_rel_err"], xr)
        out["trace_rel_err"] = max(out["trace_rel_err"], tr)
        out["checks"] += 1
        return got

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for shape in ((16, 128), (9, 17, 33)):
        b = randn(shape)
        for warm in (False, True):
            check(f"cg_resident_cg1 {shape} warm={warm}", scale, b,
                  randn(shape) if warm else None, True, maxiter=30,
                  check_every=8)
    got = check("cg_resident_cg1 breakdown", torch.zeros((), device="cuda"),
                randn((8, 128)), None, True, tol=1e-7, maxiter=64,
                check_every=4)
    if int(got[1]) != 0 or int(got[5]) != 0:
        raise AssertionError(f"cg_resident_cg1 breakdown: iterations "
                             f"{int(got[1])}, healthy {int(got[5])}")
    warm = ((128, 128, 128), (6336, 280))
    for shape in warm:
        check(f"cg_resident_cg1 {shape} warm", scale, randn(shape),
              randn(shape), True, maxiter=16, check_every=4)
    past = (((12800, 147), True), ((921, 1, 512), False))
    for shape, x0 in past:
        check(f"cg_resident_cg1 {shape} warm={x0}", scale, randn(shape),
              randn(shape) if x0 else None, False, maxiter=30,
              check_every=8)
    out.update(breakdown_healthy=int(got[5]),
               warm_several_tiles=[list(shape) for shape in warm],
               past_slots=[[list(shape), x0] for shape, x0 in past],
               past_slots_body="tile_walk", bodies_bit_equal=True)
    return out


def ragged_df64(hk, pt, gen, fixture):
    """The f64 lane's kernels on the ragged shapes: B6/B7 bit-equal to
    their twins (sums within SCALAR_TOL_F64), B9 on the fixture in
    float64, and B11 at degrees 0 to 4, cold and warm, on 16 x 128 and
    9 x 17 x 33 (each interval from its own stencil), at degree 0 on 1 x 1
    and 7 x 130; warm where a CTA of B12's double body walks three tiles
    (3,168 x 280 at degree 4: 792 tiles, the margin; 392 x 1 x 512 at
    degree 2; 109^3); and past that body's slots, 12,800 x 100 and
    921 x 1 x 512 warm at degree 3 (1,600 and 1,856 tiles).  Each B11
    check against its twin; on the body's grids instance 1, instance 2
    and the solver's launch give the same bits, past them the solver's
    launch is the tile walk's and instance 1 refuses the grid."""
    from cuda_mpi_parallel_tpu_torch.models import mmio

    f64 = torch.float64
    sms = hk.resident_dist.sm_count()

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=f64)

    scale, beta, alpha = (torch.tensor(v, device="cuda", dtype=f64)
                          for v in (0.37, 0.45, 0.11))
    checks, x_rel, trace_rel = 0, 0.0, 0.0
    for shape in ((1, 1), (3, 200), (17, 257), (1, 1, 1), (3, 5, 7),
                  (9, 17, 33)):
        r, p, x = (randn(shape) for _ in range(3))
        got, want = (f(scale, beta, r, p) for f in
                     (hk.fused_cg_pass_a_df64, hk.fused_cg_pass_a_plain))
        check_equal(f"pass A f64 {shape}", got[0], want[0])
        check_scalar(f"pass A f64 pap {shape}", got[1], want[1],
                     SCALAR_TOL_F64)
        got, want = (f(scale, alpha, p, x.clone(), r.clone()) for f in
                     (hk.fused_cg_pass_b_df64, hk.fused_cg_pass_b_plain))
        for g, w in zip(got[:2], want[:2]):
            check_equal(f"pass B f64 {shape}", g, w)
        check_scalar(f"pass B f64 rr {shape}", got[2], want[2],
                     SCALAR_TOL_F64)
        checks += 2
    mtx = mmio.load_matrix_market(fixture, dtype="float64", device="cuda")
    sell = mtx.to_shiftell_df64()
    v = randn(mtx.n)
    args = (sell.vals, sell.cols, sell.slice_ptr, mtx.n)
    check_equal("shift_ell_matvec_df64 (fixture)",
                hk.shift_ell_matvec(v, *args),
                hk.shift_ell_matvec_plain(v, *args))
    checks += 1

    def interval(shape):
        stencil = pt.Stencil2D if len(shape) == 2 else pt.Stencil3D
        theta, delta = interval_of(pt, stencil.create(
            *shape, scale=float(scale), backend="xla"))
        return dict(theta=theta, delta=delta)

    def check(name, b, start, **kw):
        """B11 against its twin, then its bodies by the grid's."""
        nonlocal checks, x_rel, trace_rel
        _, xr, tr, got = check_resident(hk, name, scale, b, start, f64=True,
                                        **kw)
        if hk.resident_dist.dist_geometry(
                *hk._build.grid_dims(tuple(b.shape)), 1, sms, 8).fits:
            check_bodies(hk, name, scale, b, start, got=got, **kw)
        else:
            check_past_slots(hk, name, scale, b, start, got, **kw)
        x_rel, trace_rel = max(x_rel, xr), max(trace_rel, tr)
        checks += 1

    for shape, degrees in (((16, 128), range(CHEB_DEGREE + 1)),
                           ((9, 17, 33), range(CHEB_DEGREE + 1)),
                           ((1, 1), (0,)), ((7, 130), (0,))):
        ival = interval(shape)
        b = randn(shape)
        for degree in degrees:
            for warm in (False, True):
                check(f"cg_resident_df64 {shape} degree {degree} "
                      f"warm={warm}", b, randn(shape) if warm else None,
                      tol=0.0, maxiter=16, check_every=4,
                      precond_degree=degree, **ival)
    three_tiles = (((3168, 280), CHEB_DEGREE, True),
                   ((392, 1, 512), 2, True), ((109, 109, 109), 0, True))
    past = (((12800, 100), 0, False), ((921, 1, 512), 3, True))
    for (shape, degree, warm), fits in (
            [(c, True) for c in three_tiles] + [(c, False) for c in past]):
        if hk.resident_dist.dist_geometry(
                *hk._build.grid_dims(shape), 1, sms, 8).fits != fits:
            raise AssertionError(f"cg_resident_df64 {shape}: expected "
                                 f"fits={fits}")
        check(f"cg_resident_df64 {shape} degree {degree} warm={warm}",
              randn(shape), randn(shape) if warm else None, tol=0.0,
              maxiter=16, check_every=4, precond_degree=degree,
              **(interval(shape) if degree else {}))
    return dict(checks=checks, resident_x_rel_err=x_rel,
                resident_trace_rel_err=trace_rel,
                three_tiles_warm=[[list(c[0]), c[1]] for c in three_tiles],
                past_slots=[[list(c[0]), c[1], c[2]] for c in past],
                past_slots_body="tile_walk", bodies_bit_equal=True)


def resident_phase(label, grid, pt, poisson, gen, count_main_path,
                   plain_reference, method="cg"):
    """The resident engine on one system to rtol 1e-6 (b = A x_true): one
    launch per solve, the iteration count of the plain general engine
    (the same ``method``) at check_every=1, the f64 true residual,
    engine="auto" taking it; and us/iteration on the same system (200
    iterations, tol 0): of the three engines with ``method="cg"``, of the
    resident cg1 and cg kernels and the general cg1 engine with
    ``"cg1"``."""
    make = (poisson.poisson_2d_operator if len(grid) == 2
            else poisson.poisson_3d_operator)
    op = make(*grid, backend="pallas")
    op_xla = make(*grid, backend="xla")
    op64 = make(*grid, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000, method=method)
    kernel = "cg_resident_cg1" if method == "cg1" else "cg_resident"
    pt.solve(op, b, engine="resident", check_every=32, maxiter=64)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="resident", check_every=32, **skw)))
    its = int(res.iterations)
    true_rel = float((b.double() - op64.matvec(res.x.double())).norm()
                     / b.double().norm())
    exact = pt.solve(op, b, engine="resident", check_every=1, **skw)
    ref = plain_reference(lambda: pt.solve(op_xla, b, engine="general",
                                           check_every=1, **skw))
    (auto, _), auto_seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="auto", check_every=32, **skw)))
    us = {}
    runs = ((("resident", "cg"), ("streaming", "cg"), ("general", "cg"))
            if method == "cg" else
            (("resident", "cg1"), ("resident", "cg"), ("general", "cg1")))
    for engine, meth in runs:
        name = engine if method == "cg" else f"{engine}_{meth}"
        pt.solve(op, b, engine=engine, method=meth,
                 **dict(RESIDENT_KW, maxiter=32))
        done, secs = timed_solve(lambda: pt.solve(
            op, b, engine=engine, method=meth, **RESIDENT_KW))
        us[name] = secs * 1e6 / int(done.iterations)
    emit(label, shape=list(grid), method=method, iterations=its,
         seconds_to_1e6=t, iters_per_s=its / t, launches=seen,
         status=res.status_enum().name,
         true_rel_residual_f64=true_rel,
         iterations_check_every_1=int(exact.iterations),
         plain_general_iterations=int(ref.iterations),
         plain_general_status=ref.status_enum().name,
         auto_launches=auto_seen, us_per_iteration=us)
    n_exact, n_ref = int(exact.iterations), int(ref.iterations)
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError(f"{label}: both solves must converge")
    if abs(n_exact - n_ref) > max(2, 0.01 * n_ref):
        raise AssertionError(f"{label}: {n_exact} vs {n_ref} iterations")
    if seen != {kernel: 1} or auto_seen != {kernel: 1}:
        raise AssertionError(f"{label}: expected exactly one {kernel} "
                             f"launch per solve, explicit and auto")
    if not true_rel <= 2e-6:
        raise AssertionError(f"{label}: true residual {true_rel}")


def cheb_streaming_phase(pt, op, op_xla, b, count_main_path,
                         plain_reference, plain_iterations):
    """A degree-4 Chebyshev at 256^3 on the streaming engine to rtol 1e-6
    (b = A x_true, as in streaming_256): three B5 launches per
    application, passes A and B once per iteration, the iteration count
    of the plain general engine (the xla stencil, the same interval) at
    check_every=1, the f64 true residual, engine="auto" taking it; and a
    degree-1 solve (200 iterations, tol 0) on passes A/B alone."""
    t0 = time.perf_counter()
    m = pt.ChebyshevPreconditioner.from_operator(op, degree=CHEB_DEGREE)
    lmax = float(m.lmax)
    setup_s = time.perf_counter() - t0
    m_xla = pt.ChebyshevPreconditioner(a=op_xla, lmin=m.lmin, lmax=m.lmax,
                                       degree=CHEB_DEGREE)
    skw = dict(rtol=1e-6, maxiter=4000, m=m)
    pt.solve(op, b, engine="streaming", check_every=32, **dict(skw,
                                                                maxiter=64))
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="streaming", check_every=32, **skw)))
    its = int(res.iterations)
    op64 = pt.Stencil3D.create(*GRID_3D, dtype=torch.float64)
    true_rel = float((b.double() - op64.matvec(res.x.double())).norm()
                     / b.double().norm())
    exact = pt.solve(op, b, engine="streaming", check_every=1, **skw)
    ref = plain_reference(lambda: pt.solve(
        op_xla, b, engine="general", check_every=1, **dict(skw, m=m_xla)))
    (auto, _), auto_seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="auto", check_every=32, **skw)))
    m1, m1_xla = (pt.ChebyshevPreconditioner(a=a, lmin=m.lmin, lmax=m.lmax,
                                             degree=1) for a in (op, op_xla))
    dkw = dict(tol=0.0, maxiter=200, check_every=32)
    (one, t1), one_seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, m=m1, engine="streaming", **dkw)))
    one_ref = plain_reference(lambda: pt.solve(op_xla, b, m=m1_xla,
                                               engine="general", **dkw))
    one_rel = abs(float(one.residual_norm) - float(one_ref.residual_norm)) \
        / float(one_ref.residual_norm)
    n_exact, n_ref = int(exact.iterations), int(ref.iterations)
    emit("cheb_streaming_256", shape=list(GRID_3D), degree=CHEB_DEGREE,
         lmin=float(m.lmin), lmax=lmax, estimate_lmax_seconds=setup_s,
         iterations=its, seconds_to_1e6=t, iters_per_s=its / t,
         launches=seen, status=res.status_enum().name,
         true_rel_residual_f64=true_rel, iterations_check_every_1=n_exact,
         plain_general_iterations=n_ref,
         plain_general_status=ref.status_enum().name,
         unpreconditioned_iterations=plain_iterations,
         auto_launches=auto_seen, degree_1_iterations=int(one.iterations),
         degree_1_iters_per_s=int(one.iterations) / t1,
         degree_1_launches=one_seen,
         degree_1_residual_norm=float(one.residual_norm),
         degree_1_plain_residual_norm=float(one_ref.residual_norm),
         degree_1_rel_diff=one_rel)
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("cheb_streaming_256: both solves must converge")
    if abs(n_exact - n_ref) > max(2, 0.01 * n_ref):
        raise AssertionError(f"cheb_streaming_256: {n_exact} vs {n_ref} "
                             f"iterations")
    steps = CHEB_DEGREE - 1
    if seen.get("fused_cheb_step") != steps * (its + 1) or not (
            seen.get("fused_cg_pass_a") == seen.get("fused_cg_pass_b")
            == its):
        raise AssertionError(f"cheb_streaming_256: launches {seen} for "
                             f"{its} iterations")
    if auto_seen.get("fused_cheb_step") != steps * (int(auto.iterations)
                                                    + 1) \
            or auto_seen.get("cg_resident", 0):
        raise AssertionError("cheb_streaming_256: engine='auto' did not "
                             "take the streaming engine")
    if not true_rel <= 2e-6:
        raise AssertionError(f"cheb_streaming_256: true residual {true_rel}")
    if one_seen.get("fused_cheb_step", 0) or not (
            one_seen.get("fused_cg_pass_a") == one_seen.get("fused_cg_pass_b")
            == 200) or not one_rel <= 1e-3:
        raise AssertionError(f"cheb_streaming_256: degree 1 launched "
                             f"{one_seen}, residuals within {one_rel}")


def cheb_resident_phase(pt, poisson, gen, count_main_path, plain_reference):
    """A degree-4 Chebyshev at 1024^2 inside the resident kernel to rtol
    1e-6: one launch per solve, the plain general engine's iteration count
    at check_every=1, the f64 true residual, engine="auto" taking it; its
    us/iteration against degree 0 (200 iterations, tol 0); and at 128^3,
    where the seven planes do not fit the L2, auto taking streaming."""
    op = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    op_xla = poisson.poisson_2d_operator(*GRID_RES_2D, backend="xla")
    op64 = poisson.poisson_2d_operator(*GRID_RES_2D, dtype=torch.float64)
    m = pt.ChebyshevPreconditioner.from_operator(op, degree=CHEB_DEGREE)
    m_xla = pt.ChebyshevPreconditioner(a=op_xla, lmin=m.lmin, lmax=m.lmax,
                                       degree=CHEB_DEGREE)
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000, m=m)
    pt.solve(op, b, engine="resident", check_every=32, **dict(skw,
                                                               maxiter=64))
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="resident", check_every=32, **skw)))
    its = int(res.iterations)
    true_rel = float((b.double() - op64.matvec(res.x.double())).norm()
                     / b.double().norm())
    exact = pt.solve(op, b, engine="resident", check_every=1, **skw)
    ref = plain_reference(lambda: pt.solve(
        op_xla, b, engine="general", check_every=1, **dict(skw, m=m_xla)))
    (auto, _), auto_seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="auto", check_every=32, **skw)))
    us = {}
    for label, mm in ((f"degree_{CHEB_DEGREE}", m), ("degree_0", None)):
        pt.solve(op, b, m=mm, engine="resident", **dict(RESIDENT_KW,
                                                        maxiter=32))
        done, secs = timed_solve(lambda: pt.solve(
            op, b, m=mm, engine="resident", **RESIDENT_KW))
        us[label] = secs * 1e6 / int(done.iterations)
    # 128^3: the unpreconditioned planes fit, the preconditioned do not
    op3 = poisson.poisson_3d_operator(*GRID_RES_3D, backend="pallas")
    m3 = pt.ChebyshevPreconditioner.from_operator(op3, degree=CHEB_DEGREE)
    b3 = torch.randn(op3.n, generator=gen, device="cuda")
    (res3, _), seen3 = count_main_path(lambda: timed_solve(lambda: pt.solve(
        op3, b3, m=m3, engine="auto", tol=0.0, maxiter=32, check_every=32)))
    n_exact, n_ref = int(exact.iterations), int(ref.iterations)
    emit("cheb_resident_1024", shape=list(GRID_RES_2D), degree=CHEB_DEGREE,
         lmin=float(m.lmin), lmax=float(m.lmax), iterations=its,
         seconds_to_1e6=t, iters_per_s=its / t, launches=seen,
         status=res.status_enum().name, true_rel_residual_f64=true_rel,
         iterations_check_every_1=n_exact, plain_general_iterations=n_ref,
         plain_general_status=ref.status_enum().name,
         auto_launches=auto_seen, us_per_iteration=us,
         auto_128_launches=seen3,
         resident_fits_128=pt.supports_resident(op3),
         resident_fits_128_preconditioned=pt.supports_resident(
             op3, preconditioned=True))
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("cheb_resident_1024: both solves must converge")
    if abs(n_exact - n_ref) > max(2, 0.01 * n_ref):
        raise AssertionError(f"cheb_resident_1024: {n_exact} vs {n_ref} "
                             f"iterations")
    if seen != {"cg_resident": 1} or auto_seen != {"cg_resident": 1}:
        raise AssertionError("cheb_resident_1024: expected exactly one "
                             "cg_resident launch per solve, explicit and "
                             "auto")
    if not true_rel <= 2e-6:
        raise AssertionError(f"cheb_resident_1024: true residual {true_rel}")
    if seen3.get("cg_resident", 0) or seen3.get("fused_cheb_step") != \
            (CHEB_DEGREE - 1) * (int(res3.iterations) + 1) \
            or not pt.supports_resident(op3) \
            or pt.supports_resident(op3, preconditioned=True):
        raise AssertionError(f"cheb_resident_1024: at 128^3 auto launched "
                             f"{seen3}, not the streaming engine")


def jacobi_fem_phase(pt, gen, count_main_path, plain_reference):
    """Jacobi-preconditioned CG on ``random_fem_2d(1_048_576, seed=0)`` in
    f32 (BASELINE config #5's stand-in) on the hand SpMV to rtol 1e-6:
    one B8 launch per iteration, the iteration count of the plain CSR
    engine with the same preconditioner, and beside it the
    unpreconditioned and the block-Jacobi (block size 8) counts and the
    host's assembly time.  Returns the FEM matrix (CSR)."""
    import numpy as np

    from cuda_mpi_parallel_tpu_torch.models import fem

    t0 = time.perf_counter()
    csr = fem.random_fem_2d(FEM_POINTS, seed=0, dtype=np.float32)
    assembly_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sell = csr.to_shiftell()
    pack_s = time.perf_counter() - t0
    jac = pt.JacobiPreconditioner.from_operator(csr)
    x_true = torch.randn(csr.n, generator=gen, device="cuda")
    b = csr.matvec(x_true)
    fkw = dict(rtol=1e-6, maxiter=5000, engine="general")
    pt.solve(sell, b, m=jac, **dict(fkw, maxiter=32))            # warm-up
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(sell, b, m=jac, **fkw)))
    its = int(res.iterations)
    ref = plain_reference(lambda: pt.solve(csr, b, m=jac, **fkw))
    plain, t_plain = timed_solve(lambda: pt.solve(sell, b, **fkw))
    t0 = time.perf_counter()
    bj = pt.BlockJacobiPreconditioner.from_operator(csr, block_size=8)
    bj_setup_s = time.perf_counter() - t0
    blocked, t_bj = timed_solve(lambda: pt.solve(sell, b, m=bj, **fkw))
    true_rel = float((b.double() - pt.CSRMatrix.from_arrays(
        csr.data.double(), csr.indices, csr.indptr, csr.shape).matvec(
            res.x.double())).norm() / b.double().norm())
    ref_its = int(ref.iterations)
    emit("jacobi_fem", rows=csr.n, nnz=csr.nnz, assembly_seconds=assembly_s,
         pack_seconds=pack_s, iterations=its, seconds=t,
         us_per_iteration=t * 1e6 / its, launches=seen,
         status=res.status_enum().name, true_rel_residual_f64=true_rel,
         plain_csr_iterations=ref_its,
         plain_csr_status=ref.status_enum().name,
         unpreconditioned_iterations=int(plain.iterations),
         unpreconditioned_status=plain.status_enum().name,
         unpreconditioned_us_per_iteration=t_plain * 1e6
         / max(int(plain.iterations), 1),
         block_jacobi_8_iterations=int(blocked.iterations),
         block_jacobi_8_status=blocked.status_enum().name,
         block_jacobi_8_us_per_iteration=t_bj * 1e6
         / max(int(blocked.iterations), 1),
         block_jacobi_8_setup_seconds=bj_setup_s)
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("jacobi_fem: both solves must converge")
    if abs(its - ref_its) > max(2, 0.01 * ref_its):
        raise AssertionError(f"jacobi_fem: {its} vs {ref_its} iterations")
    if seen.get("shift_ell_matvec") != its:
        raise AssertionError(f"jacobi_fem: {seen} for {its} iterations, "
                             f"expected one SpMV launch per iteration")
    return csr


def f64_true_residual(op64, b, x) -> float:
    """||b - A x|| / ||b|| in float64."""
    return float((b - op64.matvec(x)).norm() / b.norm())


def check_parity(label, res, ref, exact=None):
    """Both solves converged, and the engine's count at check_every=1
    (``exact``, else ``res``) within max(2, 1 %) of the plain engine's."""
    n = int((exact if exact is not None else res).iterations)
    n_ref = int(ref.iterations)
    if res.status_enum().name != "CONVERGED" \
            or ref.status_enum().name != "CONVERGED":
        raise AssertionError(f"{label}: both solves must converge")
    if abs(n - n_ref) > max(2, 0.01 * n_ref):
        raise AssertionError(f"{label}: {n} vs {n_ref} iterations")


def streaming_df64_phase(pt, poisson, gen, count_main_path,
                         plain_reference):
    """``cg_streaming_df64`` on 3D Poisson 256^3 to rtol 1e-10, b = A
    x_true in float64 (the north star at the reference's precision): one
    B6 and one B7 launch per iteration, the iteration count of the
    port's general ``cg_df64`` at check_every=1, the f64 true residual."""
    op = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    op64 = poisson.poisson_3d_operator(*GRID_3D, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda",
                         dtype=torch.float64)
    b = op64.matvec(x_true)
    skw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64)
    pt.cg_streaming_df64(op, b, tol=0.0, maxiter=64, check_every=32)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.cg_streaming_df64(op, b, check_every=32, **skw)))
    its = int(res.iterations)
    true_rel = f64_true_residual(op64, b, res.x64)
    exact = pt.cg_streaming_df64(op, b, check_every=1, **skw)
    ref, t_ref = plain_reference(lambda: timed_solve(
        lambda: pt.cg_df64(op, b, check_every=1, **skw)))
    us = {}
    for name, fn in (("streaming", pt.cg_streaming_df64),
                     ("general", pt.cg_df64)):
        fn(op, b, tol=0.0, maxiter=32, check_every=32)
        done, secs = timed_solve(lambda: fn(op, b, tol=0.0, maxiter=200,
                                            check_every=32))
        us[name] = secs * 1e6 / int(done.iterations)
    emit("streaming_df64_256", shape=list(GRID_3D), rtol=RTOL_F64,
         iterations=its, seconds_to_1e10=t, iters_per_s=its / t,
         launches=seen, status=res.status_enum().name,
         true_rel_residual_f64=true_rel,
         iterations_check_every_1=int(exact.iterations),
         plain_general_iterations=int(ref.iterations),
         plain_general_seconds=t_ref,
         plain_general_status=ref.status_enum().name,
         us_per_iteration=us)
    check_parity("streaming_df64_256", res, ref, exact)
    if not (seen.get("fused_cg_pass_a_df64") == seen.get(
            "fused_cg_pass_b_df64") == its) or len(seen) != 2:
        raise AssertionError(f"streaming_df64_256: launches {seen} for "
                             f"{its} iterations")
    if not true_rel <= 2 * RTOL_F64:
        raise AssertionError(f"streaming_df64_256: true residual {true_rel}")


def resident_df64_phase(pt, poisson, gen, count_main_path, plain_reference,
                        label, grid, degree):
    """``cg_resident_df64`` on 2D Poisson to rtol 1e-10 (b = A x_true in
    float64), unpreconditioned or with the degree-``degree`` Chebyshev
    inside the kernel: one launch per solve, the iteration count of the
    port's general ``cg_df64`` (the same preconditioner and interval) at
    check_every=1, the f64 true residual; the three f64 engines'
    us/iteration (200 iterations, tol 0); unpreconditioned, also the
    largest cube the five-plane f64 gate admits, solved in one launch."""
    op = poisson.poisson_2d_operator(*grid, backend="xla")
    op64 = poisson.poisson_2d_operator(*grid, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda",
                         dtype=torch.float64)
    b = op64.matvec(x_true)
    pc = dict(preconditioner="chebyshev", precond_degree=degree) \
        if degree else {}
    skw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64, **pc)
    pt.cg_resident_df64(op, b, tol=0.0, maxiter=64, check_every=32, **pc)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.cg_resident_df64(op, b, check_every=32, **skw)))
    its = int(res.iterations)
    true_rel = f64_true_residual(op64, b, res.x64)
    exact = pt.cg_resident_df64(op, b, check_every=1, **skw)
    ref, t_ref = plain_reference(lambda: timed_solve(
        lambda: pt.cg_df64(op, b, check_every=1, **skw)))
    fields = {}
    if not degree:
        us = {}
        for name, fn in (("resident", pt.cg_resident_df64),
                         ("streaming", pt.cg_streaming_df64),
                         ("general", pt.cg_df64)):
            fn(op, b, tol=0.0, maxiter=32, check_every=32)
            done, secs = timed_solve(lambda: fn(op, b, **RESIDENT_KW))
            us[name] = secs * 1e6 / int(done.iterations)
        n = 1
        while pt.supports_resident_df64(pt.Stencil3D.create(n + 1, n + 1,
                                                            n + 1)):
            n += 1
        op3 = poisson.poisson_3d_operator(n, n, n, backend="xla")
        b3 = torch.randn(op3.n, generator=gen, device="cuda",
                         dtype=torch.float64)
        (cube, t3), seen3 = count_main_path(lambda: timed_solve(
            lambda: pt.cg_resident_df64(op3, b3, **RESIDENT_KW)))
        fields = dict(us_per_iteration=us, largest_cube=n,
                      cube_launches=seen3,
                      cube_us_per_iteration=t3 * 1e6 / int(cube.iterations))
        if seen3 != {"cg_resident_df64": 1} or int(cube.iterations) != 200:
            raise AssertionError(f"{label}: the {n}^3 solve launched "
                                 f"{seen3}")
    emit(label, shape=list(grid), degree=degree, rtol=RTOL_F64,
         iterations=its, seconds_to_1e10=t, iters_per_s=its / t,
         launches=seen, status=res.status_enum().name,
         true_rel_residual_f64=true_rel,
         iterations_check_every_1=int(exact.iterations),
         plain_general_iterations=int(ref.iterations),
         plain_general_seconds=t_ref,
         plain_general_status=ref.status_enum().name, **fields)
    check_parity(label, res, ref, exact)
    if seen != {"cg_resident_df64": 1}:
        raise AssertionError(f"{label}: expected exactly one "
                             f"cg_resident_df64 launch, got {seen}")
    if not true_rel <= 2 * RTOL_F64:
        raise AssertionError(f"{label}: true residual {true_rel}")


def csr_df64_phase(pt, csr64, sell64, fem, gen, count_main_path,
                   plain_reference):
    """``cg_df64`` on config #2's CSR in float64 - the reference's own
    configuration, f64 CSR CG - on B9 to rtol 1e-10: one B9 launch per
    iteration and the plain torch CSR engine's count; the same with
    Jacobi on the FEM matrix (its f32 values, exact in float64).
    Returns the two systems as (label, CSR, B9 operator,
    preconditioner)."""
    out = {}
    systems = (("config2", csr64, sell64, None),
               ("fem_jacobi", fem, fem.to_shiftell_df64(), "jacobi"))
    for label, a, sell, pc in systems:
        x_true = torch.randn(a.n, generator=gen, device="cuda",
                             dtype=torch.float64)
        a64 = pt.CSRMatrix.from_arrays(a.data.double(), a.indices, a.indptr,
                                       a.shape)
        b = a64.matvec(x_true)
        skw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64,
                   preconditioner=pc, check_every=32)
        pt.cg_df64(sell, b, **dict(skw, maxiter=32))              # warm-up
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: pt.cg_df64(sell, b, **skw)))
        its = int(res.iterations)
        ref, t_ref = plain_reference(lambda: timed_solve(
            lambda: pt.cg_df64(a64, b, **skw)))
        true_rel = f64_true_residual(a64, b, res.x64)
        out[label] = dict(rows=a.n, nnz=a.nnz, preconditioner=pc,
                          iterations=its, seconds_to_1e10=t,
                          us_per_iteration=t * 1e6 / its, launches=seen,
                          status=res.status_enum().name,
                          true_rel_residual_f64=true_rel,
                          plain_csr_iterations=int(ref.iterations),
                          plain_csr_us_per_iteration=t_ref * 1e6
                          / max(int(ref.iterations), 1))
        check_parity(f"csr_df64_1024 {label}", res, ref)
        if seen != {"shift_ell_matvec_df64": its}:
            raise AssertionError(f"csr_df64_1024 {label}: {seen} for {its} "
                                 f"iterations, expected one B9 launch each")
        if not true_rel <= 2 * RTOL_F64:
            raise AssertionError(f"csr_df64_1024 {label}: true residual "
                                 f"{true_rel}")
    emit("csr_df64_1024", rtol=RTOL_F64, **out)
    return systems


def general_variants_phase(pt, poisson, gen, count_main_path,
                           plain_reference):
    """``solve(engine="general", method="cg1"|"pipecg")`` on 3D Poisson
    256^3 with B2 (the north star) to rtol 1e-6, b = A x_true,
    ``check_every=32``: the same bits as the solve on the plain torch
    stencil (B2 and its twin round alike), and the B2 launches - cg1 one
    per iteration and one at init (w0 = A r0); pipecg one per iteration,
    two at init and four per residual replacement (every 16 iterations
    in f32).  The limits: the iteration count at check_every=1 within
    max(2, 1 %) of the plain ``method="cg"`` engine's (pipecg: max(3,
    2 %), the slack of the JAX package's f32 replacement test) and the
    f64 true residual <= 2e-6.  cg1 is held to them.  f32 pipecg does not
    reach rtol 1e-6 at this size, and neither does the JAX package's
    ``_pipecg`` (``tools/pipecg_f32_floor.py``: at 128^3 on the CPU it
    stops at maxiter with a true residual of 3.0e-4; ROADMAP queue C):
    its line reports the limits
    and ``within_limits``, and is held to the rest."""
    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    op64 = poisson.poisson_3d_operator(*GRID_3D, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000, engine="general")
    ref = plain_reference(lambda: pt.solve(op_xla, b, check_every=1, **skw))
    pt.solve(op, b, check_every=32, **dict(skw, maxiter=64))
    cg, t_cg = timed_solve(lambda: pt.solve(op, b, check_every=32, **skw))
    n_ref = int(ref.iterations)
    for method, slack, rel in (("cg1", 2, 0.01), ("pipecg", 3, 0.02)):
        pt.solve(op, b, method=method, check_every=32, **dict(skw,
                                                              maxiter=64))
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, method=method, check_every=32, **skw)))
        its = int(res.iterations)
        plain = plain_reference(lambda: pt.solve(
            op_xla, b, method=method, check_every=32, **skw))
        same_bits = int(plain.iterations) == its \
            and torch.equal(bits(res.x), bits(plain.x))
        exact = pt.solve(op, b, method=method, check_every=1, **skw)
        n_exact = int(exact.iterations)
        true_rel = f64_true_residual(op64, b.double(), res.x.double())
        exact_rel = f64_true_residual(op64, b.double(), exact.x.double())
        want = 1 + its if method == "cg1" else 2 + its + 4 * (its // 16)
        within = (res.status_enum() == exact.status_enum()
                  == ref.status_enum() == pt.CGStatus.CONVERGED
                  and abs(n_exact - n_ref) <= max(slack, rel * n_ref)
                  and true_rel <= 2e-6)
        label = f"general_{method}_256"
        emit(label, shape=list(GRID_3D), iterations=its, seconds_to_1e6=t,
             iters_per_s=its / t, launches=seen,
             expected_stencil_launches=want, status=res.status_enum().name,
             true_rel_residual_f64=true_rel,
             plain_stencil_bits_equal=same_bits,
             iterations_check_every_1=n_exact,
             status_check_every_1=exact.status_enum().name,
             true_rel_residual_f64_check_every_1=exact_rel,
             plain_cg_iterations=n_ref,
             plain_cg_status=ref.status_enum().name,
             cg_iterations=int(cg.iterations), cg_seconds_to_1e6=t_cg,
             cg_iters_per_s=int(cg.iterations) / t_cg,
             limits=dict(iterations=f"max({slack}, {rel:.0%}) of cg's",
                         true_rel_residual_f64=2e-6),
             within_limits=within)
        if seen != {"stencil3d_apply": want}:
            raise AssertionError(f"{label}: launches {seen} for {its} "
                                 f"iterations, expected {want}")
        if not same_bits:
            raise AssertionError(f"{label}: the B2 solve and the plain "
                                 f"stencil's differ")
        if method == "cg1" and not within:
            raise AssertionError(f"{label}: {n_exact} vs {n_ref} "
                                 f"iterations, true residual {true_rel}")


def compensated_phase(pt, poisson, gen, count_main_path):
    """``solve(compensated=True)`` (double-float dots) with method="cg"
    and "cg1" on 2D Poisson 1024^2 with B1 to rtol 1e-6 (b = A x_true,
    check_every=1): the iteration counts within max(2, 1 %) of the
    uncompensated solves', one B1 launch per iteration (and cg1's one at
    init)."""
    op = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    op64 = poisson.poisson_2d_operator(*GRID_RES_2D, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000, engine="general", check_every=1)
    out = {}
    for method in ("cg", "cg1"):
        plain, t_plain = timed_solve(lambda: pt.solve(op, b, method=method,
                                                      **skw))
        (comp, t), seen = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, method=method, compensated=True, **skw)))
        its, n_plain = int(comp.iterations), int(plain.iterations)
        want = its + (1 if method == "cg1" else 0)
        out[method] = dict(
            iterations=its, status=comp.status_enum().name, seconds=t,
            us_per_iteration=t * 1e6 / its, launches=seen,
            true_rel_residual_f64=f64_true_residual(
                op64, b.double(), comp.x.double()),
            uncompensated_iterations=n_plain,
            uncompensated_status=plain.status_enum().name,
            uncompensated_us_per_iteration=t_plain * 1e6 / n_plain)
        if comp.status_enum() != pt.CGStatus.CONVERGED \
                or plain.status_enum() != pt.CGStatus.CONVERGED:
            raise AssertionError(f"compensated_1024 {method}: the solves "
                                 f"must converge")
        if abs(its - n_plain) > max(2, 0.01 * n_plain):
            raise AssertionError(f"compensated_1024 {method}: {its} vs "
                                 f"{n_plain} iterations")
        if seen != {"stencil2d_apply": want}:
            raise AssertionError(f"compensated_1024 {method}: launches "
                                 f"{seen}, expected {want}")
    emit("compensated_1024", shape=list(GRID_RES_2D), rtol=1e-6, **out)


def checkpoint_phase(pt, poisson, gen, count_main_path):
    """A ``method="cg"`` solve of 2D Poisson 1024^2 on B1 to rtol 1e-6
    (b = A x_true, check_every=1) stopped at ``iter_cap`` = half its
    iterations with ``return_checkpoint=True`` and resumed to the end: the
    same total iterations and the same x, bit for bit, as the unsplit
    solve; one B1 launch per iteration over the two halves."""
    op = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000, engine="general", check_every=1)
    full = pt.solve(op, b, **skw)
    n = int(full.iterations)
    half = n // 2
    (part, t1), seen1 = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, iter_cap=half, return_checkpoint=True,
                         **skw)))
    (rest, t2), seen2 = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, resume_from=part.checkpoint, **skw)))
    dx = max_err(rest.x, full.x)
    same_bits = torch.equal(bits(rest.x), bits(full.x))
    launches = seen1.get("stencil2d_apply", 0) \
        + seen2.get("stencil2d_apply", 0)
    emit("checkpoint_1024", shape=list(GRID_RES_2D), iterations=n,
         iter_cap=half, first_iterations=int(part.iterations),
         first_status=part.status_enum().name,
         checkpoint_k=int(part.checkpoint.k),
         resumed_iterations=int(rest.iterations),
         resumed_status=rest.status_enum().name, max_abs_dx=dx,
         bits_equal=same_bits, seconds=t1 + t2, launches=launches)
    if int(part.iterations) != half or int(part.checkpoint.k) != half \
            or int(rest.iterations) != n \
            or rest.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError(f"checkpoint_1024: {int(part.iterations)} + "
                             f"resume to {int(rest.iterations)}, unsplit {n}")
    if not same_bits or launches != n:
        raise AssertionError(f"checkpoint_1024: max|dx| {dx}, bits equal "
                             f"{same_bits}, {launches} B1 launches for {n}")


def df64_variants_phase(pt, systems, gen, count_main_path):
    """``cg_df64(method="cg1"|"pipecg")`` to rtol 1e-10 on B9 on the
    systems of ``csr_df64_1024`` (config #2's CSR in float64; the FEM
    matrix with Jacobi), b = A x_true in float64, check_every=32: the
    iteration count at check_every=1 within max(2, 1 %) of
    ``method="cg"``'s on the same operator, the f64 true residual, and
    the B9 launches: one per iteration and one at init for cg1; two at
    init and four per residual replacement (every 512) for pipecg."""
    out = {}
    for label, a, sell, pc in systems:
        x_true = torch.randn(a.n, generator=gen, device="cuda",
                             dtype=torch.float64)
        a64 = pt.CSRMatrix.from_arrays(a.data.double(), a.indices, a.indptr,
                                       a.shape)
        b = a64.matvec(x_true)
        skw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64,
                   preconditioner=pc)
        ref = pt.cg_df64(sell, b, check_every=1, **skw)
        n_ref = int(ref.iterations)
        out[label] = dict(preconditioner=pc, cg_iterations=n_ref,
                          cg_status=ref.status_enum().name)
        for method in ("cg1", "pipecg"):
            pt.cg_df64(sell, b, method=method, check_every=32,
                       **dict(skw, maxiter=32))
            (res, t), seen = count_main_path(lambda: timed_solve(
                lambda: pt.cg_df64(sell, b, method=method, check_every=32,
                                   **skw)))
            its = int(res.iterations)
            exact = pt.cg_df64(sell, b, method=method, check_every=1, **skw)
            n_exact = int(exact.iterations)
            true_rel = f64_true_residual(a64, b, res.x64)
            want = 1 + its if method == "cg1" \
                else 2 + its + 4 * (its // 512)
            out[label][method] = dict(
                iterations=its, seconds_to_1e10=t,
                us_per_iteration=t * 1e6 / its, launches=seen,
                expected_launches=want, status=res.status_enum().name,
                true_rel_residual_f64=true_rel,
                iterations_check_every_1=n_exact)
            name = f"df64_variants {label} {method}"
            if res.status_enum() != pt.CGStatus.CONVERGED \
                    or exact.status_enum() != pt.CGStatus.CONVERGED \
                    or ref.status_enum() != pt.CGStatus.CONVERGED:
                raise AssertionError(f"{name}: the solves must converge")
            if abs(n_exact - n_ref) > max(2, 0.01 * n_ref):
                raise AssertionError(f"{name}: {n_exact} vs {n_ref} "
                                     f"iterations")
            if seen != {"shift_ell_matvec_df64": want}:
                raise AssertionError(f"{name}: launches {seen}, expected "
                                     f"{want}")
            if not true_rel <= 2 * RTOL_F64:
                raise AssertionError(f"{name}: true residual {true_rel}")
    emit("df64_variants", rtol=RTOL_F64, **out)


# -- the distributed slice: B12, B3/B4 with halos, solve_distributed ----------

def check_resident_dist(hk, name, scale, b, **kw):
    """B12 on stacked slabs ``b`` ``(P, nx/P, ...)`` against its twin:
    equal iterations and flags, x within RESIDENT_TOL of max|x|, rr and
    the ||r||^2 trace within TRACE_TOL (-1 in the same blocks), every
    shard's scalars, flags and trace bit-identical, and the same bits
    from a second launch.  Returns (max|dx|, x and trace relative errors,
    the launch's outputs (x, rr, flags, hist))."""
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

    got = rd.cg_resident_dist(scale, b, per_shard=True, **kw)
    if not same_bits(got, rd.cg_resident_dist(scale, b, per_shard=True,
                                              **kw)):
        raise AssertionError(f"{name}: two launches differ")
    x, rr, flags, hist = got
    if not all(torch.equal(bits(rr[i:i + 1]), bits(rr[:1]))
               and torch.equal(flags[i], flags[0])
               and torch.equal(bits(hist[i]), bits(hist[0]))
               for i in range(rr.shape[0])):
        raise AssertionError(f"{name}: the shards' scalars differ")
    want = rd.cg_resident_dist(scale, b, interpret=True, **kw)
    mine = [int(v) for v in flags[0]]
    if mine != [int(want[i]) for i in (1, 3, 4, 5)]:
        raise AssertionError(f"{name}: iterations/flags {mine} differ from "
                             f"the twin's")
    err = max_err(x, want[0])
    x_max = float(want[0].abs().max())
    x_rel = err / x_max if x_max else (0.0 if err == 0 else math.inf)
    if not x_rel <= RESIDENT_TOL:
        raise AssertionError(f"{name}: max|dx| {err} = {x_rel} * max|x|")
    ran = want[6] != -1.0
    if not torch.equal(hist[0] != -1.0, ran):
        raise AssertionError(f"{name}: the trace's blocks that ran differ")
    trace = torch.cat([rr[:1], hist[0][ran]]).double()
    ref = torch.cat([want[2].reshape(1), want[6][ran]]).double()
    gap = (trace - ref).abs()
    if not bool((gap <= TRACE_TOL * ref.abs()).all()):
        raise AssertionError(f"{name}: rr or the trace differ from the "
                             f"twin's")
    trace_rel = float((gap / ref.abs().clamp_min(1e-30)).max())
    return err, x_rel, trace_rel, got


def resident_dist_row(hk, pt, scale, b, b3):
    """B12 at 1024^2 and 128^3 for P = 1, 2, 4 shards (degree 0), and at
    1024^2 with the degree-4 Chebyshev: against its twin, at P = 1
    against B10 bit for bit (x, trace, iterations), and timed per
    200-iteration launch at each P."""
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

    cheb = pt.ChebyshevPreconditioner.from_operator(
        pt.Stencil2D.create(*GRID_RES_2D, scale=scale), degree=CHEB_DEGREE)
    interval = dict(lmin=cheb.lmin, lmax=cheb.lmax)
    out = dict(shards=list(DIST_SHARDS), degree=CHEB_DEGREE, ms={},
               x_rel_err={}, trace_rel_err={}, b10_bitwise={},
               iterations={}, library_ms=None)
    worst = 0.0
    for label, base, degree in (("1024", b, 0), ("128", b3, 0),
                                (f"1024_degree_{CHEB_DEGREE}", b,
                                 CHEB_DEGREE)):
        kw = dict(RESIDENT_KW, degree=degree,
                  **(interval if degree else {}))
        for n in DIST_SHARDS:
            slabs = base.reshape((n, base.shape[0] // n) + base.shape[1:])
            key = f"{label}_p{n}"
            err, x_rel, trace_rel, got = check_resident_dist(
                hk, f"cg_resident_dist_local {key}", scale, slabs, **kw)
            worst = max(worst, err)
            out["x_rel_err"][key] = x_rel
            out["trace_rel_err"][key] = trace_rel
            out["iterations"][key] = int(got[2][0, 0])
            out["ms"][key] = time_ms(lambda: rd.cg_resident_dist(
                scale, slabs, **kw), reps=10)
            if n == 1:
                fn = hk.cg_resident_2d if base.ndim == 2 \
                    else hk.cg_resident_3d
                b10 = fn(scale, base, **dict(
                    RESIDENT_KW, precond_degree=degree,
                    **(interval if degree else {})))
                same = (torch.equal(bits(b10[0]), bits(got[0][0]))
                        and torch.equal(bits(b10[6]), bits(got[3][0]))
                        and int(b10[1]) == int(got[2][0, 0]))
                out["b10_bitwise"][label] = same
                b10_kw = dict(RESIDENT_KW, precond_degree=degree,
                              **(interval if degree else {}))
                out[f"b10_ms_{label}"] = time_ms(
                    lambda: fn(scale, base, **b10_kw), reps=10)
                if not same:
                    raise AssertionError(f"cg_resident_dist_local {label}: "
                                         f"one shard is not B10's bits")
    n = DIST_SHARDS[-1]
    slabs = b.reshape((n, b.shape[0] // n) + b.shape[1:])
    out["plain_ms"] = time_ms(lambda: rd.cg_resident_dist(
        scale, slabs, interpret=True, **RESIDENT_KW), reps=3)
    # the main shape: 1024^2 over P = 4
    main = f"1024_p{n}"
    iters = out["iterations"][main]
    cells, plane = b.numel(), b.shape[1]
    edges = 2 * (n - 1)      # inner slab edges, each a halo plane each way
    out.update(
        ms_by_case=out.pop("ms"), max_abs_err=worst, main_case=main,
        blocks_per_sm={f"{'3d' if t else '2d'}_{'cheb' if p else 'plain'}":
                       rd.blocks_per_sm(t, p)
                       for t in (False, True) for p in (False, True)},
        # B10's bytes and operations (b read, x written; 16 flops per cell
        # and iteration), plus per iteration one halo exchange (each edge
        # plane written to the peer and read there) and two allreduces of
        # P x P dot rows (8 bytes each, written and read), and the 2 flops
        # of each halo correction
        bytes=2 * cells * 4 + 3 * 4 + 4
        + iters * (edges * plane * 4 * 2 + 2 * n * n * 8 * 2),
        ops=cells * (2 + 16 * iters) + iters * edges * plane * 2)
    out["ms"] = out["ms_by_case"][main]
    return out


def halo_pass_rows(hk, scale, gen):
    """B3/B4 with ``halos=`` on a 64 x 256 x 256 slab (one of four shards
    of 256^3) with random neighbour planes: the arrays bit-equal to the
    twins', the sums within SCALAR_TOL, and timed beside the plain
    passes on the same slab."""
    beta = torch.tensor(0.45, device="cuda")
    alpha = torch.tensor(1e-3, device="cuda")
    slab = (GRID_3D[0] // 4,) + GRID_3D[1:]

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, p, x = randn(slab), randn(slab), randn(slab)
    halos = tuple(randn((1,) + slab[1:]) for _ in range(4))
    pn_k, pap_k = hk.fused_cg_pass_a(scale, beta, r, p, halos)
    pn_p, pap_p = hk.fused_cg_pass_a_plain(scale, beta, r, p, halos)
    check_equal("fused_cg_pass_a halos p_new", pn_k, pn_p)
    a_rel = check_scalar("fused_cg_pass_a halos pap", pap_k, pap_p)
    pn_halos = (halos[0] + beta * halos[2], halos[1] + beta * halos[3])
    xk, rk, rr_k = hk.fused_cg_pass_b(scale, alpha, pn_p, x.clone(),
                                      r.clone(), pn_halos)
    xp, rp, rr_p = hk.fused_cg_pass_b_plain(scale, alpha, pn_p, x.clone(),
                                            r.clone(), pn_halos)
    check_equal("fused_cg_pass_b halos x", xk, xp)
    check_equal("fused_cg_pass_b halos r", rk, rp)
    b_rel = check_scalar("fused_cg_pass_b halos rr", rr_k, rr_p)
    spare = torch.empty_like(r)
    xt, rt = x.clone(), r.clone()
    return dict(
        shape=list(slab), pass_a_pap_rel_err=a_rel,
        pass_b_rr_rel_err=b_rel, bit_equal=True,
        pass_a_ms_halo=time_ms(lambda: hk.fused_cg_pass_a(
            scale, beta, r, p, halos, out=spare)),
        pass_a_ms_no_halo=time_ms(lambda: hk.fused_cg_pass_a(
            scale, beta, r, p, out=spare)),
        pass_b_ms_halo=time_ms(lambda: hk.fused_cg_pass_b(
            scale, alpha, pn_p, xt, rt, pn_halos)),
        pass_b_ms_no_halo=time_ms(lambda: hk.fused_cg_pass_b(
            scale, alpha, pn_p, xt, rt)))


def halo_pass_rows_f64(hk, gen):
    """B6/B7 with ``halos=`` on a 64 x 256 x 256 f64 slab (one of four
    shards of 256^3) and on a 256 x 1024 slab (one of four of config #2),
    random neighbour planes: p_new, x and r bit-equal to the twins', the
    sums within SCALAR_TOL_F64, with the halos and without them on the
    same slabs; each pass timed both ways (median of TIMED)."""
    f64 = torch.float64
    scale, beta, alpha = (torch.tensor(v, device="cuda", dtype=f64)
                          for v in (0.37, 0.45, 1e-3))

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=f64)
    out = {}
    for label, grid in (("3d", GRID_3D), ("2d", GRID_RES_2D)):
        slab = (grid[0] // 4,) + tuple(grid[1:])
        r, p, x = randn(slab), randn(slab), randn(slab)
        halos = tuple(randn((1,) + slab[1:]) for _ in range(4))
        pn_halos = (halos[0] + beta * halos[2], halos[1] + beta * halos[3])
        cells = math.prod(slab)
        plane = cells // slab[0]
        row = dict(shape=list(slab), bit_equal=True,
                   pass_a_bytes=3 * cells * 8 + 4 * plane * 8 + 16 + 8,
                   pass_b_bytes=5 * cells * 8 + 2 * plane * 8 + 16 + 8,
                   pass_a_ops=13 * cells, pass_b_ops=14 * cells)
        for case, h, hb in (("halo", halos, pn_halos),
                            ("no_halo", None, None)):
            name = f"{slab} {case}"
            pn_k, pap_k = hk.fused_cg_pass_a_df64(scale, beta, r, p, h)
            pn_p, pap_p = hk.fused_cg_pass_a_plain(scale, beta, r, p, h)
            check_equal(f"fused_cg_pass_a_df64 {name} p_new", pn_k, pn_p)
            row[f"pass_a_pap_rel_err_{case}"] = check_scalar(
                f"fused_cg_pass_a_df64 {name} pap", pap_k, pap_p,
                SCALAR_TOL_F64)
            xk, rk, rr_k = hk.fused_cg_pass_b_df64(scale, alpha, pn_p,
                                                   x.clone(), r.clone(), hb)
            xp, rp, rr_p = hk.fused_cg_pass_b_plain(scale, alpha, pn_p,
                                                    x.clone(), r.clone(), hb)
            check_equal(f"fused_cg_pass_b_df64 {name} x", xk, xp)
            check_equal(f"fused_cg_pass_b_df64 {name} r", rk, rp)
            row[f"pass_b_rr_rel_err_{case}"] = check_scalar(
                f"fused_cg_pass_b_df64 {name} rr", rr_k, rr_p,
                SCALAR_TOL_F64)
            del pn_k, xk, rk, xp, rp
            spare = torch.empty_like(r)
            xt, rt = x.clone(), r.clone()
            row[f"pass_a_ms_{case}"] = time_ms(
                lambda: hk.fused_cg_pass_a_df64(scale, beta, r, p, h,
                                                out=spare))
            row[f"pass_b_ms_{case}"] = time_ms(
                lambda: hk.fused_cg_pass_b_df64(scale, alpha, pn_p, xt, rt,
                                                hb))
            del spare, xt, rt
        out[label] = row
    return out


def ragged_dist(hk, gen):
    """B12 where shards are single planes (3D with nx = P) and odd
    (9 x 17 x 33 at P = 3), and a 2D odd grid, at degrees 0 and 2,
    against its twin, and at the margin of its launch geometry; B3/B4
    with halos on odd slabs, and B4 on an odd grid without halos,
    bit-equal."""
    scale = torch.tensor(0.37, device="cuda")
    kw = dict(tol=0.0, rtol=1e-5, maxiter=300, check_every=1)
    worst, x_rel, runs = 0.0, 0.0, 0
    for shape, n in (((4, 17, 33), 4), ((3, 5, 7), 3), ((9, 17, 33), 3),
                     ((17, 257), 1), ((34, 200), 2)):
        b = torch.randn((n, shape[0] // n) + shape[1:], generator=gen,
                        device="cuda")
        for degree in (0, 2):
            interval = dict(lmin=0.05, lmax=12.5) if degree else {}
            err, rel, _, _ = check_resident_dist(
                hk, f"cg_resident_dist_local {shape} P={n} degree {degree}",
                scale, b, degree=degree, **interval, **kw)
            worst, x_rel, runs = max(worst, err), max(x_rel, rel), runs + 1
    margin = dist_margin(hk, scale, gen)
    worst, x_rel = max(worst, margin[0]), max(x_rel, margin[1])
    runs += 2
    beta = torch.tensor(0.45, device="cuda")
    alpha = torch.tensor(0.11, device="cuda")
    for shape in ((1, 200), (3, 17, 33), (1, 5, 7)):
        r, p, x = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        halos = tuple(torch.randn((1,) + shape[1:], generator=gen,
                                  device="cuda") for _ in range(4))
        check_equal(f"fused_cg_pass_a halos {shape}",
                    hk.fused_cg_pass_a(scale, beta, r, p, halos)[0],
                    hk.fused_cg_pass_a_plain(scale, beta, r, p, halos)[0])
        got = hk.fused_cg_pass_b(scale, alpha, p, x.clone(), r.clone(),
                                 halos[:2])
        want = hk.fused_cg_pass_b_plain(scale, alpha, p, x.clone(),
                                        r.clone(), halos[:2])
        check_equal(f"fused_cg_pass_b halos {shape} x", got[0], want[0])
        check_equal(f"fused_cg_pass_b halos {shape} r", got[1], want[1])
        runs += 1
    # a ragged grid without halos whose rows take 4-byte copies (n2 % 4)
    shape = (5, 9, 30)
    pn, x, r = (torch.randn(shape, generator=gen, device="cuda")
                for _ in range(3))
    got = hk.fused_cg_pass_b(scale, alpha, pn, x.clone(), r.clone())
    want = hk.fused_cg_pass_b_plain(scale, alpha, pn, x.clone(), r.clone())
    check_equal(f"fused_cg_pass_b {shape} x", got[0], want[0])
    check_equal(f"fused_cg_pass_b {shape} r", got[1], want[1])
    check_scalar(f"fused_cg_pass_b {shape} rr", got[2], want[2])
    runs += 1
    return dict(checks=runs, max_abs_err=worst, x_rel_err=x_rel)


def dist_margin(hk, scale, gen):
    """B12 at the margin of its launch geometry (csrc/resident_dist.cuh):
    one shard whose CTAs each walk the most tiles their shared slots hold
    (3 in 2D, 7 in 3D) against the twin; a slab one plane deeper is
    refused by the gate and by the launch's C entry alike.  Returns
    (max|dx|, x relative error) over both."""
    from cuda_mpi_parallel_tpu_torch.ops.cuda import _build
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(tol=0.0, rtol=1e-5, maxiter=200, check_every=32)
    worst, x_rel = 0.0, 0.0
    # 2D rows of 280 points take two tiles a block of 8 rows; 3D planes
    # of 1 x 512 points sixteen
    for n2, per_block, most in ((280, 2, 3 * 4), (512, 16, 7 * 2)):
        n0 = 8 * (most * sms // per_block)
        shape = (n0, n2) if n2 == 280 else (n0, 1, n2)
        deeper = (n0 + 1,) + shape[1:]
        if not rd.supports_resident_dist(shape) \
                or rd.supports_resident_dist(deeper):
            raise AssertionError(f"cg_resident_dist_local: the gate's margin "
                                 f"is not between {shape} and {deeper}")
        code = _build.library().cmpt_cg_resident_dist(
            *([None] * 14), n0 + 1, 1, n2, len(shape) - 2, 1, 1, 32, 0, None)
        if code == 0:
            raise AssertionError(f"cg_resident_dist_local: the launch takes "
                                 f"{deeper}, which the gate refuses")
        b = torch.randn((1,) + shape, generator=gen, device="cuda")
        err, rel, _, _ = check_resident_dist(
            hk, f"cg_resident_dist_local margin {shape}", scale, b, **kw)
        worst, x_rel = max(worst, err), max(x_rel, rel)
    return worst, x_rel


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_stencil_phase(pt, tpar, poisson, gen, count_main_path,
                       plain_reference):
    """``solve_distributed`` on 3D Poisson 256^3 (backend="pallas") over
    a 4-shard stacked mesh on the card (64 x 256 x 256 slabs) to rtol
    1e-6: the single-device general engine's count within max(2, 1 %) at
    check_every=1, P launches of B2 per matvec; and at P = 1 through
    the torch.distributed NCCL backend at world size 1, bit-equal to the
    stacked P = 1 solve."""
    import torch.distributed as dist

    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
    mesh = tpar.make_mesh(4, devices=["cuda:0"] * 4)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed(op, b, mesh=mesh, **skw)))
    ref = plain_reference(lambda: pt.solve(op_xla, b, engine="general",
                                           **skw))
    its, ref_its = int(res.iterations), int(ref.iterations)
    x_rel = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    one = tpar.make_mesh(1, devices=["cuda:0"])
    stacked = tpar.solve_distributed(op, b, mesh=one, **skw)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        nccl = tpar.solve_distributed(op, b, mesh=tpar.make_mesh(), **skw)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    nccl_equal = (torch.equal(nccl.x, stacked.x)
                  and int(nccl.iterations) == int(stacked.iterations))
    emit("dist_stencil_256", shape=list(GRID_3D), shards=4,
         iterations=its, seconds=t, iters_per_s=its / t, launches=seen,
         status=res.status_enum().name, plain_general_iterations=ref_its,
         x_rel_err=x_rel, p1_iterations=int(stacked.iterations),
         nccl_world_1_iterations=int(nccl.iterations),
         nccl_bit_equal=nccl_equal, comm_counts=dict(mesh.comm.counts))
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("dist_stencil_256: both solves must converge")
    if abs(its - ref_its) > max(2, 0.01 * ref_its):
        raise AssertionError(f"dist_stencil_256: {its} vs {ref_its}")
    if seen.get("stencil3d_apply") != 4 * its:
        raise AssertionError(f"dist_stencil_256: {seen} is not 4 B2 "
                             f"launches per iteration")
    if not nccl_equal:
        raise AssertionError("dist_stencil_256: the NCCL world-size-1 "
                             "solve is not the stacked P = 1 solve's bits")


def dist_streaming_phase(pt, tpar, poisson, gen, count_main_path):
    """``solve_distributed_streaming`` at 256^3 over 4 stacked shards to
    rtol 1e-6: P launches of B3 and of B4 per iteration, the
    single-device ``cg_streaming`` count within max(2, 1 %) at
    check_every=1."""
    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
    mesh = tpar.make_mesh(4, devices=["cuda:0"] * 4)
    tpar.solve_distributed_streaming(op, b, mesh=mesh,
                                     **dict(skw, maxiter=8))
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed_streaming(op, b, mesh=mesh, **skw)))
    ref = pt.cg_streaming(op, b, **skw)
    its, ref_its = int(res.iterations), int(ref.iterations)
    x_rel = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    emit("dist_streaming_256", shape=list(GRID_3D), shards=4,
         iterations=its, seconds=t, iters_per_s=its / t, launches=seen,
         status=res.status_enum().name, single_device_iterations=ref_its,
         x_rel_err=x_rel)
    if res.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("dist_streaming_256: the solve must converge")
    if abs(its - ref_its) > max(2, 0.01 * ref_its):
        raise AssertionError(f"dist_streaming_256: {its} vs {ref_its}")
    if seen.get("fused_cg_pass_a") != 4 * its \
            or seen.get("fused_cg_pass_b") != 4 * its:
        raise AssertionError(f"dist_streaming_256: {seen} is not 4 launches "
                             f"of each pass per iteration")


def dist_csr_phase(pt, tpar, csr, gen, count_main_path, plain_reference):
    """Config #2's CSR (1,048,576 rows) over 4 stacked shards on the
    allgather, gather and ring lanes to rtol 1e-6: each lane's count
    equal to the single-device CSR general engine's, and the gather lane
    bit-equal to the allgather lane."""
    x_true = torch.randn(csr.n, generator=gen, device="cuda")
    b = csr.matvec(x_true)
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
    mesh = tpar.make_mesh(4, devices=["cuda:0"] * 4)
    ref = plain_reference(lambda: pt.solve(csr, b, engine="general", **skw))
    ref_its = int(ref.iterations)
    out = {}
    for lane, kw in (("allgather", dict(exchange="allgather")),
                     ("gather", dict(exchange="gather")),
                     ("ring", dict(csr_comm="ring"))):
        (res, t), _ = count_main_path(lambda: timed_solve(
            lambda: tpar.solve_distributed(csr, b, mesh=mesh, **skw, **kw)))
        out[lane] = res
        emit_lane = dict(iterations=int(res.iterations), seconds=t,
                         us_per_iteration=t * 1e6 / int(res.iterations),
                         status=res.status_enum().name,
                         x_rel_err=float((res.x - ref.x).abs().max()
                                         / ref.x.abs().max()))
        out[lane + "_row"] = emit_lane
    gather_equal = torch.equal(out["gather"].x, out["allgather"].x)
    emit("dist_csr_1024", rows=csr.n, nnz=csr.nnz, shards=4,
         plain_csr_iterations=ref_its, gather_bit_equal_allgather=gather_equal,
         lanes={k: out[k + "_row"] for k in ("allgather", "gather", "ring")})
    for lane in ("allgather", "gather", "ring"):
        if int(out[lane].iterations) != ref_its \
                or out[lane].status_enum() != pt.CGStatus.CONVERGED:
            raise AssertionError(f"dist_csr_1024: the {lane} lane took "
                                 f"{int(out[lane].iterations)} iterations, "
                                 f"the single-device engine {ref_its}")
    if not gather_equal:
        raise AssertionError("dist_csr_1024: gather and allgather differ")


def resident_dist_phase(label, grid, pt, tpar, poisson, gen,
                        count_main_path, degrees):
    """``solve_distributed_resident`` on one system to rtol 1e-6 at P = 1,
    2 and 4 (b = A x_true): one B12 launch per solve, the count of B10 on
    the global grid within max(2, 1 %) at check_every=1, and
    us/iteration of a fixed 200-iteration solve beside B10's."""
    make = (poisson.poisson_2d_operator if len(grid) == 2
            else poisson.poisson_3d_operator)
    op = make(*grid, backend="pallas")
    op_xla = make(*grid, backend="xla")
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    rows = {}
    for degree in degrees:
        m = (pt.ChebyshevPreconditioner.from_operator(op, degree=degree)
             if degree else None)
        skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1, m=m)
        ref = pt.solve(op, b, engine="resident", **skw)
        ref_its = int(ref.iterations)
        done, secs = timed_solve(lambda: pt.solve(
            op, b, m=m, engine="resident", **RESIDENT_KW))
        b10_us = secs * 1e6 / int(done.iterations)
        for n in DIST_SHARDS:
            mesh = tpar.make_mesh(n, devices=["cuda:0"] * n)
            (res, t), seen = count_main_path(lambda: timed_solve(
                lambda: tpar.solve_distributed_resident(op, b, mesh=mesh,
                                                        **skw)))
            its = int(res.iterations)
            tpar.solve_distributed_resident(op, b, mesh=mesh, m=m,
                                            **dict(RESIDENT_KW, maxiter=32))
            done, secs = timed_solve(lambda: tpar.solve_distributed_resident(
                op, b, mesh=mesh, m=m, **RESIDENT_KW))
            key = f"degree_{degree}_p{n}"
            rows[key] = dict(iterations=its, b10_iterations=ref_its,
                             seconds=t, launches=seen,
                             status=res.status_enum().name,
                             us_per_iteration=secs * 1e6
                             / int(done.iterations),
                             b10_us_per_iteration=b10_us,
                             x_rel_err=float((res.x - ref.x).abs().max()
                                             / ref.x.abs().max()))
            if res.status_enum() != pt.CGStatus.CONVERGED:
                raise AssertionError(f"{label} {key}: the solve must "
                                     f"converge")
            if abs(its - ref_its) > max(2, 0.01 * ref_its):
                raise AssertionError(f"{label} {key}: {its} vs {ref_its}")
            if seen != {"cg_resident_dist_local": 1}:
                raise AssertionError(f"{label} {key}: expected one B12 "
                                     f"launch per solve, got {seen}")
    emit(label, shape=list(grid), shards=list(DIST_SHARDS), solves=rows)


# ptxas entry names of the instances the build line reports, and the key
# each is reported under
PTXAS_INSTANCES = (
    (r"_ZN4cmpt15resident_kernelI([fd])Lb([01])ELb([01])E",
     lambda g: f"{'f64' if g[0] == 'd' else 'f32'}_"
               f"{'3d' if g[1] == '1' else '2d'}_"
               f"{'cheb' if g[2] == '1' else 'plain'}"),
    (r"_ZN4cmpt19resident_cg1_kernelILb([01])E",
     lambda g: f"f32_{'3d' if g[0] == '1' else '2d'}_cg1"),
    (r"_ZN4cmpt25resident_cg1_shard_kernelILb([01])E",
     lambda g: f"f32_{'3d' if g[0] == '1' else '2d'}_cg1_one_barrier"),
    (r"_ZN4cmpt20resident_dist_kernelI([fd])Lb([01])ELb([01])E",
     lambda g: f"{'f64' if g[0] == 'd' else 'f32'}_"
               f"{'3d' if g[1] == '1' else '2d'}_"
               f"{'cheb' if g[2] == '1' else 'plain'}_dist"),
    (r"_ZN4cmpt12pass_a_marchILb([01])ELb([01])ELb([01])E",
     lambda g: f"pass_a_{'3d' if g[0] == '1' else '2d'}_"
               f"{'theta' if g[1] == '1' else 'plain'}_"
               f"{'copy16' if g[2] == '1' else 'copy4'}"),
    (r"_ZN4cmpt12pass_b_marchILb([01])ELb([01])ELb([01])E",
     lambda g: f"pass_b_{'3d' if g[0] == '1' else '2d'}_"
               f"{'rz' if g[1] == '1' else 'plain'}_"
               f"{'copy16' if g[2] == '1' else 'copy4'}"),
)


# -- MINRES and the ELL/DIA formats -------------------------------------------


MINRES_RTOL = 1e-5       # f32 MINRES on the indefinite system
MINRES_MAXITER = 20_000
REORDERED_TOL = 2e-5     # x of a solve whose every sum runs in another
#                          order (a permuted system): max|x - x_ref| <=
#                          this * max|x_ref|, the distributed lanes'
#                          parity limit (tests/test_torch_dist.py)


def minres_oracle_phase(pt, poisson, count_main_path):
    """The reference's indefinite 3x3 system through
    ``solve(method="minres")`` in f32 (tol 1e-5: in f32 beta does not
    reach 0 and the default absolute 1e-7 takes five steps) and through
    ``cg_df64(method="minres")`` (default tol): three iterations each,
    the indefiniteness certificate, x within 1e-5 (f32) and 1e-12
    (f64) of [0.5, 0.75, 1.0]."""
    t0 = time.perf_counter()
    a, b, x_exp = poisson.oracle_system(dtype=torch.float32)
    res, _ = count_main_path(lambda: pt.solve(a, b, method="minres",
                                              tol=1e-5))
    err = float((res.x.double().cpu() - torch.as_tensor(x_exp)).abs().max())
    a64, b64, _ = poisson.oracle_system(dtype=torch.float64)
    res64, _ = count_main_path(lambda: pt.cg_df64(a64, b64, method="minres"))
    err64 = float(abs(res64.x() - x_exp).max())
    emit("minres_oracle", iterations=int(res.iterations), max_abs_err=err,
         indefinite=bool(res.indefinite), status=res.status_enum().name,
         cg_df64_iterations=int(res64.iterations),
         cg_df64_max_abs_err=err64,
         cg_df64_indefinite=bool(res64.indefinite),
         cg_df64_status=res64.status_enum().name,
         limits=dict(iterations=3, max_abs_err=1e-5,
                     cg_df64_max_abs_err=1e-12),
         wall_seconds=time.perf_counter() - t0)
    for label, r, e, lim in (("f32", res, err, 1e-5),
                             ("cg_df64", res64, err64, 1e-12)):
        if int(r.iterations) != 3 or not bool(r.indefinite) \
                or r.status_enum() != pt.CGStatus.CONVERGED \
                or not e <= lim:
            raise AssertionError(f"minres_oracle {label}: expected 3 "
                                 f"iterations, converged, indefinite and "
                                 f"x within {lim}")


def host_syncs(fn):
    """``(fn(), syncs)``: the synchronizing CUDA calls ``fn`` made, as
    ``torch.cuda.set_sync_debug_mode`` reports them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def minres_256_phase(pt, poisson, gen, count_main_path, plain_reference):
    """``solve(method="minres", engine="auto")`` on 3D Poisson 256^3 with
    B2 (the north star) to rtol 1e-6, b = A x_true, ``check_every=32``:
    auto takes the general loop (the resident and streaming engines
    decline minres), one B2 launch an iteration and nothing else, at
    most one host sync a check block; held
    against the same solve on the plain torch stencil - equal status,
    count within max(2, 1 %), x within 1e-5 * max|x| - and the f64 true
    residual <= 2e-6."""
    t0 = time.perf_counter()
    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    op64 = poisson.poisson_3d_operator(*GRID_3D, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(method="minres", rtol=1e-6, maxiter=4000, check_every=32)
    pt.solve(op, b, engine="auto", **dict(skw, maxiter=64))      # warm-up
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b, engine="auto", **skw)))
    its = int(res.iterations)
    ref = plain_reference(lambda: pt.solve(op_xla, b, engine="general",
                                           **skw))
    n_ref = int(ref.iterations)
    # host syncs a check block: the predicate is one device boolean read
    # once a block; two solves of 64 and 256 iterations (tol 0) part by
    # six blocks, the set-up and epilogue syncs cancel
    syncs = {}
    for k in (64, 256):
        _, syncs[k] = host_syncs(lambda: pt.solve(
            op, b, engine="auto", **dict(skw, rtol=0.0, tol=0.0, maxiter=k)))
    per_block = (syncs[256] - syncs[64]) / 6
    x_err = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    true_rel = f64_true_residual(op64, b.double(), res.x.double())
    emit("minres_256", shape=list(GRID_3D), rtol=1e-6, iterations=its,
         seconds_to_1e6=t, iters_per_s=its / t, launches=seen,
         status=res.status_enum().name, indefinite=bool(res.indefinite),
         recurrence_rel_residual=float(res.residual_norm) / float(b.norm()),
         true_rel_residual_f64=true_rel, plain_stencil_iterations=n_ref,
         plain_stencil_status=ref.status_enum().name,
         x_rel_diff_plain=x_err, host_syncs=syncs,
         host_syncs_per_check_block=per_block,
         plain_stencil_bits_equal=n_ref == its
         and torch.equal(bits(res.x), bits(ref.x)),
         limits=dict(iterations="max(2, 1 %) of the plain stencil's",
                     x_rel_diff_plain=RESIDENT_TOL,
                     true_rel_residual_f64=2e-6,
                     host_syncs_per_check_block=1),
         wall_seconds=time.perf_counter() - t0)
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("minres_256: both solves must converge")
    if abs(its - n_ref) > max(2, 0.01 * n_ref):
        raise AssertionError(f"minres_256: {its} vs {n_ref} iterations")
    if seen != {"stencil3d_apply": its}:
        raise AssertionError(f"minres_256: launches {seen} for {its} "
                             f"iterations, expected B2 once each and no "
                             f"resident or streaming kernel")
    if not x_err <= RESIDENT_TOL or not true_rel <= 2e-6:
        raise AssertionError(f"minres_256: x {x_err} from the plain "
                             f"solve's, true residual {true_rel}")
    if per_block > 1:
        raise AssertionError(f"minres_256: {per_block} host syncs a check "
                             f"block ({syncs} at 64 / 256 iterations)")


def shifted_csr(pt, csr64, sigma: float, dtype):
    """``A - sigma I`` for a CSR ``A`` with a stored diagonal, in
    ``dtype``: the f64 values shifted, then rounded."""
    data = csr64.data.double().clone()
    data[csr64.indices == csr64.rows] -= sigma
    return pt.CSRMatrix.from_arrays(data.to(dtype), csr64.indices,
                                    csr64.indptr, csr64.shape)


def dirichlet_eig(i: int, j: int, n: int) -> float:
    """Eigenvalue (i, j) of the 5-point Laplacian on an n x n grid."""
    h = math.pi / (2 * (n + 1))
    return 4 * math.sin(i * h) ** 2 + 4 * math.sin(j * h) ** 2


def lowest_modes(n: int):
    """Eigenvectors (1, 1) and (1, 2) of the 5-point Laplacian on an
    n x n grid, unit norm, float64 on the card."""
    t = torch.arange(1, n + 1, dtype=torch.float64,
                     device="cuda") * (math.pi / (n + 1))
    s1, s2 = torch.sin(t), torch.sin(2 * t)
    u11, u12 = torch.outer(s1, s1).reshape(-1), torch.outer(s1, s2).reshape(-1)
    return u11 / u11.norm(), u12 / u12.norm()


def minres_indefinite_phase(pt, csr64, gen, count_main_path,
                            plain_reference):
    """Config #2's assembled matrix minus sigma I - sigma the midpoint of
    its two smallest distinct eigenvalues, so exactly one is negative
    (checked by the Rayleigh quotients of the two lowest modes) - solved
    by MINRES: f32 on the hand SpMV B8 (``to_shiftell()``) to rtol 1e-5
    and the f64 lane on B9 (``to_shiftell_df64()`` through
    ``cg_df64(method="minres")``) to rtol 1e-10, b = A_sigma x_true,
    maxiter 20,000, ``check_every=32``.  Each is held against the same
    solve on the plain torch CSR product (equal status, count within
    max(2, 1 %), the same ``indefinite``), launches its SpMV once an
    iteration, and reaches a true residual <= 2 rtol.  The line's
    ``within_limits`` also asks for ``indefinite`` (a negative Lanczos
    Rayleigh quotient v.Av, the JAX definition), which the JAX package
    does not raise on this system either: with one negative eigenvalue
    of 1.4e-5 beside a largest of 8 no Lanczos vector's quotient turns
    negative (``tools/minres_indefinite_flag.py``: false at 64^2 and
    128^2, and with sigma = 1; ROADMAP queue C)."""
    t0 = time.perf_counter()
    n = GRID_RES_2D[0]
    lam1, lam2 = dirichlet_eig(1, 1, n), dirichlet_eig(1, 2, n)
    sigma = 0.5 * (lam1 + lam2)
    a64 = shifted_csr(pt, csr64, sigma, torch.float64)
    a32 = shifted_csr(pt, csr64, sigma, torch.float32)
    u11, u12 = lowest_modes(n)
    q11 = float(torch.dot(u11, a64.matvec(u11)))
    q12 = float(torch.dot(u12, a64.matvec(u12)))
    out, faults = {}, []
    for label, a, sell, rtol in (
            ("f32", a32, a32.to_shiftell(), MINRES_RTOL),
            ("f64", a64, a64.to_shiftell_df64(), RTOL_F64)):
        f64 = label == "f64"
        x_true = torch.randn(a.n, generator=gen, device="cuda",
                             dtype=a.dtype)
        b = a.matvec(x_true)
        kw = dict(tol=0.0, rtol=rtol, maxiter=MINRES_MAXITER,
                  check_every=32, method="minres")

        def run(op, **over):
            if f64:
                return pt.cg_df64(op, b, **dict(kw, **over))
            return pt.solve(op, b, engine="general", **dict(kw, **over))
        run(sell, maxiter=32)                                    # warm-up
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: run(sell)))
        ref, t_ref = plain_reference(lambda: timed_solve(lambda: run(a)))
        its, n_ref = int(res.iterations), int(ref.iterations)
        x = res.x64 if f64 else res.x
        a_true = pt.CSRMatrix.from_arrays(a.data.double(), a.indices,
                                          a.indptr, a.shape)
        true_rel = f64_true_residual(a_true, b.double(), x.double())
        rr = res.residual_norm() ** 2 if f64 \
            else float(res.residual_norm) ** 2
        kernel = "shift_ell_matvec_df64" if f64 else "shift_ell_matvec"
        parity = (res.status_enum() == ref.status_enum()
                  and abs(its - n_ref) <= max(2, 0.01 * n_ref)
                  and bool(res.indefinite) == bool(ref.indefinite))
        within = (parity and res.status_enum() == pt.CGStatus.CONVERGED
                  and true_rel <= 2 * rtol and bool(res.indefinite))
        out[label] = dict(
            rtol=rtol, iterations=its, seconds=t,
            us_per_iteration=t * 1e6 / its, launches=seen,
            status=res.status_enum().name, indefinite=bool(res.indefinite),
            recurrence_rel_residual=math.sqrt(rr) / float(b.norm()),
            true_rel_residual_f64=true_rel,
            x_max_abs_err=float((x.double() - x_true.double()).abs().max()),
            plain_csr_iterations=n_ref,
            plain_csr_status=ref.status_enum().name,
            plain_csr_indefinite=bool(ref.indefinite),
            plain_csr_us_per_iteration=t_ref * 1e6 / max(n_ref, 1),
            limits=dict(iterations="max(2, 1 %) of the plain CSR's",
                        true_rel_residual_f64=2 * rtol, indefinite=True),
            within_limits=within)
        if seen != {kernel: its}:
            faults.append(f"{label}: {seen} for {its} iterations, "
                          f"expected {kernel} once each")
        if not parity or res.status_enum() != pt.CGStatus.CONVERGED \
                or not true_rel <= 2 * rtol:
            faults.append(f"{label}: {out[label]} against the plain CSR "
                          f"product's")
    emit("minres_indefinite_1024", rows=a64.n, nnz=a64.nnz, sigma=sigma,
         lambda_11=lam1, lambda_12=lam2, rayleigh_mode_11=q11,
         rayleigh_mode_12=q12, wall_seconds=time.perf_counter() - t0,
         **out)
    if not q11 < 0 < q12:
        faults.append(f"the shift leaves modes (1,1) / (1,2) at {q11} / "
                      f"{q12}, expected one negative")
    if faults:
        raise AssertionError("minres_indefinite_1024: " + "; ".join(faults))


def formats_phase(pt, csr, fem, gen, count_main_path, plain_reference):
    """The ELL/DIA formats and the RCM tools at full size: config #2's
    CSR as ``to_ell()`` and ``to_dia()`` (plain torch products), and the
    FEM matrix (``random_fem_2d(1_048_576, seed=0)``, config #5's
    stand-in) reordered by ``rcm_permutation()`` / ``permuted()``, its
    bandwidth before and after, on B8 (``to_shiftell()``) with Jacobi.
    f32 CG to rtol 1e-6 at ``check_every=1``; each form is held against
    the CSR solve of the same system - an equal count, x within 1e-5 *
    max|x| (the FEM x un-permuted: within 2e-5, ``REORDERED_TOL``, as
    every dot of the permuted solve sums in another order).  Then ELL,
    DIA, B8 and the CSR product at 200 iterations each (tol 0,
    ``check_every=32``), µs an iteration: information, not a target."""
    t0 = time.perf_counter()
    ell, dia = csr.to_ell(), csr.to_dia()
    x_true = torch.randn(csr.n, generator=gen, device="cuda")
    b = csr.matvec(x_true)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=4000, engine="general",
              check_every=1)
    ref = plain_reference(lambda: pt.solve(csr, b, **kw))
    n_ref = int(ref.iterations)
    out = dict(rows=csr.n, ell_width=ell.width, dia_offsets=list(
        dia.offsets), csr_iterations=n_ref,
        csr_status=ref.status_enum().name,
        limits=dict(iterations="the CSR solve's", x_rel_diff=RESIDENT_TOL))
    scale = float(ref.x.abs().max())
    for label, op in (("ell", ell), ("dia", dia)):
        res = plain_reference(lambda: pt.solve(op, b, **kw))
        err = float((res.x - ref.x).abs().max()) / scale
        out[label] = dict(iterations=int(res.iterations),
                          status=res.status_enum().name, x_rel_diff=err)
        if int(res.iterations) != n_ref or not err <= RESIDENT_TOL \
                or res.status_enum() != pt.CGStatus.CONVERGED:
            raise AssertionError(f"formats_1024 {label}: {out[label]} "
                                 f"against the CSR's {n_ref}")
    t1 = time.perf_counter()
    perm = fem.rcm_permutation()
    rcm_s = time.perf_counter() - t1
    fem_p = fem.permuted(perm)
    sell_p = fem_p.to_shiftell()
    bw, bw_p = fem.bandwidth(), fem_p.bandwidth()
    xf = torch.randn(fem.n, generator=gen, device="cuda")
    bf = fem.matvec(xf)
    perm_t = torch.as_tensor(perm, device="cuda").long()
    fkw = dict(kw, rtol=1e-6, maxiter=5000)
    jac = pt.JacobiPreconditioner.from_operator(fem)
    jac_p = pt.JacobiPreconditioner.from_operator(sell_p)
    fref = plain_reference(lambda: pt.solve(fem, bf, m=jac, **fkw))
    pt.solve(sell_p, bf[perm_t], m=jac_p, **dict(fkw, maxiter=32))
    (fres, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(sell_p, bf[perm_t], m=jac_p, **fkw)))
    x_back = torch.empty_like(fres.x)
    x_back[perm_t] = fres.x
    its, nf = int(fres.iterations), int(fref.iterations)
    ferr = float((x_back - fref.x).abs().max() / fref.x.abs().max())
    out["fem_rcm"] = dict(
        rows=fem.n, nnz=fem.nnz, bandwidth=bw, bandwidth_rcm=bw_p,
        rcm_seconds=rcm_s, iterations=its, seconds=t,
        us_per_iteration=t * 1e6 / its, launches=seen,
        status=fres.status_enum().name, csr_iterations=nf,
        csr_status=fref.status_enum().name, x_rel_diff=ferr,
        limits=dict(iterations="the CSR solve's", x_rel_diff=REORDERED_TOL))
    if seen != {"shift_ell_matvec": its}:
        raise AssertionError(f"formats_1024 fem_rcm: {seen} for {its} "
                             f"iterations")
    if its != nf or not ferr <= REORDERED_TOL \
            or fres.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError(f"formats_1024 fem_rcm: {out['fem_rcm']}")
    if not bw_p < bw:
        raise AssertionError(f"formats_1024: RCM bandwidth {bw_p} >= {bw}")
    # µs an iteration of the four products in one solve loop each
    sell = csr.to_shiftell()
    tkw = dict(tol=0.0, maxiter=200, check_every=32, engine="general")
    us = {}
    for label, op in (("ell", ell), ("dia", dia), ("shift_ell_b8", sell),
                      ("csr", csr)):
        pt.solve(op, b, **dict(tkw, maxiter=32))
        done, secs = timed_solve(lambda: pt.solve(op, b, **tkw))
        us[label] = secs * 1e6 / int(done.iterations)
    out["us_per_iteration_200"] = us
    emit("formats_1024", wall_seconds=time.perf_counter() - t0, **out)


def ptxas_resources(report: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    instance in ``PTXAS_INSTANCES``, from ptxas's report of this build
    ("" when the library was already built): the numbers that decide its
    blocks per SM."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        for pattern, key in PTXAS_INSTANCES:
            m = re.search(f"entry function '{pattern}", line)
            if m:
                name = key(m.groups())
                break
        if m or name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(m.group(1)) if m else 0
            name = None
    return out


# -- the telemetry core: flight recorder, heartbeat, events, health -----------


FLIGHT_TIMED_ITERS = 512   # the fixed-iteration solves the recorder's cost
#                            is timed on (tol 0), alternating on and off
FLIGHT_REPS = 15           # pairs: the host clock of a solve moves by
#                            +-100 us an iteration between solves
FLIGHT_ROWS = 2000         # rows of the recorder timed alone
KAPPA_SLACK = 1e-3         # a Ritz estimate may pass the analytic kappa
#                            by rounding only


def laplacian_kappa(n: int) -> float:
    """Condition number of the n^d Dirichlet Laplacian (any d): the
    largest over the smallest eigenvalue, cot^2(pi / (2 (n + 1)))."""
    h = math.pi / (2 * (n + 1))
    return (math.sin(n * h) / math.sin(h)) ** 2


def flight_256_phase(pt, tpar, poisson, gen, count_main_path):
    """The telemetry core on the north star: 3D Poisson 256^3 f32
    (BASELINE config #4), b = A x_true, rtol 1e-6, ``check_every=32``,
    every solve inside ``events.capture()``.

    Streaming (B3/B4) with ``FlightConfig.for_solve(maxiter)`` beside the
    same solve without it: equal counts, x bit-equal, rows 0..k, sqrt(rr)
    within 1e-6 of a ``record_history=True`` run's history, finite alpha
    and beta, equal host syncs a check block (``set_sync_debug_mode``,
    64 vs 256 iterations at tol 0), and us/iteration on and off over
    fixed 512-iteration solves.  General (B2) with ``stride=3,
    heartbeat=16``: rows every third iteration, one ``flight_heartbeat``
    event per sampled iteration, the host syncs of the solve without the
    recorder.  ``solve(engine="auto", flight=...)`` at 1024^2: the
    resident engine declined (an ``eligibility_rejected`` event), the
    streaming engine selected with ``flight_stride``, B10 not launched.
    ``solve_distributed_resident`` at 1024^2 over 1, 2 and 4 shards with
    ``flight=``: rows at multiples of ``check_every``, the last at the
    count.  Health: the streaming record ``converged``, its Ritz kappa
    at most ``KAPPA_SLACK`` above the Laplacian's analytic kappa; a
    recorded rerun of f32 pipecg (maxiter 4,000, ROADMAP queue C) not
    ``converged``.  Every captured event passes ``validate_event``."""
    import numpy as np

    from cuda_mpi_parallel_tpu_torch.telemetry import events
    from cuda_mpi_parallel_tpu_torch.telemetry import flight as tfl
    from cuda_mpi_parallel_tpu_torch.telemetry import health as thl

    t0 = time.perf_counter()
    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    maxiter = 4000
    skw = dict(tol=0.0, rtol=1e-6, maxiter=maxiter, check_every=32)
    cfg = tfl.FlightConfig.for_solve(maxiter)
    out = {}
    with events.capture() as stream:
        # streaming (B3/B4) with and without the recorder
        pt.solve(op, b, engine="streaming", flight=cfg,
                 **dict(skw, maxiter=64))                       # warm-up
        (on, t_on), seen_on = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, engine="streaming", flight=cfg, **skw)))
        (off, t_off), seen_off = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, engine="streaming", **skw)))
        hist = pt.solve(op, b, engine="streaming", record_history=True,
                        **skw).residual_history.double().cpu().numpy()
        its = int(on.iterations)
        rec = tfl.FlightRecord.from_buffer(on.flight)
        res_err = float(np.max(np.abs(rec.residuals - hist[:its + 1])
                               / hist[:its + 1]))
        fixed = dict(tol=0.0, rtol=0.0, maxiter=FLIGHT_TIMED_ITERS,
                     check_every=32)
        fixed_cfg = tfl.FlightConfig.for_solve(FLIGHT_TIMED_ITERS)
        times = {"on": [], "off": []}
        for _ in range(FLIGHT_REPS):
            for key, flight in (("on", fixed_cfg), ("off", None)):
                _, secs = timed_solve(lambda: pt.solve(
                    op, b, engine="streaming", flight=flight, **fixed))
                times[key].append(secs * 1e6 / FLIGHT_TIMED_ITERS)
        us = {k: statistics.median(v) for k, v in times.items()}
        paired = sorted(a - b for a, b in zip(times["on"], times["off"]))
        quartiles = statistics.quantiles(paired, n=4)
        # the recorder alone: host and device time a row
        ring = tfl.FlightRing(fixed_cfg, torch.float32, b.device, 0,
                              on.residual_norm)
        scalars = [on.residual_norm + i for i in range(3)]
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        t_row = time.perf_counter()
        start.record()
        for k in range(1, FLIGHT_ROWS + 1):
            ring.record(k % FLIGHT_TIMED_ITERS, *scalars)
        stop.record()
        row_host_us = (time.perf_counter() - t_row) * 1e6 / FLIGHT_ROWS
        torch.cuda.synchronize()
        row_device_us = start.elapsed_time(stop) * 1e3 / FLIGHT_ROWS
        syncs = {}
        for key, flight in (("on", cfg), ("off", None)):
            for k in (64, 256):
                _, syncs[f"{key}_{k}"] = host_syncs(lambda: pt.solve(
                    op, b, engine="streaming", flight=flight,
                    **dict(fixed, maxiter=k)))
        per_block = {key: (syncs[f"{key}_256"] - syncs[f"{key}_64"]) / 6
                     for key in ("on", "off")}
        health = thl.assess_solve_health(
            rec, converged=bool(on.converged), status=int(on.status),
            iterations=its)
        kappa = laplacian_kappa(GRID_3D[0])
        out["streaming"] = dict(
            iterations=its, iterations_off=int(off.iterations),
            x_sha256=sha256(on.x), x_sha256_off=sha256(off.x),
            seconds_to_1e6=t_on, seconds_to_1e6_off=t_off,
            launches=seen_on, launches_off=seen_off, rows=len(rec),
            sqrt_rr_rel_err_vs_history=res_err,
            alpha_beta_finite=bool(np.isfinite(rec.alphas[1:]).all()
                                   and np.isfinite(rec.betas[1:]).all()),
            us_per_iteration_on=us["on"], us_per_iteration_off=us["off"],
            recorder_us_per_iteration=statistics.median(paired),
            recorder_us_per_iteration_quartiles=[quartiles[0],
                                                 quartiles[2]],
            us_per_iteration_samples=times,
            recorder_row_host_us=row_host_us,
            recorder_row_device_us=row_device_us,
            host_syncs=syncs, host_syncs_per_check_block=per_block,
            health=health.classification.name,
            kappa_estimate=health.kappa_estimate, kappa_analytic=kappa,
            kappa_ratio=(health.kappa_estimate / kappa
                         if health.kappa_estimate else None),
            ritz_min=health.ritz_min, ritz_max=health.ritz_max)
        checks = [
            (its == int(off.iterations), "the counts differ"),
            (torch.equal(bits(on.x), bits(off.x)), "x differs"),
            (np.array_equal(rec.iterations, np.arange(its + 1)),
             "rows are not 0..k"),
            (res_err <= 1e-6, f"sqrt(rr) {res_err} from the history"),
            (out["streaming"]["alpha_beta_finite"], "alpha/beta not finite"),
            (per_block["on"] == per_block["off"]
             and syncs["on_256"] == syncs["off_256"],
             f"host syncs {syncs}"),
            (health.classification == pt.CGStatus.CONVERGED,
             f"health {health.classification.name}"),
            (health.kappa_estimate is not None
             and health.kappa_estimate <= kappa * (1 + KAPPA_SLACK),
             f"kappa {health.kappa_estimate} vs analytic {kappa}")]

        # general (B2), decimated, with the heartbeat
        gcfg = tfl.FlightConfig.for_solve(maxiter, stride=3, heartbeat=16)
        gen_kw = dict(skw, engine="general")
        with events.solve_scope():           # warm-up; its scope drains
            pt.solve(op, b, flight=gcfg, **dict(gen_kw, maxiter=64))
        with events.solve_scope() as sid:
            (g, t_g), seen_g = count_main_path(lambda: timed_solve(
                lambda: host_syncs(lambda: pt.solve(op, b, flight=gcfg,
                                                    **gen_kw))))
        g, g_syncs = g
        g_off, g_syncs_off = host_syncs(lambda: pt.solve(op, b, **gen_kw))
        g_its = int(g.iterations)
        beats = [e["iteration"] for e in map(
            json.loads, stream.getvalue().splitlines())
            if e["event"] == "flight_heartbeat" and e["solve_id"] == sid]
        grec = tfl.FlightRecord.from_buffer(g.flight)
        sampled = list(range(16, g_its + 1, 16))
        out["general"] = dict(
            iterations=g_its, iterations_off=int(g_off.iterations),
            seconds_to_1e6=t_g, launches=seen_g, rows=len(grec),
            stride=grec.stride, heartbeats=len(beats),
            sampled_iterations=len(sampled), host_syncs=g_syncs,
            host_syncs_off=g_syncs_off,
            x_bits_equal_off=torch.equal(bits(g.x), bits(g_off.x)))
        checks += [
            (np.array_equal(grec.iterations, np.arange(0, g_its + 1, 3)),
             "general rows are not every third iteration"),
            (sorted(beats) == sampled, f"heartbeats {len(beats)} vs "
                                       f"{len(sampled)} sampled"),
            (g_syncs == g_syncs_off, f"general host syncs {g_syncs} vs "
                                     f"{g_syncs_off}"),
            (out["general"]["x_bits_equal_off"], "general x differs")]

        # auto at 1024^2: the resident engine declines the recorder
        op2 = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
        b2 = poisson.poisson_2d_operator(*GRID_RES_2D).matvec(
            torch.randn(op2.n, generator=gen, device="cuda"))
        mark = len(stream.getvalue().splitlines())
        a_res, seen_a = count_main_path(lambda: pt.solve(
            op2, b2, engine="auto", flight=cfg, **skw))
        story = [json.loads(ln) for ln in stream.getvalue().splitlines()[mark:]]
        story = [(e["event"], e["engine"], e.get("flight_stride"))
                 for e in story if e["event"] in ("engine_selected",
                                                  "eligibility_rejected")]
        out["auto_1024"] = dict(iterations=int(a_res.iterations),
                                events=story, launches=seen_a)
        checks += [
            (story == [("eligibility_rejected", "resident", None),
                       ("engine_selected", "streaming", 1)],
             f"auto's events {story}"),
            ("cg_resident" not in seen_a and seen_a.get("fused_cg_pass_a"),
             f"auto launched {seen_a}")]

        # the B12 lane: the block trace as the record
        op_r = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
        lanes = {}
        for n in DIST_SHARDS:
            mesh = tpar.make_mesh(n, devices=["cuda:0"] * n)
            mark = len(stream.getvalue().splitlines())
            r, seen_r = count_main_path(
                lambda: tpar.solve_distributed_resident(
                    op_r, b2, mesh=mesh, flight=cfg, **skw))
            chosen = [json.loads(ln) for ln in
                      stream.getvalue().splitlines()[mark:]]
            rrec = tfl.FlightRecord.from_buffer(r.flight)
            r_its = int(r.iterations)
            lanes[f"p{n}"] = dict(iterations=r_its, rows=len(rrec),
                                  last_row=int(rrec.iterations[-1]),
                                  launches=seen_r,
                                  flight_stride=chosen[-1].get(
                                      "flight_stride"))
            checks += [
                (bool(np.all(rrec.iterations[:-1] % 32 == 0))
                 and int(rrec.iterations[-1]) == r_its,
                 f"B12 P={n} rows {rrec.iterations[-3:]} for {r_its}"),
                (chosen[-1].get("flight_stride") == 32,
                 f"B12 P={n} event {chosen[-1]}"),
                (seen_r == {"cg_resident_dist_local": 1},
                 f"B12 P={n} launches {seen_r}")]
        out["resident_dist_1024"] = lanes

        # health of f32 pipecg, which stops at maxiter at this size
        pcfg = tfl.FlightConfig.for_solve(maxiter)
        (p_res, t_p), seen_p = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, engine="general", method="pipecg",
                             flight=pcfg, **skw)))
        p_health = thl.assess_solve_health(
            tfl.FlightRecord.from_buffer(p_res.flight),
            converged=bool(p_res.converged), status=int(p_res.status),
            iterations=int(p_res.iterations))
        out["pipecg"] = dict(iterations=int(p_res.iterations),
                             status=p_res.status_enum().name,
                             seconds=t_p, launches=seen_p,
                             health=p_health.to_json())
        checks.append((p_health.classification != pt.CGStatus.CONVERGED,
                       f"pipecg health {p_health.classification.name}"))

    records = [json.loads(ln) for ln in stream.getvalue().splitlines()]
    bad = []
    for rec_ in records:
        try:
            events.validate_event(rec_)
        except ValueError as e:
            bad.append(str(e))
    kinds = {}
    for rec_ in records:
        kinds[rec_["event"]] = kinds.get(rec_["event"], 0) + 1
    checks.append((not bad and records, f"invalid events {bad[:3]}"))
    failed = [msg for ok, msg in checks if not ok]
    emit("flight_256", shape=list(GRID_3D), rtol=1e-6, check_every=32,
         **out, events=len(records), event_kinds=kinds,
         invalid_events=len(bad),
         limits=dict(sqrt_rr_rel_err_vs_history=1e-6,
                     kappa_over_analytic=1 + KAPPA_SLACK,
                     host_syncs="equal on and off"),
         failed=failed, wall_seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"flight_256: {failed}")


MG_GRIDS_3D = ((64, 64, 64), (128, 128, 128), GRID_3D)  # the count ladder
MG_SHARDS = 4            # the slab lane's stacked shards on the one card
MG_VCYCLE_REPS = 10      # host-timed V-cycles (median)


def vcycle_cost(m, r) -> dict:
    """One V-cycle of ``m`` on ``r``: the device operations it launches
    (kernels, copies and fills, as ``torch.profiler`` records them) and
    the median host microseconds of one call, each call started on an
    idle card so that no launch waits for a free queue slot."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m @ r
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m @ r
        torch.cuda.synchronize()
    names = collections.Counter(
        ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    host = []
    for _ in range(MG_VCYCLE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m @ r
        host.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return dict(device_ops=sum(names.values()),
                stencil_kernels=sum(n for k, n in names.items()
                                    if "stencil_kernel" in k),
                host_us=statistics.median(host))


def idle_share(fn) -> dict:
    """``fn`` (one solve) under ``torch.profiler``, tracing the card only
    (host-side op tracing would slow the host-bound loop it measures):
    the card's busy time (the device events' self time) and its idle
    share, 1 - busy / wall, the wall clock the profiled run's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed_solve(fn)
    busy_us = sum(ev.self_device_time_total for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA)
    return dict(wall_s=wall, device_busy_us=busy_us,
                idle_share=1 - busy_us * 1e-6 / wall if busy_us else None)


def mg_256_phase(pt, tpar, poisson, gen, count_main_path, plain_reference,
                 smi):
    """The geometric multigrid preconditioner (``models.multigrid``, one
    V(1,1) cycle, coarse levels on plain torch) as M in CG, b = A x_true,
    x0 = 0:

    * 3D Poisson 256^3 f32 (config #4): ``solve(a, b, m=MG(a),
      engine="auto")`` with ``a`` on B2, rtol 1e-6, ``check_every=32``:
      the general engine and nothing but B2, whose launches are 3 an
      iteration (the CG product and the cycle's two fine-level products:
      its pre-sweep from zero needs none) and 2 for the initial cycle;
      the count (at ``check_every`` 32 and 1) within max(2, 1 %) of the
      same solve on the plain stencil, x within 1e-5 * max|x| of it, the
      f64 true residual <= 2e-6, the host syncs a check block of the
      solve without m (``set_sync_debug_mode``, 8 vs 24 iterations at
      tol 0 in blocks of 8); the counts at check_every=1 on 64^3, 128^3
      and 256^3, 256^3's at most 64^3's + 5 (grid independence, as the
      JAX package asserts it).
    * 2D Poisson 1024^2 f32 (config #2, matrix-free): the same through
      B1.
    * The f64 lane: ``cg_df64(a, b, preconditioner="mg")`` at 1024^2 to
      rtol 1e-10: under a third of plain ``cg_df64``'s count, the f64
      true residual <= 2e-10, B1 (f32, the cycle's finest level) twice
      a cycle.
    * The slab lane: ``solve_distributed(..., preconditioner="mg")`` at
      256^3 over 4 stacked shards (check_every=1): the single-device
      count within 1, x within 1e-5 * max|x| of the single-device
      solve's, 4 B2 launches a fine-level product, one ``all_gather``
      a V-cycle.

    Reported beside the card: us an iteration and time to tolerance of
    each, 256^3 on the streaming engine and 1024^2 on the resident
    engine on the same systems, one V-cycle's device operations and
    host us at 256^3 and 1024^2, and the card's idle share over the
    256^3 MG-PCG solve (``torch.profiler``)."""
    from cuda_mpi_parallel_tpu_torch.models import MultigridPreconditioner

    def mg(a):
        return MultigridPreconditioner.from_operator(a)

    t_phase = time.perf_counter()
    checks, out = [], {}
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000)

    def system(grid):
        make = (poisson.poisson_2d_operator if len(grid) == 2
                else poisson.poisson_3d_operator)
        op = make(*grid, backend="pallas")
        op_xla = make(*grid, backend="xla")
        op64 = make(*grid, dtype=torch.float64)
        x_true = torch.randn(op.n, generator=gen, device=gen.device)
        return op, op_xla, op64, op_xla.matvec(x_true)

    def single(label, grid, kernel, engine, engine_kernel):
        """The f32 case on one grid; returns its solves."""
        t_case = time.perf_counter()
        op, op_xla, op64, b = system(grid)
        m = mg(op)
        pt.solve(op, b, m=m, engine="auto", check_every=32, maxiter=32)
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, m=m, engine="auto", check_every=32,
                             **skw)))
        its = int(res.iterations)
        (exact, t1), seen1 = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, m=m, engine="auto", check_every=1,
                             **skw)))
        ref = plain_reference(lambda: pt.solve(
            op_xla, b, m=mg(op_xla), check_every=32, **skw))
        ref1 = plain_reference(lambda: pt.solve(
            op_xla, b, m=mg(op_xla), check_every=1, **skw))
        x_err = float((res.x - ref.x).abs().max() / ref.x.abs().max())
        true_rel = f64_true_residual(op64, b.double(), res.x.double())
        syncs = {}
        # host syncs a check block, with m (auto: the general engine) and
        # without it (the general engine): solves of 8 and 24 iterations
        # at tol 0 in blocks of 8 part by two blocks (MG's f32 ||r||^2
        # underflows to 0 some 40 iterations in, which stops a tol-0
        # solve, so the blocks are short)
        for name, mm, eng in (("mg", m, "auto"), ("none", None, "general")):
            for k in (8, 24):
                r_k, syncs[f"{name}_{k}"] = host_syncs(lambda: pt.solve(
                    op, b, m=mm, engine=eng, tol=0.0, maxiter=k,
                    check_every=8))
                checks.append((int(r_k.iterations) == k,
                               f"{label} {name}: {int(r_k.iterations)} of "
                               f"{k} tol-0 iterations ran"))
        per_block = {name: (syncs[f"{name}_24"] - syncs[f"{name}_8"]) / 2
                     for name in ("mg", "none")}
        # the engine the system would take without m, to the same rtol
        pt.solve(op, b, engine=engine, check_every=32, maxiter=32)
        (fast, t_fast), seen_fast = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, engine=engine, check_every=32, **skw)))
        n = int(exact.iterations)
        row = dict(
            shape=list(grid), levels=m.n_levels, iterations=its,
            seconds_to_1e6=t, us_per_iteration=t * 1e6 / its,
            launches=seen, status=res.status_enum().name,
            iterations_check_every_1=n, seconds_to_1e6_check_every_1=t1,
            us_per_iteration_check_every_1=t1 * 1e6 / n,
            plain_stencil_iterations=int(ref.iterations),
            plain_stencil_iterations_check_every_1=int(ref1.iterations),
            x_rel_diff_plain=x_err, true_rel_residual_f64=true_rel,
            host_syncs=syncs, host_syncs_per_check_block=per_block,
            vcycle=vcycle_cost(m, b),
            **{engine: dict(iterations=int(fast.iterations),
                            seconds_to_1e6=t_fast, launches=seen_fast)},
            wall_seconds=time.perf_counter() - t_case)
        want = {kernel: 3 * its + 2}
        want1 = {kernel: 3 * n + 2}
        checks.extend([
            (res.status_enum() == exact.status_enum() == ref.status_enum()
             == ref1.status_enum() == pt.CGStatus.CONVERGED,
             f"{label}: every solve must converge"),
            (seen == want and seen1 == want1,
             f"{label}: launches {seen} / {seen1}, expected {want} / "
             f"{want1} (the general engine, 3 an iteration + 2)"),
            (abs(its - int(ref.iterations))
             <= max(2, 0.01 * int(ref.iterations))
             and abs(n - int(ref1.iterations))
             <= max(2, 0.01 * int(ref1.iterations)),
             f"{label}: counts {its} / {n} vs the plain stencil's "
             f"{int(ref.iterations)} / {int(ref1.iterations)}"),
            (x_err <= RESIDENT_TOL, f"{label}: x {x_err} from the plain "
                                    f"solve's"),
            (true_rel <= 2e-6, f"{label}: true residual {true_rel}"),
            (per_block["mg"] == per_block["none"] <= 1
             and syncs["mg_8"] == syncs["none_8"],
             f"{label}: host syncs {syncs}"),
            (seen_fast.get(engine_kernel, 0) > 0
             and fast.status_enum() == pt.CGStatus.CONVERGED,
             f"{label}: the {engine} engine's solve {seen_fast}")])
        return row, res, exact, (op, b)

    # 3D: the ladder at check_every=1, the north star in full
    ladder = {}
    for grid in MG_GRIDS_3D[:-1]:
        op, _, _, b = system(grid)
        ladder[grid[0]] = int(pt.solve(op, b, m=mg(op), check_every=1,
                                       **skw).iterations)
    row3, res3, exact3, (op3, b3) = single(
        "mg_256", MG_GRIDS_3D[-1], "stencil3d_apply", "streaming",
        "fused_cg_pass_a")
    ladder[MG_GRIDS_3D[-1][0]] = row3["iterations_check_every_1"]
    row3["iterations_by_extent_check_every_1"] = ladder
    t_prof = time.perf_counter()
    row3["profiled"] = idle_share(lambda: pt.solve(
        op3, b3, m=mg(op3), engine="auto", check_every=32, **skw))
    row3["profiled"]["wall_seconds"] = time.perf_counter() - t_prof
    checks.append((ladder[MG_GRIDS_3D[-1][0]] <= ladder[MG_GRIDS_3D[0][0]] + 5,
                   f"grid independence: {ladder}"))
    out["f32_3d"] = row3

    # 2D config #2 through B1, beside the resident engine
    row2, _, _, (op2, b2) = single("mg_1024", GRID_RES_2D,
                                   "stencil2d_apply", "resident",
                                   "cg_resident")
    out["f32_2d"] = row2

    # the f64 lane at 1024^2: the f32 cycle on B1, the recurrence in f64
    t_case = time.perf_counter()
    op64 = poisson.poisson_2d_operator(*GRID_RES_2D, dtype=torch.float64)
    dkw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64)
    pt.cg_df64(op2, b2, preconditioner="mg", maxiter=2)       # warm-up
    (dres, t_d), seen_d = count_main_path(lambda: timed_solve(
        lambda: pt.cg_df64(op2, b2, preconditioner="mg", **dkw)))
    (plain, t_p), seen_p = count_main_path(lambda: timed_solve(
        lambda: pt.cg_df64(op2, b2, **dkw)))
    d_its, p_its = int(dres.iterations), int(plain.iterations)
    b64 = b2.double()
    d_true = f64_true_residual(op64, b64, dres.x64)
    p_true = f64_true_residual(op64, b64, plain.x64)
    out["f64_2d"] = dict(
        shape=list(GRID_RES_2D), rtol=RTOL_F64, iterations=d_its,
        seconds_to_1e10=t_d, us_per_iteration=t_d * 1e6 / d_its,
        launches=seen_d, status=dres.status_enum().name,
        true_rel_residual_f64=d_true, plain_iterations=p_its,
        plain_seconds_to_1e10=t_p,
        plain_us_per_iteration=t_p * 1e6 / p_its, plain_launches=seen_p,
        plain_true_rel_residual_f64=p_true,
        wall_seconds=time.perf_counter() - t_case)
    checks.extend([
        (dres.status_enum() == plain.status_enum() == pt.CGStatus.CONVERGED,
         "f64: both solves must converge"),
        (3 * d_its < p_its, f"f64: {d_its} iterations against plain "
                            f"{p_its}"),
        (d_true <= 2e-10, f"f64: true residual {d_true}"),
        (seen_d == {"stencil2d_apply": 2 * (d_its + 1)} and not seen_p,
         f"f64: launches {seen_d} / plain {seen_p}, expected B1 twice "
         f"a V-cycle")])

    # the slab lane at 256^3 over stacked shards, against the one-device
    # count at check_every=1
    t_case = time.perf_counter()
    mesh = tpar.make_mesh(MG_SHARDS, devices=[b3.device] * MG_SHARDS)
    tpar.solve_distributed(op3, b3, mesh=mesh, preconditioner="mg",
                           check_every=1, maxiter=2)         # warm-up
    mesh.comm.counts.clear()
    (sres, t_s), seen_s = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed(op3, b3, mesh=mesh,
                                       preconditioner="mg", check_every=1,
                                       **skw)))
    s_its, n1 = int(sres.iterations), int(exact3.iterations)
    s_err = float((sres.x - exact3.x).abs().max() / exact3.x.abs().max())
    comm = dict(mesh.comm.counts)
    out["slab_3d"] = dict(
        shape=list(MG_GRIDS_3D[-1]), shards=MG_SHARDS, iterations=s_its,
        seconds_to_1e6=t_s, us_per_iteration=t_s * 1e6 / s_its,
        launches=seen_s, status=sres.status_enum().name,
        single_device_iterations=n1, x_rel_diff_single=s_err,
        comm_counts=comm, wall_seconds=time.perf_counter() - t_case)
    checks.extend([
        (sres.status_enum() == pt.CGStatus.CONVERGED,
         "slab: must converge"),
        (abs(s_its - n1) <= 1, f"slab: {s_its} vs one device's {n1}"),
        (s_err <= RESIDENT_TOL, f"slab: x {s_err} from one device's"),
        (seen_s == {"stencil3d_apply": MG_SHARDS * (3 * s_its + 2)},
         f"slab: launches {seen_s}, expected {MG_SHARDS} B2 a fine-level "
         f"product"),
        (comm.get("all_gather") == s_its + 1,
         f"slab: collectives {comm}, expected one all_gather a V-cycle")])
    failed = [msg for ok, msg in checks if not ok]
    emit("mg_256", card=smi, **out,
         limits=dict(launches="3 an iteration + 2 (B2/B1), 4x on slabs",
                     iterations="max(2, 1 %) of the plain stencil's; "
                                "slab: one device's +-1; f64: < plain / 3",
                     x_rel_diff=RESIDENT_TOL, true_rel_residual_f64=2e-6,
                     f64_true_rel_residual=2e-10,
                     grid_independence="256^3 <= 64^3 + 5",
                     host_syncs="a check block equal with and without m"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"mg_256: {failed}")


DIST_DF64_SHARDS = 4     # the f64 lanes' stacked shards on the one card


def dist_df64_256_phase(pt, tpar, poisson, gen, count_main_path,
                        plain_reference, smi):
    """The distributed f64 lane on a stacked mesh of 4 shards on the card,
    rtol 1e-10, b = A x_true in float64, check_every=1:

    * ``solve_distributed_streaming_df64`` at 256^3 (B6/B7 with halos):
      the count within max(2, 1 %) of the single-device
      ``cg_streaming_df64``'s, the f64 true residual <= 2e-10, exactly 4
      B6 and 4 B7 launches an iteration, one host read a check block
      (``set_sync_debug_mode``: solves of 8 and 24 iterations at tol 0
      in blocks of 8);
    * ``solve_distributed_df64`` at 256^3, ``method="cg"`` (the f64 B2 on
      each slab, 4 launches an iteration) within max(2, 1 %) of the
      single-device ``cg_df64``'s count, and ``preconditioner="mg"``
      (the f32 V-cycle on the slabs' f32 siblings: 4 (3k + 2) B2
      launches) at most a third of plain's count;
    * config #2 (1024^2 in float64): ``cg1``, ``pipecg``, ``minres``,
      ``jacobi`` and a degree-4 ``chebyshev``, each within max(2, 1 %) of
      the single-device ``cg_df64``'s count with the same arguments, the
      f64 true residual <= 2e-10, the B1 launches of its recurrence (4 a
      matvec; the Chebyshev interval's estimate on the global operator
      measured apart).

    Each with iterations/s and us an iteration on the host clock."""
    t_phase = time.perf_counter()
    f64 = torch.float64
    n_sh = DIST_DF64_SHARDS
    mesh = tpar.make_mesh(n_sh, devices=["cuda:0"] * n_sh)
    skw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64, check_every=1)
    checks, out = [], {}

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def row(res, t, seen, ref, true_rel, **extra):
        its = int(res.iterations)
        return dict(iterations=its, seconds_to_1e10=t, iters_per_s=its / t,
                    us_per_iteration=t * 1e6 / its, launches=seen,
                    status=res.status_enum().name,
                    single_device_iterations=int(ref.iterations),
                    single_device_status=ref.status_enum().name,
                    true_rel_residual_f64=true_rel, **extra)

    def converged(*results):
        return all(r.status_enum() == pt.CGStatus.CONVERGED for r in results)

    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op64 = poisson.poisson_3d_operator(*GRID_3D, dtype=f64)
    b = op64.matvec(torch.randn(op.n, generator=gen, device="cuda",
                                dtype=f64))

    # 256^3 on the streaming lane: B6/B7 with halos
    t_case = time.perf_counter()
    stream = tpar.solve_distributed_streaming_df64
    stream(op, b, mesh=mesh, tol=0.0, maxiter=8, check_every=8)  # warm-up
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: stream(op, b, mesh=mesh, **skw)))
    ref = pt.cg_streaming_df64(op, b, **skw)
    syncs = {}
    for k in (8, 24):
        r_k, syncs[k] = host_syncs(lambda: stream(
            op, b, mesh=mesh, tol=0.0, maxiter=k, check_every=8))
        checks.append((int(r_k.iterations) == k,
                       f"streaming: {int(r_k.iterations)} of {k} tol-0 "
                       f"iterations ran"))
    per_block = (syncs[24] - syncs[8]) / 2
    its = int(res.iterations)
    true_rel = f64_true_residual(op64, b, res.x64)
    want = {"fused_cg_pass_a_df64": n_sh * its,
            "fused_cg_pass_b_df64": n_sh * its}
    out["streaming_256"] = row(
        res, t, seen, ref, true_rel, expected_launches=want,
        host_syncs=syncs, host_syncs_per_check_block=per_block,
        x_rel_diff_single=float((res.x64 - ref.x64).abs().max()
                                / ref.x64.abs().max()),
        wall_seconds=time.perf_counter() - t_case)
    checks.extend([
        (converged(res, ref), "streaming: both solves must converge"),
        (within(its, int(ref.iterations)),
         f"streaming: {its} vs one device's {int(ref.iterations)}"),
        (true_rel <= 2 * RTOL_F64, f"streaming: true residual {true_rel}"),
        (seen == want, f"streaming: launches {seen}, expected {want}"),
        (per_block == 1, f"streaming: host syncs {syncs}, expected one a "
                         f"check block")])

    # 256^3 on the general lane: plain CG (the f64 B2 on each slab) and
    # MG-PCG (the f32 V-cycle on the slabs' f32 siblings)
    t_case = time.perf_counter()
    general = tpar.solve_distributed_df64
    general(op, b, mesh=mesh, tol=0.0, maxiter=4)                # warm-up
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: general(op, b, mesh=mesh, **skw)))
    ref = plain_reference(lambda: pt.cg_df64(op, b, **skw))
    its = int(res.iterations)
    true_rel = f64_true_residual(op64, b, res.x64)
    want = {"stencil3d_apply": n_sh * its}
    out["cg_256"] = row(res, t, seen, ref, true_rel, expected_launches=want,
                        wall_seconds=time.perf_counter() - t_case)
    checks.extend([
        (converged(res, ref), "cg 256^3: both solves must converge"),
        (within(its, int(ref.iterations)),
         f"cg 256^3: {its} vs one device's {int(ref.iterations)}"),
        (true_rel <= 2 * RTOL_F64, f"cg 256^3: true residual {true_rel}"),
        (seen == want, f"cg 256^3: launches {seen}, expected {want}")])
    plain_its = its
    t_case = time.perf_counter()
    general(op, b, mesh=mesh, preconditioner="mg", tol=0.0, maxiter=2)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: general(op, b, mesh=mesh, preconditioner="mg", **skw)))
    ref = pt.cg_df64(op, b, preconditioner="mg", **skw)
    its = int(res.iterations)
    true_rel = f64_true_residual(op64, b, res.x64)
    want = {"stencil3d_apply": n_sh * (3 * its + 2)}
    out["mg_256"] = row(res, t, seen, ref, true_rel, expected_launches=want,
                        plain_iterations=plain_its,
                        wall_seconds=time.perf_counter() - t_case)
    checks.extend([
        (converged(res, ref), "mg 256^3: both solves must converge"),
        (3 * its <= plain_its, f"mg 256^3: {its} iterations against plain "
                               f"{plain_its}"),
        (true_rel <= 2 * RTOL_F64, f"mg 256^3: true residual {true_rel}"),
        (seen == want, f"mg 256^3: launches {seen}, expected {want}")])
    del b, op64

    # config #2 in float64: the variants, MINRES and the preconditioners
    op2 = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    op2_64 = poisson.poisson_2d_operator(*GRID_RES_2D, dtype=f64)
    b2 = op2_64.matvec(torch.randn(op2.n, generator=gen, device="cuda",
                                   dtype=f64))
    general(op2, b2, mesh=mesh, tol=0.0, maxiter=4)              # warm-up
    from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
    from cuda_mpi_parallel_tpu_torch.solver import df64 as sdf

    hk.reset_launches()
    sdf.chebyshev_interval(op2)
    torch.cuda.synchronize()
    interval_launches = sum(hk.LAUNCHES.values())
    hk.reset_launches()
    for label, kw, matvecs in (
            ("cg1", dict(method="cg1"), lambda k: k + 1),
            ("pipecg", dict(method="pipecg"),
             lambda k: k + 2 + 4 * (k // 512)),
            ("minres", dict(method="minres"), lambda k: k),
            ("jacobi", dict(preconditioner="jacobi"), lambda k: k),
            ("chebyshev", dict(preconditioner="chebyshev",
                               precond_degree=CHEB_DEGREE),
             lambda k: CHEB_DEGREE * (k + 1) - 1)):
        t_case = time.perf_counter()
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: general(op2, b2, mesh=mesh, **kw, **skw)))
        ref = pt.cg_df64(op2, b2, **kw, **skw)
        its = int(res.iterations)
        true_rel = f64_true_residual(op2_64, b2, res.x64)
        want = {"stencil2d_apply": n_sh * matvecs(its)
                + (interval_launches if label == "chebyshev" else 0)}
        out[f"{label}_1024"] = row(
            res, t, seen, ref, true_rel, expected_launches=want,
            wall_seconds=time.perf_counter() - t_case)
        checks.extend([
            (converged(res, ref), f"{label} 1024^2: both solves must "
                                  f"converge"),
            (within(its, int(ref.iterations)),
             f"{label} 1024^2: {its} vs one device's {int(ref.iterations)}"),
            (true_rel <= 2 * RTOL_F64,
             f"{label} 1024^2: true residual {true_rel}"),
            (seen == want, f"{label} 1024^2: launches {seen}, expected "
                           f"{want}")])
    out["chebyshev_interval_launches"] = interval_launches
    failed = [msg for ok, msg in checks if not ok]
    emit("dist_df64_256", card=smi, shards=n_sh, rtol=RTOL_F64, **out,
         limits=dict(iterations="max(2, 1 %) of one device's; mg <= plain "
                                "/ 3",
                     true_rel_residual_f64=2 * RTOL_F64,
                     launches="4 B6 + 4 B7 an iteration (streaming); 4 a "
                              "matvec (B2 / B1); mg 4 (3k + 2)",
                     host_syncs="one a check block (streaming)"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"dist_df64_256: {failed}")


RING_SHARDS = 4          # the ring shift-ELL lanes' stacked shards


def ring_slab_rows(hk, rows, parts, parts64, gen, bw):
    """B8 and B9 against their twins on config #2's stacked step-0 ring
    slab (the four shards' own-block slabs as one sliced ELL, what each
    ring step launches), timed beside their bounds (bytes: each slot's
    value and column, the slice offsets, x and y once); and on the empty
    step 2 (no slot: the kernel must still write y = 0)."""
    from cuda_mpi_parallel_tpu_torch.parallel import partition as part

    out = {}
    for name, prt, dtype, item, check in (
            ("shift_ell_matvec", parts, torch.float32, 4, check_array),
            ("shift_ell_matvec_df64", parts64, torch.float64, 8,
             check_equal)):
        ids = range(prt.n_shards)
        st = part.stack_ring_step(prt, 0, ids)
        args = tuple(torch.as_tensor(v, device="cuda")
                     for v in (st.vals, st.cols, st.slice_ptr)) + (st.n,)
        x = torch.randn(st.n, generator=gen, device="cuda", dtype=dtype)
        err = check(f"{name} (ring step slab)", hk.shift_ell_matvec(x, *args),
                    hk.shift_ell_matvec_plain(x, *args))
        empty = part.stack_ring_step(prt, 2, ids)
        eargs = tuple(torch.as_tensor(v, device="cuda")
                      for v in (empty.vals, empty.cols, empty.slice_ptr))
        check_equal(f"{name} (empty ring step)",
                    hk.shift_ell_matvec(x, *eargs, empty.n),
                    torch.zeros_like(x))
        slots = st.vals.size
        n_bytes = slots * (item + 4) + st.slice_ptr.size * 8 + 2 * st.n * item
        out[name] = dict(
            rows=st.n, slots=slots, empty_step_slots=empty.vals.size,
            max_abs_err=err,
            ms=time_ms(lambda: hk.shift_ell_matvec(x, *args)),
            plain_ms=time_ms(lambda: hk.shift_ell_matvec_plain(x, *args),
                             reps=5),
            bytes=n_bytes, bound_ms=n_bytes / bw * 1e3, bound_by="bytes")
        rows[name]["ring_step_slab"] = out[name]
    return out


def dist_shiftell_phase(pt, tpar, csr, csr64, fem, gen, count_main_path,
                        plain_reference, smi, rows, bw):
    """The ring shift-ELL lanes over 4 stacked shards on the card
    (``csr_comm="ring-shiftell"``: each ring step's four slabs one B8
    launch; the CSR lane of ``solve_distributed_df64`` on B9), b = A
    x_true, ``check_every=1``:

    * config #2 (1024^2 CSR) to rtol 1e-6: the count within max(2, 1 %)
      of the single-device B8 solve's, converged; µs an iteration beside
      the ``ring`` and ``allgather`` lanes and the single-device B8 solve;
    * the 1 M-point FEM system with Jacobi (config #3) to rtol 1e-6:
      within max(2, 1 %) of the single-device B8 + Jacobi count; the
      host seconds of the ring partition;
    * config #2 in the f64 lane at rtol 1e-10: cg and cg1 within max(2,
      1 %) of the single-device ``cg_df64`` on B9, the degree-4
      Chebyshev of the single-device ``cg_df64`` on the CSR (the same
      interval: the global CSR's power iteration, as the JAX lane takes
      it; the B9 matrix's own interval is the f64 hi-word iteration's);
      the f64 true residual <= 2e-10;
    * every solve: exactly 4 B8/B9 launches and 3 ``ppermute``s a matvec;
    * one shard: x bit-equal to the single-device B8 solve's.

    Each with µs an iteration on the host clock, the partition included
    (``us_per_iteration``, as ``dist_csr_1024`` reports its lanes) and
    without it (``us_per_iteration_after_setup``: the setup timed alone
    subtracted)."""
    from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
    from cuda_mpi_parallel_tpu_torch.parallel import dist_cg
    from cuda_mpi_parallel_tpu_torch.parallel import partition as part

    t_phase = time.perf_counter()
    n_sh = RING_SHARDS
    mesh = tpar.make_mesh(n_sh, devices=["cuda:0"] * n_sh)
    checks, out = [], {}

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def converged(*results):
        return all(r.status_enum() == pt.CGStatus.CONVERGED for r in results)

    def timed_setup(fn):
        """``(fn(), seconds)``: a lane's host setup timed alone."""
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    def shiftell_setup(a, f64=False):
        """The lane's partition and its stacked step slabs on the card."""
        prt = (part.ring_partition_shiftell_df64(a, n_sh) if f64
               else part.ring_partition_shiftell(a, n_sh))
        dist_cg.ring_step_tensors(prt, mesh)
        return prt

    def lane_row(res, t, setup, ref=None, **extra):
        its = int(res.iterations)
        row = dict(iterations=its, seconds=t, us_per_iteration=t * 1e6 / its,
                   setup_seconds=setup,
                   us_per_iteration_after_setup=(t - setup) * 1e6 / its,
                   status=res.status_enum().name, **extra)
        if ref is not None:
            row.update(single_device_iterations=int(ref.iterations),
                       single_device_status=ref.status_enum().name)
        return row

    def ring_solve(label, fn, matvecs, name, ref, setup, **extra):
        """One counted solve: its launches and ppermutes a matvec."""
        mesh.comm.counts.clear()
        (res, t), seen = count_main_path(lambda: timed_solve(fn))
        k = matvecs(int(res.iterations))
        perms = mesh.comm.counts["ppermute"]
        want = {name: n_sh * k}
        out[label] = lane_row(res, t, setup, ref, launches=seen,
                              expected_launches=want, ppermutes=perms,
                              expected_ppermutes=(n_sh - 1) * k, **extra)
        checks.extend([
            (converged(res, ref), f"{label}: both solves must converge"),
            (within(int(res.iterations), int(ref.iterations)),
             f"{label}: {int(res.iterations)} vs one device's "
             f"{int(ref.iterations)}"),
            (seen == want, f"{label}: launches {seen}, expected {want}"),
            (perms == (n_sh - 1) * k,
             f"{label}: {perms} ppermutes for {k} matvecs")])
        return res

    # config #2 in f32: the lane, the ring and allgather lanes, one device
    x_true = torch.randn(csr.n, generator=gen, device="cuda")
    b = csr.matvec(x_true)
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
    sell = csr.to_shiftell()
    lane = dict(csr_comm="ring-shiftell")
    tpar.solve_distributed(csr, b, mesh=mesh, maxiter=8, **lane)  # warm-up
    (single, t_single), _ = count_main_path(lambda: timed_solve(
        lambda: pt.solve(sell, b, engine="general", **skw)))
    out["single_device_b8"] = lane_row(single, t_single, 0.0)
    parts, setup = timed_setup(lambda: shiftell_setup(csr))
    res = ring_solve("ring_shiftell_1024", lambda: tpar.solve_distributed(
        csr, b, mesh=mesh, **lane, **skw), lambda k: k, "shift_ell_matvec",
        single, setup)
    for label, kw, prep in (
            ("ring", dict(csr_comm="ring"),
             lambda: part.ring_partition_csr(csr, n_sh)),
            ("allgather", dict(exchange="allgather"),
             lambda: part.partition_csr(csr, n_sh))):
        other, t = plain_reference(lambda: timed_solve(
            lambda: tpar.solve_distributed(csr, b, mesh=mesh, **kw, **skw)))
        out[label] = lane_row(other, t, timed_setup(prep)[1])
        checks.append((within(int(other.iterations), int(res.iterations)),
                       f"{label}: {int(other.iterations)} iterations"))
    # one shard: the single-device B8 solve's bits
    one_mesh = tpar.make_mesh(1, devices=["cuda:0"])
    (one, _), seen = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed(csr, b, mesh=one_mesh, **lane,
                                       **skw)))
    one_equal = torch.equal(one.x, single.x)
    out["one_shard"] = dict(iterations=int(one.iterations), launches=seen,
                            bit_equal_single_device=one_equal)
    checks.append((one_equal and int(one.iterations)
                   == int(single.iterations),
                   "one shard: x differs from the single-device B8 solve"))
    del sell

    # the 1 M-point FEM system with Jacobi (config #3)
    t0 = time.perf_counter()
    fem_parts = part.ring_partition_shiftell(fem, n_sh)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist_cg.ring_step_tensors(fem_parts, mesh)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    fem_sell = fem.to_shiftell()
    jac = pt.JacobiPreconditioner.from_operator(fem)
    xf = torch.randn(fem.n, generator=gen, device="cuda")
    bf = fem.matvec(xf)
    fkw = dict(tol=0.0, rtol=1e-6, maxiter=5000, check_every=1)
    (fem_single, t_fs), _ = count_main_path(lambda: timed_solve(
        lambda: pt.solve(fem_sell, bf, m=jac, engine="general", **fkw)))
    ring_solve("fem_jacobi", lambda: tpar.solve_distributed(
        fem, bf, mesh=mesh, preconditioner="jacobi", **lane, **fkw),
        lambda k: k, "shift_ell_matvec", fem_single,
        partition_s + stack_s, rows=fem.n, nnz=fem.nnz,
        ring_partition_host_seconds=partition_s,
        ring_stack_seconds=stack_s,
        step_slots=[int(sum(v.size for v in fem_parts.vals[t]))
                    for t in range(n_sh)],
        single_device_us_per_iteration=t_fs * 1e6
        / int(fem_single.iterations))
    del fem_sell, jac

    # config #2 in the f64 lane on B9
    x64 = torch.randn(csr64.n, generator=gen, device="cuda",
                      dtype=torch.float64)
    b64 = csr64.matvec(x64)
    kw64 = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64, check_every=1)
    sell64 = csr64.to_shiftell_df64()
    general = tpar.solve_distributed_df64
    general(csr64, b64, mesh=mesh, tol=0.0, maxiter=4)          # warm-up
    parts64, setup64 = timed_setup(lambda: shiftell_setup(csr64, f64=True))
    for label, kw, matvecs in (
            ("cg_df64_1024", dict(), lambda k: k),
            ("cg1_df64_1024", dict(method="cg1"), lambda k: k + 1),
            ("chebyshev_df64_1024", dict(preconditioner="chebyshev",
                                         precond_degree=CHEB_DEGREE),
             lambda k: CHEB_DEGREE * (k + 1) - 1)):
        if label.startswith("chebyshev"):
            ref = plain_reference(lambda: pt.cg_df64(csr64, b64, **kw,
                                                     **kw64))
        else:
            ref = pt.cg_df64(sell64, b64, **kw, **kw64)
        res = ring_solve(label, lambda: general(csr64, b64, mesh=mesh, **kw,
                                                **kw64),
                         matvecs, "shift_ell_matvec_df64", ref, setup64)
        true_rel = f64_true_residual(csr64, b64, res.x64)
        out[label]["true_rel_residual_f64"] = true_rel
        checks.append((true_rel <= 2 * RTOL_F64,
                       f"{label}: true residual {true_rel}"))
    del sell64
    out["kernels_on_ring_slabs"] = ring_slab_rows(hk, rows, parts, parts64,
                                                  gen, bw)
    failed = [msg for ok, msg in checks if not ok]
    emit("dist_shiftell_1024", card=smi, shards=n_sh, **out,
         limits=dict(iterations="max(2, 1 %) of one device's",
                     true_rel_residual_f64=2 * RTOL_F64,
                     launches="4 B8/B9 and 3 ppermutes a matvec",
                     one_shard="x bit-equal to the single-device B8 solve"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"dist_shiftell_1024: {failed}")


PENCIL_SHAPE = (4, 2)    # the pencil mesh of the pencil_256 phase
PENCIL_GRID_F64 = (128, 128, 128)   # the f64 variants' grid on pencils


def pencil_256_phase(pt, tpar, poisson, gen, count_main_path,
                     plain_reference, smi):
    """The pencil decomposition on the one card: ``solve_distributed`` at
    256^3 f32 (``backend="xla"``: the pencil path has no hand matvec, as
    the JAX one has no Pallas call) on ``make_mesh_2d((4, 2),
    devices=["cuda:0"] * 8)``, 64 x 128 x 256 pencils, rtol 1e-6 at
    check_every=1, b = A x_true:

    * plain CG within max(2, 1 %) of one device's general count, exactly
      four ``ppermute``s a matvec, and beside it the 8-slab lane's
      µs an iteration and the card's idle share over the solve;
    * on (4, 1) pencils (two ``ppermute``s a matvec) the 4-slab xla
      lane's count;
    * a degree-4 Chebyshev within max(2, 1 %) of one device's count, MG
      within 1 of one device's MG-PCG;
    * the f64 lane on the same mesh, rtol 1e-10, true residual <= 2e-10,
      each count within max(2, 1 %) of one device's ``cg_df64``: cg and
      mg at 256^3, cg1, pipecg, Jacobi and a degree-4 Chebyshev at 128^3;
    * over a ``torch.distributed`` NCCL group of one rank, joined through
      ``parallel.multihost.initialize``: a (1, 1) pencil mesh bit-equal
      to the stacked (1, 1) solve, and ``global_mesh`` ->
      ``shard_vector_global`` -> ``solve_distributed`` bit-equal to the
      stacked ``make_mesh(1)`` solve.

    Every pencil solve launches no hand kernel."""
    import torch.distributed as dist
    from cuda_mpi_parallel_tpu_torch.models.multigrid import (
        MultigridPreconditioner,
    )
    from cuda_mpi_parallel_tpu_torch.models.precond import (
        ChebyshevPreconditioner,
    )
    from cuda_mpi_parallel_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    sx, sy = PENCIL_SHAPE
    dev = ["cuda:0"] * (sx * sy)
    mesh = tpar.make_mesh_2d(PENCIL_SHAPE, devices=dev)
    skw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
    checks, out = [], {}

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def converged(*results):
        return all(r.status_enum() == pt.CGStatus.CONVERGED for r in results)

    def pencil_solve(fn, m):
        m.comm.counts.clear()
        (res, t), seen = count_main_path(lambda: timed_solve(fn))
        checks.append((not seen, f"a pencil solve launched {seen}"))
        its = int(res.iterations)
        return res, t, dict(iterations=its, seconds=t,
                            us_per_iteration=t * 1e6 / its,
                            status=res.status_enum().name,
                            comm_counts=dict(m.comm.counts))

    op = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op.matvec(x_true)
    solve = tpar.solve_distributed

    # f32 plain CG on (4, 2) pencils, one device and the 8-slab lane
    solve(op, b, mesh=mesh, tol=0.0, maxiter=4)                  # warm-up
    res, t, row = pencil_solve(lambda: solve(op, b, mesh=mesh, **skw), mesh)
    ref = plain_reference(lambda: pt.solve(op, b, engine="general", **skw))
    slab8 = tpar.make_mesh(sx * sy, devices=dev)
    slab, t_slab = timed_solve(lambda: solve(op, b, mesh=slab8, **skw))
    idle = idle_share(lambda: solve(op, b, mesh=mesh, **skw))
    its, ref_its = int(res.iterations), int(ref.iterations)
    per_matvec = row["comm_counts"].get("ppermute", 0) / its
    out["cg_4x2"] = dict(
        row, one_device_iterations=ref_its,
        x_rel_diff_one_device=float((res.x - ref.x).abs().max()
                                    / ref.x.abs().max()),
        ppermutes_per_matvec=per_matvec,
        slab_8_iterations=int(slab.iterations),
        slab_8_us_per_iteration=t_slab * 1e6 / int(slab.iterations),
        idle=idle)
    checks.extend([
        (converged(res, ref, slab), "cg 4x2: the solves must converge"),
        (within(its, ref_its), f"cg 4x2: {its} vs one device's {ref_its}"),
        (per_matvec == 4, f"cg 4x2: {per_matvec} ppermutes a matvec")])

    # (4, 1) pencils against the 4-slab xla lane
    m41 = tpar.make_mesh_2d((sx, 1), devices=dev[:sx])
    res, t, row = pencil_solve(lambda: solve(op, b, mesh=m41, **skw), m41)
    slab4, t_slab = timed_solve(lambda: solve(
        op, b, mesh=tpar.make_mesh(sx, devices=dev[:sx]), **skw))
    per_matvec = row["comm_counts"].get("ppermute", 0) / int(res.iterations)
    out["cg_4x1"] = dict(
        row, ppermutes_per_matvec=per_matvec,
        slab_4_iterations=int(slab4.iterations),
        slab_4_us_per_iteration=t_slab * 1e6 / int(slab4.iterations),
        x_bit_equal_slab_4=torch.equal(res.x, slab4.x))
    checks.extend([
        (int(res.iterations) == int(slab4.iterations),
         f"cg 4x1: {int(res.iterations)} vs the 4-slab lane's "
         f"{int(slab4.iterations)}"),
        (per_matvec == 2, f"cg 4x1: {per_matvec} ppermutes a matvec")])

    # a degree-4 Chebyshev and MG on (4, 2)
    for label, kw, m_ref, limit in (
            ("chebyshev_4x2", dict(preconditioner="chebyshev",
                                   precond_degree=CHEB_DEGREE),
             lambda: ChebyshevPreconditioner.from_operator(
                 op, degree=CHEB_DEGREE), within),
            ("mg_4x2", dict(preconditioner="mg"),
             lambda: MultigridPreconditioner.from_operator(op),
             lambda n, r: abs(n - r) <= 1)):
        solve(op, b, mesh=mesh, tol=0.0, maxiter=2, **kw)          # warm-up
        res, t, row = pencil_solve(
            lambda: solve(op, b, mesh=mesh, **kw, **skw), mesh)
        m = m_ref()
        ref = plain_reference(lambda: pt.solve(op, b, m=m, engine="general",
                                               **skw))
        its, ref_its = int(res.iterations), int(ref.iterations)
        out[label] = dict(row, one_device_iterations=ref_its)
        checks.extend([
            (converged(res, ref), f"{label}: both solves must converge"),
            (limit(its, ref_its), f"{label}: {its} vs one device's "
                                  f"{ref_its}")])
    del b, x_true

    # the f64 lane on (4, 2): cg and mg at 256^3, the variants at 128^3
    f64 = torch.float64
    fkw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64, check_every=1)
    general = tpar.solve_distributed_df64
    for grid, cases in (
            (GRID_3D, (("cg", {}), ("mg", dict(preconditioner="mg")))),
            (PENCIL_GRID_F64, (
                ("cg1", dict(method="cg1")),
                ("pipecg", dict(method="pipecg")),
                ("jacobi", dict(preconditioner="jacobi")),
                ("chebyshev", dict(preconditioner="chebyshev",
                                   precond_degree=CHEB_DEGREE))))):
        op = poisson.poisson_3d_operator(*grid, backend="xla")
        op64 = poisson.poisson_3d_operator(*grid, dtype=f64)
        b = op64.matvec(torch.randn(op.n, generator=gen, device="cuda",
                                    dtype=f64))
        general(op, b, mesh=mesh, tol=0.0, maxiter=4)             # warm-up
        for label, kw in cases:
            res, t, row = pencil_solve(
                lambda: general(op, b, mesh=mesh, **kw, **fkw), mesh)
            ref = plain_reference(lambda: pt.cg_df64(op, b, **kw, **fkw))
            its, ref_its = int(res.iterations), int(ref.iterations)
            true_rel = f64_true_residual(op64, b, res.x64)
            name = f"f64_{label}_{grid[0]}"
            out[name] = dict(row, one_device_iterations=ref_its,
                             true_rel_residual_f64=true_rel)
            checks.extend([
                (converged(res, ref), f"{name}: both solves must converge"),
                (within(its, ref_its),
                 f"{name}: {its} vs one device's {ref_its}"),
                (true_rel <= 2 * RTOL_F64,
                 f"{name}: true residual {true_rel}")])
        del b, op64

    # one NCCL rank through multihost: a (1, 1) pencil mesh and the
    # global mesh, each bit-equal to its stacked twin
    op = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    b = op.matvec(torch.randn(op.n, generator=gen, device="cuda"))
    stacked_11 = solve(op, b, mesh=tpar.make_mesh_2d((1, 1), devices=dev[:1]),
                       **skw)
    stacked_1 = solve(op, b, mesh=tpar.make_mesh(1, devices=dev[:1]), **skw)
    multihost.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        info = multihost.process_info()
        (nccl_11, _), seen_11 = count_main_path(lambda: timed_solve(
            lambda: solve(op, b, mesh=tpar.make_mesh_2d((1, 1)), **skw)))
        gmesh = multihost.global_mesh()
        b_local = multihost.shard_vector_global(b, op.n, gmesh)
        nccl_1 = solve(op, gmesh.comm.global_vector(b_local), mesh=gmesh,
                       **skw)
        torch.cuda.synchronize()
        kinds = (gmesh.comm.kind, dist.get_backend())
    finally:
        dist.destroy_process_group()
    out["nccl_world_1"] = dict(
        process_info=list(info), comm=list(kinds),
        pencil_1x1_iterations=int(nccl_11.iterations),
        pencil_1x1_bit_equal=torch.equal(nccl_11.x, stacked_11.x),
        global_mesh_iterations=int(nccl_1.iterations),
        global_mesh_bit_equal=torch.equal(nccl_1.x, stacked_1.x))
    checks.extend([
        (not seen_11, f"nccl 1x1 launched {seen_11}"),
        (kinds == ("distributed", "nccl"), f"nccl: comm {kinds}"),
        (out["nccl_world_1"]["pencil_1x1_bit_equal"]
         and int(nccl_11.iterations) == int(stacked_11.iterations),
         "nccl: the (1, 1) pencil solve is not the stacked one's bits"),
        (out["nccl_world_1"]["global_mesh_bit_equal"]
         and int(nccl_1.iterations) == int(stacked_1.iterations),
         "nccl: the global-mesh solve is not make_mesh(1)'s bits")])
    failed = [msg for ok, msg in checks if not ok]
    emit("pencil_256", card=smi, mesh=list(PENCIL_SHAPE),
         pencil=[GRID_3D[0] // sx, GRID_3D[1] // sy, GRID_3D[2]], **out,
         limits=dict(iterations="max(2, 1 %) of one device's; mg 1; "
                                "(4, 1) the 4-slab lane's",
                     ppermutes_per_matvec="4 on (4, 2), 2 on (4, 1)",
                     true_rel_residual_f64=2 * RTOL_F64,
                     launches="none (the pencil matvec is plain torch)",
                     nccl="bit-equal to the stacked solves"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"pencil_256: {failed}")


def resumable_phase(pt, tpar, poisson, csr, gen, count_main_path, smi):
    """Checkpoint, resume and elastic migration (``utils.checkpoint``,
    ``robust.elastic``): every solve checkpoints to npz files in a
    ``tempfile.TemporaryDirectory``, b = A x_true.

    * f32 3D Poisson 256^3 on B2 (``backend="pallas"``), rtol 1e-6,
      check_every=1: ``solve_resumable`` "preempted" at ``maxiter`` =
      half the count (its file kept, unconverged), then a fresh call
      resumes from disk to convergence: the count of an uninterrupted
      ``solve(engine="general")``, x bit-equal to it, one B2 launch an
      iteration over the two calls.  Reported: us an iteration, the host
      ms of each ``save_checkpoint`` (three 67 MB vectors, the card's
      copy to the host included), of the load and of one
      ``problem_fingerprint`` (each call hashes b on the host), and the
      saves' share of the resumable run's wall time.  The same on config
      #2's 1024^2 through B1.
    * f64 2D Poisson 1024^2, rtol 1e-10: ``solve_resumable_df64(engine=
      "resident")`` in about four segments replays on B11, x_hi/x_lo
      bit-equal to one ``cg_resident_df64``, one B11 launch a segment;
      ``engine="general"`` (``cg_df64``, whose single-device stencil
      product is plain float64 torch, as the JAX df64 stencil is XLA
      code: no hand kernel) preempted after one segment and resumed
      from disk, bit-equal to the unsplit ``cg_df64`` (the float64 state
      crosses the file); the host ms of each ``save_checkpoint_df64``.
    * Elastic: config #2's CSR (1,048,576 rows) over stacked shards on
      the allgather lane, rtol 1e-6, check_every=1: preempted by
      ``Preemption(1)`` on 4 shards and resumed with ``elastic=True`` on
      2: the count within max(2, 1 %) of the uninterrupted 4-shard
      resumable run, x within 1e-5 * max|x| of it, exactly one
      ``solve_migration`` event with ``seam_rel_err`` <= 1e-5; a
      same-layout resume on 4 shards bit-equal to the uninterrupted
      resumable run; no hand kernel (the CSR lane is torch segment
      sums)."""
    import tempfile

    from cuda_mpi_parallel_tpu_torch.robust import (
        PreemptedError,
        Preemption,
    )
    from cuda_mpi_parallel_tpu_torch.telemetry import events
    from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    checks, out = [], {}
    io_ms = {"save": [], "load": []}
    io = ("save_checkpoint", "load_checkpoint", "save_checkpoint_df64")
    original = {name: getattr(ck, name) for name in io}

    def timed_io(kind, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            io_ms[kind].append((time.perf_counter() - t0) * 1e3)
            return res
        return run

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def f32_case(label, op, kernel, d):
        """solve_resumable preempted at half the count and resumed from
        disk, beside the uninterrupted general solve."""
        t_case = time.perf_counter()
        x_true = torch.randn(op.n, generator=gen, device="cuda")
        b = op.matvec(x_true)
        skw = dict(tol=0.0, rtol=1e-6)
        pt.solve(op, b, engine="general", maxiter=4, **skw)    # warm-up
        (full, t_full), _ = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, engine="general", maxiter=4000,
                             **skw)))
        n = int(full.iterations)
        seg = max(1, n // 4)
        path = os.path.join(d, f"{label}.npz")
        io_ms["save"].clear()
        io_ms["load"].clear()
        (first, t1), seen1 = count_main_path(lambda: timed_solve(
            lambda: ck.solve_resumable(op, b, path, segment_iters=seg,
                                       maxiter=n // 2, **skw)))
        kept = os.path.exists(path)
        (rest, t2), seen2 = count_main_path(lambda: timed_solve(
            lambda: ck.solve_resumable(op, b, path, segment_iters=seg,
                                       maxiter=4000, **skw)))
        saves, loads = list(io_ms["save"]), list(io_ms["load"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.problem_fingerprint(op, b)
        fingerprint_ms = (time.perf_counter() - t0) * 1e3
        launches = seen1.get(kernel, 0) + seen2.get(kernel, 0)
        wall = t1 + t2
        row = dict(shape=list(op.grid), iterations=n, segment_iters=seg,
                   preempted_iterations=int(first.iterations),
                   preempted_converged=bool(first.converged),
                   file_kept=kept, resumed_iterations=int(rest.iterations),
                   resumed_status=rest.status_enum().name,
                   x_bit_equal=same_bits((rest.x,), (full.x,)),
                   launches={kernel: launches},
                   us_per_iteration_uninterrupted=t_full * 1e6 / n,
                   us_per_iteration_resumable=wall * 1e6 / n,
                   save_ms=saves, load_ms=loads,
                   fingerprint_ms=fingerprint_ms,
                   vector_mbytes=op.n * 4 / 1e6,
                   saves_share_of_wall=sum(saves) / (wall * 1e3),
                   resumable_seconds=wall, uninterrupted_seconds=t_full,
                   wall_seconds=time.perf_counter() - t_case)
        checks.extend([
            (kept and not bool(first.converged)
             and int(first.iterations) == n // 2,
             f"{label}: the preempted run stopped at "
             f"{int(first.iterations)} (file kept {kept})"),
            (rest.status_enum() == pt.CGStatus.CONVERGED
             and int(rest.iterations) == n,
             f"{label}: resumed to {int(rest.iterations)}, unsplit {n}"),
            (row["x_bit_equal"], f"{label}: x is not the unsplit bits"),
            (launches == n and set(seen1) | set(seen2) == {kernel},
             f"{label}: launches {seen1} + {seen2} for {n} iterations"),
            (not os.path.exists(path), f"{label}: the file outlived the "
                                       f"converged run"),
            (len(loads) == 1 and len(saves) == -(-(n // 2) // seg)
             + -(-(n - n // 2) // seg),
             f"{label}: {len(saves)} saves / {len(loads)} loads")])
        return row

    for name in io:
        setattr(ck, name, timed_io(name.split("_")[0], original[name]))
    try:
        with tempfile.TemporaryDirectory() as d:
            out["f32_256"] = f32_case(
                "f32_256", poisson.poisson_3d_operator(*GRID_3D,
                                                       backend="pallas"),
                "stencil3d_apply", d)
            out["f32_1024"] = f32_case(
                "f32_1024", poisson.poisson_2d_operator(*GRID_RES_2D,
                                                        backend="pallas"),
                "stencil2d_apply", d)

            # the f64 lane at 1024^2
            t_case = time.perf_counter()
            op = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
            op64 = poisson.poisson_2d_operator(*GRID_RES_2D,
                                               dtype=torch.float64)
            x_true = torch.randn(op.n, generator=gen, device="cuda",
                                 dtype=torch.float64)
            b64 = op64.matvec(x_true)
            skw = dict(tol=0.0, rtol=RTOL_F64, maxiter=MAXITER_F64)
            (one, t_one), seen_one = count_main_path(lambda: timed_solve(
                lambda: pt.cg_resident_df64(op, b64, **skw)))
            n = int(one.iterations)
            seg = -(-n // 4)
            path = os.path.join(d, "replay.npz")
            (rep, t_rep), seen_rep = count_main_path(lambda: timed_solve(
                lambda: ck.solve_resumable_df64(
                    op, b64, path, segment_iters=seg, engine="resident",
                    **skw)))
            n_seg = -(-n // seg)
            out["resident_df64_1024"] = dict(
                iterations=n, segment_iters=seg, segments=n_seg,
                resumed_iterations=int(rep.iterations),
                status=rep.status_enum().name, launches=seen_rep,
                one_launch=seen_one, x_bit_equal=same_bits(
                    (rep.x_hi, rep.x_lo), (one.x_hi, one.x_lo)),
                one_solve_seconds=t_one, replay_seconds=t_rep,
                replay_over_one=t_rep / t_one,
                true_rel_residual_f64=f64_true_residual(op64, b64,
                                                        rep.x64),
                wall_seconds=time.perf_counter() - t_case)
            checks.extend([
                (one.status_enum() == rep.status_enum()
                 == pt.CGStatus.CONVERGED and int(rep.iterations) == n,
                 f"replay: {int(rep.iterations)} vs one launch's {n}"),
                (out["resident_df64_1024"]["x_bit_equal"],
                 "replay: x_hi/x_lo are not one launch's bits"),
                (seen_one == {"cg_resident_df64": 1}
                 and seen_rep == {"cg_resident_df64": n_seg},
                 f"replay: launches {seen_rep} for {n_seg} segments"),
                (not os.path.exists(path), "replay: the file outlived "
                                           "the converged run")])

            t_case = time.perf_counter()
            (gen_full, t_gf), seen_gf = count_main_path(lambda: timed_solve(
                lambda: pt.cg_df64(op, b64, **skw)))
            n = int(gen_full.iterations)
            seg = -(-n // 4)
            path = os.path.join(d, "general64.npz")
            io_ms["save"].clear()
            (g1, t_g1), seen_g1 = count_main_path(lambda: timed_solve(
                lambda: ck.solve_resumable_df64(
                    op, b64, path, segment_iters=seg, tol=0.0,
                    rtol=RTOL_F64, maxiter=seg, keep_checkpoint=True)))
            kept = os.path.exists(path)
            (g2, t_g2), seen_g2 = count_main_path(lambda: timed_solve(
                lambda: ck.solve_resumable_df64(
                    op, b64, path, segment_iters=seg, **skw)))
            out["general_df64_1024"] = dict(
                iterations=n, segment_iters=seg,
                preempted_iterations=int(g1.iterations), file_kept=kept,
                resumed_iterations=int(g2.iterations),
                status=g2.status_enum().name,
                x_bit_equal=same_bits((g2.x64,), (gen_full.x64,)),
                launches={k: seen_gf.get(k, 0) + seen_g1.get(k, 0)
                          + seen_g2.get(k, 0)
                          for k in set(seen_gf) | set(seen_g1)
                          | set(seen_g2)},
                us_per_iteration_uninterrupted=t_gf * 1e6 / n,
                us_per_iteration_resumable=(t_g1 + t_g2) * 1e6 / n,
                save_ms=list(io_ms["save"]),
                wall_seconds=time.perf_counter() - t_case)
            checks.extend([
                (kept and int(g1.iterations) == seg
                 and not bool(g1.converged),
                 f"general f64: the preempted run stopped at "
                 f"{int(g1.iterations)}"),
                (g2.status_enum() == pt.CGStatus.CONVERGED
                 and int(g2.iterations) == n,
                 f"general f64: resumed to {int(g2.iterations)}, "
                 f"unsplit {n}"),
                (out["general_df64_1024"]["x_bit_equal"],
                 "general f64: x is not the unsplit bits"),
                (not out["general_df64_1024"]["launches"],
                 f"general f64: launched "
                 f"{out['general_df64_1024']['launches']}")])

            # elastic: config #2's CSR, 4 stacked shards -> 2
            t_case = time.perf_counter()
            x_true = torch.randn(csr.n, generator=gen, device="cuda")
            b = csr.matvec(x_true)
            m4 = tpar.make_mesh(4, devices=["cuda:0"] * 4)
            m2 = tpar.make_mesh(2, devices=["cuda:0"] * 2)
            ekw = dict(tol=0.0, rtol=1e-6, maxiter=4000, check_every=1)
            (full, t_full), seen_full = count_main_path(lambda: timed_solve(
                lambda: ck.solve_resumable_distributed(
                    csr, b, os.path.join(d, "full.npz"), mesh=m4,
                    segment_iters=4000, **ekw)))
            n = int(full.iterations)
            seg = -(-n // 4)
            path = os.path.join(d, "elastic.npz")
            t0 = time.perf_counter()
            try:
                ck.solve_resumable_distributed(
                    csr, b, path, mesh=m4, segment_iters=seg,
                    preempt=Preemption(1), **ekw)
                preempted = False
            except PreemptedError:
                preempted = True
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            with events.capture() as buf:
                (mig, t_mig), seen_mig = count_main_path(
                    lambda: timed_solve(
                        lambda: ck.solve_resumable_distributed(
                            csr, b, path, mesh=m2, segment_iters=seg,
                            elastic=True, **ekw)))
            recs = [json.loads(line) for line in buf.getvalue().splitlines()
                    if line.strip()]
            moves = [r for r in recs if r["event"] == "solve_migration"]
            same_path = os.path.join(d, "same.npz")
            try:
                ck.solve_resumable_distributed(
                    csr, b, same_path, mesh=m4, segment_iters=seg,
                    preempt=Preemption(1), **ekw)
            except PreemptedError:
                pass
            (same, t_same), seen_same = count_main_path(
                lambda: timed_solve(lambda: ck.solve_resumable_distributed(
                    csr, b, same_path, mesh=m4, segment_iters=seg,
                    **ekw)))
            x_err = float((mig.x - full.x).abs().max()
                          / full.x.abs().max())
            out["elastic_1024"] = dict(
                rows=csr.n, shards_from=4, shards_to=2, iterations=n,
                segment_iters=seg, preempted=preempted,
                migrated_iterations=int(mig.iterations),
                migrated_status=mig.status_enum().name,
                x_rel_err=x_err, migrations=moves,
                same_layout_iterations=int(same.iterations),
                same_layout_bit_equal=same_bits((same.x,), (full.x,)),
                launches={k: v for s_ in (seen_full, seen_mig, seen_same)
                          for k, v in s_.items()},
                us_per_iteration_uninterrupted=t_full * 1e6 / n,
                preempted_seconds=t_pre, migrated_seconds=t_mig,
                same_layout_seconds=t_same,
                wall_seconds=time.perf_counter() - t_case)
            checks.extend([
                (preempted, "elastic: Preemption(1) did not preempt"),
                (mig.status_enum() == pt.CGStatus.CONVERGED
                 and within(int(mig.iterations), n),
                 f"elastic: migrated run {int(mig.iterations)} vs {n}"),
                (x_err <= 1e-5, f"elastic: x rel err {x_err}"),
                (len(moves) == 1 and moves[0]["seam_rel_err"] <= 1e-5
                 and (moves[0]["n_shards_from"], moves[0]["n_shards_to"])
                 == (4, 2), f"elastic: migration events {moves}"),
                (int(same.iterations) == n
                 and out["elastic_1024"]["same_layout_bit_equal"],
                 "elastic: the same-layout resume is not the "
                 "uninterrupted bits"),
                (not out["elastic_1024"]["launches"],
                 f"elastic: launched {out['elastic_1024']['launches']}")])
    finally:
        for name in io:
            setattr(ck, name, original[name])
    failed = [msg for ok, msg in checks if not ok]
    emit("resumable", card=smi, **out,
         limits=dict(f32="the uninterrupted count, x bit-equal, one "
                         "B1/B2 launch an iteration",
                     resident_df64="one launch's count and bits, one B11 "
                                   "launch a segment",
                     general_df64="the unsplit count and bits, no hand "
                                  "kernel",
                     elastic="count within max(2, 1 %), x within 1e-5 "
                             "* max|x|, one migration with seam <= 1e-5, "
                             "the same layout bit-equal"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"resumable: {failed}")


def many_rhs_phase(pt, tpar, poisson, csr, gen, count_main_path,
                   plain_reference, smi):
    """The many-RHS tier and Krylov recycling (``solver.many``,
    ``solver.recycle``, ``parallel.solve_distributed_many``), b = A X_true
    column by column, rtol 1e-6.

    * Matrix-free f32 at config #2, 1024^2, ``Stencil2D(backend=
      "pallas")``, k = 8: ``solve_many(method="batched")`` at
      ``check_every=1`` - lanes 0 and 7, and a k = 1 stack, bit-equal (x,
      count, status) to the port's single ``solve(engine="general")`` of
      the column; each lane's float64 true residual within 1e-5 of
      ||b||; exactly one ``stencil2d_apply_cols`` launch a ``matmat``
      (the loop's steps: x0 = 0 takes no init sweep) and no single-grid
      launch, for ``method="block"`` too.  The us an iteration of each
      (``check_every=32``) beside 8 sequential single solves.  The same
      at 256^3 on ``Stencil3D`` with k = 4 (lanes 0 and 3).  Block CG's
      largest count is reported beside the batched one there, and held
      below it at 128^2 x 8: its gain shrinks as the grid grows, in the
      JAX package as in the port (on the CPU both take 157 against 232
      at 128^2; at 512^2 the JAX package 327 against 333, the port 327
      against 334: ``tests/torch_many_scale.py block``), and at config
      #2 it is gone.
    * Config #2 as assembled CSR, k = 8, Jacobi: each lane within max(2,
      1 %) of its single solve, lanes 0 and 7 (and whether it is its
      bits);
      ``solve_distributed_many`` over 4 stacked shards on the allgather
      and gather lanes: the lanes' counts within max(2, 1 %) of the
      single-device batch, and per iteration the single-RHS solve's
      collectives (``mesh.comm.counts``, two tol-0 runs 8 iterations
      apart) with each exchange carrying all 8 columns.
    * Recycling on config #2's CSR: ``recycled_sequence(repeats=3)`` on
      one device, repeat traffic (the same b each solve, the function's
      default): the count falls from solve to solve; each harvest's host
      seconds and the ring's bytes.  One deflated ``solve_distributed``
      of that b over 4 stacked shards (the first solve's harvest) with
      the undeflated solve's collectives per iteration and fewer
      iterations; the same for a fresh b is reported (a space harvested
      from one b does not shorten a fresh random b's solve: on the CPU
      the JAX package takes 288, 329, 328 for three fresh b at 512^2
      and the port 289, 329, 329, their kept Ritz values within 1.4 %
      of each other - ``tests/torch_many_scale.py recycle``)."""
    from cuda_mpi_parallel_tpu_torch.solver import recycle as rec
    from cuda_mpi_parallel_tpu_torch.solver import solve_many

    t_phase = time.perf_counter()
    checks, out = [], {}

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def blocked_steps(res, check_every=32):
        """Loop steps of a many-RHS solve at ``check_every``: whole blocks
        up to the longest lane's count."""
        return -(-int(res.iterations.max()) // check_every) * check_every

    for label, grid, k, cols_kernel, single_kernel, lanes in (
            ("matrix_free_1024", GRID_RES_2D, MANY_K_2D,
             "stencil2d_apply_cols", "stencil2d_apply", (0, MANY_K_2D - 1)),
            ("matrix_free_256", GRID_3D, MANY_K_3D,
             "stencil3d_apply_cols", "stencil3d_apply", (0, MANY_K_3D - 1))):
        op = (poisson.poisson_2d_operator if len(grid) == 2
              else poisson.poisson_3d_operator)(*grid, backend="pallas")
        x_true = torch.randn((k, op.n), generator=gen, device="cuda").t()
        b = op.matmat(x_true)
        kw = dict(tol=0.0, rtol=1e-6, maxiter=4000)
        (many, t_many), seen = count_main_path(lambda: timed_solve(
            lambda: solve_many(op, b, **kw)))
        steps = int(many.iterations.max())
        lane_rows = {}
        for j in lanes:
            single = pt.solve(op, b[:, j], engine="general", **kw)
            lane_rows[j] = dict(
                iterations=int(single.iterations),
                x_bit_equal=torch.equal(single.x, many.x[:, j]),
                count_equal=int(single.iterations) == int(many.iterations[j]),
                status_equal=int(single.status) == int(many.status[j]))
        one = solve_many(op, b[:, :1], **kw)
        single0 = pt.solve(op, b[:, 0], engine="general", **kw)
        k1_equal = (torch.equal(one.x[:, 0], single0.x)
                    and int(one.iterations[0]) == int(single0.iterations)
                    and int(one.status[0]) == int(single0.status))
        (block, t_block), seen_block = count_main_path(lambda: timed_solve(
            lambda: solve_many(op, b, method="block", **kw)))
        block_steps = int(block.iterations.max())
        op64 = (poisson.poisson_2d_operator if len(grid) == 2
                else poisson.poisson_3d_operator)(*grid, dtype=torch.float64)
        true_rel = [float((b[:, j].double() - op64.matvec(
            many.x[:, j].double())).norm() / b[:, j].double().norm())
            for j in range(k)]
        # throughput: one host read a 32-iteration block
        fast = dict(kw, check_every=32)
        res_b, t_b = timed_solve(lambda: solve_many(op, b, **fast))
        res_k, t_k = timed_solve(lambda: solve_many(
            op, b, method="block", **fast))
        t0 = time.perf_counter()
        seq_its = [int(pt.solve(op, b[:, j], engine="general",
                                **fast).iterations) for j in range(k)]
        torch.cuda.synchronize()
        t_seq = time.perf_counter() - t0
        out[label] = dict(
            grid=list(grid), k=k, stack_bytes=k * op.n * 4,
            iterations=many.iterations.tolist(),
            statuses=[s.name for s in many.status_enums()],
            lanes=lane_rows, k1_bit_equal=k1_equal,
            launches=seen, block_launches=seen_block,
            block_iterations=block.iterations.tolist(),
            block_fallback=bool(block.fallback),
            true_rel_residual_f64=true_rel, seconds_check_every_1=t_many,
            block_seconds_check_every_1=t_block,
            # per loop step: a batched or block step advances all k
            # lanes (whole 32-step blocks, as a single solve's count
            # runs); sequential: the 8 solves' wall over the longest
            us_per_iteration=dict(
                batched=t_b * 1e6 / blocked_steps(res_b),
                block=t_k * 1e6 / blocked_steps(res_k),
                sequential=t_seq * 1e6 / max(seq_its),
                sequential_per_lane_iteration=t_seq * 1e6 / sum(seq_its)),
            sequential_iterations=seq_its)
        checks.extend([
            (all(r["x_bit_equal"] and r["count_equal"] and r["status_equal"]
                 for r in lane_rows.values()) and k1_equal,
             f"{label}: a lane is not its single solve's bits"),
            (many.converged.all() and max(true_rel) <= 1e-5,
             f"{label}: batched lanes' true residuals {true_rel}"),
            (seen == {cols_kernel: steps},
             f"{label}: launches {seen}, expected {steps} {cols_kernel}"),
            (seen_block == {cols_kernel: block_steps}
             and not bool(block.fallback),
             f"{label}: block launches {seen_block} ({block_steps})"),
            (block.converged.all(), f"{label}: block did not converge")])
        del op, op64, x_true, b, many, block, one, res_b, res_k

    # block CG's gain where the spectrum still shows it: 128^2 x 8 on B1
    op = poisson.poisson_2d_operator(128, 128, backend="pallas")
    x_true = torch.randn((MANY_K_2D, op.n), generator=gen,
                         device="cuda").t()
    b = op.matmat(x_true)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=4000)
    small, seen = count_main_path(lambda: solve_many(op, b, **kw))
    small_block, seen_block = count_main_path(
        lambda: solve_many(op, b, method="block", **kw))
    out["block_128"] = dict(
        grid=[128, 128], k=MANY_K_2D, iterations=small.iterations.tolist(),
        block_iterations=small_block.iterations.tolist(), launches=seen,
        block_launches=seen_block)
    checks.append((small_block.converged.all() and int(
        small_block.iterations.max()) < int(small.iterations.max()),
        f"block_128: block max count {small_block.iterations.tolist()} "
        f"vs batched {small.iterations.tolist()}"))
    del op, x_true, b

    # config #2 as assembled CSR, Jacobi, k = 8
    k = MANY_K_2D
    x_true = torch.randn((k, csr.n), generator=gen, device="cuda").t()
    b = csr.matmat(x_true)
    m = pt.JacobiPreconditioner.from_operator(csr)
    kw = dict(tol=0.0, rtol=1e-6, maxiter=4000)
    (many, t_many), seen = count_main_path(lambda: timed_solve(
        lambda: solve_many(csr, b, m=m, **kw)))
    csr_lanes = {}
    for j in (0, k - 1):
        single = plain_reference(lambda: pt.solve(csr, b[:, j], m=m,
                                                  engine="general", **kw))
        csr_lanes[j] = dict(iterations=int(single.iterations),
                            batched=int(many.iterations[j]),
                            x_bit_equal=torch.equal(single.x, many.x[:, j]))
    mesh = tpar.make_mesh(4, devices=["cuda:0"] * 4)
    dist = {}
    for lane in ("allgather", "gather"):
        (res, t_d), seen_d = count_main_path(lambda: timed_solve(
            lambda: tpar.solve_distributed_many(csr, b, mesh=mesh,
                                                preconditioner="jacobi",
                                                exchange=lane, **kw)))

        def per_iteration(fn):
            counts = []
            for maxiter in (8, 16):
                mesh.comm.counts.clear()
                fn(maxiter)
                counts.append(dict(mesh.comm.counts))
            return {c: (counts[1].get(c, 0) - counts[0].get(c, 0)) / 8
                    for c in set(counts[0]) | set(counts[1])}

        per_many = per_iteration(lambda it: tpar.solve_distributed_many(
            csr, b, mesh=mesh, tol=0.0, maxiter=it, exchange=lane))
        per_one = per_iteration(lambda it: tpar.solve_distributed(
            csr, b[:, 0], mesh=mesh, tol=0.0, maxiter=it, exchange=lane))
        payloads = []
        key = "all_gather" if lane == "allgather" else "ppermute"
        orig = getattr(mesh.comm, key)
        setattr(mesh.comm, key,
                lambda v, *a: payloads.append(list(v.shape)) or orig(v, *a))
        try:
            tpar.solve_distributed_many(csr, b, mesh=mesh, tol=0.0,
                                        maxiter=1, exchange=lane)
        finally:
            delattr(mesh.comm, key)
        dist[lane] = dict(
            iterations=res.iterations.tolist(), seconds=t_d,
            us_per_iteration=t_d * 1e6 / int(res.iterations.max()),
            launches=seen_d, collectives_per_iteration=per_many,
            single_rhs_collectives_per_iteration=per_one,
            exchange_payload_shapes=payloads)
        checks.extend([
            (all(within(int(n), int(r)) for n, r in
                 zip(res.iterations.tolist(), many.iterations.tolist()))
             and res.converged.all(),
             f"csr_1024 {lane}: lanes {res.iterations.tolist()} vs "
             f"{many.iterations.tolist()}"),
            (per_many == per_one,
             f"csr_1024 {lane}: collectives an iteration {per_many} vs "
             f"{per_one}"),
            (payloads and all(p[-1] == k for p in payloads),
             f"csr_1024 {lane}: exchange payloads {payloads}")])
    out["csr_1024"] = dict(
        rows=csr.n, nnz=csr.nnz, k=k, preconditioner="jacobi",
        lanes=csr_lanes, seconds=t_many,
        us_per_iteration=t_many * 1e6 / int(many.iterations.max()),
        launches=seen, distributed=dict(shards=4, **dist))
    checks.extend([
        (all(within(r["batched"], r["iterations"])
             for r in csr_lanes.values()) and many.converged.all(),
         f"csr_1024: lanes against single solves {csr_lanes}"),
        (not seen, f"csr_1024: launched {seen} (CSR is torch segment "
                   f"sums)")])
    del x_true, b, many

    # recycling on config #2's CSR: repeat traffic, the same b each solve
    b_rep = csr.matvec(torch.randn(csr.n, generator=gen, device="cuda"))
    (seq, t_seq), seen = count_main_path(lambda: timed_solve(
        lambda: rec.recycled_sequence(csr, b_rep, repeats=3, k=8,
                                      maxiter=4000, tol=0.0, rtol=1e-6)))
    its = seq.iterations()
    cfg = rec.BasisConfig.for_solve(4000)
    # the space of the first (undeflated) solve's harvest, for the mesh
    space, _ = rec.harvest_space(csr, seq.entries[0].result, k=8,
                                 note=False)
    b_new = csr.matvec(torch.randn(csr.n, generator=gen, device="cuda"))

    def per_iteration(**extra):
        counts = []
        for maxiter in (8, 16):
            mesh.comm.counts.clear()
            tpar.solve_distributed(csr, b_new, mesh=mesh, tol=0.0,
                                   maxiter=maxiter, **extra)
            counts.append(dict(mesh.comm.counts))
        return {c: (counts[1].get(c, 0) - counts[0].get(c, 0)) / 8
                for c in set(counts[0]) | set(counts[1])}

    per_plain, per_defl = per_iteration(), per_iteration(deflate=space)
    (plain_d, t_plain), _ = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed(csr, b_rep, mesh=mesh, **kw)))
    (defl_d, t_defl), _ = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed(csr, b_rep, mesh=mesh, deflate=space,
                                       **kw)))
    fresh = [int(tpar.solve_distributed(csr, b_new, mesh=mesh, **kw,
                                        **extra).iterations)
             for extra in ({}, {"deflate": space})]
    out["recycle_1024"] = dict(
        iterations=its, falls_every_solve=all(
            b_ < a_ for a_, b_ in zip(its, its[1:])),
        harvest_seconds=[e.harvest_s for e in seq.entries],
        solve_seconds=[e.elapsed_s for e in seq.entries],
        ring_capacity=cfg.capacity, ring_bytes=cfg.capacity * csr.n * 4,
        ritz=[list(e.info.ritz) if e.info else None for e in seq.entries],
        wall_seconds=t_seq, launches=seen,
        distributed=dict(
            shards=4, plain_iterations=int(plain_d.iterations),
            deflated_iterations=int(defl_d.iterations),
            deflated_status=defl_d.status_enum().name,
            plain_us_per_iteration=t_plain * 1e6 / int(plain_d.iterations),
            deflated_us_per_iteration=t_defl * 1e6
            / int(defl_d.iterations),
            collectives_per_iteration=per_defl,
            undeflated_collectives_per_iteration=per_plain,
            fresh_b_iterations=dict(plain=fresh[0], deflated=fresh[1])))
    checks.extend([
        (all(e.result.converged for e in seq.entries)
         and out["recycle_1024"]["falls_every_solve"],
         f"recycle_1024: iterations {its} do not fall every solve"),
        (per_defl == per_plain,
         f"recycle_1024: deflated collectives {per_defl} vs {per_plain}"),
        (defl_d.status_enum() == pt.CGStatus.CONVERGED
         and int(defl_d.iterations) < int(plain_d.iterations),
         f"recycle_1024: distributed deflated {int(defl_d.iterations)} vs "
         f"{int(plain_d.iterations)}")])
    failed = [msg for ok, msg in checks if not ok]
    emit("many_rhs", card=smi, **out,
         limits=dict(matrix_free="lanes and k = 1 bit-equal to single "
                                 "solves, true residuals <= 1e-5; one "
                                 "column-stack launch a matmat; block "
                                 "max count below batched at 128^2",
                     csr="lanes within max(2, 1 %) of single solves; the "
                         "distributed lanes' of the batch; collectives "
                         "an iteration the single-RHS solve's",
                     recycle="the count falls every solve; deflated "
                             "collectives an iteration unchanged, fewer "
                             "iterations"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"many_rhs: {failed}")


def robust_phase(pt, tpar, poisson, csr, sell, gen, count_main_path, smi):
    """Fault injection, recovery and validation (``robust.inject``,
    ``robust.recover``, ``robust.validate``), b = A x_true, rtol 1e-6.

    * Config #2 at 1024^2 on B1 (``Stencil2D(backend="pallas")``) and as
      its CSR through ``to_shiftell()`` on B8, ``engine="general"``: a
      clean solve; ``fault=None`` and a plan past convergence bit-equal
      to it (x, count, status) with its B1/B8 launch count; ``spmv`` and
      ``reduction`` plans at step 40 exit BREAKDOWN at 40-41;
      ``solve_with_recovery`` recovers with one restart to x within 1e-5
      * max|x| of the clean solve; a sticky plan exhausts two restarts
      (three attempts, BREAKDOWN, typed); ``snapshot_every=64`` with a
      plan at step 100 restarts from the last finite segment and
      converges to the clean solve's absolute threshold 1e-6 ||b|| (a
      restart's rtol would be relative to its own smaller initial
      residual): true residual within 2e-6 of ||b||, another trajectory
      to the same tolerance, so x is reported beside the clean x, not
      held to it.
    * One 256^3 ``spmv`` drill on B2 (BREAKDOWN at 40-41), recovered.
    * ``engine="resident"``/``"streaming"`` with a plan raise, launching
      nothing; a NaN in b is refused by ``solve_with_recovery`` and
      ``solve_distributed`` before any launch, and with
      ``validate=False`` reaches the typed BREAKDOWN.
    * Config #2's CSR over 4 stacked shards (the CSR lanes are torch
      segment sums: no hand kernel), allgather and gather lanes:
      ``halo``/``spmv``/``reduction`` plans on shard 2 at step 40 exit
      BREAKDOWN at 40-41 and recover within 1e-5 * max|x|, an unfired
      plan bit-equal to the clean solve; ``solve_distributed_many`` x 8
      with a lane-3 ``reduction`` plan breaks lane 3 alone, the other
      lanes bit-equal to the clean batch; the ``shard_loss`` drill
      migrates 4 -> 3 shards (an uneven split of 1,048,576 rows) at the
      first segment boundary and converges with the uninterrupted count
      (within max(2, 1 %), as the 4 -> 2 migration of the ``resumable``
      phase)."""
    import tempfile

    from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
    from cuda_mpi_parallel_tpu_torch.robust import (
        FaultPlan,
        RecoveryPolicy,
        solve_with_recovery,
    )
    from cuda_mpi_parallel_tpu_torch.telemetry import events
    from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    checks, out = [], {}
    kw = dict(tol=0.0, rtol=1e-6, maxiter=4000)
    gkw = dict(kw, engine="general")

    def status(res):
        return res.status_enum().name

    def rel_err(x, ref):
        return float((x - ref).abs().max() / ref.abs().max())

    def true_rel(op, b, x):
        """||b - A x|| / ||b||, the product in float32, the norms in
        float64."""
        return float((b - op.matvec(x)).double().norm()
                     / b.double().norm())

    def result_bits(res):
        return (res.x, res.iterations, res.status)

    def captured(fn):
        with events.capture() as buf:
            res = fn()
        recs = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.strip()]
        return res, recs

    def drill(label, fn, clean, recover):
        """One plan: the broken solve and its recovery."""
        (broken, t_b), seen_b = count_main_path(lambda: timed_solve(fn))
        (rr, recs), seen_r = count_main_path(lambda: captured(recover))
        err = rel_err(rr.result.x, clean.x)
        row = dict(status=status(broken), iterations=int(broken.iterations),
                   seconds=t_b, launches=seen_b, recovered=rr.recovered,
                   restarts=rr.restarts, recovered_x_rel_err=err,
                   recovered_bit_equal=torch.equal(rr.result.x, clean.x),
                   recovered_launches=seen_r,
                   events=sorted({r["event"] for r in recs
                                  if r["event"].startswith("solve_")}))
        checks.extend([
            (row["status"] == "BREAKDOWN"
             and 40 <= row["iterations"] <= 41,
             f"{label}: {row['status']} at {row['iterations']}"),
            (rr.recovered and rr.restarts == 1 and err <= 1e-5,
             f"{label}: recovery {rr.to_json()} x err {err}")])
        return row

    # -- one device: config #2 on B1 and on B8 --------------------------------
    op1 = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    for label, op, kernel in (("b1_1024", op1, "stencil2d_apply"),
                              ("b8_1024", sell, "shift_ell_matvec")):
        b = op.matvec(torch.randn(op.n, generator=gen, device="cuda"))
        pt.solve(op, b, **dict(gkw, maxiter=32))                # warm-up
        (clean, t_clean), seen = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, **gkw)))
        n = int(clean.iterations)
        off, seen_off = count_main_path(
            lambda: pt.solve(op, b, fault=None, **gkw))
        late, seen_late = count_main_path(lambda: pt.solve(
            op, b, fault=FaultPlan(site="spmv", iteration=n + 100), **gkw))
        row = dict(iterations=n, status=status(clean),
                   us_per_iteration=t_clean * 1e6 / n, launches=seen,
                   fault_none_bit_equal=same_bits(result_bits(off),
                                                  result_bits(clean)),
                   fault_none_launches=seen_off,
                   late_plan_bit_equal=same_bits(result_bits(late),
                                                 result_bits(clean)),
                   late_plan_launches=seen_late)
        checks.extend([
            (status(clean) == "CONVERGED" and seen.get(kernel) == n,
             f"{label}: clean {status(clean)}, launches {seen} vs {n}"),
            (row["fault_none_bit_equal"] and seen_off == seen,
             f"{label}: fault=None not the clean bits/launches"),
            (row["late_plan_bit_equal"] and seen_late == seen,
             f"{label}: a plan past convergence not the clean bits/"
             f"launches")])
        for site in ("spmv", "reduction"):
            plan = FaultPlan(site=site, iteration=40)
            row[site] = drill(
                f"{label} {site}",
                lambda: pt.solve(op, b, fault=plan, **gkw), clean,
                lambda: solve_with_recovery(op, b, inject=plan, **gkw))
            checks.append((row[site]["launches"].get(kernel)
                           == row[site]["iterations"],
                           f"{label} {site}: launches {row[site]}"))
        sticky, seen_s = count_main_path(lambda: solve_with_recovery(
            op, b, policy=RecoveryPolicy(max_restarts=2),
            inject=FaultPlan(site="spmv", iteration=40, sticky=True),
            **gkw))
        # a restart re-seeds CG, whose rtol is relative to ITS initial
        # residual: the drill takes the clean solve's absolute threshold
        # (1e-6 ||b||, x0 = 0), as the JAX drills take an absolute tol
        snap_kw = dict(gkw, tol=1e-6 * float(b.norm()), rtol=0.0)
        (snap, recs), seen_snap = count_main_path(lambda: captured(
            lambda: solve_with_recovery(
                op, b, policy=RecoveryPolicy(max_restarts=1,
                                             snapshot_every=64),
                inject=FaultPlan(site="spmv", iteration=100), **snap_kw)))
        seeds = [r.get("seed") for r in recs
                 if r["event"] == "solve_recovery"
                 and r["action"] == "restart"]
        # a restart from a pre-fault iterate takes another trajectory to
        # the same tolerance: held to the tolerance, x reported
        snap_true = true_rel(op, b, snap.result.x)
        row.update(sticky=dict(sticky.to_json(), launches=seen_s),
                   snapshot=dict(snap.to_json(), seeds=seeds,
                                 iterations=int(snap.result.iterations),
                                 x_rel_err=rel_err(snap.result.x, clean.x),
                                 true_rel_residual=snap_true,
                                 clean_true_rel_residual=true_rel(
                                     op, b, clean.x),
                                 launches=seen_snap))
        checks.extend([
            (not sticky.recovered and sticky.attempts == 3
             and status(sticky.result) == "BREAKDOWN"
             and len(sticky.faults) == 3,
             f"{label}: sticky {sticky.to_json()}"),
            (snap.recovered and seeds == ["last_finite_segment"]
             and snap_true <= 2e-6,
             f"{label}: snapshot_every=64 {snap.to_json()} seeds {seeds} "
             f"true residual {snap_true}")])
        out[label] = row
        if label == "b1_1024":
            b1, clean1 = b, clean

    # -- one 256^3 drill on B2 ---------------------------------------------------
    op3 = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    b3 = op3.matvec(torch.randn(op3.n, generator=gen, device="cuda"))
    clean3, seen3 = count_main_path(lambda: pt.solve(op3, b3, **gkw))
    plan = FaultPlan(site="spmv", iteration=40)
    out["b2_256"] = dict(
        iterations=int(clean3.iterations), launches=seen3,
        spmv=drill("b2_256 spmv",
                   lambda: pt.solve(op3, b3, fault=plan, **gkw), clean3,
                   lambda: solve_with_recovery(op3, b3, inject=plan,
                                               **gkw)))
    checks.append((out["b2_256"]["spmv"]["launches"].get("stencil3d_apply")
                   == out["b2_256"]["spmv"]["iterations"],
                   f"b2_256: launches {out['b2_256']['spmv']}"))
    del op3, b3, clean3

    # -- refusals and validation ---------------------------------------------------
    m4 = tpar.make_mesh(4, devices=["cuda:0"] * 4)

    def refused(fn):
        """``(message, launches)``: the ValueError ``fn`` raises (or
        "ran") and the kernels it launched before that."""
        hk.reset_launches()
        try:
            fn()
            msg = "ran"
        except ValueError as e:
            msg = str(e)
        torch.cuda.synchronize()
        seen = dict(hk.LAUNCHES)
        hk.reset_launches()
        return msg, seen

    b_nan = b1.clone()
    b_nan[7] = float("nan")
    refusals = {
        engine: refused(lambda: pt.solve(op1, b1, engine=engine,
                                         fault=plan, **kw))
        for engine in ("resident", "streaming")}
    refusals["solve_with_recovery"] = refused(
        lambda: solve_with_recovery(op1, b_nan, **gkw))
    refusals["solve_distributed"] = refused(
        lambda: tpar.solve_distributed(csr, b_nan, mesh=m4, **kw))
    nan_1, seen_nan = count_main_path(lambda: pt.solve(op1, b_nan, **gkw))
    nan_4 = tpar.solve_distributed(csr, b_nan, mesh=m4, validate=False,
                                   **kw)
    out["refusals"] = dict(
        messages=refusals,
        nan_b_validate_false=dict(
            single=dict(status=status(nan_1),
                        iterations=int(nan_1.iterations), launches=seen_nan),
            four_shards=dict(status=status(nan_4),
                             iterations=int(nan_4.iterations))))
    checks.extend([
        (all("fault injection" in refusals[e][0]
             for e in ("resident", "streaming")),
         f"refusals: fused engines {refusals}"),
        (all("non-finite" in refusals[k][0]
             for k in ("solve_with_recovery", "solve_distributed")),
         f"refusals: NaN b {refusals}"),
        (not any(seen for _, seen in refusals.values()),
         f"refusals: launched before refusing {refusals}"),
        (status(nan_1) == "BREAKDOWN" and not seen_nan
         and status(nan_4) == "BREAKDOWN" and int(nan_4.iterations) <= 1,
         f"refusals: validate=False {out['refusals']}")])
    del op1, b1, clean1, b_nan

    # -- config #2's CSR over 4 stacked shards ------------------------------------
    x_true = torch.randn(csr.n, generator=gen, device="cuda")
    bc = csr.matvec(x_true)
    lanes = {}
    for lane, exchange in (("allgather", None), ("gather", "gather")):
        dkw = dict(kw, mesh=m4, exchange=exchange)
        tpar.solve_distributed(csr, bc, **dict(dkw, maxiter=8))  # warm-up
        (clean, t_clean), seen = count_main_path(lambda: timed_solve(
            lambda: tpar.solve_distributed(csr, bc, **dkw)))
        n = int(clean.iterations)
        late = tpar.solve_distributed(csr, bc, inject=FaultPlan(
            site="halo", iteration=n + 100, shard=2), **dkw)
        row = dict(iterations=n, status=status(clean),
                   us_per_iteration=t_clean * 1e6 / n, launches=seen,
                   late_plan_bit_equal=same_bits(result_bits(late),
                                                 result_bits(clean)))
        checks.extend([
            (status(clean) == "CONVERGED" and not seen,
             f"dist {lane}: {status(clean)}, launched {seen}"),
            (row["late_plan_bit_equal"],
             f"dist {lane}: an unfired plan changed the bits")])
        for site in ("halo", "spmv", "reduction"):
            plan = FaultPlan(site=site, iteration=40, shard=2)
            row[site] = drill(
                f"dist {lane} {site}",
                lambda: tpar.solve_distributed(csr, bc, inject=plan, **dkw),
                clean,
                lambda: solve_with_recovery(csr, bc, inject=plan, **dkw))
        lanes[lane] = row
        if lane == "allgather":
            clean_ag = clean
    out["dist_csr_1024"] = dict(rows=csr.n, shards=4, lanes=lanes)

    # the batched lane: k = 8, a reduction plan on lane 3
    k = 8
    bk = torch.stack([csr.matvec(torch.randn(csr.n, generator=gen,
                                             device="cuda"))
                      for _ in range(k)], 1)
    many_kw = dict(mesh=m4, tol=0.0, rtol=1e-6, maxiter=4000)
    (many_clean, t_mc), seen_mc = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed_many(csr, bk, **many_kw)))
    plan = FaultPlan(site="reduction", iteration=40, lane=3, shard=2)
    (many_bad, t_mb), seen_mb = count_main_path(lambda: timed_solve(
        lambda: tpar.solve_distributed_many(csr, bk, inject=plan,
                                            **many_kw)))
    statuses = [s.name for s in many_bad.status_enums()]
    others_equal = all(torch.equal(many_bad.x[:, j], many_clean.x[:, j])
                       and int(many_bad.iterations[j])
                       == int(many_clean.iterations[j])
                       for j in range(k) if j != 3)
    out["many_1024"] = dict(
        k=k, statuses=statuses, iterations=many_bad.iterations.tolist(),
        clean_iterations=many_clean.iterations.tolist(),
        others_bit_equal=others_equal, seconds=t_mb,
        clean_seconds=t_mc, launches=seen_mb)
    checks.extend([
        (statuses[3] == "BREAKDOWN"
         and 40 <= int(many_bad.iterations[3]) <= 41
         and all(s == "CONVERGED" for j, s in enumerate(statuses)
                 if j != 3), f"many_1024: statuses {statuses}"),
        (others_equal, "many_1024: the untouched lanes differ from the "
                       "clean batch")])
    del bk, many_clean, many_bad

    # the shard_loss drill: 4 -> 3 shards at the first segment boundary
    n = int(clean_ag.iterations)
    seg = -(-n // 4)
    with tempfile.TemporaryDirectory() as d:
        (loss, recs), seen_l = count_main_path(lambda: captured(
            lambda: ck.solve_resumable_distributed(
                csr, bc, os.path.join(d, "loss.npz"), mesh=m4,
                segment_iters=seg, elastic=True,
                inject=FaultPlan.parse("shard_loss:1:2"), **kw)))
    moves = [r for r in recs if r["event"] == "solve_migration"]
    loss_err = rel_err(loss.x, clean_ag.x)
    out["shard_loss_1024"] = dict(
        shards_from=4, shards_to=3, segment_iters=seg,
        iterations=int(loss.iterations), uninterrupted_iterations=n,
        status=status(loss), x_rel_err=loss_err, migrations=moves,
        launches=seen_l)
    checks.extend([
        (status(loss) == "CONVERGED"
         and abs(int(loss.iterations) - n) <= max(2, 0.01 * n),
         f"shard_loss: {status(loss)} at {int(loss.iterations)} vs {n}"),
        (loss_err <= 1e-5, f"shard_loss: x err {loss_err}"),
        (len(moves) == 1 and moves[0]["reason"] == "shard_loss"
         and moves[0]["lost_shard"] == 2
         and (moves[0]["n_shards_from"], moves[0]["n_shards_to"])
         == (4, 3), f"shard_loss: migrations {moves}")])
    failed = [msg for ok, msg in checks if not ok]
    emit("robust", card=smi, **out,
         limits=dict(drill="BREAKDOWN at 40-41; one restart to x within "
                           "1e-5 * max|x|; the kernel launched once an "
                           "iteration",
                     unarmed="fault=None and a plan past convergence: "
                             "the clean bits and launches",
                     sticky="three attempts, BREAKDOWN",
                     snapshot="a restart from the last finite segment, "
                              "true residual <= 2e-6 * ||b||",
                     many="lane 3 BREAKDOWN at 40-41, the other lanes "
                          "the clean batch's bits",
                     shard_loss="4 -> 3 shards, the uninterrupted count "
                                "within max(2, 1 %), x within 1e-5 * "
                                "max|x|"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"robust: {failed}")


#: each kernel row's bound (ms, four decimals) at the main path's shapes,
#: as PERF.md's kernel table records it: taking the card's peaks from
#: ``telemetry.roofline`` must leave every bound as it was
TABLE_BOUND_MS = {
    "stencil2d_apply": "0.0401", "stencil3d_apply": "0.0401",
    "stencil2d_apply_cols": "0.0200", "stencil3d_apply_cols": "0.1603",
    "fused_cg_pass_a": "0.0601", "fused_cg_pass_b": "0.1002",
    "fused_cheb_step": "0.1002", "fused_cg_pass_a_df64": "0.1202",
    "fused_cg_pass_b_df64": "0.2003", "shift_ell_matvec": "0.0151",
    "shift_ell_matvec_df64": "0.0239", "cg_resident": "0.0501",
    "cg_resident_cg1": "0.0565", "cg_resident_df64": "0.0988",
    "cg_resident_dist_local": "0.0501"}


def roofline_tune_phase(pt, tpar, poisson, csr, gen, count_main_path, smi,
                        rows):
    """The machine model, the roofline verdict, the comm-layer cost
    account and the autotuner (``telemetry.roofline``,
    ``telemetry.cost``, ``utils.tune``).

    * ``machine_model("cuda")``: the card's published peaks - the very
      numbers the kernels line's bounds use - and its memory size; each
      kernel row's bound held to PERF.md's table (``TABLE_BOUND_MS``).
    * ``analyze`` of a measured general solve at 1024^2 (B1, tol 0, 512
      iterations, check_every=32) and a streaming solve at 256^3 (B3/B4,
      the same): efficiency against the model's bound, and the bound.
    * ``trace_solve_cost`` over 4 stacked shards, 16 iterations: 1024^2
      slabs on B1 (2 psums and 2 halo ppermutes an iteration, wire bytes
      the two boundary rows), config #2's CSR on the allgather lane (1
      all_gather, wire 3/4 of x) and the gather lane.
    * ``autotune`` at 1024^2 (backends xla/pallas x cg/cg1 x check_every
      1/32) and on config #2's CSR (CSR, ELL, DIA, B8's sliced ELL): the
      table and the winner; ``solve_tuned`` (at 1024^2 with
      ``engine="auto"``, the resident kernel B10's) bit-equal to
      ``solve`` with the winning configuration."""
    from cuda_mpi_parallel_tpu_torch.telemetry import cost, roofline
    from cuda_mpi_parallel_tpu_torch.utils import tune

    t_phase = time.perf_counter()
    checks, out = [], {}
    model = roofline.machine_model("cuda")
    out["machine_model"] = model.to_json()
    props = torch.cuda.get_device_properties(0)
    checks.append((model.name == torch.cuda.get_device_name(0)
                   and model.hbm_bytes == float(props.total_memory),
                   f"machine_model: {model} vs the card's name and memory"))
    bounds = {name: f"{rows[name]['bound_ms']:.4f}"
              for name in TABLE_BOUND_MS if name in rows}
    out["kernel_bounds_ms"] = bounds
    checks.append((bounds == TABLE_BOUND_MS,
                   f"kernel bounds {bounds} vs PERF.md's {TABLE_BOUND_MS}"))

    # the roofline verdict of two measured solves
    op1 = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    b1 = torch.randn(op1.n, generator=gen, device="cuda")
    op3 = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    b3 = torch.randn(op3.n, generator=gen, device="cuda")
    akw = dict(tol=0.0, maxiter=512, check_every=32)
    verdicts = {}
    for label, op, b, engine in (("general_1024", op1, b1, "general"),
                                 ("streaming_256", op3, b3, "streaming")):
        pt.solve(op, b, engine=engine, **dict(akw, maxiter=32))  # warm-up
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op, b, engine=engine, **akw)))
        rep = roofline.analyze(n=op.n, nnz=roofline.operator_nnz(op),
                               itemsize=4, iterations=int(res.iterations),
                               elapsed_s=t, model=model)
        verdicts[label] = dict(
            iterations=int(res.iterations), seconds=t, launches=seen,
            efficiency_pct=rep.efficiency_pct, bound=rep.bound,
            us_per_iteration=rep.measured_s_per_iteration * 1e6,
            model_us_per_iteration=rep.model_s_per_iteration * 1e6,
            arithmetic_intensity=rep.arithmetic_intensity,
            describe=rep.describe())
        checks.append((int(res.iterations) == 512 and rep.bound == "memory"
                       and rep.efficiency_pct > 0,
                       f"analyze {label}: {verdicts[label]}"))
    out["analyze"] = verdicts
    del op3, b3

    # the comm-layer account over 4 stacked shards
    m4 = tpar.make_mesh(4, devices=["cuda:0"] * 4)
    bc = csr.matvec(torch.randn(csr.n, generator=gen, device="cuda"))
    tkw = dict(mesh=m4, tol=0.0, maxiter=16)
    traces = {}
    for label, a, b, extra in (("stencil_1024", op1, b1, {}),
                               ("allgather_1024", csr, bc, {}),
                               ("gather_1024", csr, bc,
                                dict(exchange="gather"))):
        sc, seen = count_main_path(lambda: cost.trace_solve_cost(
            tpar.solve_distributed, a, b, **tkw, **extra))
        traces[label] = dict(per_iteration=sc.per_iteration.to_json(),
                             setup=sc.setup.to_json(),
                             loops=len(sc.loops), launches=seen)
    out["trace_solve_cost"] = traces
    halo = cost.stencil_halo_bytes_per_iteration(
        (GRID_RES_2D[0] // 4, GRID_RES_2D[1]), 4)
    per = {k: v["per_iteration"] for k, v in traces.items()}
    checks.extend([
        (per["stencil_1024"]["ops"] == {"ppermute": 2, "psum": 2}
         and per["stencil_1024"]["wire_bytes"] == halo
         and traces["stencil_1024"]["launches"].get("stencil2d_apply")
         == 4 * 16, f"trace stencil_1024: {traces['stencil_1024']}"),
        (per["allgather_1024"]["ops"] == {"all_gather": 1, "psum": 2}
         and per["allgather_1024"]["wire_bytes"] == 3 * csr.n // 4 * 4,
         f"trace allgather_1024: {traces['allgather_1024']}"),
        (per["gather_1024"]["ops"].get("psum") == 2
         and "all_gather" not in per["gather_1024"]["ops"]
         and 0 < per["gather_1024"]["wire_bytes"]
         < per["allgather_1024"]["wire_bytes"],
         f"trace gather_1024: {traces['gather_1024']}")])

    # the autotuner: config #2 matrix-free (B1) and as its CSR (B8)
    rkw = dict(tol=0.0, rtol=1e-6, maxiter=4000)
    tuned = {}
    for label, a, b, engine in (("stencil_1024", op1, b1, "auto"),
                                ("csr_1024", csr, bc, "general")):
        t0 = time.perf_counter()
        (res, cfg), seen = count_main_path(lambda: tune.solve_tuned(
            a, b, engine=engine, **rkw))
        sweep_s = time.perf_counter() - t0
        again, seen_again = count_main_path(lambda: pt.solve(
            cfg.operator if cfg.operator is not None else a, b,
            engine=engine, **cfg.best, **rkw))
        tuned[label] = dict(
            best=cfg.best, us_per_iteration=cfg.us_per_iter,
            operator=(type(cfg.operator).__name__
                      if cfg.operator is not None else None),
            table=cfg.table, iterations=int(res.iterations),
            status=res.status_enum().name, seconds=sweep_s,
            launches=seen, solve_launches=seen_again,
            bit_equal=same_bits(
                (res.x, res.iterations, res.status),
                (again.x, again.iterations, again.status)))
        finite = [v for v in cfg.table.values() if math.isfinite(v)]
        checks.extend([
            (tuned[label]["bit_equal"]
             and res.status_enum() == pt.CGStatus.CONVERGED,
             f"autotune {label}: solve_tuned not solve's bits"),
            (cfg.us_per_iter == min(finite) and len(cfg.table) == (
                8 if label == "stencil_1024" else 16),
             f"autotune {label}: table {cfg.table}")])
    out["autotune"] = tuned
    checks.append(("stencil2d_apply" in tuned["stencil_1024"]["launches"]
                   and "shift_ell_matvec" in tuned["csr_1024"]["launches"],
                   "autotune: the hand-kernel candidates did not launch"))
    failed = [msg for ok, msg in checks if not ok]
    emit("roofline_tune", card=smi, **out, failed=failed,
         wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"roofline_tune: {failed}")


PLAN_SHARDS = 4          # the plan_scope phase's stacked shards
#: the plan both packages' planners return for config #2's CSR at P = 4
#: under models.skewed.PLANNING_MODEL (tests/torch_plan_scale.py, the
#: "balanced" case)
BALANCED_PLAN = ("none+even+gather", "0c295911f3a7")
BANDED_K = 24            # extra in-row couplings of the skewed rows
#: the banded f64 solves' stop: past what float32 arithmetic reaches,
#: short of RTOL_F64's 2,947 iterations, which the phase's wall cannot hold
PLAN_RTOL_F64 = 1e-8


def plan_scope_phase(pt, tpar, poisson, csr, gen, count_main_path, smi):
    """Device-memory and per-shard accounting and the partition planner
    (``telemetry.memscope``, ``telemetry.shardscope``, ``balance/``,
    ``plan=``) over 4 stacked shards on the card:

    * config #2's CSR (1024^2, f32) on the allgather, gather, ring and
      ring shift-ELL (B8) lanes, telemetered, 16 iterations: the shard
      report, the footprint - its matrix bytes the live tensors' exactly
      (``note_footprint`` asserts it), the recorded peak at most the
      allocator's high water over the solve and at least the persistent
      footprint, FITS against the card's memory - and
      ``plan_partition`` under ``models.skewed.PLANNING_MODEL``: the
      JAX planner's plan;
    * the comm gauges of a telemetered 1024^2 slab solve (B1) and of the
      allgather lane: ``trace_solve_cost``'s numbers, and the same solve
      untelemetered bit-equal with equal launches, each first solve
      timed (what the records of a first telemetered solve cost);
    * ``plan_partition(hbm_budget=)`` below the footprint: the mesh grows
      (config #2) or ``MemoryBudgetError`` is raised (a 64^2 system),
      with ``torch.cuda.memory_allocated()`` unchanged;
    * the banded skew system (1024^2 grid, its second quarter of rows
      with 29 entries: even-split nnz max/mean 2.6), planned once for the
      ring lanes (``resolve_plan("auto", exchange="ring")``), with
      ``plan="auto"`` on ring shift-ELL (B8, rtol 1e-6) resolving that
      plan, and that plan on ``solve_distributed_df64``'s CSR lane (B9,
      rtol 1e-8): the measured nnz max/mean cut >= 2x, x in the
      caller's order within 1e-5 (f32) / 1e-10 (f64) of max|x| of the
      unplanned solve's, the count within max(2, 1 %), 4 launches a
      matvec (one a ring step);
    * its ``shard_loss`` migration 4 -> 3 from that plan on the
      resumable lane (re-planned by ``plan="auto"`` for 3 shards): the
      uninterrupted planned solve's count within max(2, 1 %)."""
    import tempfile

    import numpy as np

    from cuda_mpi_parallel_tpu_torch import telemetry
    from cuda_mpi_parallel_tpu_torch.balance import plan_partition
    from cuda_mpi_parallel_tpu_torch.models.skewed import (
        PLANNING_MODEL,
        banded_skew_coo,
    )
    from cuda_mpi_parallel_tpu_torch.parallel import dist_cg
    from cuda_mpi_parallel_tpu_torch.robust import FaultPlan
    from cuda_mpi_parallel_tpu_torch.telemetry import cost, events
    from cuda_mpi_parallel_tpu_torch.telemetry import memscope as ms
    from cuda_mpi_parallel_tpu_torch.telemetry import shardscope as ss
    from cuda_mpi_parallel_tpu_torch.telemetry.roofline import MachineModel
    from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    n_sh = PLAN_SHARDS
    mesh = tpar.make_mesh(n_sh, devices=["cuda:0"] * n_sh)
    capacity = float(torch.cuda.get_device_properties(0).total_memory)
    checks, out, walls = [], {}, {}
    t_part = time.perf_counter()

    def lap(name):
        """The host seconds of a part of the phase, since the last lap."""
        nonlocal t_part
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[name] = now - t_part
        t_part = now

    def captured(fn):
        with events.capture() as buf:
            res = fn()
        return res, [json.loads(line) for line in
                     buf.getvalue().splitlines() if line.strip()]

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def rel_err(x, ref):
        return float((x - ref).abs().max() / ref.abs().max())

    # config #2's four lanes, telemetered: reports, footprints, peaks
    bc = csr.matvec(torch.randn(csr.n, generator=gen, device="cuda"))
    fkw = dict(mesh=mesh, tol=0.0, maxiter=16)
    lanes = {}
    for label, kw in (("allgather", dict(exchange="allgather")),
                      ("gather", dict(exchange="gather")),
                      ("ring", dict(csr_comm="ring")),
                      ("ring-shiftell", dict(csr_comm="ring-shiftell"))):
        dist_cg.clear_solver_cache()
        ss.reset_last_shard_report()
        ms.reset_last_memory_profile()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        (res, recs), seen = count_main_path(lambda: captured(
            lambda: tpar.solve_distributed(csr, bc, **fkw, **kw)))
        high = torch.cuda.max_memory_allocated() - before
        prof = ms.last_memory_profile()
        fp, rep = prof["footprint"], ss.last_shard_report()
        peak = next(iter(dist_cg._PEAK_CACHE.values()))
        persistent = int(fp.persistent_bytes.sum())
        lanes[label] = dict(
            report=rep.to_json(), footprint=fp.to_json(),
            measured_bytes=prof["measured_bytes"],
            matrix_bytes_x_shards=int(fp.matrix_bytes.sum()),
            peak_record_bytes=peak, allocator_high_water_bytes=high,
            persistent_bytes_sum=persistent, launches=seen,
            events=sorted({r["event"] for r in recs}))
        checks.extend([
            (prof["measured_bytes"] == int(fp.matrix_bytes.sum()),
             f"{label}: measured {prof['measured_bytes']} != model "
             f"{int(fp.matrix_bytes.sum())}"),
            (persistent <= peak <= high,
             f"{label}: peak {peak} not within [{persistent}, {high}]"),
            (fp.hbm_bytes == capacity and fp.classification == "FITS",
             f"{label}: {fp.classification} on {fp.hbm_bytes}"),
            (int(rep.n_shards) == n_sh and int(rep.nnz.sum()) == csr.nnz,
             f"{label}: report {rep.kind} nnz {int(rep.nnz.sum())}"),
            ({"shard_profile", "memory_profile", "comm_cost"}
             <= set(lanes[label]["events"]),
             f"{label}: events {lanes[label]['events']}")])
        if label == "ring-shiftell":
            checks.append((seen == {"shift_ell_matvec": n_sh * 16},
                           f"{label}: launches {seen}"))
    out["config2_lanes"] = lanes
    t0 = time.perf_counter()
    plan = plan_partition(csr, n_sh, model=MachineModel(**PLANNING_MODEL))
    out["config2_plan"] = dict(label=plan.label,
                               fingerprint=plan.fingerprint(),
                               score=plan.score,
                               seconds=time.perf_counter() - t0,
                               expected=list(BALANCED_PLAN))
    checks.append(((plan.label, plan.fingerprint()) == BALANCED_PLAN,
                   f"config #2 plan {plan.describe()} vs {BALANCED_PLAN}"))
    lap("config2_lanes_and_plan")

    # the comm gauges, and the same solves untelemetered
    op1 = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
    b1 = torch.randn(op1.n, generator=gen, device="cuda")
    gauges = {}
    for label, a, b in (("stencil_1024", op1, b1), ("allgather_1024", csr,
                                                    bc)):
        # the first solve of a fresh solver, untelemetered and then
        # telemetered (its comm record, its peak record over the setup
        # and first two trips, the partition's accounting): whole calls
        dist_cg.clear_solver_cache()
        (plain, t_plain), seen_plain = count_main_path(
            lambda: timed_solve(lambda: tpar.solve_distributed(a, b, **fkw)))
        want = cost.trace_solve_cost(tpar.solve_distributed, a, b, **fkw)
        dist_cg.clear_solver_cache()
        ((noted, recs), t_noted), seen_noted = count_main_path(
            lambda: timed_solve(lambda: captured(
                lambda: tpar.solve_distributed(a, b, **fkw))))
        kind = dist_cg.last_comm_cost()[1]["kind"]
        got = {g: telemetry.REGISTRY.gauge(
            f"dist_comm_{g}_per_iteration", "",
            labelnames=("kind",)).value(kind=kind)
            for g in ("psum", "ppermute", "all_gather", "bytes",
                      "wire_bytes")}
        per = want.per_iteration
        expect = dict(psum=per.psum, ppermute=per.ppermute,
                      all_gather=per.all_gather, bytes=per.comm_bytes,
                      wire_bytes=per.wire_bytes)
        gauges[label] = dict(gauges=got, trace_solve_cost=expect,
                             launches=seen_noted,
                             bit_equal=same_bits((plain.x,), (noted.x,)),
                             untelemetered_seconds=t_plain,
                             telemetered_first_seconds=t_noted,
                             telemetered_over_untelemetered=t_noted
                             / t_plain)
        checks.extend([
            (got == expect, f"{label}: gauges {got} vs {expect}"),
            (gauges[label]["bit_equal"] and seen_plain == seen_noted,
             f"{label}: telemetered solve differs ({seen_plain} vs "
             f"{seen_noted})")])
    out["comm_gauges"] = gauges
    del op1, b1
    lap("comm_gauges")

    # the budget gate: the mesh grows, or the refusal allocates nothing
    indptr = csr.indptr.cpu().numpy()
    fps = {p: int(ms.predict_footprint(
        n=csr.n, n_shards=p, indptr=indptr, itemsize=4,
        hbm_bytes=None).persistent_bytes.max()) for p in (4, 8)}
    budget = (fps[4] + fps[8]) // 2
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    grown = plan_partition(csr, n_sh, exchange="allgather",
                           reorders=("none",), splits=("even",),
                           hbm_budget=budget)
    torch.cuda.synchronize()
    grown_delta = torch.cuda.memory_allocated() - before
    small = poisson.poisson_2d_csr(64, 64, dtype=torch.float32)
    torch.cuda.synchronize()
    before_small = torch.cuda.memory_allocated()
    try:
        plan_partition(small, n_sh, reorders=("none",), splits=("even",),
                       hbm_budget=64)
        refused = None
    except ms.MemoryBudgetError as e:
        refused = dict(required_bytes=e.required_bytes,
                       budget_bytes=e.budget_bytes, n_shards=e.n_shards)
    torch.cuda.synchronize()
    out["budget"] = dict(predicted_persistent=fps, budget=budget,
                         grown_shards=grown.n_shards,
                         grown_allocated_delta=grown_delta, refused=refused,
                         refused_allocated_delta=torch.cuda.memory_allocated()
                         - before_small)
    checks.extend([
        (grown.n_shards == 2 * n_sh and grown_delta == 0,
         f"budget: {grown.n_shards} shards, {grown_delta} B allocated"),
        (refused is not None and out["budget"][
            "refused_allocated_delta"] == 0, f"budget: {out['budget']}")])
    del small
    lap("budget")

    # the banded skew system: plan="auto" on B8, its plan on B9
    skew64 = pt.CSRMatrix.from_coo(*banded_skew_coo(GRID_RES_2D[0],
                                                    BANDED_K),
                                   dtype=torch.float64)
    skew = pt.CSRMatrix.from_arrays(skew64.data.float(), skew64.indices,
                                    skew64.indptr)
    n = skew.n
    x_true = torch.randn(n, generator=gen, device="cuda")
    bs = skew.matvec(x_true)
    bs64 = skew64.matvec(x_true.double())
    banded = {"rows": n, "nnz": skew.nnz}
    lap("banded_build")
    # the planner once, as plan="auto" on the ring lanes prices it; the
    # auto call below must resolve the same plan, which the B9 lane and
    # the migration then take as given
    t0 = time.perf_counter()
    ring_plan = dist_cg.resolve_plan("auto", skew, n_sh, exchange="ring")
    banded["ring_plan"] = dict(label=ring_plan.label,
                               fingerprint=ring_plan.fingerprint(),
                               seconds=time.perf_counter() - t0)
    lap("banded_plan")
    for label, fn, a, b, name, tol in (
            ("ring_shiftell", tpar.solve_distributed, skew, bs,
             "shift_ell_matvec", 1e-5),
            ("csr_df64", tpar.solve_distributed_df64, skew64, bs64,
             "shift_ell_matvec_df64", 1e-10)):
        kw = dict(mesh=mesh, tol=0.0, maxiter=MAXITER_F64, check_every=1,
                  rtol=1e-6 if name == "shift_ell_matvec" else
                  PLAN_RTOL_F64)
        if name == "shift_ell_matvec":
            kw["csr_comm"] = "ring-shiftell"
        rows_ = {}
        for plan_arg in (None, "auto" if name == "shift_ell_matvec"
                         else ring_plan):
            t0 = time.perf_counter()
            (res, recs), seen = count_main_path(lambda: captured(
                lambda: fn(a, b, plan=plan_arg, **kw)))
            t = time.perf_counter() - t0
            prof, = [rec for rec in recs if rec["event"] == "shard_profile"]
            planned = [rec for rec in recs
                       if rec["event"] == "partition_plan"]
            x = res.x if name == "shift_ell_matvec" else res.x64
            its = int(res.iterations)
            key = "None" if plan_arg is None else "planned"
            rows_[key] = dict(
                iterations=its, status=res.status_enum().name, seconds=t,
                launches=seen, plan=prof["plan"],
                plan_arg=plan_arg if plan_arg in (None, "auto")
                else "ring_plan",
                fingerprint=planned[0]["fingerprint"] if planned else None,
                nnz=prof["nnz"],
                nnz_max_over_mean=prof["imbalance"]["nnz_max_over_mean"],
                x=x)
            checks.extend([
                (res.status_enum() == pt.CGStatus.CONVERGED,
                 f"{label} plan={plan_arg}: {res.status_enum().name}"),
                (seen == {name: n_sh * its},
                 f"{label} plan={plan_arg}: launches {seen} for {its} "
                 f"iterations")])
        even, planned = rows_["None"], rows_["planned"]
        cut = even["nnz_max_over_mean"] / planned["nnz_max_over_mean"]
        err = rel_err(planned.pop("x"), even.pop("x"))
        banded[label] = dict(even=even, planned=planned, cut=cut,
                             x_rel_err=err, x_tol=tol)
        lap(f"banded_{label}")
        checks.extend([
            (planned["fingerprint"] == ring_plan.fingerprint(),
             f"{label}: plan {planned['fingerprint']} vs "
             f"{ring_plan.fingerprint()}"),
            (cut >= 2.0, f"{label}: nnz max/mean cut {cut}"),
            (err <= tol, f"{label}: x differs by {err} of max|x|"),
            (within(planned["iterations"], even["iterations"]),
             f"{label}: {planned['iterations']} vs "
             f"{even['iterations']} iterations")])
    del skew64, bs64

    # the shard_loss migration of the planned system, 4 -> 3 shards at
    # the first of two segments, re-planned by plan="auto" for 3
    mkw = dict(tol=0.0, rtol=1e-6, maxiter=4000)
    clean, seen_c = count_main_path(lambda: tpar.solve_distributed(
        skew, bs, mesh=mesh, plan=ring_plan, **mkw))
    n_clean = int(clean.iterations)
    seg = -(-n_clean // 2)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        (moved, recs), seen_m = count_main_path(lambda: captured(
            lambda: ck.solve_resumable_distributed(
                skew, bs, os.path.join(d, "plan.npz"), mesh=mesh,
                segment_iters=seg, elastic=True, plan=ring_plan,
                inject=FaultPlan.parse("shard_loss:1:2"), **mkw)))
    moves = [rec for rec in recs if rec["event"] == "solve_migration"]
    banded["shard_loss"] = dict(
        iterations=int(moved.iterations), uninterrupted_iterations=n_clean,
        status=moved.status_enum().name, segment_iters=seg,
        seconds=time.perf_counter() - t0,
        x_rel_err=rel_err(moved.x, clean.x), migrations=moves)
    checks.extend([
        (moved.status_enum() == pt.CGStatus.CONVERGED
         and within(int(moved.iterations), n_clean),
         f"shard_loss: {moved.status_enum().name} at "
         f"{int(moved.iterations)} vs {n_clean}"),
        (len(moves) == 1 and moves[0]["plan"] != "even"
         and (moves[0]["n_shards_from"], moves[0]["n_shards_to"])
         == (4, 3), f"shard_loss: migrations {moves}")])
    out["banded_1024"] = banded
    del skew, bs, clean, moved
    lap("banded_shard_loss")
    failed = [msg for ok, msg in checks if not ok]
    emit("plan_scope", card=smi, shards=n_sh, **out, part_seconds=walls,
         limits=dict(matrix_bytes="the live tensors' exactly",
                     peak="persistent <= peak record <= allocator high "
                          "water",
                     gauges="trace_solve_cost's per-iteration numbers",
                     banded="nnz max/mean cut >= 2x, x within 1e-5 (f32) "
                            "/ 1e-10 (f64) of max|x|, counts within "
                            "max(2, 1 %), 4 launches a matvec",
                     shard_loss="the uninterrupted planned count within "
                                "max(2, 1 %)"),
         failed=failed, wall_seconds=time.perf_counter() - t_phase)
    if failed:
        raise AssertionError(f"plan_scope: {failed}")


OBS_SHARDS = 4           # the observatory phase's stacked shards
OBS_TIMED_ITERS = 200    # the iterations a profile's anchoring solve adds
OBS_SEQUENCE = 3         # solve_sequence's repeats on the banded system
OBS_SEGMENTS = 5         # the watchdog drill's segments (before migrating)
#: the environment variable of the measured-artifact cache directory
#: (``utils.tune.CACHE_DIR_ENV``); the phase points it at a temporary
#: directory and removes that at its end
CACHE_ENV = "CUDA_MPI_PARALLEL_TPU_CACHE_DIR"


def observatory_phase(pt, tpar, poisson, csr, gen, count_main_path, smi):
    """The rest of telemetry and the straggler watchdog over 4 stacked
    shards on the card (``telemetry.phasetrace``, ``calibrate``,
    ``report``, ``tracing``, ``slo``, ``fleet``, ``parallel.
    solve_sequence``, ``robust.StragglerWatchdog``), each part its own
    line:

    * ``observatory_profiles``: config #2's CSR (1024^2, f32) on the
      allgather, gather and ring lanes, each profiled by
      ``profile_distributed`` (16 repetitions a phase) and anchored to a
      200-iteration solve's wall (the difference of a 232- and a
      32-iteration solve, each the faster of two, so the host partition
      each call repeats cancels):
      every phase positive and finite, one link a gather round with the
      schedule's bytes, none on allgather and one rotation on the ring,
      the explained fraction inside the JAX unit bound (0.2, 3.0), and
      each profile's fit ``lstsq2``, confident, with its links;
    * ``observatory_sequence``: ``solve_sequence(repeats=3, plan="auto",
      csr_comm="ring-shiftell")`` on the banded skew system (B8, rtol
      1e-6, a JsonCache of its own): every solve converged, its count
      within max(2, 1 %) and its x within 1e-5 * max|x| of the unplanned
      solve's, 4 launches a matvec, one ``replan`` after each of the
      first two solves; then the gather profile's fit stored in the
      phase's cache steers a fresh ``plan="auto"``: it resolves the plan
      the search gives under that fit (``scored_by`` names it, or the
      even split);
    * ``observatory_reports``: a ``SolveReport`` (text and JSON) and a
      Perfetto trace of the streaming 256^3 solve with the flight
      recorder (B3/B4: flight, health, roofline), of the 4-slab 1024^2
      stencil solve (B1: shard report and comm account, modeled spans)
      and of the gather CSR solve (its phase profile, measured spans),
      each written to the phase's directory and accepted by
      ``validate_perfetto`` read back;
    * ``observatory_watchdog``: config #2's CSR resumable on 4 shards in
      about five segments with ``StragglerWatchdog(persist=False,
      profile_repeats=2)`` and the ``shard_slow:1:1`` drill: shard 1
      found degraded, the run migrated 4 -> 3 (``shard_degraded``) and
      converged to rtol 1e-6 with the clean count (max(2, 1 %)) and x
      within 1e-5 * max|x|; the same run with the watchdog and no fault:
      no finding, no migration, x bit-equal to the run without one;
    * ``observatory_host``: a ``RequestTrace`` per sequence solve (no
      orphan span, the rendered trees), an ``SLOTracker`` fed the walls
      of the banded system's four timed solves on the service clock with
      the budget one slow solve breaks (exactly one ``slo_burn``), and
      the ``REGISTRY`` snapshot merged as two replicas (every counter
      exactly doubled).

    The fits' "wire" here is ``StackedComm``'s copies in the card's
    memory, not NVLink or a network."""
    import shutil
    import tempfile

    import numpy as np

    from cuda_mpi_parallel_tpu_torch import telemetry
    from cuda_mpi_parallel_tpu_torch.balance import plan_partition
    from cuda_mpi_parallel_tpu_torch.models.skewed import banded_skew_coo
    from cuda_mpi_parallel_tpu_torch.parallel import dist_cg
    from cuda_mpi_parallel_tpu_torch.parallel import partition as part
    from cuda_mpi_parallel_tpu_torch.robust import (
        FaultPlan,
        StragglerWatchdog,
    )
    from cuda_mpi_parallel_tpu_torch.telemetry import calibrate as tcal
    from cuda_mpi_parallel_tpu_torch.telemetry import events, fleet
    from cuda_mpi_parallel_tpu_torch.telemetry import flight as tfl
    from cuda_mpi_parallel_tpu_torch.telemetry import health as thl
    from cuda_mpi_parallel_tpu_torch.telemetry import phasetrace
    from cuda_mpi_parallel_tpu_torch.telemetry import report as trep
    from cuda_mpi_parallel_tpu_torch.telemetry import roofline
    from cuda_mpi_parallel_tpu_torch.telemetry import shardscope as ss
    from cuda_mpi_parallel_tpu_torch.telemetry import slo, tracing
    from cuda_mpi_parallel_tpu_torch.utils import checkpoint as ck
    from cuda_mpi_parallel_tpu_torch.utils.logging import solve_record
    from cuda_mpi_parallel_tpu_torch.utils.tune import JsonCache

    t_phase = time.perf_counter()
    n_sh = OBS_SHARDS
    mesh = tpar.make_mesh(n_sh, devices=["cuda:0"] * n_sh)
    checks, walls = [], {}
    t_part = time.perf_counter()

    def lap(name):
        nonlocal t_part
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[name] = now - t_part
        t_part = now

    def captured(fn):
        with events.capture() as buf:
            res = fn()
        return res, [json.loads(line) for line in
                     buf.getvalue().splitlines() if line.strip()]

    def within(n, ref):
        return abs(n - ref) <= max(2, 0.01 * ref)

    def rel_err(x, ref):
        return float((x - ref).abs().max() / ref.abs().max())

    def finite_positive(*values):
        return all(math.isfinite(float(v)) and float(v) > 0
                   for v in values)

    tmp = tempfile.mkdtemp(prefix="observatory-")
    cache_before = os.environ.get(CACHE_ENV)
    os.environ[CACHE_ENV] = tmp
    try:
        # 1. phase profiles of config #2's three CSR lanes
        x_true = torch.randn(csr.n, generator=gen, device="cuda")
        bc = csr.matvec(x_true)
        pkw = dict(mesh=mesh, tol=0.0, check_every=32)
        lanes = {"allgather": dict(exchange="allgather"),
                 "gather": dict(exchange="gather"),
                 "ring": dict(csr_comm="ring")}
        profiles, fits, rows, solves = {}, {}, {}, {}
        def best_of_two(maxiter, kw):
            """The faster of two timed solves (each call repeats the
            host partition, whose first touch of fresh arrays is slow)."""
            runs = [count_main_path(lambda: timed_solve(
                lambda: tpar.solve_distributed(csr, bc, maxiter=maxiter,
                                               **pkw, **kw)))[0]
                    for _ in range(2)]
            return min(runs, key=lambda run: run[1])

        for lane, kw in lanes.items():
            _, t_lo = best_of_two(32, kw)
            hi, t_hi = best_of_two(32 + OBS_TIMED_ITERS, kw)
            solves[lane] = (hi, t_hi)
            t0 = time.perf_counter()
            p = phasetrace.profile_distributed(
                csr, mesh=mesh, solve_iterations=OBS_TIMED_ITERS,
                solve_elapsed_s=t_hi - t_lo, **kw)
            t_prof = time.perf_counter() - t0
            phasetrace.note_profile(p)
            fit = tcal.fit_machine_model(tcal.observations_from_profile(p),
                                         per_link=p.links)
            tcal.note_calibration(fit)
            profiles[lane], fits[lane] = p, fit
            rows[lane] = dict(
                profile=p.to_json(), profile_seconds=t_prof,
                solve_seconds=[t_lo, t_hi],
                explained_fraction=p.explained_fraction(),
                explained_fraction_vs_solve=p.explained_fraction_vs_solve(),
                fit=dict(method=fit.method, confident=fit.confident,
                         residual_rel=fit.residual_rel,
                         gather_slowdown=fit.model.gather_slowdown,
                         net_bytes_per_s=fit.model.net_bytes_per_s,
                         per_link=fit.model.per_link,
                         describe=fit.describe()))
            ef = p.explained_fraction()
            checks.extend([
                (finite_positive(*p.spmv_s, p.spmv_mesh_s, p.halo_s,
                                 p.reduction_s, p.step_s,
                                 *(lk["seconds"] for lk in p.links)),
                 f"profile {lane}: a phase time is not positive "
                 f"({p.to_json()})"),
                (0.2 < ef < 3.0, f"profile {lane}: explained {ef}"),
                (fit.method == "lstsq2" and fit.confident
                 and len(fit.model.per_link or ()) == len(p.links),
                 f"profile {lane}: fit {fit.describe()}")])
        sched = part.partition_csr(csr, n_sh, exchange="gather").halo
        glinks = profiles["gather"].links
        checks.extend([
            ([(lk["shift"], lk["bytes"]) for lk in glinks]
             == list(zip((r.shift for r in sched.rounds),
                         sched.round_wire_bytes(4))),
             f"profile gather: links {glinks} vs the schedule's rounds"),
            (profiles["allgather"].links == (),
             f"profile allgather: links {profiles['allgather'].links}"),
            ([(lk["shift"], lk["bytes"]) for lk in profiles["ring"].links]
             == [(1, profiles["ring"].n_local * 4)],
             f"profile ring: links {profiles['ring'].links}")])
        emit("observatory_profiles", card=smi, shards=n_sh,
             rows=csr.n, nnz=csr.nnz, repeats=phasetrace.DEFAULT_REPEATS,
             lanes=rows, gather_rounds=len(sched.rounds),
             wire="StackedComm's copies in the card's memory")
        lap("profiles")

        # 2. solve_sequence on the banded skew system (B8)
        skew = pt.CSRMatrix.from_coo(*banded_skew_coo(GRID_RES_2D[0],
                                                      BANDED_K),
                                     dtype=torch.float32)
        xs = torch.randn(skew.n, generator=gen, device="cuda")
        bs = skew.matvec(xs)
        skw = dict(mesh=mesh, tol=0.0, rtol=1e-6, maxiter=4000,
                   check_every=1, csr_comm="ring-shiftell")
        (even, t_even), seen_even = count_main_path(lambda: timed_solve(
            lambda: tpar.solve_distributed(skew, bs, **skw)))
        n_even = int(even.iterations)
        seq_cache = JsonCache(os.path.join(tmp, "sequence"))
        (seq, recs), seen_seq = count_main_path(lambda: captured(
            lambda: tpar.solve_sequence(
                skew, bs, repeats=OBS_SEQUENCE, plan="auto",
                calibration_cache=seq_cache, **skw)))
        replans = [r for r in recs if r["event"] == "replan"]
        entries = []
        for e in seq.entries:
            its = int(e.result.iterations)
            entries.append(dict(
                iterations=its, status=e.result.status_enum().name,
                seconds=e.elapsed_s, plan=e.plan.label if e.plan else
                "even", scored_by=e.plan.scored_by if e.plan else None,
                fingerprint=e.plan.fingerprint() if e.plan else None,
                x_rel_err=rel_err(e.result.x, even.x),
                fit=dict(method=e.fit.method, confident=e.fit.confident,
                         residual_rel=e.fit.residual_rel,
                         gather_slowdown=e.fit.model.gather_slowdown,
                         net_bytes_per_s=e.fit.model.net_bytes_per_s),
                drift_pct=e.drift.drift_pct, replan=e.replan))
            checks.extend([
                (e.result.status_enum() == pt.CGStatus.CONVERGED
                 and within(its, n_even),
                 f"sequence solve {e.index}: {entries[-1]['status']} at "
                 f"{its} vs {n_even}"),
                (entries[-1]["x_rel_err"] <= 1e-5,
                 f"sequence solve {e.index}: x err "
                 f"{entries[-1]['x_rel_err']}")])
        matvecs = 2 * sum(int(e.result.iterations) for e in seq.entries)
        checks.extend([
            (seen_seq == {"shift_ell_matvec": n_sh * matvecs},
             f"sequence: launches {seen_seq} for {matvecs} matvecs"),
            ([r["solve_index"] for r in replans] == [1, 2],
             f"sequence: replans {replans}")])
        # the gather profile's confident fit, stored, steers plan="auto":
        # it resolves the plan the search gives under that model (None
        # when that plan is the even split, the unplanned layout)
        model = fits["gather"].model
        stored = tcal.store_calibration(fits["gather"])
        preferred = tcal.preferred_model(skew.device)
        t0 = time.perf_counter()
        steered = dist_cg.resolve_plan("auto", skew, n_sh, exchange="ring")
        t_steer = time.perf_counter() - t0
        direct = dist_cg.resolve_plan(
            plan_partition(skew, n_sh, model=model, exchange="ring"), skew,
            n_sh, exchange="ring")

        def fingerprint(plan):
            return None if plan is None else plan.fingerprint()

        checks.append((
            stored is not None and preferred is not None
            and preferred.name == model.name
            and fingerprint(steered) == fingerprint(direct)
            and (steered is None or steered.scored_by == model.name),
            f"stored fit {model.name}: plan='auto' resolved "
            f"{fingerprint(steered)} scored by "
            f"{getattr(steered, 'scored_by', None)}, the fit's search "
            f"{fingerprint(direct)}"))
        emit("observatory_sequence", card=smi, shards=n_sh, rows=skew.n,
             nnz=skew.nnz, unplanned=dict(iterations=n_even,
                                          seconds=t_even,
                                          launches=seen_even),
             entries=entries, launches=seen_seq, replans=replans,
             steered_plan=dict(
                 label=getattr(steered, "label", "none+even"),
                 scored_by=getattr(steered, "scored_by", None),
                 fingerprint=fingerprint(steered), seconds=t_steer,
                 preferred_model=preferred.name if preferred else None,
                 reference_plan=fingerprint(seq.entries[0].plan)))
        lap("sequence")

        # 3. reports and Perfetto traces of three solves
        reports = {}

        def write(label, rep, trace, kind):
            stem = os.path.join(tmp, label)
            with open(stem + ".txt", "w") as f:
                f.write(rep.to_text())
            with open(stem + ".json", "w") as f:
                json.dump(rep.to_json(), f, allow_nan=False)
            trep.write_perfetto(stem + ".trace.json", trace)
            with open(stem + ".trace.json") as f:
                back = json.load(f)
            trep.validate_perfetto(back)
            text = rep.to_text()
            reports[label] = dict(
                text_lines=text.count("\n"),
                sections=[ln for ln in text.splitlines()
                          if ln.startswith("--")],
                json_keys=sorted(rep.to_json()),
                trace_events=len(back["traceEvents"]),
                span_source=back["metadata"]["span_source"])
            checks.append((back["metadata"]["span_source"] == kind,
                           f"{label}: span_source "
                           f"{back['metadata']['span_source']}"))

        op3 = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
        b3 = torch.randn(op3.n, generator=gen, device="cuda")
        cfg = tfl.FlightConfig.for_solve(4000)
        fkw = dict(engine="streaming", tol=0.0, rtol=1e-6, maxiter=4000,
                   check_every=32, flight=cfg)
        (res, t), seen = count_main_path(lambda: timed_solve(
            lambda: pt.solve(op3, b3, **fkw)))
        its = int(res.iterations)
        rec = tfl.FlightRecord.from_buffer(res.flight)
        health = thl.assess_solve_health(
            rec, converged=bool(res.converged), status=int(res.status),
            iterations=its)
        roof = roofline.analyze(n=op3.n, nnz=roofline.operator_nnz(op3),
                                itemsize=4, iterations=its, elapsed_s=t,
                                backend="cuda")
        write("streaming_256", trep.SolveReport(
            record=solve_record(res, elapsed_s=t, problem="poisson3d 256^3",
                                device="cuda", dtype="float32"),
            roofline=roof, flight_summary=rec.summary(),
            health=health.to_json(), sections=(("solve", t),)),
            trep.perfetto_trace(iterations=its, elapsed_s=t, n_shards=1,
                                flight_history=rec.to_history(4000),
                                sections=(("solve", t),),
                                label="streaming_256"), "modeled")
        reports["streaming_256"].update(launches=seen, iterations=its,
                                        health=health.to_json()["classification"],
                                        efficiency_pct=roof.efficiency_pct)
        checks.append((seen.get("fused_cg_pass_a") == its
                       and res.status_enum() == pt.CGStatus.CONVERGED,
                       f"streaming_256 report: {its} iterations, "
                       f"launches {seen}"))
        del op3, b3

        op1 = poisson.poisson_2d_operator(*GRID_RES_2D, backend="pallas")
        b1 = torch.randn(op1.n, generator=gen, device="cuda")
        dist_cg.clear_solver_cache()
        ss.reset_last_shard_report()
        dist_cg.reset_last_comm_cost()
        ((res, t), _), seen = count_main_path(lambda: captured(
            lambda: timed_solve(lambda: tpar.solve_distributed(
                op1, b1, mesh=mesh, tol=0.0, rtol=1e-6, maxiter=4000,
                check_every=32))))
        its = int(res.iterations)
        sc, ctx = dist_cg.last_comm_cost()
        totals = sc.totals(its)
        comm = {"psum": totals.psum, "ppermute": totals.ppermute,
                "all_gather": totals.all_gather,
                "comm_bytes": totals.comm_bytes,
                "wire_bytes": totals.wire_bytes,
                "per_iteration": sc.per_iteration.to_json(),
                "setup": sc.setup.to_json(), "kind": ctx.get("kind"),
                "n_shards": ctx.get("n_shards")}
        shard = ss.last_shard_report()
        write("stencil_1024_4slabs", trep.SolveReport(
            record=solve_record(res, elapsed_s=t, problem="poisson2d "
                                "1024^2", device="cuda", mesh=n_sh,
                                dtype="float32"),
            shard=shard, comm=comm, sections=(("solve", t),)),
            trep.perfetto_trace(iterations=its, elapsed_s=t, shard=shard,
                                sections=(("solve", t),),
                                label="stencil_1024"), "modeled")
        reports["stencil_1024_4slabs"].update(launches=seen,
                                              iterations=its, comm=comm)
        checks.append((seen.get("stencil2d_apply", 0) >= n_sh * its
                       and shard is not None and shard.n_shards == n_sh
                       and comm["ppermute"] > 0,
                       f"stencil report: launches {seen}, comm {comm}"))
        del op1, b1

        hi, t_hi = solves["gather"]
        write("csr_gather_1024", trep.SolveReport(
            record=solve_record(hi, elapsed_s=t_hi, problem="poisson2d "
                                "1024^2 csr", device="cuda", mesh=n_sh,
                                dtype="float32"),
            phase=profiles["gather"].to_json(),
            sections=(("solve", t_hi),)),
            trep.perfetto_trace(iterations=int(hi.iterations),
                                elapsed_s=t_hi,
                                phase_profile=profiles["gather"],
                                label="csr_gather"), "measured")
        emit("observatory_reports", card=smi, reports=reports,
             directory="a temporary directory, removed at the phase's end")
        lap("reports")

        # 4. the watchdog drill: shard_slow on config #2's CSR
        ekw = dict(mesh=mesh, tol=0.0, rtol=1e-6, maxiter=4000,
                   check_every=1)
        clean, _ = count_main_path(lambda: tpar.solve_distributed(
            csr, bc, **ekw))
        n_clean = int(clean.iterations)
        seg = -(-n_clean // OBS_SEGMENTS)
        drill = {}
        for label, wd_on, fault in (("drill", True, "shard_slow:1:1"),
                                    ("watchdog_clean", True, None),
                                    ("no_watchdog", False, None)):
            wd = StragglerWatchdog(persist=False, profile_repeats=2) \
                if wd_on else None
            extra = {} if fault is None \
                else {"inject": FaultPlan.parse(fault)}
            t0 = time.perf_counter()
            (res, recs), seen = count_main_path(lambda: captured(
                lambda: ck.solve_resumable_distributed(
                    csr, bc, os.path.join(tmp, label + ".npz"),
                    segment_iters=seg, elastic=True, watchdog=wd, **extra,
                    **ekw)))
            drill[label] = dict(
                res=res, seconds=time.perf_counter() - t0,
                iterations=int(res.iterations),
                status=res.status_enum().name,
                degraded=[r for r in recs
                          if r["event"] == "shard_degraded"],
                migrations=[r for r in recs
                            if r["event"] == "solve_migration"],
                x_rel_err=rel_err(res.x, clean.x), launches=seen)
        d, c, p0 = (drill[k] for k in ("drill", "watchdog_clean",
                                       "no_watchdog"))
        checks.extend([
            (d["degraded"] and d["degraded"][0]["shard"] == 1
             and d["degraded"][0]["phase"] == "spmv",
             f"drill: findings {d['degraded']}"),
            (d["migrations"] and d["migrations"][0]["reason"]
             == "shard_degraded" and d["migrations"][0]["n_shards_to"] == 3,
             f"drill: migrations {d['migrations']}"),
            (d["status"] == "CONVERGED"
             and within(d["iterations"], n_clean)
             and d["x_rel_err"] <= 1e-5,
             f"drill: {d['status']} at {d['iterations']} vs {n_clean}, "
             f"x err {d['x_rel_err']}"),
            (not c["degraded"] and not c["migrations"]
             and same_bits((c["res"].x,), (p0["res"].x,)),
             f"watchdog without a fault: findings {c['degraded']}, "
             f"migrations {c['migrations']}")])
        emit("observatory_watchdog", card=smi, shards=n_sh,
             clean_iterations=n_clean, segment_iters=seg,
             **{k: {f: v for f, v in row.items() if f != "res"}
                for k, row in drill.items()},
             bit_equal_without_watchdog=same_bits((c["res"].x,),
                                                  (p0["res"].x,)))
        del drill, clean
        lap("watchdog")

        # 5. request traces, the SLO burn and the fleet merge
        clock = 0.0
        with events.capture() as buf:
            for e in seq.entries:
                tr = tracing.RequestTrace(f"sequence-{e.index}")
                tr.span("submit", start_s=clock, duration_s=0.0, root=True)
                tr.span("solve", start_s=clock, duration_s=e.elapsed_s,
                        solve_id=e.index, attempt=0)
                clock += e.elapsed_s
                tr.span("result", start_s=clock, duration_s=0.0,
                        status=e.result.status_enum().name)
        spans = [json.loads(line) for line in buf.getvalue().splitlines()
                 if line.strip()]
        orphans = tracing.orphan_spans(spans)
        trees = [tracing.render_tree(spans, tid)
                 for tid in dict.fromkeys(s["trace_id"] for s in spans)]
        solve_walls = [t_even] + [e.elapsed_s for e in seq.entries]
        target = sorted(solve_walls)[-2]
        tracker = slo.SLOTracker(slo.SLOConfig(
            windows=(slo.SLOWindow("hour", 3600.0, 1.0),),
            budget=1.0 / len(solve_walls), min_samples=len(solve_walls)))
        clock = 0.0
        with events.capture() as buf:
            for wall in solve_walls:
                clock += wall
                tracker.observe("chip", "banded", clock, wall <= target)
        burns = [json.loads(line) for line in buf.getvalue().splitlines()
                 if line.strip()]
        snap = telemetry.REGISTRY.snapshot()
        merged = fleet.merge_snapshots({"replica-a": snap,
                                        "replica-b": snap})
        doubled = [
            all(any(m["labels"] == s["labels"]
                    and m["value"] == 2 * s["value"]
                    for m in merged[name]["series"])
                for s in entry["series"])
            for name, entry in snap.items() if entry["kind"] == "counter"]
        checks.extend([
            (spans and orphans == [] and len(trees) == len(seq.entries),
             f"request traces: {len(orphans)} orphans"),
            (len(burns) == 1 and burns[0]["event"] == "slo_burn",
             f"slo: burns {burns}"),
            (doubled and all(doubled),
             f"fleet: {doubled.count(False)} counters not doubled")])
        emit("observatory_host", card=smi, spans=len(spans),
             orphans=len(orphans), trees=trees, slo_target_s=target,
             slo_walls=solve_walls, slo_burns=burns,
             slo_snapshot=tracker.snapshot(clock),
             counters_merged=len(doubled))
        lap("host")
    finally:
        if cache_before is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = cache_before
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [msg for ok, msg in checks if not ok]
    wall = time.perf_counter() - t_phase
    emit("observatory", card=smi, part_seconds=walls, wall_seconds=wall,
         budget_seconds=90.0, failed=failed,
         limits=dict(profiles="phases positive and finite; explained "
                              "fraction in (0.2, 3.0); fits lstsq2 and "
                              "confident",
                     sequence="counts within max(2, 1 %), x within 1e-5 "
                              "* max|x| of the unplanned solve; 4 "
                              "launches a matvec; a replan after solves "
                              "1 and 2",
                     watchdog="shard 1 degraded, 4 -> 3, the clean count "
                              "within max(2, 1 %), x within 1e-5; no "
                              "fault: no finding, x bit-equal",
                     host="no orphan span; one slo_burn; counters "
                          "doubled"))
    if failed:
        raise AssertionError(f"observatory: {failed}")


def timed_solve(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cuda_mpi_parallel_tpu_torch as pt
    from cuda_mpi_parallel_tpu_torch.models import poisson
    from cuda_mpi_parallel_tpu_torch.ops import cuda as hk
    from cuda_mpi_parallel_tpu_torch.ops.cuda import resident_dist as rd

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         count=torch.cuda.device_count())
    if cap[0] != 9:
        raise RuntimeError(f"{name} has capability {cap}, not 9.x")
    # the part's published peaks (telemetry.roofline's table): HBM bytes/s,
    # float32 and float64 FLOP/s outside the tensor cores
    from cuda_mpi_parallel_tpu_torch.telemetry import roofline

    peak = roofline.published_peaks(name)[:3]

    # 2. build
    t0 = time.perf_counter()
    info = hk.build_info()
    resources = ptxas_resources(info.pop("ptxas"))
    march = {p: {k: v for k, v in resources.items() if k.startswith(p)}
             for p in ("pass_a_", "pass_b_")}
    # B12's four instances: ptxas's numbers and the CTAs per SM its launch
    # takes (B10's: the one-shard bit check needs B10's grid)
    dist = {f"f32_{d}_{kind}_dist": dict(
        resources.pop(f"f32_{d}_{kind}_dist", {}),
        blocks_per_sm=rd.blocks_per_sm(d == "3d", kind == "cheb"))
        for d in ("2d", "3d") for kind in ("plain", "cheb")}
    # B12's body in double, on which B11 runs at one shard
    b11_body = {f"{d}_{kind}": resources.pop(f"f64_{d}_{kind}_dist", {})
                for d in ("2d", "3d") for kind in ("plain", "cheb")}
    registers = {k: v for k, v in resources.items()
                 if not k.startswith(tuple(march))}
    # the instances B10's f32 launches take: B12's body at one shard for
    # the grids whose tiles fit its slots (1024^2, 128^3), the tile walk
    # past them, each with ptxas's numbers and its CTAs per SM
    b10 = {f"{body}_{d}_{kind}": dict(
        registers.get(f"f32_{d}_{kind}", {}) if body == "tile_walk"
        else {k: v for k, v in dist[f"f32_{d}_{kind}_dist"].items()
              if k != "blocks_per_sm"},
        blocks_per_sm=resident_blocks_per_sm(
            hk, d == "3d", kind == "cheb", tile_walk=body == "tile_walk"))
        for body in ("b12", "tile_walk") for d in ("2d", "3d")
        for kind in ("plain", "cheb")}
    # and those its cg1 form launches: the one-barrier body on B12's
    # machinery for the same grids, the tile walk past them
    b10_cg1 = {f"{body}_{d}": dict(
        registers.get(f"f32_{d}_cg1" + ("" if body == "tile_walk"
                                        else "_one_barrier"), {}),
        blocks_per_sm=resident_blocks_per_sm(
            hk, d == "3d", False, cg1=True, tile_walk=body == "tile_walk"))
        for body in ("one_barrier", "tile_walk") for d in ("2d", "3d")}
    # and those B11's f64 launches take: B12's body in double for the
    # grids whose tiles fit its slots (1024^2, 768 x 1024, 109^3), the
    # tile walk past them; the body keeps the tile walk's grid, so its
    # bits, only at the tile walk's two CTAs per SM
    b11 = {f"{body}_{d}_{kind}": dict(
        registers.get(f"f64_{d}_{kind}", {}) if body == "tile_walk"
        else b11_body[f"{d}_{kind}"],
        blocks_per_sm=resident_blocks_per_sm(
            hk, d == "3d", kind == "cheb", f64=True,
            tile_walk=body == "tile_walk"))
        for body in ("b12", "tile_walk") for d in ("2d", "3d")
        for kind in ("plain", "cheb")}
    emit("build", seconds=time.perf_counter() - t0, **info,
         resident_registers=registers, resident_dist_resources=dist,
         b10_instances=b10, b10_cg1_instances=b10_cg1, b11_instances=b11,
         pass_a_resources=march["pass_a_"],
         pass_b_resources=march["pass_b_"])
    occupancy = {k: v["blocks_per_sm"] for k, v in b11.items()}
    if set(occupancy.values()) != {2}:
        raise AssertionError(f"B11's instances must run two CTAs per SM "
                             f"(the tile walk's grid), got {occupancy}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    # BASELINE config #2 as assembled CSR (host numpy assembly and packing)
    csr = poisson.poisson_2d_csr(*GRID_RES_2D, dtype=torch.float32)
    sell = csr.to_shiftell()
    csr64 = poisson.poisson_2d_csr(*GRID_RES_2D, dtype=torch.float64)
    sell64 = csr64.to_shiftell_df64()

    # 3. kernels against their twins, timed
    rows = kernels_phase(hk, pt, peak, gen, csr, sell, csr64, sell64)
    # its own stream of inputs, so the main path's inputs do not depend on it
    ragged_phase(hk, pt, poisson,
                 torch.Generator("cuda").manual_seed(SEED + 1))
    launches = {k: 0 for k in rows}

    def count_main_path(fn):
        """Run ``fn`` (a port solve) with fresh counts; add them up."""
        hk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        seen = dict(hk.LAUNCHES)
        for k, v in seen.items():
            launches[k] += v
        hk.reset_launches()
        return out, seen

    def plain_reference(fn):
        """Run a reference solve; it must launch no hand kernel."""
        hk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if sum(hk.LAUNCHES.values()):
            raise AssertionError(f"reference launched {dict(hk.LAUNCHES)}")
        return out

    # 4. oracle: the reference's 3x3 system in f64, through solve() and
    # through the f64 lane's cg_df64
    a, b, x_exp = poisson.oracle_system(dtype=torch.float64)
    res = pt.solve(a, b, engine="general")
    x_err = float((res.x.cpu() - torch.as_tensor(x_exp)).abs().max())
    res64 = pt.cg_df64(a, b)
    x_err64 = float(abs(res64.x() - x_exp).max())
    emit("oracle", iterations=int(res.iterations), max_abs_err=x_err,
         indefinite=bool(res.indefinite), status=res.status_enum().name,
         cg_df64_iterations=int(res64.iterations),
         cg_df64_max_abs_err=x_err64,
         cg_df64_indefinite=bool(res64.indefinite),
         cg_df64_status=res64.status_enum().name)
    if int(res.iterations) != 3 or not x_err <= 1e-12 \
            or not bool(res.indefinite):
        raise AssertionError("oracle: expected 3 iterations, x within "
                             "1e-12 and indefinite=True")
    if int(res64.iterations) != 3 or not x_err64 <= 1e-12 \
            or res64.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("oracle: cg_df64 expected 3 iterations, "
                             "converged, x within 1e-12")

    # 5. general engine at 256^3 on the stencil kernel (B2)
    op = poisson.poisson_3d_operator(*GRID_3D, backend="pallas")
    op_xla = poisson.poisson_3d_operator(*GRID_3D, backend="xla")
    b3 = torch.randn(op.n, generator=gen, device="cuda")
    kw = dict(tol=0.0, maxiter=200, check_every=32, engine="general")
    pt.solve(op, b3, **dict(kw, maxiter=32))                  # warm-up
    (res, t), seen = count_main_path(
        lambda: timed_solve(lambda: pt.solve(op, b3, **kw)))
    ref = plain_reference(lambda: pt.solve(op_xla, b3, **kw))
    rel = abs(float(res.residual_norm) - float(ref.residual_norm)) \
        / float(ref.residual_norm)
    emit("general_256", iterations=int(res.iterations), seconds=t,
         iters_per_s=int(res.iterations) / t, launches=seen,
         residual_norm=float(res.residual_norm),
         plain_residual_norm=float(ref.residual_norm), rel_diff=rel)
    if seen.get("stencil3d_apply", 0) < 200 or not rel <= 1e-3:
        raise AssertionError("general_256: expected >= 200 stencil "
                             "launches and residuals within 1e-3")

    # 6. streaming engine at 256^3 to rtol 1e-6 (B3/B4), b = A x_true
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b3 = op_xla.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000)
    pt.solve(op, b3, engine="streaming", check_every=32, maxiter=64)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b3, engine="streaming", check_every=32, **skw)))
    its = int(res.iterations)
    op64 = poisson.poisson_3d_operator(*GRID_3D, dtype=torch.float64)
    true_rel = float((b3.double() - op64.matvec(res.x.double())).norm()
                     / b3.double().norm())
    exact = pt.solve(op, b3, engine="streaming", check_every=1, **skw)
    ref = plain_reference(lambda: pt.solve(op_xla, b3, engine="general",
                                           check_every=1, **skw))
    (auto, _), auto_seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op, b3, engine="auto", check_every=32, **skw)))
    plain_256_iterations = its
    emit("streaming_256", iterations=its, seconds_to_1e6=t,
         iters_per_s=its / t, launches=seen, status=res.status_enum().name,
         true_rel_residual_f64=true_rel,
         iterations_check_every_1=int(exact.iterations),
         plain_general_iterations=int(ref.iterations),
         plain_general_status=ref.status_enum().name,
         auto_launches=auto_seen)
    n_exact, n_ref = int(exact.iterations), int(ref.iterations)
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("streaming_256: both solves must converge")
    if abs(n_exact - n_ref) > max(2, 0.01 * n_ref):
        raise AssertionError(f"streaming_256: {n_exact} vs {n_ref} "
                             f"iterations")
    if not (seen.get("fused_cg_pass_a") == seen.get("fused_cg_pass_b")
            == its):
        raise AssertionError("streaming_256: pass launches != iterations")
    if auto_seen.get("fused_cg_pass_a") != int(auto.iterations) \
            or auto_seen.get("cg_resident", 0):
        raise AssertionError("streaming_256: engine='auto' did not take "
                             "the streaming engine")
    if not true_rel <= 2e-6:
        raise AssertionError(f"streaming_256: true residual {true_rel}")

    # 7. streaming engine at 4096^2 with a warm start (B1 at init, B3/B4)
    op2 = poisson.poisson_2d_operator(*GRID_2D, backend="pallas")
    op2_xla = poisson.poisson_2d_operator(*GRID_2D, backend="xla")
    b2 = torch.randn(op2.n, generator=gen, device="cuda")
    x0 = torch.randn(op2.n, generator=gen, device="cuda")
    kw2 = dict(tol=0.0, maxiter=200, check_every=32)
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(op2, b2, x0, engine="streaming", **kw2)))
    ref = plain_reference(lambda: pt.solve(op2_xla, b2, x0, engine="general",
                                           **kw2))
    rel = abs(float(res.residual_norm) - float(ref.residual_norm)) \
        / float(ref.residual_norm)
    # 4096^2 fails the resident gate: auto takes streaming
    _, auto_seen = count_main_path(lambda: pt.solve(
        op2, b2, engine="auto", tol=0.0, maxiter=32, check_every=32))
    emit("streaming_2d", iterations=int(res.iterations), seconds=t,
         iters_per_s=int(res.iterations) / t, launches=seen,
         residual_norm=float(res.residual_norm),
         plain_residual_norm=float(ref.residual_norm), rel_diff=rel,
         auto_launches=auto_seen)
    if not rel <= 1e-3 or seen.get("stencil2d_apply") != 1:
        raise AssertionError("streaming_2d: residuals differ or the "
                             "warm-start init missed the 2D stencil")
    if auto_seen.get("fused_cg_pass_a") != 32 \
            or auto_seen.get("cg_resident", 0):
        raise AssertionError("streaming_2d: engine='auto' did not take "
                             "the streaming engine")

    # 8. / 9. the resident engine at 1024^2 (BASELINE config #2) and 128^3
    for label, grid in (("resident_1024", GRID_RES_2D),
                        ("resident_128", GRID_RES_3D)):
        resident_phase(label, grid, pt, poisson, gen, count_main_path,
                       plain_reference)

    # 10. config #2 as assembled CSR on the hand SpMV (B8)
    x_true = torch.randn(csr.n, generator=gen, device="cuda")
    bc = csr.matvec(x_true)
    ckw = dict(rtol=1e-6, maxiter=4000, engine="general")
    pt.solve(sell, bc, **dict(ckw, maxiter=32))                  # warm-up
    (res, t), seen = count_main_path(lambda: timed_solve(
        lambda: pt.solve(sell, bc, **ckw)))
    ref = plain_reference(lambda: pt.solve(csr, bc, **ckw))
    its, ref_its = int(res.iterations), int(ref.iterations)
    rel = abs(float(res.residual_norm) - float(ref.residual_norm)) \
        / float(ref.residual_norm)
    emit("csr_1024", rows=csr.n, nnz=csr.nnz, iterations=its, seconds=t,
         iters_per_s=its / t, us_per_iteration=t * 1e6 / its, launches=seen,
         status=res.status_enum().name, residual_norm=float(res.residual_norm),
         plain_csr_iterations=ref_its,
         plain_residual_norm=float(ref.residual_norm), rel_diff=rel)
    if res.status_enum() != pt.CGStatus.CONVERGED \
            or ref.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("csr_1024: both solves must converge")
    if seen.get("shift_ell_matvec") != its or not rel <= 1e-3:
        raise AssertionError("csr_1024: expected one SpMV launch per "
                             "iteration and residuals within 1e-3")

    # 11. - 13. the preconditioned solves
    cheb_streaming_phase(pt, op, op_xla, b3, count_main_path,
                         plain_reference, plain_256_iterations)
    cheb_resident_phase(pt, poisson, gen, count_main_path, plain_reference)
    fem = jacobi_fem_phase(pt, gen, count_main_path, plain_reference)

    # 14. - 17. the f64 lane at rtol 1e-10
    streaming_df64_phase(pt, poisson, gen, count_main_path, plain_reference)
    resident_df64_phase(pt, poisson, gen, count_main_path, plain_reference,
                        "resident_df64_1024", GRID_RES_2D, 0)
    resident_df64_phase(pt, poisson, gen, count_main_path, plain_reference,
                        "cheb_resident_df64", GRID_CHEB_F64, CHEB_DEGREE)
    systems = csr_df64_phase(pt, csr64, sell64, fem, gen, count_main_path,
                             plain_reference)

    # 18. - 23. the single-reduction and pipelined methods, compensated
    # dots and checkpoint/resume
    for label, grid in (("resident_cg1_1024", GRID_RES_2D),
                        ("resident_cg1_128", GRID_RES_3D)):
        resident_phase(label, grid, pt, poisson, gen, count_main_path,
                       plain_reference, method="cg1")
    general_variants_phase(pt, poisson, gen, count_main_path,
                           plain_reference)
    compensated_phase(pt, poisson, gen, count_main_path)
    checkpoint_phase(pt, poisson, gen, count_main_path)
    df64_variants_phase(pt, systems, gen, count_main_path)

    # 24. - 28. the distributed solve: P shards of a stacked mesh on the
    # card (and one NCCL rank)
    from cuda_mpi_parallel_tpu_torch import parallel as tpar

    dist_stencil_phase(pt, tpar, poisson, gen, count_main_path,
                       plain_reference)
    dist_streaming_phase(pt, tpar, poisson, gen, count_main_path)
    dist_csr_phase(pt, tpar, csr, gen, count_main_path, plain_reference)
    resident_dist_phase("resident_dist_1024", GRID_RES_2D, pt, tpar, poisson,
                        gen, count_main_path, (0, CHEB_DEGREE))
    resident_dist_phase("resident_dist_128", GRID_RES_3D, pt, tpar, poisson,
                        gen, count_main_path, (0,))

    # 29. - 32. MINRES (the symmetric-indefinite solver) on B1/B2, B8 and
    # B9, and the ELL/DIA formats and RCM reordering
    minres_oracle_phase(pt, poisson, count_main_path)
    minres_256_phase(pt, poisson, gen, count_main_path, plain_reference)
    minres_indefinite_phase(pt, csr64, gen, count_main_path, plain_reference)
    formats_phase(pt, csr, fem, gen, count_main_path, plain_reference)

    # 33. the telemetry core: the flight recorder on B3/B4, B2 and B12,
    # solve()'s events and the solve health
    flight_256_phase(pt, tpar, poisson, gen, count_main_path)

    # 34. the multigrid preconditioner (MG-PCG) on B2 and B1, in the f64
    # lane and on stacked slabs
    mg_256_phase(pt, tpar, poisson, gen, count_main_path, plain_reference,
                 smi)

    # 35. the distributed f64 lane: B6/B7 with halos, the f64 B1/B2 on
    # slabs, the f32 V-cycle, over 4 stacked shards
    dist_df64_256_phase(pt, tpar, poisson, gen, count_main_path,
                        plain_reference, smi)

    # 36. the ring shift-ELL lanes: each ring step's slabs one launch of
    # B8 (f32) or B9 (the f64 lane), over 4 stacked shards
    dist_shiftell_phase(pt, tpar, csr, csr64, fem, gen, count_main_path,
                        plain_reference, smi, rows, peak[0])

    # 37. the pencil decomposition: 256^3 on (4, 2) pencils of a stacked
    # 2-D mesh in f32 and f64 (no hand kernel: the matvec is plain torch),
    # and one NCCL rank through parallel.multihost
    pencil_256_phase(pt, tpar, poisson, gen, count_main_path,
                     plain_reference, smi)

    # 38. checkpoint, resume and elastic migration: solve_resumable on B2
    # and B1, the f64 lane's replay on B11 and its general lane from disk,
    # a 4 -> 2 shard migration of config #2's CSR
    resumable_phase(pt, tpar, poisson, csr, gen, count_main_path, smi)

    # 39. the many-RHS tier and Krylov recycling: solve_many on the
    # column-stack B1/B2 instances, config #2's CSR batched and over 4
    # stacked shards, recycled_sequence and a deflated distributed solve
    many_rhs_phase(pt, tpar, poisson, csr, gen, count_main_path,
                   plain_reference, smi)

    # 40. fault injection, recovery and validation: drills on B1, B8 and
    # B2, and over 4 stacked shards on config #2's CSR (the batched lane
    # and the shard_loss migration too)
    robust_phase(pt, tpar, poisson, csr, sell, gen, count_main_path, smi)

    # 41. the machine model, the roofline verdict, the comm-layer cost
    # account and the autotuner (B1, B3/B4, B8, B10)
    roofline_tune_phase(pt, tpar, poisson, csr, gen, count_main_path, smi,
                        rows)

    # 42. device-memory and per-shard accounting and the partition
    # planner: config #2's lanes, the comm gauges (B1), the budget gate,
    # plan="auto" on the banded skew system (B8, B9) and its migration
    plan_scope_phase(pt, tpar, poisson, csr, gen, count_main_path, smi)

    # 43. the rest of telemetry and the straggler watchdog: phase
    # profiles and calibration of config #2's CSR lanes, solve_sequence
    # on the banded skew system (B8), solve reports and Perfetto traces
    # (B3/B4, B1), the shard_slow drill, request traces, the SLO burn and
    # the fleet merge
    observatory_phase(pt, tpar, poisson, csr, gen, count_main_path, smi)

    # 44. the summary
    sources = {"stencil2d_apply": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "stencil.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "stencil.py:200"),
               "stencil3d_apply": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "stencil.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "stencil.py:328"),
               # the vmapped call of the JAX LinearOperator.matmat
               "stencil2d_apply_cols": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                        "stencil.cu",
                                        "cuda_mpi_parallel_tpu/ops/pallas/"
                                        "stencil.py:200"),
               "stencil3d_apply_cols": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                        "stencil.cu",
                                        "cuda_mpi_parallel_tpu/ops/pallas/"
                                        "stencil.py:328"),
               "fused_cg_pass_a": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "fused_cg.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "fused_cg.py:265"),
               "fused_cg_pass_b": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "fused_cg.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "fused_cg.py:331"),
               "cg_resident": ("cuda_mpi_parallel_tpu_torch/csrc/resident.cu",
                               "cuda_mpi_parallel_tpu/ops/pallas/"
                               "resident.py:560"),
               "cg_resident_cg1": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "resident.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "resident.py:451"),
               "shift_ell_matvec": ("cuda_mpi_parallel_tpu_torch/csrc/spmv.cu",
                                    "cuda_mpi_parallel_tpu/ops/pallas/"
                                    "spmv.py:301"),
               "fused_cheb_step": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "fused_cg.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "fused_cg.py:489"),
               "fused_cg_pass_a_df64": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                        "fused_cg.cu",
                                        "cuda_mpi_parallel_tpu/ops/pallas/"
                                        "fused_cg.py:784"),
               "fused_cg_pass_b_df64": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                        "fused_cg.cu",
                                        "cuda_mpi_parallel_tpu/ops/pallas/"
                                        "fused_cg.py:843"),
               "shift_ell_matvec_df64": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                         "spmv.cu",
                                         "cuda_mpi_parallel_tpu/ops/pallas/"
                                         "spmv.py:464"),
               "cg_resident_df64": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                    "resident.cu",
                                    "cuda_mpi_parallel_tpu/ops/pallas/"
                                    "resident.py:1086"),
               "cg_resident_dist_local": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                          "resident_dist.cu",
                                          "cuda_mpi_parallel_tpu/ops/pallas/"
                                          "resident_dist.py:378")}
    # the resident kernels' ptxas registers (by build-line key) and
    # occupancy beside their entries
    summary = []
    for k, row in rows.items():
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
        extra = {}
        if k in ("cg_resident", "cg_resident_cg1", "cg_resident_df64"):
            extra = dict(registers={"cg_resident": b10,
                                    "cg_resident_cg1": b10_cg1,
                                    "cg_resident_df64": b11}[k],
                         blocks_per_sm=row["blocks_per_sm"],
                         blocks_per_sm_tile_walk=row[
                             "blocks_per_sm_tile_walk"],
                         x_sha256=row["x_sha256"])
        if k == "cg_resident_dist_local":
            extra = dict(registers=dist, blocks_per_sm=row["blocks_per_sm"])
        if k in ("fused_cg_pass_a", "fused_cg_pass_b"):
            extra = dict(registers=march[k[-6:] + "_"])
        if k in ("shift_ell_matvec", "shift_ell_matvec_df64"):
            extra = dict(ring_step_slab=row["ring_step_slab"])
        if k in ("stencil2d_apply_cols", "stencil3d_apply_cols"):
            extra = dict(shape=row["shape"],
                         bit_equal_single_launches=row[
                             "bit_equal_single_launches"],
                         ms_k_single_launches=row["ms_k_single_launches"],
                         library=row["library"],
                         library_tf32=row["library_tf32"])
        summary.append(dict(
            name=k, route="cuda", source=sources[k][0],
            replaces=sources[k][1], launches=launches[k],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            **extra))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
