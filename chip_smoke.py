"""Drive the PyTorch/CUDA port's main path on one Hopper card.

    python3 chip_smoke.py

Builds the hand kernels from ``cuda_mpi_parallel_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch twin at the main path's
shapes, then solves through ``solve()``: the north-star problem - 3D
Poisson at 256^3 - and its 2D sibling (4096^2, the same 16.8 M cells) on
the general and streaming engines; 2D Poisson at 1024^2 (BASELINE config
#2) and 3D at 128^3 on the one-launch resident engine; and config #2 as
its assembled CSR (1,048,576 rows, 5,238,784 nonzeros) on the hand SpMV.
Each phase prints one JSON line; any failure raises and the process
exits non-zero.  The last three lines are the card's name and power
limit as ``nvidia-smi`` prints them, the ``{"kernels": [...]}`` summary,
and ``{"ok": true, "device": {...}}``.

Launch counts: every kernel wrapper counts its launches; a main-path
phase resets the counts just before its port solve and reads them just
after, and the kernels line sums those readings.  The launches made to
compare a kernel with its twin, and to time it, are not counted.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

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
TIMED = 25           # timed launches per kernel (median reported)

# Published peaks of the H100 parts (NVIDIA data sheets): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no published peaks for {name!r}")


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


def check_scalar(name, got, want) -> float:
    rel = abs(float(got) - float(want)) / abs(float(want))
    if not rel <= SCALAR_TOL:
        raise AssertionError(f"{name}: relative error {rel} > {SCALAR_TOL}")
    return rel


def bound(n_bytes: float, n_ops: float, bw: float, flops: float):
    t_bytes, t_ops = n_bytes / bw, n_ops / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernels_phase(hk, bw, flops, gen, csr, sell):
    """The kernels against their twins at the main path's shapes, and
    timed: B1-B4, B10 (``cg_resident``) and B8 (``shift_ell_matvec``)."""
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
        w = torch.zeros((3,) * ndim, device="cuda")
        centre = (1,) * ndim
        w[centre] = 2.0 * ndim
        for axis in range(ndim):
            for off in (0, 2):
                idx = list(centre)
                idx[axis] = off
                w[tuple(idx)] = -1.0
        w = (w * scale)[None, None]
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
        b_err = max(check_array("fused_cg_pass_b x", xk, xp),
                    check_array("fused_cg_pass_b r", rk, rp))
        b_rel = check_scalar("fused_cg_pass_b rr", rr_k, rr_p)
        # theta and with_rz: checked, not on this slice's main path
        theta = torch.tensor(1.7, device="cuda")
        check_array("fused_cg_pass_a p_new (theta)",
                    hk.fused_cg_pass_a(scale, beta, r, p, theta=theta)[0],
                    hk.fused_cg_pass_a_plain(scale, beta, r, p,
                                             theta=theta)[0])
        _, _, rr2, rz2 = hk.fused_cg_pass_b(scale, alpha, pn_p, x.clone(),
                                            r.clone(), theta=1.7,
                                            with_rz=True)
        _, _, _, rz2_p = hk.fused_cg_pass_b_plain(scale, alpha, pn_p,
                                                  x.clone(), r.clone(),
                                                  theta=1.7, with_rz=True)
        check_scalar("fused_cg_pass_b rz", rz2, rz2_p)
        check_scalar("fused_cg_pass_b rr (with_rz)", rr2, rr_p)
        if grid != GRID_3D:
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
            plain_ms=time_ms(lambda: hk.fused_cg_pass_b_plain(
                scale, alpha, pn_p, xt, rt)),
            library_ms=None, bytes=5 * cells * 4 + 8 + 4,
            ops=14 * cells)
    # B10 at 1024^2 (timed) and at 128^3, where each block walks several
    # tiles; the 3D rhs comes from its own stream, so the main path's
    # inputs do not depend on it
    b3 = torch.randn(GRID_RES_3D, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(SEED + 2))
    rows["cg_resident"] = resident_row(hk, scale, randn(GRID_RES_2D), b3)
    rows["shift_ell_matvec"] = spmv_row(hk, csr, sell, randn(csr.n))
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"],
                                                 bw, flops)
    emit("kernels", array_tol=ARRAY_TOL, scalar_tol=SCALAR_TOL,
         timed_launches=TIMED, kernels=rows)
    return rows


def check_resident(hk, name, scale, b, x0=None, **kw):
    """The resident kernel against its twin on ``b``: equal iteration
    counts and flags, x within RESIDENT_TOL, rr and the ||r||^2 trace
    within TRACE_TOL (-1 in the same blocks), and the same bits from a
    second launch.  Returns (max|dx|, x and trace relative errors, kernel
    outputs)."""
    fn = hk.cg_resident_2d if b.ndim == 2 else hk.cg_resident_3d
    got = fn(scale, b, x0=x0, **kw)
    again = fn(scale, b, x0=x0, **kw)
    if not all(torch.equal(u.view(torch.int32), v.view(torch.int32))
               for u, v in zip(got, again)):             # bits, NaNs too
        raise AssertionError(f"{name}: two launches differ")
    nblocks = -(-kw["maxiter"] // kw["check_every"])
    want = hk.cg_resident_plain(scale, b, x0, tol=kw.get("tol", 0.0),
                                rtol=kw.get("rtol", 0.0), cap=kw["maxiter"],
                                nblocks=nblocks,
                                check_every=kw["check_every"])
    flags = [int(v) for v in (got[1], *got[3:6])]
    if flags != [int(v) for v in (want[1], *want[3:6])] \
            or got[6].shape != want[6].shape:
        raise AssertionError(f"{name}: iterations/flags {flags} differ "
                             f"from the twin's")
    err = max_err(got[0], want[0])
    x_rel = err / float(want[0].abs().max())
    if not x_rel <= RESIDENT_TOL:
        raise AssertionError(f"{name}: max|dx| {err} = {x_rel} * max|x|")
    ran = want[6] != -1.0
    if not torch.equal(got[6] != -1.0, ran):
        raise AssertionError(f"{name}: the trace's blocks that ran differ")
    trace = torch.cat([got[2].reshape(1), got[6][ran]]).double()
    ref = torch.cat([want[2].reshape(1), want[6][ran]]).double()
    gap = (trace - ref).abs()
    if not bool((gap <= TRACE_TOL * ref.abs()).all()):
        raise AssertionError(f"{name}: rr or the trace differ from the "
                             f"twin's: {trace.tolist()} vs {ref.tolist()}")
    trace_rel = float((gap / ref.abs().clamp_min(1e-30)).max())
    return err, x_rel, trace_rel, got


def resident_row(hk, scale, b, b3):
    """B10 at 1024^2 and at 128^3: a fixed-length solve (200 iterations,
    check blocks of 32) against its twin, timed per launch."""
    err, x_rel, trace_rel, got = check_resident(hk, "cg_resident", scale, b,
                                                **RESIDENT_KW)
    err3, x_rel3, trace_rel3, got3 = check_resident(
        hk, "cg_resident 3D", scale, b3, **RESIDENT_KW)
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
        shape=list(b.shape), max_abs_err=max(err, err3),
        max_abs_err_2d=err, x_rel_err=x_rel, trace_rel_err=trace_rel,
        iterations=iters, ms=ms, us_per_iteration=ms * 1e3 / iters,
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
    the fused sums' determinism, and a streaming solve on such a grid."""
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
                worst = max(worst, check_array(f"pass B {shape}", g, w))
            for g, w in zip(got[2:], want[2:]):
                check_scalar(f"pass B sums {shape}", g, w)
            checks += 1
    r, p = (torch.randn((9, 17, 33), generator=gen, device="cuda")
            for _ in range(2))
    paps = {float(hk.fused_cg_pass_a(scale, beta, r, p)[1])
            for _ in range(5)}
    if len(paps) != 1:
        raise AssertionError(f"pass A sums differ between runs: {paps}")
    # the resident kernel: single cell, ragged 2D and 3D, and a warm start
    res_worst = res_x_rel = res_trace_rel = 0.0
    for shape, x0 in (((1, 1), False), ((7, 130), False), ((7, 130), True),
                      ((9, 17, 33), False), ((9, 17, 33), True)):
        b = torch.randn(shape, generator=gen, device="cuda")
        start = torch.randn(shape, generator=gen, device="cuda") \
            if x0 else None
        err, x_rel, trace_rel, _ = check_resident(
            hk, f"cg_resident {shape}", scale, b, start, tol=0.0, maxiter=30,
            check_every=8)
        res_worst = max(res_worst, err)
        res_x_rel = max(res_x_rel, x_rel)
        res_trace_rel = max(res_trace_rel, trace_rel)
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
         plain_general_iterations=ref_its, x_rel_err=x_err)
    if abs(its - ref_its) > 2 or not x_err <= 1e-4 \
            or res.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("kernels_ragged: streaming solve disagrees")


def resident_phase(label, grid, pt, poisson, gen, count_main_path,
                   plain_reference):
    """The resident engine on one system to rtol 1e-6 (b = A x_true): one
    launch per solve, the iteration count of the plain general engine at
    check_every=1, the f64 true residual, engine="auto" taking it; and
    the three engines' us/iteration on the same system (200 iterations,
    tol 0)."""
    make = (poisson.poisson_2d_operator if len(grid) == 2
            else poisson.poisson_3d_operator)
    op = make(*grid, backend="pallas")
    op_xla = make(*grid, backend="xla")
    op64 = make(*grid, dtype=torch.float64)
    x_true = torch.randn(op.n, generator=gen, device="cuda")
    b = op_xla.matvec(x_true)
    skw = dict(rtol=1e-6, maxiter=4000)
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
    for engine in ("resident", "streaming", "general"):
        pt.solve(op, b, engine=engine, **dict(RESIDENT_KW, maxiter=32))
        done, secs = timed_solve(lambda: pt.solve(op, b, engine=engine,
                                                  **RESIDENT_KW))
        us[engine] = secs * 1e6 / int(done.iterations)
    emit(label, shape=list(grid), iterations=its, seconds_to_1e6=t,
         iters_per_s=its / t, launches=seen, status=res.status_enum().name,
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
    if seen != {"cg_resident": 1} or auto_seen != {"cg_resident": 1}:
        raise AssertionError(f"{label}: expected exactly one cg_resident "
                             f"launch per solve, explicit and auto")
    if not true_rel <= 2e-6:
        raise AssertionError(f"{label}: true residual {true_rel}")


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
    bw, flops = peaks(name)

    # 2. build
    t0 = time.perf_counter()
    info = hk.build_info()
    emit("build", seconds=time.perf_counter() - t0, **info)

    gen = torch.Generator("cuda").manual_seed(SEED)
    # BASELINE config #2 as assembled CSR (host numpy assembly and packing)
    csr = poisson.poisson_2d_csr(*GRID_RES_2D, dtype=torch.float32)
    sell = csr.to_shiftell()

    # 3. kernels against their twins, timed
    rows = kernels_phase(hk, bw, flops, gen, csr, sell)
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

    # 4. oracle: the reference's 3x3 system in f64
    a, b, x_exp = poisson.oracle_system(dtype=torch.float64)
    res = pt.solve(a, b, engine="general")
    x_err = float((res.x.cpu() - torch.as_tensor(x_exp)).abs().max())
    emit("oracle", iterations=int(res.iterations), max_abs_err=x_err,
         indefinite=bool(res.indefinite), status=res.status_enum().name)
    if int(res.iterations) != 3 or not x_err <= 1e-12 \
            or not bool(res.indefinite):
        raise AssertionError("oracle: expected 3 iterations, x within "
                             "1e-12 and indefinite=True")

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

    # 11. the summary
    sources = {"stencil2d_apply": ("cuda_mpi_parallel_tpu_torch/csrc/"
                                   "stencil.cu",
                                   "cuda_mpi_parallel_tpu/ops/pallas/"
                                   "stencil.py:200"),
               "stencil3d_apply": ("cuda_mpi_parallel_tpu_torch/csrc/"
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
               "shift_ell_matvec": ("cuda_mpi_parallel_tpu_torch/csrc/spmv.cu",
                                    "cuda_mpi_parallel_tpu/ops/pallas/"
                                    "spmv.py:301")}
    summary = []
    for k, row in rows.items():
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
        summary.append(dict(
            name=k, route="cuda", source=sources[k][0],
            replaces=sources[k][1], launches=launches[k],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
