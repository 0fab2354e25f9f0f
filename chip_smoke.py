"""Drive the PyTorch/CUDA port's main path on one Hopper card.

    python3 chip_smoke.py

Builds the hand kernels from ``cuda_mpi_parallel_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch twin at the main path's
shapes, then solves the north-star problem - 3D Poisson at 256^3 - and
its 2D sibling (4096^2, the same 16.8 M cells) through ``solve()``.
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
ARRAY_TOL = 1e-6     # max|kernel - twin| <= ARRAY_TOL * max|twin| (a few
#                      f32 ulps; both round every op alike, see common.cuh)
SCALAR_TOL = 1e-5    # relative: the sums run in another order than torch.sum
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


def kernels_phase(hk, bw, flops, gen):
    """B1-B4 against their twins at the main path's shapes, and timed."""
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
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"],
                                                 bw, flops)
    emit("kernels", array_tol=ARRAY_TOL, scalar_tol=SCALAR_TOL,
         timed_launches=TIMED, kernels=rows)
    return rows


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
    op = poisson.poisson_3d_operator(9, 17, 33, backend="pallas")
    b = torch.randn(op.n, generator=gen, device="cuda")
    res = pt.solve(op, b, rtol=1e-5, engine="streaming")
    ref = pt.solve(poisson.poisson_3d_operator(9, 17, 33), b, rtol=1e-5)
    its, ref_its = int(res.iterations), int(ref.iterations)
    x_err = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    emit("kernels_ragged", checks=checks, max_abs_err=worst,
         deterministic=True, streaming_iterations=its,
         plain_general_iterations=ref_its, x_rel_err=x_err)
    if abs(its - ref_its) > 2 or not x_err <= 1e-4 \
            or res.status_enum() != pt.CGStatus.CONVERGED:
        raise AssertionError("kernels_ragged: streaming solve disagrees")


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
         count=torch.cuda.device_count())
    if cap[0] != 9:
        raise RuntimeError(f"{name} has capability {cap}, not 9.x")
    bw, flops = peaks(name)

    # 2. build
    t0 = time.perf_counter()
    info = hk.build_info()
    emit("build", seconds=time.perf_counter() - t0, **info)

    gen = torch.Generator("cuda").manual_seed(SEED)

    # 3. kernels against their twins, timed
    rows = kernels_phase(hk, bw, flops, gen)
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
    if auto_seen.get("fused_cg_pass_a") != int(auto.iterations):
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
    emit("streaming_2d", iterations=int(res.iterations), seconds=t,
         iters_per_s=int(res.iterations) / t, launches=seen,
         residual_norm=float(res.residual_norm),
         plain_residual_norm=float(ref.residual_norm), rel_diff=rel)
    if not rel <= 1e-3 or seen.get("stencil2d_apply") != 1:
        raise AssertionError("streaming_2d: residuals differ or the "
                             "warm-start init missed the 2D stencil")

    # 8. the summary
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
                                   "fused_cg.py:331")}
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
