"""Hopper resident CG (B10): the whole solve in one launch, and its plain
PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/resident.py``
(``_cg_resident_call`` with ``_resident_kernel`` at degree 0,
``cg_resident_2d`` / ``cg_resident_3d`` and the capacity gate).  On a
CUDA tensor the wrapper makes one cooperative launch of
``csrc/resident.cu``, which runs every check block, iteration and
reduction of the solve on the card and returns the kernel's raw outputs
``(x, iterations, rr, indefinite, converged, healthy, hist)``; on a CPU
tensor it runs :func:`cg_resident_plain`, the same recurrence in torch
ops.

Capacity.  The kernel keeps five grid planes in device memory (b, x, r,
p, Ap); the gate admits a grid when those planes fit the card's L2
cache, where the iterations run without DRAM traffic: ``5 * cells * 4 <=
vmem_bytes()`` - 1024^2 and 128^3 f32 pass, 2048^2, 256^3 and 4096^2 do
not.  ``vmem_bytes`` keeps the JAX name and its ``CMP_RESIDENT_VMEM_BYTES``
override; on a CPU device it is the H100's 50 MiB L2, so CPU runs decide
as the card would.  The tile walk masks ragged edges, so the TPU tiling
rules (``nx % 8``, ``ny % 128``) do not apply.

The cg1 kernel (``method="cg1"``, ROADMAP A3) and the in-kernel Chebyshev
degree (``precond_degree > 0``, A8) are not ported yet.
"""
from __future__ import annotations

import os

import torch

from ..._device import require_hopper
from . import _build
from .stencil import stencil2d_apply_plain, stencil3d_apply_plain

_ENV_OVERRIDE = "CMP_RESIDENT_VMEM_BYTES"
#: L2 of an H100 - the budget of a CPU device (the card the port targets)
_H100_L2_BYTES = 50 * 2 ** 20
#: grid planes the kernel keeps in device memory: b, x, r, p, Ap
_PLANES_BOUND = 5


def vmem_bytes(device=None) -> int:
    """Bytes of fast on-chip memory the resident planes may fill: the
    ``CMP_RESIDENT_VMEM_BYTES`` override, else the L2 size of ``device``
    (a CUDA device; ``None`` = the current one when a card is present),
    else the H100's 50 MiB."""
    env = os.environ.get(_ENV_OVERRIDE)
    if env:
        try:
            budget = int(env)
        except ValueError as e:
            raise ValueError(
                f"{_ENV_OVERRIDE}={env!r} is not an integer byte count"
            ) from e
        if budget <= 0:
            raise ValueError(f"{_ENV_OVERRIDE} must be positive, got {budget}")
        return budget
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).L2_cache_size
    return _H100_L2_BYTES


def _fits(cells: int, itemsize: int, device) -> bool:
    return (itemsize == 4 and cells >= 1
            and _PLANES_BOUND * cells * itemsize <= vmem_bytes(device))


def supports_resident_2d(nx: int, ny: int, itemsize: int = 4,
                         device=None) -> bool:
    """True if an (nx, ny) f32 grid's five planes fit the budget."""
    return min(nx, ny) >= 1 and _fits(nx * ny, itemsize, device)


def supports_resident_3d(nx: int, ny: int, nz: int, itemsize: int = 4,
                         device=None) -> bool:
    """True if an (nx, ny, nz) f32 grid's five planes fit the budget."""
    return min(nx, ny, nz) >= 1 and _fits(nx * ny * nz, itemsize, device)


def _safe_div_f32(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``solver.cg._safe_div`` in the twin (not imported: the solver
    imports this module): only an exact 0/0 freezes to 0."""
    zero = (num == 0) & (den == 0)
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def _coerce_x0(x0, b_grid: torch.Tensor):
    """An optional warm start as an f32 tensor of ``b_grid``'s shape: flat
    ``(n,)`` or exactly the grid shape, nothing else."""
    if x0 is None:
        return None
    x0 = torch.as_tensor(x0, device=b_grid.device)
    if x0.ndim == 1 and x0.shape[0] == b_grid.numel():
        x0 = x0.reshape(b_grid.shape)
    elif tuple(x0.shape) != tuple(b_grid.shape):
        raise ValueError(f"x0 shape {tuple(x0.shape)} matches neither the "
                         f"grid {tuple(b_grid.shape)} nor its flat length")
    if x0.dtype != torch.float32:
        raise ValueError(f"x0 must be float32, got {x0.dtype}")
    return x0


def _check_grid_fits(shape, device) -> None:
    """Raise unless the grid passes the capacity gate."""
    ok = (supports_resident_2d(*shape, device=device) if len(shape) == 2
          else supports_resident_3d(*shape, device=device))
    if not ok:
        raise ValueError(
            f"{tuple(shape)} f32 grid does not fit the resident kernel: "
            f"needs {_PLANES_BOUND} * grid bytes <= {vmem_bytes(device)} "
            f"(the card's L2; set {_ENV_OVERRIDE} to override the budget)")


def _check_method(method: str, precond_degree: int) -> None:
    if method not in ("cg", "cg1"):
        raise ValueError(
            f"resident method must be 'cg' or 'cg1', got {method!r}")
    if method == "cg1":
        raise NotImplementedError(
            "the resident cg1 kernel (method='cg1') is not ported yet "
            "(ROADMAP A3); use method='cg'")
    if precond_degree > 0:
        raise NotImplementedError(
            "the in-kernel Chebyshev degree (precond_degree > 0) is not "
            "ported yet (ROADMAP A8)")


def _check_loop_args(check_every: int, maxiter: int,
                     precond_degree: int = 0) -> int:
    """Validate the loop arguments; ``check_every`` clamped to
    ``[1, max(maxiter, 1)]`` so ``maxiter == 0`` gives zero blocks."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if precond_degree < 0:
        raise ValueError(
            f"precond_degree must be >= 0, got {precond_degree}")
    if maxiter < 0:
        raise ValueError(f"maxiter must be >= 0, got {maxiter}")
    return max(1, min(check_every, maxiter))


def cg_resident_plain(scale, b: torch.Tensor, x0=None, *, tol, rtol, cap,
                      nblocks: int, check_every: int):
    """The ``_resident_kernel`` recurrence in torch ops, check blocks
    included - what ``csrc/resident.cu`` is held against.  Returns the
    kernel's outputs ``(x, iterations, rr, indefinite, converged, healthy,
    hist)`` (int32 flags, f32 ``rr``, the ``(nblocks + 1,)`` ||r||^2 trace
    with -1 in blocks that never ran).  Elementwise arithmetic rounds as
    the kernel's does; the sums run in torch's order, not the kernel's."""
    stencil = stencil2d_apply_plain if b.ndim == 2 else stencil3d_apply_plain
    scale, tol, rtol = (_build.device_scalar(v, b, torch.float32)
                        for v in (scale, tol, rtol))
    cap = int(cap)
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()
    else:
        x, r = x0.clone(), b - stencil(x0, scale)
    p = r
    rr = torch.sum(r * r)
    rho = rr
    thresh = torch.maximum(tol, rtol * torch.sqrt(rr))
    thresh2 = thresh * thresh
    hist = torch.full((nblocks + 1,), -1.0, dtype=torch.float32,
                      device=b.device)
    hist[0] = rr
    k = 0
    indefinite = torch.zeros((), dtype=torch.bool, device=b.device)
    for blk in range(nblocks):
        healthy = torch.isfinite(rr) & torch.isfinite(rho) & (rho > 0)
        if not (bool((rr >= thresh2) & (rr > 0) & healthy) and k < cap):
            break
        for _ in range(min(check_every, cap - k)):
            ap = stencil(p, scale)
            pap = torch.sum(p * ap)
            indefinite = indefinite | ((pap <= 0) & (rr > 0))
            alpha = _safe_div_f32(rho, pap)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = torch.sum(r * r)
            beta = _safe_div_f32(rr_new, rho)
            p = r + beta * p
            rr = rho = rr_new
        k += min(check_every, cap - k)
        hist[blk + 1] = rr
    converged = (rr < thresh2) | (rr == 0)
    healthy = torch.isfinite(rr) & torch.isfinite(rho) \
        & ((rho > 0) | (rr == 0))
    i32 = torch.int32
    return (x, torch.tensor(k, dtype=i32, device=b.device), rr,
            indefinite.to(i32), converged.to(i32), healthy.to(i32), hist)


def _cg_resident_call(scale, tol, rtol, cap, b_grid: torch.Tensor, x0_grid,
                      *, maxiter: int, check_every: int):
    nblocks = -(-maxiter // check_every)
    if b_grid.device.type == "cpu":
        return cg_resident_plain(scale, b_grid, x0_grid, tol=tol, rtol=rtol,
                                 cap=cap, nblocks=nblocks,
                                 check_every=check_every)
    name = "cg_resident"
    dev = b_grid.device
    b = b_grid.contiguous()
    x0 = None if x0_grid is None else x0_grid.contiguous()
    params = torch.stack([_build.device_scalar(v, b, torch.float32)
                          for v in (scale, tol, rtol)])
    cap_t = _build.device_scalar(cap, b, torch.int32)
    x, r, p, ap = (torch.empty_like(b) for _ in range(4))
    n0, n1, n2, three_d = _build.grid_dims(b.shape)
    with torch.cuda.device(dev):
        lib = _build.library()
        tiles = lib.cmpt_tile_blocks(n0, n1, n2, three_d)
        if tiles <= 0:
            raise ValueError(f"{name}: grid {tuple(b.shape)} needs more "
                             f"blocks than one launch allows")
        partials = torch.empty(2 * tiles, dtype=torch.float32, device=dev)
        rr = torch.empty(1, dtype=torch.float32, device=dev)
        flags = torch.empty(4, dtype=torch.int32, device=dev)
        hist = torch.empty(nblocks + 1, dtype=torch.float32, device=dev)
        _build.check(lib.cmpt_cg_resident(
            b.data_ptr(), None if x0 is None else x0.data_ptr(),
            x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
            params.data_ptr(), cap_t.data_ptr(), partials.data_ptr(),
            rr.data_ptr(), flags.data_ptr(), hist.data_ptr(), n0, n1, n2,
            three_d, nblocks, check_every, _build.stream_handle(dev)), name)
    _build.LAUNCHES[name] += 1
    return x, flags[0], rr[0], flags[1], flags[2], flags[3], hist


def _cg_resident(scale, b, *, ndim: int, x0, tol, rtol, maxiter, check_every,
                 iter_cap, precond_degree, method):
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b)
    if b.ndim != ndim:
        raise ValueError(f"b{ndim}d must be {ndim}-D (the grid), got "
                         f"{tuple(b.shape)}")
    if b.dtype != torch.float32:
        raise ValueError(f"resident CG is float32-only, got {b.dtype}")
    if b.device.type != "cpu":
        require_hopper(b.device, "cg_resident")
    check_every = _check_loop_args(check_every, maxiter, precond_degree)
    _check_method(method, precond_degree)
    x0 = _coerce_x0(x0, b)
    _check_grid_fits(b.shape, b.device)
    cap = maxiter if iter_cap is None else iter_cap
    return _cg_resident_call(scale, tol, rtol, cap, b, x0, maxiter=maxiter,
                             check_every=check_every)


def cg_resident_2d(scale, b2d, *, x0=None, tol=0.0, rtol=0.0, maxiter=2000,
                   check_every=32, iter_cap=None, precond_degree=0,
                   method="cg"):
    """The whole CG solve for the 5-point stencil in one launch.

    Arguments as the JAX ``cg_resident_2d``: ``scale`` a number or 0-d
    tensor; ``b2d`` the (nx, ny) f32 rhs; ``x0`` an optional f32 warm
    start (flat or grid); ``tol``/``rtol`` absolute/relative on ||r||;
    ``maxiter`` sizes the block loop; ``check_every`` the check block;
    ``iter_cap`` an optional cap <= maxiter (number or tensor).  Returns
    ``(x2d, iterations, rr, indefinite, converged, healthy, hist)`` as
    0-d / 1-d tensors (int32 flags; ``hist`` holds ||r||^2 per block,
    -1 for blocks that never ran).
    """
    return _cg_resident(scale, b2d, ndim=2, x0=x0, tol=tol, rtol=rtol,
                        maxiter=maxiter, check_every=check_every,
                        iter_cap=iter_cap, precond_degree=precond_degree,
                        method=method)


def cg_resident_3d(scale, b3d, *, x0=None, tol=0.0, rtol=0.0, maxiter=2000,
                   check_every=32, iter_cap=None, precond_degree=0,
                   method="cg"):
    """The 7-point (``Stencil3D``) form of :func:`cg_resident_2d`."""
    return _cg_resident(scale, b3d, ndim=3, x0=x0, tol=tol, rtol=rtol,
                        maxiter=maxiter, check_every=check_every,
                        iter_cap=iter_cap, precond_degree=precond_degree,
                        method=method)

