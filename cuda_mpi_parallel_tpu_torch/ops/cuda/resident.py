"""Hopper resident CG (B10 and its cg1 form, and B11 in float64): the
whole solve in one launch, and its plain PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/resident.py``
(``_cg_resident_call`` with ``_resident_kernel`` and
``_resident_kernel_cg1``, ``cg_resident_2d`` /
``cg_resident_3d`` and the capacity gate; ``_cg_resident_df64_call``,
``cg_resident_df64_2d`` / ``_3d`` and ``supports_resident_df64_2d`` /
``_3d``, whose ``(hi, lo)`` f32 planes are native float64 planes
here).  On a
CUDA tensor the wrapper makes one cooperative launch of
``csrc/resident.cu``, which runs every check block, iteration and
reduction of the solve on the card and returns the kernel's raw outputs
``(x, iterations, rr, indefinite, converged, healthy, hist)``; on a CPU
tensor it runs :func:`cg_resident_plain`, the same recurrence in torch
ops.

B10's f32 launch takes one of two bodies by the grid's shape: B12's
body at one shard (``csrc/resident_dist.cu``: two barriers an
iteration, p formed where it is read, Ap and x in shared memory) when
the grid's tiles fit its shared slots - every square and cube the gate
admits - else the tile walk of ``csrc/resident.cu``.  B11's f64 launch
takes the same two bodies by the same rule, in double: B12's body at
two CTAs per SM with three tiles a CTA at most (every square and cube
the f64 gate admits), the tile walk past it.  Both give the same bits;
the C entry alone picks one, by ``dist_geometry`` of
``csrc/resident_dist.cuh`` (restated in Python as
``ops.cuda.resident_dist.dist_geometry``).

With ``precond_degree = k > 0`` the kernel applies the k-term Chebyshev
preconditioner on ``[lmin, lmax]`` inside the launch, after each r
update (``_resident_kernel``'s ``precond``): k - 1 extra stencil passes
and grid barriers per iteration.

``method="cg1"`` launches the Chronopoulos-Gear kernel instead
(``_resident_kernel_cg1``; unpreconditioned, f32), counted under
``LAUNCHES["cg_resident_cg1"]``; its twin is
:func:`cg_resident_cg1_plain`.  It too has two bodies, picked by the
same shape rule in its C entry: on B12's machinery at one shard
(``csrc/resident_dist.cu``'s ``resident_cg1_shard_kernel``: one pass
and one barrier an iteration, r formed where it is read, p and x in
shared memory) for every grid whose tiles fit B12's slots - every
square and cube the cg1 gate admits - else ``csrc/resident.cu``'s tile
walk (two passes and two grid barriers an iteration).  Both give the
same bits.

Capacity.  The kernel keeps five grid planes in device memory (b, x, r,
p, Ap), seven with the preconditioner (a second z buffer and d; Ap's
plane is the first z buffer once the r update has read it); the gate
admits a grid when those planes fit the card's L2 cache, where the
iterations run without DRAM traffic: ``planes * cells * 4 <=
vmem_bytes()``.  Five: 1024^2 and 128^3 f32 pass, 2048^2, 256^3 and
4096^2 do not.  Seven: 1024^2 passes, 128^3 does not.  The cg1 kernel
keeps six (b, x, r, p, s = A p, w = A r): 1024^2 (24 MiB) and 128^3
(48 MiB) pass, 136^3 (which five admit) does not.  Its one-barrier body
allocates eight (b, x, and r, s, w in two parities each; p and x live
in shared memory), of which the iterations touch the six of r, s and
w, so the gate stays at six.  (The JAX package
gates the preconditioned kernel at 13 planes and the cg1 kernel at two
over its bound, measurements of the TPU compiler's scratch, which do
not carry over.)  ``vmem_bytes`` keeps
the JAX name and its ``CMP_RESIDENT_VMEM_BYTES`` override; on a CPU
device it is the H100's 50 MiB L2, so CPU runs decide as the card
would.  The tile walk masks ragged edges, so the TPU tiling rules
(``nx % 8``, ``ny % 128``) do not apply.

The f64 lane gates the same planes at 8 bytes: five fit 1024^2 (40 MiB)
and cubes up to 109^3 at the H100's 50 MiB, seven fit 768 x 1024
(42 MiB) but not 1024^2 (56 MiB).  (The JAX package gates its df64
kernel at 27 and 41 f32 planes, measurements of the TPU compiler's
scratch, which do not carry over.)  Its Chebyshev interval is the
centre and half-width ``theta``, ``delta`` of
``solver.df64.chebyshev_interval``, and its threshold ``max(tol^2,
rtol^2 ||r0||^2)``, as in the JAX df64 kernel.
"""
from __future__ import annotations

import os

import torch

from ..._device import require_hopper
from ..chebyshev import chebyshev_coefficients, chebyshev_steps
from . import _build
from .stencil import stencil2d_apply_plain, stencil3d_apply_plain

_ENV_OVERRIDE = "CMP_RESIDENT_VMEM_BYTES"
#: L2 of an H100 - the budget of a CPU device (the card the port targets)
_H100_L2_BYTES = 50 * 2 ** 20
#: grid planes the kernel keeps in device memory: b, x, r, p, Ap
_PLANES_BOUND = 5
#: with the in-kernel Chebyshev: also a second z buffer and d
_PLANES_PRECOND = 7
#: the cg1 kernel: b, x, r, p, s = A p, w = A r
_PLANES_CG1 = 6


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
    card = card_of(device)
    if card is not None:
        return torch.cuda.get_device_properties(card).L2_cache_size
    return _H100_L2_BYTES


def card_of(device=None):
    """The CUDA device whose properties a capacity gate reads: ``device``
    when it is one, the current card for ``None`` when one is present,
    else ``None`` (the gate then takes the H100's)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _planes(preconditioned: bool, cg1: bool = False) -> int:
    if cg1:
        return _PLANES_CG1
    return _PLANES_PRECOND if preconditioned else _PLANES_BOUND


def _fits(cells: int, itemsize: int, device, preconditioned: bool,
          cg1: bool = False) -> bool:
    return (cells >= 1 and _planes(preconditioned, cg1) * cells * itemsize
            <= vmem_bytes(device))


def supports_resident_2d(nx: int, ny: int, itemsize: int = 4,
                         device=None, preconditioned: bool = False,
                         cg1: bool = False) -> bool:
    """True if an (nx, ny) f32 grid's planes (five, seven with the
    preconditioner, six for the cg1 kernel) fit the budget (``itemsize``
    must be 4: this is the f32 kernels' gate)."""
    return (itemsize == 4 and min(nx, ny) >= 1
            and _fits(nx * ny, 4, device, preconditioned, cg1))


def supports_resident_3d(nx: int, ny: int, nz: int, itemsize: int = 4,
                         device=None, preconditioned: bool = False,
                         cg1: bool = False) -> bool:
    """True if an (nx, ny, nz) f32 grid's planes fit the budget."""
    return (itemsize == 4 and min(nx, ny, nz) >= 1
            and _fits(nx * ny * nz, 4, device, preconditioned, cg1))


def supports_resident_df64_2d(nx: int, ny: int, device=None,
                              preconditioned: bool = False) -> bool:
    """True if an (nx, ny) grid's f64 planes (five, seven with the
    preconditioner) fit the budget."""
    return min(nx, ny) >= 1 and _fits(nx * ny, 8, device, preconditioned)


def supports_resident_df64_3d(nx: int, ny: int, nz: int, device=None,
                              preconditioned: bool = False) -> bool:
    """True if an (nx, ny, nz) grid's f64 planes fit the budget."""
    return min(nx, ny, nz) >= 1 and _fits(nx * ny * nz, 8, device,
                                          preconditioned)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``solver.cg._safe_div`` in the twin (not imported: the solver
    imports this module): only an exact 0/0 freezes to 0."""
    zero = (num == 0) & (den == 0)
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def _coerce_x0(x0, b_grid: torch.Tensor):
    """An optional warm start as a tensor of ``b_grid``'s shape and dtype:
    flat ``(n,)`` or exactly the grid shape, nothing else."""
    if x0 is None:
        return None
    x0 = torch.as_tensor(x0, device=b_grid.device)
    if x0.ndim == 1 and x0.shape[0] == b_grid.numel():
        x0 = x0.reshape(b_grid.shape)
    elif tuple(x0.shape) != tuple(b_grid.shape):
        raise ValueError(f"x0 shape {tuple(x0.shape)} matches neither the "
                         f"grid {tuple(b_grid.shape)} nor its flat length")
    if x0.dtype != b_grid.dtype:
        raise ValueError(f"x0 must be {_name(b_grid.dtype)}, got {x0.dtype}")
    return x0


def _name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _check_grid_fits(shape, dtype, device, preconditioned: bool,
                     cg1: bool = False) -> None:
    """Raise unless the grid passes the capacity gate of its kernel."""
    if dtype == torch.float64:
        fits = (supports_resident_df64_2d if len(shape) == 2
                else supports_resident_df64_3d)(
            *shape, device=device, preconditioned=preconditioned)
    else:
        fits = (supports_resident_2d if len(shape) == 2
                else supports_resident_3d)(
            *shape, device=device, preconditioned=preconditioned, cg1=cg1)
    if not fits:
        raise ValueError(
            f"{tuple(shape)} {_name(dtype)} grid does not fit the resident "
            f"kernel: needs {_planes(preconditioned, cg1)} * grid bytes <= "
            f"{vmem_bytes(device)} (the card's L2; set {_ENV_OVERRIDE} to "
            f"override the budget)")


def _check_method(method: str, precond_degree: int) -> None:
    if method not in ("cg", "cg1"):
        raise ValueError(
            f"resident method must be 'cg' or 'cg1', got {method!r}")
    if method == "cg1" and precond_degree > 0:
        raise ValueError(
            "the resident cg1 kernel is unpreconditioned (the "
            "preconditioned Chronopoulos-Gear form needs a third "
            "reduction); use method='cg' with precond_degree, or drop "
            "the preconditioner")


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


def _chebyshev_plain(stencil, scale, theta, steps):
    """``r -> z``: ``_resident_kernel``'s ``precond`` in torch ops, with
    the interval centre ``theta`` and the steps' ``(c1, c2)`` of
    ``ops.chebyshev.chebyshev_steps``."""
    def precond(r):
        d = r / theta
        z = d
        for c1, c2 in steps:
            d = c1 * d + c2 * (r - stencil(z, scale))
            z = z + d
        return z
    return precond


def cg_resident_plain(scale, b: torch.Tensor, x0=None, *, tol, rtol, cap,
                      nblocks: int, check_every: int, precond_degree: int = 0,
                      lmin=0.0, lmax=1.0):
    """The ``_resident_kernel`` recurrence in torch ops, check blocks
    and the in-kernel Chebyshev (``precond_degree > 0``) included - what
    ``csrc/resident.cu`` is held against.  Returns the kernel's outputs
    ``(x, iterations, rr, indefinite, converged, healthy, hist)`` (int32
    flags, f32 ``rr``, the ``(nblocks + 1,)`` ||r||^2 trace with -1 in
    blocks that never ran).  Elementwise arithmetic rounds as the
    kernel's does; the sums run in torch's order, not the kernel's."""
    stencil = stencil2d_apply_plain if b.ndim == 2 else stencil3d_apply_plain
    scale, tol, rtol, lmin, lmax = (_build.device_scalar(v, b, torch.float32)
                                    for v in (scale, tol, rtol, lmin, lmax))
    precond = (_chebyshev_plain(stencil, scale,
                                *chebyshev_steps(lmin, lmax, precond_degree))
               if precond_degree > 0 else None)

    def threshold2(rr0):
        thresh = torch.maximum(tol, rtol * torch.sqrt(rr0))
        return thresh * thresh
    return _resident_plain(stencil, scale, b, x0, threshold2, precond,
                           cap=cap, nblocks=nblocks, check_every=check_every)


def cg_resident_df64_plain(scale, b: torch.Tensor, x0=None, *, tol, rtol,
                           cap, nblocks: int, check_every: int,
                           precond_degree: int = 0, theta=1.0, delta=1.0):
    """The f64 lane's recurrence (``_resident_kernel_df64``'s) in torch
    float64 ops - what B11 is held against.  As
    :func:`cg_resident_plain`, with the threshold ``max(tol^2, rtol^2
    ||r0||^2)`` and the Chebyshev interval given by its centre ``theta``
    and half-width ``delta``; ``rr`` and the trace are float64."""
    stencil = stencil2d_apply_plain if b.ndim == 2 else stencil3d_apply_plain
    scale, tol, rtol, theta, delta = (
        _build.device_scalar(v, b, torch.float64)
        for v in (scale, tol, rtol, theta, delta))
    precond = (_chebyshev_plain(stencil, scale, theta,
                                chebyshev_coefficients(theta, delta,
                                                       precond_degree))
               if precond_degree > 0 else None)

    def threshold2(rr0):
        return torch.maximum(tol * tol, (rtol * rtol) * rr0)
    return _resident_plain(stencil, scale, b, x0, threshold2, precond,
                           cap=cap, nblocks=nblocks, check_every=check_every)


def cg_resident_cg1_plain(scale, b: torch.Tensor, x0=None, *, tol, rtol,
                          cap, nblocks: int, check_every: int):
    """The ``_resident_kernel_cg1`` recurrence (Chronopoulos-Gear,
    unpreconditioned, f32) in torch ops - what the cg1 kernel of
    ``csrc/resident.cu`` is held against.  Returns the kernel's outputs
    ``(x, iterations, rr, indefinite, converged, healthy, hist)`` as
    :func:`cg_resident_plain` does.  Elementwise arithmetic rounds as
    the kernel's does; the sums run in torch's order."""
    stencil = stencil2d_apply_plain if b.ndim == 2 else stencil3d_apply_plain
    scale, tol, rtol = (_build.device_scalar(v, b, torch.float32)
                        for v in (scale, tol, rtol))
    cap = int(cap)
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()
    else:
        x, r = x0.clone(), b - stencil(x0, scale)
    w = stencil(r, scale)
    rr = torch.sum(r * r)
    delta = torch.sum(w * r)
    p, s = r, w
    thresh = torch.maximum(tol, rtol * torch.sqrt(rr))
    thresh2 = thresh * thresh
    alpha = _safe_div(rr, delta)       # carried one step ahead
    indefinite = (delta <= 0) & (rr > 0)
    hist = torch.full((nblocks + 1,), -1.0, dtype=b.dtype, device=b.device)
    hist[0] = rr
    k = 0
    for blk in range(nblocks):
        healthy = torch.isfinite(rr) & torch.isfinite(alpha)
        if not (bool((rr >= thresh2) & (rr > 0) & healthy) and k < cap):
            break
        for _ in range(min(check_every, cap - k)):
            x = x + alpha * p
            r = r - alpha * s
            w = stencil(r, scale)
            rr_new = torch.sum(r * r)
            delta = torch.sum(w * r)
            beta = _safe_div(rr_new, rr)
            denom = delta - beta * _safe_div(rr_new, alpha)
            alpha = _safe_div(rr_new, denom)
            indefinite = indefinite | ((denom <= 0) & (rr_new > 0))
            p = r + beta * p
            s = w + beta * s
            rr = rr_new
        k += min(check_every, cap - k)
        hist[blk + 1] = rr
    converged = (rr < thresh2) | (rr == 0)
    healthy = torch.isfinite(rr) & torch.isfinite(alpha)
    i32 = torch.int32
    return (x, torch.tensor(k, dtype=i32, device=b.device), rr,
            indefinite.to(i32), converged.to(i32), healthy.to(i32), hist)


def _resident_plain(stencil, scale, b, x0, threshold2, precond, *, cap,
                    nblocks, check_every):
    cap = int(cap)
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()
    else:
        x, r = x0.clone(), b - stencil(x0, scale)
    rr = torch.sum(r * r)
    if precond is None:
        p, rho = r, rr
    else:
        p = precond(r)
        rho = torch.sum(r * p)
    thresh2 = threshold2(rr)
    hist = torch.full((nblocks + 1,), -1.0, dtype=b.dtype, device=b.device)
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
            alpha = _safe_div(rho, pap)
            x = x + alpha * p
            r = r - alpha * ap
            rr = torch.sum(r * r)
            if precond is None:
                z, rho_new = r, rr
            else:
                z = precond(r)
                rho_new = torch.sum(r * z)
            beta = _safe_div(rho_new, rho)
            p = z + beta * p
            rho = rho_new
        k += min(check_every, cap - k)
        hist[blk + 1] = rr
    converged = (rr < thresh2) | (rr == 0)
    healthy = torch.isfinite(rr) & torch.isfinite(rho) \
        & ((rho > 0) | (rr == 0))
    i32 = torch.int32
    return (x, torch.tensor(k, dtype=i32, device=b.device), rr,
            indefinite.to(i32), converged.to(i32), healthy.to(i32), hist)


def _cg_resident_call(scale, tol, rtol, p3, p4, cap, b_grid: torch.Tensor,
                      x0_grid, *, maxiter: int, check_every: int,
                      degree: int, method: str = "cg",
                      interpret: bool = False, instance: int = 0):
    """One launch of B10 (f32 ``b_grid``; ``p3, p4`` = ``lmin, lmax``),
    its cg1 kernel (``method="cg1"``; no interval) or B11 (f64; ``theta,
    delta``); its twin on a CPU tensor, or when ``interpret`` asks for
    it.  B10's C entries run B12's body at one shard (the cg1 form: its
    one-barrier body) when the grid's tiles fit its shared slots, else
    the tile walk; so does B11's.  ``instance`` is a check hook, not a
    tuning option: it forces one body for the checks that hold the two
    equal (1 B12's body or the one-barrier body, where a grid past the
    slots raises; 2 the tile walk).  The solver passes 0, the shape's."""
    nblocks = -(-maxiter // check_every)
    f64 = b_grid.dtype == torch.float64
    cg1 = method == "cg1"
    if interpret or b_grid.device.type == "cpu":
        if cg1:
            return cg_resident_cg1_plain(
                scale, b_grid, x0_grid, tol=tol, rtol=rtol, cap=cap,
                nblocks=nblocks, check_every=check_every)
        plain = cg_resident_df64_plain if f64 else cg_resident_plain
        interval = (dict(theta=p3, delta=p4) if f64
                    else dict(lmin=p3, lmax=p4))
        return plain(scale, b_grid, x0_grid, tol=tol, rtol=rtol, cap=cap,
                     nblocks=nblocks, check_every=check_every,
                     precond_degree=degree, **interval)
    return _launch(scale, tol, rtol, p3, p4, cap, b_grid, x0_grid,
                   nblocks=nblocks, check_every=check_every, degree=degree,
                   method=method, instance=instance)


def _launch(scale, tol, rtol, p3, p4, cap, b_grid: torch.Tensor, x0_grid, *,
            nblocks: int, check_every: int, degree: int, method: str,
            instance: int):
    """One launch of B10, its cg1 kernel or B11 on ``b_grid``'s card;
    returns the kernel's outputs."""
    f64 = b_grid.dtype == torch.float64
    cg1 = method == "cg1"
    name = ("cg_resident_cg1" if cg1 else
            "cg_resident_df64" if f64 else "cg_resident")
    dev, dtype = b_grid.device, b_grid.dtype
    b = b_grid.contiguous()
    x0 = None if x0_grid is None else x0_grid.contiguous()
    params = torch.stack([_build.device_scalar(v, b, dtype) for v in
                          ((scale, tol, rtol) if cg1
                           else (scale, tol, rtol, p3, p4))])
    cap_t = _build.device_scalar(cap, b, torch.int32)
    # x, r, p and Ap (the cg1 kernel: s = A p, and w = A r); the
    # Chebyshev planes: d from degree 2, the second z buffer from 3
    # (on B12's body p and ap are p's two planes, d its first z buffer;
    # on cg1's one-barrier body r's are r and p, s's s and s2, w's w and
    # w2)
    x, r, p, ap = (torch.empty_like(b) for _ in range(4))
    w, s2, w2 = ((torch.empty_like(b) for _ in range(3)) if cg1
                 else (None, None, None))
    d = torch.empty_like(b) if degree >= 2 else None
    z2 = torch.empty_like(b) if degree >= 3 else None
    n0, n1, n2, three_d = _build.grid_dims(b.shape)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        lib = _build.library()
        tiles = lib.cmpt_tile_blocks(n0, n1, n2, three_d)
        if tiles <= 0:
            raise ValueError(f"{name}: grid {tuple(b.shape)} needs more "
                             f"blocks than one launch allows")
        partials = torch.empty((2 if cg1 else 3) * tiles, dtype=dtype,
                               device=dev)
        rr = torch.empty(1, dtype=dtype, device=dev)
        flags = torch.empty(4, dtype=torch.int32, device=dev)
        hist = torch.empty(nblocks + 1, dtype=dtype, device=dev)
        planes = (ptr(b), ptr(x0), ptr(x), ptr(r), ptr(p), ptr(ap))
        sums = (ptr(params), ptr(cap_t), ptr(partials), ptr(rr), ptr(flags),
                ptr(hist))
        loop = (n0, n1, n2, three_d, nblocks, check_every)
        stream = _build.stream_handle(dev)
        # B12's body (and cg1's one-barrier body) keeps its barrier and
        # dot rows in a zeroed exchange region of the lane's value size,
        # sized by the header's C entry; the tile walk ignores it
        region = torch.zeros(lib.cmpt_resident_dist_exchange_bytes(
            n1 * n2, 1, b.element_size()), dtype=torch.uint8, device=dev)
        if cg1:
            code = lib.cmpt_cg_resident_cg1(
                *planes, ptr(w), ptr(s2), ptr(w2), *sums, ptr(region),
                *loop, instance, stream)
        else:
            entry = (lib.cmpt_cg_resident_f64 if f64
                     else lib.cmpt_cg_resident)
            code = entry(*planes, ptr(z2), ptr(d), *sums, ptr(region),
                         *loop, degree, instance, stream)
        _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return x, flags[0], rr[0], flags[1], flags[2], flags[3], hist


def _cg_resident(scale, b, *, ndim: int, x0, tol, rtol, maxiter, check_every,
                 iter_cap, precond_degree, p3, p4, method,
                 dtype=torch.float32, interpret=False):
    name = ("cg_resident_df64" if dtype == torch.float64
            else "cg_resident_cg1" if method == "cg1" else "cg_resident")
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b)
    if b.ndim != ndim:
        raise ValueError(f"b{ndim}d must be {ndim}-D (the grid), got "
                         f"{tuple(b.shape)}")
    if b.dtype != dtype:
        raise ValueError(f"{name} is {_name(dtype)}-only, got {b.dtype}")
    if b.device.type != "cpu" and not interpret:
        require_hopper(b.device, name)
    check_every = _check_loop_args(check_every, maxiter, precond_degree)
    _check_method(method, precond_degree)
    x0 = _coerce_x0(x0, b)
    _check_grid_fits(b.shape, dtype, b.device, precond_degree > 0,
                     cg1=method == "cg1")
    cap = maxiter if iter_cap is None else iter_cap
    return _cg_resident_call(scale, tol, rtol, p3, p4, cap, b, x0,
                             maxiter=maxiter, check_every=check_every,
                             degree=int(precond_degree), method=method,
                             interpret=interpret)


def cg_resident_2d(scale, b2d, *, x0=None, tol=0.0, rtol=0.0, maxiter=2000,
                   check_every=32, iter_cap=None, precond_degree=0,
                   lmin=0.0, lmax=1.0, method="cg", interpret=False):
    """The whole CG solve for the 5-point stencil in one launch.

    Arguments as the JAX ``cg_resident_2d``: ``scale`` a number or 0-d
    tensor; ``b2d`` the (nx, ny) f32 rhs; ``x0`` an optional f32 warm
    start (flat or grid); ``tol``/``rtol`` absolute/relative on ||r||;
    ``maxiter`` sizes the block loop; ``check_every`` the check block;
    ``iter_cap`` an optional cap <= maxiter (number or tensor);
    ``precond_degree`` k > 0 applies the k-term Chebyshev preconditioner
    on the spectral interval ``[lmin, lmax]`` (numbers or 0-d tensors,
    ignored at k = 0) inside the kernel.  Returns
    ``(x2d, iterations, rr, indefinite, converged, healthy, hist)`` as
    0-d / 1-d tensors (int32 flags; ``hist`` holds ||r||^2 per block,
    -1 for blocks that never ran).  ``method="cg1"`` runs the
    Chronopoulos-Gear kernel (unpreconditioned: ``precond_degree`` must
    be 0).  ``interpret=True`` runs the plain twin on any device (an
    explicit request, as the JAX ``interpret=`` is).
    """
    return _cg_resident(scale, b2d, ndim=2, x0=x0, tol=tol, rtol=rtol,
                        maxiter=maxiter, check_every=check_every,
                        iter_cap=iter_cap, precond_degree=precond_degree,
                        p3=lmin, p4=lmax, method=method, interpret=interpret)


def cg_resident_3d(scale, b3d, *, x0=None, tol=0.0, rtol=0.0, maxiter=2000,
                   check_every=32, iter_cap=None, precond_degree=0,
                   lmin=0.0, lmax=1.0, method="cg", interpret=False):
    """The 7-point (``Stencil3D``) form of :func:`cg_resident_2d`."""
    return _cg_resident(scale, b3d, ndim=3, x0=x0, tol=tol, rtol=rtol,
                        maxiter=maxiter, check_every=check_every,
                        iter_cap=iter_cap, precond_degree=precond_degree,
                        p3=lmin, p4=lmax, method=method, interpret=interpret)



def cg_resident_df64_2d(scale, b2d, *, x0=None, tol=0.0, rtol=0.0,
                        maxiter=2000, check_every=32, iter_cap=None,
                        precond_degree=0, theta=1.0, delta=1.0,
                        interpret=False):
    """B11: the whole f64 CG solve for the 5-point stencil in one launch
    (the JAX ``cg_resident_df64_2d``, on native float64 planes).

    ``scale`` a number or 0-d tensor; ``b2d`` the (nx, ny) f64 rhs;
    ``x0`` an optional f64 warm start (flat or grid); ``tol``/``rtol``
    give the threshold ``max(tol^2, rtol^2 ||r0||^2)`` on ||r||^2;
    ``maxiter``, ``check_every`` and ``iter_cap`` as for
    :func:`cg_resident_2d`; ``precond_degree`` k > 0 applies the k-term
    Chebyshev preconditioner on the interval of centre ``theta`` and
    half-width ``delta`` (``solver.df64.chebyshev_interval``) inside the
    kernel.  Returns ``(x2d, iterations, rr, indefinite, converged,
    healthy, hist)`` with f64 ``x2d``, ``rr`` and ``hist``.
    """
    return _cg_resident(scale, b2d, ndim=2, x0=x0, tol=tol, rtol=rtol,
                        maxiter=maxiter, check_every=check_every,
                        iter_cap=iter_cap, precond_degree=precond_degree,
                        p3=theta, p4=delta, method="cg",
                        dtype=torch.float64, interpret=interpret)


def cg_resident_df64_3d(scale, b3d, *, x0=None, tol=0.0, rtol=0.0,
                        maxiter=2000, check_every=32, iter_cap=None,
                        precond_degree=0, theta=1.0, delta=1.0,
                        interpret=False):
    """The 7-point (``Stencil3D``) form of :func:`cg_resident_df64_2d`."""
    return _cg_resident(scale, b3d, ndim=3, x0=x0, tol=tol, rtol=rtol,
                        maxiter=maxiter, check_every=check_every,
                        iter_cap=iter_cap, precond_degree=precond_degree,
                        p3=theta, p4=delta, method="cg",
                        dtype=torch.float64, interpret=interpret)
