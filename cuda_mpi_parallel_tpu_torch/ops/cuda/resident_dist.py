"""Hopper distributed resident CG (B12): every shard's whole solve in one
cooperative launch, and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/resident_dist.py``
(``cg_resident_dist_local``, kernel ``_resident_dist_kernel``, and
``supports_resident_dist``).  The JAX kernel runs once per TPU chip and
moves halo rows and dot partials between chips by in-kernel remote DMA;
here the P shards of a mesh on one card are P groups of CTAs of one
launch of ``csrc/resident_dist.cu``, which exchange halo planes and
tagged dot rows through per-shard exchange regions laid out by
``csrc/resident_dist.cuh`` (the protocol is described in the source).
The slabs are stacked: ``b`` is ``(P, nx / P, ...)``.

On a CUDA tensor :func:`cg_resident_dist` launches B12 (counted under
``LAUNCHES["cg_resident_dist_local"]``) or raises; on a CPU tensor, or
with ``interpret=True``, it runs :func:`cg_resident_dist_plain`, the same
per-shard protocol in torch ops on the stacked slabs: the halos by a
masked roll, each shard's stencil with ``-scale * halo`` added to its
edge planes, and each dot as per-shard partials added in shard order.
Both return ``(x, iterations, rr, indefinite, converged, healthy,
hist)`` as B10's wrapper does, with ``x`` stacked like ``b``.

Capacity.  One shard's slab keeps B10's planes (five: b, x, r and p's
two buffers; seven with the preconditioner's two z buffers) plus its
exchange region; ``supports_resident_dist`` gates that against the L2
(the per-chip gate of the JAX package).  On one card the P slabs share
the L2, so :func:`check_shards_fit` gates the whole stacked grid and all
exchange regions - B10's gate on the global grid, plus the exchange
rows.  Both also hold the slab to the launch geometry: a shard takes
B10's CTAs per SM divided over the shards, and each CTA keeps shared
slots for the tiles it walks, at most 3 in 2D and 7 in 3D.  That
refuses slabs of many thin or ragged tiles which the L2 would hold: at
one shard on 132 SMs, more than 1,584 tiles of 8 x 256 points in 2D
(e.g. 6,337 x 280) or 1,848 of 8 x 8 x 32 in 3D; no square or cube is
among them (PERF.md lists the 2D widths).  The region's size and the
geometry are those of ``csrc/resident_dist.cuh``, which the kernel
compiles; the gate reads them through ``_build.host_library()`` (the
header built by the host's C++ compiler), so it decides the same on the
CPU as on the card, for the card's SM count and L2 (an H100's on the
CPU).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..._device import require_hopper
from ..chebyshev import chebyshev_steps
from . import _build
from .resident import (
    _ENV_OVERRIDE,
    _check_loop_args,
    _planes,
    _safe_div,
    card_of,
    vmem_bytes,
)
from .stencil import stencil2d_apply_plain, stencil3d_apply_plain

_NAME = "cg_resident_dist_local"


#: SMs of an H100 SXM: the card a CPU device stands for, as for the L2
_H100_SMS = 132


def sm_count(device=None) -> int:
    """SMs of the card ``device`` names (``None``: the current one when a
    card is present), else an H100's."""
    card = card_of(device)
    if card is None:
        return _H100_SMS
    return torch.cuda.get_device_properties(card).multi_processor_count


def _geometry(local_shape, n_shards: int, device):
    """``(fits, tiles)`` of B12's launch of ``n_shards`` slabs of
    ``local_shape`` (``dist_geometry`` of ``csrc/resident_dist.cuh``)."""
    n0, n1, n2, three_d = _build.grid_dims(local_shape)
    out = (ctypes.c_int64 * 3)()
    fits = _build.host_library().cmpt_resident_dist_geometry(
        n0, n1, n2, three_d, n_shards, sm_count(device), out)
    return bool(fits), int(out[0])


def _slab_bytes(local_shape, n_shards: int, preconditioned: bool) -> int:
    cells = math.prod(local_shape)
    plane = cells // local_shape[0]
    return (_planes(preconditioned) * cells * 4
            + _build.host_library().cmpt_resident_dist_exchange_bytes(
                plane, n_shards))


def supports_resident_dist(local_shape, device=None,
                           preconditioned: bool = False) -> bool:
    """Capacity gate of one shard's slab: B10's planes (five, seven with
    ``preconditioned``) and the exchange region within the budget of
    ``vmem_bytes(device)`` (the card's L2), and its tiles within the
    shared slots of one launch's CTAs."""
    local_shape = tuple(local_shape)
    if len(local_shape) not in (2, 3) or min(local_shape) < 1:
        return False
    return (_slab_bytes(local_shape, 1, preconditioned) <= vmem_bytes(device)
            and _geometry(local_shape, 1, device)[0])


def check_shards_fit(local_shape, n_shards: int, device=None,
                     preconditioned: bool = False) -> None:
    """Raise unless ``n_shards`` slabs on one card fit its L2 together
    (every slab's planes and every exchange region) and one launch's
    shared slots (each shard's CTAs hold its slab's tiles)."""
    local_shape = tuple(local_shape)
    need = n_shards * _slab_bytes(local_shape, n_shards, preconditioned)
    if need > vmem_bytes(device):
        raise ValueError(
            f"{n_shards} shards of {local_shape} on one card need "
            f"{need} bytes of resident planes and exchange regions > "
            f"{vmem_bytes(device)} (the card's L2; set {_ENV_OVERRIDE} to "
            f"override the budget)")
    if not _geometry(local_shape, n_shards, device)[0]:
        raise ValueError(
            f"{n_shards} shards of {local_shape} have more tiles than one "
            f"launch's CTAs hold in shared memory on {sm_count(device)} "
            f"SMs (thin or ragged slabs; see csrc/resident_dist.cuh)")


def _local_stencil(v: torch.Tensor, scale) -> torch.Tensor:
    """Each shard's zero-Dirichlet stencil of stacked slabs ``v``
    ``(P, ...)``: ``stencil2d/3d_apply_plain`` term for term, batched."""
    plain = stencil2d_apply_plain if v.ndim == 3 else stencil3d_apply_plain
    return torch.stack([plain(s, scale) for s in v.unbind(0)])


def _halo_stencil(v: torch.Tensor, scale) -> torch.Tensor:
    """``_resident_dist_kernel``'s ``stencil_with_halo`` on every shard:
    the local stencil plus ``-scale * halo`` on the edge planes, the
    halos by a masked roll (zeros at the global edges); one shard takes
    the plain stencil."""
    av = _local_stencil(v, scale)
    n = v.shape[0]
    if n == 1:
        return av
    above = torch.roll(v[:, -1:], 1, dims=0)
    above[0] = 0
    below = torch.roll(v[:, :1], -1, dims=0)
    below[-1] = 0
    if v.shape[1] >= 2:
        inner = torch.zeros((n, v.shape[1] - 2) + tuple(v.shape[2:]),
                            dtype=v.dtype, device=v.device)
        corr = torch.cat([-scale * above, inner, -scale * below], dim=1)
    else:
        corr = -scale * (above + below)
    return av + corr


def _allreduce(partials: torch.Tensor) -> torch.Tensor:
    """The per-shard partials ``(P,)`` added in shard order."""
    total = partials[0]
    for v in partials[1:]:
        total = total + v
    return total


def _shard_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _allreduce(torch.sum(u * v, dim=tuple(range(1, u.ndim))))


def cg_resident_dist_plain(scale, b: torch.Tensor, *, tol, rtol, cap,
                           nblocks: int, check_every: int, degree: int = 0,
                           lmin=0.0, lmax=1.0):
    """``_resident_dist_kernel``'s recurrence on stacked slabs ``b``
    ``(P, nx / P, ...)`` in torch ops - what B12 is held against.
    Returns ``(x, iterations, rr, indefinite, converged, healthy, hist)``
    (``x`` stacked, int32 flags, f32 ``rr``, the ``(nblocks + 1,)``
    ||r||^2 trace with -1 in blocks that never ran).  Elementwise
    arithmetic rounds as the kernel's does; each shard's sums run in
    torch's order, the shards' in shard order."""
    scale, tol, rtol, lmin, lmax = (_build.device_scalar(v, b, torch.float32)
                                    for v in (scale, tol, rtol, lmin, lmax))
    cap = int(cap)
    precond = None
    if degree > 0:
        theta, steps = chebyshev_steps(lmin, lmax, degree)

        def precond(r):
            d = r / theta
            z = d
            for c1, c2 in steps:
                d = c1 * d + c2 * (r - _halo_stencil(z, scale))
                z = z + d
            return z
    x, r = torch.zeros_like(b), b.clone()
    rr = _shard_dot(r, r)
    if precond is None:
        p, rho = r, rr
    else:
        p = precond(r)
        rho = _shard_dot(r, p)
    thresh = torch.maximum(tol, rtol * torch.sqrt(rr))
    thresh2 = thresh * thresh
    hist = torch.full((nblocks + 1,), -1.0, dtype=b.dtype, device=b.device)
    hist[0] = rr
    k = 0
    indefinite = torch.zeros((), dtype=torch.bool, device=b.device)
    for blk in range(nblocks):
        healthy = torch.isfinite(rr) & torch.isfinite(rho) & (rho > 0)
        if not (bool((rr >= thresh2) & (rr > 0) & healthy) and k < cap):
            break
        for _ in range(min(check_every, cap - k)):
            ap = _halo_stencil(p, scale)
            pap = _shard_dot(p, ap)
            indefinite = indefinite | ((pap <= 0) & (rr > 0))
            alpha = _safe_div(rho, pap)
            x = x + alpha * p
            r = r - alpha * ap
            rr = _shard_dot(r, r)
            if precond is None:
                z, rho_new = r, rr
            else:
                z = precond(r)
                rho_new = _shard_dot(r, z)
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


def _launch(scale, tol, rtol, lmin, lmax, cap, b: torch.Tensor, *,
            nblocks: int, check_every: int, degree: int):
    """One launch of B12 on stacked slabs ``b``; returns the stacked x
    and every shard's own outputs ``(rr (P,), flags (P, 4), hist (P,
    nblocks + 1))``, which the protocol makes bit-identical."""
    dev = b.device
    n_shards = b.shape[0]
    local = tuple(b.shape[1:])
    b = b.contiguous()
    params = torch.stack([_build.device_scalar(v, b, torch.float32)
                          for v in (scale, tol, rtol, lmin, lmax)])
    cap_t = _build.device_scalar(cap, b, torch.int32)
    x, r, p0, p1 = (torch.empty_like(b) for _ in range(4))
    z1 = torch.empty_like(b) if degree >= 2 else None
    z2 = torch.empty_like(b) if degree >= 3 else None
    n0, n1, n2, three_d = _build.grid_dims(local)

    def ptr(t):
        return None if t is None else t.data_ptr()
    fits, tiles = _geometry(local, n_shards, dev)
    if not fits:
        raise ValueError(f"{_NAME}: {n_shards} slabs of {local} do not fit "
                         f"one launch (check_shards_fit)")
    xbytes = _build.host_library().cmpt_resident_dist_exchange_bytes(
        n1 * n2, n_shards)
    with torch.cuda.device(dev):
        lib = _build.library()
        regions = torch.zeros(n_shards * xbytes, dtype=torch.uint8,
                              device=dev)
        peers = torch.tensor([regions.data_ptr() + s * xbytes
                              for s in range(n_shards)], dtype=torch.int64,
                             device=dev)
        partials = torch.empty(3 * n_shards * tiles, dtype=torch.float32,
                               device=dev)
        rr = torch.empty(n_shards, dtype=torch.float32, device=dev)
        flags = torch.empty((n_shards, 4), dtype=torch.int32, device=dev)
        hist = torch.empty((n_shards, nblocks + 1), dtype=torch.float32,
                           device=dev)
        code = lib.cmpt_cg_resident_dist(
            ptr(b), ptr(x), ptr(r), ptr(p0), ptr(p1), ptr(z2), ptr(z1),
            ptr(params), ptr(cap_t), ptr(partials), ptr(peers), ptr(rr),
            ptr(flags), ptr(hist), n0, n1, n2, three_d, n_shards, nblocks,
            check_every, degree, _build.stream_handle(dev))
        _build.check(code, _NAME)
    _build.LAUNCHES[_NAME] += 1
    return x, rr, flags, hist


def cg_resident_dist(scale, b: torch.Tensor, *, tol=0.0, rtol=0.0,
                     maxiter=2000, check_every=32, iter_cap=None, degree=0,
                     lmin=0.0, lmax=1.0, interpret=False, per_shard=False):
    """The whole distributed CG solve of stacked f32 slabs ``b`` ``(P,
    nx / P, ny[, nz])`` for the 5/7-point stencil: one launch of B12 on
    a CUDA tensor (one per solve, all P shards), the twin on a CPU
    tensor or with ``interpret=True``.

    ``scale``, ``tol``, ``rtol``, ``maxiter``, ``check_every``,
    ``iter_cap`` as for ``cg_resident_2d``; ``degree`` k > 0 applies the
    k-term Chebyshev preconditioner on ``[lmin, lmax]`` on every shard,
    each step with its own halo exchange.  Returns ``(x, iterations, rr,
    indefinite, converged, healthy, hist)`` with ``x`` stacked like
    ``b``.  ``per_shard=True`` (a launch only) returns instead ``(x, rr,
    flags, hist)`` with every shard's own copy of the scalars, flags
    ``(P, 4)`` = iterations, indefinite, converged, healthy."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b)
    if b.ndim not in (3, 4):
        raise ValueError(f"{_NAME}: b must be stacked 2D or 3D slabs (P, "
                         f"nx/P, ...), got shape {tuple(b.shape)}")
    if b.dtype != torch.float32:
        raise ValueError(f"{_NAME} is float32-only, got {b.dtype}")
    check_every = _check_loop_args(check_every, maxiter, degree)
    nblocks = -(-maxiter // check_every)
    cap = maxiter if iter_cap is None else iter_cap
    if interpret or b.device.type == "cpu":
        if per_shard:
            raise ValueError(f"{_NAME}: per_shard outputs come from a launch")
        return cg_resident_dist_plain(
            scale, b, tol=tol, rtol=rtol, cap=cap, nblocks=nblocks,
            check_every=check_every, degree=degree, lmin=lmin, lmax=lmax)
    require_hopper(b.device, _NAME)
    x, rr, flags, hist = _launch(scale, tol, rtol, lmin, lmax, cap, b,
                                 nblocks=nblocks, check_every=check_every,
                                 degree=int(degree))
    if per_shard:
        return x, rr, flags, hist
    return x, flags[0, 0], rr[0], flags[0, 1], flags[0, 2], flags[0, 3], \
        hist[0]


def blocks_per_sm(three_d: bool, precond: bool) -> int:
    """Resident CTAs per SM of a B12 instance on this card at the shared
    slots of the most tiles a CTA walks (what every launch takes, B10's
    occupancy, divided over the shards)."""
    n = _build.library().cmpt_cg_resident_dist_blocks_per_sm(
        int(three_d), int(precond))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: cudaError_t {-n}")
    return n
