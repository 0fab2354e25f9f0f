"""Hopper fused-CG passes (B3/B4, and B6/B7 in float64), the streamed
Chebyshev step (B5), and their plain PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/fused_cg.py``
(``fused_cg_pass_a`` / ``fused_cg_pass_b``, and the df64 passes
``fused_cg_pass_a_df64`` / ``fused_cg_pass_b_df64``): one streaming CG
iteration is two launches, the minimum the data flow allows (alpha needs
all of p.Ap before any x/r update, beta all of ||r||^2 before any p
update).  The df64 passes take native float64 planes where the JAX ones
take ``(hi, lo)`` f32 pairs; they have no ``theta`` and no ``with_rz``,
as the JAX ones have none, and their twins are the f32 passes' twins,
which compute in the planes' dtype.

* pass A: ``p_new = r/theta + beta * p`` (written) and
  ``pap = p_new . A p_new`` (``A p_new`` never stored);
* pass B: ``x += alpha p_new``, ``r -= alpha A p_new`` in place, with
  ``A p_new`` recomputed, and ``rr = r . r`` (plus
  ``rz = r . (r/theta)`` with ``with_rz``);
* Chebyshev step (``fused_cheb_step``): ``d' = c1 d + c2 (r - A z)``,
  ``z' = z + d'`` - one step of the streamed polynomial preconditioner,
  with ``z0 = d0 = r/theta`` formed on the fly in the first step and
  ``rho = r . z'`` summed in the last.

The scalars (scale, alpha, beta, theta) may be numbers or 0-d tensors;
on the card the kernels read them from device memory, so the solver
loop never waits on the host.  The sums are deterministic: per-block
partials, then an ordered fixed-tree sum in the same library - no float
atomics.  On a CPU tensor each wrapper runs its plain twin; on a CUDA
tensor it launches the hand kernel (``csrc/fused_cg.cu``) or raises.

``halos=`` (f32 passes): the neighbour shards' edge planes of a slab of
a row-partitioned grid, which replace the Dirichlet zero just outside
the slab along its first axis (the JAX ``_fill_edge_halo``): pass A
takes ``(r_lo, r_hi, p_lo, p_hi)`` and forms p_new there too, pass B
takes p_new's ``(pn_lo, pn_hi)``; each plane is ``(1,) + shape[1:]``.
The returned sums are then the slab's partials.  The df64 passes B6/B7
take no halos yet (ROADMAP A10 residue).
"""
from __future__ import annotations

import torch

from ..._device import require_hopper
from . import _build
from .stencil import stencil2d_apply_plain, stencil3d_apply_plain


def supports_streaming(shape, itemsize: int = 4) -> bool:
    """Shape gate of the f32 fused-CG kernels (B3/B4): a non-empty f32 2D
    or 3D grid.

    The Hopper tile walk masks ragged edges itself, so the TPU slab
    tiling rules (``nz % 128`` and the rest) do not apply; ``itemsize``
    is kept for the JAX signature and must be 4.  The f64 passes B6/B7
    take the same grids (``solver.streaming.supports_streaming_df64``)."""
    return (len(shape) in (2, 3) and min(shape) >= 1 and itemsize == 4)


def _stencil_plain(u, scale, lo=None, hi=None):
    """The plain stencil of ``u``; with ``lo``/``hi`` the planes just
    outside it along the first axis (halos) instead of zero."""
    apply = stencil2d_apply_plain if u.ndim == 2 else stencil3d_apply_plain
    if lo is None:
        return apply(u, scale)
    return apply(torch.cat([lo, u, hi]), scale)[1:-1]


def fused_cg_pass_a_plain(scale, beta, r, p, halos=None, *, theta=None,
                          out=None):
    """The arithmetic of pass A in plain torch ops."""
    div = 1.0 if theta is None else theta
    pnew = r / div + beta * p
    edges = (None, None)
    if halos is not None:
        r_lo, r_hi, p_lo, p_hi = halos
        edges = (r_lo / div + beta * p_lo, r_hi / div + beta * p_hi)
    pap = torch.sum(pnew * _stencil_plain(pnew, scale, *edges))
    if out is not None:
        out.copy_(pnew)
        pnew = out
    return pnew, pap


def fused_cg_pass_b_plain(scale, alpha, pnew, x, r, halos=None, *,
                          theta=None, with_rz: bool = False):
    """The arithmetic of pass B in plain torch ops (x, r in place)."""
    ap = _stencil_plain(pnew, scale, *(halos if halos is not None
                                       else (None, None)))
    x.add_(alpha * pnew)
    r.sub_(alpha * ap)
    rr = torch.sum(r * r)
    if with_rz:
        rz = torch.sum(r * (r / (1.0 if theta is None else theta)))
        return x, r, rr, rz
    return x, r, rr


def fused_cheb_step_plain(scale, theta, c1, c2, v, r=None, d=None, *,
                          first: bool, last: bool, out=None, d_out=None):
    """The arithmetic of one Chebyshev step in plain torch ops, in the
    JAX kernel's order (``out``/``d_out`` as for the kernel)."""
    if first:
        z = v / theta
        r, d = v, z
    else:
        z = v
    d_new = c1 * d + c2 * (r - _stencil_plain(z, scale))
    z_new = z + d_new
    if out is not None:
        out.copy_(z_new)
        z_new = out
    if d_out is not None:
        d_out.copy_(d_new)
        d_new = d_out
    if last:
        return z_new, d_new, torch.sum(r * z_new)
    return z_new, d_new


def fused_cheb_step(scale, theta, c1, c2, v: torch.Tensor, r=None, d=None,
                    *, first: bool, last: bool, out=None, d_out=None):
    """One streamed Chebyshev semi-iteration step (the JAX
    ``fused_cheb_step``).

    ``v`` is the stencil operand: the residual ``r`` itself when
    ``first`` (``z0 = d0 = v/theta`` is formed on the fly), else the
    current iterate ``z`` with ``r`` and ``d`` read alongside.  Returns
    ``(z_new, d_new)``, plus ``rho = r . z_new`` when ``last``.  ``out``
    takes ``z_new`` and must not alias ``v`` (neighbouring blocks still
    read it); ``d_out`` takes ``d_new`` and may be ``d`` itself (an
    in-place update).  The scalars may be numbers or 0-d tensors.
    """
    _check_grids("fused_cheb_step", torch.float32, v, None if first else r,
                 None if first else d, out, d_out)
    if not first and (r is None or d is None):
        raise ValueError("fused_cheb_step: a step after the first needs "
                         "r and d")
    if v.device.type == "cpu":
        return fused_cheb_step_plain(scale, theta, c1, c2, v, r, d,
                                     first=first, last=last, out=out,
                                     d_out=d_out)
    name = "fused_cheb_step"
    require_hopper(v.device, name)
    zout = torch.empty_like(v) if out is None else out
    dout = torch.empty_like(v) if d_out is None else d_out
    reads = {v.data_ptr()} | (set() if first
                              else {r.data_ptr(), d.data_ptr()})
    if zout.data_ptr() in reads | {dout.data_ptr()}:
        raise ValueError(f"{name}: out must not alias v, r, d or d_out")
    if dout.data_ptr() in reads - (set() if first else {d.data_ptr()}):
        raise ValueError(f"{name}: d_out may alias d, not v or r")
    lib = _build.library()
    s, t, k1, k2 = (_build.device_scalar(val, v)
                    for val in (scale, theta, c1, c2))
    n0, n1, n2, three_d = _build.grid_dims(v.shape)
    blocks = _tile_blocks(lib, name, n0, n1, n2, three_d)
    partials = torch.empty(blocks if last else 1, dtype=torch.float32,
                           device=v.device)
    res = torch.empty(1, dtype=torch.float32, device=v.device)
    _build.check(lib.cmpt_cheb_step(
        v.data_ptr(), None if first else r.data_ptr(),
        None if first else d.data_ptr(), zout.data_ptr(), dout.data_ptr(),
        s.data_ptr(), t.data_ptr(), k1.data_ptr(), k2.data_ptr(),
        n0, n1, n2, three_d, int(first), int(last), partials.data_ptr(),
        res.data_ptr(), _build.stream_handle(v.device)), name)
    _build.LAUNCHES[name] += 1
    if last:
        return zout, dout, res[0]
    return zout, dout


def fused_cg_pass_a(scale, beta, r: torch.Tensor, p: torch.Tensor,
                    halos=None, *, theta=None, out=None):
    """One streamed pass: ``p_new = r/theta + beta * p``;
    ``pap = p_new . A p_new``.  Returns ``(p_new, pap)``.

    ``r``/``p``: f32 grids ((nx, ny) or (nx, ny, nz)).  ``theta`` is the
    optional divisor of the r-term (default 1: exact, so the
    unpreconditioned trajectory is untouched).  ``out``: optional buffer
    for ``p_new``; it must not alias ``p``, whose neighbours other blocks
    still read (the solver keeps two direction buffers and swaps them).
    ``halos``: ``(r_lo, r_hi, p_lo, p_hi)`` of a slab (see the module
    docstring), or None.
    """
    _check_grids("fused_cg_pass_a", torch.float32, r, p, out)
    halos = _check_halos("fused_cg_pass_a", r, halos, 4)
    if r.device.type == "cpu":
        return fused_cg_pass_a_plain(scale, beta, r, p, halos, theta=theta,
                                     out=out)
    return _launch_pass_a("fused_cg_pass_a", scale, beta, r, p, theta, out,
                          halos)


def fused_cg_pass_a_df64(scale, beta, r: torch.Tensor, p: torch.Tensor, *,
                         out=None):
    """B6: pass A in float64 (the JAX ``fused_cg_pass_a_df64``):
    ``p_new = r + beta * p``; ``pap = p_new . A p_new``.  ``r``/``p``:
    f64 grids; the scalars numbers or 0-d tensors; ``out`` as for
    :func:`fused_cg_pass_a`.  Returns ``(p_new, pap)``."""
    _check_grids("fused_cg_pass_a_df64", torch.float64, r, p, out)
    if r.device.type == "cpu":
        return fused_cg_pass_a_plain(scale, beta, r, p, out=out)
    return _launch_pass_a("fused_cg_pass_a_df64", scale, beta, r, p, None,
                          out)


def _launch_pass_a(name, scale, beta, r, p, theta, out, halos=None):
    require_hopper(r.device, name)
    if out is not None and out.data_ptr() in (p.data_ptr(), r.data_ptr()):
        raise ValueError(f"{name}: out must not alias r or p")
    lib = _build.library()
    pnew = torch.empty_like(r) if out is None else out
    s = _build.device_scalar(scale, r)
    b = _build.device_scalar(beta, r)
    n0, n1, n2, three_d = _build.grid_dims(r.shape)
    partials = torch.empty(_tile_blocks(lib, name, n0, n1, n2, three_d),
                           dtype=r.dtype, device=r.device)
    res = torch.empty(1, dtype=r.dtype, device=r.device)
    planes = (r.data_ptr(), p.data_ptr(), pnew.data_ptr(), s.data_ptr(),
              b.data_ptr())
    tail = (n0, n1, n2, three_d, partials.data_ptr(), res.data_ptr(),
            _build.stream_handle(r.device))
    if r.dtype == torch.float32:
        t = None if theta is None else _build.device_scalar(theta, r)
        edges = ((None,) * 4 if halos is None
                 else tuple(h.data_ptr() for h in halos))
        code = lib.cmpt_cg_pass_a(*planes, None if t is None else t.data_ptr(),
                                  *edges, *tail)
    else:
        code = lib.cmpt_cg_pass_a_f64(*planes, *tail)
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    return pnew, res[0]


def fused_cg_pass_b(scale, alpha, pnew: torch.Tensor, x: torch.Tensor,
                    r: torch.Tensor, halos=None, *, theta=None,
                    with_rz: bool = False):
    """One streamed pass: ``x += alpha p``, ``r -= alpha A p``,
    ``rr = r . r``, with ``A p`` recomputed from ``p_new`` rather than
    read back.  ``x`` and ``r`` are updated IN PLACE and returned:
    ``(x, r, rr)``, or ``(x, r, rr, rz)`` with ``with_rz`` where
    ``rz = r . (r/theta)`` (the degree-1 Chebyshev rho).  ``halos``:
    p_new's ``(pn_lo, pn_hi)`` of a slab, or None.
    """
    _check_grids("fused_cg_pass_b", torch.float32, pnew, x, r)
    halos = _check_halos("fused_cg_pass_b", pnew, halos, 2)
    if pnew.device.type == "cpu":
        return fused_cg_pass_b_plain(scale, alpha, pnew, x, r, halos,
                                     theta=theta, with_rz=with_rz)
    return _launch_pass_b("fused_cg_pass_b", scale, alpha, pnew, x, r, theta,
                          with_rz, halos)


def fused_cg_pass_b_df64(scale, alpha, pnew: torch.Tensor, x: torch.Tensor,
                         r: torch.Tensor):
    """B7: pass B in float64 (the JAX ``fused_cg_pass_b_df64``):
    ``x += alpha p``, ``r -= alpha A p`` IN PLACE, ``rr = r . r``.
    Returns ``(x, r, rr)``."""
    _check_grids("fused_cg_pass_b_df64", torch.float64, pnew, x, r)
    if pnew.device.type == "cpu":
        return fused_cg_pass_b_plain(scale, alpha, pnew, x, r)
    return _launch_pass_b("fused_cg_pass_b_df64", scale, alpha, pnew, x, r,
                          None, False)


def _launch_pass_b(name, scale, alpha, pnew, x, r, theta, with_rz,
                   halos=None):
    require_hopper(pnew.device, name)
    ptrs = {pnew.data_ptr(), x.data_ptr(), r.data_ptr()}
    if len(ptrs) != 3:
        raise ValueError(f"{name}: pnew, x and r must be distinct buffers")
    lib = _build.library()
    s = _build.device_scalar(scale, x)
    a = _build.device_scalar(alpha, x)
    n0, n1, n2, three_d = _build.grid_dims(x.shape)
    nsum = 2 if with_rz else 1
    partials = torch.empty(
        nsum * _tile_blocks(lib, name, n0, n1, n2, three_d),
        dtype=x.dtype, device=x.device)
    res = torch.empty(nsum, dtype=x.dtype, device=x.device)
    planes = (pnew.data_ptr(), x.data_ptr(), r.data_ptr(), s.data_ptr(),
              a.data_ptr())
    tail = (partials.data_ptr(), res.data_ptr(),
            _build.stream_handle(x.device))
    if x.dtype == torch.float32:
        t = None if theta is None else _build.device_scalar(theta, x)
        edges = ((None,) * 2 if halos is None
                 else tuple(h.data_ptr() for h in halos))
        code = lib.cmpt_cg_pass_b(*planes, None if t is None else t.data_ptr(),
                                  *edges, n0, n1, n2, three_d, int(with_rz),
                                  *tail)
    else:
        code = lib.cmpt_cg_pass_b_f64(*planes, n0, n1, n2, three_d, *tail)
    _build.check(code, name)
    _build.LAUNCHES[name] += 1
    if with_rz:
        return x, r, res[0], res[1]
    return x, r, res[0]


def _tile_blocks(lib, name, n0, n1, n2, three_d) -> int:
    blocks = lib.cmpt_tile_blocks(n0, n1, n2, three_d)
    if blocks <= 0:
        raise ValueError(f"{name}: grid ({n0}, {n1}, {n2}) needs more "
                         f"blocks than one launch allows")
    return blocks


def _check_halos(name, grid, halos, count):
    """``halos`` as a tuple of ``count`` contiguous f32 planes ``(1,) +
    grid.shape[1:]`` on ``grid``'s device, or None."""
    if halos is None:
        return None
    halos = tuple(halos)
    if len(halos) != count:
        raise ValueError(f"{name}: halos must hold {count} planes, got "
                         f"{len(halos)}")
    plane = (1,) + tuple(grid.shape[1:])
    for h in halos:
        if tuple(h.shape) != plane or h.dtype != grid.dtype \
                or h.device != grid.device:
            raise ValueError(f"{name}: each halo must be a {grid.dtype} "
                             f"plane {plane} on {grid.device}, got "
                             f"{tuple(h.shape)} {h.dtype} on {h.device}")
    return tuple(h.contiguous() for h in halos)


def _check_grids(name, dtype, first, *others):
    if first.ndim not in (2, 3):
        raise ValueError(f"{name}: expected a 2D or 3D grid, got shape "
                         f"{tuple(first.shape)}")
    for t in (first,) + others:
        if t is None:
            continue
        if t.shape != first.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(first.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {str(dtype)[6:]} grids only, got "
                            f"{t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{first.device}")
        if t.device.type != "cpu" and not t.is_contiguous():
            raise ValueError(f"{name}: grids must be contiguous")
