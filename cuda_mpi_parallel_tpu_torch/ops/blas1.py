"""Level-1 vector operations in plain torch.

Counterpart of the JAX package's ``ops/blas1.py``: ``dot``,
``norm2_sq``, ``axpy``, ``xpby``, the fused inner products of the
single-reduction CG variants (``fused_dots``) and the compensated
(double-float) dots (``dot_compensated``, ``fused_dots_compensated``).
Scalars stay 0-d tensors on the vectors' device, so the solver loop
never copies one to the host between its convergence checks.

``axis_name`` names the mesh axis a dot reduces over, as in the JAX
package: inside a per-shard body (``parallel.comm.shard_map``) the
vectors are the local blocks of row-partitioned ones, shard axis first
(``parallel.comm``), each shard's partial is taken with the same
function as the single-device dot, and ONE ``psum`` of the bound comm
adds the partials in shard order.  The many-RHS forms come with
ROADMAP A14.
"""
from __future__ import annotations

import torch


def _shard_rows(axis_name, *tensors):
    """The comm bound to ``axis_name`` and each tensor as ``(L, -1)``:
    its L local shards' blocks, one per row."""
    from ..parallel.comm import resolve

    comm = resolve(axis_name)
    count = comm.local_count
    return comm, [t.reshape(count, -1) for t in tensors]


def dot(x: torch.Tensor, y: torch.Tensor, *, axis_name=None) -> torch.Tensor:
    """Inner product x . y as a 0-d tensor (grids are flattened, as
    ``jnp.vdot`` does); with ``axis_name``, the partial of each local
    shard and one psum over the mesh axis."""
    if axis_name is None:
        return torch.dot(x.reshape(-1), y.reshape(-1))
    comm, (xs, ys) = _shard_rows(axis_name, x, y)
    return comm.psum(torch.stack([torch.dot(xr, yr)
                                  for xr, yr in zip(xs, ys)]))


def norm2_sq(x: torch.Tensor, *, axis_name=None) -> torch.Tensor:
    """Squared 2-norm ||x||^2 (what the CG recurrence consumes)."""
    return dot(x, x, axis_name=axis_name)


def fused_dots(pairs, *, axis_name=None) -> torch.Tensor:
    """Several inner products as one stacked 1-D tensor: the one
    reduction per iteration of ``solver.cg(method="cg1")`` - one psum on
    a mesh, carrying every pair's partials."""
    if axis_name is None:
        return torch.stack([dot(x, y) for x, y in pairs])
    comm, flat = _shard_rows(axis_name, *[t for pair in pairs for t in pair])
    rows = [torch.stack([torch.dot(xs[s], ys[s])
                         for xs, ys in zip(flat[0::2], flat[1::2])])
            for s in range(comm.local_count)]
    return comm.psum(torch.stack(rows))


# -- Compensated (double-float) inner product ---------------------------------
#
# The JAX package's error-free transformations, operation for operation:
# a Veltkamp split and an add-only two-prod for the elementwise products,
# a two-sum pairwise tree for the summation, carrying a (hi, lo)
# accumulator.  Eager torch runs every operation as its own kernel, so
# nothing is contracted into an FMA and the transforms stay error-free.

def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth two-sum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split_const(dtype) -> float:
    # 2^ceil(p/2) + 1 for a p-bit significand: f32 p=24 -> 2^12+1
    return 134217729.0 if dtype == torch.float64 else 4097.0


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """``p + err == a * b`` to O(eps^2 |ab|): Veltkamp halves whose
    partial products are exact in the working precision, carried by an
    add-only two-sum chain (the JAX ``_two_prod``)."""
    c = _split_const(a.dtype)
    ac = a * c
    ah = ac - (ac - a)
    al = a - ah
    bc = b * c
    bh = bc - (bc - b)
    bl = b - bh
    p, e1 = _two_sum(ah * bh, al * bh)
    p, e2 = _two_sum(p, ah * bl)
    return p, (e1 + e2) + al * bl


def _sum_df(v: torch.Tensor):
    """Pairwise tree reduction over axis 0 with a two-sum-carried
    ``(hi, lo)`` accumulator; each level folds the second half onto the
    first, an odd level padded with one zero (the JAX ``_sum_df``'s
    pairing, so both packages add in the same order)."""
    hi = v
    lo = torch.zeros_like(v)
    while hi.shape[0] > 1:
        m = hi.shape[0]
        h = (m + 1) // 2
        if m % 2:
            pad = torch.zeros((1,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
            hi = torch.cat([hi, pad])
            lo = torch.cat([lo, pad])
        s, e = _two_sum(hi[:h], hi[h:])
        hi = s
        lo = lo[:h] + lo[h:] + e
    return hi[0], lo[0]


def _dot_df_local(x: torch.Tensor, y: torch.Tensor):
    """``(hi, lo)`` double-float partials of x . y: ``(n,)`` vectors, or
    ``(n, k)`` stacks giving per-column ``(k,)`` partials."""
    p, e = _two_prod(x, y)
    hi, lo = _sum_df(p)
    return hi, lo + torch.sum(e, dim=0)


def dot_compensated(x: torch.Tensor, y: torch.Tensor, *,
                    axis_name=None) -> torch.Tensor:
    """x . y with as-if-doubled precision (two-prod products, the
    double-float pairwise tree): within a few ulps of the correctly
    rounded dot.  ``cg(..., compensated=True)`` uses it.  With
    ``axis_name`` each shard's ``(hi, lo)`` partials ride ONE psum (the
    hi and the lo parts summed apart, as in the JAX package)."""
    if axis_name is None:
        hi, lo = _dot_df_local(x, y)
        return hi + lo
    comm, (xs, ys) = _shard_rows(axis_name, x, y)
    hl = comm.psum(torch.stack([torch.stack(_dot_df_local(xr, yr))
                                for xr, yr in zip(xs, ys)]))
    return hl[0] + hl[1]


def fused_dots_compensated(pairs, *, axis_name=None) -> list:
    """The compensated counterpart of :func:`fused_dots`: a list of 0-d
    tensors, one per pair; on a mesh every pair's ``(hi, lo)`` partials
    ride ONE psum, keeping cg1's one reduction per iteration."""
    if axis_name is None:
        parts = [_dot_df_local(x, y) for x, y in pairs]
        his = torch.stack([h for h, _ in parts])
        los = torch.stack([lo for _, lo in parts])
        return list(his + los)
    comm, flat = _shard_rows(axis_name, *[t for pair in pairs for t in pair])
    n = len(pairs)
    rows = []
    for s in range(comm.local_count):
        parts = [_dot_df_local(xs[s], ys[s])
                 for xs, ys in zip(flat[0::2], flat[1::2])]
        rows.append(torch.stack([h for h, _ in parts]
                                + [lo for _, lo in parts]))
    hl = comm.psum(torch.stack(rows))
    return list(hl[:n] + hl[n:])


def axpy(alpha: torch.Tensor, x: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x  (``cublasDaxpy``, ``CUDACG.cu:314,321,347``)."""
    return y + alpha * x


def xpby(x: torch.Tensor, beta: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """x + beta * y - the CG direction update."""
    return x + beta * y
