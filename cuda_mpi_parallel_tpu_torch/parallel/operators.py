"""Distributed (per-shard) linear operators.

Counterpart of the JAX package's ``parallel/operators.py``.  Each class
applies the local block of a row-partitioned global operator inside a
comm scope (``parallel.comm``), doing its own communication:

* ``DistStencil2D/3D`` - matrix-free Poisson slabs; the neighbour planes
  come by halo exchange (``parallel.halo``).  ``backend="pallas"`` runs
  the hand stencil kernel (B1/B2) unchanged on each local slab, with
  its zero Dirichlet edges, and adds ``-scale * halo`` to the edge rows
  - the stencil is linear, so the two are exactly the neighbour terms;
  ``"xla"`` runs the plain shifted adds over the halo-extended slab.
* ``DistStencil3DPencil`` - the 3D Poisson block over a 2-D mesh, one
  halo plane a side on each of two partitioned axes.
* ``DistCSR`` - general sparsity; the matvec all-gathers x (one
  collective) and multiplies the local row block.
* ``DistCSRGather`` - the same product with only the coupled x entries
  shipped, by the compiled rounds of ``parallel.exchange``.
* ``DistCSRRing`` - x-blocks rotate around the ring in ``n_shards``
  steps, each step multiplying the slab of the resident block.
* ``DistShiftELLRing`` / ``DistShiftELLDF64Ring`` - the same ring, each
  step's slabs one launch of the hand SpMV (B8 in f32, B9 in f64).

Inside a scope every per-shard tensor carries the shard axis first
(``L`` local shards: all P of a stacked mesh, 1 on a process group), so
the fields of the CSR operators are ``(L, ...)`` stacks and a vector is
the shard-major ``(L * n_local,)``; ``shape`` is ``(L * n_local, ...)``.
Each shard's block is multiplied by the same function on either comm,
so a stacked solve and a process-group solve give the same bits.

The CSR products sum each row's entries in order (``ops.spmv``), which
needs sorted row ids: each operator sorts its padded blocks once,
stably, when it is built (the zero padding entries join row 0's end).

``DistStencil3DPencil`` partitions two grid axes over a 2-D mesh: its
vectors are the shard-major pencils (``to_pencils``/``from_pencils``
move between them and natural order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.operators import (
    LinearOperator,
    _dtype_name,
    _on,
    _resolve_backend,
    torch_dtype,
)
from ..ops import df64, spmv
from ..ops.cuda import spmv as hk_spmv
from ..ops.cuda import stencil as hk
from . import comm as cm
from .halo import (
    exchange_halo,
    exchange_halo_axis,
    rotation_perm,
    validate_permutation,
)


def _shard_blocks(op, x):
    """``(u, lo, hi)``: ``x`` as ``(L, *local_grid)`` local slabs and
    their neighbour planes ``(L, 1, ...)`` (zeros at the global edges,
    and for a lone shard outside any scope)."""
    lead = cm.local_count(op.axis_name)
    u = x.reshape((lead,) + tuple(op.local_grid))
    try:
        cm.resolve(op.axis_name)
    except NameError:
        if op.n_shards != 1:
            raise
        zero = torch.zeros_like(u[:, :1])
        return u, zero, zero
    lo, hi = exchange_halo(u, op.axis_name, op.n_shards)
    return u, lo, hi


def _stencil_slabs(op, x, apply, extended):
    """The slab stencil of ``DistStencil2D/3D``: per shard, the hand
    kernel (or its twin on the CPU) plus the edge corrections for
    ``backend="pallas"``; the plain formula over the halo-extended slabs
    for ``"xla"``."""
    u, lo, hi = _shard_blocks(op, x)
    if op.backend == "pallas":
        out = []
        for s in range(u.shape[0]):
            y = apply(u[s].contiguous(), op.scale)
            y[0] = y[0] + (-op.scale * lo[s, 0])
            y[-1] = y[-1] + (-op.scale * hi[s, 0])
            out.append(y)
        return torch.stack(out).reshape(-1)
    return (op.scale * extended(u, torch.cat([lo, u, hi], dim=1))).reshape(-1)


def _ext_2d(u, ue):
    ue = torch.nn.functional.pad(ue, (1, 1))        # (L, lnx + 2, ny + 2)
    return (4.0 * u
            - ue[:, :-2, 1:-1] - ue[:, 2:, 1:-1]
            - ue[:, 1:-1, :-2] - ue[:, 1:-1, 2:])


def _ext_3d(u, ue):
    ue = torch.nn.functional.pad(ue, (1, 1, 1, 1))
    return (6.0 * u
            - ue[:, :-2, 1:-1, 1:-1] - ue[:, 2:, 1:-1, 1:-1]
            - ue[:, 1:-1, :-2, 1:-1] - ue[:, 1:-1, 2:, 1:-1]
            - ue[:, 1:-1, 1:-1, :-2] - ue[:, 1:-1, 1:-1, 2:])


class _DistStencil(LinearOperator):
    """What the 2D and 3D slabs share."""

    @property
    def shape(self):
        n = cm.local_count(self.axis_name)
        for g in self.local_grid:
            n *= g
        return (n, n)

    @property
    def dtype(self):
        return getattr(torch, self._dtype_name)

    @property
    def device(self):
        return self.scale.device

    @classmethod
    def _make(cls, global_grid, n_shards, axis_name, scale, dtype, backend,
              device):
        if global_grid[0] % n_shards:
            raise ValueError(
                f"grid x-extent {global_grid[0]} not divisible by "
                f"{n_shards} shards")
        dtype = torch_dtype(dtype)
        local = (global_grid[0] // n_shards,) + tuple(global_grid[1:])
        backend = _resolve_backend(backend, local, dtype.itemsize)
        from .._device import resolve_device

        return cls(scale=_on(scale, resolve_device(device), dtype).reshape(()),
                   local_grid=local, axis_name=axis_name, n_shards=n_shards,
                   backend=backend, _dtype_name=_dtype_name(dtype))


@dataclasses.dataclass(frozen=True)
class DistStencil2D(_DistStencil):
    """Local block of a 2D 5-point Poisson operator, partitioned on the
    x-axis (the JAX ``DistStencil2D``; ``device`` as the port's
    operators take it)."""

    scale: torch.Tensor
    local_grid: Tuple[int, int]   # (local_nx, ny)
    axis_name: str
    n_shards: int
    backend: str = "xla"
    _dtype_name: str = "float32"

    @classmethod
    def create(cls, global_grid, n_shards, axis_name="rows", scale=1.0,
               dtype=torch.float32, backend: str = "xla", device=None):
        return cls._make(global_grid, n_shards, axis_name, scale, dtype,
                         backend, device)

    def matvec(self, x):
        return _stencil_slabs(self, x, hk.stencil2d_apply, _ext_2d)

    def diagonal(self):
        return torch.full((self.shape[0],), 4.0, dtype=self.dtype,
                          device=self.device) * self.scale


@dataclasses.dataclass(frozen=True)
class DistStencil3D(_DistStencil):
    """Local block of the 3D 7-point Poisson operator (BASELINE config
    #4, the north star at 256^3), partitioned on the leading grid axis;
    per matvec each shard exchanges one (ny, nz) plane with each
    neighbour."""

    scale: torch.Tensor
    local_grid: Tuple[int, int, int]  # (local_nx, ny, nz)
    axis_name: str
    n_shards: int
    backend: str = "xla"
    _dtype_name: str = "float32"

    @classmethod
    def create(cls, global_grid, n_shards, axis_name="rows", scale=1.0,
               dtype=torch.float32, backend: str = "xla", device=None):
        return cls._make(global_grid, n_shards, axis_name, scale, dtype,
                         backend, device)

    def matvec(self, x):
        return _stencil_slabs(self, x, hk.stencil3d_apply, _ext_3d)

    def diagonal(self):
        return torch.full((self.shape[0],), 6.0, dtype=self.dtype,
                          device=self.device) * self.scale


@dataclasses.dataclass(frozen=True)
class DistStencil3DPencil(LinearOperator):
    """Pencil-decomposed 3D 7-point Poisson block: TWO partitioned grid
    axes over a 2-D mesh (the JAX ``DistStencil3DPencil``; ``device`` as
    the port's operators take it).

    Each shard owns an ``(lnx, lny, nz)`` pencil and exchanges one
    boundary plane per partitioned axis and side per matvec - four
    ``ppermute``s, the x planes over ``axis_names[0]`` and the y planes
    over ``axis_names[1]``.  Inner products reduce over both axes (the
    solver's ``axis_name=("rows", "cols")``).  The matvec is plain torch,
    the JAX formula term for term, as the JAX pencil has no Pallas
    matvec; a float64 instance serves the f64 lane."""

    scale: torch.Tensor
    local_grid: Tuple[int, int, int]   # (lnx, lny, nz)
    axis_names: Tuple[str, str]        # (x-axis name, y-axis name)
    shards: Tuple[int, int]            # (sx, sy)
    _dtype_name: str = "float32"

    @classmethod
    def create(cls, global_grid, shards, axis_names=("rows", "cols"),
               scale=1.0, dtype=torch.float32, device=None):
        from .._device import resolve_device

        nx, ny, nz = global_grid
        sx, sy = shards
        if nx % sx or ny % sy:
            raise ValueError(
                f"grid ({nx}, {ny}) not divisible by shards ({sx}, {sy})")
        dtype = torch_dtype(dtype)
        return cls(scale=_on(scale, resolve_device(device), dtype).reshape(()),
                   local_grid=(nx // sx, ny // sy, nz),
                   axis_names=tuple(axis_names), shards=(sx, sy),
                   _dtype_name=_dtype_name(dtype))

    @property
    def shape(self):
        lnx, lny, nz = self.local_grid
        n = cm.local_count(self.axis_names) * lnx * lny * nz
        return (n, n)

    @property
    def dtype(self):
        return getattr(torch, self._dtype_name)

    @property
    def device(self):
        return self.scale.device

    def matvec(self, x):
        lnx, lny, nz = self.local_grid
        u = x.reshape((cm.local_count(self.axis_names), lnx, lny, nz))
        x_lo, x_hi = _pencil_halo(u, self.axis_names[0], self.shards[0], 0)
        y_lo, y_hi = _pencil_halo(u, self.axis_names[1], self.shards[1], 1)
        ue = torch.cat([x_lo, u, x_hi], dim=1)     # (L, lnx+2, lny, nz)
        # corner cells are never read by the 7-point stencil: zero-pad the
        # y-halo planes at the x ends to align shapes
        pad_c = u.new_zeros((u.shape[0], 1, 1, nz))
        y_lo = torch.cat([pad_c, y_lo, pad_c], dim=1)
        y_hi = torch.cat([pad_c, y_hi, pad_c], dim=1)
        ue = torch.cat([y_lo, ue, y_hi], dim=2)    # (L, lnx+2, lny+2, nz)
        ue = torch.nn.functional.pad(ue, (1, 1))
        y = (6.0 * u
             - ue[:, :-2, 1:-1, 1:-1] - ue[:, 2:, 1:-1, 1:-1]
             - ue[:, 1:-1, :-2, 1:-1] - ue[:, 1:-1, 2:, 1:-1]
             - ue[:, 1:-1, 1:-1, :-2] - ue[:, 1:-1, 1:-1, 2:])
        return (self.scale * y).reshape(-1)

    def diagonal(self):
        return torch.full((self.shape[0],), 6.0, dtype=self.dtype,
                          device=self.device) * self.scale


def _pencil_halo(u, axis_name, n_shards, dim):
    """``exchange_halo_axis`` of the ``(L, lnx, lny, nz)`` pencils along
    local grid axis ``dim``; zero planes without a collective (and
    outside any scope) on an axis of one shard."""
    if n_shards == 1:
        shape = list(u.shape)
        shape[dim + 1] = 1
        zero = u.new_zeros(shape)
        return zero, zero
    return exchange_halo_axis(u, axis_name, n_shards, dim)


def to_pencils(x, grid, shards) -> torch.Tensor:
    """A global vector in natural ``(nx, ny, nz)`` order as the
    shard-major concatenation of its ``(sx, sy)`` pencils (shard ``(i,
    j)`` at ``i * sy + j``): a transpose of blocks."""
    nx, ny, nz = grid
    sx, sy = shards
    return (x.reshape(sx, nx // sx, sy, ny // sy, nz)
            .permute(0, 2, 1, 3, 4).reshape(-1))


def from_pencils(x, grid, shards) -> torch.Tensor:
    """The inverse of :func:`to_pencils`: natural order again."""
    nx, ny, nz = grid
    sx, sy = shards
    return (x.reshape(sx, sy, nx // sx, ny // sy, nz)
            .permute(0, 2, 1, 3, 4).reshape(-1))


def _sorted_by_row(data, cols, rows):
    """Each shard's entries ``(L, m)`` stably sorted by row id, so the
    ordered segment sums of ``ops.spmv`` apply; a row's entries keep
    their order."""
    order = torch.argsort(rows.long(), dim=1, stable=True)
    return (torch.gather(data, 1, order), torch.gather(cols, 1, order),
            torch.gather(rows, 1, order))


def _csr_rows(data, cols, rows, x_of, n_local):
    """Per local shard ``s``: its block against ``x_of(s)``,
    concatenated shard-major."""
    return torch.cat([spmv.csr_matvec(data[s], cols[s], rows[s], x_of(s),
                                      n_local)
                      for s in range(data.shape[0])])


def _csr_rows_many(data, cols, rows, x_of, n_local):
    """:func:`_csr_rows` for column stacks: per local shard its block
    against the stack ``x_of(s)`` (``ops.spmv.csr_matmat``: each column
    the matvec's bits), concatenated shard-major, column-major."""
    return torch.cat([spmv.csr_matmat(data[s], cols[s], rows[s], x_of(s),
                                      n_local).t()
                      for s in range(data.shape[0])], dim=1).t()


def _csr_diag(data, cols, rows, offsets, n_local):
    """Per local shard: the entries with ``cols == rows + offset``."""
    out = []
    for s in range(data.shape[0]):
        on_diag = cols[s] == rows[s] + offsets[s]
        out.append(torch.segment_reduce(
            torch.where(on_diag, data[s], torch.zeros_like(data[s])), "sum",
            offsets=spmv._segment_offsets(rows[s], n_local)))
    return torch.cat(out)


class _DistCSRBase(LinearOperator):
    @property
    def shape(self):
        lead = cm.local_count(self.axis_name)
        return (lead * self.n_local, self.n_local * self.n_shards)

    @property
    def dtype(self):
        return self._data0().dtype

    @property
    def device(self):
        return self._data0().device

    def _data0(self):
        return self.data

    def __post_init__(self):
        object.__setattr__(self, "_rows_sorted", _sorted_by_row(
            self.data, self.cols, self.local_rows))

    def local_apply(self, x_of, stack: bool = False):
        """The local-SpMV phase over per-shard inputs: local shard ``s``'s
        block against ``x_of(s)`` (its gathered or extended x, or ``(.,
        k)`` stack when ``stack``), concatenated shard-major - the hook
        through which a fault plan poisons one shard's received
        payload (``robust.inject``)."""
        rows = _csr_rows_many if stack else _csr_rows
        return rows(*self._rows_sorted, x_of, self.n_local)


@dataclasses.dataclass(frozen=True)
class DistCSR(_DistCSRBase):
    """Local row blocks of a partitioned general CSR matrix: ``cols``
    hold global column ids; the matvec all-gathers x and gathers
    locally.  Fields are ``partition.partition_csr``'s ``(L, m)`` rows
    of this process's shards."""

    data: torch.Tensor        # (L, max_local_nnz)
    cols: torch.Tensor        # (L, max_local_nnz) global column ids
    local_rows: torch.Tensor  # (L, max_local_nnz) in [0, n_local)
    n_local: int
    axis_name: str
    n_shards: int

    def gather_x(self, x):
        """The halo-exchange phase alone: the full x (or ``(n, k)``
        stack) on every shard, by one all_gather."""
        lead = cm.local_count(self.axis_name)
        return cm.resolve(self.axis_name).all_gather(
            x.reshape((lead, self.n_local) + tuple(x.shape[1:])))

    def local_matvec(self, x_full):
        """The local-SpMV phase alone: each shard's block against the
        gathered x."""
        return _csr_rows(*self._rows_sorted, lambda s: x_full, self.n_local)

    def matvec(self, x):
        return self.local_matvec(self.gather_x(x))

    def matmat(self, x):
        """All ``k`` columns of the local stack ``(L * n_local, k)``
        through ONE all_gather of the ``(n_local, k)`` blocks, then each
        shard's block against the gathered stack; column ``j`` is
        ``matvec`` of column ``j`` bit for bit."""
        full = self.gather_x(x)
        return self.local_apply(lambda s: full, stack=True)

    def diagonal(self):
        ids = cm.shard_ids(self.axis_name)
        return _csr_diag(*self._rows_sorted,
                         [s * self.n_local for s in ids], self.n_local)


@dataclasses.dataclass(frozen=True)
class DistCSRGather(_DistCSRBase):
    """Gather-exchange distributed CSR: per compiled round, each shard
    gathers exactly the local entries a peer's rows reference
    (``send_idx``) and ships them with one rotation ``ppermute``;
    ``cols`` were remapped host-side into the extended-x layout
    ``[local block | round-1 recv | ...]``, so the local multiply sums
    the same entries in the same order as ``DistCSR`` - the same bits,
    fewer bytes moved."""

    data: torch.Tensor                  # (L, max_local_nnz)
    cols: torch.Tensor                  # (L, max_local_nnz) extended-local
    local_rows: torch.Tensor            # (L, max_local_nnz) in [0, n_local)
    send_idx: Tuple[torch.Tensor, ...]  # per round: (L, m_r) local offsets
    shifts: Tuple[int, ...]             # per round: ring rotation shift
    n_local: int
    axis_name: str
    n_shards: int

    def exchange_round(self, x, i: int):
        """Round ``i`` alone: each shard's coupled entries for rotation
        peer ``shifts[i]``, shipped by one ``ppermute`` (of all columns
        of a stack ``(L * n_local, k)``)."""
        perm = rotation_perm(self.n_shards, self.shifts[i])
        xb = x.reshape((-1, self.n_local) + tuple(x.shape[1:]))
        idx = self.send_idx[i].long()
        payload = torch.stack([xb[s][idx[s]] for s in range(xb.shape[0])])
        return cm.resolve(self.axis_name).ppermute(payload, perm)

    def extend_x(self, x):
        """Every round, and the extended-x layout ``[local block | round
        recvs...]`` of each shard, ``(L, n_local + halo width)`` (and a
        trailing ``k`` for a stack)."""
        parts = [x.reshape((-1, self.n_local) + tuple(x.shape[1:]))]
        for i in range(len(self.shifts)):
            parts.append(self.exchange_round(x, i))
        return torch.cat(parts, dim=1)

    def local_matvec(self, x_ext):
        """The local-SpMV phase alone, over the extended x."""
        return _csr_rows(*self._rows_sorted, lambda s: x_ext[s],
                         self.n_local)

    def matvec(self, x):
        return self.local_matvec(self.extend_x(x))

    def matmat(self, x):
        """The same gather rounds, each shipping an ``(m_r, k)`` slab of
        all ``k`` columns (extended x becomes extended X, the schedule
        unchanged); column ``j`` is ``matvec`` of column ``j`` bit for
        bit."""
        x_ext = self.extend_x(x)
        return self.local_apply(lambda s: x_ext[s], stack=True)

    def diagonal(self):
        # own-block cols are remapped to [0, n_local); halo ids start at
        # n_local, so only own-block diagonal entries match
        return _csr_diag(*self._rows_sorted,
                         [0] * self.data.shape[0], self.n_local)


@dataclasses.dataclass(frozen=True)
class DistCSRRing(_DistCSRBase):
    """Ring-scheduled distributed CSR: the x-blocks rotate around the
    ring in ``n_shards`` steps; at step ``t`` shard ``i`` holds block
    ``(i + t) % n`` and multiplies its slab for it
    (``partition.ring_partition_csr``'s per-step ``(L, m_t)`` slabs)."""

    data: Tuple[torch.Tensor, ...]        # per step: (L, m_t) slab values
    cols: Tuple[torch.Tensor, ...]        # per step: block-relative cols
    local_rows: Tuple[torch.Tensor, ...]  # per step: in [0, n_local)
    n_local: int
    axis_name: str
    n_shards: int

    def _data0(self):
        return self.data[0]

    def __post_init__(self):
        object.__setattr__(self, "_rows_sorted", tuple(
            _sorted_by_row(d, c, r) for d, c, r
            in zip(self.data, self.cols, self.local_rows)))

    def rotate(self, xb):
        """One ring rotation of the resident x-blocks ``(L, n_local)``:
        afterwards shard ``i`` holds block ``i + 1``."""
        ring = validate_permutation(
            (j, (j - 1) % self.n_shards) for j in range(self.n_shards))
        return cm.resolve(self.axis_name).ppermute(xb, ring)

    def step_matvec(self, t: int, xb):
        """Step ``t``'s slab multiply against the resident blocks."""
        return _csr_rows(*self._rows_sorted[t], lambda s: xb[s],
                         self.n_local)

    def matvec(self, x):
        y = torch.zeros_like(x)
        xb = x.reshape(-1, self.n_local)
        for t in range(self.n_shards):
            y = y + self.step_matvec(t, xb)
            if t + 1 < self.n_shards:
                xb = self.rotate(xb)
        return y

    def diagonal(self):
        # the diagonal lives in the own-block slab (step 0)
        return _csr_diag(*self._rows_sorted[0], [0] * self.data[0].shape[0],
                         self.n_local)


@dataclasses.dataclass(frozen=True)
class _ShiftELLRing:
    """What the f32 and f64 shift-ELL rings share: the fields, and the
    ring product over the hand SpMV (B8 on float32, B9 on float64)."""

    vals: Tuple[torch.Tensor, ...]       # per step: (n_slots,) stacked slab
    cols: Tuple[torch.Tensor, ...]       # per step: int32, -1 in padding
    slice_ptr: Tuple[torch.Tensor, ...]  # per step: int64 slice offsets
    diag: torch.Tensor                   # (L * n_local,)
    h: Optional[int]
    kc: int
    n_local: int
    axis_name: str
    n_shards: int

    @property
    def shape(self):
        lead = cm.local_count(self.axis_name)
        return (lead * self.n_local, self.n_local * self.n_shards)

    @property
    def device(self):
        return self.diag.device

    rotate = DistCSRRing.rotate

    def step_matvec(self, t: int, xb):
        """Step ``t``'s slabs against the resident blocks ``(L,
        n_local)``: one launch for the L local shards."""
        x = xb.reshape(-1)
        return hk_spmv.shift_ell_matvec(x, self.vals[t], self.cols[t],
                                        self.slice_ptr[t], x.shape[0])

    def _ring_product(self, x):
        y = torch.zeros_like(x)
        xb = x.reshape(-1, self.n_local)
        for t in range(self.n_shards):
            y = y + self.step_matvec(t, xb)
            if t + 1 < self.n_shards:
                xb = self.rotate(xb)
        return y


@dataclasses.dataclass(frozen=True)
class DistShiftELLRing(_ShiftELLRing, LinearOperator):
    """Ring-scheduled distributed SpMV on the hand kernel B8: the x-block
    rotation of ``DistCSRRing``, each step's slab multiply one launch of
    ``ops.cuda.spmv.shift_ell_matvec`` over the L local shards' stacked
    slabs (``partition.stack_ring_step``), so P launches a matvec
    whatever L is.  The step products add in step order.  Built from
    ``partition.ring_partition_shiftell``; ``h``/``kc`` are the JAX
    sheet geometry, carried and unread."""

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x):
        return self._ring_product(x)

    def diagonal(self):
        return self.diag


@dataclasses.dataclass(frozen=True)
class DistShiftELLDF64Ring(_ShiftELLRing):
    """The f64 ring on the hand kernel B9: ``DistShiftELLRing`` on float64
    slabs (``partition.ring_partition_shiftell_df64``), the reference's
    ``CUDA_R_64F`` CSR SpMV (``CUDACG.cu:216,288``) over the mesh.  The
    JAX class rotates ``(hi, lo)`` f32 planes and adds the step products
    in double-float; here x and the sums are float64.  Like the JAX class
    it is not a ``LinearOperator``: ``matvec_df``/``diagonal_df`` take
    and give ``(hi, lo)`` pairs, and ``matvec64`` is the float64 product
    ``solve_distributed_df64`` runs."""

    def matvec64(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring_product(x)

    def matvec_df(self, x):
        return df64.f64_to_pair(self.matvec64(df64.pair_to_f64(*x).to(
            self.device)))

    def diagonal_df(self):
        return df64.f64_to_pair(self.diag)
