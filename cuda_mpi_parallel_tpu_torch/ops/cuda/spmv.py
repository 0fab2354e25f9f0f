"""Hopper SpMV for assembled matrices (B8 in f32, B9 in f64): the
sliced-ELL packer, the kernel's wrapper and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/spmv.py``
(``pack_shift_ell`` / ``shift_ell_matvec``, and ``pack_shift_ell_df64``
/ ``shift_ell_matvec_df64``, whose ``(hi, lo)`` f32 planes become native
float64 values here).  The TPU's shift-ELL sheets
exist to feed its lane gather from a VMEM-resident x; Hopper gathers from
L1/L2 with no such limit, so the layout here is sliced ELL: rows in slices
of 32 (one warp), each slice padded to its own longest row, values and
int32 columns slot-major within the slice, -1 marking a padding slot.
The packer is host numpy, run once per matrix; there is no x budget.

On a CPU tensor :func:`shift_ell_matvec` runs :func:`shift_ell_matvec_plain`;
on a CUDA tensor it launches ``csrc/spmv.cu`` - B8 on f32 values and x,
B9 on f64 ones (counted as ``shift_ell_matvec_df64``, the JAX name) - or
raises.  Both add a row's slots in CSR order, so they agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..._device import require_hopper
from . import _build

SLICE = 32  # rows per slice: one warp


class SlicedELL(NamedTuple):
    """Host arrays of :func:`pack_sliced_ell`.  Slot k of row
    ``32 s + l`` lives at ``slice_ptr[s] + 32 k + l``."""

    vals: np.ndarray       # (n_slots,) the matrix dtype; 0 in padding
    cols: np.ndarray       # (n_slots,) int32; -1 in padding
    slice_ptr: np.ndarray  # (ceil(n / 32) + 1,) int64, first slot per slice
    n: int


def pack_sliced_ell(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, n: int) -> SlicedELL:
    """CSR -> sliced ELL.  Slot k of a row holds the row's k-th CSR entry
    (duplicates kept: the matvec sums them, as CSR's does)."""
    data = np.asarray(data)
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"sliced ELL takes float32/float64 values, got "
                         f"{data.dtype}")
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    if indptr.shape != (n + 1,):
        raise ValueError(f"indptr of length {indptr.shape[0]} for n={n}")
    row_len = np.diff(indptr)
    n_slices = -(-n // SLICE)
    lens = np.zeros(n_slices * SLICE, dtype=np.int64)
    lens[:n] = row_len
    width = lens.reshape(n_slices, SLICE).max(axis=1, initial=0)
    slice_ptr = np.concatenate([[0], np.cumsum(width * SLICE)]).astype(
        np.int64)
    vals = np.zeros(int(slice_ptr[-1]), dtype=data.dtype)
    cols = np.full(int(slice_ptr[-1]), -1, dtype=np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int64), row_len)
    slot = np.arange(rows.size, dtype=np.int64) - indptr[rows]
    pos = slice_ptr[rows // SLICE] + slot * SLICE + rows % SLICE
    vals[pos] = data[:rows.size]
    cols[pos] = indices[:rows.size]
    return SlicedELL(vals=vals, cols=cols, slice_ptr=slice_ptr, n=n)


def shift_ell_matvec_plain(x: torch.Tensor, vals: torch.Tensor,
                           cols: torch.Tensor, slice_ptr: torch.Tensor,
                           n: int) -> torch.Tensor:
    """``y = A x`` adding each row's slots in slot (CSR) order, one slot
    per step, as the kernel does; padding slots are skipped."""
    n_slices = slice_ptr.numel() - 1
    width = (slice_ptr[1:] - slice_ptr[:-1]) // SLICE
    y = torch.zeros(n_slices * SLICE,
                    dtype=torch.promote_types(vals.dtype, x.dtype),
                    device=x.device)
    lanes = torch.arange(SLICE, device=x.device)
    for k in range(int(width.max()) if n_slices else 0):
        live = torch.nonzero(width > k).squeeze(1)
        pos = ((slice_ptr[live] + k * SLICE)[:, None] + lanes).reshape(-1)
        rows = ((live * SLICE)[:, None] + lanes).reshape(-1)
        c = cols[pos]
        real = c >= 0
        pos, rows, c = pos[real], rows[real], c[real].long()
        y[rows] = y[rows] + vals[pos] * x[c]
    return y[:n]


def shift_ell_matvec(x: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor,
                     slice_ptr: torch.Tensor, n: int) -> torch.Tensor:
    """``y = A x`` with A packed by :func:`pack_sliced_ell` (``vals``,
    ``cols``, ``slice_ptr`` on ``x``'s device).  On the card ``x`` and
    ``vals`` are both float32 (B8) or both float64 (B9)."""
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"shift_ell_matvec: x of shape {tuple(x.shape)} "
                         f"for n={n}")
    if x.device.type == "cpu":
        return shift_ell_matvec_plain(x, vals, cols, slice_ptr, n)
    name = ("shift_ell_matvec_df64" if x.dtype == torch.float64
            else "shift_ell_matvec")
    require_hopper(x.device, name)
    if x.dtype not in (torch.float32, torch.float64) \
            or vals.dtype != x.dtype:
        raise TypeError(
            f"{name}: the kernels take float32 or float64 values and x of "
            f"one dtype (got x {x.dtype}, values {vals.dtype})")
    if cols.dtype != torch.int32 or slice_ptr.dtype != torch.int64:
        raise TypeError(f"{name}: int32 columns and int64 slice offsets "
                        f"expected, got {cols.dtype} and {slice_ptr.dtype}")
    for t in (vals, cols, slice_ptr):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the packed arrays must be contiguous")
    if slice_ptr.numel() != -(-n // SLICE) + 1:
        raise ValueError(f"{name}: {slice_ptr.numel()} slice offsets for "
                         f"n={n}")
    x = x.contiguous()
    lib = _build.library()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    fn = lib.cmpt_sliced_ell_spmv if x.dtype == torch.float32 \
        else lib.cmpt_sliced_ell_spmv_f64
    _build.check(fn(
        vals.data_ptr(), cols.data_ptr(), slice_ptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), n,
        _build.stream_handle(x.device)), name)
    _build.LAUNCHES[name] += 1
    return y
