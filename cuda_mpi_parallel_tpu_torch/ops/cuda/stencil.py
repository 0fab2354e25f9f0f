"""Hopper stencil kernels (B1/B2) and their plain PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/stencil.py``:
``stencil2d_apply`` / ``stencil3d_apply`` compute
``y = scale * (Laplacian of x)`` with zero Dirichlet edges.  On a CPU
tensor the wrapper runs the plain twin; on a CUDA tensor it launches the
hand kernel (``csrc/stencil.cu``) or raises - it never falls back.  The
twins are also the operators' ``backend="xla"`` path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..._device import require_hopper
from . import _build


def stencil2d_apply_plain(x2d: torch.Tensor, scale) -> torch.Tensor:
    """5-point ``scale * (4u - up - down - left - right)``, the JAX
    formula term for term (``models/operators.py`` ``Stencil2D.matvec``)."""
    up = F.pad(x2d, (1, 1, 1, 1))
    y = (4.0 * x2d
         - up[:-2, 1:-1] - up[2:, 1:-1]
         - up[1:-1, :-2] - up[1:-1, 2:])
    return scale * y


def stencil3d_apply_plain(x3d: torch.Tensor, scale) -> torch.Tensor:
    """7-point ``scale * (6u - six neighbours)``, the JAX formula term
    for term (``models/operators.py`` ``Stencil3D.matvec``)."""
    up = F.pad(x3d, (1, 1, 1, 1, 1, 1))
    y = (6.0 * x3d
         - up[:-2, 1:-1, 1:-1] - up[2:, 1:-1, 1:-1]
         - up[1:-1, :-2, 1:-1] - up[1:-1, 2:, 1:-1]
         - up[1:-1, 1:-1, :-2] - up[1:-1, 1:-1, 2:])
    return scale * y


def stencil2d_apply(x2d: torch.Tensor, scale) -> torch.Tensor:
    """y = scale * (5-point Laplacian) of an (nx, ny) grid (Dirichlet).
    ``scale`` is a number or a 0-d tensor (read on the device)."""
    if x2d.ndim != 2:
        raise ValueError(f"stencil2d_apply needs an (nx, ny) grid, got "
                         f"shape {tuple(x2d.shape)}")
    if x2d.device.type == "cpu":
        return stencil2d_apply_plain(x2d, scale)
    return _launch(x2d, scale, "stencil2d_apply")


def stencil3d_apply(x3d: torch.Tensor, scale) -> torch.Tensor:
    """y = scale * (7-point Laplacian) of an (nx, ny, nz) grid
    (Dirichlet)."""
    if x3d.ndim != 3:
        raise ValueError(f"stencil3d_apply needs an (nx, ny, nz) grid, got "
                         f"shape {tuple(x3d.shape)}")
    if x3d.device.type == "cpu":
        return stencil3d_apply_plain(x3d, scale)
    return _launch(x3d, scale, "stencil3d_apply")


def _launch(x: torch.Tensor, scale, name: str) -> torch.Tensor:
    require_hopper(x.device, name)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 grids only, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the grid must be contiguous")
    lib = _build.library()
    s = _build.device_scalar(scale, x)
    y = torch.empty_like(x)
    n0, n1, n2, three_d = _build.grid_dims(x.shape)
    fn = lib.cmpt_stencil_f32 if x.dtype == torch.float32 \
        else lib.cmpt_stencil_f64
    _build.check(fn(x.data_ptr(), y.data_ptr(), s.data_ptr(), n0, n1, n2,
                    three_d, _build.stream_handle(x.device)), name)
    _build.LAUNCHES[name] += 1
    return y
