"""Hopper stencil kernels (B1/B2) and their plain PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/stencil.py``:
``stencil2d_apply`` / ``stencil3d_apply`` compute
``y = scale * (Laplacian of x)`` with zero Dirichlet edges.  On a CPU
tensor the wrapper runs the plain twin; on a CUDA tensor it launches the
hand kernel (``csrc/stencil.cu``) or raises - it never falls back.  The
twins are also the operators' ``backend="xla"`` path.

The column-stack instances ``stencil2d_apply_cols`` /
``stencil3d_apply_cols`` apply the stencil to every grid of a stack
``(k, *grid)`` (grid after grid in memory: the column-major ``(n, k)``
stacks of the many-RHS solvers) in ONE launch, each grid bit for bit as
a single launch on it - the port of the JAX package's vmapped stencil
call.  Their twins apply the plain formulas over the batch axis.
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


def stencil2d_apply_cols_plain(xs: torch.Tensor, scale) -> torch.Tensor:
    """:func:`stencil2d_apply_plain` over a stack ``(k, nx, ny)``, term
    for term, so each grid is its plain twin's bits."""
    up = F.pad(xs, (1, 1, 1, 1))
    y = (4.0 * xs
         - up[:, :-2, 1:-1] - up[:, 2:, 1:-1]
         - up[:, 1:-1, :-2] - up[:, 1:-1, 2:])
    return scale * y


def stencil3d_apply_cols_plain(xs: torch.Tensor, scale) -> torch.Tensor:
    """:func:`stencil3d_apply_plain` over a stack ``(k, nx, ny, nz)``."""
    up = F.pad(xs, (1, 1, 1, 1, 1, 1))
    y = (6.0 * xs
         - up[:, :-2, 1:-1, 1:-1] - up[:, 2:, 1:-1, 1:-1]
         - up[:, 1:-1, :-2, 1:-1] - up[:, 1:-1, 2:, 1:-1]
         - up[:, 1:-1, 1:-1, :-2] - up[:, 1:-1, 1:-1, 2:])
    return scale * y


def stencil2d_apply(x2d: torch.Tensor, scale) -> torch.Tensor:
    """y = scale * (5-point Laplacian) of an (nx, ny) grid (Dirichlet).
    ``scale`` is a number or a 0-d tensor (read on the device)."""
    return _apply(x2d, scale, "stencil2d_apply", "an (nx, ny) grid", 2,
                  stencil2d_apply_plain)


def stencil3d_apply(x3d: torch.Tensor, scale) -> torch.Tensor:
    """y = scale * (7-point Laplacian) of an (nx, ny, nz) grid
    (Dirichlet)."""
    return _apply(x3d, scale, "stencil3d_apply", "an (nx, ny, nz) grid", 3,
                  stencil3d_apply_plain)


def stencil2d_apply_cols(xs: torch.Tensor, scale) -> torch.Tensor:
    """:func:`stencil2d_apply` of each grid of a stack ``(k, nx, ny)``,
    one launch for all ``k``."""
    return _apply(xs, scale, "stencil2d_apply_cols", "a (k, nx, ny) stack",
                  3, stencil2d_apply_cols_plain, stack=True)


def stencil3d_apply_cols(xs: torch.Tensor, scale) -> torch.Tensor:
    """:func:`stencil3d_apply` of each grid of a stack
    ``(k, nx, ny, nz)``, one launch for all ``k``."""
    return _apply(xs, scale, "stencil3d_apply_cols",
                  "a (k, nx, ny, nz) stack", 4, stencil3d_apply_cols_plain,
                  stack=True)


def _apply(x: torch.Tensor, scale, name: str, what: str, ndim: int, plain,
           stack: bool = False) -> torch.Tensor:
    """``plain`` on a CPU tensor, else one launch counted under ``name``:
    a single grid is the stack launch at k = 1."""
    if x.ndim != ndim:
        raise ValueError(f"{name} needs {what}, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain(x, scale)
    require_hopper(x.device, name)
    return _launch(x, scale, name) if stack else _launch(x[None], scale,
                                                         name)[0]


def _launch(xs: torch.Tensor, scale, name: str) -> torch.Tensor:
    if xs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 grids only, got "
                        f"{xs.dtype}")
    if not xs.is_contiguous():
        raise ValueError(f"{name}: the grid must be contiguous")
    k = xs.shape[0]
    if not 1 <= k <= 65535:
        raise ValueError(f"{name}: 1 to 65535 grids a launch, got {k}")
    lib = _build.library()
    s = _build.device_scalar(scale, xs)
    y = torch.empty_like(xs)
    n0, n1, n2, three_d = _build.grid_dims(xs.shape[1:])
    fn = lib.cmpt_stencil_f32 if xs.dtype == torch.float32 \
        else lib.cmpt_stencil_f64
    _build.check(fn(xs.data_ptr(), y.data_ptr(), s.data_ptr(), n0, n1, n2,
                    three_d, k, _build.stream_handle(xs.device)), name)
    _build.LAUNCHES[name] += 1
    return y
