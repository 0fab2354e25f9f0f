"""Carry an operator of the JAX package across to the port.

The JAX operators are pytrees; their state is a set of array leaves plus
static metadata.  ``operator_from_arrays`` rebuilds the port's operator
from that state given as numpy arrays and plain values, so both packages
solve the same system.  It imports no JAX: the caller flattens the JAX
operator (``jax.tree_util.tree_flatten_with_path``) and reads its meta
fields.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.operators import (
    CSRMatrix,
    DenseOperator,
    LinearOperator,
    Stencil2D,
    Stencil3D,
)


def operator_from_arrays(kind: str, arrays: dict, meta: dict,
                         device=None) -> LinearOperator:
    """The port's operator for JAX operator state.

    ``kind``: the JAX class name - ``"Stencil2D"``, ``"Stencil3D"``,
    ``"CSRMatrix"`` or ``"DenseOperator"``.  ``arrays``: its array
    leaves as numpy arrays keyed by field name (a leading ``"."``, as
    ``jax.tree_util.keystr`` writes it, is ignored).  ``meta``: its static
    fields - ``grid``, ``backend``, ``_dtype_name`` for the stencils,
    ``shape`` for CSR.  ``device``: as for every operator (``None`` =
    cuda).
    """
    # copies: leaves of JAX arrays are read-only views
    arrays = {k.lstrip("."): np.array(v) for k, v in arrays.items()}
    if kind in ("Stencil2D", "Stencil3D"):
        cls = Stencil2D if kind == "Stencil2D" else Stencil3D
        grid = tuple(int(g) for g in meta["grid"])
        if len(grid) != (2 if kind == "Stencil2D" else 3):
            raise ValueError(f"{kind} with grid {grid}")
        return cls.create(*grid, scale=float(arrays["scale"]),
                          dtype=meta["_dtype_name"], backend=meta["backend"],
                          device=device)
    if kind == "CSRMatrix":
        device = resolve_device(device)
        index = {k: torch.as_tensor(arrays[k], dtype=torch.int32,
                                    device=device)
                 for k in ("indices", "indptr", "rows")}
        return CSRMatrix(data=torch.as_tensor(arrays["data"], device=device),
                         shape=tuple(int(s) for s in meta["shape"]), **index)
    if kind == "DenseOperator":
        return DenseOperator.create(arrays["a"], device=device)
    raise TypeError(f"no port of a {kind!r} operator in this slice")
