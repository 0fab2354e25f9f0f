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
    DIAMatrix,
    ELLMatrix,
    JacobiPreconditioner,
    LinearOperator,
    Stencil2D,
    Stencil3D,
)
from .models.multigrid import MultigridPreconditioner
from .models.precond import BlockJacobiPreconditioner, ChebyshevPreconditioner
from .solver.cg import CGCheckpoint
from .solver.df64 import DF64Checkpoint
from .solver.recycle import RecycleSpace


def operator_from_arrays(kind: str, arrays: dict, meta: dict,
                         device=None) -> LinearOperator:
    """The port's operator (or preconditioner) for JAX operator state.

    ``kind``: the JAX class name - ``"Stencil2D"``, ``"Stencil3D"``,
    ``"CSRMatrix"``, ``"ELLMatrix"``, ``"DIAMatrix"``,
    ``"ShiftELLMatrix"``, ``"ShiftELLDF64Matrix"``, ``"DenseOperator"``,
    ``"JacobiPreconditioner"``, ``"BlockJacobiPreconditioner"``,
    ``"ChebyshevPreconditioner"``, ``"MultigridPreconditioner"`` or
    ``"DistStencil3DPencil"`` (array ``scale``; meta ``local_grid``,
    ``axis_names``, ``shards`` and ``_dtype_name``).
    ``arrays``: its array leaves as numpy arrays keyed by field path (a
    leading ``"."``, as
    ``jax.tree_util.keystr`` writes it, is ignored).  ``meta``: its
    static fields - ``grid``, ``backend``, ``_dtype_name`` for the
    stencils, ``shape`` for CSR, ELL (arrays ``vals``, ``cols``) and DIA
    (array ``bands``, meta ``offsets`` too), ``dim`` for block-Jacobi,
    ``degree`` for Chebyshev.  A shift-ELL matrix is carried by the CSR
    arrays it was packed from (``data``, ``indices``, ``indptr`` and
    ``shape``):
    the TPU sheet layout is not carried over, the port packs its own; a
    ``ShiftELLDF64Matrix`` likewise, from CSR arrays with float64 data
    (its ``(hi, lo)`` sheets are TPU layout too).  A
    Chebyshev preconditioner carries its operator as the leaves under
    ``a.`` (``".a.scale"``) and ``meta["a"] = (kind, meta)`` of that
    operator, beside ``lmin`` and ``lmax``.  A multigrid preconditioner
    carries its level stencils as the leaves under ``ops[i].`` and
    ``global_ops[j].`` (``".ops[0].scale"``) and ``meta["ops"]`` /
    ``meta["global_ops"]``, the ``(kind, meta)`` of each level, beside
    ``omega``, ``pre_sweeps``, ``post_sweeps`` and ``coarse_sweeps``.
    ``device``: as for every operator (``None`` = cuda).
    """
    # copies: leaves of JAX arrays are read-only views
    arrays = {k.lstrip("."): np.array(v) for k, v in arrays.items()}
    if kind == "JacobiPreconditioner":
        return JacobiPreconditioner(
            inv_diag=_tensor(arrays["inv_diag"], device))
    if kind == "BlockJacobiPreconditioner":
        return BlockJacobiPreconditioner(
            inv_blocks=_tensor(arrays["inv_blocks"], device),
            dim=int(meta["dim"]))
    if kind == "ChebyshevPreconditioner":
        a_kind, a_meta = meta["a"]
        a = operator_from_arrays(
            a_kind, {k[2:]: v for k, v in arrays.items()
                     if k.startswith("a.")}, a_meta, device=device)
        return ChebyshevPreconditioner(
            a=a, lmin=_tensor(arrays["lmin"], device).reshape(()),
            lmax=_tensor(arrays["lmax"], device).reshape(()),
            degree=int(meta["degree"]))
    if kind == "MultigridPreconditioner":
        levels = {}
        for field in ("ops", "global_ops"):
            levels[field] = tuple(
                operator_from_arrays(
                    lkind, {k[len(f"{field}[{i}]."):]: v
                            for k, v in arrays.items()
                            if k.startswith(f"{field}[{i}].")},
                    lmeta, device=device)
                for i, (lkind, lmeta) in enumerate(meta.get(field, ())))
        return MultigridPreconditioner(
            **levels, omega=float(meta["omega"]),
            **{k: int(meta[k]) for k in ("pre_sweeps", "post_sweeps",
                                         "coarse_sweeps")})
    if kind in ("Stencil2D", "Stencil3D"):
        cls = Stencil2D if kind == "Stencil2D" else Stencil3D
        grid = tuple(int(g) for g in meta["grid"])
        if len(grid) != (2 if kind == "Stencil2D" else 3):
            raise ValueError(f"{kind} with grid {grid}")
        return cls.create(*grid, scale=float(arrays["scale"]),
                          dtype=meta["_dtype_name"], backend=meta["backend"],
                          device=device)
    if kind == "DistStencil3DPencil":
        from .parallel.operators import DistStencil3DPencil

        (lnx, lny, nz), (sx, sy) = meta["local_grid"], meta["shards"]
        return DistStencil3DPencil.create(
            (int(lnx) * int(sx), int(lny) * int(sy), int(nz)),
            (int(sx), int(sy)), axis_names=tuple(meta["axis_names"]),
            scale=float(arrays["scale"]), dtype=meta["_dtype_name"],
            device=device)
    if kind in ("CSRMatrix", "ShiftELLMatrix", "ShiftELLDF64Matrix"):
        csr = CSRMatrix.from_arrays(
            arrays["data"], arrays["indices"], arrays["indptr"],
            tuple(int(s) for s in meta["shape"]), device=device)
        if kind == "ShiftELLDF64Matrix":
            return csr.to_shiftell_df64()
        return csr if kind == "CSRMatrix" else csr.to_shiftell()
    if kind == "ELLMatrix":
        return ELLMatrix(
            vals=_tensor(arrays["vals"], device),
            cols=_tensor(arrays["cols"].astype(np.int32), device),
            shape=tuple(int(s) for s in meta["shape"]))
    if kind == "DIAMatrix":
        return DIAMatrix(
            bands=_tensor(arrays["bands"], device),
            offsets=tuple(int(k) for k in meta["offsets"]),
            shape=tuple(int(s) for s in meta["shape"]))
    if kind == "DenseOperator":
        return DenseOperator.create(arrays["a"], device=device)
    raise TypeError(f"no port of a {kind!r} operator in this slice")


def _tensor(value: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(value, device=resolve_device(device))


def df64_checkpoint_from_arrays(fields: dict, device=None) -> DF64Checkpoint:
    """The port's ``DF64Checkpoint`` from a JAX one's fields as arrays
    (``{"x_hi": ..., "k": ..., "indefinite": ...}``, each field through
    ``np.asarray``).  It carries the pairs only; the resumed solve
    recombines them to float64.  A JAX ``(hi, lo)`` pair itself needs
    no helper: the f64 lane's entries take it as it is, and
    ``ops.df64.pair_to_f64`` recombines one."""
    dev = resolve_device(device)
    pairs = {k: torch.as_tensor(np.array(fields[k], dtype=np.float32),
                                device=dev)
             for k in ("x_hi", "x_lo", "r_hi", "r_lo", "p_hi", "p_lo",
                       "rho_hi", "rho_lo", "rr_hi", "rr_lo", "rr0_hi",
                       "rr0_lo")}
    return DF64Checkpoint(
        **pairs,
        k=torch.as_tensor(int(np.asarray(fields["k"])), dtype=torch.int32,
                          device=dev),
        indefinite=torch.as_tensor(bool(np.asarray(fields["indefinite"])),
                                   device=dev))


def checkpoint_from_arrays(fields: dict, device=None) -> CGCheckpoint:
    """The port's ``CGCheckpoint`` from a JAX one's fields as arrays
    (``{"x": ..., "r": ..., "k": ..., "indefinite": ...}``, each field
    through ``np.asarray``): the vectors and scalars keep their dtype, so
    ``solve(..., resume_from=...)`` continues the JAX trajectory."""
    dev = resolve_device(device)
    arrays = {k: torch.as_tensor(np.array(fields[k]), device=dev)
              for k in ("x", "r", "p")}
    scalars = {k: torch.as_tensor(np.array(fields[k]), device=dev).reshape(())
               for k in ("rho", "rr", "nrm0")}
    return CGCheckpoint(
        **arrays, **scalars,
        k=torch.as_tensor(int(np.asarray(fields["k"])), dtype=torch.int32,
                          device=dev),
        indefinite=torch.as_tensor(bool(np.asarray(fields["indefinite"])),
                                   device=dev))


def recycle_space_from_arrays(fields: dict, device=None) -> RecycleSpace:
    """The port's ``solver.recycle.RecycleSpace`` from a JAX one: ``w``,
    ``aw`` and ``chol`` as arrays (``np.asarray`` of each field) and its
    ``n``, ``k`` and ``layout``.  The layout token is the operator's
    fingerprint, the JAX package's bytes, so a space the JAX package
    harvested deflates the port's solve of the same matrix (and any other
    operator refuses it with ``RecycleMismatch``)."""
    dev = resolve_device(device)
    return RecycleSpace(
        **{k: torch.as_tensor(np.array(fields[k]), device=dev)
           for k in ("w", "aw", "chol")},
        n=int(fields["n"]), k=int(fields["k"]), layout=str(fields["layout"]))
