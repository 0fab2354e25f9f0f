"""The double-float ``(hi, lo)`` pair surface of the f64 lane.

Counterpart of the JAX package's ``ops/df64.py``.  A TPU has no f64
units, so the JAX package stores every f64-class value as an unevaluated
pair of f32 words ``hi + lo`` and computes with error-free transforms.
An H100 has native float64, so the port computes in float64 and keeps
only the pair at its edges: ``(hi, lo)`` inputs are recombined as
``hi.double() + lo.double()``, results are split as :func:`split_f64`
splits them.  The error-free
``add``/``mul``/``div``/``dot`` have no use here and are not ported.

A pair carries about 48 significand bits, a float64 53: a value split
and recombined comes back within ``2**-47`` relative, not bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def split_f64(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split of float64 data into an ``(hi, lo)`` f32 pair:
    ``hi`` the nearest f32, ``lo`` the nearest f32 to the remainder."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(hi, lo) -> np.ndarray:
    """Host-side recombination to float64 numpy."""
    return (np.asarray(_host(hi), dtype=np.float64)
            + np.asarray(_host(lo), dtype=np.float64))


def from_f32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Promote an f32 tensor to a pair (exact: lo = 0)."""
    return x, torch.zeros_like(x)


def const(v: float, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float as a pair of 0-d f32 tensors."""
    hi, lo = split_f64(np.float64(v))
    return (torch.as_tensor(hi, device=device),
            torch.as_tensor(lo, device=device))


def pair_to_f64(hi, lo) -> torch.Tensor:
    """An ``(hi, lo)`` pair as one float64 tensor: ``hi.double() +
    lo.double()``, the pair's value to float64's last bit (exact for a
    pair split from a float64).  The words may be tensors or arrays."""
    return _tensor(hi).double() + _tensor(lo).double()


def f64_to_pair(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float64 tensor split as :func:`split_f64` splits it, on its own
    device."""
    hi = x.to(torch.float32)
    return hi, (x - hi.double()).to(torch.float32)


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
