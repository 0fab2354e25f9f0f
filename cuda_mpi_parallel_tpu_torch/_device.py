"""Device resolution and the Hopper capability gate.

The port's entry points run on the card unless the caller asks for the
CPU: an operator's ``device=None`` means ``"cuda"``, and ``"cpu"`` (what
the tests pass) is the only way onto the host.  Without a CUDA device an
unspecified device is an error, never a silent fall back to the CPU.

The hand kernels are built for ``sm_90a`` (Hopper), so a CUDA tensor on
any other card is refused before a launch.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising if there is none); anything else as
    given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the card "
                "by default; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the host")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple:
    return torch.cuda.get_device_capability(index)


def is_hopper(device) -> bool:
    """True for a CUDA device of capability 9.x (the kernels' target)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return False
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _capability(index)[0] == 9


def require_hopper(device, what: str) -> None:
    """Raise unless ``device`` is a CUDA device of capability 9.x."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"{what}: the hand kernel needs a CUDA tensor, got a tensor "
            f"on {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: got a CUDA tensor but no CUDA device is available")
    if not is_hopper(device):
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        raise RuntimeError(
            f"{what}: the hand kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} has capability "
            f"{_capability(index)}")
