"""Utilities: timing and structured logging (reference: the dead
``cpuSecond`` helper at ``CUDACG.cu:35-39`` and nothing else).
Checkpointing and autotuning (the JAX package's ``utils.checkpoint`` and
``utils.tune``) are not ported yet."""

from . import logging, timing

__all__ = ["logging", "timing"]
