"""Utilities: timing, structured logging and checkpointing (reference:
the dead ``cpuSecond`` helper at ``CUDACG.cu:35-39`` and nothing else).

``utils.checkpoint`` (import it by name: it imports the solvers) is the
JAX package's checkpoint/resume with its npz file format - the
resumable single-device, f64 and distributed loops, the fingerprints
and the typed ``CheckpointMismatch``/``CheckpointCorrupt``.  Autotuning
(the JAX package's ``utils.tune``) is not ported yet (ROADMAP A16)."""

from . import logging, timing

__all__ = ["logging", "timing"]
