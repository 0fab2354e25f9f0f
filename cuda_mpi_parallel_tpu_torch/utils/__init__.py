"""Utilities: timing, structured logging, autotuning and checkpointing
(reference: the dead ``cpuSecond`` helper at ``CUDACG.cu:35-39`` and
nothing else).

``utils.tune`` is the JAX package's autotuner (``autotune``,
``solve_tuned``) and its measured-artifact disk cache (``JsonCache``).
``utils.checkpoint`` (import it by name: it imports the solvers) is the
JAX package's checkpoint/resume with its npz file format - the
resumable single-device, f64 and distributed loops, the fingerprints
and the typed ``CheckpointMismatch``/``CheckpointCorrupt``."""

from . import logging, timing, tune

__all__ = ["logging", "timing", "tune"]
