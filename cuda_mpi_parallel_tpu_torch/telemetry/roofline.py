"""Analytic roofline model: achieved vs attainable, per solve.

Counterpart of the JAX package's ``telemetry/roofline.py``.  The flight
recorder says how the *iterates* behaved; :mod:`.cost` says what the
solve *does* per iteration.  This module closes the last gap - how fast
the hardware could have done it.  A CG iteration is streaming-bound
almost everywhere, so the classic roofline (Williams et al., CACM 2009)
applies directly:

* a **machine model** - peak memory bytes/s, peak FLOP/s, and (for
  meshes) interconnect bytes/s.  A CUDA card is priced from the
  published peaks of its part (NVIDIA data sheets; the H100 family, by
  ``torch.cuda.get_device_name``), its capacity read from the device;
  CPU hosts are **self-calibrated** with a tiny one-shot benchmark (a
  streaming triad for bytes/s, a small matmul for FLOP/s) cached on disk
  by ``utils.tune.JsonCache``;
* a **traffic model** - FLOPs and memory bytes per iteration from the
  solver recurrence (``cost.analytic_solve_ops``: spmv/dot/axpy counts)
  and the operator's nnz, plus per-iteration communication payload bytes
  from the comm-layer :class:`~.cost.SolveCost`;
* the **join** - a measured wall time against the model's per-iteration
  time bound, giving achieved-vs-peak efficiency %, arithmetic
  intensity, and a bound classification (memory- / compute- /
  communication-bound: whichever term dominates the model time).

Everything is host arithmetic on already-synced scalars - the solve is
never touched.  Efficiency can legitimately exceed 100% when the model
is pessimistic for a given shape (e.g. a resident solve whose working
set lives in L2 and never streams HBM); the number is a *ruler*, not a
grade.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np

from .cost import analytic_solve_ops

__all__ = [
    "CPU_MODEL_MAX_AGE_S",
    "DEFAULT_GATHER_SLOWDOWN",
    "MachineModel",
    "RooflineReport",
    "analyze",
    "machine_model",
    "operator_nnz",
    "solve_traffic",
]

#: Effective slowdown of per-slot sparse-gather work versus the streaming
#: bandwidth a machine model quotes (the per-entry x gather is random
#: access).  8 is the deliberately conservative table default.
DEFAULT_GATHER_SLOWDOWN = 8.0

#: Published peaks of the NVIDIA parts the hand kernels target (sm_90),
#: from NVIDIA's H100 and H200 data sheets, by the name
#: ``torch.cuda.get_device_name`` reports: HBM bytes/s, float32 and
#: float64 FLOP/s outside the tensor cores, and interconnect bytes/s per
#: direction - half the data sheets' bidirectional NVLink figure (900
#: GB/s for the SXM parts, 600 GB/s for the NVL bridge) or, for the PCIe
#: card, half of PCIe Gen5 x16's 128 GB/s.  Matched most specific first.
_CUDA_PEAKS = (
    ("H100 PCIe", (2.0e12, 51e12, 26e12, 6.4e10)),
    ("H100 NVL", (3.9e12, 60e12, 30e12, 3.0e11)),
    ("H200", (4.8e12, 67e12, 34e12, 4.5e11)),
    ("H100", (3.35e12, 67e12, 34e12, 4.5e11)),
)

#: Conservative fallback when the backend is unknown - close to a modest
#: server core.  No ``hbm_bytes``: an unknown device's capacity stays
#: unknown.
_GENERIC_MODEL = dict(name="generic", mem_bytes_per_s=1.0e10,
                      flops_per_s=5.0e9, net_bytes_per_s=1.0e9,
                      source="table")

#: Disk-cached CPU self-calibrations older than this are re-measured
#: (a week: host hardware does not drift, but kernels/libraries do).
CPU_MODEL_MAX_AGE_S = 7 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Peak rates the roofline measures against (the JAX package's
    fields and JSON).

    ``gather_slowdown`` prices per-slot sparse-gather work against the
    streaming ``mem_bytes_per_s``; ``created_at`` is the unix stamp of a
    measured (calibrated) model - ``None`` for timeless table entries;
    ``hbm_bytes`` the per-device memory capacity (``None`` = unknown);
    ``per_link`` optional per-link wire bandwidths ``((ring shift,
    bytes/s), ...)``.
    """

    name: str
    mem_bytes_per_s: float
    flops_per_s: float
    net_bytes_per_s: Optional[float] = None
    source: str = "table"          # "table" | "calibrated"
    gather_slowdown: float = DEFAULT_GATHER_SLOWDOWN
    created_at: Optional[float] = None
    hbm_bytes: Optional[float] = None
    per_link: Optional[Tuple[Tuple[int, float], ...]] = None

    @property
    def ridge_flops_per_byte(self) -> float:
        """Arithmetic intensity where compute overtakes memory."""
        return self.flops_per_s / self.mem_bytes_per_s

    @property
    def age_s(self) -> Optional[float]:
        """Seconds since this model was measured (None for tables)."""
        if self.created_at is None:
            return None
        return max(time.time() - self.created_at, 0.0)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "MachineModel":
        if not isinstance(data, dict):
            # a truncated/hand-edited cache entry whose payload is JSON
            # but not an object must surface as the TypeError the cache
            # readers treat as a miss
            raise TypeError(
                f"machine model JSON must be an object, got "
                f"{type(data).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in fields}
        if kwargs.get("per_link") is not None:
            kwargs["per_link"] = tuple(
                (int(s), float(b)) for s, b in kwargs["per_link"])
        return cls(**kwargs)


def published_peaks(device_name: str) -> Tuple[float, float, float, float]:
    """``(HBM bytes/s, f32 FLOP/s, f64 FLOP/s, interconnect bytes/s)`` of
    the card named ``device_name`` (``torch.cuda.get_device_name``),
    from the table above; ``RuntimeError`` for a part it does not
    list."""
    for key, peaks in _CUDA_PEAKS:
        if key in device_name:
            return peaks
    raise RuntimeError(f"no published peaks for {device_name!r}")


def _cuda_model(device_name: str, total_memory: float) -> MachineModel:
    """The table model of one card: its part's published peaks and the
    capacity the device reports."""
    mem, f32, _f64, net = published_peaks(device_name)
    return MachineModel(name=device_name, mem_bytes_per_s=mem,
                        flops_per_s=f32, net_bytes_per_s=net,
                        source="table", hbm_bytes=float(total_memory))


def _calibrate_cpu() -> MachineModel:
    """One-shot CPU self-benchmark: a streaming triad (3 arrays x 8 MB,
    well past L2) for bytes/s and a small f64 matmul for FLOP/s.
    Best-of-3, ~tens of ms total."""
    n = 2_000_000
    a = np.ones(n, dtype=np.float32)
    b = np.ones(n, dtype=np.float32)
    out = np.empty(n, dtype=np.float32)
    tri_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.multiply(a, 1.5, out=out)
        out += b
        tri_times.append(time.perf_counter() - t0)
    # triad traffic: read a, read b, write out (write-allocate ignored)
    mem_bps = 3 * n * 4 / max(min(tri_times), 1e-9)

    m = 384
    x = np.ones((m, m))
    mm_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        x @ x
        mm_times.append(time.perf_counter() - t0)
    flops = 2 * m ** 3 / max(min(mm_times), 1e-9)
    # a stacked mesh's "network" on the host is a memcpy: model it as the
    # measured stream bandwidth
    return MachineModel(name="cpu-calibrated", mem_bytes_per_s=mem_bps,
                        flops_per_s=flops, net_bytes_per_s=mem_bps,
                        source="calibrated",
                        hbm_bytes=_host_ram_bytes())


def _host_ram_bytes() -> Optional[float]:
    """Physical host RAM in bytes - the CPU backend's "device capacity"
    (``None`` where the sysconf keys are missing)."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
    except (AttributeError, ValueError, OSError):
        return None
    if pages <= 0 or page <= 0:
        return None
    return float(pages) * float(page)


_CACHED_CPU: list = [None]
_CACHED_CUDA: dict = {}


def _cpu_model(cache=None) -> MachineModel:
    """The CPU model, via the measured-artifact disk cache: a fresh
    (< :data:`CPU_MODEL_MAX_AGE_S`) entry for this host is reused across
    processes (and across the two packages, whose cache key and format
    agree); otherwise the one-shot self-benchmark runs and its result is
    stored (best-effort)."""
    from ..utils.tune import JsonCache, host_fingerprint

    if cache is None:
        cache = JsonCache()
    key = f"machine-model-cpu-{host_fingerprint()}"
    entry = cache.get(key, max_age_s=CPU_MODEL_MAX_AGE_S)
    if entry is not None:
        try:
            model = MachineModel.from_json(entry["payload"])
            if model.mem_bytes_per_s > 0 and model.flops_per_s > 0:
                return model
        except (TypeError, KeyError):
            pass  # malformed/old-format entry: re-measure
    model = dataclasses.replace(_calibrate_cpu(), created_at=time.time())
    try:
        cache.put(key, model.to_json(), created_at=model.created_at)
    except (OSError, ValueError):
        pass
    return model


def machine_model(backend: Optional[str] = None, *,
                  cache=None) -> MachineModel:
    """The machine model for ``backend``: ``"cuda"`` (or ``"cuda:i"``) the
    card's table entry, ``"cpu"`` the self-calibration (at most once per
    process, and persisted in the ``utils.tune.JsonCache`` disk cache
    keyed by host fingerprint, week-stale; ``cache`` overrides its
    location), anything else the generic model.  ``None`` follows the
    device rule: the card, raising without one."""
    if backend is None:
        backend = "cuda"
    if str(backend).startswith("cuda"):
        import torch

        from .._device import resolve_device

        index = resolve_device(backend).index
        if index not in _CACHED_CUDA:
            _CACHED_CUDA[index] = _cuda_model(
                torch.cuda.get_device_name(index),
                torch.cuda.get_device_properties(index).total_memory)
        return _CACHED_CUDA[index]
    if backend == "cpu":
        if cache is not None:
            return _cpu_model(cache)
        if _CACHED_CPU[0] is None:
            _CACHED_CPU[0] = _cpu_model()
        return _CACHED_CPU[0]
    return MachineModel(**_GENERIC_MODEL)


def operator_nnz(a) -> int:
    """Live matrix entries of an operator, for the traffic model.

    Assembled formats expose ``nnz``; matrix-free stencils count their
    stencil points per row; anything else is modeled dense."""
    nnz = getattr(a, "nnz", None)
    if nnz is not None and not callable(nnz):
        return int(nnz)
    name = type(a).__name__
    n = int(a.shape[0])
    if "Stencil3D" in name or "3d" in name.lower():
        return 7 * n
    if "Stencil2D" in name:
        return 5 * n
    if hasattr(a, "local_grid"):   # distributed stencils
        return (7 if len(a.local_grid) == 3 else 5) * n
    return n * int(a.shape[1]) if len(a.shape) > 1 else n


def solve_traffic(n: int, nnz: int, itemsize: int, *,
                  method: str = "cg", preconditioned: bool = False,
                  precond_matvecs: int = 0, n_rhs: int = 1) -> dict:
    """Per-iteration FLOPs and memory bytes of a solver recurrence.

    Built on ``cost.analytic_solve_ops``'s per-iteration op counts with
    the standard per-op traffic: an SpMV is ``2 nnz`` FLOPs moving the
    matrix (value + column index per entry) plus the two vectors; a dot
    is ``2 n`` FLOPs over two read vectors; an axpy-class fused update is
    ``2 n`` FLOPs over two reads and one write.  A model, not a
    measurement.

    ``n_rhs > 1`` models the batched tier (``solver.many``): each matrix
    sweep's ``nnz * (itemsize + 4)`` bytes are paid ONCE and amortized
    over all lanes, while every per-lane vector term scales by
    ``n_rhs``; ``mem_bytes_per_rhs`` reports the amortized per-lane
    traffic."""
    ops = analytic_solve_ops(method, preconditioned=preconditioned,
                             precond_matvecs=precond_matvecs,
                             n_rhs=n_rhs)
    # one matrix sweep per spmv, n_rhs vector stacks riding it
    spmv_bytes = nnz * (itemsize + 4) + 2 * n * itemsize * n_rhs
    spmv_flops = 2 * nnz * n_rhs
    dot_bytes = 2 * n * itemsize
    axpy_bytes = 3 * n * itemsize
    flops = (ops["spmv"] * spmv_flops
             + ops["dot"] * 2 * n
             + ops["axpy"] * 2 * n)
    mem_bytes = (ops["spmv"] * spmv_bytes
                 + ops["dot"] * dot_bytes
                 + ops["axpy"] * axpy_bytes)
    return {"flops": float(flops), "mem_bytes": float(mem_bytes),
            "mem_bytes_per_rhs": float(mem_bytes) / n_rhs,
            "ops": ops}


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """One solve's roofline verdict (JSON-ready)."""

    model: MachineModel
    iterations: int
    measured_s: float
    flops_per_iteration: float
    mem_bytes_per_iteration: float
    comm_bytes_per_iteration: float
    arithmetic_intensity: float      # FLOP per memory byte
    t_mem_s: float                   # model per-iteration terms
    t_flop_s: float
    t_comm_s: float
    model_s_per_iteration: float     # max of the three terms
    measured_s_per_iteration: float
    efficiency_pct: float            # model bound / measured, x100
    bound: str                       # memory | compute | communication
    model_source: str = "table"
    model_age_s: Optional[float] = None
    n_rhs: int = 1

    @property
    def mem_bytes_per_iteration_per_rhs(self) -> float:
        """Amortized per-lane memory traffic: what one RHS pays when the
        matrix sweep is shared across the batch."""
        return self.mem_bytes_per_iteration / max(self.n_rhs, 1)

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["model"] = self.model.to_json()
        return out

    def describe(self) -> str:
        gbps = (self.mem_bytes_per_iteration
                / max(self.measured_s_per_iteration, 1e-30)) / 1e9
        return (f"{self.efficiency_pct:.1f}% of the "
                f"{self.bound}-bound roofline on {self.model.name} "
                f"({gbps:.2f} GB/s achieved vs "
                f"{self.model.mem_bytes_per_s / 1e9:.2f} peak; "
                f"arithmetic intensity "
                f"{self.arithmetic_intensity:.3f} flop/B)")


def analyze(*, n: int, nnz: int, itemsize: int, iterations: int,
            elapsed_s: float, method: str = "cg",
            preconditioned: bool = False, precond_matvecs: int = 0,
            comm_bytes_per_iteration: float = 0.0,
            model: Optional[MachineModel] = None,
            backend: Optional[str] = None,
            n_rhs: int = 1) -> RooflineReport:
    """Join the analytic traffic model with a measured solve.

    ``elapsed_s`` is the measured wall time of ``iterations`` iterations
    (``observe_solve``'s solve section / ``utils.timing.time_fn``);
    ``comm_bytes_per_iteration`` comes from the comm-layer
    ``SolveCost.per_iteration.comm_bytes`` on meshes (0 on one device).
    Pass ``model`` explicitly for deterministic tests."""
    if model is None:
        model = machine_model(backend)
    traffic = solve_traffic(n, nnz, itemsize, method=method,
                            preconditioned=preconditioned,
                            precond_matvecs=precond_matvecs,
                            n_rhs=n_rhs)
    flops, mem_bytes = traffic["flops"], traffic["mem_bytes"]
    t_mem = mem_bytes / model.mem_bytes_per_s
    t_flop = flops / model.flops_per_s
    net = model.net_bytes_per_s or model.mem_bytes_per_s
    t_comm = float(comm_bytes_per_iteration) / net
    terms = {"memory": t_mem, "compute": t_flop, "communication": t_comm}
    bound = max(terms, key=terms.get)
    model_iter = max(terms.values())
    its = max(int(iterations), 1)
    measured_iter = max(float(elapsed_s), 1e-30) / its
    return RooflineReport(
        model=model, iterations=int(iterations),
        measured_s=float(elapsed_s),
        flops_per_iteration=flops,
        mem_bytes_per_iteration=mem_bytes,
        comm_bytes_per_iteration=float(comm_bytes_per_iteration),
        arithmetic_intensity=flops / max(mem_bytes, 1e-30),
        t_mem_s=t_mem, t_flop_s=t_flop, t_comm_s=t_comm,
        model_s_per_iteration=model_iter,
        measured_s_per_iteration=measured_iter,
        efficiency_pct=100.0 * model_iter / measured_iter,
        bound=bound, model_source=model.source,
        model_age_s=model.age_s, n_rhs=int(n_rhs))
