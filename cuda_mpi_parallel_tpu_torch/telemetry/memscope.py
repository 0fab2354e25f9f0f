"""Device-memory observatory: per-shard device-memory footprint
accounting.

Counterpart of the JAX package's ``telemetry/memscope.py``.  Every
other axis of the machine already has a ruler here - shardscope counts
slots and halo payloads, :mod:`.cost` records wire bytes at the comm
layer, roofline prices traffic against peak bandwidth - and this module
says how many bytes a solve actually *pins* per device.  The PIM SpMV
lesson (PAPERS: arXiv 2204.00900 - throughput is sustained stream
bandwidth over the RESIDENT bytes) and the cluster-storage accounting
of arXiv 1112.5588 both start from the primitive this module supplies:
an honest bytes-per-device model.

Three views of the same footprint, kept deliberately separate:

* **matrix bytes** (:func:`matrix_bytes_per_shard`) - the tensors a
  partition actually holds on the device for the life of a
  dispatcher: CSR slot planes at their real padded ``slots`` x
  itemsize, int32 column/row index planes, gather ``send_idx`` slabs,
  and for the ring shift-ELL families the sliced-ELL value, column and
  slice-pointer arrays each ring step packs (``ring_step_tensors``:
  on a stacked mesh ONE pack a step over the local shards' stacked
  rows, ragged per owner - the port's own numbers) plus the Jacobi
  diagonal.  It equals the summed bytes of the live tensors EXACTLY
  (:func:`live_device_bytes` is the measured twin - same numbers, two
  derivations).
* **solver bytes** (:func:`solver_bytes_per_shard`) - the modeled
  solve-lifetime working set: b/x/r/p/Ap many-RHS k-wide stacks, the
  extended-x exchange buffer (full ``n_global_padded`` for allgather,
  ``n_local + halo_width`` for a gather schedule, one rotating block
  for the ring), flight-recorder and recycling-basis rings, df64
  doubling.  The JAX package's arithmetic, unchanged.
* **transient peak** (:class:`PeakRecord`) - a PyTorch solve has no
  jaxpr to walk, so the port keeps a liveness record while one solve
  runs: a ``TorchDispatchMode`` adds each new output storage's bytes
  when an op creates it and subtracts them when the storage is freed
  (a finalizer on the untyped storage), counting the solve's inputs
  from the start as the JAX walk counts the program's; the high-water
  mark is reported.  It is the port's own number (eager PyTorch
  materialises temporaries that XLA fuses) and runs only in a
  telemetered solve, over its setup and first two loop trips
  (:meth:`PeakRecord.stop`): every later trip repeats the second
  one's working set.

``persistent = matrix + solver`` is what a registered operator costs
per device while serving; ``peak`` bounds the solve-time spike.  Fit
classification against :class:`~.roofline.MachineModel.hbm_bytes`
(the capacity the card reports, ``CUDA_MPI_PARALLEL_TPU_HBM_BYTES``
override) is FITS / TIGHT (> ``TIGHT_FRACTION``) / OVERFLOW - or
``"unknown"`` when the model has no capacity number, which REPORTS and
never refuses.  :class:`MemoryBudgetError` is the typed refusal the
planner (``balance.plan_partition(hbm_budget=)``) raises BEFORE any
allocation, naming the bytes and the smallest mesh that fits.

Everything but the peak record is host-side arithmetic over arrays the
partitioners already produced; the solve is never perturbed.
"""
from __future__ import annotations

import dataclasses
import math
import os
import weakref
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "HBM_BYTES_ENV",
    "TIGHT_FRACTION",
    "MemoryBudgetError",
    "MemoryFootprint",
    "PeakRecord",
    "classify",
    "csr_slot_bytes",
    "device_memory_peak",
    "footprint_for_partition",
    "hbm_bytes_for",
    "last_memory_profile",
    "live_device_bytes",
    "matrix_bytes_per_shard",
    "note_footprint",
    "predict_footprint",
    "reset_last_memory_profile",
    "smallest_fitting_mesh",
    "solve_peak_bytes",
    "solver_bytes_per_shard",
]

#: environment override for the per-device HBM capacity (bytes) -
#: wins over any machine model's table/calibrated value
HBM_BYTES_ENV = "CUDA_MPI_PARALLEL_TPU_HBM_BYTES"

#: occupancy above this fraction of capacity classifies TIGHT: enough
#: headroom questions (fragmentation, allocator caching, workspace)
#: live in the last fifth that "fits on paper" stops being a promise
TIGHT_FRACTION = 0.8


class MemoryBudgetError(RuntimeError):
    """A partition/registration whose footprint cannot fit the budget.

    Raised BEFORE any device allocation, so an over-budget operator
    fails at plan/registration time with numbers attached -
    never as an opaque OOM inside request latency.  ``required_bytes``
    is the worst-shard persistent footprint of the best (smallest)
    candidate considered, ``budget_bytes`` the per-device budget it
    exceeded, and ``smallest_fitting_mesh`` the first power-of-two
    shard count whose predicted footprint fits (``None`` when none
    does within the search bound).
    """

    def __init__(self, message: str, *, required_bytes: int,
                 budget_bytes: float, n_shards: int,
                 smallest_fitting_mesh: Optional[int] = None):
        super().__init__(message)
        self.required_bytes = int(required_bytes)
        self.budget_bytes = float(budget_bytes)
        self.n_shards = int(n_shards)
        self.smallest_fitting_mesh = smallest_fitting_mesh


def classify(peak_bytes: float,
             hbm_bytes: Optional[float]) -> str:
    """FITS / TIGHT / OVERFLOW against a per-device capacity, or
    ``"unknown"`` when no capacity is known (unknown REPORTS, never
    refuses - a pre-PR calibration file without ``hbm_bytes`` must not
    start failing registrations)."""
    if hbm_bytes is None or hbm_bytes <= 0:
        return "unknown"
    if peak_bytes > hbm_bytes:
        return "OVERFLOW"
    if peak_bytes > TIGHT_FRACTION * hbm_bytes:
        return "TIGHT"
    return "FITS"


def hbm_bytes_for(model=None, backend: Optional[str] = None
                  ) -> Optional[float]:
    """The per-device memory capacity to classify against: the
    :data:`HBM_BYTES_ENV` override when set, else ``model.hbm_bytes``
    (the model defaults to ``roofline.machine_model(backend)``: the
    capacity the card reports; ``None`` follows the device rule, the
    card).  On ``backend="cpu"`` without a model it is the host RAM the
    CPU model records, read without running its calibration.  ``None``
    = unknown."""
    env = os.environ.get(HBM_BYTES_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            raise ValueError(
                f"{HBM_BYTES_ENV} must be a number of bytes, got "
                f"{env!r}")
    if model is None:
        from .roofline import _host_ram_bytes, machine_model

        if backend is not None and str(backend).startswith("cpu"):
            return _host_ram_bytes()
        model = machine_model(backend)
    return getattr(model, "hbm_bytes", None)


# ---------------------------------------------------------------------------
# the static model: matrix bytes (exact) + solver working set (modeled)

def _prod(shape) -> int:
    return int(math.prod(int(s) for s in shape))


def csr_slot_bytes(slots, itemsize: int):
    """Device bytes of ``slots`` CSR entry slots: one data value plus
    the int32 column and int32 local-row planes per slot - THE
    per-slot cost shared by the exact partition accounting below, the
    pre-build prediction, and ``shardscope``'s predicted
    ``persistent_bytes``.  Vectorizes over numpy ``slots``."""
    return slots * (int(itemsize) + 4 + 4)


def matrix_bytes_per_shard(parts, shard_ids=None) -> np.ndarray:
    """Per-shard device bytes of the tensors a partition pins for the
    life of a dispatcher - THE byte definition shared by the footprint
    model, ``shardscope.ShardReport.persistent_bytes`` and the
    dist_cg measured twin.

    Summing exactly what ``parallel.dist_cg`` puts on the device per
    family:

    * CSR (allgather/gather): ``data`` + int32 ``cols`` +
      int32 ``local_rows`` slot planes, plus the gather schedule's
      int32 ``send_idx`` slab per round (the JAX package's numbers,
      from array shapes alone; constant across shards);
    * ring CSR: the same three planes per ring step;
    * ring shift-ELL (f32/f64, for B8/B9): per ring step the sliced-ELL
      values, int32 columns and int64 slice pointers of the pack the
      lane builds (``partition.stack_ring_step``), plus the diagonal.
      The shards of ``shard_ids`` are packed together, one pack a step
      over their stacked rows (``None``: every shard, the stacked mesh
      of one process); every other shard alone (a process-group rank
      packs its one shard).  A slice belongs to the shard of its first
      row and the pack's closing pointer to its last shard, so the sum
      over shards is the packs' bytes exactly; the slices' widths come
      from the rows' entry counts, so these numbers are ragged per
      shard - the port's own, not the JAX package's sheet geometry.
    """
    from ..parallel import partition as part

    p = int(parts.n_shards)
    if isinstance(parts, part.PartitionedCSR):
        per = sum(np.asarray(x).dtype.itemsize * _prod(x.shape[1:])
                  for x in (parts.data, parts.cols, parts.local_rows))
        if parts.halo is not None:
            per += sum(
                np.asarray(r.send_idx).dtype.itemsize * r.m
                for r in parts.halo.rounds)
        return np.full(p, per, dtype=np.int64)
    if isinstance(parts, part.RingPartitionedCSR):
        per = sum(
            np.asarray(x).dtype.itemsize * _prod(x.shape[1:])
            for tup in (parts.data, parts.cols, parts.local_rows)
            for x in tup)
        return np.full(p, per, dtype=np.int64)
    if isinstance(parts, (part.RingPartitionedShiftELL,
                          part.RingPartitionedShiftELLDF64)):
        return _sliced_ring_bytes(parts, shard_ids)
    raise TypeError(f"no memory accounting for {type(parts).__name__}")


def _slab_row_lengths(parts, t: int, s: int) -> np.ndarray:
    """Entries per row of owner ``s``'s step-``t`` sliced-ELL slab (its
    live slots: a packed slab holds no padding entry of its own)."""
    from ..ops.cuda.spmv import SLICE

    ptr = np.asarray(parts.slice_ptr[t][s], dtype=np.int64)
    live = np.asarray(parts.cols[t][s]) >= 0
    width = np.diff(ptr) // SLICE
    pos = np.arange(int(ptr[-1]), dtype=np.int64)
    slc = np.repeat(np.arange(width.size, dtype=np.int64), width * SLICE)
    rows = slc * SLICE + (pos - ptr[slc]) % SLICE
    return np.bincount(rows[live], minlength=width.size * SLICE)[
        :parts.n_local]


def _sliced_ring_bytes(parts, shard_ids) -> np.ndarray:
    from ..ops.cuda.spmv import SLICE

    p, n_local = int(parts.n_shards), int(parts.n_local)
    itemsize = np.asarray(parts.vals[0][0]).dtype.itemsize
    stacked = tuple(range(p)) if shard_ids is None \
        else tuple(int(s) for s in shard_ids)
    groups = [stacked] + [(s,) for s in range(p) if s not in stacked]
    out = np.zeros(p, dtype=np.int64)
    for t in range(p):
        for group in groups:
            lens = np.zeros(-(-len(group) * n_local // SLICE) * SLICE,
                            dtype=np.int64)
            for k, s in enumerate(group):
                lens[k * n_local:(k + 1) * n_local] = \
                    _slab_row_lengths(parts, t, s)
            width = lens.reshape(-1, SLICE).max(axis=1)
            first_row = np.arange(width.size, dtype=np.int64) * SLICE
            owner = np.asarray(group, dtype=np.int64)[first_row // n_local]
            # values + int32 columns per slot, one int64 pointer a slice
            np.add.at(out, owner, width * SLICE * (itemsize + 4) + 8)
            out[group[-1]] += 8
    out += n_local * np.asarray(parts.diag).dtype.itemsize
    return out


def solver_bytes_per_shard(*, n_local: int, n_shards: int,
                           itemsize: int, n_rhs: int = 1,
                           exchange: str = "allgather",
                           halo_width: int = 0, df64: bool = False,
                           flight_capacity: int = 0,
                           basis_m: int = 0) -> int:
    """Modeled per-shard bytes of the solve-lifetime working set.

    The recurrence carries b, x, r, p and the Ap product - five
    ``(n_local, n_rhs)`` stacks - plus the exchange's extended-x
    buffer: the full ``(n_shards * n_local, n_rhs)`` gathered stack
    for allgather, ``(n_local + halo_width, n_rhs)`` for a compiled
    gather schedule (``halo_width = GatherSchedule.halo_width``), and
    one extra rotating ``(n_local, n_rhs)`` block for the ring
    schedules.  ``df64`` doubles every vector entry into (hi, lo)
    planes.  ``flight_capacity`` rows of the (replicated) flight ring
    carry ``1 + 3 * n_rhs`` recorded columns each (``4`` single-RHS);
    ``basis_m`` recycling-basis vectors hold their local rows per
    shard.
    """
    vec = int(itemsize) * (2 if df64 else 1)
    k = max(int(n_rhs), 1)
    per = 5 * n_local * k * vec
    if exchange == "allgather":
        per += n_shards * n_local * k * vec
    elif exchange == "gather":
        per += (n_local + int(halo_width)) * k * vec
    elif exchange in ("ring", "ring-shiftell"):
        per += 2 * n_local * k * vec
    else:
        raise ValueError(f"unknown exchange {exchange!r}")
    if flight_capacity:
        cols = 4 if k == 1 else 1 + 3 * k
        per += int(flight_capacity) * cols * vec
    if basis_m:
        per += int(basis_m) * n_local * vec
    return int(per)


def _exchange_of(parts) -> Tuple[str, int]:
    """(exchange lane, gather halo width) of a built partition."""
    from ..parallel import partition as part

    if isinstance(parts, part.PartitionedCSR):
        if parts.halo is not None:
            return "gather", int(parts.halo.halo_width)
        return "allgather", 0
    if isinstance(parts, part.RingPartitionedCSR):
        return "ring", 0
    return "ring-shiftell", 0


def _kind_of(parts) -> str:
    from ..parallel import partition as part

    if isinstance(parts, part.PartitionedCSR):
        return ("csr-gather" if parts.halo is not None
                else "csr-allgather")
    if isinstance(parts, part.RingPartitionedCSR):
        return "csr-ring"
    return ("ring-shiftell-df64"
            if isinstance(parts, part.RingPartitionedShiftELLDF64)
            else "ring-shiftell")


@dataclasses.dataclass(frozen=True)
class MemoryFootprint:
    """One partitioned solve's per-device memory account (JSON-ready).

    ``matrix_bytes`` is exact (measured-twin asserted);
    ``solver_bytes`` is the modeled working set;
    ``jaxpr_peak_bytes`` (the JAX package's field name, kept so that
    the JSON crosses packages) is the per-shard share of the
    :class:`PeakRecord` high water of a recorded solve - the process's
    peak over its local shards - when one was recorded (it counts the
    solve's inputs too).
    ``hbm_bytes`` is the capacity classified against (``None`` =
    unknown).
    """

    kind: str
    n_shards: int
    n_rhs: int
    itemsize: int
    matrix_bytes: np.ndarray          # (P,) exact pinned bytes
    solver_bytes: np.ndarray          # (P,) modeled working set
    jaxpr_peak_bytes: Optional[int] = None
    hbm_bytes: Optional[float] = None

    @property
    def persistent_bytes(self) -> np.ndarray:
        """(P,) matrix + solver working set: what one registered,
        actively solving operator costs per chip."""
        return self.matrix_bytes + self.solver_bytes

    @property
    def peak_bytes(self) -> int:
        """Worst-shard high water: the recorded peak when there is one,
        at least the persistent model."""
        persistent = int(self.persistent_bytes.max()) \
            if self.n_shards else 0
        if self.jaxpr_peak_bytes is None:
            return persistent
        return max(int(self.jaxpr_peak_bytes), persistent)

    @property
    def classification(self) -> str:
        return classify(self.peak_bytes, self.hbm_bytes)

    @property
    def headroom_frac(self) -> Optional[float]:
        """Fraction of capacity left above the peak (negative =
        overflow); ``None`` when capacity is unknown."""
        if self.hbm_bytes is None or self.hbm_bytes <= 0:
            return None
        return 1.0 - self.peak_bytes / float(self.hbm_bytes)

    def to_json(self) -> dict:
        head = self.headroom_frac
        return {
            "kind": self.kind,
            "n_shards": self.n_shards,
            "n_rhs": self.n_rhs,
            "itemsize": self.itemsize,
            "matrix_bytes": [int(v) for v in self.matrix_bytes],
            "solver_bytes": [int(v) for v in self.solver_bytes],
            "persistent_bytes": [int(v) for v in self.persistent_bytes],
            "jaxpr_peak_bytes": (None if self.jaxpr_peak_bytes is None
                                 else int(self.jaxpr_peak_bytes)),
            "peak_bytes": int(self.peak_bytes),
            "hbm_bytes": (None if self.hbm_bytes is None
                          else float(self.hbm_bytes)),
            "headroom_frac": (None if head is None
                              else round(float(head), 6)),
            "classification": self.classification,
        }

    @classmethod
    def from_json(cls, data: dict) -> "MemoryFootprint":
        return cls(
            kind=str(data["kind"]), n_shards=int(data["n_shards"]),
            n_rhs=int(data["n_rhs"]), itemsize=int(data["itemsize"]),
            matrix_bytes=np.asarray(data["matrix_bytes"],
                                    dtype=np.int64),
            solver_bytes=np.asarray(data["solver_bytes"],
                                    dtype=np.int64),
            jaxpr_peak_bytes=(None
                              if data.get("jaxpr_peak_bytes") is None
                              else int(data["jaxpr_peak_bytes"])),
            hbm_bytes=(None if data.get("hbm_bytes") is None
                       else float(data["hbm_bytes"])))

    def describe(self) -> str:
        """The one-line footprint digest of a report."""
        per = int(self.persistent_bytes.max()) if self.n_shards else 0
        parts = [f"{_fmt_bytes(per)}/shard persistent "
                 f"({_fmt_bytes(int(self.matrix_bytes.max()))} matrix "
                 f"+ {_fmt_bytes(int(self.solver_bytes.max()))} "
                 f"solver, k={self.n_rhs})",
                 f"peak {_fmt_bytes(self.peak_bytes)}"]
        if self.hbm_bytes is not None and self.hbm_bytes > 0:
            head = self.headroom_frac
            parts.append(
                f"{self.classification} on "
                f"{_fmt_bytes(self.hbm_bytes)} HBM "
                f"(headroom {head * 100:.1f}%)")
        else:
            parts.append("capacity unknown")
        return "; ".join(parts)


def _fmt_bytes(b: float) -> str:
    b = float(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024.0 or unit == "GiB":
            return (f"{b:.0f} {unit}" if unit == "B"
                    else f"{b:.2f} {unit}")
        b /= 1024.0
    return f"{b:.2f} GiB"


def footprint_for_partition(parts, *, n_rhs: int = 1,
                            flight_capacity: int = 0,
                            basis_m: int = 0,
                            jaxpr_peak: Optional[int] = None,
                            hbm_bytes: Optional[float] = "auto",
                            model=None, shard_ids=None) -> MemoryFootprint:
    """The footprint of a BUILT partition: exact matrix bytes of the
    tensors it pins (``shard_ids`` as in :func:`matrix_bytes_per_shard`),
    modeled solver working set for ``n_rhs`` lanes.
    ``hbm_bytes="auto"`` resolves capacity via :func:`hbm_bytes_for`
    (env override, then ``model``, then the card); pass ``None`` to
    classify as unknown or a number to pin it.  The f64 ring partition
    is priced as the JAX df64 one: 4-byte (hi, lo) vectors, doubled."""
    from ..parallel import partition as part

    exchange, halo_width = _exchange_of(parts)
    df64 = isinstance(parts, part.RingPartitionedShiftELLDF64)
    if df64:
        itemsize = 4           # (hi, lo) f32 planes; df64 doubles below
    elif hasattr(parts, "vals"):
        itemsize = np.asarray(parts.vals[0][0]).dtype.itemsize
    elif isinstance(parts.data, tuple):
        itemsize = np.asarray(parts.data[0]).dtype.itemsize
    else:
        itemsize = np.asarray(parts.data).dtype.itemsize
    if hbm_bytes == "auto":
        hbm_bytes = hbm_bytes_for(model)
    matrix = matrix_bytes_per_shard(parts, shard_ids)
    solver = solver_bytes_per_shard(
        n_local=int(parts.n_local), n_shards=int(parts.n_shards),
        itemsize=int(itemsize), n_rhs=n_rhs, exchange=exchange,
        halo_width=halo_width, df64=df64,
        flight_capacity=flight_capacity, basis_m=basis_m)
    return MemoryFootprint(
        kind=_kind_of(parts), n_shards=int(parts.n_shards),
        n_rhs=int(n_rhs), itemsize=int(itemsize),
        matrix_bytes=matrix,
        solver_bytes=np.full(int(parts.n_shards), solver,
                             dtype=np.int64),
        jaxpr_peak_bytes=jaxpr_peak, hbm_bytes=hbm_bytes)


# ---------------------------------------------------------------------------
# the pre-build prediction (the planner's gate)

def predict_slots(n: int, n_shards: int, *, nnz: Optional[int] = None,
                  indptr=None, row_ranges=None) -> Tuple[int, int]:
    """``(n_local, slots)`` of the CSR partition that WOULD be built:
    the exact ``partition_csr`` slot count when ``indptr`` is given
    (max over shards of live entries + unit-diagonal padding rows),
    else the uniform-nnz estimate ``ceil(nnz / P)`` + padding (what a
    synthetic sweep prices)."""
    from .shardscope import _row_ranges as even_ranges

    if row_ranges is not None:
        from ..parallel.partition import ranges_n_local

        ranges = tuple((int(lo), int(hi)) for lo, hi in row_ranges)
        n_local = ranges_n_local(ranges)
    else:
        n_local = -(-int(n) // int(n_shards))
        ranges = even_ranges(int(n), n_local, int(n_shards))
    if indptr is not None:
        ip = np.asarray(indptr).astype(np.int64)
        counts = [int(ip[hi] - ip[lo]) + (n_local - (hi - lo))
                  for lo, hi in ranges]
        return n_local, max(max(counts), 1)
    if nnz is None:
        raise ValueError("predict_slots needs nnz= or indptr=")
    # uniform-nnz estimate: each shard holds ~nnz/P live entries; the
    # tail shard additionally pads its missing rows with unit diagonals
    tail_real = int(n) - (int(n_shards) - 1) * n_local
    pad_rows = max(n_local - max(tail_real, 0), 0)
    return n_local, max(-(-int(nnz) // int(n_shards)) + pad_rows, 1)


def predict_footprint(*, n: int, n_shards: int,
                      nnz: Optional[int] = None, indptr=None,
                      row_ranges=None, itemsize: int = 4,
                      n_rhs: int = 1, exchange: str = "allgather",
                      halo_width: int = 0, df64: bool = False,
                      flight_capacity: int = 0, basis_m: int = 0,
                      hbm_bytes: Optional[float] = "auto",
                      model=None) -> MemoryFootprint:
    """Geometry-only footprint of the CSR partition that WOULD be
    built - no partition arrays, no device work.  This is what
    ``balance.plan_partition(hbm_budget=)`` gates candidates on.

    ``indptr`` gives the exact even-split (or ``row_ranges``) slot
    count; ``nnz`` alone prices the uniform split a synthetic sweep
    assumes.  The gather lane's ``halo_width``/send slabs are unknown
    before the schedule is compiled, so predictions price the
    allgather layout unless the caller passes a measured
    ``halo_width`` - a conservative (upper-bound) extended-x charge.
    """
    n_local, slots = predict_slots(int(n), int(n_shards), nnz=nnz,
                                   indptr=indptr,
                                   row_ranges=row_ranges)
    if hbm_bytes == "auto":
        hbm_bytes = hbm_bytes_for(model)
    mat_itemsize = int(itemsize) * (2 if df64 else 1)
    per_matrix = int(csr_slot_bytes(slots, mat_itemsize))
    solver = solver_bytes_per_shard(
        n_local=n_local, n_shards=int(n_shards),
        itemsize=int(itemsize), n_rhs=n_rhs, exchange=exchange,
        halo_width=halo_width, df64=df64,
        flight_capacity=flight_capacity, basis_m=basis_m)
    p = int(n_shards)
    return MemoryFootprint(
        kind=f"predicted-csr-{exchange}", n_shards=p,
        n_rhs=int(n_rhs), itemsize=int(itemsize),
        matrix_bytes=np.full(p, per_matrix, dtype=np.int64),
        solver_bytes=np.full(p, solver, dtype=np.int64),
        jaxpr_peak_bytes=None, hbm_bytes=hbm_bytes)


def smallest_fitting_mesh(*, n: int, budget_bytes: float,
                          nnz: Optional[int] = None, indptr=None,
                          itemsize: int = 4, n_rhs: int = 1,
                          exchange: str = "allgather",
                          df64: bool = False,
                          flight_capacity: int = 0,
                          start: int = 1,
                          max_shards: int = 65536) -> Optional[int]:
    """The smallest power-of-two shard count >= ``start`` whose
    predicted worst-shard persistent footprint fits ``budget_bytes``
    (``None`` when none does by ``max_shards`` - e.g. an allgather
    extended-x that never shrinks with P)."""
    p = 1
    while p < start:
        p *= 2
    while p <= max_shards:
        fp = predict_footprint(
            n=n, n_shards=p, nnz=nnz, indptr=indptr,
            itemsize=itemsize, n_rhs=n_rhs, exchange=exchange,
            df64=df64, flight_capacity=flight_capacity,
            hbm_bytes=None)
        if int(fp.persistent_bytes.max()) <= budget_bytes:
            return p
        p *= 2
    return None


# ---------------------------------------------------------------------------
# the measured twin

def _tensors(tree):
    """Every tensor (or array) leaf of a tree of tuples, lists, dicts
    and dataclasses, in order."""
    if tree is None:
        return
    if hasattr(tree, "untyped_storage") or (
            hasattr(tree, "nbytes") and not isinstance(tree, type)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def live_device_bytes(tree) -> int:
    """Summed bytes over every tensor leaf of ``tree`` (``numel x
    element_size``; a numpy leaf its ``nbytes``) - this process's
    tensors, so on a stacked mesh every shard's."""
    total = 0
    for v in _tensors(tree):
        if hasattr(v, "element_size"):
            total += int(v.numel()) * int(v.element_size())
        else:
            total += int(v.nbytes)
    return total


def device_memory_peak(device=None) -> Optional[int]:
    """The allocator's peak bytes on the card
    (``torch.cuda.max_memory_allocated``) - the allocator-level
    cross-check of the static model; ``None`` on the CPU (no allocator
    statistics) or for a CPU ``device``."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(device))


# ---------------------------------------------------------------------------
# the peak record (the port's counterpart of the JAX jaxpr liveness walk)

class PeakRecord:
    """Liveness record of the storages one solve holds on ``device``.

    Inside ``with record:`` a ``TorchDispatchMode`` sees every aten op;
    each output storage not seen before adds its bytes to ``live`` and
    gets a finalizer that subtracts them when the storage is freed (the
    last tensor viewing it gone).  :meth:`add` counts tensors that
    exist before the record starts - the solve's inputs, which the JAX
    walk counts from the program's entry.  ``peak`` is the high water
    of ``live``.  Views share their base's storage and count once; a
    storage that grows in place adds its growth.  The mode calls each
    op as it was called, so the solve runs the same operations.
    """

    def __init__(self, device=None):
        import torch

        self.device = None if device is None else torch.device(device)
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}
        self._mode = None

    def _on_device(self, t) -> bool:
        if self.device is None:
            return True
        d = t.device
        return d.type == self.device.type and (
            self.device.index is None or d.index is None
            or d.index == self.device.index)

    def add(self, tree) -> "PeakRecord":
        """Count the tensors of ``tree`` (each storage once)."""
        for t in _tensors(tree):
            if hasattr(t, "untyped_storage") and self._on_device(t):
                self._count(t.untyped_storage())
        return self

    def _count(self, storage) -> None:
        key = storage._cdata
        nbytes = int(storage.nbytes())
        old = self._sizes.get(key)
        if old is None:
            if nbytes == 0:
                return
            self._sizes[key] = nbytes
            weakref.finalize(storage, self._free, key)
            self.live += nbytes
        elif nbytes > old:
            self._sizes[key] = nbytes
            self.live += nbytes - old
        else:
            return
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __enter__(self) -> "PeakRecord":
        from torch.utils._python_dispatch import TorchDispatchMode

        record = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                record.add(out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def stop(self) -> None:
        """End the record before its ``with`` body does; the peak so far
        stands.  Called between operations (``parallel.dist_cg`` stops
        it once a solve's setup and first two loop trips have run, its
        working set then at its steady state), and a no-op unless this
        record's mode is the innermost one."""
        from torch.utils._python_dispatch import _get_current_dispatch_mode

        mode = self._mode
        if mode is None or _get_current_dispatch_mode() is not mode:
            return
        self._mode = None
        mode.__exit__(None, None, None)

    def __exit__(self, *exc) -> None:
        mode, self._mode = self._mode, None
        if mode is not None:
            mode.__exit__(*exc)


def solve_peak_bytes(fn, *args, device=None, **kwargs) -> int:
    """Run ``fn(*args, **kwargs)`` once under a :class:`PeakRecord` and
    return its high water in bytes: the storages on ``device`` (default:
    that of the first tensor argument) live at once, the arguments'
    counted from the start.  Like ``cost.trace_solve_cost`` (and unlike
    the JAX ``solve_peak_bytes``, which walks a traced program without
    running it) this EXECUTES the solve; ``fn``'s result is
    discarded."""
    if device is None:
        device = next((t.device for t in _tensors(args)
                       if hasattr(t, "untyped_storage")), None)
    record = PeakRecord(device).add(args)
    with record:
        fn(*args, **kwargs)
    return int(record.peak)


# ---------------------------------------------------------------------------
# emission + the pickup slot

#: the most recent (footprint, measured dict) noted by a solve path -
#: the same pattern as shardscope._LAST / dist_cg._LAST_COMM_COST
_LAST: list = [None]


def last_memory_profile() -> Optional[dict]:
    """``{"footprint": MemoryFootprint, ...}`` of the most recent
    distributed solve (``measured_bytes`` rides along when the solve
    path measured its live tensors), or ``None``.  Reset before
    dispatching the solve being attributed
    (:func:`reset_last_memory_profile`), like every other last-slot."""
    return _LAST[0]


def reset_last_memory_profile() -> None:
    _LAST[0] = None


def note_footprint(footprint: MemoryFootprint, *,
                   measured_bytes: Optional[int] = None,
                   device_peak: Optional[int] = None,
                   shard_ids=None) -> MemoryFootprint:
    """Publish a freshly computed footprint: park it
    (:func:`last_memory_profile`) and, when telemetry is active, emit a
    ``memory_profile`` event plus ``hbm_bytes_persistent/peak/headroom``
    gauges.  ``measured_bytes`` is the live-tensor twin: the summed
    bytes of the tensors the dispatch pinned for the shards
    ``shard_ids`` (``None``: every shard, a stacked mesh); when present
    it is asserted against the matrix model of those shards EXACTLY -
    same numbers, two derivations - so drift between the model and
    what dist_cg actually ships fails loudly at the instrumentation
    site."""
    from .. import telemetry
    from .registry import REGISTRY

    if measured_bytes is not None:
        mine = footprint.matrix_bytes if shard_ids is None \
            else footprint.matrix_bytes[list(shard_ids)]
        predicted = int(mine.sum())
        if int(measured_bytes) != predicted:
            raise AssertionError(
                f"memscope model drift: partition tensors measure "
                f"{int(measured_bytes)} bytes on the device but the "
                f"static model says {predicted} "
                f"({footprint.kind}, P={footprint.n_shards})")
    _LAST[0] = {
        "footprint": footprint,
        "measured_bytes": (None if measured_bytes is None
                           else int(measured_bytes)),
        "device_peak_bytes": (None if device_peak is None
                              else int(device_peak)),
    }
    if not telemetry.active():
        return footprint
    payload = footprint.to_json()
    payload["measured_bytes"] = (None if measured_bytes is None
                                 else int(measured_bytes))
    payload["device_peak_bytes"] = (None if device_peak is None
                                    else int(device_peak))
    telemetry.events.emit("memory_profile", **payload)
    persistent = footprint.persistent_bytes
    g_p = REGISTRY.gauge("hbm_bytes_persistent",
                         "modeled persistent device bytes per shard "
                         "(matrix + solver working set)",
                         labelnames=("kind", "shard"))
    for k in range(footprint.n_shards):
        g_p.set(float(persistent[k]), kind=footprint.kind,
                shard=str(k))
    REGISTRY.gauge("hbm_bytes_peak",
                   "worst-shard modeled high-water bytes of the most "
                   "recent distributed solve",
                   labelnames=("kind",)).set(
        float(footprint.peak_bytes), kind=footprint.kind)
    head = footprint.headroom_frac
    if head is not None:
        REGISTRY.gauge("hbm_headroom_frac",
                       "fraction of device HBM left above the "
                       "modeled peak (negative = overflow)",
                       labelnames=("kind",)).set(
            float(head), kind=footprint.kind)
    return footprint
