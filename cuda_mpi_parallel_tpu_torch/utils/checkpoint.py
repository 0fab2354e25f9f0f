"""Solver-state checkpoint / resume.

Counterpart of the JAX package's ``utils/checkpoint.py``, with its file
format: the reference keeps its solver state (x, r, p, rho) only in
device memory, so a killed run restarts from zero.  Here the full CG
recurrence state (``solver.cg.CGCheckpoint``) round-trips through an
``.npz`` file, and ``solve_resumable`` runs a solve in segments,
persisting after each, so a long 256^3 run continues from where it
stopped with the *exact* iterate trajectory (p and rho resumed, not
restarted from x).

The tensors live on the operator's device; host numpy appears only at
the npz boundary.  The members, ``_FORMAT_VERSION``, the fingerprints
and the error texts are the JAX package's, so a checkpoint of a
matching operator (``Stencil2D``/``Stencil3D``, ``CSRMatrix``,
``ELLMatrix``, ``DIAMatrix``, ``DenseOperator``, ``JacobiPreconditioner``
built from the same arrays) written by either package resumes in the
other.  The f64 lane's file carries the JAX (hi, lo) pairs and, beside
them, the port's float64 state (``state64_*`` members, which the JAX
loader ignores), so a port-to-port resume from disk continues the
float64 trajectory bit for bit.

orbax (``backend="orbax"``, ``save_checkpoint_orbax``,
``load_checkpoint_orbax``) is a JAX library with no PyTorch
counterpart: those names raise ``NotImplementedError``, and the npz
lane is the port's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .._device import is_hopper
from ..convert import checkpoint_from_arrays, df64_checkpoint_from_arrays
from ..models.operators import LinearOperator
from ..parallel.partition import _host
from ..solver.cg import CGCheckpoint, CGResult, _as_operator, solve

# Bumped 1 -> 2 when the fingerprint scheme changed to cover operator
# coefficients: a version-1 checkpoint's fingerprint is not comparable,
# so loading it must fail with the accurate "format version" error
# rather than a spurious "different problem".
_FORMAT_VERSION = 2

# Operator dataclass fields EXCLUDED from problem identity:
#   backend          - selects a kernel (plain torch vs the hand kernel),
#                      not a linear system; the same checkpoint must
#                      resume under either.
#   rows             - derived from indptr at construction
#                      (CSRMatrix.from_arrays); hashing it adds bytes,
#                      never identity.
#   device, _device  - where the operator lives: a checkpoint written on
#                      the card resumes on the CPU and the reverse.
_FP_EXCLUDE_FIELDS = frozenset({"backend", "rows", "device", "_device"})

#: the df64 resident replay's summation radix as the JAX package records
#: it (its default): the port's B11 has one fixed reduction order
_REPLAY_FOLD_RADIX = 2

#: the float64 state a port-written df64 checkpoint carries beside the
#: pairs (``DF64Checkpoint.state64``), each as an npz member
_STATE64_MEMBERS = tuple(f"state64_{n}"
                         for n in ("x", "r", "p", "rho", "rr", "rr0"))


class CheckpointMismatch(ValueError):
    """A checkpoint belongs to a different problem or layout
    (fingerprint mismatch).  Typed so recovery/serving layers can
    branch on it; still a ``ValueError`` for every existing caller.

    ``migratable`` splits the refusal (elastic solves): ``True`` means
    the PROBLEM matches and only the layout (mesh shape / partition
    plan / exchange lane) differs - exactly what
    ``solve_resumable_distributed(elastic=True)`` auto-migrates via
    ``robust.elastic.migrate_checkpoint``; ``False`` (the default)
    means the operator/rhs fingerprint itself differs - no migration
    can make a checkpoint of a DIFFERENT system resumable.
    ``stored_layout`` carries the checkpoint's recorded layout
    metadata when it was available."""

    def __init__(self, message: str, *, migratable: bool = False,
                 stored_layout: Optional[dict] = None):
        super().__init__(message)
        self.migratable = migratable
        self.stored_layout = stored_layout


class CheckpointCorrupt(ValueError):
    """A checkpoint file exists but cannot be read (truncated zip,
    missing members, torn write).  Typed so the resumable loops can
    fall back to the previous retained snapshot (``keep_last``)
    instead of dying on the newest file - corruption must degrade to
    "resume from the one before", never to an unhandled traceback."""


def _shape(a) -> tuple:
    """An operator's shape as the JAX package prints it: a tuple of
    Python ints (a tensor's ``torch.Size`` would print otherwise)."""
    return tuple(int(s) for s in a.shape)


def _update_operator_hash(h, a) -> None:
    """Feed an operator's FULL mathematical identity into ``h``: array
    fields hash by name/dtype/shape/bytes and static fields by repr, in
    sorted field order; execution-strategy and placement fields
    (``_FP_EXCLUDE_FIELDS``) are excluded.  For the operator dataclasses
    whose fields match the JAX package's, built from the same arrays,
    the bytes fed are the JAX package's.  ``ShiftELLMatrix`` and
    ``ShiftELLDF64Matrix`` keep Hopper's sliced-ELL arrays in place of
    the TPU's shift-ELL sheets, so their fingerprints cannot match the
    JAX ones (a checkpoint of those crosses packages only through the
    CSR it was packed from)."""
    h.update(f"fpv2:{type(a).__name__}:{_shape(a)};".encode())
    if dataclasses.is_dataclass(a):
        fields = sorted(dataclasses.fields(a), key=lambda f: f.name)
        for f in fields:
            if f.name in _FP_EXCLUDE_FIELDS:
                continue
            v = getattr(a, f.name)
            if isinstance(v, (torch.Tensor, np.ndarray)):
                arr = _host(v)
                h.update(f"{f.name}:{arr.dtype}:{arr.shape}:".encode())
                h.update(np.ascontiguousarray(arr).tobytes())
            else:
                h.update(f"{f.name}={v!r};".encode())
    else:   # a raw tensor, or a non-dataclass operator's tensors
        leaves = [a] if isinstance(a, (torch.Tensor, np.ndarray)) else [
            v for _, v in sorted(vars(a).items())
            if isinstance(v, (torch.Tensor, np.ndarray))]
        for leaf in leaves:
            arr = _host(leaf)
            h.update(f"{arr.dtype}:{arr.shape}:".encode())
            h.update(np.ascontiguousarray(arr).tobytes())


def operator_fingerprint(a) -> str:
    """Digest of one operator's mathematical identity (no rhs) - the
    solver service's handle key component (repeat traffic on the same
    matrix must land on the same state, whatever kernel backend built
    it)."""
    import hashlib

    h = hashlib.sha256()
    _update_operator_hash(h, a)
    return h.hexdigest()[:16]


def problem_fingerprint(a, b) -> str:
    """Identify the (operator, rhs) a checkpoint belongs to.

    On resume the recurrence never re-reads b (r comes from the state), so
    resuming against the wrong problem would silently 'converge' to the old
    system's solution - the fingerprint turns that into a loud error.
    Hashing scheme: see :func:`_update_operator_hash` (the JAX package's
    bytes for matching operators).
    """
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(_host(b)).tobytes())
    _update_operator_hash(h, a)
    return h.hexdigest()[:16]


def _atomic_savez(path: str, **fields) -> None:
    """Write an npz atomically: a ``tempfile.mkstemp`` sibling in the
    target directory, then ``os.replace``.  A preemption mid-write can
    never leave a truncated file at ``path`` (readers see the old
    snapshot or the new one, nothing in between), the unique temp name
    cannot collide with a concurrent writer, and a failed write cleans
    its temp up instead of littering the checkpoint directory."""
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **fields)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _refuse_orbax(what: str):
    raise NotImplementedError(
        f"{what}: orbax is a JAX library with no PyTorch counterpart; "
        f"the port's checkpoints use the npz lane (backend='npz', "
        f"save_checkpoint/load_checkpoint), whose file format the JAX "
        f"package reads too")


def save_checkpoint(path: str, ckpt: CGCheckpoint,
                    fingerprint: str = "",
                    layout: Optional[dict] = None) -> None:
    """Persist a CG checkpoint (atomically: write temp + rename).

    ``layout``: optional JSON-able layout metadata (the distributed
    resumable loop records problem fingerprint + mesh shape +
    partition plan + exchange lane) - what makes the checkpoint
    MIGRATABLE to a different mesh shape later
    (``robust.elastic.migrate_checkpoint``)."""
    import json

    fields = dict(
        version=_FORMAT_VERSION,
        fingerprint=fingerprint,
        **{name: _host(getattr(ckpt, name))
           for name in ("x", "r", "p", "rho", "rr", "nrm0", "k",
                        "indefinite")})
    if layout is not None:
        fields["layout"] = json.dumps(layout)
    _atomic_savez(path, **fields)


def _check_fingerprint(stored: str, expect: str, path: str) -> None:
    """Enforce the problem-identity check all load paths share.

    A stored-but-different fingerprint is a hard error.  A checkpoint
    saved WITHOUT a fingerprint cannot be verified: when the caller asked
    for verification (non-empty ``expect``), accepting it silently would
    defeat the wrong-system protection ``problem_fingerprint`` exists
    for - warn loudly instead of either silently resuming or breaking
    legitimately fingerprint-less manual saves.
    """
    if not expect:
        return
    if stored and stored != expect:
        raise CheckpointMismatch(
            f"checkpoint {path} belongs to a different problem "
            f"(fingerprint {stored} != {expect}); refusing "
            f"to resume - delete it to start fresh")
    if not stored:
        import warnings

        warnings.warn(
            f"checkpoint {path} was saved without a problem fingerprint; "
            f"cannot verify it belongs to this system - resuming "
            f"UNVERIFIED (re-save with fingerprint= to enable the check)",
            UserWarning, stacklevel=3)


def _check_version(z: dict, path: str) -> None:
    version = int(np.asarray(z["version"]))
    if version != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path} has format version {version}, "
            f"expected {_FORMAT_VERSION}")


def _check_stored_fingerprint(z: dict, expect: str, path: str) -> None:
    _check_fingerprint(str(z["fingerprint"]) if "fingerprint" in z else "",
                       expect, path)


def _load_npz_arrays(path: str) -> dict:
    """Materialize every member of a checkpoint npz as host arrays.

    Corruption is TYPED here: a truncated zip (torn write without the
    atomic rename), an unreadable member or a missing file body raises
    :class:`CheckpointCorrupt` so resumable loops can fall back to the
    previous retained snapshot.  A missing file stays
    ``FileNotFoundError`` (absent, not corrupt)."""
    import zipfile
    import zlib

    try:
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
            ValueError, KeyError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable ({type(e).__name__}: "
            f"{e}); it was likely torn by a crash mid-write - resume "
            f"from the previous retained snapshot (keep_last) or "
            f"delete it to start fresh") from e


def load_checkpoint(path: str, expect_fingerprint: str = "",
                    device=None) -> CGCheckpoint:
    """A CG checkpoint from ``path`` as tensors on ``device`` (``None``
    = the card, the device rule)."""
    z = _load_npz_arrays(path)
    if "kind" in z and str(z["kind"]) == "df64":
        raise ValueError(
            f"checkpoint {path} is a df64 checkpoint; load it with "
            f"load_checkpoint_df64 and resume with cg_df64")
    if "version" not in z or "x" not in z:
        raise CheckpointCorrupt(
            f"checkpoint {path} is missing required members "
            f"(version/x): not a CG checkpoint, or torn mid-write")
    _check_version(z, path)
    _check_stored_fingerprint(z, expect_fingerprint, path)
    return checkpoint_from_arrays(z, device)


def _df64_fields() -> tuple:
    """The JAX ``DF64Checkpoint`` fields (the port's less ``state64``)."""
    from ..solver.df64 import DF64Checkpoint

    return tuple(f.name for f in dataclasses.fields(DF64Checkpoint)
                 if f.name != "state64")


def save_checkpoint_df64(path: str, ckpt, fingerprint: str = "") -> None:
    """Persist a ``DF64Checkpoint`` (atomic npz; schema mirrors
    ``save_checkpoint`` with the double-float state pairs, which the JAX
    loader reads, and the float64 state beside them when the port wrote
    the checkpoint)."""
    fields = {name: _host(getattr(ckpt, name)) for name in _df64_fields()}
    if ckpt.state64 is not None:
        fields.update({m: _host(v) for m, v in zip(_STATE64_MEMBERS,
                                                   ckpt.state64)})
    _atomic_savez(path, version=_FORMAT_VERSION,
                  fingerprint=fingerprint, kind="df64", **fields)


def load_checkpoint_df64(path: str, expect_fingerprint: str = "",
                         device=None):
    """A ``DF64Checkpoint`` from ``path`` as tensors on ``device``
    (``None`` = the card): its float64 state when the file carries one
    (a port-written checkpoint), else the pairs alone (a JAX one)."""
    z = _load_npz_arrays(path)
    _check_version(z, path)
    if "kind" in z and str(z["kind"]) == "df64-replay":
        raise ValueError(
            f"checkpoint {path} is a resident-engine replay "
            f"checkpoint; resume it with solve_resumable_df64("
            f"engine='resident') - or delete it to start fresh")
    if "kind" not in z or str(z["kind"]) != "df64":
        raise ValueError(
            f"checkpoint {path} is not a df64 checkpoint; load it "
            f"with load_checkpoint and resume with solve")
    _check_stored_fingerprint(z, expect_fingerprint, path)
    ckpt = df64_checkpoint_from_arrays(z, device)
    if not all(m in z for m in _STATE64_MEMBERS):
        return ckpt
    return dataclasses.replace(ckpt, state64=tuple(
        torch.as_tensor(z[m], device=ckpt.k.device)
        for m in _STATE64_MEMBERS))


def save_checkpoint_orbax(path: str, ckpt: CGCheckpoint,
                          fingerprint: str = "") -> None:
    """Not available: orbax is a JAX library (the npz lane is the
    port's)."""
    _refuse_orbax("save_checkpoint_orbax")


def load_checkpoint_orbax(path: str, expect_fingerprint: str = "",
                          like: Optional[CGCheckpoint] = None
                          ) -> CGCheckpoint:
    """Not available: orbax is a JAX library (the npz lane is the
    port's)."""
    _refuse_orbax("load_checkpoint_orbax")


def _check_backend(backend: str, what: str) -> None:
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend: {backend!r}")
    if backend == "orbax":
        _refuse_orbax(f"{what}(backend='orbax')")


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def solve_resumable(
    a,
    b,
    path: str,
    *,
    segment_iters: int = 500,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    m=None,
    keep_checkpoint: bool = False,
    backend: str = "npz",
) -> CGResult:
    """Solve A x = b, checkpointing to ``path`` every ``segment_iters``.

    If ``path`` exists the solve resumes from it (exact trajectory).  On
    convergence the checkpoint is removed unless ``keep_checkpoint``.
    ``backend``: ``"npz"`` (single-file, framework-free); ``"orbax"``
    raises ``NotImplementedError`` (a JAX library).

    Each segment is one ``solve(engine="general")`` with the TOTAL
    ``maxiter`` and the segment's ``iter_cap``, on the operator's device:
    on the card a ``backend="pallas"`` stencil runs B1/B2 and a
    ``ShiftELLMatrix`` B8.  The per-segment host round-trip costs one
    save of three vectors per ``segment_iters`` iterations - the price
    of being able to survive preemption (which the reference cannot).
    """
    if segment_iters < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    _check_backend(backend, "solve_resumable")
    fp = problem_fingerprint(a, b)
    if not isinstance(a, LinearOperator):
        a = _as_operator(a)
    state: Optional[CGCheckpoint] = None
    if os.path.exists(path):
        if os.path.isdir(path):
            raise ValueError(
                f"checkpoint at {path} is in orbax format but "
                f"backend='npz' was requested; pass backend='orbax' to "
                f"resume it (or delete it)")
        state = load_checkpoint(path, expect_fingerprint=fp,
                                device=a.device)

    while True:
        done_k = int(state.k) if state is not None else 0
        cap = min(done_k + segment_iters, maxiter)
        # maxiter stays constant (the TOTAL cap, which the checkpoint's k
        # counts against); only iter_cap advances per segment
        res = solve(a, b, tol=tol, rtol=rtol, maxiter=maxiter, m=m,
                    resume_from=state, return_checkpoint=True,
                    iter_cap=cap)
        if res.status_enum().name == "BREAKDOWN":
            # never overwrite the last good checkpoint with the
            # breakdown segment's non-finite recurrence state - the
            # pre-fault progress on disk is what a retry resumes from
            return res
        state = res.checkpoint
        save_checkpoint(path, state, fingerprint=fp)
        finished = bool(res.converged) or int(res.iterations) >= maxiter
        if finished:
            if bool(res.converged) and not keep_checkpoint:
                _remove(path)
            return res


def _snapshot_paths(path: str, keep_last: int) -> list:
    """The retention chain, newest first: ``path`` then
    ``path.prev1`` .. ``path.prev{keep_last-1}``."""
    return [path] + [f"{path}.prev{i}" for i in range(1, keep_last)]


def _rotate_snapshots(path: str, keep_last: int) -> None:
    """Shift the retention chain one slot (newest -> .prev1 -> ...)
    before a new save, so the last ``keep_last`` snapshots survive
    even a newest file torn by a crash that beat the atomic rename's
    guarantees (e.g. filesystem loss)."""
    if keep_last <= 1:
        return
    chain = _snapshot_paths(path, keep_last)
    for i in range(len(chain) - 2, -1, -1):
        if os.path.exists(chain[i]):
            os.replace(chain[i], chain[i + 1])


def _remove_snapshots(path: str, keep_last: int) -> None:
    for p in _snapshot_paths(path, keep_last):
        _remove(p)


def _read_distributed_snapshot(path: str):
    """``(checkpoint, stored_fingerprint, layout|None)`` of one
    distributed npz snapshot, WITHOUT a fingerprint check (the
    resumable loop decides migratable-vs-fatal itself); the leaves are
    host numpy.  Raises :class:`CheckpointCorrupt` for torn/unreadable
    files."""
    import json

    z = _load_npz_arrays(path)
    if "version" not in z or "x" not in z:
        raise CheckpointCorrupt(
            f"checkpoint {path} is missing required members "
            f"(version/x): not a CG checkpoint, or torn mid-write")
    stored = str(z["fingerprint"]) if "fingerprint" in z else ""
    layout = None
    if "layout" in z:
        try:
            layout = json.loads(str(z["layout"]))
        except json.JSONDecodeError as e:
            raise CheckpointCorrupt(
                f"checkpoint {path} has unparseable layout metadata "
                f"({e}); torn mid-write - fall back or delete") from e
        if not isinstance(layout, dict):
            raise CheckpointCorrupt(
                f"checkpoint {path} layout metadata is not an object")
    _check_version(z, path)
    raw = CGCheckpoint(**{f.name: np.asarray(z[f.name])
                          for f in dataclasses.fields(CGCheckpoint)})
    return raw, stored, layout


def distributed_fingerprint(a, b, *, n_shards: int, plan=None,
                            exchange=None,
                            csr_comm: str = "allgather") -> str:
    """Identify the (problem, layout) a DISTRIBUTED checkpoint belongs
    to.  A distributed ``CGCheckpoint``'s vector leaves live in the
    padded row layout of one exact partition - resuming it under a
    different mesh size, partition plan or exchange lane would scatter
    the recurrence vectors to the wrong rows and silently converge to
    garbage.  This fingerprint folds the layout identity (shard count,
    plan fingerprint, exchange/comm lane) into the problem fingerprint
    so that mismatch fails loudly (:class:`CheckpointMismatch`); it is
    the JAX package's digest."""
    import hashlib

    lane = plan.fingerprint() if plan is not None else "even"
    spec = (f"{problem_fingerprint(a, b)};shards={n_shards};"
            f"plan={lane};exchange={exchange};comm={csr_comm}")
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def _host_checkpoint(ckpt) -> CGCheckpoint:
    """A checkpoint's leaves gathered to host numpy once (the save and a
    migration consume numpy)."""
    return CGCheckpoint(**{f.name: _host(getattr(ckpt, f.name))
                           for f in dataclasses.fields(CGCheckpoint)})


def solve_resumable_distributed(
    a,
    b,
    path: str,
    *,
    mesh=None,
    n_devices: Optional[int] = None,
    segment_iters: int = 500,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    preconditioner: Optional[str] = None,
    plan=None,
    exchange=None,
    keep_checkpoint: bool = False,
    backend: str = "npz",
    preempt=None,
    elastic: bool = False,
    keep_last: int = 1,
    watchdog=None,
    **kw,
) -> CGResult:
    """Distributed sibling of :func:`solve_resumable`: a mesh solve in
    segments, persisting the full recurrence state after each, so a
    preempted 256^3-class run resumes the *exact* iterate trajectory
    (p and rho restored, not restarted).

    Scope mirrors ``solve_distributed``'s checkpoint lane: assembled
    ``CSRMatrix`` on the allgather/gather exchange, ``method="cg"``.
    The checkpoint fingerprint covers the problem AND the layout (mesh
    size, resolved partition plan, exchange lane); the file also
    records the layout ITSELF (mesh shape, plan ranges + permutation,
    exchange lane) as metadata.  Resuming under a mismatched layout
    raises :class:`CheckpointMismatch` - with ``migratable=True`` when
    only the layout differs, ``False`` when the operator/rhs
    fingerprint itself does.  The plan (``plan=``: ``None``, ``"auto"``
    or a ``balance.PartitionPlan``) is resolved ONCE per mesh, so every
    segment shares one layout and runs the same cached per-shard solver
    (``maxiter`` stays the total cap, only ``iter_cap`` advances).

    ``elastic=True`` turns the migratable refusal into a migration
    (``robust.elastic.migrate_checkpoint``): a checkpoint written at a
    different shard count / plan / exchange lane is lifted to global
    row order, re-laid out for THIS mesh under the resolved plan and
    resumed - residual continuity across the seam is the asserted
    contract (``solve_migration`` event, ``solve_migrations_total``).
    In-run, elastic mode also answers two triggers with
    checkpoint-now-and-migrate: a ``robust.StragglerWatchdog`` finding
    (``watchdog=`` profiles the partition every
    ``check_every_segments`` segments through
    ``telemetry.phasetrace.profile_distributed`` and compares per-shard
    SpMV seconds and per-link bandwidths against its EWMA baselines -
    typed ``shard_degraded`` events) and the host-level ``shard_loss``
    drill site.  Both drop the affected shard count and continue on a
    smaller stacked mesh.

    ``keep_last=K`` retains the K most recent snapshots (``path``,
    ``path.prev1``, ...); a torn/unreadable newest file is a typed
    :class:`CheckpointCorrupt` and resume falls back to the previous
    snapshot, loudly (``solve_recovery`` event,
    ``action="checkpoint_fallback"``, ``checkpoint_fallbacks_total``).

    ``preempt``: optional host hook (e.g. ``robust.Preemption``) called
    with the number of completed segments after each save - raising
    :class:`robust.PreemptedError` there simulates a killed worker with
    its state safely on disk; a later identical call resumes.
    ``**kw`` forwards to ``solve_distributed`` (check_every, flight,
    ...).

    On a process-group mesh of several ranks, rank 0 alone writes and
    removes the files (each rank holds the same global state) and every
    rank reads them; a barrier follows each write, so no rank reads or
    returns ahead of the file.

    ``inject=`` (in ``**kw``): an in-trace ``robust.FaultPlan`` passes
    through to ``solve_distributed`` - a breakdown segment returns its
    typed result and leaves the last good checkpoint on disk; the
    host-level sites are consumed HERE.  ``shard_slow`` (it needs
    ``watchdog=``) inflates the measured profile of its shard
    (``FaultPlan.doctor_profile``), so the watchdog's real detection
    path runs end to end; ``shard_loss``, at the firing segment boundary
    (``FaultPlan.fires_segment``), migrates the saved state to
    ``n_shards - 1`` stacked shards and the solve goes on there
    (``elastic=True``; without it ``robust.ShardLostError``).  A
    migration re-plans (``plan="auto"``) unless the caller asked for the
    even split all along.

    Not ported: ``backend="orbax"`` (a JAX library), which raises
    ``NotImplementedError``.
    """
    from ..parallel.dist_cg import (
        _plan_exchange_hint,
        resolve_plan,
        solve_distributed,
    )
    from ..parallel.mesh import make_mesh

    if segment_iters < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    _check_backend(backend, "solve_resumable_distributed")
    # host-level chaos sites (shard_slow / shard_loss) are consumed by
    # THIS loop - an in-trace FaultPlan passes through to the solve
    host_fault = None
    inj = kw.get("inject")
    if inj is not None and getattr(inj, "host_level", False):
        host_fault = kw.pop("inject")
        if host_fault.site == "shard_slow" and watchdog is None:
            raise ValueError(
                "inject site 'shard_slow' drills the straggler "
                "watchdog - pass watchdog=robust.StragglerWatchdog()")
        if host_fault.site == "shard_loss" and not elastic:
            from ..robust.inject import ShardLostError

            raise ShardLostError(
                "inject site 'shard_loss' needs elastic=True (a lost "
                "shard can only be survived by migrating off it)")
    if mesh is None:
        mesh = make_mesh(n_devices)
    n_shards = int(mesh.size)
    if host_fault is not None:
        if n_shards <= 1:
            raise ValueError(
                f"inject site {host_fault.site!r} needs a mesh of "
                f">= 2 shards (there is nothing to migrate off at 1)")
        if host_fault.shard >= n_shards:
            raise ValueError(
                f"inject targets shard {host_fault.shard} but the "
                f"mesh has {n_shards}")
    if mesh.comm.kind != "stacked" and (
            host_fault is not None or (watchdog is not None and elastic)):
        raise ValueError(
            "the in-run migration (shard_loss, shard_slow or a watchdog "
            "finding) shrinks a stacked mesh; a process group keeps its "
            "ranks (migrate at load time: resume on the smaller group "
            "with elastic=True)")
    comm = mesh.comm
    group = getattr(comm, "kind", "") == "distributed" \
        and comm.n_shards > 1
    writer = not group or comm.rank == 0
    plan_spec = plan
    plan_resolved = resolve_plan(
        plan, a, n_shards,
        exchange=_plan_exchange_hint("allgather", exchange))
    problem_fp = problem_fingerprint(a, b)
    fp = distributed_fingerprint(a, b, n_shards=n_shards,
                                 plan=plan_resolved, exchange=exchange)

    def sync() -> None:
        if group:
            import torch.distributed as dist

            dist.barrier()

    def layout_meta() -> dict:
        return {
            "problem": problem_fp,
            "n_shards": n_shards,
            "exchange": exchange,
            "comm": "allgather",
            "plan": (plan_resolved.layout_json()
                     if plan_resolved is not None else None),
        }

    def save_state(st: CGCheckpoint) -> None:
        if writer:
            _rotate_snapshots(path, keep_last)
            save_checkpoint(path, st, fingerprint=fp, layout=layout_meta())
        sync()

    def note_migration(mig, reason: str, **extra) -> None:
        from ..telemetry import events
        from ..telemetry.registry import REGISTRY

        REGISTRY.counter(
            "solve_migrations_total",
            "distributed checkpoints migrated to a new mesh shape "
            "(robust.elastic)", labelnames=("reason",)).inc(
                reason=reason)
        events.emit("solve_migration", reason=reason, **mig.to_json(),
                    **extra)

    if os.path.isdir(path):
        raise ValueError(
            f"checkpoint at {path} is in orbax format but "
            f"backend='npz' was requested; pass backend='orbax' to "
            f"resume it (or delete it)")

    state: Optional[CGCheckpoint] = None
    migrated = False
    first_corrupt: Optional[CheckpointCorrupt] = None
    corrupt_paths: list = []
    for idx, p in enumerate(_snapshot_paths(path, keep_last)):
        if not os.path.exists(p):
            continue
        try:
            raw, stored_fp, layout = _read_distributed_snapshot(p)
        except CheckpointCorrupt as e:
            if first_corrupt is None:
                first_corrupt = e
            corrupt_paths.append(p)
            continue
        if layout is not None and layout.get("problem") != problem_fp:
            raise CheckpointMismatch(
                f"checkpoint {p} belongs to a DIFFERENT problem "
                f"(operator/rhs fingerprint {layout.get('problem')} "
                f"!= {problem_fp}); no migration can make a "
                f"checkpoint of another system resumable - delete it "
                f"to start fresh", migratable=False,
                stored_layout=layout)
        if stored_fp == fp:
            state = raw
        elif layout is not None:
            if not elastic:
                raise CheckpointMismatch(
                    f"checkpoint {p} was written under a different "
                    f"layout (mesh {layout.get('n_shards')} -> "
                    f"{n_shards} shards); the problem matches, so it "
                    f"IS migratable - pass elastic=True to "
                    f"auto-migrate and resume", migratable=True,
                    stored_layout=layout)
            from ..balance.plan import PartitionPlan
            from ..robust import elastic as rel

            plan_old = (PartitionPlan.from_layout_json(layout["plan"])
                        if layout.get("plan") else None)
            mig = rel.migrate_checkpoint(
                raw, n_shards, a=a, n_shards_old=int(layout["n_shards"]),
                plan_old=plan_old, plan=plan_resolved, exchange=exchange)
            plan_resolved = mig.plan
            fp = distributed_fingerprint(
                a, b, n_shards=n_shards, plan=plan_resolved,
                exchange=exchange)
            state = mig.checkpoint
            migrated = True
            note_migration(mig, "resume_mesh_change", path=p)
        else:
            # a checkpoint without layout metadata: the combined-
            # fingerprint refusal, unchanged
            _check_fingerprint(stored_fp, fp, p)
            state = raw
        # every rank has read the chain before rank 0 changes it
        sync()
        if idx > 0:
            from ..telemetry import events
            from ..telemetry.registry import REGISTRY

            # remove the corrupt newer snapshots NOW: the next save
            # rotates the chain, and a known-corrupt file left at
            # `path` would be rotated OVER the good snapshot we just
            # resumed from - a preemption in that window would then
            # lose every recoverable state
            if writer:
                for bad in corrupt_paths:
                    _remove(bad)
            REGISTRY.counter(
                "checkpoint_fallbacks_total",
                "resumes that skipped corrupt newer checkpoints and "
                "fell back to an older retained snapshot").inc()
            events.emit("solve_recovery", attempt=0,
                        action="checkpoint_fallback", path=p,
                        skipped=len(corrupt_paths))
        if migrated:
            save_state(state)   # the migrated state is checkpointed
        break
    else:
        if first_corrupt is not None:
            # every retained snapshot was unreadable: typed, loud
            raise first_corrupt

    segments = 0
    while True:
        done_k = int(state.k) if state is not None else 0
        cap = min(done_k + segment_iters, maxiter)
        res = solve_distributed(
            a, b, mesh=mesh, tol=tol, rtol=rtol, maxiter=maxiter,
            preconditioner=preconditioner, plan=plan_resolved,
            exchange=exchange, resume_from=state, return_checkpoint=True,
            iter_cap=cap, **kw)
        if res.status_enum().name == "BREAKDOWN":
            # do NOT save: the breakdown segment's recurrence state is
            # non-finite, and overwriting the last good checkpoint
            # with it would make every later resume break down
            # immediately
            return res
        state = _host_checkpoint(res.checkpoint)
        save_state(state)
        segments += 1
        finished = bool(res.converged) or int(res.iterations) >= maxiter
        if finished:
            if bool(res.converged) and not keep_checkpoint:
                if writer:
                    _remove_snapshots(path, keep_last)
                sync()
            return res
        # -- elastic triggers: run AFTER the save (the state on disk is
        # what a migration re-lays out) and BEFORE the preempt hook (a
        # drill that both degrades and preempts must emit its
        # shard_degraded findings before the kill)
        migrate_to = None
        reason = None
        extra: dict = {}
        if watchdog is not None and n_shards > 1 \
                and segments % watchdog.check_every_segments == 0:
            from ..telemetry import phasetrace

            profile = phasetrace.profile_distributed(
                a, mesh=mesh, plan=plan_resolved, exchange=exchange,
                repeats=watchdog.profile_repeats)
            if host_fault is not None:
                profile = host_fault.doctor_profile(profile, segments)
            findings = watchdog.observe(profile)
            drop = watchdog.degraded_shards(findings)
            if drop and elastic and n_shards - len(drop) >= 1:
                migrate_to = n_shards - len(drop)
                reason = "shard_degraded"
                extra = {"degraded_shards": list(drop)}
        if migrate_to is None and host_fault is not None \
                and host_fault.site == "shard_loss" \
                and host_fault.fires_segment(segments):
            migrate_to = n_shards - 1
            reason = "shard_loss"
            extra = {"lost_shard": host_fault.shard}
        if migrate_to is not None:
            from ..robust import elastic as rel

            mig = rel.migrate_checkpoint(
                state, migrate_to, a=a, n_shards_old=n_shards,
                plan_old=plan_resolved,
                # an explicit old-mesh plan cannot target the new one;
                # re-plan unless the caller asked for the even split
                plan=("auto" if plan_spec is not None else None),
                exchange=exchange)
            mesh = make_mesh(migrate_to, axis_name=mesh.axis_names[0],
                             devices=[mesh.device] * migrate_to)
            n_shards = migrate_to
            plan_resolved = mig.plan
            fp = distributed_fingerprint(a, b, n_shards=n_shards,
                                         plan=plan_resolved,
                                         exchange=exchange)
            state = mig.checkpoint
            note_migration(mig, reason, **extra)
            save_state(state)   # checkpoint-now-and-migrate
            host_fault = None   # the affected shard is off the mesh
        if preempt is not None:
            preempt(segments)


def solve_resumable_df64(
    a,
    b,
    path: str,
    *,
    segment_iters: int = 500,
    tol: float = 1e-7,
    rtol: float = 0.0,
    maxiter: int = 2000,
    preconditioner=None,
    keep_checkpoint: bool = False,
    engine: str = "general",
    interpret: bool = False,
):
    """f64 sibling of :func:`solve_resumable`: f64-class long solves
    that survive preemption, checkpointing every ``segment_iters``.

    ``engine="general"`` runs each segment through ``cg_df64`` with the
    TOTAL ``maxiter`` and the segment's ``iter_cap`` (a
    ``backend="pallas"`` stencil runs the f64 B1/B2 on the card); the
    state persists as the npz df64 checkpoint, whose float64 members
    make the resumed run continue the exact float64 trajectory.

    ``engine="resident"`` runs segments on the one-launch f64 kernel
    B11 (``solver.resident.cg_resident_df64``) by REPLAY: each segment
    re-runs the solve from iteration 0 up to the advancing ``iter_cap``
    inside one launch, so the trajectory is bitwise identical to an
    uninterrupted resident solve (same kernel, same inputs,
    deterministic recurrence).  The checkpoint stores only
    ``(k, x_hi, x_lo)`` (``kind="df64-replay"``) - the kernel holds
    r/p/rho on chip, and the replay re-derives them.  ``engine="auto"``
    picks resident when ``supports_resident_df64(a, preconditioned=...)``
    holds and the kernel runs compiled - on a Hopper card, the port's
    counterpart of the JAX package's TPU test - or ``interpret=True``
    asks for B11's plain twin; general otherwise.
    """
    from ..solver.df64 import cg_df64

    if segment_iters < 1:
        raise ValueError(f"segment_iters must be >= 1, got {segment_iters}")
    if engine not in ("general", "resident", "auto"):
        raise ValueError(f"unknown engine {engine!r}; expected 'general', "
                         f"'auto' or 'resident'")
    b64 = b.detach().double() if isinstance(b, torch.Tensor) \
        else torch.as_tensor(np.asarray(b, dtype=np.float64))
    fp = problem_fingerprint(a, b64)
    if engine in ("resident", "auto"):
        from ..solver.resident import supports_resident_df64

        ok = supports_resident_df64(
            a, preconditioned=preconditioner == "chebyshev")
        ok = ok and preconditioner in (None, "chebyshev")
        if engine == "auto":
            # auto takes the resident kernel only where it runs compiled
            # (or the caller explicitly asked for its twin): off the card
            # the twin is slower than the general solver - the same rule
            # as solve(engine="auto")
            ok = ok and (is_hopper(a.device) or interpret)
        if engine == "resident" and not ok:
            raise ValueError(
                "engine='resident' needs a 2D/3D stencil whose df64 "
                "working set fits on chip and preconditioner None or "
                "'chebyshev' - use engine='general' (or 'auto')")
        if ok:
            return _solve_resumable_df64_resident(
                a, b64, path, segment_iters=segment_iters, tol=tol,
                rtol=rtol, maxiter=maxiter, preconditioner=preconditioner,
                keep_checkpoint=keep_checkpoint, fingerprint=fp,
                interpret=interpret)
    state = None
    if os.path.exists(path):
        state = load_checkpoint_df64(path, expect_fingerprint=fp,
                                     device=a.device)

    while True:
        done_k = int(state.k) if state is not None else 0
        cap = min(done_k + segment_iters, maxiter)
        res = cg_df64(a, b64, tol=tol, rtol=rtol, maxiter=maxiter,
                      preconditioner=preconditioner, resume_from=state,
                      return_checkpoint=True, iter_cap=cap)
        if res.status_enum().name == "BREAKDOWN":
            # see solve_resumable: the poisoned segment state must
            # not clobber the last good checkpoint
            return res
        state = res.checkpoint
        save_checkpoint_df64(path, state, fingerprint=fp)
        finished = bool(res.converged) or int(res.iterations) >= maxiter
        if finished:
            if bool(res.converged) and not keep_checkpoint:
                _remove(path)
            return res


def _save_replay_ckpt(path, k, x_hi, x_lo, fingerprint):
    """Replay-mode checkpoint: progress marker + current iterate.  B11
    keeps r/p/rho on chip and the replay re-derives them; x is stored
    for inspection (it IS the current solution estimate), k is what
    resume needs.  The fold radix is the JAX package's default, which
    its loader checks; the port's B11 has one summation order."""
    _atomic_savez(path, version=_FORMAT_VERSION,
                  fingerprint=fingerprint,
                  kind="df64-replay", k=np.asarray(k),
                  fold_radix=np.asarray(_REPLAY_FOLD_RADIX),
                  x_hi=_host(x_hi), x_lo=_host(x_lo))


def _load_replay_k(path, expect_fingerprint) -> int:
    z = _load_npz_arrays(path)
    if "kind" not in z or str(z["kind"]) != "df64-replay":
        raise ValueError(
            f"checkpoint {path} is not a df64 replay checkpoint "
            f"(engine='resident'); it belongs to the general-path "
            f"format - resume with the engine that wrote it, or "
            f"delete it to start fresh")
    _check_version(z, path)
    _check_stored_fingerprint(z, expect_fingerprint, path)
    saved_radix = (int(np.asarray(z["fold_radix"]))
                   if "fold_radix" in z else _REPLAY_FOLD_RADIX)
    if saved_radix != _REPLAY_FOLD_RADIX:
        raise ValueError(
            f"checkpoint {path} was written with df64 fold radix "
            f"{saved_radix}, but the port has one summation order (its "
            f"f64 kernel sums natively, as radix {_REPLAY_FOLD_RADIX} "
            f"records): the replay's bitwise guarantee depends on the "
            f"summation order - delete the checkpoint to start fresh")
    return int(np.asarray(z["k"]))


def _solve_resumable_df64_resident(a, b64, path, *, segment_iters, tol,
                                   rtol, maxiter, preconditioner,
                                   keep_checkpoint, fingerprint,
                                   interpret):
    """Replay segmentation on B11 (see ``solve_resumable_df64``).  Every
    segment runs the same kernel with only ``iter_cap`` advanced, so
    iterates at any given iteration are bitwise identical across
    segmentations."""
    from ..solver.resident import cg_resident_df64

    done_k = 0
    if os.path.exists(path):
        done_k = _load_replay_k(path, fingerprint)
    while True:
        cap = min(done_k + segment_iters, maxiter)
        res = cg_resident_df64(
            a, b64, tol=tol, rtol=rtol, maxiter=maxiter,
            preconditioner=preconditioner, iter_cap=cap,
            interpret=interpret)
        if res.status_enum().name == "BREAKDOWN":
            # consistent with the other resumable loops: keep the last
            # good checkpoint (the replay would deterministically
            # reproduce the breakdown anyway - the fault is the data's)
            return res
        done_k = int(res.iterations)
        _save_replay_ckpt(path, done_k, res.x_hi, res.x_lo, fingerprint)
        finished = bool(res.converged) or done_k >= maxiter
        # a stalled segment (iterations < cap without a finished status)
        # cannot happen: the kernel stops early only on convergence,
        # breakdown, or the cap itself - guard anyway so a logic bug
        # surfaces as an error, not an infinite loop
        if not finished and done_k < cap:
            raise RuntimeError(
                f"resident segment stopped at {done_k} < cap {cap} "
                f"without converging - this is a bug")
        if finished:
            if bool(res.converged) and not keep_checkpoint:
                _remove(path)
            return res
