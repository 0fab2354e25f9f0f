"""The port's public surface against the JAX package's.

A caller switches packages by changing the import (ROADMAP "Same
surface"), so for every public name the port defines - in the package
root, ``solver``, ``models`` (and its ``fem``/``mmio``/``multigrid``/
``poisson`` and ``random_spd`` modules), ``solver.minres``,
``solver.many``, ``solver.recycle``, ``ops`` (``blas1``,
``spmv``), ``parallel`` (and ``parallel.multihost``), ``telemetry`` (and its ``events``, ``flight``,
``health``, ``registry`` and ``session`` modules), ``utils``
(``logging``, ``timing``, ``checkpoint``, ``tune``), ``telemetry.cost``,
``telemetry.roofline``, ``telemetry.shardscope``, ``telemetry.memscope``,
``balance`` (and its ``nnz_split``, ``reorder`` and ``plan`` modules)
and ``robust`` (and ``robust.elastic``, ``inject``, ``recover``,
``validate``) - this compares
``inspect.signature`` with the JAX counterpart: the same parameters, in
the same order, of the same kind and with the same defaults (dtype
defaults by name; annotations are not compared, since they name each
framework's array type).  For a class, its constructor and every public
method or classmethod the JAX class also has.

Differences allowed without a record: a trailing ``device=None`` (the
device rule: operators take a device, ``None`` meaning the card; the
checkpoint loaders take one too).  Every other difference is listed in
``RECORDED`` with its reason, every name without a JAX counterpart in
``PORT_ONLY``, every name kept with the JAX signature that raises
because the port has no counterpart (orbax) in ``REFUSED``, and every
JAX name the port does not define in ``NO_COUNTERPART``; each
parametrized case is one name.
"""
import dataclasses
import importlib
import inspect

import numpy as np
import pytest

PORT = "cuda_mpi_parallel_tpu_torch"
JAX = "cuda_mpi_parallel_tpu"
SCOPES = ("", ".solver", ".solver.minres", ".solver.many",
          ".solver.recycle", ".models", ".models.fem",
          ".models.mmio", ".models.multigrid", ".models.poisson",
          ".models.random_spd", ".ops",
          ".ops.blas1", ".ops.spmv", ".parallel", ".parallel.multihost",
          ".telemetry",
          ".telemetry.events", ".telemetry.flight", ".telemetry.health",
          ".telemetry.registry", ".telemetry.session", ".utils.logging",
          ".utils.timing", ".utils.checkpoint", ".utils.tune", ".robust",
          ".robust.elastic", ".robust.inject", ".robust.recover",
          ".robust.validate", ".telemetry.cost", ".telemetry.roofline",
          ".telemetry.shardscope", ".telemetry.memscope", ".balance",
          ".balance.nnz_split", ".balance.reorder", ".balance.plan")

#: names whose JAX counterpart lives elsewhere than the port's module
ELSEWHERE = {"parallel.shard_map": f"{JAX}.utils.compat"}

#: differences kept on purpose, each with its reason (qualified name ->
#: reason); a recorded name must still exist and still differ
RECORDED = {
    "DF64CGResult": "the f64 lane computes in native float64: the result "
                    "carries the float64 solution (x64) and ||r||^2 "
                    "beside the JAX (hi, lo) fields",
    "DF64Checkpoint": "a native-float64 checkpoint carries its float64 "
                      "state (state64) beside the JAX (hi, lo) fields",
    "IdentityOperator": "the device rule: the operator records its device "
                        "(_device) as the port's operators do",
    "ShiftELLMatrix": "Hopper's sliced-ELL layout (vals, cols, slice_ptr) "
                      "replaces the TPU shift-ELL sheets (lane_idx, "
                      "chunk_blocks, h, kc, ...)",
    "ShiftELLDF64Matrix": "the same sliced-ELL layout in float64, in place "
                          "of the TPU's (hi, lo) sheets",
    "parallel.shard_map": "the port's entry points lay out the per-shard "
                          "tensors themselves, so in_specs/out_specs are "
                          "optional (accepted, not read)",
    "parallel.solve_distributed_resident": "interpret=True runs B12's plain "
                                           "twin, as the JAX package's "
                                           "interpret mode runs the Pallas "
                                           "kernel on the host",
    "parallel.DistShiftELLRing": "each ring step's slabs in Hopper's "
                                 "sliced-ELL layout (vals, cols, "
                                 "slice_ptr) in place of the TPU "
                                 "shift-ELL sheets (lane_idx, "
                                 "chunk_blocks)",
    "parallel.DistShiftELLDF64Ring": "the same sliced-ELL slabs in float64 "
                                     "(vals, diag) in place of the TPU's "
                                     "(hi, lo) sheets and diagonal planes",
    "PartitionPlan": "the planner's default model is an H100 table, so "
                     "scored_by defaults to reference-h100",
    "telemetry.memscope.matrix_bytes_per_shard": "shard_ids: which shards "
                                                 "one process packs "
                                                 "together (the ring "
                                                 "sliced-ELL bytes depend "
                                                 "on it)",
    "telemetry.memscope.footprint_for_partition": "shard_ids, as "
                                                  "matrix_bytes_per_shard",
    "telemetry.memscope.note_footprint": "shard_ids: the shards whose "
                                         "tensors measured_bytes covers "
                                         "(a process-group rank's one)",
    "telemetry.memscope.solve_peak_bytes": "runs the solve under a "
                                           "PeakRecord (a PyTorch solve "
                                           "has no jaxpr to walk)",
}

#: names kept with the JAX signature that raise ``NotImplementedError``
#: because the port has no counterpart, each with its reason and the
#: arguments of a call that must raise
REFUSED = {
    "utils.checkpoint.save_checkpoint_orbax": (
        "orbax is a JAX library with no PyTorch counterpart; the npz lane "
        "(save_checkpoint, whose format both packages read) is the port's",
        ("unused", None)),
    "utils.checkpoint.load_checkpoint_orbax": (
        "orbax is a JAX library with no PyTorch counterpart; the npz lane "
        "(load_checkpoint) is the port's", ("unused",)),
}

#: JAX public names the port has no counterpart of, each with its reason
NO_COUNTERPART = {
    "telemetry.cost.jaxpr_solve_cost": "walks a jaxpr, which a PyTorch "
                                       "solve does not have; the port "
                                       "records its collectives at the "
                                       "comm layer (trace_solve_cost)",
    "telemetry.memscope.jaxpr_peak_bytes": "walks a jaxpr; the port "
                                           "records a solve's peak with "
                                           "memscope.PeakRecord",
}

#: public names with no JAX counterpart, each with its reason
PORT_ONLY = {
    "ops.chebyshev": "one definition of the Chebyshev steps shared by the "
                     "matvec, B5 and the resident twins (the JAX package "
                     "computes them inside each kernel)",
    "parallel.Mesh": "the port's mesh (the JAX package uses "
                     "jax.sharding.Mesh)",
    "parallel.StackedComm": "the comm backend of P shards in one process "
                            "(the JAX package has XLA's collectives)",
    "parallel.ProcessGroupComm": "the torch.distributed comm backend",
    "parallel.AxisComm": "one axis of a 2-D mesh's comm (the JAX package "
                         "names mesh axes to XLA's collectives)",
    "telemetry.memscope.PeakRecord": "the liveness record of a solve's "
                                     "storages, the port's counterpart of "
                                     "the JAX jaxpr walk",
}


def _norm_default(value):
    """A default as comparable text: dtypes by name, arrays by value."""
    if value is inspect.Parameter.empty:
        return "<required>"
    name = getattr(value, "__name__", None)
    text = str(value)
    if text.startswith("torch.") or name in ("float32", "float64"):
        return text.rsplit(".", 1)[-1].replace("'>", "")
    if "float32" in text or "float64" in text:
        return "float64" if "64" in text else "float32"
    return repr(value)


def _params(sig):
    return [(p.name, p.kind, _norm_default(p.default))
            for p in sig.parameters.values()]


def _differences(port_obj, jax_obj):
    """Human-readable differences of two callables' signatures; a
    trailing ``device=None`` of the port's is not one."""
    try:
        ps, js = inspect.signature(port_obj), inspect.signature(jax_obj)
    except (TypeError, ValueError):
        return []
    pp, jj = _params(ps), _params(js)
    if pp and pp[-1][0] == "device" and pp[-1][2] == "None" \
            and not (jj and jj[-1][0] == "device"):
        pp = pp[:-1]
    return [] if pp == jj else [f"port {ps} != jax {js}"]


def _class_differences(port_cls, jax_cls):
    out = []
    if dataclasses.is_dataclass(port_cls) != dataclasses.is_dataclass(
            jax_cls) or dataclasses.is_dataclass(port_cls):
        out += [f"__init__: {d}" for d in _differences(port_cls, jax_cls)]
    for name, member in vars(port_cls).items():
        if name.startswith("_") or not hasattr(jax_cls, name):
            continue
        if isinstance(member, (classmethod, staticmethod)):
            member = member.__func__
        if not callable(member):
            continue
        jmember = inspect.getattr_static(jax_cls, name)
        if isinstance(jmember, (classmethod, staticmethod)):
            jmember = jmember.__func__
        if callable(jmember):
            out += [f"{name}: {d}" for d in _differences(member, jmember)]
    return out


def _public_names():
    seen, cases = set(), []
    for scope in SCOPES:
        mod = importlib.import_module(PORT + scope)
        names = getattr(mod, "__all__", None) or [
            n for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", "") == mod.__name__]
        for name in sorted(names):
            obj = getattr(mod, name)
            if inspect.ismodule(obj):
                if obj.__name__.startswith(PORT) \
                        and obj.__name__ not in seen:
                    seen.add(obj.__name__)
                    qual = obj.__name__[len(PORT) + 1:]
                    if qual in PORT_ONLY:
                        cases.append(qual)
                continue
            home = getattr(obj, "__module__", mod.__name__)
            qual = (scope[1:] + "." + name).lstrip(".")
            key = (home, name)
            if key in seen:
                continue
            seen.add(key)
            cases.append(qual)
    return cases


CASES = _public_names()


def _jax_counterpart(qual):
    scope, _, name = qual.rpartition(".")
    port_mod = importlib.import_module(
        PORT + ("." + scope if scope else ""))
    obj = getattr(port_mod, name)
    candidates = [ELSEWHERE.get(qual)]
    candidates.append(JAX + ("." + scope if scope else ""))
    home = getattr(obj, "__module__", "") or ""
    if home.startswith(PORT):
        candidates.append(JAX + home[len(PORT):])
    for mod_name in candidates:
        if not mod_name:
            continue
        try:
            jmod = importlib.import_module(mod_name)
        except ImportError:
            continue
        if hasattr(jmod, name):
            return obj, getattr(jmod, name)
    return obj, None


def test_the_cases_cover_the_port():
    assert len(CASES) > 80
    for qual in list(RECORDED) + list(PORT_ONLY) + list(REFUSED):
        assert qual in CASES, f"recorded name {qual} is not public"


@pytest.mark.parametrize("qual", sorted(REFUSED))
def test_refused_names_raise(qual):
    obj, jobj = _jax_counterpart(qual)
    assert jobj is not None and not _differences(obj, jobj)
    with pytest.raises(NotImplementedError, match="no PyTorch counterpart"):
        obj(*REFUSED[qual][1])


@pytest.mark.parametrize("qual", CASES)
def test_signature_matches_jax(qual):
    if qual in PORT_ONLY:
        scope, _, name = qual.rpartition(".")
        try:
            jax_has = "." in qual and importlib.util.find_spec(
                JAX + "." + qual) is not None
        except ModuleNotFoundError:     # a member of a module
            jax_has = hasattr(importlib.import_module(JAX + "." + scope),
                              name)
        if jax_has:
            pytest.fail(f"{qual} is recorded as port-only but the JAX "
                        f"package has it")
        return
    obj, jobj = _jax_counterpart(qual)
    assert jobj is not None, (
        f"{qual} has no JAX counterpart: port it under the JAX name or "
        f"record it in PORT_ONLY with its reason")
    if inspect.isclass(obj):
        diffs = _class_differences(obj, jobj)
    elif callable(obj):
        diffs = _differences(obj, jobj)
    elif type(obj).__module__.startswith(PORT):
        # an instance of a port class (the metrics REGISTRY): the JAX
        # counterpart is an instance of the class of that name
        diffs = ([] if type(obj).__name__ == type(jobj).__name__
                 else [f"{type(obj)} != {type(jobj)}"])
    else:
        diffs = [] if np.all(obj == jobj) else [f"{obj!r} != {jobj!r}"]
    if qual in RECORDED:
        assert diffs, f"{qual} is recorded as different but matches now"
    else:
        assert not diffs, "\n".join(diffs)


@pytest.mark.parametrize("qual", sorted(NO_COUNTERPART))
def test_names_without_counterpart(qual):
    scope, _, name = qual.rpartition(".")
    assert hasattr(importlib.import_module(JAX + "." + scope), name)
    assert not hasattr(importlib.import_module(PORT + "." + scope), name)


def _later_lane(case, package=PORT):
    """Call one lane that rides a later ROADMAP item (or, ported, the
    same call in either package)."""
    pt = importlib.import_module(package)
    tpar = importlib.import_module(package + ".parallel")
    poisson = importlib.import_module(package + ".models.poisson")
    solver = importlib.import_module(package + ".solver")
    cg_many, solve_many = solver.cg_many, solver.solve_many

    if package == PORT:
        a = poisson.poisson_2d_csr(8, 8, device="cpu")
        mesh = tpar.make_mesh(2, devices=["cpu"] * 2)
    else:
        a = poisson.poisson_2d_csr(8, 8)
        mesh = tpar.make_mesh(2)
    stack = np.ones((64, 2))
    if case == "solve_distributed_many(plan=)":
        return tpar.solve_distributed_many(a, stack, mesh=mesh, plan="auto")
    elif case == "solve_distributed_many(inject=)":
        tpar.solve_distributed_many(a, stack, mesh=mesh, inject=object())
    elif case == "solve_many(fault=)":
        solve_many(a, stack, fault=object())
    elif case == "cg_many(fault=)":
        cg_many(a, stack, fault=object())
    elif case == "solve(fault=)":
        pt.solve(a, np.ones(64), fault=object())
    elif case == "ManyRHSDispatcher.memory_footprint":
        return tpar.ManyRHSDispatcher(a, mesh=mesh).memory_footprint(
            n_rhs=2, hbm_bytes=None)


#: lanes of the ported names that ride later ROADMAP items, and the item
#: each one's refusal names.  The four A15 cases keep their ids: fault=
#: and inject= run since their port (tests/test_torch_robust.py), and an
#: object that is no FaultPlan raises what the JAX package raises for the
#: same call (the exception type named here).  The two cases marked
#: ``None`` keep their ids too: plan= and memory_footprint run since
#: their port (ROADMAP A10 residue and A16, tests/test_torch_balance.py
#: and tests/test_torch_memscope.py) and give the JAX call's result.
LATER_LANES = {
    "solve_distributed_many(plan=)": None,
    "solve_distributed_many(inject=)": TypeError,
    "solve_many(fault=)": AttributeError,
    "cg_many(fault=)": AttributeError,
    "solve(fault=)": AttributeError,
    "ManyRHSDispatcher.memory_footprint": None,
}


@pytest.mark.parametrize("case", sorted(LATER_LANES))
def test_later_lanes_raise_with_their_item(case):
    expected = LATER_LANES[case]
    if expected is None:
        ours, theirs = _later_lane(case), _later_lane(case, JAX)
        if case == "ManyRHSDispatcher.memory_footprint":
            assert ours.to_json() == theirs.to_json()
        else:
            assert np.asarray(ours.converged).all()
            assert np.array_equal(np.asarray(ours.iterations),
                                  np.asarray(theirs.iterations))
            np.testing.assert_allclose(ours.x.numpy(), np.asarray(theirs.x),
                                       rtol=0, atol=1e-5)
        return
    with pytest.raises(expected):
        _later_lane(case, JAX)
    with pytest.raises(expected):
        _later_lane(case)


@pytest.mark.parametrize("grid", [(16, 128), (8, 8, 128), (5, 3, 7)])
def test_column_stack_twin_is_k_single_twins(grid):
    """The column-stack stencil twin (the card's one-launch instance's
    plain version) equals k single-grid twins bit for bit."""
    import torch

    from cuda_mpi_parallel_tpu_torch.ops import cuda as hk

    xs = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (4,) + grid).astype(np.float32))
    scale = torch.tensor(0.37)
    if len(grid) == 2:
        batched = hk.stencil2d_apply_cols(xs, scale)
        singles = [hk.stencil2d_apply_plain(x, scale) for x in xs]
    else:
        batched = hk.stencil3d_apply_cols(xs, scale)
        singles = [hk.stencil3d_apply_plain(x, scale) for x in xs]
    for got, want in zip(batched, singles):
        assert torch.equal(got, want)
