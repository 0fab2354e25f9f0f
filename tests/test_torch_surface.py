"""The port's public surface against the JAX package's.

A caller switches packages by changing the import (ROADMAP "Same
surface"), so for every public name the port defines - in the package
root, ``solver``, ``models`` (and its ``fem``/``mmio``/``poisson``
and ``random_spd`` modules), ``solver.minres``, ``ops`` (``blas1``,
``spmv``) and ``parallel`` - this compares
``inspect.signature`` with the JAX counterpart: the same parameters, in
the same order, of the same kind and with the same defaults (dtype
defaults by name; annotations are not compared, since they name each
framework's array type).  For a class, its constructor and every public
method or classmethod the JAX class also has.

Differences allowed without a record: a trailing ``device=None`` (the
device rule: operators take a device, ``None`` meaning the card).  Every
other difference is listed in ``RECORDED`` with its reason, and every
name without a JAX counterpart in ``PORT_ONLY``; each parametrized case
is one name.
"""
import dataclasses
import importlib
import inspect

import numpy as np
import pytest

PORT = "cuda_mpi_parallel_tpu_torch"
JAX = "cuda_mpi_parallel_tpu"
SCOPES = ("", ".solver", ".solver.minres", ".models", ".models.fem",
          ".models.mmio", ".models.poisson", ".models.random_spd", ".ops",
          ".ops.blas1", ".ops.spmv", ".parallel")

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
    "parallel.DistStencil3DPencil": "not ported yet (ROADMAP A10 residue: "
                                    "pencil meshes): a stub that raises",
    "parallel.DistShiftELLRing": "not ported yet (ROADMAP A10 residue: "
                                 "ring-shiftell on B8): a stub that raises",
    "parallel.DistShiftELLDF64Ring": "not ported yet (ROADMAP A10 residue: "
                                     "ring-shiftell on B9): a stub that "
                                     "raises",
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
    for qual in list(RECORDED) + list(PORT_ONLY):
        assert qual in CASES, f"recorded name {qual} is not public"


@pytest.mark.parametrize("qual", CASES)
def test_signature_matches_jax(qual):
    if qual in PORT_ONLY:
        if "." in qual and importlib.util.find_spec(
                JAX + "." + qual) is not None:
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
    else:
        diffs = [] if np.all(obj == jobj) else [f"{obj!r} != {jobj!r}"]
    if qual in RECORDED:
        assert diffs, f"{qual} is recorded as different but matches now"
    else:
        assert not diffs, "\n".join(diffs)
