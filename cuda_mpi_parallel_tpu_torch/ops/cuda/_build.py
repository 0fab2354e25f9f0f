"""Build the hand kernels of ``csrc/`` with ``nvcc`` at first use and
load them through ``ctypes``.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` into an object, all of
them at once, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds).  The
library is named after a hash of the sources and flags, so an edit
rebuilds, and lives in ``_build/`` beside the package (listed in
``.gitignore``).  A finished library is renamed into place atomically,
so concurrent first uses never load a half-written file.

Every C entry point of the kernel library returns a ``cudaError_t``;
:func:`check` raises on anything but success.  :data:`LAUNCHES` counts
the kernel launches of each wrapper (one per wrapper call that reached
the card).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches of each kernel wrapper since the last :func:`reset_launches`
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None
_build_info: dict = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "cmpt_stencil_f32": ([_P, _P, _P, _I64, _I64, _I64, _INT, _P], _INT),
    "cmpt_stencil_f64": ([_P, _P, _P, _I64, _I64, _I64, _INT, _P], _INT),
    "cmpt_tile_blocks": ([_I64, _I64, _I64, _INT], _I64),
    "cmpt_error_string": ([_INT], ctypes.c_char_p),
    "cmpt_cg_pass_a": ([_P] * 10 + [_I64] * 3 + [_INT] + [_P] * 3, _INT),
    "cmpt_march_blocks": ([_I64, _I64, _I64, _INT], _I64),
    "cmpt_cg_pass_b": ([_P] * 8 + [_I64] * 3 + [_INT, _INT] + [_P] * 3,
                       _INT),
    "cmpt_cg_pass_a_f64": ([_P] * 5 + [_I64] * 3 + [_INT] + [_P] * 3, _INT),
    "cmpt_cg_pass_b_f64": ([_P] * 5 + [_I64] * 3 + [_INT] + [_P] * 3, _INT),
    "cmpt_cheb_step": ([_P] * 9 + [_I64] * 3 + [_INT] * 3 + [_P] * 3, _INT),
    "cmpt_cg_resident": ([_P] * 15 + [_I64] * 3 + [_INT] * 5 + [_P], _INT),
    "cmpt_cg_resident_f64": ([_P] * 15 + [_I64] * 3 + [_INT] * 5 + [_P],
                             _INT),
    "cmpt_cg_resident_cg1": ([_P] * 16 + [_I64] * 3 + [_INT] * 4 + [_P],
                             _INT),
    "cmpt_cg_resident_blocks_per_sm": ([_INT] * 5, _INT),
    "cmpt_cg_resident_dist": ([_P] * 14 + [_I64] * 3 + [_INT] * 5 + [_P],
                              _INT),
    "cmpt_cg_resident_dist_blocks_per_sm": ([_INT] * 2, _INT),
    "cmpt_resident_dist_exchange_bytes": ([_I64, _INT, _INT], _I64),
    "cmpt_sliced_ell_spmv": ([_P] * 5 + [_I64, _P], _INT),
    "cmpt_sliced_ell_spmv_f64": ([_P] * 5 + [_I64, _P], _INT),
}


def reset_launches() -> None:
    LAUNCHES.clear()


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "/usr/local/cuda/bin): the hand kernels cannot be "
                       "built")


def _compile(lib_path: Path) -> str:
    """One nvcc per source, all started together, then one link.  Returns
    the compilers' report (ptxas's registers, stack and spills of every
    kernel, from ``-Xptxas -v``)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, report = [], []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"$ {' '.join(cmd)}\n{out}")
            report.append(out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _ in procs]]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                               f"{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return "".join(report)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has
    no library yet."""
    global _lib
    with _lock:
        if _lib is None:
            digest = source_hash()
            path = BUILD_DIR / f"libcmpt_{digest}.so"
            seconds, report = 0.0, ""
            if not path.exists():
                t0 = time.perf_counter()
                report = _compile(path)
                seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _build_info.update(hash=digest, path=str(path),
                               nvcc_seconds=seconds, ptxas=report)
            _lib = lib
    return _lib


def build_info() -> dict:
    """Source hash, library path, the seconds nvcc took in this process
    (0.0 when the library was already built) and ptxas's report of that
    build ("" when there was none)."""
    library()
    return dict(_build_info)


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().cmpt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def grid_dims(shape) -> tuple:
    """(n0, n1, n2, three_d) of the kernels' tile walk: a 2D grid
    (nx, ny) is walked as (nx, 1, ny)."""
    if len(shape) == 2:
        return shape[0], 1, shape[1], 0
    if len(shape) == 3:
        return shape[0], shape[1], shape[2], 1
    raise ValueError(f"expected a 2D or 3D grid, got shape {tuple(shape)}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def device_scalar(value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``dtype`` (default ``like.dtype``) on
    ``like``'s device - what a kernel reads through a pointer.  A tensor
    already there is returned as is, so no host sync is added."""
    dtype = like.dtype if dtype is None else dtype
    if isinstance(value, torch.Tensor):
        if value.numel() != 1:
            raise ValueError(f"expected a scalar, got shape "
                             f"{tuple(value.shape)}")
        return value.to(device=like.device, dtype=dtype).reshape(())
    return torch.full((), float(value), dtype=dtype, device=like.device)
