"""The port stands alone: it imports neither JAX nor the JAX package, and
it never runs on the host unless asked to.

* a fresh interpreter imports the port and finds no ``jax`` and no
  ``cuda_mpi_parallel_tpu`` module (other than the port's own) loaded;
* the sources of the port and of ``chip_smoke.py`` name neither;
* without a CUDA device, an operator built without ``device`` raises
  instead of falling back to the CPU;
* every kernel wrapper raises on a CUDA tensor when there is no card,
  instead of running its plain twin - B1-B5 (B3/B4 with halos too), the
  resident solve (B10, with and without its Chebyshev degree, and its
  cg1 kernel), the distributed resident solve (B12) and the sliced-ELL
  SpMV (B8) alike; so does a mesh or distributed operator built without
  a device.
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import cuda_mpi_parallel_tpu_torch as pt
from cuda_mpi_parallel_tpu_torch import parallel as tpar
from cuda_mpi_parallel_tpu_torch.models import mmio, poisson
from cuda_mpi_parallel_tpu_torch.ops import cuda as hk

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "cuda_mpi_parallel_tpu_torch"
# an import of jax/jaxlib or of the JAX package (its name where "_torch"
# does not follow it), as a statement or through importlib/__import__
_MOD = r"(jax|jaxlib|cuda_mpi_parallel_tpu(?!_torch))\b"
IMPORTS = re.compile(
    rf"^\s*(import|from)\s+{_MOD}"
    rf"|(import_module|__import__)\(\s*['\"]{_MOD}", re.M)


def test_fresh_import_loads_no_jax():
    code = (
        "import sys, re\n"
        "import cuda_mpi_parallel_tpu_torch\n"
        "import cuda_mpi_parallel_tpu_torch.convert\n"
        "pat = re.compile(r'cuda_mpi_parallel_tpu(?!_torch)')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or pat.match(m))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _sources():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) \
        + sorted(PORT.rglob("*.cuh")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_the_jax_package(path):
    assert [m.group(0) for m in IMPORTS.finditer(path.read_text())] == []


def test_the_import_scan_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "import jaxlib",
           "from cuda_mpi_parallel_tpu.models import poisson",
           "  import cuda_mpi_parallel_tpu",
           "importlib.import_module('cuda_mpi_parallel_tpu.ops')",
           "__import__(\"jax\")"]
    good = ["import cuda_mpi_parallel_tpu_torch",
            "from cuda_mpi_parallel_tpu_torch.ops import cuda",
            "# the JAX package cuda_mpi_parallel_tpu/ops/pallas/stencil.py",
            "import jaxtyping_like_name_is_not_jax"]
    assert all(IMPORTS.search(line) for line in bad)
    assert not any(IMPORTS.search(line) for line in good)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", [
    lambda: pt.Stencil3D.create(8, 8, 128),
    lambda: pt.Stencil2D.create(16, 128, device="cuda"),
    lambda: poisson.poisson_3d_operator(8, 8, 128, backend="pallas"),
    lambda: poisson.oracle_system(),
    lambda: pt.CSRMatrix.from_arrays(np.ones(1), [0], [0, 1]),
    lambda: mmio.load_matrix_market(
        str(ROOT / "tests" / "fixtures" / "skewed_spd_240.mtx")),
    lambda: pt.solve(np.eye(2), np.ones(2)),
    lambda: tpar.make_mesh(),
    lambda: tpar.DistStencil2D.create((16, 128), 2),
    lambda: tpar.solve_distributed(pt.Stencil2D.create(16, 128,
                                                       device="cpu"),
                                   np.ones(16 * 128))])
def test_no_device_means_cuda_not_cpu(no_cuda, build):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def _cuda_grid(shape):
    with FakeTensorMode():
        return torch.zeros(shape, device="cuda")


@pytest.mark.parametrize("name", ["stencil2d_apply", "stencil3d_apply",
                                  "fused_cg_pass_a", "fused_cg_pass_b",
                                  "cg_resident", "shift_ell_matvec",
                                  "fused_cheb_step", "cg_resident_degree",
                                  "cg_resident_cg1", "cg_resident_dist",
                                  "cg_resident_dist_degree",
                                  "fused_cg_pass_a_halos",
                                  "fused_cg_pass_b_halos"])
def test_wrappers_refuse_cuda_tensors_without_a_card(no_cuda, name):
    hk.reset_launches()
    if name == "cg_resident":
        call = lambda: hk.cg_resident_2d(1.0, _cuda_grid((16, 128)),
                                         maxiter=4)
    elif name == "cg_resident_cg1":
        call = lambda: hk.cg_resident_3d(1.0, _cuda_grid((4, 8, 128)),
                                         maxiter=4, method="cg1")
    elif name == "cg_resident_degree":
        call = lambda: hk.cg_resident_3d(1.0, _cuda_grid((4, 8, 128)),
                                         maxiter=4, precond_degree=4,
                                         lmin=0.4, lmax=12.0)
    elif name == "cg_resident_dist":
        call = lambda: hk.cg_resident_dist(1.0, _cuda_grid((4, 4, 128)),
                                           maxiter=4)
    elif name == "cg_resident_dist_degree":
        call = lambda: hk.cg_resident_dist(1.0, _cuda_grid((2, 2, 8, 128)),
                                           maxiter=4, degree=2, lmin=0.4,
                                           lmax=12.0)
    elif name == "fused_cg_pass_a_halos":
        plane = (1, 8, 128)
        call = lambda: hk.fused_cg_pass_a(
            1.0, 0.0, _cuda_grid((4, 8, 128)), _cuda_grid((4, 8, 128)),
            tuple(_cuda_grid(plane) for _ in range(4)))
    elif name == "fused_cg_pass_b_halos":
        call = lambda: hk.fused_cg_pass_b(
            1.0, 0.5, _cuda_grid((16, 128)), _cuda_grid((16, 128)),
            _cuda_grid((16, 128)), (_cuda_grid((1, 128)),
                                    _cuda_grid((1, 128))))
    elif name == "fused_cheb_step":
        call = lambda: hk.fused_cheb_step(
            1.0, 2.0, 0.5, 0.25, _cuda_grid((8, 8, 128)),
            _cuda_grid((8, 8, 128)), _cuda_grid((8, 8, 128)), first=False,
            last=True)
    elif name == "shift_ell_matvec":
        packed = hk.pack_sliced_ell(np.arange(65), np.arange(64),
                                    np.ones(64, np.float32), 64)
        call = lambda: hk.shift_ell_matvec(
            _cuda_grid((64,)), *(torch.as_tensor(a) for a in packed[:3]),
            64)
    elif name == "stencil2d_apply":
        call = lambda: hk.stencil2d_apply(_cuda_grid((16, 128)), 1.0)
    elif name == "stencil3d_apply":
        call = lambda: hk.stencil3d_apply(_cuda_grid((8, 8, 128)), 1.0)
    elif name == "fused_cg_pass_a":
        call = lambda: hk.fused_cg_pass_a(
            1.0, 0.0, _cuda_grid((8, 8, 128)), _cuda_grid((8, 8, 128)))
    else:
        call = lambda: hk.fused_cg_pass_b(
            1.0, 0.5, _cuda_grid((16, 128)), _cuda_grid((16, 128)),
            _cuda_grid((16, 128)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert sum(hk.LAUNCHES.values()) == 0


def test_explicit_cpu_runs_on_the_host():
    op = pt.Stencil3D.create(4, 8, 128, device="cpu")
    assert op.device == torch.device("cpu")
    res = pt.solve(op, torch.ones(op.n), rtol=1e-4)
    assert res.x.device.type == "cpu" and bool(res.converged)
