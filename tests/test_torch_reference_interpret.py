"""The JAX reference's Pallas TPU-interpret state, set up once in every
test process.

The port's tests hold it against the JAX package, whose distributed
kernels run on the CPU in Pallas TPU-interpret mode.  That mode keeps
its race-detector state (``interpret_pallas_call.races``) in a module
global that stays ``None`` until the first interpreted kernel of the
process has run, and ``analysis.runtime.check_races`` reads that state
after calling its kernel.  A check whose own kernel runs no interpreted
Pallas call (``tests/test_analysis_runtime.py``'s
``test_unconfirmable_detection_warns``) then finds ``None`` whenever it
is the first in its process, and under ``pytest -n N --dist loadfile``
which files a worker ran before it depends on how the files were spread
over the workers.  This module runs one small interpreted kernel while
it is imported: every worker imports every test module while it
collects, before any test runs, so the state is there in every process,
however the files are spread.  Run on its own, that test file still
meets the ``None`` state.
"""
import numpy as np
import pytest

from cuda_mpi_parallel_tpu.analysis.runtime import (
    RaceDetectorUnavailable,
    _detector_module,
)


def _interpret_once():
    """One (8, 128) ``x + 1`` kernel in TPU-interpret mode; returns its
    output as numpy, or None where this jax has no TPU interpreter."""
    try:
        _detector_module()
    except RaceDetectorUnavailable:
        return None
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    y = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=pltpu.InterpretParams())(
            jnp.arange(8 * 128, dtype=jnp.float32).reshape(8, 128))
    return np.asarray(jax.block_until_ready(y))


_SEED_OUT = _interpret_once()


def test_interpret_state_present():
    if _SEED_OUT is None:
        pytest.skip("this jax build has no Pallas TPU interpreter")
    assert _detector_module().races is not None


def test_interpret_kernel_output():
    if _SEED_OUT is None:
        pytest.skip("this jax build has no Pallas TPU interpreter")
    want = np.arange(8 * 128, dtype=np.float32).reshape(8, 128) + 1.0
    np.testing.assert_array_equal(_SEED_OUT, want)
