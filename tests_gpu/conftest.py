"""GPU tier: compiled kernels and f32 solver numerics on a CUDA GPU.

The main suite (tests/) forces the CPU backend with 8 virtual devices and
runs the Pallas kernels in interpret mode; this tier compiles them for the
card and checks the solvers' f32 numerics there:

    python -m pytest tests_gpu -q -m gpu      # chip_smoke.py runs it too

Every test carries the ``gpu`` marker; the ``_require_gpu`` fixture skips
it when JAX's default device is not a GPU.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _require_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU")


@pytest.fixture
def rng():
    return np.random.default_rng(7)
