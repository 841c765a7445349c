"""Test harness: force the CPU backend with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh; tests never touch
a GPU (tests_gpu/ holds the tier that does). Must run before jax is
imported anywhere.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# One fast representative test per module; `pytest -m smoke` must finish
# in <90 s so rounds can iterate (full suite stays the CI tier).
_SMOKE = {
    "test_autoth.py::test_autoth_tightens_loose_threshold",
    "test_ba.py::test_recovers_perturbed_pose",
    "test_checkpoint_profiling.py::test_stage_timer_taxonomy",
    "test_descriptors_ext.py::test_ring_descriptor_discriminates",
    "test_features.py::test_fast_detects_square_corners",
    "test_geometry.py::test_skew_and_essential",
    "test_homography_pose.py::test_decompose_recovers_pose",
    "test_matching.py::test_hamming_matrix_exact",
    "test_native_loader.py::test_pnm_roundtrip",
    "test_optflow.py::test_lk_recovers_large_shift",
    "test_pallas_knn.py::test_knn2_matches_xla_path",
    "test_parallel.py::test_mesh_axes",
    "test_rectify.py::test_rectifying_rotations_are_rotations",
    "test_refine.py::test_refine_improves_noisy_model",
    "test_robust.py::test_masked_padding",
    "test_scale_space.py::test_blob_detectors_find_blobs",
    "test_solvers.py::test_8pt",
    "test_stereo_refine.py::test_init_then_refine_improves",
    "test_subpix.py::test_recovers_known_subpixel_shift",
}


def pytest_collection_modifyitems(items):
    for item in items:
        rel = item.nodeid.split("/")[-1]
        # strip parametrization for membership so a "[param]" id still matches
        base = rel.split("[")[0]
        if base in _SMOKE:
            # nonlinear-diffusion params dominate the smoke budget; keep the
            # cheap scale-space params only
            if "test_blob_detectors" in base and (
                "KAZE" in rel or "AKAZE" in rel
            ):
                continue
            item.add_marker(pytest.mark.smoke)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_pose(rng, max_angle_deg=20.0):
    """Random (R, t) with bounded rotation and unit translation."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(2.0, max_angle_deg))
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    return R.astype(np.float64), t.astype(np.float64)


def synthetic_correspondences(rng, R, t, n, noise=0.0, outlier_frac=0.0,
                              depth_range=(4.0, 12.0)):
    """Project random 3D points into two views: cam1 = [I|0], cam2 = [R|t].

    Returns normalized image coords x1, x2 of shape (n, 2) float64.
    """
    X = np.stack(
        [
            rng.uniform(-2.0, 2.0, n),
            rng.uniform(-2.0, 2.0, n),
            rng.uniform(*depth_range, n),
        ],
        axis=1,
    )
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:3]
    if noise > 0:
        x1 = x1 + rng.normal(scale=noise, size=x1.shape)
        x2 = x2 + rng.normal(scale=noise, size=x2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        x2[idx] = rng.uniform(-0.6, 0.6, size=(n_out, 2))
    return x1, x2


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound accumulated XLA state across the suite.

    A single-invocation full run used to segfault inside XLA CPU
    compilation (backend_compile_and_load) after ~60-140 tests — an
    accumulated-compilation-state crash, not attributable to any single
    test (every module passes alone). Dropping compiled executables
    between modules keeps the in-process LLVM/XLA footprint bounded.
    """
    yield
    jax.clear_caches()
