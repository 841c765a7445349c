"""Run tooling without a GPU: compile cache, peak table, chip_smoke phases.

chip_smoke.py and bench.py measure only on a GPU; what they decide before
touching one (which phases run, which peaks apply, where the compile
cache lives, refusing a CPU) is checked here, and the four-device phase is
rehearsed on four of the suite's virtual CPU devices.
"""

import jax
import pytest

import bench
import chip_smoke
from matchinglib_poselib_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own; the helper sets no directory of its own
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_is_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(compile_cache.DEFAULT_DIR)
    assert compile_cache.DEFAULT_DIR.parent == chip_smoke.REPO
    assert jax.config.jax_compilation_cache_dir == path


def test_peaks_table():
    h100 = bench.peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"bf16_flops": 989e12, "fp32_flops": 67e12,
                    "hbm_bytes": 3.35e12}
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no peak rates"):
            bench.peaks(kind)


@pytest.mark.parametrize(
    "argv,phases",
    [
        ([], ("compile", "pair", "batch", "stream", "kernels")),
        (["--seed", "3"], ("compile", "pair", "batch", "stream", "kernels")),
        (["--four"], ("four",)),
    ],
)
def test_chip_smoke_phase_selection(argv, phases):
    args, selected = chip_smoke.select_phases(argv)
    assert selected == phases
    assert args.four == ("--four" in argv)


def test_chip_smoke_refuses_cpu(capsys):
    """No GPU: non-zero exit before any phase, and no verdict line."""
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "phase" not in out


def test_pose_error_resolves_small_angles():
    import numpy as np

    a = np.deg2rad(1e-3)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([1.0, 1e-5, 0.0], np.float32)
    rot, tang = chip_smoke.pose_error(np.eye(3), [1.0, 0, 0], R, t)
    assert abs(rot - 1e-3) < 1e-4
    assert abs(tang - np.degrees(1e-5)) < 1e-5


@pytest.mark.parametrize(
    "n_a,n_b,rot,tang,tol,same",
    [(998, 998, 2.04e-3, 4.83e-3, "BATCH_TOL", True),
     (974, 975, 6e-4, 0.06, "BATCH_TOL", False),
     (980, 980, 0.0, 0.025, "BATCH_TOL", False),
     (996, 998, 4.4e-3, 1.5e-2, "FOUR_TOL", True),
     (980, 980, 0.0, 0.06, "FOUR_TOL", False)],
)
def test_same_result_tolerance(n_a, n_b, rot, tang, tol, same):
    tol = getattr(chip_smoke, tol)
    assert chip_smoke.same_result(n_a, n_b, rot, tang, tol) == same


def test_batch_phase_on_cpu():
    """The batch phase at reduced size: run_batch against the single-pair
    step, with bit-equal correspondences and inlier counts."""
    sizes = chip_smoke.Sizes(scale=0.5, keypoints=1024, batch_hypotheses=32,
                             max_batches=4, n_batch=2)
    smoke = chip_smoke.Smoke(0, ("batch",), sizes)
    smoke.run("batch")


def test_four_device_phase_on_cpu_mesh():
    """The --four phase on four virtual CPU devices at half scale."""
    sizes = chip_smoke.Sizes(scale=0.5, keypoints=1024, n_batch=4,
                             n_stream=4, knn_rows=1024, ba_points=256)
    assert len(jax.devices()) >= 4
    smoke = chip_smoke.Smoke(0, chip_smoke.FOUR_CARD_PHASES, sizes)
    smoke.run("four")
