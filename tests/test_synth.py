"""Seeded synthetic stereo scenes (utils/synth.py): ground truth and use.

The scenes stand in for KITTI frames wherever the pipeline must be checked
against a known pose (chip_smoke.py, bench.py), so their ground truth has
to hold: the images must be the projections of one scene through (K1, K2,
R, t), and the pipeline must recover that pose.
"""

import numpy as np

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import (
    DescriptorConfig, DetectorConfig, MatchingConfig, PoseConfig, RobustConfig,
)
from matchinglib_poselib_tpu.models import pipeline
from matchinglib_poselib_tpu.ops import geometry as geo
from matchinglib_poselib_tpu.utils import synth


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def test_threaded_render_is_repeatable():
    """Frames rendered on a thread pool (as chip_smoke.py renders them)
    are the frames of a sequential render, bit for bit."""
    import concurrent.futures

    rig = synth.make_rig(0, scale=0.5)
    seeds = [synth.frame_seed(0, i) for i in range(4)]
    seq = [synth.render(rig, s) for s in seeds]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        par = list(pool.map(lambda s: synth.render(rig, s), seeds * 2))
    for i, p in enumerate(par):
        np.testing.assert_array_equal(p.img1, seq[i % 4].img1)
        np.testing.assert_array_equal(p.img2, seq[i % 4].img2)


def test_ground_truth_is_consistent():
    """Scene points seen in view 1 land on their epipolar lines in view 2
    and look the same there; the same seed gives the same images."""
    p = synth.stereo_pair(3, scale=0.25)
    H, W = p.img1.shape
    assert (H, W) == (128, 348)
    assert p.img1.dtype == np.float32 and 0 <= p.img1.min() <= p.img1.max() <= 1
    rot = np.degrees(np.arccos((np.trace(p.R) - 1) / 2))
    assert 1.0 <= rot <= 3.0
    assert abs(np.linalg.norm(p.t) - synth.BASELINE_M) < 0.05

    rng = np.random.default_rng(0)
    ys, xs = rng.integers(2, H - 2, 3000), rng.integers(2, W - 2, 3000)
    pix1 = np.stack([xs, ys, np.ones_like(xs)]).astype(float)
    X = np.linalg.inv(p.K1) @ pix1 * p.depth1[ys, xs]
    X2 = p.R @ X + p.t[:, None]
    pix2 = p.K2 @ X2
    pix2 = pix2[:2] / pix2[2]
    # epipolar constraint in normalized coordinates, E = [t]x R
    x1 = np.linalg.inv(p.K1) @ pix1
    x2 = np.linalg.inv(p.K2) @ np.vstack([pix2, np.ones(len(xs))])
    E = _skew(p.t) @ p.R
    assert np.abs(np.sum(x2 * (E @ x1), axis=0)).max() < 1e-9
    # photo-consistency where the point is inside view 2 (occlusions and
    # cell edges make a minority differ)
    ok = (pix2[0] > 1) & (pix2[0] < W - 2) & (pix2[1] > 1) & (pix2[1] < H - 2)
    v2 = p.img2[np.round(pix2[1][ok]).astype(int),
                np.round(pix2[0][ok]).astype(int)]
    diff = np.abs(p.img1[ys[ok], xs[ok]] - v2)
    assert ok.mean() > 0.8 and np.median(diff) < 0.02

    q = synth.stereo_pair(3, scale=0.25)
    np.testing.assert_array_equal(q.img1, p.img1)
    np.testing.assert_array_equal(q.img2, p.img2)
    assert not np.array_equal(synth.stereo_pair(4, scale=0.25).img1, p.img1)


def test_frames_share_the_rig():
    a, b = synth.frames(2, seed=5, scale=0.25)
    for k in ("K1", "K2", "R", "t"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.img1, b.img1)


def test_pipeline_recovers_synth_pose():
    """FAST + ORB + GMbSOF + 5pt robust pose on a half-size pair."""
    p = synth.stereo_pair(0, scale=0.5)
    det = DetectorConfig(kind="FAST", max_keypoints=1024, fast_threshold=12.0)
    desc = DescriptorConfig(kind="ORB")
    match = MatchingConfig(matcher_name="GMBSOF")
    pose_cfg = PoseConfig(robust=RobustConfig(batch_hypotheses=96,
                                              max_batches=12))

    @jax.jit
    def step(a, b, K1, K2):
        corr = pipeline.get_correspondences(a, b, det, desc, match)
        d = jnp.zeros(5, jnp.float32)
        return pipeline.estimate_pose(
            corr.pts1, corr.pts2, corr.mask, corr.quality, K1, K2, d, d,
            pose_cfg, jax.random.PRNGKey(0),
        )

    res = step(jnp.asarray(p.img1), jnp.asarray(p.img2),
               jnp.asarray(p.K1, jnp.float32), jnp.asarray(p.K2, jnp.float32))
    rd, td, _ = geo.compare_poses(
        jnp.asarray(p.R, jnp.float32),
        jnp.asarray(p.t / np.linalg.norm(p.t), jnp.float32), res.R, res.t,
    )
    assert int(res.n_inliers) >= 300
    assert float(rd) < 1.0 and float(td) < 2.0, (float(rd), float(td))
