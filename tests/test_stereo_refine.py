"""StereoRefine streaming framework: state machine + accuracy over a stream.

Synthetic rig: fixed stereo pose, per-frame correspondences with noise and
outliers. Checks the reference's behavioral contract (SURVEY.md §3.4):
init -> aggregate -> refine improves accuracy over single frames; bad
frames are skipped with the old pose restored; a persistent pose change
triggers reinitialization; pose stability is detected.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import random_pose
from matchinglib_poselib_tpu.config import (
    PoseConfig, RobustConfig, StereoRefineConfig,
)
from matchinglib_poselib_tpu.models.stereo_refine import StereoRefine
from matchinglib_poselib_tpu.ops import geometry as geo, pool as poolops


K_CAM = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])


def make_cfg(pool_cap=1024):
    return StereoRefineConfig(
        max_pool_correspondences=pool_cap,
        pose=PoseConfig(
            robust=RobustConfig(
                batch_hypotheses=128, max_batches=3, check_degeneracy=False
            )
        ),
    )


def gen_frame(rng, R, t, n=256, noise_px=0.4, outlier_frac=0.15):
    """One frame of pixel correspondences for the rig pose (R, t)."""
    X = np.stack(
        [
            rng.uniform(-2.0, 2.0, n),
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(4.0, 12.0, n),
        ],
        axis=1,
    )
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:3]
    p1 = x1 @ K_CAM[:2, :2].T + K_CAM[:2, 2]
    p2 = x2 @ K_CAM[:2, :2].T + K_CAM[:2, 2]
    p1 += rng.normal(scale=noise_px, size=p1.shape)
    p2 += rng.normal(scale=noise_px, size=p2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        p2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return p1.astype(np.float32), p2.astype(np.float32)


def pose_err(sr, R, t):
    rdiff, tang, _ = geo.compare_poses(
        jnp.asarray(R, jnp.float32),
        jnp.asarray(t / np.linalg.norm(t), jnp.float32),
        jnp.asarray(sr.R, jnp.float32), jnp.asarray(sr.t, jnp.float32),
    )
    return float(rdiff), float(tang)


class TestStreaming:
    def test_init_then_refine_improves(self, rng):
        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())

        res = sr.add_new_correspondences(*gen_frame(rng, R, t))
        assert res.state == "init"
        r0, t0 = pose_err(sr, R, t)

        errs = []
        for _ in range(8):
            res = sr.add_new_correspondences(*gen_frame(rng, R, t))
            assert res.state in ("refined", "robust")
            errs.append(pose_err(sr, R, t))
        r_end, t_end = errs[-1]
        # aggregated pose must be accurate and at least as good as frame 1
        assert r_end < max(r0, 0.2)
        assert t_end < max(t0, 1.0)
        assert r_end < 0.2, f"rot err {r_end}"
        assert t_end < 1.0, f"t ang err {t_end}"
        assert res.pool_size > 400

    def test_bad_frames_are_skipped(self, rng):
        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        sr.add_new_correspondences(*gen_frame(rng, R, t))
        for _ in range(3):
            sr.add_new_correspondences(*gen_frame(rng, R, t))
        R_before = sr.R.copy()
        t_before = sr.t.copy()

        # pure-garbage frame: random correspondences
        p1 = rng.uniform([0, 0], [640, 480], size=(256, 2)).astype(np.float32)
        p2 = rng.uniform([0, 0], [640, 480], size=(256, 2)).astype(np.float32)
        res = sr.add_new_correspondences(p1, p2)
        assert res.state == "skipped"
        assert res.skip_count == 1
        np.testing.assert_allclose(sr.R, R_before)
        np.testing.assert_allclose(sr.t, t_before)

        # good frame afterwards resets the skip counter
        res = sr.add_new_correspondences(*gen_frame(rng, R, t))
        assert res.state in ("refined", "robust")
        assert res.skip_count == 0

    def test_too_many_skips_reinitializes(self, rng):
        R, t = random_pose(rng, max_angle_deg=10.0)
        cfg = StereoRefineConfig(
            max_pool_correspondences=1024,
            max_skip_pairs=2,
            pose=PoseConfig(
                robust=RobustConfig(
                    batch_hypotheses=128, max_batches=3,
                    check_degeneracy=False,
                )
            ),
        )
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg)
        sr.add_new_correspondences(*gen_frame(rng, R, t))
        sr.max_skip_pairs_new = 2  # no stability escalation yet

        last = None
        for _ in range(6):
            p1 = rng.uniform([0, 0], [640, 480], size=(256, 2)).astype(
                np.float32
            )
            p2 = rng.uniform([0, 0], [640, 480], size=(256, 2)).astype(
                np.float32
            )
            last = sr.add_new_correspondences(p1, p2)
            if last.state == "reinit":
                break
        assert last.state == "reinit"
        assert sr.nr_estimation == 0  # back to uninitialized

    def test_pose_change_triggers_reinit(self, rng):
        R, t = random_pose(rng, max_angle_deg=8.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        sr.add_new_correspondences(*gen_frame(rng, R, t))
        for _ in range(3):
            sr.add_new_correspondences(*gen_frame(rng, R, t))

        # the rig physically moves: clearly different pose, good frames
        R2, t2 = random_pose(rng, max_angle_deg=25.0)
        while np.degrees(
            np.arccos(np.clip((np.trace(R.T @ R2) - 1) / 2, -1, 1))
        ) < 10.0:
            R2, t2 = random_pose(rng, max_angle_deg=25.0)

        states = []
        for _ in range(3):
            res = sr.add_new_correspondences(
                *gen_frame(rng, R2, t2, noise_px=0.2, outlier_frac=0.05)
            )
            states.append(res.state)
            if res.state == "reinit":
                break
        assert "reinit" in states, f"states: {states}"
        r_err, t_err = pose_err(sr, R2, t2)
        assert r_err < 0.5
        assert t_err < 2.0

    def test_stability_detection(self, rng):
        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        # the reference gates stability on >= 1000 pool correspondences
        # (checkPoseStability :3135); scale to this test's small stream
        sr.min_pool_size_stable = 300
        sr.add_new_correspondences(*gen_frame(rng, R, t, noise_px=0.2))
        res = None
        ever_stable = False
        for _ in range(12):
            res = sr.add_new_correspondences(
                *gen_frame(rng, R, t, noise_px=0.2)
            )
            ever_stable = ever_stable or res.pose_is_stable
        # rating-based stability flickers frame-to-frame on a short stream
        # (the +-absThRankingStable band is tight by design); it must be
        # detected during the stream and the most-likely pose must lock in
        assert ever_stable
        assert res.most_likely_pose_stable
        rdiff, _, _ = geo.compare_poses(
            jnp.asarray(R, jnp.float32),
            jnp.asarray(t / np.linalg.norm(t), jnp.float32),
            jnp.asarray(res.R_most_likely, jnp.float32),
            jnp.asarray(res.t_most_likely, jnp.float32),
        )
        assert float(rdiff) < 0.3

    def test_rejects_garbage_initialization(self, rng):
        sr = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        p1 = rng.uniform([0, 0], [640, 480], size=(256, 2)).astype(np.float32)
        p2 = rng.uniform([0, 0], [640, 480], size=(256, 2)).astype(np.float32)
        res = sr.add_new_correspondences(p1, p2)
        assert res.state == "rejected"
        assert sr.nr_estimation == 0


class TestPoolOps:
    def test_insert_and_evict_keeps_best(self, rng):
        pool = poolops.empty_pool(8)
        pts = rng.uniform(0, 100, size=(12, 2)).astype(np.float32)
        w = np.linspace(0.1, 1.2, 12).astype(np.float32)
        pool = poolops.insert_and_evict(
            pool,
            jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(pts) / 100,
            jnp.asarray(pts) / 100,
            jnp.zeros(12), jnp.zeros(12), jnp.zeros(12),
            jnp.asarray(w), jnp.ones(12, bool),
        )
        assert int(pool.n_valid) == 8
        # the 8 highest weights survive
        kept = np.sort(np.asarray(pool.weight)[np.asarray(pool.valid)])
        np.testing.assert_allclose(kept, np.sort(w)[-8:], rtol=1e-6)

    def test_filter_dedup_keeps_better(self, rng):
        pool = poolops.empty_pool(8)
        base = np.array([[10.0, 10.0], [50.0, 50.0]], np.float32)
        pool = poolops.insert_and_evict(
            pool,
            jnp.asarray(base), jnp.asarray(base), jnp.asarray(base) / 100,
            jnp.asarray(base) / 100,
            jnp.zeros(2), jnp.zeros(2), jnp.zeros(2),
            jnp.asarray([0.5, 0.9], jnp.float32), jnp.ones(2, bool),
        )
        # new points: one decisively better than slot0 (same point), one
        # decisively worse than slot1 (compareCorrespondences :2450)
        new_pts = np.array([[10.5, 10.2], [50.2, 49.9]], np.float32)
        new_w = jnp.asarray([0.8, 0.3], jnp.float32)
        new_valid, pool_valid, n_found = poolops.filter_new_vs_pool(
            pool, jnp.asarray(new_pts), jnp.asarray(new_pts), new_w,
            jnp.ones(2, bool), 3.0,
        )
        nv = np.asarray(new_valid)
        assert nv[0] and not nv[1]  # better new kept, worse new dropped
        # the displaced old entry was invalidated
        assert int(jnp.sum(pool_valid)) == int(pool.n_valid) - 1

    def test_filter_coincident_bumps_nrfound(self, rng):
        """A re-detected correspondence (identical endpoints) bumps the
        pool entry's nrFound and the new copy is dropped (:2163-2169)."""
        pool = poolops.empty_pool(4)
        base = np.array([[10.0, 10.0]], np.float32)
        pool = poolops.insert_and_evict(
            pool,
            jnp.asarray(base), jnp.asarray(base), jnp.asarray(base) / 100,
            jnp.asarray(base) / 100,
            jnp.zeros(1), jnp.zeros(1), jnp.zeros(1),
            jnp.asarray([0.5], jnp.float32), jnp.ones(1, bool),
        )
        new_valid, pool_valid, n_found = poolops.filter_new_vs_pool(
            pool, jnp.asarray(base), jnp.asarray(base),
            jnp.asarray([0.9], jnp.float32), jnp.ones(1, bool), 3.0,
        )
        assert not bool(new_valid[0])
        assert int(jnp.sum(pool_valid)) == 1
        assert int(n_found[np.asarray(pool.valid)].max()) == 2

    def test_update_pool_state_tracks_q_and_history(self):
        """update_pool_state triangulates Q, flags far points, and pushes
        onto the Sampson-error history (CoordinateProps :55-62)."""
        R = np.eye(3, dtype=np.float32)
        t = np.array([-1.0, 0, 0], np.float32)  # baseline along -x
        # two near points (z=5) and one far (z=200 > maxDist3DPtsZ=50)
        X = np.array([[0.5, 0.2, 5.0], [-0.5, 0.1, 6.0], [0.3, 0.0, 200.0]],
                     np.float32)
        x1 = X[:, :2] / X[:, 2:]
        X2 = X @ R.T + t
        x2 = X2[:, :2] / X2[:, 2:]
        E = geo.essential_from_rt(jnp.asarray(R), jnp.asarray(t))
        pool = poolops.empty_pool(3)
        pool = pool._replace(
            x1=jnp.asarray(x1), x2=jnp.asarray(x2), valid=jnp.ones(3, bool),
        )
        pool = poolops.update_pool_state(
            pool, E, jnp.asarray(R), jnp.asarray(t),
            jnp.asarray(1e-4), jnp.asarray(50.0),
        )
        q = np.asarray(pool.q)
        np.testing.assert_allclose(q[:, 2], X[:, 2], rtol=1e-3)
        far = np.asarray(pool.q_too_far)
        assert not far[0] and not far[1] and far[2]
        assert float(poolops.far_point_ratio(pool)) == pytest.approx(1 / 3)
        assert np.asarray(pool.sampson_count).tolist() == [1, 1, 1]
        # second update: history grows, age increments
        pool = poolops.update_pool_state(
            pool, E, jnp.asarray(R), jnp.asarray(t),
            jnp.asarray(1e-4), jnp.asarray(50.0),
        )
        assert np.asarray(pool.sampson_count).tolist() == [2, 2, 2]
        assert np.asarray(pool.age).tolist() == [2, 2, 2]
        assert np.asarray(pool.mean_sampson).max() < 1e-6

    def test_evict_outliers(self):
        pool = poolops.empty_pool(4)
        x1 = np.array([[0.1, 0.1], [0.2, -0.1], [0.0, 0.3], [0.5, 0.5]],
                      np.float32)
        R = np.eye(3)
        t = np.array([1.0, 0, 0])
        E = np.asarray(geo.essential_from_rt(
            jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32)))
        # consistent x2 (pure horizontal shift) except the last (vertical)
        x2 = x1 + np.array([[0.05, 0]] * 3 + [[0.0, 0.2]], np.float32)
        pool = pool._replace(
            x1=jnp.asarray(x1), x2=jnp.asarray(x2),
            valid=jnp.ones(4, bool),
        )
        out = poolops.evict_outliers(pool, jnp.asarray(E), jnp.asarray(1e-6))
        v = np.asarray(out.valid)
        assert v[:3].all() and not v[3]


class TestConfigBehaviors:
    """Round-2 parity behaviors (ConfigPoseEstimation,
    stereo_pose_refinement.h:100-178)."""

    def test_few_matches_switches_to_ransac(self, rng):
        """useRANSAC_fewMatches (:1295-1323): sparse frames use plain
        RANSAC for that estimation only."""
        import dataclasses
        from matchinglib_poselib_tpu.config import PoseEstimator

        cfg = dataclasses.replace(make_cfg(), use_ransac_few_matches=True)
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg)
        rc_small = sr._robust_cfg(80)
        rc_large = sr._robust_cfg(400)
        assert rc_small.estimator == PoseEstimator.RANSAC
        assert not rc_small.prosac
        assert rc_large.estimator == cfg.pose.robust.estimator
        # disabled flag: no switch
        sr2 = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        assert sr2._robust_cfg(80).estimator == cfg.pose.robust.estimator

        # end-to-end: a sparse but clean frame still initializes
        R, t = random_pose(rng, max_angle_deg=10.0)
        res = sr.add_new_correspondences(
            *gen_frame(rng, R, t, n=80, outlier_frac=0.1)
        )
        assert res.state == "init"
        r_err, t_err = pose_err(sr, R, t)
        assert r_err < 2.0 and t_err < 8.0

    def test_raise_skip_cnt_escalation(self):
        """updateMaxSkipPairs (:3300-3316): raiseSkipCnt packs the factor
        (low nibble) and the required consecutive stable poses (high
        nibble + 1)."""
        import dataclasses

        # factor 2 (=> 5 * 1.5 -> 8), need 3 consecutive stable poses
        cfg = dataclasses.replace(
            make_cfg(), raise_skip_cnt=(2 << 4) | 2, max_skip_pairs=5
        )
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg)
        sr.nr_consec_stable = 2  # not enough yet (need (2)+1 = 3)
        sr._update_max_skip_pairs()
        assert sr.max_skip_pairs_new == 5
        sr.nr_consec_stable = 3
        sr._update_max_skip_pairs()
        assert sr.max_skip_pairs_new == int(np.ceil(5 * 1.5))
        # raise_skip_cnt = 0 never escalates
        sr2 = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        sr2.nr_consec_stable = 10
        sr2._update_max_skip_pairs()
        assert sr2.max_skip_pairs_new == sr2.cfg.max_skip_pairs

    def test_kneip_instead_ba(self, rng):
        """kneipInsteadBA (:1593-1695): the eigensolver replaces BA on the
        per-frame path and keeps accuracy."""
        import dataclasses

        cfg = dataclasses.replace(make_cfg(), kneip_instead_ba=True)
        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg)
        res = sr.add_new_correspondences(*gen_frame(rng, R, t))
        assert res.state == "init"
        r_err, t_err = pose_err(sr, R, t)
        assert r_err < 0.5 and t_err < 2.0

    def test_pool_path_configs(self, rng):
        """refineMethod_CorrPool / BART_CorrPool (:155-158): the pool path
        runs with its own refinement/BA configuration."""
        import dataclasses
        from matchinglib_poselib_tpu.config import (
            BAConfig, MinimalSolver, RefinementConfig,
        )

        cfg = dataclasses.replace(
            make_cfg(),
            refine_pool=RefinementConfig(solver=MinimalSolver.EIGHT_PT,
                                         iterations=6),
            ba_pool=BAConfig(enabled=True, iterations=8),
            kneip_instead_ba_pool=False,
        )
        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg)
        sr.add_new_correspondences(*gen_frame(rng, R, t))
        for _ in range(4):
            res = sr.add_new_correspondences(*gen_frame(rng, R, t))
            assert res.state in ("refined", "robust")
        r_err, t_err = pose_err(sr, R, t)
        assert r_err < 0.3 and t_err < 1.5

    def test_far_points_excluded_from_ba(self, rng):
        """maxDist3DPtsZ (:177-178): frames dominated by very far points
        must not destabilize the BA-refined pose."""
        import dataclasses
        from matchinglib_poselib_tpu.config import BAConfig

        cfg = dataclasses.replace(
            make_cfg(), ba_pool=BAConfig(enabled=True, iterations=8),
            max_dist_3d_pts_z=50.0,
        )
        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg)

        def far_frame(n=256):
            # half near (z 4-12), half very far (z 300-900 baselines)
            z = np.concatenate([
                rng.uniform(4.0, 12.0, n // 2),
                rng.uniform(300.0, 900.0, n - n // 2),
            ])
            X = np.stack([
                rng.uniform(-2.0, 2.0, n) * z / 8.0,
                rng.uniform(-1.5, 1.5, n) * z / 8.0,
                z,
            ], axis=1)
            x1 = X[:, :2] / X[:, 2:3]
            X2 = X @ R.T + t
            x2 = X2[:, :2] / X2[:, 2:3]
            p1 = x1 @ K_CAM[:2, :2].T + K_CAM[:2, 2]
            p2 = x2 @ K_CAM[:2, :2].T + K_CAM[:2, 2]
            p1 += rng.normal(scale=0.3, size=p1.shape)
            p2 += rng.normal(scale=0.3, size=p2.shape)
            return p1.astype(np.float32), p2.astype(np.float32)

        sr.add_new_correspondences(*far_frame())
        for _ in range(4):
            res = sr.add_new_correspondences(*far_frame())
        assert np.isfinite(sr.R).all() and np.isfinite(sr.t).all()
        # far points are tracked in the pool and reported via the ratio
        assert float(poolops.far_point_ratio(sr.pool)) > 0.2
        r_err, t_err = pose_err(sr, R, t)
        assert r_err < 1.0, f"rot err {r_err}"

    def test_no_dead_config_fields(self):
        """Every StereoRefineConfig field must be consumed by the model or
        the shared app glue (round-1 verdict: zero parity theater)."""
        import dataclasses as dc
        import inspect
        from matchinglib_poselib_tpu import config as cfgmod
        from matchinglib_poselib_tpu.models import stereo_refine as srmod

        src = inspect.getsource(srmod)
        for f in dc.fields(cfgmod.StereoRefineConfig):
            assert f.name in src, f"config field never read: {f.name}"


class TestSprtHistory:
    def test_sprt_history_builds_and_prior_tightens_budget(self, rng):
        """SPRT delta/epsilon 20-frame static history (pose_estim.cpp:
        1754-1761,1809-1976): streaming fills the history, the derived
        epsilon prior matches the stream's inlier ratio, and feeding that
        prior into the robust engine stops the hypothesis loop earlier
        than the uninformed run."""
        import jax

        from matchinglib_poselib_tpu.ops import robust as rb

        R, t = random_pose(rng, max_angle_deg=10.0)
        sr = StereoRefine(K_CAM, K_CAM, cfg=make_cfg())
        for i in range(8):
            p1, p2 = gen_frame(rng, R, t)
            sr.add_new_correspondences(p1, p2)
        assert len(sr.sprt_history) >= 3
        prior = sr._sprt_prior()
        assert prior is not None
        # stream runs at ~0.8 inlier ratio; prior must reflect it
        assert 0.3 < prior < 0.95
        # the prior bounds the hypothesis budget: same problem, same
        # engine, fewer batches with the history prior
        p1, p2 = gen_frame(rng, R, t)
        x1 = jnp.asarray((p1 - K_CAM[:2, 2]) / np.diag(K_CAM)[:2],
                         jnp.float32)
        x2 = jnp.asarray((p2 - K_CAM[:2, 2]) / np.diag(K_CAM)[:2],
                         jnp.float32)
        mask = jnp.ones(len(p1), jnp.float32)
        cfg = RobustConfig(batch_hypotheses=32, max_batches=8,
                           confidence=0.9999, check_degeneracy=False)
        key = jax.random.PRNGKey(3)
        res_no, _ = rb.estimate_essential_robust(
            x1, x2, mask, mask, cfg, key, threshold_sq=sr.th_sq
        )
        res_pr, _ = rb.estimate_essential_robust(
            x1, x2, mask, mask, cfg, key, threshold_sq=sr.th_sq,
            prior_inlier_ratio=jnp.asarray(prior, jnp.float32),
        )
        assert int(res_pr.n_batches) <= int(res_no.n_batches)
        # full reinit clears the rig statistics
        sr.reset()
        assert sr.sprt_history == []


class TestFrameTracking:
    def test_tracking_follows_per_frame_jitter(self, rng):
        """track_frame_pose (extension beyond the reference): on a rig with real
        per-frame rotation jitter, the tracked pose follows each frame's
        own rotation better than the pool-mean pose, while the
        translation stays pool-stable (rotation-only stage 1 +
        margin-gated 5-DOF stage 2, models/stereo_refine.py)."""
        import dataclasses as dc

        R0, t0 = random_pose(rng, max_angle_deg=8.0)
        jit_frames = []
        for _ in range(10):
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            a = np.deg2rad(0.08)
            Kx = np.array([
                [0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0],
            ])
            Rj = (np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx) @ R0
            jit_frames.append(Rj)

        def run(track):
            srng = np.random.default_rng(123)
            cfg = dc.replace(make_cfg(), track_frame_pose=track)
            sr = StereoRefine(K_CAM, K_CAM, cfg=cfg, seed=5)
            errs = []
            for f, Rf in enumerate(jit_frames):
                res = sr.add_new_correspondences(
                    *gen_frame(srng, Rf, t0, noise_px=0.2, outlier_frac=0.1)
                )
                if f >= 3 and res.state == "refined":
                    rd, td, _ = geo.compare_poses(
                        jnp.asarray(Rf, jnp.float32),
                        jnp.asarray(t0 / np.linalg.norm(t0), jnp.float32),
                        jnp.asarray(sr.R, jnp.float32),
                        jnp.asarray(sr.t, jnp.float32),
                    )
                    errs.append((float(rd), float(td)))
            return np.asarray(errs)

        tracked = run(True)
        frozen = run(False)
        assert len(tracked) >= 4 and len(frozen) >= 4
        # rotation: tracking must follow the per-frame jitter at least as
        # well as the pool mean; translation must not degrade materially
        assert tracked[:, 0].mean() <= frozen[:, 0].mean() + 0.01, (
            tracked[:, 0].mean(), frozen[:, 0].mean(),
        )
        assert tracked[:, 1].mean() <= frozen[:, 1].mean() + 0.05
