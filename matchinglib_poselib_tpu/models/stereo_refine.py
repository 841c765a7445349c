"""Continuous stereo pose refinement: the streaming framework.

Batched re-design of poselib::StereoRefine (SURVEY.md P14, §3.4;
reference: poselib/source/stereo_pose_refinement.cpp, header
stereo_pose_refinement.h:100-178 ConfigPoseEstimation):

- per-frame flow of addNewCorrespondences (:416-952): undistort -> inlier
  check vs the last pose -> {robust re-estimation | pool refinement | skip |
  reinit} state machine driven by the reference's inlier-ratio thresholds
  (relInlRatThLast/relInlRatThNew/minInlierRatSkip/minInlierRatioReInit)
- correspondence pool with spatial dedup, weight eviction, outlier removal,
  triangulated 3D points with far-point flags, nrFound counters and
  per-correspondence Sampson-error history (ops/pool.py replaces the
  std::list + nanoflann KD-tree)
- ranking-based stability detection: robust center of gravity over the
  rotated-point history (getNearToMeanPose :2817-3117), ranking-band
  stability with the Sampson-error-range fallback (checkPoseStability
  :3131-3296) and most-likely-pose persistence
- skip-and-restore with raiseSkipCnt escalation (updateMaxSkipPairs :3300)
- RANSAC fallback for sparse frames (useRANSAC_fewMatches, :1295-1323)
- Kneip eigensolver instead of BA (kneipInsteadBA(_CorrPool), :1593-1695)
  with the reference's Stewenius+pseudo-Huber / BA failure fallbacks
- pool-path refinement/BA configured separately from the per-frame path
  (refineMethod_CorrPool / BART_CorrPool, :1767-1990), far 3D points
  excluded from BA (maxDist3DPtsZ)
- algorithmic failure recovery (SURVEY.md §5.3): restore-old-pose on bad
  pairs, full reinit after too many skips, pool-robust fallback,
  failed-refinement escalation, BA restore guards

Design split: the branchy per-frame decision logic runs on host over a
handful of scalars (one device->host sync per frame); every heavy
computation — Sampson scoring over the pool, robust hypothesis batches,
IRLS refinement, BA, dedup distance matrices, eviction sorts — is a jitted
fixed-shape device program compiled once and reused for every frame.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import (
    PoseEstimator,
    StereoRefineConfig,
)
from matchinglib_poselib_tpu.ops import ba, eigensolver, geometry as geo
from matchinglib_poselib_tpu.ops import pool as poolops
from matchinglib_poselib_tpu.ops import refine, robust

# Minimum matches below which useRANSAC_fewMatches switches the estimator
# (stereo_pose_refinement.cpp:1295 uses points1newMat.rows < 100; the
# header comment :133 says 150 — the code wins)
FEW_MATCHES_THRESHOLD = 100
# Minimum pool occupancy before stability can be evaluated
# (checkPoseStability :3135 minPoolSizeToBeStable)
MIN_POOL_SIZE_STABLE = 1000


class FrameResult(NamedTuple):
    """Per-frame output (the reference returns these via getters)."""

    state: str  # init | refined | robust | reinit | skipped | rejected
    R: np.ndarray  # (3, 3) current pose estimate
    t: np.ndarray  # (3,) unit translation
    E: np.ndarray  # (3, 3)
    inlier_ratio: float  # inlier ratio of the new frame vs the pose
    pool_size: int
    pose_is_stable: bool
    most_likely_pose_stable: bool
    R_most_likely: np.ndarray
    t_most_likely: np.ndarray
    skip_count: int


# ---------------------------------------------------------------------------
# jitted device steps (compiled once per static shape/config)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("robust_cfg", "refine_cfg", "ba_cfg", "kneip_iba"),
)
def _pose_from_set(
    x1, x2, mask, quality, th_sq, robust_cfg, refine_cfg, ba_cfg,
    kneip_iba, max_dist_z, key, sprt_prior=None,
):
    """Robust E + refinement + pose recovery (+ Kneip-instead-BA / BA) on
    one (padded) correspondence set.

    Mirrors robustPoseEstimation (stereo_pose_refinement.cpp:1272-1736):
    robust engine -> optional linear refinement -> recoverPose -> either
    Kneip's eigensolver as the BA substitute (:1593-1650, falling back to
    BA / weighted Stewenius on failure :1651-1695) or BA (:1697-1724),
    with far 3D points (z > maxDist3DPtsZ) excluded from BA.

    sprt_prior: optional inlier-ratio prior from the streaming SPRT
    delta/epsilon history (pose_estim.cpp:1754-1761 static history) — it
    bounds the hypothesis budget of the robust engine.
    """
    res, _ = robust.estimate_essential_robust(
        x1, x2, mask, quality, robust_cfg, key, threshold_sq=th_sq,
        prior_inlier_ratio=sprt_prior,
    )
    E = res.model
    inl = res.inlier_mask
    if refine_cfg.enabled:
        rres = refine.refine_essential_linear(
            E, x1, x2, mask, res.threshold, refine_cfg
        )
        keep = rres.n_inliers >= (res.n_inliers // 2)
        E = jnp.where(keep, rres.model, E)
        inl = jnp.where(keep, rres.inlier_mask, inl)
    R, t, X, ok3d, _ = geo.recover_pose(E, x1, x2, inl.astype(x1.dtype), vote_points=512)

    if refine_cfg.polish_rt:
        # 5-DOF LM Sampson polish + inlier re-selection rounds (see
        # pipeline.estimate_pose) — the accuracy-decisive final step,
        # applied in streaming mode too
        pol, inl_p = refine.polish_pose_iterative(
            R, t, x1, x2, inl.astype(x1.dtype), mask.astype(x1.dtype),
            res.threshold,
            rounds=refine_cfg.polish_rounds,
            iterations=refine_cfg.polish_iterations,
            max_points=refine_cfg.polish_max_points,
        )
        keep_p = jnp.sum(inl_p) >= (jnp.sum(inl) * 3) // 4
        R = jnp.where(keep_p, pol.R, R)
        t = jnp.where(keep_p, pol.t, t)
        E = jnp.where(keep_p, pol.E, E)
        inl = jnp.where(keep_p, inl_p, inl)
        X = geo.triangulate_linear(R, t, x1, x2)
        z2 = (X @ R.T + t)[:, 2]
        ok3d = (X[:, 2] > 0) & (z2 > 0)

    kneip_ok = jnp.asarray(False)
    if kneip_iba:
        kn = eigensolver.refine_essential_kneip(E, x1, x2, inl)
        err_k = geo.sampson_error(kn.E, x1, x2)
        inl_k = (err_k < res.threshold) & mask.astype(bool)
        n_k = jnp.sum(inl_k)
        kneip_ok = (
            (n_k >= jnp.sum(inl) // 2)
            & (n_k > 0)
            & jnp.all(jnp.isfinite(kn.E))
        )
        E = jnp.where(kneip_ok, kn.E, E)
        R = jnp.where(kneip_ok, kn.R, R)
        t = jnp.where(kneip_ok, kn.t, t)
        inl = jnp.where(kneip_ok, inl_k, inl)
        X = geo.triangulate_linear(R, t, x1, x2)
        z2 = (X @ R.T + t)[:, 2]
        ok3d = (X[:, 2] > 0) & (z2 > 0)

    if ba_cfg.enabled:
        # exclude far points from BA (maxDist3DPtsZ, triangPts3D semantics)
        ba_mask = inl & ok3d & (X[:, 2] <= max_dist_z)
        eyeK = jnp.eye(3, dtype=x1.dtype)
        bres = ba.refine_stereo_ba(
            R, t, x1, x2, X, ba_mask.astype(x1.dtype), eyeK, eyeK, ba_cfg,
            huber_delta=jnp.sqrt(th_sq),
        )
        # when Kneip succeeded it replaces BA (useBA=false, :1633/:1697)
        R = jnp.where(kneip_ok, R, bres.R)
        t = jnp.where(kneip_ok, t, bres.t)
        E = jnp.where(kneip_ok, E, geo.essential_from_rt(bres.R, bres.t))
        inl = jnp.where(
            kneip_ok, inl,
            (geo.sampson_error(E, x1, x2) < res.threshold) & mask.astype(bool),
        )

    n_valid = jnp.maximum(jnp.sum(mask), 1.0)
    ratio = jnp.sum(inl).astype(x1.dtype) / n_valid
    return E, R, t, inl, ratio


@functools.partial(
    jax.jit, static_argnames=("refine_cfg", "ba_cfg", "kneip_iba")
)
def _refine_pool_pose(
    E0, pool: poolops.Pool, th_sq, refine_cfg, ba_cfg, kneip_iba, max_dist_z
):
    """Linear refinement of the pose on ALL pool correspondences with the
    pool-path configs, optionally followed by Kneip-instead-BA or BA
    (refinePoseFromPool, stereo_pose_refinement.cpp:1767-1990)."""
    maskf = pool.valid.astype(pool.x1.dtype)
    rres = refine.refine_essential_linear(
        E0, pool.x1, pool.x2, maskf, th_sq, refine_cfg
    )
    E = rres.model
    inl = rres.inlier_mask
    R, t, X, ok3d, _ = geo.recover_pose(
        E, pool.x1, pool.x2, inl.astype(pool.x1.dtype)
    )

    if refine_cfg.polish_rt:
        # 5-DOF LM Sampson polish with inlier re-selection — the
        # accuracy-decisive step (see _pose_from_set), applied to the
        # pool path too: this is the path that runs on MOST accepted
        # frames, and without it the 25k-correspondence pool lost to
        # single-frame estimation (GT_CAMPAIGN round 3: stereoref floored
        # at ~0.09 deg R_diff vs 0.028 for per-frame USAC at inl60).
        # Support quality weighting: each pool slot carries its
        # aggregated correspondence weight (Sampson-error history +
        # descriptor distance + responses, poolops.correspondence_weight
        # <- computeCorrespondenceWeight stereo_pose_refinement.cpp:2514),
        # so long-lived low-error correspondences steer the polish.
        pol, inl_p = refine.polish_pose_iterative(
            R, t, pool.x1, pool.x2, inl.astype(pool.x1.dtype), maskf,
            th_sq,
            rounds=refine_cfg.polish_rounds,
            iterations=refine_cfg.polish_iterations,
            max_points=refine_cfg.polish_max_points,
            point_weights=pool.weight,
        )
        keep_p = jnp.sum(inl_p) >= (jnp.sum(inl) * 3) // 4
        R = jnp.where(keep_p, pol.R, R)
        t = jnp.where(keep_p, pol.t, t)
        E = jnp.where(keep_p, pol.E, E)
        inl = jnp.where(keep_p, inl_p, inl)
        X = geo.triangulate_linear(R, t, pool.x1, pool.x2)
        z2 = (X @ R.T + t)[:, 2]
        ok3d = (X[:, 2] > 0) & (z2 > 0)

    kneip_ok = jnp.asarray(False)
    if kneip_iba:
        kn = eigensolver.refine_essential_kneip(E, pool.x1, pool.x2, inl)
        err_k = geo.sampson_error(kn.E, pool.x1, pool.x2)
        inl_k = (err_k < th_sq) & pool.valid
        n_k = jnp.sum(inl_k)
        kneip_ok = (
            (n_k >= jnp.sum(inl) // 2)
            & (n_k > 0)
            & jnp.all(jnp.isfinite(kn.E))
        )
        E = jnp.where(kneip_ok, kn.E, E)
        R = jnp.where(kneip_ok, kn.R, R)
        t = jnp.where(kneip_ok, kn.t, t)
        inl = jnp.where(kneip_ok, inl_k, inl)
        X = geo.triangulate_linear(R, t, pool.x1, pool.x2)
        z2 = (X @ R.T + t)[:, 2]
        ok3d = (X[:, 2] > 0) & (z2 > 0)

    if ba_cfg.enabled:
        ba_mask = inl & ok3d & (X[:, 2] <= max_dist_z)
        eyeK = jnp.eye(3, dtype=pool.x1.dtype)
        bres = ba.refine_stereo_ba(
            R, t, pool.x1, pool.x2, X, ba_mask.astype(pool.x1.dtype),
            eyeK, eyeK, ba_cfg, huber_delta=jnp.sqrt(th_sq),
        )
        R = jnp.where(kneip_ok, R, bres.R)
        t = jnp.where(kneip_ok, t, bres.t)
        E = jnp.where(kneip_ok, E, geo.essential_from_rt(bres.R, bres.t))

    inl = (geo.sampson_error(E, pool.x1, pool.x2) < th_sq) & pool.valid
    n_valid = jnp.maximum(jnp.sum(maskf), 1.0)
    ratio = jnp.sum(inl).astype(pool.x1.dtype) / n_valid
    return E, R, t, ratio


@functools.partial(jax.jit, static_argnames=("refine_cfg",))
def _track_frame_pose(
    E_pool, R_pool, t_pool, pool: poolops.Pool, x1, x2, mask, th_sq,
    refine_cfg,
):
    """Current-frame adaptation of the pool-refined pose.

    Extension beyond the reference (refinePoseFromPool
    returns the pool pose unmodified, stereo_pose_refinement.cpp:1767):
    the pool pose is the mean pose over the aggregation window, so on a
    rig with real per-frame pose jitter it floors at the jitter radius
    (GT campaign: a PERFECT mean-pose estimator scores R_diff ~0.029 deg
    against per-frame GT — exactly the per-frame USAC score). A short LM
    Sampson polish on the NEW pair, seeded at the pool pose, tracks the
    current frame with pool-grade stability: the seed is already within
    the basin, so two rounds suffice, and two guards keep the adaptation
    honest — the frame support must not shrink and the polished pose
    must still explain >= 95% of the pool's inliers (drift protection).
    """
    dtype = x1.dtype
    maskb = mask.astype(bool)
    err0 = geo.sampson_error(E_pool, x1, x2)
    inl0 = (err0 < th_sq) & maskb
    # stage 1 — rotation-only: per-frame rotation jitter is physical
    # (vibration), but the translation DIRECTION of a stereo rig is far
    # better estimated by the pool mean than by any single frame
    # (per-frame t estimation is noise-limited ~0.1 deg; the pool mean's
    # per-frame t error is an order of magnitude below that). Tracking R
    # also decouples the R-t compensation the shared-E fit otherwise
    # makes (GT campaign: inl90 t_ang 0.045 -> 0.019 deg from this alone)
    pol, inl_p = refine.polish_pose_iterative(
        R_pool, t_pool, x1, x2, inl0.astype(dtype), mask.astype(dtype),
        th_sq, rounds=2, iterations=refine_cfg.polish_iterations,
        max_points=refine_cfg.polish_max_points, rotation_only=True,
    )
    poolb = pool.valid
    n_pool0 = jnp.sum(
        (geo.sampson_error(E_pool, pool.x1, pool.x2) < th_sq) & poolb
    )
    n_poolp = jnp.sum(
        (geo.sampson_error(pol.E, pool.x1, pool.x2) < th_sq) & poolb
    )
    # the pool guard is deliberately loose (90%): adapting to a frame
    # whose true pose sits at the jitter radius legitimately shifts pool
    # residuals by ~f*jitter, costing a few percent of threshold-edge
    # pool inliers — only actual drift (pool support collapse) rejects
    n0 = jnp.sum(inl0)
    keep = (
        (jnp.sum(inl_p) >= n0)
        & (n_poolp >= (n_pool0 * 9) // 10)
        & jnp.all(jnp.isfinite(pol.E))
    )
    E = jnp.where(keep, pol.E, E_pool)
    R = jnp.where(keep, pol.R, R_pool)
    t = jnp.where(keep, pol.t, t_pool)
    n_cur = jnp.where(keep, jnp.sum(inl_p), n0)

    # stage 2 — full 5-DOF step, accepted only on STRICT frame-support
    # improvement: when the pool's t is accurate (high-inlier regimes)
    # freeing t gains nothing and is rejected, keeping the pool-mean t;
    # when the pool's t is contaminated (low-inlier regimes) the frame
    # carries real t information and the step is accepted (GT campaign:
    # inl40 t_ang 0.30 -> 0.18 deg)
    pol5, inl5 = refine.polish_pose_iterative(
        R, t, x1, x2,
        ((geo.sampson_error(E, x1, x2) < th_sq) & maskb).astype(dtype),
        mask.astype(dtype), th_sq,
        rounds=1, iterations=refine_cfg.polish_iterations,
        max_points=refine_cfg.polish_max_points,
    )
    n_pool5 = jnp.sum(
        (geo.sampson_error(pol5.E, pool.x1, pool.x2) < th_sq) & poolb
    )
    # a 2% margin: a t move must earn a real support gain — chance-level
    # +1/+2 inlier flips at high inlier counts must not unseat the
    # pool-mean t (they did: inl90 t_ang 0.019 -> 0.039 without margin)
    keep5 = (
        (jnp.sum(inl5) > n_cur + jnp.maximum(2, n_cur // 50))
        & (n_pool5 >= (n_pool0 * 9) // 10)
        & jnp.all(jnp.isfinite(pol5.E))
    )
    E = jnp.where(keep5, pol5.E, E)
    R = jnp.where(keep5, pol5.R, R)
    t = jnp.where(keep5, pol5.t, t)
    return E, R, t


@jax.jit
def _frame_inlier_ratio(E, x1, x2, mask, th_sq):
    err = geo.sampson_error(E, x1, x2)
    inl = (err < th_sq) & mask.astype(bool)
    n = jnp.maximum(jnp.sum(mask), 1.0)
    return jnp.sum(inl).astype(x1.dtype) / n, inl, err


@jax.jit
def _undistort(pts1, pts2, K1, K2, dist1, dist2):
    x1 = geo.undistort_oulu(geo.img_to_cam(pts1, K1), dist1)
    x2 = geo.undistort_oulu(geo.img_to_cam(pts2, K2), dist2)
    return x1, x2


# ---------------------------------------------------------------------------
# the framework
# ---------------------------------------------------------------------------


class StereoRefine:
    """Streaming stereo pose estimator over a fixed camera rig.

    Usage mirrors the reference (stereo_pose_refinement.h:185-334): create
    once with the calibration, then feed per-frame correspondences through
    `add_new_correspondences`. Poses are relative cam1 -> cam2 with unit
    translation.
    """

    # test hooks (reference constants)
    min_pool_size_stable = MIN_POOL_SIZE_STABLE

    def __init__(
        self,
        K1: np.ndarray,
        K2: np.ndarray,
        dist1: np.ndarray | None = None,
        dist2: np.ndarray | None = None,
        cfg: StereoRefineConfig = StereoRefineConfig(),
        seed: int = 0,
    ):
        self.cfg = cfg
        self.K1 = jnp.asarray(K1, jnp.float32)
        self.K2 = jnp.asarray(K2, jnp.float32)
        self.dist1 = jnp.asarray(
            dist1 if dist1 is not None else np.zeros(5), jnp.float32
        )
        self.dist2 = jnp.asarray(
            dist2 if dist2 is not None else np.zeros(5), jnp.float32
        )
        f_mean = float(K1[0][0] + K1[1][1] + K2[0][0] + K2[1][1]) / 4.0
        th = cfg.pose.robust.threshold_px / f_mean
        self.th_sq = jnp.asarray(th * th, jnp.float32)
        # maxDist3DPtsZ is a depth in units of the (unit) baseline
        self.max_dist_z = jnp.asarray(cfg.max_dist_3d_pts_z, jnp.float32)
        self._key = jax.random.PRNGKey(seed)
        self.reset()

    # -- state management ---------------------------------------------------

    def reset(self):
        """Full reinitialization (reinitializeSystem / clearHistoryAndPool,
        stereo_pose_refinement.cpp:1025-1070): pool + history + counters."""
        self.pool = poolops.empty_pool(self.cfg.max_pool_correspondences)
        self.R = np.eye(3)
        self.t = np.array([1.0, 0.0, 0.0])
        self.E = np.zeros((3, 3))
        self.nr_estimation = 0
        self.frame_idx = 0
        self.skip_count = 0
        self.max_skip_pairs_new = self.cfg.max_skip_pairs
        self.pose_history: list[tuple[np.ndarray, np.ndarray]] = []
        self.ratio_history: list[float] = []
        # per-estimation (mean, std) of sqrt-Sampson over new-pair inliers
        # (errorStatistic_history, :858)
        self.err_stat_history: list[tuple[float, float]] = []
        # SPRT epsilon/delta static history over the last 20 estimations
        # (pose_estim.cpp:1754-1761,1809-1976; pose_helper.cpp:2830,2879):
        # entries (epsilon = accepted inlier ratio, delta = fraction of
        # points consistent with rejected/bad models). The epsilon mean
        # feeds the robust engine's hypothesis-budget prior; cleared on
        # full reinit (the rig changed, the statistics no longer apply).
        self.sprt_history: list[tuple[float, float]] = []
        self._last_delta = 0.05
        # rating per pose from getNearToMeanPose; most-likely winner indices
        self.pose_ratings: list[float] = []
        self.most_likely_idxs: list[int] = []
        self.pose_is_stable = False
        self.most_likely_pose_stable = False
        self.nr_consec_stable = 0
        self._stability_tries = 0
        self.R_most_likely = np.eye(3)
        self.t_most_likely = np.array([1.0, 0.0, 0.0])
        # checkPoolPoseRobust schedule state (:680-716)
        self._nr_since_robust = 0
        self._check_pool_robust_tmp = max(self.cfg.check_pool_pose_robust, 1)
        self._init_number_inliers = 0
        self._failed_refinements = 0
        self.max_pool_size_reached = False

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _log(self, msg: str):
        """Reference-style state-transition prints (cfg.verbose, :501-560)."""
        if self.cfg.verbose > 0:
            print(f"[StereoRefine] {msg}")

    def _push_history(self, R, t, ratio: float):
        self.pose_history.append((np.asarray(R), np.asarray(t)))
        self.ratio_history.append(float(ratio))
        if len(self.pose_history) > 100:
            self.pose_history = self.pose_history[-100:]
            self.ratio_history = self.ratio_history[-100:]
            self.err_stat_history = self.err_stat_history[-100:]

    # -- sub-steps ----------------------------------------------------------

    def _robust_cfg(self, n_matches: int):
        """useRANSAC_fewMatches (:1295-1323): sparse frames switch the
        robust engine to plain RANSAC for this estimation only."""
        rc = self.cfg.pose.robust
        if (
            self.cfg.use_ransac_few_matches
            and n_matches < FEW_MATCHES_THRESHOLD
            and (rc.estimator != PoseEstimator.RANSAC
                 or self.cfg.pose.auto_th or self.cfg.pose.use_halign)
        ):
            rc = dataclasses.replace(
                rc, estimator=PoseEstimator.RANSAC, prosac=False
            )
        return rc

    def _sprt_prior(self):
        """Inlier-ratio prior from the 20-frame SPRT history, or None.

        Mirrors the SPRT_DELTA/EPSILON_AUTOM_INIT static-history path
        (pose_estim.cpp:1809-1976): at least 3 valid entries are required;
        the prior is the epsilon mean damped toward its minimum by the
        delta spread (unstable histories yield a weaker prior).
        """
        if len(self.sprt_history) < 3:
            return None
        eps = np.asarray([e for e, _ in self.sprt_history])
        dlt = np.asarray([d for _, d in self.sprt_history])
        spread = float(np.std(eps) + np.std(dlt))
        prior = float(np.mean(eps)) - spread
        return float(np.clip(prior, 0.05, 0.95))

    def _push_sprt(self, eps: float, delta: float):
        self.sprt_history.append((float(eps), float(delta)))
        if len(self.sprt_history) > 20:
            self.sprt_history = self.sprt_history[-20:]

    def _frame_pose(self, x1, x2, mask, quality, n_matches: int):
        """robustPoseEstimation on the new frame with the per-frame configs."""
        prior = self._sprt_prior()
        out = _pose_from_set(
            x1, x2, mask, quality, self.th_sq,
            self._robust_cfg(n_matches),
            self.cfg.pose.refine, self.cfg.pose.ba,
            self.cfg.kneip_instead_ba, self.max_dist_z,
            self._next_key(),
            sprt_prior=None if prior is None else jnp.asarray(
                prior, jnp.float32
            ),
        )
        E, R, t, inl, ratio = out
        # delta analogue: fraction of points that fit the PREVIOUS pose but
        # not the new one (points a bad/stale model explains)
        if self.nr_estimation > 0:
            err_prev = geo.sampson_error(
                jnp.asarray(self.E, jnp.float32), x1, x2
            )
            prev_ok = (err_prev < self.th_sq) & mask.astype(bool)
            stale = jnp.sum(prev_ok & jnp.logical_not(inl))
            self._last_delta = float(stale) / max(float(jnp.sum(mask)), 1.0)
        return out

    def _seed_pool(self, pts1, pts2, x1, x2, inl, desc_dist, response):
        """Replace the pool contents with the inliers of a fresh pose."""
        self.pool = poolops.empty_pool(self.cfg.max_pool_correspondences)
        E = jnp.asarray(self.E, jnp.float32)
        err = geo.sampson_error(E, x1, x2)
        w = poolops.correspondence_weight(err, desc_dist, response, self.th_sq)
        self.pool = poolops.insert_and_evict(
            self.pool, pts1, pts2, x1, x2, desc_dist, response, err,
            jnp.where(inl, w, 0.0), inl,
        )
        self._init_number_inliers = int(jnp.sum(inl))
        self._nr_since_robust = 0
        self._check_pool_robust_tmp = max(self.cfg.check_pool_pose_robust, 1)

    def _set_pose(self, E, R, t):
        self.E = np.asarray(E)
        self.R = np.asarray(R)
        self.t = np.asarray(t)

    # -- stability detection --------------------------------------------------

    def _get_near_to_mean_pose(self) -> int:
        """getNearToMeanPose (stereo_pose_refinement.cpp:2817-3117).

        Each pose is summarized as the rotated-and-shifted probe point
        R @ (0.5,0.5,0.5) + t. A robust center of gravity is computed by
        per-coordinate outlier filtering (mu +- 3 sigma when mean and
        median agree, inner-quartile band otherwise); poses valid on all
        three coordinates vote for the CoG. The pose nearest to the CoG
        becomes the most-likely pose, and every pose gets the normalized
        rating 1 - d_i / (d_max + 0.0075 * |CoG|).

        Returns 0 on success, -1 with <5 poses, -2 if the poses disagree.
        """
        n_p = len(self.pose_history)
        if n_p < 5:
            return -1
        probe = np.array([0.5, 0.5, 0.5])
        pts = np.stack(
            [R @ probe + t for R, t in self.pose_history]
        )  # (n_p, 3)

        q0 = int(np.floor(n_p * 0.25 + 0.5))
        q1 = n_p - q0
        order = np.argsort(pts, axis=0)  # per-coordinate sort indices
        sorted_pts = np.take_along_axis(pts, order, axis=0)

        rng = sorted_pts[-1] - sorted_pts[0]  # (3,) coordinate ranges
        over_range = bool(np.any(rng > 0.05))
        median = np.median(sorted_pts, axis=0)
        mean_all = pts.mean(axis=0)
        inner = sorted_pts[q0:q1]
        mean_inner = inner.mean(axis=0)
        if over_range:
            std = inner.std(axis=0, ddof=1) if inner.shape[0] > 1 else rng
            center = mean_inner
        else:
            std = pts.std(axis=0, ddof=1) if n_p > 1 else rng
            center = mean_all

        # statFilterPossible: mean and median must agree in sign, ratio
        # < 1.33 and absolute difference < 0.02 (:2965-2984)
        stat_ok = np.zeros(3, bool)
        for i in range(3):
            a, m = mean_all[i], median[i]
            if (a > 0 and m > 0) or (a < 0 and m < 0):
                stat_ok[i] = (
                    max(abs(a / m), abs(m / a)) <= 1.33
                    and abs(a - m) <= 0.02
                )
            elif abs(a) < 1e-12 or abs(m) < 1e-12:
                stat_ok[i] = abs(a - m) <= 0.02

        valid = np.ones(n_p, bool)
        if not stat_ok.any():
            # intersection of the inner-quartile sets on all coordinates
            for i in range(3):
                sel = np.zeros(n_p, bool)
                sel[order[q0:q1, i]] = True
                valid &= sel
        else:
            lo = center - 3.0 * std
            hi = center + 3.0 * std
            for i in range(3):
                if stat_ok[i]:
                    valid &= (pts[:, i] > lo[i]) & (pts[:, i] < hi[i])
                else:
                    sel = np.zeros(n_p, bool)
                    sel[order[q0:q1, i]] = True
                    valid &= sel

        if valid.sum() < 3:
            return -2  # the poses are too different

        cog = pts[valid].mean(axis=0)
        dist = np.linalg.norm(pts - cog, axis=1)
        best = int(np.argmin(dist))
        max_d = dist.max() + np.linalg.norm(cog) * 0.0075
        # winner hysteresis: when the history tightens (all poses nearly
        # identical — the normal case once the LM polish converges the
        # stream), argmin flickers among near-ties and the most-likely
        # persistence check (:3178) can never see m equal indices. Keep
        # the previous winner while its rating is within the ranking
        # stability band of the best.
        if self.most_likely_idxs:
            prev = self.most_likely_idxs[-1]
            if (
                0 <= prev < n_p
                and (dist[prev] - dist[best]) / max(max_d, 1e-12)
                <= self.cfg.abs_th_ranking_stable
            ):
                best = prev
        self.R_most_likely = self.pose_history[best][0].copy()
        self.t_most_likely = self.pose_history[best][1].copy()
        self.most_likely_idxs.append(best)
        self.pose_ratings = list(1.0 - dist / max(max_d, 1e-12))
        return 0

    def _check_pose_stability(self):
        """checkPoseStability (stereo_pose_refinement.cpp:3131-3296)."""
        cfg = self.cfg
        err = self._get_near_to_mean_pose()
        if err:
            self.pose_is_stable = False
            self.most_likely_pose_stable = False
            self.R_most_likely = self.R.copy()
            self.t_most_likely = self.t.copy()
            if err != -2:
                self._stability_tries = 0
            return

        n_est = len(self.pose_history)
        if (
            n_est < cfg.min_cont_stable_poses
            or int(self.pool.n_valid) < self.min_pool_size_stable
        ):
            self.pose_is_stable = False
            self.most_likely_pose_stable = False
            self._stability_tries = 0
            return

        # ranking-band check over the last minContStablePoses poses (:3158)
        last = self.pose_ratings[-1]
        lo, hi = last - cfg.abs_th_ranking_stable, last + cfg.abs_th_ranking_stable
        stable = True
        for k in range(2, cfg.min_cont_stable_poses + 1):
            r = self.pose_ratings[n_est - k]
            if not (lo < r < hi and r > cfg.min_norm_dist_stable):
                stable = False
                break

        # most-likely pose persistence (:3178-3203)
        m = cfg.min_cont_stable_poses
        if len(self.most_likely_idxs) >= m:
            last_idx = self.most_likely_idxs[-1]
            same = all(i == last_idx for i in self.most_likely_idxs[-m:])
            self.most_likely_pose_stable = (
                same and self.pose_ratings[last_idx] > cfg.min_norm_dist_stable
            )

        ratio_far = float(poolops.far_point_ratio(self.pool))

        if stable and ratio_far < 0.95:
            self.pose_is_stable = True
            self.nr_consec_stable += 1
            if self.max_skip_pairs_new <= cfg.max_skip_pairs:
                self._update_max_skip_pairs()
            if self._stability_tries:
                self._stability_tries -= 1
            return

        self.pose_is_stable = False
        self._stability_tries += 1

        # fallback: Sampson-error-range overlap over the last window
        # (:3225-3285) once ranking failed repeatedly, the pool is full,
        # and far points do not dominate
        if (
            self._stability_tries > cfg.min_cont_stable_poses
            and self.max_pool_size_reached
            and ratio_far < cfg.max_rat_3d_pts_far
            and len(self.err_stat_history) >= cfg.min_cont_stable_poses
        ):
            window = self.err_stat_history[-cfg.min_cont_stable_poses:]
            ranges = [(mu - 2.0 * sd, mu + 2.0 * sd) for mu, sd in window]
            mean_error = float(np.mean([mu for mu, _ in window]))
            min_left = min(r[0] for r in ranges)
            min_right = min(r[1] for r in ranges)
            max_left = max(r[0] for r in ranges)
            max_right = max(r[1] for r in ranges)
            if min_right <= min_left or max_left >= max_right:
                self.nr_consec_stable = 0
                return  # non-overlapping ranges
            span_l = mean_error - min_left
            span_r = max_right - mean_error
            full = span_l + span_r
            if full <= 0:
                self.nr_consec_stable = 0
                return
            pct_l, pct_r = span_l / full, span_r / full
            ok = True
            for left, right in ranges:
                right_ov = pct_r * (right - mean_error) / max(span_r, 1e-12)
                left_ov = pct_l * (mean_error - left) / max(span_l, 1e-12)
                if right_ov + left_ov < 0.8:
                    ok = False
                    break
            if ok:
                self.pose_is_stable = True
                self.nr_consec_stable += 1
            else:
                self.nr_consec_stable = 0
        else:
            self.nr_consec_stable = 0

        if self.pose_is_stable and self.max_skip_pairs_new <= cfg.max_skip_pairs:
            self._update_max_skip_pairs()

    def _update_max_skip_pairs(self):
        """updateMaxSkipPairs (stereo_pose_refinement.cpp:3300-3316):
        raiseSkipCnt low nibble = extra 0.25x factors on maxSkipPairs, high
        nibble + 1 = consecutive stable poses required before raising."""
        cfg = self.cfg
        factor = cfg.raise_skip_cnt & 0xF
        need = ((cfg.raise_skip_cnt & 0xF0) >> 4) + 1
        if factor and need <= self.nr_consec_stable:
            self.max_skip_pairs_new = int(
                np.ceil(cfg.max_skip_pairs * (1.0 + factor * 0.25))
            )
        else:
            self.max_skip_pairs_new = cfg.max_skip_pairs

    # -- main entry ---------------------------------------------------------

    def add_new_correspondences(
        self,
        pts1: np.ndarray,  # (K, 2) pixel coords, left
        pts2: np.ndarray,  # (K, 2) pixel coords, right
        mask: np.ndarray | None = None,  # (K,) validity
        quality: np.ndarray | None = None,  # (K,) PROSAC quality
        desc_dist: np.ndarray | None = None,
        response: np.ndarray | None = None,
    ) -> FrameResult:
        """Process one frame (addNewCorrespondences,
        stereo_pose_refinement.cpp:416-952)."""
        K = pts1.shape[0]
        pts1 = jnp.asarray(pts1, jnp.float32)
        pts2 = jnp.asarray(pts2, jnp.float32)
        mask = (
            jnp.ones((K,), jnp.float32) if mask is None
            else jnp.asarray(mask, jnp.float32)
        )
        quality = (
            jnp.ones((K,), jnp.float32) if quality is None
            else jnp.asarray(quality, jnp.float32)
        )
        desc_dist = (
            jnp.zeros((K,), jnp.float32) if desc_dist is None
            else jnp.asarray(desc_dist, jnp.float32)
        )
        response = (
            jnp.zeros((K,), jnp.float32) if response is None
            else jnp.asarray(response, jnp.float32)
        )
        x1, x2 = _undistort(
            pts1, pts2, self.K1, self.K2, self.dist1, self.dist2
        )
        self.frame_idx += 1
        n_matches = int(jnp.sum(mask))

        if self.nr_estimation == 0:
            result = self._robust_initialization(
                pts1, pts2, x1, x2, mask, quality, desc_dist, response,
                n_matches,
            )
        else:
            result = self._continuous_step(
                pts1, pts2, x1, x2, mask, quality, desc_dist, response,
                n_matches,
            )

        if self.skip_count > self.max_skip_pairs_new:
            # too many consecutive bad pairs -> full reinit (:943-948)
            self.reset()
            result = result._replace(state="reinit")
        return result

    # -- state-machine branches ----------------------------------------------

    def _result(self, state: str, ratio: float) -> FrameResult:
        # every accepted estimation feeds the SPRT static history (the
        # reference updates delta/epsilon per estimation in streaming mode,
        # pose_estim.cpp:1754-1761); skips/rejections carry no statistics
        if state in ("init", "refined", "robust", "reinit"):
            self._push_sprt(float(ratio), self._last_delta)
        return FrameResult(
            state=state,
            R=self.R.copy(), t=self.t.copy(), E=self.E.copy(),
            inlier_ratio=float(ratio),
            pool_size=int(self.pool.n_valid),
            pose_is_stable=self.pose_is_stable,
            most_likely_pose_stable=self.most_likely_pose_stable,
            R_most_likely=self.R_most_likely.copy(),
            t_most_likely=self.t_most_likely.copy(),
            skip_count=self.skip_count,
        )

    def _robust_initialization(
        self, pts1, pts2, x1, x2, mask, quality, desc_dist, response,
        n_matches,
    ) -> FrameResult:
        """robustInitialization (stereo_pose_refinement.cpp:968)."""
        E, R, t, inl, ratio = self._frame_pose(x1, x2, mask, quality, n_matches)
        ratio_f = float(ratio)
        if ratio_f < self.cfg.min_start_agg_inl_rat:
            # not reliable enough to start aggregating (:1015 reject path)
            return self._result("rejected", ratio_f)
        self._set_pose(E, R, t)
        self._seed_pool(pts1, pts2, x1, x2, inl, desc_dist, response)
        self.nr_estimation = 1
        self.skip_count = 0
        self._push_history(self.R, self.t, ratio_f)
        self._record_err_stats(x1, x2, mask)
        self._after_accept()
        return self._result("init", ratio_f)

    def _record_err_stats(self, x1, x2, mask):
        """errorStatistic_history entry for the newest pair (:845-858)."""
        E = jnp.asarray(self.E, jnp.float32)
        err = geo.sampson_error(E, x1, x2)
        inl = (err < self.th_sq) & mask.astype(bool)
        _, mean, std, _ = geo.masked_stats(
            jnp.sqrt(jnp.maximum(err, 0.0)), inl
        )
        self.err_stat_history.append((float(mean), float(std)))

    def _continuous_step(
        self, pts1, pts2, x1, x2, mask, quality, desc_dist, response,
        n_matches,
    ) -> FrameResult:
        cfg = self.cfg
        E_cur = jnp.asarray(self.E, jnp.float32)
        ratio_new, inl_new, err_new = _frame_inlier_ratio(
            E_cur, x1, x2, mask, self.th_sq
        )
        ratio_new = float(ratio_new)
        last_ratio = self.ratio_history[-1]

        add_to_pool = False
        frame_inl = inl_new
        frame_ratio = ratio_new

        if ratio_new < (1.0 - cfg.rel_inl_rat_th_last) * last_ratio:
            # significant drop -> robust re-estimation on the new frame (:489)
            E, R, t, inl, ratio_rob = self._frame_pose(
                x1, x2, mask, quality, n_matches
            )
            ratio_rob_f = float(ratio_rob)
            if ratio_new < ratio_rob_f * (1.0 - cfg.rel_inl_rat_th_new):
                # either the pose changed or the pair is bad (:497)
                if (
                    ratio_rob_f >= cfg.min_inlier_ratio_reinit
                    and ratio_new < cfg.min_inlier_ratio_reinit
                ):
                    # the rig moved: reinitialize on the new pose (:501-508)
                    self.reset()
                    self.frame_idx += 1
                    self._set_pose(E, R, t)
                    self._seed_pool(
                        pts1, pts2, x1, x2, inl, desc_dist, response
                    )
                    self.nr_estimation = 1
                    self._push_history(self.R, self.t, ratio_rob_f)
                    self._record_err_stats(x1, x2, mask)
                    self._log("The pose has changed! System is reinitialized!")
                    return self._result("reinit", ratio_rob_f)
                if (
                    ratio_rob_f < cfg.min_inlier_rat_skip
                    and ratio_rob_f
                    < cfg.rel_min_inlier_rat_skip * last_ratio
                ):
                    # bad pair: restore the old pose and skip (:511-521)
                    self.skip_count += 1
                    self._log("Bad image pair: restoring last valid pose")
                    return self._result("skipped", ratio_new)
                # unsure: robust estimation on the pool, keep history,
                # do not add the pair to the pool (:524-558); still counts
                # as a skipped pair (:560)
                self._log("Pose change or bad pair: robust estimation "
                          "on the pool")
                ok = self._robust_on_pool()
                self.skip_count += 1
                if not ok:
                    self.reset()
                    return self._result("reinit", ratio_rob_f)
                self.pose_is_stable = False
                self.most_likely_pose_stable = False
                return self._result("robust", ratio_rob_f)
            # similar pose after re-estimation: just a low-quality pair —
            # restore the last pose and add the pair's old-E inliers (:563)
            add_to_pool = True
            frame_inl = inl_new
            frame_ratio = ratio_new
        else:
            add_to_pool = True  # (:585-592)

        if not add_to_pool:  # pragma: no cover — all paths above return
            return self._result("skipped", ratio_new)

        # --- pool insertion + refinement (:594-860) ---
        E_old, R_old, t_old = self.E.copy(), self.R.copy(), self.t.copy()
        w_new = poolops.correspondence_weight(
            err_new, desc_dist, response, self.th_sq
        )
        new_valid, pool_valid, n_found = poolops.filter_new_vs_pool(
            self.pool, pts1, pts2, w_new, frame_inl, cfg.min_pts_distance
        )
        self.pool = self.pool._replace(valid=pool_valid, n_found=n_found)
        self.pool = poolops.insert_and_evict(
            self.pool, pts1, pts2, x1, x2, desc_dist, response, err_new,
            jnp.where(new_valid, w_new, 0.0), new_valid,
        )
        pool_size = int(self.pool.n_valid)
        if pool_size >= self.cfg.max_pool_correspondences:
            self.max_pool_size_reached = True

        # robust-vs-refine schedule on the pool (:680-716)
        init_inl = max(self._init_number_inliers, 1)
        run_robust = (
            cfg.check_pool_pose_robust == 1
            or self._nr_since_robust > self._check_pool_robust_tmp
            or (
                not self.max_pool_size_reached
                and self._check_pool_robust_tmp * init_inl < pool_size
            )
        )
        min_rel_remaining = 0.75
        if run_robust:
            ok = self._robust_on_pool()
            if not ok:
                self._set_pose(E_old, R_old, t_old)
                self.reset()
                return self._result("reinit", frame_ratio)
            if cfg.check_pool_pose_robust > 1:
                # exponential backoff of the robust cadence (:703-713)
                if self.max_pool_size_reached:
                    self._check_pool_robust_tmp = max(
                        cfg.check_pool_pose_robust, 10
                    )
                elif self._check_pool_robust_tmp > 50:
                    self._check_pool_robust_tmp = (
                        cfg.max_pool_correspondences // init_inl + 2
                    )
                else:
                    self._check_pool_robust_tmp = int(
                        round(
                            cfg.check_pool_pose_robust
                            + np.exp(0.8 + self._check_pool_robust_tmp / 6.0)
                        )
                    )
            self._nr_since_robust = 0
            min_rel_remaining = 0.7
            if cfg.track_frame_pose:
                E_t, R_t, t_t = _track_frame_pose(
                    jnp.asarray(self.E, jnp.float32),
                    jnp.asarray(self.R, jnp.float32),
                    jnp.asarray(self.t, jnp.float32),
                    self.pool, x1, x2, mask, self.th_sq, cfg.refine_pool,
                )
                self._set_pose(E_t, R_t, t_t)
            state = "robust"
        else:
            if self.max_pool_size_reached:
                self._nr_since_robust += 1
            else:
                self._nr_since_robust = 0
            E_p, R_p, t_p, ratio_p = _refine_pool_pose(
                E_cur, self.pool, self.th_sq,
                cfg.refine_pool, cfg.ba_pool, cfg.kneip_instead_ba_pool,
                self.max_dist_z,
            )
            if not np.all(np.isfinite(np.asarray(E_p))):
                # refinement failed: keep the old pose; a second consecutive
                # failure clears the whole system (:725-815)
                self._set_pose(E_old, R_old, t_old)
                self.skip_count += 1
                if self._failed_refinements > 0:
                    self._failed_refinements = 0
                    self.reset()
                    return self._result("reinit", frame_ratio)
                self._failed_refinements += 1
                return self._result("skipped", frame_ratio)
            self._failed_refinements = 0
            if cfg.track_frame_pose:
                # current-frame adaptation of the pool pose (see
                # _track_frame_pose): tracks per-frame rig jitter that the
                # mean-pose pool refinement cannot, guarded against drift
                E_p, R_p, t_p = _track_frame_pose(
                    E_p, R_p, t_p, self.pool, x1, x2, mask, self.th_sq,
                    cfg.refine_pool,
                )
            self._set_pose(E_p, R_p, t_p)
            state = "refined"

        # guard (:821-830): too few pool inliers after refinement -> the
        # aggregated state is inconsistent, restore + reinitialize
        E_ref = jnp.asarray(self.E, jnp.float32)
        n_pool_inl, n_pool, _ = poolops.pool_inlier_stats(
            self.pool, E_ref, self.th_sq
        )
        if float(n_pool_inl) < min_rel_remaining * max(float(n_pool), 1.0):
            self._set_pose(E_old, R_old, t_old)
            self.reset()
            return self._result("reinit", frame_ratio)

        # guard (:833-845): the refined pose must still explain the new pair
        ratio_ref, _, _ = _frame_inlier_ratio(
            E_ref, x1, x2, mask, self.th_sq
        )
        ratio_ref = float(ratio_ref)
        if ratio_ref < frame_ratio * (1.0 - cfg.rel_inl_rat_th_new):
            self._set_pose(E_old, R_old, t_old)
            self.reset()
            return self._result("reinit", frame_ratio)

        self._push_history(self.R, self.t, ratio_ref)
        self._record_err_stats(x1, x2, mask)
        self.nr_estimation += 1
        self.skip_count = 0
        self._after_accept()
        return self._result(state, ratio_ref)

    def _robust_on_pool(self) -> bool:
        """robustEstimationOnPool (stereo_pose_refinement.cpp:1075): robust
        engine over the pool with the pool-path refine/BA configs."""
        maskf = self.pool.valid.astype(jnp.float32)
        E, R, t, inl, ratio = _pose_from_set(
            self.pool.x1, self.pool.x2, maskf, self.pool.weight,
            self.th_sq, self.cfg.pose.robust,
            self.cfg.refine_pool, self.cfg.ba_pool,
            self.cfg.kneip_instead_ba_pool, self.max_dist_z,
            self._next_key(),
        )
        if not np.all(np.isfinite(np.asarray(E))) or float(ratio) <= 0.0:
            return False
        self._set_pose(E, R, t)
        return True

    def _after_accept(self):
        """Post-acceptance housekeeping: pool Sampson-history/3D update,
        outlier eviction, stability + most-likely pose (:861-940)."""
        E = jnp.asarray(self.E, jnp.float32)
        R = jnp.asarray(self.R, jnp.float32)
        t = jnp.asarray(self.t, jnp.float32)
        self.pool = poolops.evict_outliers(self.pool, E, 4.0 * self.th_sq)
        self.pool = poolops.update_pool_state(
            self.pool, E, R, t, self.th_sq, self.max_dist_z
        )
        self._check_pose_stability()
