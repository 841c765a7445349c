"""Flagship pipelines: correspondences + relative pose on an image pair.

Mirrors the reference's two entry layers (SURVEY.md §3.1/§3.3):

- get_correspondences == matchinglib::getCorrespondences
  (matchinglib/source/correspondences.cpp:148-519): detect -> describe ->
  match -> optional GMS / SOF / VFC filtering. The GMBSOF matcher name runs
  the full two-pass guided pipeline (initial ratio matching -> SOF field ->
  radius-guided rematch, match_statOptFlow.cpp:212 AdvancedMatching).
- estimate_pose == the poselib-test single-pair flow
  (tests/poselib-test/main.cpp:1461-1560 + pose_estim.cpp:857/:1737):
  pixel -> camera coords, Oulu undistortion, robust E (batched engine),
  IRLS linear refinement, pose recovery with cheirality voting,
  triangulation.

Both stages are jit-compiled end-to-end with static configs; all outputs
are fixed-shape masked arrays, so the same compiled program serves every
frame of a stream (and vmaps over pair batches).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import (
    DetectorConfig,
    DescriptorConfig,
    MAX_PIX_TH,
    MIN_PIX_TH,
    MatchingConfig,
    PoseConfig,
)
from matchinglib_poselib_tpu.ops import ba, features, filters, geometry as geo
from matchinglib_poselib_tpu.ops import homography_pose, matching, refine, robust
from matchinglib_poselib_tpu.ops import subpix


class Correspondences(NamedTuple):
    pts1: jax.Array  # (K, 2) pixel coords in image 1
    pts2: jax.Array  # (K, 2) matched pixel coords in image 2
    mask: jax.Array  # (K,) bool
    quality: jax.Array  # (K,) match quality (higher = better; PROSAC order)
    distance: jax.Array  # (K,) descriptor distance
    kps1: features.Keypoints
    kps2: features.Keypoints

    @property
    def n(self):
        return jnp.sum(self.mask.astype(jnp.int32))


class PoseResult(NamedTuple):
    R: jax.Array  # (3, 3) rotation cam1 -> cam2
    t: jax.Array  # (3,) unit translation
    E: jax.Array  # (3, 3) essential matrix
    inlier_mask: jax.Array  # (K,) bool over correspondences
    n_inliers: jax.Array
    inlier_ratio: jax.Array
    points3d: jax.Array  # (K, 3) triangulated points (camera-1 frame)
    valid3d: jax.Array  # (K,) cheirality mask
    is_degenerate: jax.Array  # bool flag from degeneracy analysis
    # UsacResults observability counters (USAC.h:18-60; zeros on the Halign
    # branch, which runs no hypothesize-and-verify loop)
    n_models_generated: jax.Array = 0
    n_models_rejected: jax.Array = 0
    n_points_verified: jax.Array = 0
    n_lo_refinements: jax.Array = 0
    # Halign observability (pose_homography.cpp:200-266): 0 = homography
    # alignment succeeded (or Halign not requested), -1..-4 = the failure
    # code that triggered the robust-E fallback (HalignResult.error_code)
    halign_error_code: jax.Array = 0


@functools.partial(
    jax.jit, static_argnames=("det_cfg", "desc_cfg", "match_cfg", "shape")
)
def get_correspondences(
    img1: jax.Array,
    img2: jax.Array,
    det_cfg: DetectorConfig = DetectorConfig(),
    desc_cfg: DescriptorConfig = DescriptorConfig(),
    match_cfg: MatchingConfig = MatchingConfig(),
    shape: tuple[int, int] | None = None,
) -> Correspondences:
    """Full correspondence pipeline on one image pair.

    img1, img2: (H, W) float32 grayscale in [0, 1].
    """
    if shape is None:
        shape = img1.shape
    binary = features.is_binary_descriptor(desc_cfg.kind)
    is_bold = features.is_bold_descriptor(desc_cfg.kind)
    # reference filter selection (match_statOptFlow.cpp:149-156): the
    # ratio test when enabled, cross-checking as the fallback when the
    # ratio test is off (never silently neither)
    cross = match_cfg.cross_check or not match_cfg.ratio_test

    kps1 = features.detect_keypoints(img1, det_cfg)
    kps2 = features.detect_keypoints(img2, det_cfg)
    bands = features.detector_bands(det_cfg)
    d1, kps1 = features.compute_descriptors(img1, kps1, desc_cfg, bands=bands)
    d2, kps2 = features.compute_descriptors(img2, kps2, desc_cfg, bands=bands)

    if is_bold:
        # BOLD carries (bits, stability-mask) words; the masked-Hamming
        # engine replaces the plain one (descriptors_ext.match_bold)
        from matchinglib_poselib_tpu.ops import descriptors_ext

        res = descriptors_ext.match_bold(
            d1[:, :16], d1[:, 16:], d2[:, :16], d2[:, 16:],
            kps1.mask, kps2.mask,
            ratio_test=match_cfg.ratio_test,
            ratio=match_cfg.ratio,
            cross_check=cross,
        )
    else:
        res = matching.match_descriptors(
            d1, d2, kps1.mask, kps2.mask,
            binary=binary,
            ratio_test=match_cfg.ratio_test,
            ratio=match_cfg.ratio,
            cross_check=cross,
        )
    pts1 = kps1.xy
    pts2 = kps2.xy[res.idx]
    mask = res.mask

    if match_cfg.matcher_name.upper() == "GMBSOF" and is_bold:
        # no guided BOLD rematch: apply the SOF consistency filter to the
        # first-pass matches instead (same flow statistics, filter-only)
        mask = filters.sof_filter_matches(
            pts1, pts2, mask, shape,
            cell_px=match_cfg.sof_grid_px,
            validation_th=match_cfg.sof_validation_th,
        )
    elif match_cfg.matcher_name.upper() == "GMBSOF":
        # the SOF field is estimated from a spatially balanced subset: the
        # strongest keypoints per grid cell (get_Sparse_KeypointField,
        # match_statOptFlow.cpp:5215) — weak clutter never pollutes the
        # per-cell flow statistics; the guided pass 2 still rematches ALL
        # keypoints
        init_mask = mask
        if match_cfg.sof_init_strongest:
            strong1 = filters.select_strongest_per_cell(
                kps1.xy, kps1.score, kps1.mask, shape,
                cell_px=match_cfg.sof_grid_px,
                per_cell=match_cfg.sof_init_per_cell,
            )
            init_mask = mask & strong1
        # AUTOTH (match_statOptFlow.cpp:766-801): the validation threshold
        # adapts to the inlier ratio estimated from the ratio-test
        # distance distribution
        if match_cfg.sof_autoth:
            vth = filters.autoth_validation_th(
                matching.estimate_inlier_ratio_from_ratios(res), binary
            )
        else:
            vth = match_cfg.sof_validation_th
        # pass 2: SOF field from initial matches -> guided rematch within
        # the predicted radius (AdvancedMatching semantics)
        field = filters.sof_statistics(
            pts1, pts2, init_mask, shape,
            cell_px=match_cfg.sof_grid_px,
            validation_th=vth,
        )
        pred, rad = filters.sof_predict(field, kps1.xy, match_cfg.sof_grid_px)
        # sparse-seed fallback: where the query's grid cell never
        # validated (too few seed matches per cell — the scale-warp
        # regime, GMBSOF_EVAL.md), predict from the k nearest seed
        # matches instead of the interpolated grid, so guided matching
        # still constrains the search instead of degenerating to the
        # plain ratio pass
        predk, radk, okk = filters.sof_predict_knn(
            pts1, pts2 - pts1, init_mask, kps1.xy
        )
        use_knn = ~filters.sof_cell_valid_at(
            field, kps1.xy, match_cfg.sof_grid_px
        ) & okk
        pred = jnp.where(use_knn[:, None], predk, pred)
        rad = jnp.where(use_knn, radk, rad)
        res = matching.match_descriptors(
            d1, d2, kps1.mask, kps2.mask,
            binary=binary,
            ratio_test=match_cfg.ratio_test,
            ratio=match_cfg.ratio,
            cross_check=cross,
            guide_pred=pred,
            guide_rad=rad,
            pts2_xy=kps2.xy,
        )
        pts2 = kps2.xy[res.idx]
        mask = res.mask

    if match_cfg.gms_filter:
        mask = filters.gms_filter(
            pts1, pts2, mask, shape, shape,
            grid=match_cfg.gms_grid,
            alpha=match_cfg.gms_threshold_factor,
        )
    if match_cfg.sof_filter and match_cfg.matcher_name.upper() != "GMBSOF":
        mask = filters.sof_filter_matches(
            pts1, pts2, mask, shape,
            cell_px=match_cfg.sof_grid_px,
            validation_th=match_cfg.sof_validation_th,
        )
    if match_cfg.subpix_refine:
        # template-matching sub-pixel refinement of the right-image points
        # (subPixRefine; getSubPixMatches matchers.cpp:1085, dispatched at
        # correspondences.cpp:445-508)
        sp = subpix.refine_matches_subpix(img1, img2, pts1, pts2, mask)
        pts2 = sp.pts2
    if match_cfg.vfc_filter:
        scale = jnp.asarray([shape[1], shape[0]], img1.dtype)
        vfc = filters.vfc_filter(pts1 / scale, pts2 / scale, mask)
        mask = vfc.inlier_mask

    # match quality for PROSAC: inverse distance ratio (lower ratio = better)
    ratio_q = res.distance / jnp.maximum(res.second_distance, 1e-9)
    quality = jnp.where(mask, 1.0 - ratio_q, 0.0)
    return Correspondences(
        pts1=pts1,
        pts2=pts2,
        mask=mask,
        quality=quality,
        distance=res.distance,
        kps1=kps1,
        kps2=kps2,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_pose(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    quality: jax.Array,
    K1: jax.Array,
    K2: jax.Array,
    dist1: jax.Array,
    dist2: jax.Array,
    cfg: PoseConfig,
    key: jax.Array,
) -> PoseResult:
    """Robust relative pose from pixel correspondences.

    Threshold semantics follow the reference: the pixel threshold is
    converted to normalized camera units via the mean focal length
    (pose_estim.cpp th2 = th / ((fx1+fy1+fx2+fy2)/4)).
    """
    x1 = geo.undistort_oulu(geo.img_to_cam(pts1, K1), dist1)
    x2 = geo.undistort_oulu(geo.img_to_cam(pts2, K2), dist2)

    f_mean = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    th = cfg.robust.threshold_px / f_mean
    th_sq = th * th

    if cfg.use_halign:
        # Halign (poselib-test --Halign; estimatePoseHomographies,
        # pose_homography.cpp:127): pose via multi-plane homography
        # extraction + decomposition — for plane-dominated scenes where
        # direct E estimation degenerates. The reference returns error
        # codes -1..-4 on non-planar scenes (pose_homography.cpp:200-266)
        # and its caller falls back; we do the same via lax.cond, so the
        # robust-E branch only executes when Halign actually failed.
        key, key_fb = jax.random.split(key)
        hres = homography_pose.estimate_pose_halign(
            x1, x2, mask, quality, cfg.halign, cfg.robust, key,
            threshold_sq=th_sq,
        )
        halign_ok = hres.error_code == 0

        def _keep_halign(_):
            return hres.E, hres.inlier_mask, hres.n_inliers

        def _fallback_robust(_):
            r, _ = robust.estimate_essential_robust(
                x1, x2, mask.astype(jnp.float32), quality, cfg.robust,
                key_fb, threshold_sq=th_sq,
            )
            return r.model, r.inlier_mask, r.n_inliers

        E, inl, n_inl_sel = jax.lax.cond(
            halign_ok, _keep_halign, _fallback_robust, None
        )

        class _R:
            model = E
            inlier_mask = inl
            n_inliers = n_inl_sel
            threshold = jnp.asarray(th_sq, x1.dtype)

        res = _R
        degen = None
        degen_flag = hres.is_rotation_only & halign_ok
        halign_code = hres.error_code
    elif cfg.auto_th:
        # AutoThEpi (poselib-test --autoTH; pose_estim.cpp:82-300): the
        # inlier threshold is adapted from residual statistics between
        # robust rounds, bounded by [MIN_PIX_TH, MAX_PIX_TH] pixels
        ath = robust.estimate_essential_autoth(
            x1, x2, mask.astype(jnp.float32), quality, cfg.robust, key,
            threshold_sq=th_sq,
            min_threshold=MIN_PIX_TH / f_mean,
            max_threshold=MAX_PIX_TH / f_mean,
        )
        res, degen = ath.result, ath.degen
        E = res.model
        inl = res.inlier_mask
        degen_flag = (
            degen.is_degenerate if degen is not None else jnp.asarray(False)
        )
    else:
        # SPRT-init parity (pose_estim.cpp:1814-1940): the match-quality
        # distribution provides an inlier-ratio prior that bounds the
        # hypothesis budget (quality = 1 - distance ratio, so quality > 0.4
        # is the reference's decisive ratio < 0.6 band)
        n_val = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
        prior = jnp.clip(
            jnp.sum(((quality > 0.4) & mask.astype(bool)).astype(jnp.float32))
            / n_val,
            0.05, 0.95,
        )
        res, degen = robust.estimate_essential_robust(
            x1, x2, mask.astype(jnp.float32), quality, cfg.robust, key,
            threshold_sq=th_sq, prior_inlier_ratio=prior,
        )
        E = res.model
        inl = res.inlier_mask
        degen_flag = (
            degen.is_degenerate if degen is not None else jnp.asarray(False)
        )

    if cfg.refine.enabled:
        rres = refine.refine_essential_linear(
            E, x1, x2, mask.astype(jnp.float32), res.threshold, cfg.refine
        )
        # keep the refined model only if it retains the support (the
        # reference's inlier-loss guard at the refinement call sites)
        keep = rres.n_inliers >= (res.n_inliers // 2)
        E = jnp.where(keep, rres.model, E)
        inl = jnp.where(keep, rres.inlier_mask, inl)

    R, t, X, ok3d, _ = geo.recover_pose(E, x1, x2, inl.astype(jnp.float32), vote_points=512)

    if cfg.refine.polish_rt:
        # final 5-DOF (R,t)-manifold LM Sampson polish alternated with
        # inlier re-selection — the accuracy-decisive step on real data
        # (cuts KITTI t_ang from ~2.8 deg to below the OpenCV-USAC
        # reference workload; see PARITY_ACCURACY.md)
        pol, inl_p = refine.polish_pose_iterative(
            R, t, x1, x2, inl.astype(jnp.float32), mask.astype(jnp.float32),
            res.threshold,
            rounds=cfg.refine.polish_rounds,
            iterations=cfg.refine.polish_iterations,
            max_points=cfg.refine.polish_max_points,
        )
        # guard: keep only if the polished model retains the support
        keep = jnp.sum(inl_p) >= (jnp.sum(inl) * 3) // 4
        R = jnp.where(keep, pol.R, R)
        t = jnp.where(keep, pol.t, t)
        E = jnp.where(keep, pol.E, E)
        inl = jnp.where(keep, inl_p, inl)
        # re-triangulate from the polished pose
        _, X, ok3d = geo.cheirality_counts(R, t, x1, x2, inl)

    if cfg.ba.enabled:
        # BART semantics (poselib-test --BART=1 -> refineStereoBA,
        # pose_estim.cpp:1083): BA on the triangulated inliers, restore
        # guards keep the pre-BA pose on suspicious updates. BA runs in
        # normalized camera coordinates (K = I), so the pseudo-Huber delta
        # is the pixel delta divided by the focal length.
        eyeK = jnp.eye(3, dtype=x1.dtype)
        bres = ba.refine_stereo_ba(
            R, t, x1, x2, X,
            (inl & ok3d).astype(jnp.float32),
            eyeK, eyeK, cfg.ba,
            huber_delta=cfg.ba.huber_delta / f_mean,
        )
        R, t, X = bres.R, bres.t, bres.points
        E = geo.essential_from_rt(R, t)
        err = geo.sampson_error(E, x1, x2)
        inl = (err < res.threshold) & mask.astype(bool)

    n_inl = jnp.sum(inl).astype(jnp.int32)
    n_valid = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    return PoseResult(
        R=R,
        t=t,
        E=E,
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=n_inl.astype(jnp.float32) / n_valid,
        points3d=X,
        valid3d=ok3d,
        is_degenerate=degen_flag,
        n_models_generated=getattr(res, "n_models_generated", 0),
        n_models_rejected=getattr(res, "n_models_rejected", 0),
        n_points_verified=getattr(res, "n_points_verified", 0),
        n_lo_refinements=getattr(res, "n_lo_refinements", 0),
        halign_error_code=(
            halign_code if cfg.use_halign else jnp.asarray(0, jnp.int32)
        ),
    )


class StereoPipeline:
    """Detect + describe + match + pose on stereo pairs — the flagship model.

    Owns the static configs (compiled once); `run` executes the jitted
    pipeline on one pair, `run_batch` vmaps over a leading pair axis
    (the data-parallel unit sharded over the `pairs` mesh axis).
    """

    def __init__(
        self,
        det_cfg: DetectorConfig = DetectorConfig(),
        desc_cfg: DescriptorConfig = DescriptorConfig(),
        match_cfg: MatchingConfig = MatchingConfig(),
        pose_cfg: PoseConfig = PoseConfig(),
        verbose: int = 0,
    ):
        self.det_cfg = det_cfg
        self.desc_cfg = desc_cfg
        self.match_cfg = match_cfg
        self.pose_cfg = pose_cfg
        # stage timing with the reference's taxonomy/verbosity
        # (correspondences.cpp:221-240; SURVEY.md §5.1)
        from matchinglib_poselib_tpu.utils.profiling import StageTimer

        self.timer = StageTimer(verbose=verbose)

    def correspondences(self, img1, img2) -> Correspondences:
        with self.timer.stage("matching") as h:
            corr = get_correspondences(
                img1, img2, self.det_cfg, self.desc_cfg, self.match_cfg
            )
            h["outputs"] = corr
        return corr

    def run(self, img1, img2, K1, K2, dist1, dist2, key) -> tuple:
        corr = self.correspondences(img1, img2)
        with self.timer.stage("robEstimationAndRef") as h:
            pose = estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                K1, K2, dist1, dist2, self.pose_cfg, key,
            )
            h["outputs"] = pose
        return corr, pose

    def run_batch(self, imgs1, imgs2, K1, K2, dist1, dist2, key) -> tuple:
        """Batched pairs: imgs1/imgs2 (B, H, W), shared calibration.

        vmaps the full detect->describe->match->pose program over the pair
        axis — the data-parallel unit that `parallel.mesh` shards over the
        'pairs' axis across devices. One compiled program serves any stream
        of same-shaped batches.
        """
        corr = jax.vmap(
            lambda a, b: get_correspondences(
                a, b, self.det_cfg, self.desc_cfg, self.match_cfg
            )
        )(imgs1, imgs2)
        keys = jax.random.split(key, imgs1.shape[0])
        pose = jax.vmap(
            lambda p1, p2, m, q, k: estimate_pose(
                p1, p2, m, q, K1, K2, dist1, dist2, self.pose_cfg, k
            )
        )(corr.pts1, corr.pts2, corr.mask, corr.quality, keys)
        return corr, pose
