"""Shared CLI plumbing: reference option names -> typed configs.

The reference packs several choices into digit strings; the parsers here
keep those exact encodings (poselib-test/main.cpp):

- --cfgUSAC, 6 digits [default 311220] (main.cpp:382-411): SPRT init /
  PROSAC beta / sample prevalidation / degeneracy handling / estimator /
  inner-refinement. Digits 1-3 configure SPRT+prevalidation, which the
  batched engine subsumes (dense scoring needs no SPRT or
  prevalidation) — they are accepted and recorded but have no batched
  equivalent; digits 4-6 map to real engine options.
- --refineRT, 2 digits [default 22] (main.cpp:339-354): linear
  refinement algorithm + weighting.
- --RobMethod (main.cpp:361): USAC | ARRSAC | RANSAC | LMEDS.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from matchinglib_poselib_tpu.config import (
    BAConfig,
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    MinimalSolver,
    PoseConfig,
    PoseEstimator,
    RefineWeights,
    RefinementConfig,
    RobustConfig,
    StereoRefineConfig,
)
from matchinglib_poselib_tpu.utils.compile_cache import (  # noqa: F401
    enable_compile_cache,
)


def add_matching_options(p: argparse.ArgumentParser):
    """matchinglib-test option set (matchinglib-test/main.cpp)."""
    p.add_argument("--img_path", required=True, help="image directory")
    p.add_argument("--l_img_pref", default="left_", help="left/first prefix")
    p.add_argument("--r_img_pref", default="right_", help="right/second prefix")
    p.add_argument("--f_detect", default="FAST", help="keypoint detector")
    p.add_argument("--d_extr", default="ORB", help="descriptor extractor")
    p.add_argument("--matcher", default="GMBSOF", help="matcher name")
    p.add_argument("--noRatiot", action="store_true", help="disable ratio test")
    p.add_argument("--refineVFC", action="store_true")
    p.add_argument("--refineSOF", action="store_true")
    p.add_argument("--refineGMS", action="store_true")
    p.add_argument("--DynKeyP", action="store_true",
                   help="dynamic keypoint response filtering (always on: "
                        "the detector is grid-filtered by design)")
    p.add_argument("--f_nr", type=int, default=2048, help="max features")
    p.add_argument("--subPixRef", action="store_true")
    p.add_argument("--showNr", type=int, default=50)
    p.add_argument("--v", type=int, default=0, help="verbosity 0-7")
    p.add_argument("--nmsIdx", default="", help="accepted for parity (NMSLIB "
                   "index params; the exact engine needs none)")
    p.add_argument("--nmsQry", default="", help="accepted for parity")
    p.add_argument("--output_path", default="")


def add_pose_options(p: argparse.ArgumentParser):
    """poselib-test extra options (poselib-test/main.cpp)."""
    p.add_argument("--c_file", default="calib_cam_to_cam.txt",
                   help="KITTI-format calibration file name (in img_path)")
    p.add_argument("--noPoseDiff", action="store_true")
    p.add_argument("--autoTH", action="store_true")
    p.add_argument("--refineRT", default="22")
    p.add_argument("--BART", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--RobMethod", default="USAC")
    p.add_argument("--Halign", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--showRect", action="store_true")
    p.add_argument("--th", type=float, default=0.8, help="pixel threshold")
    p.add_argument("--cfgUSAC", default="311220")
    p.add_argument("--USACdegenTh", type=float, default=0.85)
    p.add_argument("--USACInlratFilt", type=int, default=0)
    p.add_argument("--compInitPose", action="store_true",
                   help="compare against the calibration extrinsics")
    p.add_argument("--distcoeffNr", type=int, default=5)
    p.add_argument("--histEqual", action="store_true")
    p.add_argument("--stepSize", type=int, default=1)


def add_stereo_refine_options(p: argparse.ArgumentParser):
    """--stereoRef streaming-mode options (poselib-test/main.cpp)."""
    p.add_argument("--stereoRef", action="store_true")
    p.add_argument("--evStepStereoStable", type=int, default=0)
    p.add_argument("--useOnlyStablePose", action="store_true")
    p.add_argument("--useMostLikelyPose", action="store_true")
    p.add_argument("--refineRT_stereo", default="22")
    p.add_argument("--BART_stereo", type=int, default=0)
    p.add_argument("--minStartAggInlRat", type=float, default=0.2)
    p.add_argument("--relInlRatThLast", type=float, default=0.35)
    p.add_argument("--relInlRatThNew", type=float, default=0.2)
    p.add_argument("--minInlierRatSkip", type=float, default=0.38)
    p.add_argument("--relMinInlierRatSkip", type=float, default=0.7)
    p.add_argument("--maxSkipPairs", type=int, default=5)
    p.add_argument("--minInlierRatioReInit", type=float, default=0.67)
    p.add_argument("--minPtsDistance", type=float, default=3.0)
    p.add_argument("--maxPoolCorrespondences", type=int, default=30000)
    p.add_argument("--minContStablePoses", type=int, default=3)
    p.add_argument("--absThRankingStable", type=float, default=0.075)
    p.add_argument("--useRANSAC_fewMatches", action="store_true")
    p.add_argument("--checkPoolPoseRobust", type=int, default=3)
    p.add_argument("--minNormDistStable", type=float, default=0.5)
    p.add_argument("--raiseSkipCnt", default="00")
    p.add_argument("--maxRat3DPtsFar", type=float, default=0.4)
    p.add_argument("--maxDist3DPtsZ", type=float, default=130.0)


def matching_configs(args):
    det = DetectorConfig(
        kind=args.f_detect.upper(), max_keypoints=args.f_nr,
        fast_threshold=12.0,
    )
    desc = DescriptorConfig(kind=args.d_extr.upper())
    match = MatchingConfig(
        matcher_name=args.matcher.upper(),
        ratio_test=not args.noRatiot,
        gms_filter=args.refineGMS,
        sof_filter=args.refineSOF,
        vfc_filter=args.refineVFC,
        subpix_refine=args.subPixRef,
    )
    return det, desc, match


_SOLVER_BY_DIGIT5 = {
    "0": MinimalSolver.NISTER_5PT,
    "1": MinimalSolver.NISTER_5PT,  # Kneip eigensolver -> batched 5pt
    "2": MinimalSolver.STEWENIUS_5PT,
}

# refineRT 1st digit (main.cpp:339-354): (enabled, solver, kneipInsteadBA)
_REFINE_ALG = {
    "0": (False, MinimalSolver.EIGHT_PT, False),
    "1": (True, MinimalSolver.EIGHT_PT, False),
    "2": (True, MinimalSolver.EIGHT_PT, False),
    "3": (True, MinimalSolver.NISTER_5PT, False),
    "4": (True, MinimalSolver.STEWENIUS_5PT, False),
    # Kneip's eigensolver applied on the robust output (PR_KNEIP)
    "5": (True, MinimalSolver.KNEIP, False),
    # Kneip after triangulation = BA substitute (kneipInsteadBA,
    # main.cpp:842-844)
    "6": (True, MinimalSolver.KNEIP, True),
}

_REFINE_W = {
    "0": RefineWeights.SQUARED,
    "1": RefineWeights.TORR,
    "2": RefineWeights.PSEUDO_HUBER,
}


def pose_config(args) -> PoseConfig:
    cfgusac = (args.cfgUSAC + "311220")[:6]
    rob = RobustConfig(
        estimator=PoseEstimator[args.RobMethod.upper()]
        if args.RobMethod.upper() in PoseEstimator.__members__
        else PoseEstimator.USAC,
        solver=_SOLVER_BY_DIGIT5.get(cfgusac[4], MinimalSolver.NISTER_5PT),
        threshold_px=args.th,
        check_degeneracy=cfgusac[3] != "0",
        degen_decision_ratio=args.USACdegenTh,
    )
    rrt = (args.refineRT + "22")[:2]
    enabled, solver, kneip_iba = _REFINE_ALG.get(
        rrt[0], (True, MinimalSolver.EIGHT_PT, False)
    )
    ref = RefinementConfig(
        enabled=enabled,
        solver=solver,
        weights=_REFINE_W.get(rrt[1], RefineWeights.PSEUDO_HUBER),
    )
    ba = BAConfig(enabled=args.BART > 0, fix_intrinsics=args.BART != 2)
    return PoseConfig(
        robust=rob, refine=ref, ba=ba, auto_th=args.autoTH,
        use_halign=args.Halign > 0,
    ), kneip_iba


def _parse_raise_skip_cnt(s: str) -> int:
    """2-digit CLI value 'fc' -> bit-packed raiseSkipCnt (main.cpp:1135):
    low nibble = factor digit, high nibble = consecutive-poses digit."""
    s = (str(s) + "00")[:2]
    try:
        f, c = int(s[0]), int(s[1])
    except ValueError:
        return 0
    return (c << 4) | f


def stereo_refine_config(args, pose: PoseConfig,
                         kneip_iba: bool = False) -> StereoRefineConfig:
    rrt_s = (args.refineRT_stereo + "22")[:2]
    en_s, solver_s, kneip_iba_s = _REFINE_ALG.get(
        rrt_s[0], (True, MinimalSolver.EIGHT_PT, False)
    )
    refine_pool = RefinementConfig(
        enabled=en_s,
        solver=solver_s,
        weights=_REFINE_W.get(rrt_s[1], RefineWeights.PSEUDO_HUBER),
        # pool-scale compaction caps (see StereoRefineConfig.refine_pool)
        refine_max_points=4096,
        polish_max_points=4096,
    )
    ba_pool = BAConfig(
        enabled=args.BART_stereo > 0, fix_intrinsics=args.BART_stereo != 2
    )
    return StereoRefineConfig(
        max_pool_correspondences=args.maxPoolCorrespondences,
        min_pts_distance=args.minPtsDistance,
        check_pool_pose_robust=args.checkPoolPoseRobust,
        min_start_agg_inl_rat=args.minStartAggInlRat,
        rel_inl_rat_th_last=args.relInlRatThLast,
        rel_inl_rat_th_new=args.relInlRatThNew,
        min_inlier_rat_skip=args.minInlierRatSkip,
        rel_min_inlier_rat_skip=args.relMinInlierRatSkip,
        max_skip_pairs=args.maxSkipPairs,
        min_inlier_ratio_reinit=args.minInlierRatioReInit,
        min_cont_stable_poses=args.minContStablePoses,
        abs_th_ranking_stable=args.absThRankingStable,
        min_norm_dist_stable=args.minNormDistStable,
        raise_skip_cnt=_parse_raise_skip_cnt(args.raiseSkipCnt),
        max_rat_3d_pts_far=args.maxRat3DPtsFar,
        max_dist_3d_pts_z=args.maxDist3DPtsZ,
        use_ransac_few_matches=args.useRANSAC_fewMatches,
        kneip_instead_ba=kneip_iba,
        kneip_instead_ba_pool=kneip_iba_s,
        refine_pool=refine_pool,
        ba_pool=ba_pool,
        verbose=args.v,
        pose=pose,
    )


class StageTimer:
    """Per-stage wall-clock timing, printed like the reference's verbose
    tick-count output (correspondences.cpp:221-240; SURVEY.md §5.1)."""

    def __init__(self, verbose: int):
        self.verbose = verbose
        self.stages: dict[str, float] = {}
        self._t0 = None
        self._name = None

    def start(self, name: str):
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self):
        dt = (time.perf_counter() - self._t0) * 1e3
        self.stages[self._name] = self.stages.get(self._name, 0.0) + dt
        if self.verbose > 0:
            print(f"  [time] {self._name}: {dt:.2f} ms")
        return dt
