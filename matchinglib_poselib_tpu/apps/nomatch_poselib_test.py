"""GT-driven pose evaluation CLI (reference: tests/noMatch_poselib-test).

Consumes ground-truth correspondences that bypass the matcher (the
``noMatch_`` prefix = "no matching performed"), runs the configured pose
algorithms per frame and writes a semicolon-separated CSV with the
reference's metric columns (writeResultsDisk, main.cpp:2918-2937):
R_diffAll, per-axis R_diff, t_angDiff_deg, t_distDiff, t element diffs,
most-likely-pose variants, inlier ratios (GT + estimated), pool size and
per-stage timings (timeMeasurements struct, main.cpp:61-73).

Sequence format (replaces the reference's SemiRealSequence OpenCV-yaml):
a directory of ``frame_*.npz`` files, each with

    pts1 (K, 2) float  left-image pixel coords
    pts2 (K, 2) float  right-image pixel coords
    R_GT (3, 3), t_GT (3,)  ground-truth relative pose
    K1 (3, 3), K2 (3, 3)    intrinsics
    inlier_mask_GT (K,) bool  (optional) which GT correspondences are
                              true inliers (for inlRat_GT)

Usage:
    python -m matchinglib_poselib_tpu.apps.nomatch_poselib_test \
        --sequ_path <dir> --output_path out/ --RobMethod USAC --stereoRef
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import time

import numpy as np

from matchinglib_poselib_tpu.apps import common


def _mat_cols(name, rows, cols):
    return [f"{name}({y},{x})" for y in range(rows) for x in range(cols)]


# reference CamMatDiff fields (noMatch_poselib-test/main.cpp:113-154)
_KDIFF_FIELDS = (
    "fxDiff", "fyDiff", "fxyDiffNorm", "cxDiff", "cyDiff", "cxyDiffNorm",
    "cxyfxfyNorm",
)

CSV_COLUMNS = (
    [
        "frame", "state",
        "R_diffAll", "R_diff_roll", "R_diff_pitch", "R_diff_yaw",
        "t_angDiff_deg", "t_distDiff",
        "t_diff_tx", "t_diff_ty", "t_diff_tz",
        # most-likely-pose variants (algorithmResult main.cpp:207-211)
        "R_mostLikely_diffAll",
        "R_mostLikely_diff_roll", "R_mostLikely_diff_pitch",
        "R_mostLikely_diff_yaw",
        "t_mostLikely_angDiff_deg", "t_mostLikely_distDiff",
        "t_mostLikely_diff_tx", "t_mostLikely_diff_ty", "t_mostLikely_diff_tz",
    ]
    # full matrices (printCVMat blocks, main.cpp:404-412)
    + _mat_cols("R_out", 3, 3) + _mat_cols("t_out", 3, 1)
    + _mat_cols("R_mostLikely", 3, 3) + _mat_cols("t_mostLikely", 3, 1)
    + _mat_cols("R_GT", 3, 3) + _mat_cols("t_GT", 3, 1)
    # camera-matrix diffs (CamMatDiff, main.cpp:113-154)
    + [f"K1_{f}" for f in _KDIFF_FIELDS]
    + [f"K2_{f}" for f in _KDIFF_FIELDS]
    + [
        "nrCorrs_GT", "inlRat_GT", "nrCorrs_estimated", "inlRat_estimated",
        "poolSize", "poseIsStable", "mostLikelyPose_stable", "ransac_agg",
        # streaming state-machine counters (stereo_pose_refinement.cpp
        # :943-948 skip escalation / :1025 reinitializeSystem)
        "skipCount",
        # Halign failure-code observability (pose_homography.cpp:200-266;
        # 0 = alignment used, -1..-4 = fallback reason)
        "halign_errCode",
        # UsacResults observability counters (USAC.h:18-60)
        "usac_modelsGenerated", "usac_modelsRejected", "usac_pointsVerified",
        "usac_loRefinements",
        "filtering_ms", "robEstimationAndRef_ms", "linRefinement_ms",
        "bundleAdjust_ms", "stereoRefine_ms",
    ]
)


def _kdiff(K_used: np.ndarray, K_gt: np.ndarray) -> dict:
    """CamMatDiff::calcDiff parity (main.cpp:121-137)."""
    fx = float(K_used[0, 0] - K_gt[0, 0])
    fy = float(K_used[1, 1] - K_gt[1, 1])
    cx = float(K_used[0, 2] - K_gt[0, 2])
    cy = float(K_used[1, 2] - K_gt[1, 2])
    return {
        "fxDiff": fx,
        "fyDiff": fy,
        "fxyDiffNorm": float(np.hypot(fx, fy)),
        "cxDiff": cx,
        "cyDiff": cy,
        "cxyDiffNorm": float(np.hypot(cx, cy)),
        "cxyfxfyNorm": float(np.sqrt(fx * fx + fy * fy + cx * cx + cy * cy)),
    }


def _write_mat(row: dict, name: str, m: np.ndarray):
    m = np.asarray(m, np.float64).reshape(-1)
    r = 3 if m.size == 9 else m.size
    c = 3 if m.size == 9 else 1
    i = 0
    for y in range(r):
        for x in range(c):
            row[f"{name}({y},{x})"] = round(float(m[i]), 6)
            i += 1


def build_parser():
    p = argparse.ArgumentParser(
        prog="noMatch_poselib-test",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--sequ_path", required=True)
    p.add_argument("--matchData_idx", type=int, default=0,
                   help="accepted for parity (frame files are globbed)")
    p.add_argument("--ovf_ext", default="npz",
                   help="frame file extension: npz (native) or the "
                        "reference's cv::FileStorage yaml/yml/xml[.gz] "
                        "(SemiRealSequence sequSingleFrameData_* + "
                        "matchSingleFrameData_* files)")
    p.add_argument("--matches_path", default="",
                   help="directory of matchSingleFrameData_* files when "
                        "ovf_ext is a FileStorage format (default: "
                        "sequ_path itself, then its first subdirectory "
                        "containing such files — the reference nests them "
                        "in a hash-named subdir, main.cpp:963-968)")
    p.add_argument("--output_path", default=".")
    p.add_argument("--v", type=int, default=0)
    p.add_argument("--addSequInfo", default="")
    p.add_argument("--useGTCamMat", action="store_true",
                   help="use GT camera matrices (always on: the npz frames "
                        "carry K1/K2)")
    p.add_argument("--accumCorrs", type=int, default=0)
    # pose options shared with poselib-test
    p.add_argument("--noPoseDiff", action="store_true")
    p.add_argument("--autoTH", action="store_true")
    p.add_argument("--refineRT", default="22")
    p.add_argument("--refineVFC", action="store_true")
    p.add_argument("--refineSOF", action="store_true")
    p.add_argument("--refineGMS", action="store_true")
    p.add_argument("--BART", type=int, default=0)
    p.add_argument("--RobMethod", default="USAC")
    p.add_argument("--Halign", type=int, default=0)
    p.add_argument("--th", type=float, default=0.8)
    p.add_argument("--cfgUSAC", default="311220")
    p.add_argument("--USACdegenTh", type=float, default=0.85)
    p.add_argument("--USACInlratFilt", type=int, default=0)
    p.add_argument("--compInitPose", action="store_true")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the untimed frame-0 JIT warm-up pass")
    common.add_stereo_refine_options(p)
    return p


def _angles_deg(R):
    """roll/pitch/yaw of a rotation matrix (getAnglesRotMat parity)."""
    import jax.numpy as jnp

    from matchinglib_poselib_tpu.ops import geometry as geo

    # angles_from_rot already returns degrees (ops/geometry.py) — no further
    # conversion (a double np.degrees() here inflated every per-axis column
    # 57.3x in the round-2 campaign CSVs).
    return np.asarray(geo.angles_from_rot(jnp.asarray(R, jnp.float32)))


def evaluate_frame(frame, pose_cfg, stereo_ref, args, key, frame_idx,
                   accum=None):
    """One frame: estimate + GT metrics. Returns a CSV row dict.

    accum: optional list buffer of the last --accumCorrs frames'
    (pts1, pts2) for aggregated robust estimation (reference main.cpp:1742
    frameInliers_accum; ransac_agg column = frames aggregated).
    """
    import jax
    import jax.numpy as jnp

    from matchinglib_poselib_tpu.models import pipeline
    from matchinglib_poselib_tpu.ops import filters, geometry as geo

    pts1 = frame["pts1"].astype(np.float32)
    pts2 = frame["pts2"].astype(np.float32)
    K = len(pts1)
    R_GT = frame["R_GT"]
    t_GT = frame["t_GT"].ravel()
    K1 = frame["K1"]
    K2 = frame["K2"]
    inl_gt = frame.get("inlier_mask_GT", np.ones(K, bool))

    row = {c: "" for c in CSV_COLUMNS}
    row["frame"] = frame_idx
    row["nrCorrs_GT"] = K
    row["inlRat_GT"] = round(float(np.mean(inl_gt)), 4)
    row["ransac_agg"] = 1

    # K diffs: the frames may carry noisy K1/K2 next to GT intrinsics
    K1_GT = frame.get("K1_GT", K1)
    K2_GT = frame.get("K2_GT", K2)
    for nm, d in (("K1", _kdiff(K1, K1_GT)), ("K2", _kdiff(K2, K2_GT))):
        for f, v in d.items():
            row[f"{nm}_{f}"] = round(v, 6)

    # correspondence accumulation over the last --accumCorrs frames
    if accum is not None and args.accumCorrs > 1:
        accum.append((pts1, pts2))
        while len(accum) > args.accumCorrs:
            accum.pop(0)
        row["ransac_agg"] = len(accum)
        pts1 = np.concatenate([a[0] for a in accum], axis=0)
        pts2 = np.concatenate([a[1] for a in accum], axis=0)
        K = len(pts1)

    mask = np.ones(K, np.float32)
    quality = np.ones(K, np.float32)

    t0 = time.perf_counter()
    if args.refineVFC or args.refineSOF or args.refineGMS:
        m = jnp.asarray(mask).astype(bool)
        shape = (
            int(np.ceil(pts1[:, 1].max())) + 1,
            int(np.ceil(pts1[:, 0].max())) + 1,
        )
        if args.refineGMS:
            m = filters.gms_filter(
                jnp.asarray(pts1), jnp.asarray(pts2), m, shape, shape
            )
        if args.refineSOF:
            m = filters.sof_filter_matches(
                jnp.asarray(pts1), jnp.asarray(pts2), m, shape
            )
        if args.refineVFC:
            scale = np.asarray([shape[1], shape[0]], np.float32)
            vfc = filters.vfc_filter(
                jnp.asarray(pts1 / scale), jnp.asarray(pts2 / scale), m
            )
            m = vfc.inlier_mask
        mask = np.asarray(m).astype(np.float32)
    row["filtering_ms"] = round((time.perf_counter() - t0) * 1e3, 3)

    # distortion-in-the-loop: frames may carry Oulu distortion
    # coefficients (pose_helper.cpp:1169 Remove_LensDist preprocessing)
    d1 = jnp.asarray(
        frame.get("dist1", np.zeros(5)).ravel(), jnp.float32
    )
    d2 = jnp.asarray(
        frame.get("dist2", np.zeros(5)).ravel(), jnp.float32
    )
    if stereo_ref is not None:
        t0 = time.perf_counter()
        fr = stereo_ref.add_new_correspondences(pts1, pts2, mask, quality)
        row["stereoRefine_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        R_est, t_est = np.asarray(fr.R), np.asarray(fr.t)
        row["state"] = fr.state
        row["skipCount"] = int(fr.skip_count)
        row["poolSize"] = int(fr.pool_size)
        row["poseIsStable"] = int(bool(fr.pose_is_stable))
        row["mostLikelyPose_stable"] = int(bool(fr.most_likely_pose_stable))
        row["inlRat_estimated"] = round(float(fr.inlier_ratio), 4)
        row["nrCorrs_estimated"] = int(round(fr.inlier_ratio * mask.sum()))
        rml, tml = np.asarray(fr.R_most_likely), np.asarray(fr.t_most_likely)
        tn_gt = t_GT / np.linalg.norm(t_GT)
        rdm, tdm, tdd = geo.compare_poses(
            jnp.asarray(R_GT, jnp.float32),
            jnp.asarray(tn_gt, jnp.float32),
            jnp.asarray(rml, jnp.float32), jnp.asarray(tml, jnp.float32),
        )
        row["R_mostLikely_diffAll"] = round(float(rdm), 4)
        row["t_mostLikely_angDiff_deg"] = round(float(tdm), 4)
        row["t_mostLikely_distDiff"] = round(float(tdd), 4)
        ang_ml = _angles_deg(rml @ R_GT.T)
        row["R_mostLikely_diff_roll"] = round(float(ang_ml[0]), 4)
        row["R_mostLikely_diff_pitch"] = round(float(ang_ml[1]), 4)
        row["R_mostLikely_diff_yaw"] = round(float(ang_ml[2]), 4)
        tml_n = tml / max(np.linalg.norm(tml), 1e-12)
        for ax, v in zip("xyz", tml_n - tn_gt):
            row[f"t_mostLikely_diff_t{ax}"] = round(float(v), 4)
        _write_mat(row, "R_mostLikely", rml)
        _write_mat(row, "t_mostLikely", tml)
    else:
        t0 = time.perf_counter()
        pose = pipeline.estimate_pose(
            jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(mask),
            jnp.asarray(quality),
            jnp.asarray(K1, jnp.float32), jnp.asarray(K2, jnp.float32),
            d1, d2, pose_cfg, key,
        )
        jax.block_until_ready(pose.R)
        row["robEstimationAndRef_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3
        )
        R_est, t_est = np.asarray(pose.R), np.asarray(pose.t)
        row["state"] = "single"
        row["nrCorrs_estimated"] = int(pose.n_inliers)
        row["inlRat_estimated"] = round(float(pose.inlier_ratio), 4)
        if args.Halign:
            row["halign_errCode"] = int(pose.halign_error_code)
        row["usac_modelsGenerated"] = int(pose.n_models_generated)
        row["usac_modelsRejected"] = int(pose.n_models_rejected)
        row["usac_pointsVerified"] = int(pose.n_points_verified)
        row["usac_loRefinements"] = int(pose.n_lo_refinements)

    if not args.noPoseDiff:
        tn_gt = t_GT / np.linalg.norm(t_GT)
        rd, td, tdist = geo.compare_poses(
            jnp.asarray(R_GT, jnp.float32), jnp.asarray(tn_gt, jnp.float32),
            jnp.asarray(R_est, jnp.float32), jnp.asarray(t_est, jnp.float32),
        )
        row["R_diffAll"] = round(float(rd), 4)
        row["t_angDiff_deg"] = round(float(td), 4)
        row["t_distDiff"] = round(float(tdist), 4)
        ang = _angles_deg(R_est @ R_GT.T)
        row["R_diff_roll"] = round(float(ang[0]), 4)
        row["R_diff_pitch"] = round(float(ang[1]), 4)
        row["R_diff_yaw"] = round(float(ang[2]), 4)
        td_el = t_est / max(np.linalg.norm(t_est), 1e-12) - tn_gt
        row["t_diff_tx"] = round(float(td_el[0]), 4)
        row["t_diff_ty"] = round(float(td_el[1]), 4)
        row["t_diff_tz"] = round(float(td_el[2]), 4)
    _write_mat(row, "R_out", R_est)
    _write_mat(row, "t_out", t_est)
    _write_mat(row, "R_GT", R_GT)
    _write_mat(row, "t_GT", t_GT)
    return row


_FS_EXTS = {"yaml", "yml", "xml", "yaml.gz", "yml.gz", "xml.gz"}


def _filestorage_frames(args):
    """Frame list for the reference's SemiRealSequence FileStorage layout.

    sequ_path holds sequSingleFrameData_<n>.<ext> (camera params); the
    matchSingleFrameData_<n>.<ext> files live beside them or in a
    (hash-named) subdirectory (noMatch_poselib-test/main.cpp:963-968,
    1522-1543). Returns a list of loader thunks.
    """
    from matchinglib_poselib_tpu.utils import opencv_fs

    ext = args.ovf_ext.lower().lstrip(".")
    root = pathlib.Path(args.sequ_path)
    sequ = sorted(root.glob(f"sequSingleFrameData_*.{ext}"))
    if not sequ:
        raise SystemExit(f"no sequSingleFrameData_*.{ext} in {root}")
    mdir = pathlib.Path(args.matches_path) if args.matches_path else None
    if mdir is None:
        if list(root.glob(f"matchSingleFrameData_*.{ext}")):
            mdir = root
        else:
            for sub in sorted(p for p in root.iterdir() if p.is_dir()):
                if list(sub.glob(f"matchSingleFrameData_*.{ext}")):
                    mdir = sub
                    break
    if mdir is None:
        raise SystemExit(f"no matchSingleFrameData_*.{ext} under {root}")

    def make_loader(sp):
        idx = sp.stem.split("_")[-1].split(".")[0]
        mp = mdir / f"matchSingleFrameData_{idx}.{ext}"

        def load():
            cp = opencv_fs.read_cam_pars(sp)
            sm = opencv_fs.read_matches(mp)
            return opencv_fs.sequ_frame(cp, sm)

        return load

    return [make_loader(sp) for sp in sequ]


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.enable_compile_cache()
    import jax

    pose_args = argparse.Namespace(**vars(args))
    pose_cfg, kneip_iba = common.pose_config(pose_args)

    if args.ovf_ext.lower().lstrip(".") in _FS_EXTS:
        frames = _filestorage_frames(args)
    else:
        frames = sorted(
            pathlib.Path(args.sequ_path).glob(f"frame_*.{args.ovf_ext}")
        )
    if not frames:
        raise SystemExit(f"no frame_*.{args.ovf_ext} in {args.sequ_path}")

    def load_frame(fp):
        return fp() if callable(fp) else dict(np.load(fp))

    stereo_ref = None
    if args.stereoRef:
        from matchinglib_poselib_tpu.models.stereo_refine import StereoRefine

        first = load_frame(frames[0])
        stereo_ref = StereoRefine(
            first["K1"], first["K2"],
            dist1=first.get("dist1"), dist2=first.get("dist2"),
            cfg=common.stereo_refine_config(args, pose_cfg, kneip_iba),
        )

    out = pathlib.Path(args.output_path)
    out.mkdir(parents=True, exist_ok=True)
    csv_path = out / "results.csv"
    key = jax.random.PRNGKey(0)
    accum: list = []

    # Warm-up: run frame 0 once through a throwaway evaluation so JIT
    # compilation does not pollute the stage-timing columns of the real run
    # (round-2 CSVs had robEstimationAndRef_ms=130038 on row 0). All jitted
    # entry points are module-level, so a scratch StereoRefine instance
    # shares the compile cache with the real one.
    if not args.no_warmup:
        warm_ref = None
        if stereo_ref is not None:
            from matchinglib_poselib_tpu.models.stereo_refine import (
                StereoRefine,
            )

            first = load_frame(frames[0])
            warm_ref = StereoRefine(
                first["K1"], first["K2"],
                dist1=first.get("dist1"), dist2=first.get("dist2"),
                cfg=common.stereo_refine_config(args, pose_cfg, kneip_iba),
            )
        evaluate_frame(
            load_frame(frames[0]), pose_cfg, warm_ref, args,
            jax.random.fold_in(key, 0), 0, accum=None,
        )
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS, delimiter=";")
        w.writeheader()
        for i, fp in enumerate(frames):
            frame = load_frame(fp)
            row = evaluate_frame(
                frame, pose_cfg, stereo_ref, args,
                jax.random.fold_in(key, i), i, accum=accum,
            )
            w.writerow(row)
            if args.v > 0:
                print(
                    f"frame {i}: R_diffAll={row['R_diffAll']} "
                    f"t_angDiff={row['t_angDiff_deg']} state={row['state']}"
                )
    print(f"wrote {csv_path} ({len(frames)} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
