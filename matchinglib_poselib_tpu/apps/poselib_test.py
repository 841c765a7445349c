"""Pose-estimation CLI (reference: tests/poselib-test/main.cpp).

Full pipeline on a KITTI-calibrated stereo sequence: correspondences,
robust relative pose (USAC/RANSAC/ARRSAC/LMEDS, --autoTH, --Halign),
linear refinement (--refineRT), bundle adjustment (--BART), pose
comparison against the calibration extrinsics (--compInitPose),
rectification output (--showRect — saved to --output_path instead of an
on-screen display). ``--stereoRef`` switches to the StereoRefine
streaming framework (main.cpp:1389-1432).

Usage:
    python -m matchinglib_poselib_tpu.apps.poselib_test \
        --img_path <dir> --c_file calib_cam_to_cam.txt --compInitPose
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from matchinglib_poselib_tpu.apps import common
from matchinglib_poselib_tpu.utils import io


def build_parser():
    p = argparse.ArgumentParser(
        prog="poselib-test",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_matching_options(p)
    common.add_pose_options(p)
    common.add_stereo_refine_options(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from matchinglib_poselib_tpu.models import pipeline
    from matchinglib_poselib_tpu.ops import geometry as geo, rectify

    det, desc, match = common.matching_configs(args)
    pose_cfg, kneip_iba = common.pose_config(args)
    timer = common.StageTimer(args.v)

    img_dir = pathlib.Path(args.img_path)
    calib = io.load_kitti_calib(img_dir / args.c_file)
    K1 = jnp.asarray(calib.K0, jnp.float32)
    K2 = jnp.asarray(calib.K1, jnp.float32)
    nd = args.distcoeffNr
    d1 = jnp.asarray(np.r_[calib.dist0[:nd], np.zeros(max(0, 5 - nd))],
                     jnp.float32)
    d2 = jnp.asarray(np.r_[calib.dist1[:nd], np.zeros(max(0, 5 - nd))],
                     jnp.float32)

    pairs = io.load_stereo_sequence(
        args.img_path, args.l_img_pref, args.r_img_pref
    )[:: max(1, args.stepSize)]
    if not pairs:
        raise SystemExit(f"no stereo pairs in {args.img_path}")

    out_dir = pathlib.Path(args.output_path) if args.output_path else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    stereo_ref = None
    if args.stereoRef:
        from matchinglib_poselib_tpu.models.stereo_refine import StereoRefine

        stereo_ref = StereoRefine(
            np.asarray(calib.K0), np.asarray(calib.K1),
            np.asarray(calib.dist0[:5]), np.asarray(calib.dist1[:5]),
            cfg=common.stereo_refine_config(args, pose_cfg, kneip_iba),
        )

    key = jax.random.PRNGKey(0)
    results = []
    for i, (lp, rp) in enumerate(pairs):
        img1 = jnp.asarray(io.load_image_gray(lp))
        img2 = jnp.asarray(io.load_image_gray(rp))
        if args.histEqual:
            # histogram equalization via sorted-rank mapping (the
            # reference uses cv::equalizeHist before matching)
            def eq(im):
                flat = im.ravel()
                ranks = jnp.argsort(jnp.argsort(flat))
                return (ranks.astype(jnp.float32) / flat.size).reshape(im.shape)

            img1, img2 = eq(img1), eq(img2)

        timer.start("correspondences")
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        timer.stop()

        if stereo_ref is not None:
            timer.start("stereoRefine")
            fr = stereo_ref.add_new_correspondences(
                np.asarray(corr.pts1), np.asarray(corr.pts2),
                np.asarray(corr.mask), np.asarray(corr.quality),
                desc_dist=np.asarray(corr.distance),
            )
            timer.stop()
            R, t = np.asarray(fr.R), np.asarray(fr.t)
            if args.useMostLikelyPose and fr.most_likely_pose_stable:
                R = np.asarray(fr.R_most_likely)
                t = np.asarray(fr.t_most_likely)
            rec = {
                "frame": i,
                "state": fr.state,
                "inlier_ratio": round(float(fr.inlier_ratio), 4),
                "pool_size": int(fr.pool_size),
                "stable": bool(fr.pose_is_stable),
            }
        else:
            timer.start("pose")
            pose = pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                K1, K2, d1, d2, pose_cfg, jax.random.fold_in(key, i),
            )
            timer.stop()
            R, t = np.asarray(pose.R), np.asarray(pose.t)
            rec = {
                "frame": i,
                "n_matches": int(corr.n),
                "n_inliers": int(pose.n_inliers),
                "inlier_ratio": round(float(pose.inlier_ratio), 4),
                "degenerate": bool(pose.is_degenerate),
            }
            if args.v > 0:
                # UsacResults counter parity (USAC.h:18-60)
                rec["usac"] = {
                    "models_generated": int(pose.n_models_generated),
                    "models_rejected": int(pose.n_models_rejected),
                    "points_verified": int(pose.n_points_verified),
                    "lo_refinements": int(pose.n_lo_refinements),
                }

        if args.compInitPose and not args.noPoseDiff:
            rd, td, tdist = geo.compare_poses(
                jnp.asarray(calib.R, jnp.float32),
                jnp.asarray(calib.t / np.linalg.norm(calib.t), jnp.float32),
                jnp.asarray(R), jnp.asarray(t),
            )
            rec["R_diff_deg"] = round(float(rd), 4)
            rec["t_angDiff_deg"] = round(float(td), 4)
        print(json.dumps(rec))
        results.append(rec)

        if args.showRect and out_dir is not None:
            rect = rectify.get_rectification_parameters(
                K1, K2, jnp.asarray(R, jnp.float32),
                jnp.asarray(t, jnp.float32), d1, d2, img1.shape,
            )
            r1 = rectify.rectified_image(
                img1, K1, d1, rect.R1, rect.K_new1, img1.shape
            )
            r2 = rectify.rectified_image(
                img2, K2, d2, rect.R2, rect.K_new2, img2.shape
            )
            from matchinglib_poselib_tpu.utils import visualize

            for name, arr in (("rect_left", r1), ("rect_right", r2)):
                visualize.write_png(
                    out_dir / f"{name}_{i:04d}.png",
                    (np.clip(np.asarray(arr), 0, 1) * 255).astype(np.uint8),
                )
            # ShowRectifiedImages parity (pose_helper.cpp:2636): stacked
            # pair with epipolar scan lines for visual verification
            visualize.write_png(
                out_dir / f"rect_pair_{i:04d}.png",
                visualize.draw_rectified_pair(
                    np.asarray(r1), np.asarray(r2)
                ),
            )

    summary = {
        "frames": len(results),
        "stage_ms": {k: round(v, 2) for k, v in timer.stages.items()},
    }
    if args.compInitPose and results and "R_diff_deg" in results[0]:
        summary["R_diff_deg_median"] = round(
            float(np.median([r["R_diff_deg"] for r in results])), 4
        )
        summary["t_angDiff_deg_median"] = round(
            float(np.median([r["t_angDiff_deg"] for r in results])), 4
        )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
