"""Minimal library usage example (A4 parity, source/examples/).

Match one stereo pair and estimate its relative pose in ~20 lines —
the JAX counterpart of the reference's matchinglibcmd example.

Run:  python examples/match_and_pose.py [image_dir]
(defaults to the reference's bundled KITTI stereo pair)
"""

import pathlib
import sys

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import (
    DescriptorConfig, DetectorConfig, MatchingConfig, PoseConfig,
)
from matchinglib_poselib_tpu.models import pipeline
from matchinglib_poselib_tpu.utils import io

d = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                 "/root/reference/matchinglib_poselib/source/tests/"
                 "poselib-test/imgs/stereo")
img1 = jnp.asarray(io.load_image_gray(next(iter(sorted(d.glob("left_*"))))))
img2 = jnp.asarray(io.load_image_gray(next(iter(sorted(d.glob("right_*"))))))
calib = io.load_kitti_calib(d / "calib_cam_to_cam.txt")

corr = pipeline.get_correspondences(
    img1, img2,
    DetectorConfig(kind="FAST", max_keypoints=2048),
    DescriptorConfig(kind="ORB"),
    MatchingConfig(matcher_name="GMBSOF"),
)
print(f"{int(corr.n)} matches")

res = pipeline.estimate_pose(
    corr.pts1, corr.pts2, corr.mask, corr.quality,
    jnp.asarray(calib.K0, jnp.float32), jnp.asarray(calib.K1, jnp.float32),
    jnp.asarray(calib.dist0, jnp.float32), jnp.asarray(calib.dist1, jnp.float32),
    PoseConfig(), jax.random.PRNGKey(0),
)
print("R =", res.R, "\nt =", res.t, f"\n{int(res.n_inliers)} inliers", sep="")
