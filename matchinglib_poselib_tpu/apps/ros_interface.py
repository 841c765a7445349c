"""ROS interface: continuous matching + pose estimation node (A5 parity).

The reference ships a separate repo (matchinglib_poselib_ros,
README.md:769-777) whose node continuously reads stereo images,
calculates matches and poses with the library, and exposes every
pipeline option through a launch file plus dynamic-reconfigure updates
at runtime. This module is that interface for this framework:

- ``params_to_configs``: the launch-file / dynamic-reconfigure flat
  parameter namespace -> the typed config tree (config.py). Parameter
  names follow the reference executables' option names (poselib-test
  main.cpp defineOption list) so launch files translate one-to-one.
- ``MatchingPoselibNode``: the node object. ``handle_stereo_pair`` is
  the image callback (usable directly in headless environments);
  ``reconfigure`` applies a dynamic-reconfigure delta, rebuilding the
  compiled pipeline only when a *static* config actually changed;
  streaming mode maintains a ``StereoRefine`` instance and surfaces the
  reference's stability outputs (R_new/t_new/poseIsStable,
  R_mostLikely/t_mostLikely/mostLikelyPose_stable,
  stereo_pose_refinement.h:127-176).
- When ``rospy`` exists, ``spin()`` wires the callback to image topics;
  ROS itself is optional — everything else works without it (this is
  deliberate: the compute node is the framework, ROS is transport).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax

from matchinglib_poselib_tpu.config import (
    BAConfig,
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
    RefinementConfig,
    RobustConfig,
)
from matchinglib_poselib_tpu.models import pipeline as _pipeline


#: launch-file parameter namespace -> config field, with casts.
#: Names mirror the reference executables' options (poselib-test
#: main.cpp: --f_detect/--d_extr/--matcher/--nrFeatures/--subPixRef/
#: --RobMethod/--th/--refineRT/--BART ...).
_PARAM_SCHEMA = {
    "f_detect": ("det", "kind", str),
    "d_extr": ("desc", "kind", str),
    "matcher": ("match", "matcher_name", str),
    "nrFeatures": ("det", "max_keypoints", int),
    "f_detect_th": ("det", "fast_threshold", float),
    "subPixRef": ("match", "subpix_refine", lambda v: bool(int(v))),
    "ratioTest": ("match", "ratio_test", lambda v: bool(int(v))),
    "DynKeyP": (None, None, None),  # accepted, implied by grid top-k
    "th": ("robust", "threshold_px", float),
    "RobMethod": ("robust", "estimator_name", str),
    "batch_hypotheses": ("robust", "batch_hypotheses", int),
    "max_batches": ("robust", "max_batches", int),
    "refineRT": ("refine", "refine_rt_code", str),
    "BART": ("ba", "enabled", lambda v: bool(int(v))),
    "stereoRef": ("node", "stereo_ref", lambda v: bool(int(v))),
    "evStepStereoStable": ("node", "ev_step_stable", int),
    "useMostLikelyPose": ("node", "use_most_likely", lambda v: bool(int(v))),
}


def params_to_configs(params: dict) -> dict:
    """Flat launch/dynamic-reconfigure params -> typed config tree."""
    groups = {
        "det": {},
        "desc": {},
        "match": {},
        "robust": {},
        "refine": {},
        "ba": {},
        "node": {},
    }
    for name, value in params.items():
        if name not in _PARAM_SCHEMA:
            raise KeyError(f"unknown parameter '{name}'")
        group, field, cast = _PARAM_SCHEMA[name]
        if group is None:
            continue
        groups[group][field] = cast(value)

    # RobMethod -> estimator enum (same names as the reference menu)
    rb = groups["robust"]
    if "estimator_name" in rb:
        from matchinglib_poselib_tpu.config import PoseEstimator

        rb["estimator"] = PoseEstimator(rb.pop("estimator_name"))
    # refineRT two-digit code (poselib-test --refineRT, main.cpp:339-354):
    # first digit = refinement algorithm (incl. Kneip-instead-BA on 6),
    # second digit = weighting function — same tables as the CLI
    rf = groups["refine"]
    node = groups.pop("node")
    if "refine_rt_code" in rf:
        from matchinglib_poselib_tpu.apps.common import (
            _REFINE_ALG,
            _REFINE_W,
        )

        code = (rf.pop("refine_rt_code") + "22")[:2]
        enabled, solver, kneip_iba = _REFINE_ALG.get(
            code[0], (True, None, False)
        )
        rf["enabled"] = enabled
        if solver is not None:
            rf["solver"] = solver
        if code[1] in _REFINE_W:
            rf["weights"] = _REFINE_W[code[1]]
        node["kneip_instead_ba"] = kneip_iba
    det = DetectorConfig(**groups["det"])
    desc = DescriptorConfig(**groups["desc"])
    match = MatchingConfig(**groups["match"])
    pose = PoseConfig(
        robust=RobustConfig(**groups["robust"]),
        refine=RefinementConfig(**groups["refine"]),
        ba=BAConfig(**groups["ba"]),
    )
    return {"det": det, "desc": desc, "match": match, "pose": pose,
            "node": node}


@dataclasses.dataclass
class PoseMsg:
    """Published pose (reference node publishes R/t + stability flags)."""

    R: np.ndarray
    t: np.ndarray
    n_inliers: int
    inlier_ratio: float
    pose_is_stable: bool = False
    R_most_likely: np.ndarray | None = None
    t_most_likely: np.ndarray | None = None
    most_likely_stable: bool = False


class MatchingPoselibNode:
    """Continuous stereo matching + pose node.

    The transport-free core of the reference's ROS node: feed stereo
    frames through ``handle_stereo_pair``, read ``PoseMsg`` results;
    ``reconfigure`` mirrors dynamic_reconfigure (recompiles only when a
    static config changed). With rospy present, ``spin()`` subscribes to
    the image topics from the launch parameters.
    """

    def __init__(self, params: dict | None = None,
                 on_pose: Callable[[PoseMsg], None] | None = None):
        self._params = dict(params or {})
        self._on_pose = on_pose
        self._frame_idx = 0
        self._last_eval_idx = 0
        self._last_msg: PoseMsg | None = None
        self._calib = None
        self._rebuild()

    # -- configuration -------------------------------------------------
    def _rebuild(self):
        cfg = params_to_configs(self._params)
        self._det, self._desc = cfg["det"], cfg["desc"]
        self._match, self._pose = cfg["match"], cfg["pose"]
        self._node = cfg["node"]
        self._refine = None  # lazily built once calibration is known
        self._key = jax.random.PRNGKey(0)

    def reconfigure(self, changes: dict):
        """dynamic_reconfigure callback: apply a parameter delta."""
        new = dict(self._params)
        new.update(changes)
        if new != self._params:
            self._params = new
            self._rebuild()

    def set_calibration(self, K1, K2, dist1, dist2):
        import jax.numpy as jnp

        self._calib = tuple(
            jnp.asarray(a, jnp.float32) for a in (K1, K2, dist1, dist2)
        )
        self._refine = None

    # -- data path ------------------------------------------------------
    def handle_stereo_pair(self, img_left, img_right) -> PoseMsg:
        """Image callback: match + estimate pose on one stereo frame."""
        import jax.numpy as jnp

        if self._calib is None:
            raise RuntimeError("set_calibration() before streaming frames")
        # evStepStereoStable (reference node parameter): once the stereo
        # pose is stable, re-evaluate it only every n-th frame and
        # republish the held pose in between (0 = evaluate every frame)
        ev_step = int(self._node.get("ev_step_stable", 0) or 0)
        if (
            self._node.get("stereo_ref")
            and ev_step > 0
            and self._refine is not None
            and self._refine.pose_is_stable
            and self._last_msg is not None
            and (self._frame_idx - self._last_eval_idx) < ev_step
        ):
            self._frame_idx += 1
            if self._on_pose is not None:
                self._on_pose(self._last_msg)
            return self._last_msg

        K1, K2, d1, d2 = self._calib
        i1 = jnp.asarray(np.asarray(img_left, np.float32))
        i2 = jnp.asarray(np.asarray(img_right, np.float32))
        corr = _pipeline.get_correspondences(
            i1, i2, self._det, self._desc, self._match
        )
        key = jax.random.fold_in(self._key, self._frame_idx)
        self._frame_idx += 1
        self._last_eval_idx = self._frame_idx

        if self._node.get("stereo_ref"):
            from matchinglib_poselib_tpu.config import StereoRefineConfig
            from matchinglib_poselib_tpu.models.stereo_refine import (
                StereoRefine,
            )

            if self._refine is None:
                kiba = bool(self._node.get("kneip_instead_ba", False))
                self._refine = StereoRefine(
                    np.asarray(K1), np.asarray(K2),
                    np.asarray(d1), np.asarray(d2),
                    cfg=StereoRefineConfig(
                        pose=self._pose,
                        kneip_instead_ba=kiba,
                        kneip_instead_ba_pool=kiba,
                    ),
                )
            st = self._refine.add_new_correspondences(
                np.asarray(corr.pts1), np.asarray(corr.pts2),
                np.asarray(corr.mask), np.asarray(corr.quality),
            )
            use_ml = self._node.get("use_most_likely", False)
            R = st.R_most_likely if use_ml else st.R
            t = st.t_most_likely if use_ml else st.t
            msg = PoseMsg(
                R=np.asarray(R, np.float64),
                t=np.asarray(t, np.float64),
                n_inliers=int(st.pool_size),
                inlier_ratio=float(st.inlier_ratio),
                pose_is_stable=bool(st.pose_is_stable),
                R_most_likely=np.asarray(st.R_most_likely, np.float64),
                t_most_likely=np.asarray(st.t_most_likely, np.float64),
                most_likely_stable=bool(st.most_likely_pose_stable),
            )
        else:
            res = _pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                K1, K2, d1, d2, self._pose, key,
            )
            msg = PoseMsg(
                R=np.asarray(res.R, np.float64),
                t=np.asarray(res.t, np.float64),
                n_inliers=int(res.n_inliers),
                inlier_ratio=float(res.inlier_ratio),
            )
        self._last_msg = msg
        if self._on_pose is not None:
            self._on_pose(msg)
        return msg

    # -- optional ROS transport -----------------------------------------
    def spin(self, left_topic="/stereo/left/image_raw",
             right_topic="/stereo/right/image_raw"):
        """Subscribe to image topics and stream (requires rospy)."""
        try:
            import message_filters
            import rospy
            from sensor_msgs.msg import Image
        except ImportError as e:  # transport optional by design
            raise RuntimeError(
                "rospy not available — drive handle_stereo_pair() directly"
            ) from e

        rospy.init_node("matchinglib_poselib_tpu")

        def _to_gray(msg: Image) -> np.ndarray:
            buf = np.frombuffer(msg.data, np.uint8)
            img = buf.reshape(msg.height, msg.step)[:, : msg.width]
            return img.astype(np.float32) / 255.0

        def cb(lmsg, rmsg):
            self.handle_stereo_pair(_to_gray(lmsg), _to_gray(rmsg))

        subs = [
            message_filters.Subscriber(left_topic, Image),
            message_filters.Subscriber(right_topic, Image),
        ]
        message_filters.TimeSynchronizer(subs, queue_size=4).registerCallback(
            cb
        )
        rospy.spin()
