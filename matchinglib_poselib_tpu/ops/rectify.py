"""Stereo rectification and rectified-image generation.

Batched equivalent of the reference's rectification layer (SURVEY.md P13,
all in poselib/source/pose_helper.cpp):

- getRectificationParameters (:1366) — dispatch + validation
- rectifyFusiello (:1459) — Fusiello-Trucco-Verri general-rig rectification
- stereoRectify2 / cvStereoRectify2 (:1900,1979) — robustified OpenCV-style
  rectification with disparity-to-depth Q matrix
- estimateOptimalFocalScale (:2561) — focal scale search keeping the
  rectified field of view tight
- ShowRectifiedImages / GetRectifiedImages (:2636,2775) — undistort+rectify
  remap of the input images

Both classic algorithms reduce to the same construction here: a common
rotation whose x-axis is the baseline, new shared intrinsics, per-camera
rectifying rotations R1 = Rn and R2 = Rn R^T (world = camera-1 frame,
x2 = R x1 + t). The remap is a dense gather — pure elementwise work, batched over
all output pixels at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as geo


class Rectification(NamedTuple):
    R1: jax.Array  # (3, 3) rectifying rotation, camera 1
    R2: jax.Array  # (3, 3) rectifying rotation, camera 2
    K_new1: jax.Array  # (3, 3) new intrinsics, camera 1
    K_new2: jax.Array  # (3, 3) new intrinsics, camera 2
    P1: jax.Array  # (3, 4) new projection, camera 1
    P2: jax.Array  # (3, 4) new projection, camera 2
    Q: jax.Array  # (4, 4) disparity-to-depth mapping
    baseline: jax.Array  # scalar |c2 - c1|


def _rectifying_rotation(R: jax.Array, t: jax.Array) -> jax.Array:
    """Common rotation with x-axis along the baseline (Fusiello step).

    World frame = camera 1. Optical center of cam2: c2 = -R^T t. Rows:
    r1 = baseline direction, r2 = z_old x r1, r3 = r1 x r2.
    """
    c2 = -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    r1 = geo.normalize_vec(c2)
    # keep rectified x pointing roughly along old +x so images stay upright
    r1 = r1 * jnp.where(r1[..., 0:1] < 0, -1.0, 1.0)
    z_old = jnp.asarray([0.0, 0.0, 1.0], R.dtype)
    r2 = geo.normalize_vec(jnp.cross(z_old, r1))
    r3 = jnp.cross(r1, r2)
    return jnp.stack([r1, r2, r3], axis=-2)


@jax.jit
def rectify_fusiello(
    K1: jax.Array, K2: jax.Array, R: jax.Array, t: jax.Array
) -> Rectification:
    """Fusiello-Trucco-Verri rectification (pose_helper.cpp:1459).

    New shared intrinsics = mean of the inputs with zero skew (the
    reference's choice); both cameras get the common baseline-aligned
    rotation.
    """
    Rn = _rectifying_rotation(R, t)
    Kn = 0.5 * (K1 + K2)
    Kn = Kn.at[0, 1].set(0.0)
    c2 = -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    baseline = jnp.linalg.norm(c2)

    R1 = Rn
    R2 = Rn @ jnp.swapaxes(R, -1, -2)
    P1 = Kn @ jnp.concatenate([Rn, jnp.zeros((3, 1), R.dtype)], axis=1)
    P2 = Kn @ jnp.concatenate([Rn, -(Rn @ c2)[:, None]], axis=1)

    f = Kn[0, 0]
    cx, cy = Kn[0, 2], Kn[1, 2]
    Tx = -baseline
    Q = jnp.asarray(
        [
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
        ],
        R.dtype,
    )
    Q = Q.at[0, 3].set(-cx)
    Q = Q.at[1, 3].set(-cy)
    Q = Q.at[2, 3].set(f)
    Q = Q.at[3, 2].set(-1.0 / Tx)
    return Rectification(
        R1=R1, R2=R2, K_new1=Kn, K_new2=Kn, P1=P1, P2=P2, Q=Q,
        baseline=baseline,
    )


@jax.jit
def estimate_vergence(
    R: jax.Array,
    RR1: jax.Array,
    RR2: jax.Array,
    PR1: jax.Array,
    PR2: jax.Array,
) -> jax.Array:
    """Vergence (correspondence-search start shift, in pixels) of a
    rectified rig (estimateVergence, pose_helper.cpp:2505-2535).

    R: cam1->cam2 rotation; RR1/RR2: rectifying rotations; PR1/PR2:
    (3, 4) rectified projection matrices (camera 1 centred at the
    origin). Projects camera-2's viewing direction (the last row of R)
    through both rectified cameras; the x-disparity of those projections
    is the epipolar search offset. Returns ceil(1.1 * vergence) as an
    int32 scalar (0 when the rig has no vergence — parallel axes).
    """
    a = R[2, :]  # cam2 z-axis expressed in cam1 coords
    K1 = PR1[:, :3]
    K2 = PR2[:, :3]
    ar1 = K1 @ (RR1 @ a)
    ar2 = K2 @ RR2[:, 2]
    ar1 = ar1 / jnp.where(jnp.abs(ar1[2]) > 1e-12, ar1[2], 1.0)
    ar2 = ar2 / jnp.where(jnp.abs(ar2[2]) > 1e-12, ar2[2], 1.0)
    vergence = ar1[0] - ar2[0]
    out = jnp.ceil(1.1 * vergence)
    return jnp.where(jnp.abs(vergence) < 1e-6, 0.0, out).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("img_hw", "zero_disparity"))
def stereo_rectify(
    K1: jax.Array,
    K2: jax.Array,
    R: jax.Array,
    t: jax.Array,
    img_hw: tuple[int, int],
    focal_scale: jax.Array | float = 1.0,
    zero_disparity: bool = True,
) -> Rectification:
    """OpenCV-compatible rectification (stereoRectify2, pose_helper.cpp:1900).

    Same geometric construction as Fusiello; the new focal length is the
    mean focal scaled by ``focal_scale`` (the reference's
    estimateOptimalFocalScale result) and the principal point is recentred
    so the original image centers stay centred after rotation.

    zero_disparity=True shares the horizontal principal point
    (CALIB_ZERO_DISPARITY: a point at infinity has zero disparity);
    False keeps per-camera cx (the reference engine's convention, where
    the infinite-depth disparity offset is reported by estimate_vergence
    as the correspondence-search start shift).
    """
    H, W = img_hw
    Rn = _rectifying_rotation(R, t)
    c2 = -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    baseline = jnp.linalg.norm(c2)

    f = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) * focal_scale

    R1 = Rn
    R2 = Rn @ jnp.swapaxes(R, -1, -2)

    # recentre: map each original center through its rectifying rotation
    def center_after(Kc, Rrect):
        c = jnp.asarray([0.5 * (W - 1), 0.5 * (H - 1), 1.0], R.dtype)
        ray = jnp.linalg.inv(Kc) @ c
        r = Rrect @ ray
        return r[:2] / jnp.maximum(r[2], 1e-9)

    c1n = center_after(K1, R1)
    c2n = center_after(K2, R2)
    # shared vertical center (rows must align), per-camera horizontal
    cy = 0.5 * (H - 1) - f * 0.5 * (c1n[1] + c2n[1])
    cx1 = 0.5 * (W - 1) - f * c1n[0]
    cx2 = 0.5 * (W - 1) - f * c2n[0]
    if zero_disparity:
        # share cx (simple Q form, zero disparity at infinity)
        cx1 = cx2 = 0.5 * (cx1 + cx2)

    def mkK(cxv):
        z = jnp.zeros((), R.dtype)
        one = jnp.ones((), R.dtype)
        return jnp.stack(
            [
                jnp.stack([f, z, cxv]),
                jnp.stack([z, f, cy]),
                jnp.stack([z, z, one]),
            ]
        )

    Kn1 = mkK(cx1)
    Kn2 = mkK(cx2)
    P1 = Kn1 @ jnp.concatenate([Rn, jnp.zeros((3, 1), R.dtype)], axis=1)
    P2 = Kn2 @ jnp.concatenate([Rn, -(Rn @ c2)[:, None]], axis=1)

    Tx = -baseline
    Q = jnp.zeros((4, 4), R.dtype)
    Q = Q.at[0, 0].set(1.0)
    Q = Q.at[1, 1].set(1.0)
    Q = Q.at[0, 3].set(-cx1)
    Q = Q.at[1, 3].set(-cy)
    Q = Q.at[2, 3].set(f)
    Q = Q.at[3, 2].set(-1.0 / Tx)
    # disparity of a point at infinity (OpenCV Q[3,3] term; zero in the
    # shared-cx convention)
    Q = Q.at[3, 3].set((cx1 - cx2) / Tx)
    return Rectification(
        R1=R1, R2=R2, K_new1=Kn1, K_new2=Kn2, P1=P1, P2=P2, Q=Q,
        baseline=baseline,
    )


@functools.partial(jax.jit, static_argnames=("img_hw", "n_candidates"))
def optimal_focal_scale(
    K1: jax.Array,
    K2: jax.Array,
    R: jax.Array,
    t: jax.Array,
    dist1: jax.Array,
    dist2: jax.Array,
    img_hw: tuple[int, int],
    n_candidates: int = 33,
) -> jax.Array:
    """Largest focal scale whose rectified view stays inside both sources.

    Reference: estimateOptimalFocalScale (pose_helper.cpp:2561) searches a
    scale for the new camera matrix; here a fixed grid of candidate scales
    is scored in one batch (all remap grids computed together) and the
    best in-bounds fraction wins — static shapes, no line search.
    """
    H, W = img_hw
    scales = jnp.linspace(0.5, 2.0, n_candidates).astype(K1.dtype)

    # border sample points of the output image (fixed ring of 64 points)
    n_b = 16
    xs = jnp.linspace(0.0, W - 1.0, n_b)
    ys = jnp.linspace(0.0, H - 1.0, n_b)
    border = jnp.concatenate(
        [
            jnp.stack([xs, jnp.zeros_like(xs)], axis=1),
            jnp.stack([xs, jnp.full_like(xs, H - 1.0)], axis=1),
            jnp.stack([jnp.zeros_like(ys), ys], axis=1),
            jnp.stack([jnp.full_like(ys, W - 1.0), ys], axis=1),
        ]
    ).astype(K1.dtype)

    rect = stereo_rectify(K1, K2, R, t, img_hw, 1.0)

    def frac_inside(scale):
        def one_cam(Kc, distc, Rrect):
            f = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) * scale
            Kn = rect.K_new1.at[0, 0].set(f).at[1, 1].set(f)
            src = rectify_source_coords(border, Kc, distc, Rrect, Kn)
            ok = (
                (src[:, 0] >= 0) & (src[:, 0] <= W - 1)
                & (src[:, 1] >= 0) & (src[:, 1] <= H - 1)
            )
            return jnp.mean(ok.astype(K1.dtype))

        return jnp.minimum(
            one_cam(K1, dist1, rect.R1), one_cam(K2, dist2, rect.R2)
        )

    fracs = jax.vmap(frac_inside)(scales)
    # prefer the largest scale (tightest FOV crop) that keeps >=99% inside;
    # fall back to the best-covered scale
    good = fracs >= 0.99
    best_covered = scales[jnp.argmax(fracs)]
    largest_good = jnp.max(jnp.where(good, scales, -jnp.inf))
    return jnp.where(jnp.any(good), largest_good, best_covered)


def rectify_source_coords(out_px, K, dist, Rrect, K_new):
    """Output rectified pixels -> source image pixels (one camera).

    out_px: (N, 2). Inverse mapping used by initUndistortRectifyMap:
    ray = Rrect^T @ K_new^-1 @ p, normalize to z = 1, apply forward
    distortion, then the original K.
    """
    h = geo.to_homogeneous(out_px)
    rays = h @ jnp.linalg.inv(K_new).T @ Rrect  # rows: Rrect^T Kn^-1 p
    xn = rays[..., :2] / jnp.maximum(jnp.abs(rays[..., 2:]), 1e-9) * jnp.sign(
        rays[..., 2:]
    )
    xd = geo.distort_oulu(xn, dist)
    return geo.cam_to_img(xd, K)


@functools.partial(jax.jit, static_argnames=("out_hw",))
def rectified_image(
    img: jax.Array,  # (H, W) grayscale
    K: jax.Array,
    dist: jax.Array,
    Rrect: jax.Array,
    K_new: jax.Array,
    out_hw: tuple[int, int],
) -> jax.Array:
    """Undistort + rectify remap with bilinear sampling.

    Reference: GetRectifiedImages (pose_helper.cpp:2775) via
    cv::initUndistortRectifyMap + remap; here the sampling grid and the
    gather run fused on device.
    """
    Ho, Wo = out_hw
    H, W = img.shape
    yy, xx = jnp.meshgrid(
        jnp.arange(Ho, dtype=img.dtype), jnp.arange(Wo, dtype=img.dtype),
        indexing="ij",
    )
    out_px = jnp.stack([xx.ravel(), yy.ravel()], axis=1)
    src = rectify_source_coords(out_px, K, dist, Rrect, K_new)
    sx = src[:, 0]
    sy = src[:, 1]
    x0 = jnp.clip(jnp.floor(sx), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(sy), 0, H - 2).astype(jnp.int32)
    fx = jnp.clip(sx - x0, 0.0, 1.0)
    fy = jnp.clip(sy - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    val = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    # half-pixel tolerance: borderline float error must not blank edge rows
    inside = (sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5) & (sy <= H - 0.5)
    return jnp.where(inside, val, 0.0).reshape(Ho, Wo)


def get_rectification_parameters(
    K1, K2, R, t, dist1, dist2, img_hw, use_fusiello: bool = False
) -> Rectification:
    """Top-level dispatch (getRectificationParameters pose_helper.cpp:1366):
    optimal focal scale + the chosen rectification construction."""
    if use_fusiello:
        return rectify_fusiello(K1, K2, R, t)
    scale = optimal_focal_scale(K1, K2, R, t, dist1, dist2, img_hw)
    return stereo_rectify(K1, K2, R, t, img_hw, scale)
