"""Pyramidal Lucas-Kanade optical flow + LK-guided matchers.

Batched equivalent of the reference's M16 (SURVEY.md):

- calc_opticalFlow (match_opticalflow.cpp:28-67): cv::calcOpticalFlowPyrLK
  with 3 pyramid levels, 21x21 window, 20 iterations, eps 0.013.
- getMatches_OpticalFlow / LKOF (match_opticalflow.cpp:71-148): LK-predict
  each previous keypoint into the next image, match = nearest next
  keypoint within searchRadius_px (spatial only).
- getMatches_OpticalFlowAdvanced / ALKOF (:150-205): among the spatial
  neighbors inside the radius, pick the minimum-Hamming descriptor with
  hamming < maxHammDist. (The reference limits candidates to k spatial
  NN for CPU speed; here ALL candidates inside the radius compete —
  equal-or-better recall, same acceptance rule.)
- getMatches_OpticalFlowTracker / LKOFT, ALKOFT (:209+): the tracked
  (flow-predicted) positions themselves become the next keypoints.

All keypoints advance in one batch: window gathers, structure tensors,
and the iterative LK updates are vmapped arrays; the pyramid walk and the
LK iterations are static loops (fixed shapes, jit-friendly).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import matching


class FlowResult(NamedTuple):
    pts: jax.Array  # (N, 2) predicted positions in the next image
    status: jax.Array  # (N,) bool — tracking succeeded
    err: jax.Array  # (N,) mean absolute window residual


def _blur_downsample(img: jax.Array) -> jax.Array:
    """5-tap binomial blur + 2x decimation (one pyramid level down)."""
    k = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], img.dtype) / 16.0

    def conv1d(x, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (2, 2)
        xp = jnp.pad(x, pad, mode="edge")
        out = jnp.zeros_like(x)
        for i in range(5):
            sl = [slice(None), slice(None)]
            sl[axis] = slice(i, i + x.shape[axis])
            out = out + k[i] * xp[tuple(sl)]
        return out

    sm = conv1d(conv1d(img, 0), 1)
    return sm[::2, ::2]


def gaussian_pyramid(img: jax.Array, levels: int):
    """[level0 = img, level1 = half, ...] — finest first."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_blur_downsample(pyr[-1]))
    return pyr


def _window_offsets(win: int, dtype):
    o = jnp.arange(win, dtype=dtype) - (win - 1) / 2.0
    return o


def _sample_windows(img, cx, cy, win):
    """(N,) centers -> (N, win, win) bilinear windows (pitch 1px)."""
    H, W = img.shape
    offs = _window_offsets(win, img.dtype)
    gx = cx[:, None, None] + offs[None, None, :]
    gy = cy[:, None, None] + offs[None, :, None]
    x0 = jnp.clip(jnp.floor(gx), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(gy), 0, H - 2).astype(jnp.int32)
    fx = jnp.clip(gx - x0, 0.0, 1.0)
    fy = jnp.clip(gy - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _lk_level(img_prev, img_next, pts, flow, win, iters, eps):
    """One pyramid level of LK: refine ``flow`` for every point."""
    cx, cy = pts[:, 0], pts[:, 1]
    # template and its gradients (central differences on bilinear samples)
    T = _sample_windows(img_prev, cx, cy, win)
    Ix = 0.5 * (
        _sample_windows(img_prev, cx + 1.0, cy, win)
        - _sample_windows(img_prev, cx - 1.0, cy, win)
    )
    Iy = 0.5 * (
        _sample_windows(img_prev, cx, cy + 1.0, win)
        - _sample_windows(img_prev, cx, cy - 1.0, win)
    )
    gxx = jnp.sum(Ix * Ix, axis=(1, 2))
    gxy = jnp.sum(Ix * Iy, axis=(1, 2))
    gyy = jnp.sum(Iy * Iy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-12
    det_safe = jnp.where(inv_ok, det, 1.0)

    def body(_, flow):
        S = _sample_windows(
            img_next, cx + flow[:, 0], cy + flow[:, 1], win
        )
        d = T - S
        bx = jnp.sum(Ix * d, axis=(1, 2))
        by = jnp.sum(Iy * d, axis=(1, 2))
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        step = jnp.stack([dx, dy], axis=1)
        small = jnp.sum(step * step, axis=1, keepdims=True) < eps * eps
        step = jnp.where(inv_ok[:, None] & ~small, step, 0.0)
        return flow + step

    flow = jax.lax.fori_loop(0, iters, body, flow)
    S = _sample_windows(img_next, cx + flow[:, 0], cy + flow[:, 1], win)
    err = jnp.mean(jnp.abs(T - S), axis=(1, 2))
    return flow, err, inv_ok


@functools.partial(
    jax.jit, static_argnames=("levels", "win", "iters")
)
def lk_flow(
    img_prev: jax.Array,
    img_next: jax.Array,
    pts: jax.Array,
    mask: jax.Array,
    levels: int = 3,
    win: int = 21,
    iters: int = 20,
    eps: float = 0.013,
    max_err: float = 0.05,
) -> FlowResult:
    """Pyramidal LK (calc_opticalFlow parity: 3 levels, 21x21, 20 iters,
    eps 0.013, err gate 0.05 — match_opticalflow.cpp:40,57-64)."""
    H, W = img_prev.shape
    pyr_prev = gaussian_pyramid(img_prev, levels)
    pyr_next = gaussian_pyramid(img_next, levels)

    scale = 2.0 ** (levels - 1)
    flow = jnp.zeros_like(pts)
    ok = mask.astype(bool)
    err = jnp.zeros(pts.shape[0], pts.dtype)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0**lvl
        flow = flow * (2.0 if lvl < levels - 1 else 1.0)
        flow, err, inv_ok = _lk_level(
            pyr_prev[lvl], pyr_next[lvl], pts / s, flow, win, iters, eps
        )
        ok = ok & inv_ok
    # flow is at level-0 units after the final doubling chain
    out = pts + flow
    inside = (
        (out[:, 0] >= 0) & (out[:, 0] <= W - 1)
        & (out[:, 1] >= 0) & (out[:, 1] <= H - 1)
    )
    status = ok & inside & (err < max_err)
    return FlowResult(pts=out, status=status, err=err)


@functools.partial(jax.jit, static_argnames=("search_radius",))
def match_lkof(
    kp_prev: jax.Array,
    kp_next: jax.Array,
    mask_prev: jax.Array,
    mask_next: jax.Array,
    img_prev: jax.Array,
    img_next: jax.Array,
    search_radius: float = 10.0,
) -> matching.MatchResult:
    """LKOF: LK prediction + nearest spatial keypoint within the radius
    (match_opticalflow.cpp:134-148). The spatial 2-NN runs through the
    same exact engine as descriptor matching (coordinates ARE the
    descriptor)."""
    fl = lk_flow(img_prev, img_next, kp_prev, mask_prev)
    res = matching.match_descriptors(
        fl.pts, kp_next, mask_prev & fl.status, mask_next,
        binary=False, ratio_test=False, cross_check=False,
        max_distance=search_radius * search_radius,
    )
    return res


@functools.partial(jax.jit, static_argnames=("search_radius", "max_hamm"))
def match_alkof(
    kp_prev: jax.Array,
    kp_next: jax.Array,
    desc_prev: jax.Array,
    desc_next: jax.Array,
    mask_prev: jax.Array,
    mask_next: jax.Array,
    img_prev: jax.Array,
    img_next: jax.Array,
    search_radius: float = 10.0,
    max_hamm: float = 60.0,
) -> matching.MatchResult:
    """ALKOF: minimum-Hamming descriptor among the spatial candidates
    inside the LK-predicted radius, gated by maxHammDist
    (match_opticalflow.cpp:150-205)."""
    fl = lk_flow(img_prev, img_next, kp_prev, mask_prev)
    rad = jnp.full(kp_prev.shape[0], search_radius, kp_prev.dtype)
    return matching.match_descriptors(
        desc_prev, desc_next, mask_prev & fl.status, mask_next,
        binary=True, ratio_test=False, cross_check=False,
        max_distance=max_hamm,
        guide_pred=fl.pts, guide_rad=rad, pts2_xy=kp_next,
    )


@jax.jit
def track_lkoft(
    kp_prev: jax.Array,
    mask_prev: jax.Array,
    img_prev: jax.Array,
    img_next: jax.Array,
) -> FlowResult:
    """LKOFT/ALKOFT tracker core: the flow-predicted positions become the
    next frame's keypoints (getMatches_OpticalFlowTracker,
    match_opticalflow.cpp:209+). Descriptor re-extraction/validation at
    the tracked positions is the caller's step (pipeline layer), matching
    the reference's split."""
    return lk_flow(img_prev, img_next, kp_prev, mask_prev)
