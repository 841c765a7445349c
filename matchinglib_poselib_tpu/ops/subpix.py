"""Sub-pixel refinement of matched keypoint positions.

Batched equivalent of the reference's M9 (SURVEY.md):

- getSubPixMatches (matchinglib/source/matchers.cpp:1085-1317): template
  matching of a patch around the left keypoint inside a 2x-upsampled
  search window around the right keypoint; the best-correlation shift
  moves the right point. Rejects the whole refinement pass if too many
  matches fail.
- getSubPixMatches_seperate_Imgs (matchers.cpp:1318-1398):
  cv::cornerSubPix on each image independently — covered here by the
  detector's quadratic response-map refinement (features.refine_subpixel).

Design: all matches refine simultaneously. Per match, a TxT template
(bilinear-sampled at half-pixel pitch around the left point, which IS the
reference's 2x upscaling) slides over an SxS search window; the full SSD
surface over all (S-T+1)^2 shifts is computed as three matmul/elementwise terms
(sum T^2 + local sum S^2 - 2 corr(S, T)) with the cross-correlation as a
depthwise convolution batched over matches. A final 1D parabola fit on
the SSD surface gives sub-half-pixel precision.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SubpixResult(NamedTuple):
    pts2: jax.Array  # (N, 2) refined right-image coords
    shift: jax.Array  # (N, 2) applied shift in pixels
    success: jax.Array  # (N,) bool per-match refinement accepted
    pass_ok: jax.Array  # bool — whole pass accepted (reference reject rule)


def _sample_grid(img, cx, cy, half_extent, n, pitch):
    """(N,) centers -> (N, n, n) bilinear patches at the given pixel pitch."""
    H, W = img.shape
    offs = (jnp.arange(n, dtype=img.dtype) - (n - 1) / 2.0) * pitch
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


def _parabola_peak(y_m, y_0, y_p):
    """Sub-sample offset of the extremum of a 3-point parabola, in [-.5, .5]."""
    denom = y_m - 2.0 * y_0 + y_p
    off = 0.5 * (y_m - y_p) / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    return jnp.clip(jnp.where(jnp.abs(denom) > 1e-12, off, 0.0), -0.5, 0.5)


@functools.partial(
    jax.jit, static_argnames=("template", "search", "min_success_ratio")
)
def refine_matches_subpix(
    img1: jax.Array,
    img2: jax.Array,
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    template: int = 11,
    search: int = 21,
    min_success_ratio: float = 0.5,
) -> SubpixResult:
    """Template-matching sub-pixel refinement of pts2 (matchers.cpp:1085).

    template/search: patch sizes in HALF-pixel samples (pitch 0.5px), so
    template=11 covers a 5x5 px neighborhood and search=21 allows shifts
    of up to ±2.5 px — the reference's 2x-upscaled template match. The
    pass is rejected wholesale (pass_ok=False, original points returned
    downstream) when fewer than ``min_success_ratio`` of the valid
    matches refine cleanly, mirroring the reference's guard.
    """
    dtype = img1.dtype
    maskb = mask.astype(bool)
    n = pts1.shape[0]
    pitch = 0.5

    T = _sample_grid(img1, pts1[:, 0], pts1[:, 1], None, template, pitch)
    S = _sample_grid(img2, pts2[:, 0], pts2[:, 1], None, search, pitch)

    # zero-mean patches: brightness-offset invariance (the reference uses
    # OpenCV matchTemplate TM_SQDIFF on raw patches; zero-mean is strictly
    # more robust and keeps the decision identical on equal-gain images)
    T = T - jnp.mean(T, axis=(1, 2), keepdims=True)
    S = S - jnp.mean(S, axis=(1, 2), keepdims=True)

    # SSD over shifts: sumT2 + box(S^2) - 2 * corr(S, T), depthwise conv
    k = search - template + 1
    sum_t2 = jnp.sum(T * T, axis=(1, 2))[:, None, None]
    ones = jnp.ones((n, 1, template, template), dtype)
    S4 = S[None]  # (1, N, S, S)
    box_s2 = jax.lax.conv_general_dilated(
        S4 * S4, ones, (1, 1), "VALID", feature_group_count=n,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0]
    corr = jax.lax.conv_general_dilated(
        S4, T[:, None], (1, 1), "VALID", feature_group_count=n,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0]
    ssd = sum_t2 + box_s2 - 2.0 * corr  # (N, k, k)

    flat = ssd.reshape(n, k * k)
    best = jnp.argmin(flat, axis=1)
    by = best // k
    bx = best % k
    c = (k - 1) // 2

    # parabola refinement along each axis (clamped at the window border)
    ym = jnp.clip(by, 1, k - 2)
    xm = jnp.clip(bx, 1, k - 2)
    rows = jnp.arange(n)
    off_y = _parabola_peak(
        ssd[rows, ym - 1, bx], ssd[rows, ym, bx], ssd[rows, ym + 1, bx]
    )
    off_x = _parabola_peak(
        ssd[rows, by, xm - 1], ssd[rows, by, xm], ssd[rows, by, xm + 1]
    )

    shift = jnp.stack(
        [
            (bx.astype(dtype) - c + off_x) * pitch,
            (by.astype(dtype) - c + off_y) * pitch,
        ],
        axis=1,
    )

    # success: the minimum is interior (not clamped at the search border)
    # and the SSD surface has real contrast
    interior = (by > 0) & (by < k - 1) & (bx > 0) & (bx < k - 1)
    contrast = (jnp.max(flat, axis=1) - jnp.min(flat, axis=1)) > 1e-8
    success = maskb & interior & contrast

    n_valid = jnp.maximum(jnp.sum(maskb.astype(jnp.float32)), 1.0)
    pass_ok = (
        jnp.sum(success.astype(jnp.float32)) / n_valid
    ) >= min_success_ratio

    new_pts2 = jnp.where(
        (success & pass_ok)[:, None], pts2 + shift, pts2
    )
    return SubpixResult(
        pts2=new_pts2, shift=shift, success=success, pass_ok=pass_ok
    )
