"""Scale-space keypoint detectors: DoG (SIFT), fast-Hessian (SURF),
CenSurE (STAR), MSD, and pyramid FAST (ORB/BRISK).

Batched re-implementations of the reference's OpenCV-backed detector
factory rows (SURVEY.md M2; createDetector features.cpp:792-847). Each
detector is a fixed-shape, branch-free score/extrema computation:

- Gaussian pyramids via separable convolutions (static kernel taps, XLA
  fuses them onto the elementwise/matmul).
- Scale-space extrema via ``reduce_window`` max/min comparisons — no
  pointer-chasing NMS.
- Per-octave keypoints are selected with the same grid-capped top-k used at
  the base scale, then merged with a global top-k (the analogue of the
  reference's responseFilterGridBased, features.cpp:506).

MSER has no fixed-shape equivalent (union-find over threshold sweeps); its
registry row maps to polarity-aware scale-normalized DoG blob detection with
a cross-level stability requirement — the classical LoG-blob approximation
of MSER (documented behavioral substitution, same role: blob/region
keypoints for the downstream descriptor stage).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import DetectorConfig
from matchinglib_poselib_tpu.ops import features as F


# ---------------------------------------------------------------------------
# separable convolution helpers
# ---------------------------------------------------------------------------


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_sep(img: jax.Array, k1d: np.ndarray) -> jax.Array:
    """Separable 2D convolution with a static 1D kernel.

    Edge-replicate padding (VALID conv on a pre-padded image) — zero padding
    would fabricate strong corner/blob responses at the image border at
    coarse scales.
    """
    k = jnp.asarray(k1d, img.dtype)
    K = k.shape[0]
    r = K // 2
    x = jnp.pad(img, ((r, r), (r, r)), mode="edge")[None, None]  # NCHW
    kh = k.reshape(1, 1, K, 1)
    kw = k.reshape(1, 1, 1, K)
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID")
    x = jax.lax.conv_general_dilated(x, kw, (1, 1), "VALID")
    return x[0, 0]


def gaussian_blur(img: jax.Array, sigma: float) -> jax.Array:
    if sigma <= 0.0:
        return img
    return _conv_sep(img, _gauss_kernel1d(sigma))


def box_filter(img: jax.Array, radius: int) -> jax.Array:
    """Mean filter over a (2r+1)^2 window via separable uniform conv."""
    w = 2 * radius + 1
    k = np.full((w,), 1.0 / w, np.float32)
    return _conv_sep(img, k)


def _downsample2(img: jax.Array) -> jax.Array:
    return img[::2, ::2]


# ---------------------------------------------------------------------------
# grid selection shared across octaves
# ---------------------------------------------------------------------------


def _select_level(
    score: jax.Array,
    k: int,
    coord_scale: float,
    kp_scale: float,
    border: int,
    grid_cells: int = 0,
):
    """Grid top-k at one pyramid level, coords mapped to base resolution."""
    xy, sc, mask = F.select_keypoints_grid(score, k, grid_cells, border)
    xy = F.refine_subpixel(score, xy, mask)
    xy = xy * coord_scale
    scale = jnp.full_like(sc, kp_scale)
    return xy, sc, scale, mask


def _merge_levels(levels, max_keypoints: int):
    """Concatenate per-level candidates, keep global top max_keypoints."""
    xy = jnp.concatenate([l[0] for l in levels])
    sc = jnp.concatenate([l[1] for l in levels])
    scale = jnp.concatenate([l[2] for l in levels])
    mask = jnp.concatenate([l[3] for l in levels])
    vals = jnp.where(mask, sc, -jnp.inf)
    k = min(max_keypoints, vals.shape[0])
    top, idx = jax.lax.top_k(vals, k)
    out_mask = jnp.isfinite(top) & (top > 0.0)
    kps = F.Keypoints(
        xy=xy[idx],
        score=jnp.where(out_mask, sc[idx], 0.0),
        angle=jnp.zeros((k,), jnp.float32),
        scale=scale[idx],
        mask=out_mask,
    )
    if k < max_keypoints:
        pad = max_keypoints - k
        kps = F.Keypoints(
            xy=jnp.concatenate([kps.xy, jnp.zeros((pad, 2), jnp.float32)]),
            score=jnp.concatenate([kps.score, jnp.zeros((pad,), jnp.float32)]),
            angle=jnp.concatenate([kps.angle, jnp.zeros((pad,), jnp.float32)]),
            scale=jnp.concatenate([kps.scale, jnp.ones((pad,), jnp.float32)]),
            mask=jnp.concatenate([kps.mask, jnp.zeros((pad,), bool)]),
        )
    return kps


def _n_octaves(h: int, w: int, min_size: int = 32, cap: int = 4) -> int:
    n = 1
    while min(h, w) // (2**n) >= min_size and n < cap:
        n += 1
    return n


# ---------------------------------------------------------------------------
# SIFT: difference-of-Gaussians extrema
# ---------------------------------------------------------------------------

_SIFT_SCALES = 3  # intervals per octave (OpenCV SIFT nOctaveLayers)
_SIFT_SIGMA0 = 1.6
_SIFT_CONTRAST_TH = 0.04 / _SIFT_SCALES  # OpenCV contrastThreshold scheme
_SIFT_EDGE_R = 10.0  # edge-response ratio threshold


def _dog_octave_score(gauss: list[jax.Array], contrast_th: float):
    """Scale-space extrema scores for one octave.

    gauss: list of S+3 blurred images. Returns (S, H, W) response maps —
    |DoG| where the pixel is a 26-neighborhood extremum passing contrast and
    edge tests, else 0.
    """
    dogs = [g1 - g0 for g0, g1 in zip(gauss[:-1], gauss[1:])]  # S+2 maps
    D = jnp.stack(dogs)  # (S+2, H, W)

    def win_max(x):
        return jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
        )

    def win_min(x):
        return jax.lax.reduce_window(
            x, jnp.inf, jax.lax.min, (3, 3), (1, 1), "SAME"
        )

    mx = jax.vmap(win_max)(D)  # (S+2, H, W) per-layer 3x3 max
    mn = jax.vmap(win_min)(D)

    outs = []
    for i in range(1, len(dogs) - 1):
        c = D[i]
        is_max = (
            (c >= mx[i - 1]) & (c >= mx[i + 1]) & (c >= mx[i]) & (c > 0)
        )
        is_min = (
            (c <= mn[i - 1]) & (c <= mn[i + 1]) & (c <= mn[i]) & (c < 0)
        )
        # edge suppression: DoG Hessian trace^2/det test (Lowe sec. 4.1)
        s = lambda dy, dx: jnp.roll(c, (dy, dx), (0, 1))
        dxx = s(0, 1) + s(0, -1) - 2 * c
        dyy = s(1, 0) + s(-1, 0) - 2 * c
        dxy = 0.25 * (s(1, 1) + s(-1, -1) - s(1, -1) - s(-1, 1))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r = _SIFT_EDGE_R
        edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
        ok = (is_max | is_min) & (jnp.abs(c) > contrast_th) & edge_ok
        outs.append(jnp.where(ok, jnp.abs(c), 0.0))
    return outs  # S maps


def sift_dog_keypoints(
    img: jax.Array,
    max_keypoints: int,
    contrast_th: float = _SIFT_CONTRAST_TH,
    grid_cells: int = 0,
) -> F.Keypoints:
    """SIFT detector: DoG scale-space extrema over a Gaussian pyramid.

    Parity target: OpenCV SIFT detection semantics as dispatched by the
    reference (features.cpp:816-819 'SIFT' row).
    """
    H, W = img.shape
    n_oct = _n_octaves(H, W)
    base = gaussian_blur(img, np.sqrt(max(_SIFT_SIGMA0**2 - 0.25, 0.01)))
    levels = []
    per_level_k = max(32, max_keypoints // max(1, n_oct))
    cur = base
    k_step = [
        np.sqrt(
            max(
                (_SIFT_SIGMA0 * 2 ** ((i + 1) / _SIFT_SCALES)) ** 2
                - (_SIFT_SIGMA0 * 2 ** (i / _SIFT_SCALES)) ** 2,
                1e-4,
            )
        )
        for i in range(_SIFT_SCALES + 2)
    ]
    for o in range(n_oct):
        gauss = [cur]
        for i in range(_SIFT_SCALES + 2):
            gauss.append(gaussian_blur(gauss[-1], float(k_step[i])))
        scores = _dog_octave_score(gauss, contrast_th)
        for i, sc in enumerate(scores):
            sigma = _SIFT_SIGMA0 * 2 ** ((i + 1) / _SIFT_SCALES) * (2**o)
            levels.append(
                _select_level(
                    sc, per_level_k, float(2**o), float(sigma / _SIFT_SIGMA0),
                    border=8, grid_cells=grid_cells,
                )
            )
        cur = _downsample2(gauss[_SIFT_SCALES])  # sigma doubled layer
    return _merge_levels(levels, max_keypoints)


def mser_blob_keypoints(
    img: jax.Array, max_keypoints: int, grid_cells: int = 0
) -> F.Keypoints:
    """MSER registry row → polarity-aware stable-blob detection.

    Documented substitution (module docstring): scale-normalized DoG
    extrema with a low contrast threshold approximate maximally-stable
    bright/dark regions (reference row features.cpp:800-803 'MSER').
    """
    return sift_dog_keypoints(
        img, max_keypoints, contrast_th=0.25 * _SIFT_CONTRAST_TH,
        grid_cells=grid_cells,
    )


# ---------------------------------------------------------------------------
# SURF: determinant-of-Hessian over scales
# ---------------------------------------------------------------------------


def _hessian_det(img: jax.Array, sigma: float) -> jax.Array:
    """Scale-normalized determinant of the Gaussian Hessian."""
    g = gaussian_blur(img, sigma)
    s = lambda dy, dx: jnp.roll(g, (dy, dx), (0, 1))
    dxx = s(0, 1) + s(0, -1) - 2 * g
    dyy = s(1, 0) + s(-1, 0) - 2 * g
    dxy = 0.25 * (s(1, 1) + s(-1, -1) - s(1, -1) - s(-1, 1))
    return (sigma**2) ** 2 * (dxx * dyy - 0.81 * dxy * dxy)


_SURF_SIGMAS = (1.2, 1.6, 2.2, 3.0, 4.2, 6.0, 8.5)


def surf_hessian_keypoints(
    img: jax.Array, max_keypoints: int, grid_cells: int = 0
) -> F.Keypoints:
    """SURF detector: fast-Hessian blobs, extrema across adjacent scales.

    Parity target: OpenCV SURF detection as dispatched by the reference
    (features.cpp:820-823 'SURF' row). The box-filter approximation of the
    original is replaced by true Gaussian derivatives (better, and cheap on
    device — the 0.81 dxy weight matches SURF's approximation constant).
    """
    maps = jnp.stack([_hessian_det(img, s) for s in _SURF_SIGMAS])
    mx = jax.vmap(
        lambda x: jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
        )
    )(maps)
    levels = []
    per_level_k = max(32, max_keypoints // (len(_SURF_SIGMAS) - 2))
    for i in range(1, len(_SURF_SIGMAS) - 1):
        c = maps[i]
        ok = (c >= mx[i - 1]) & (c >= mx[i + 1]) & (c >= mx[i]) & (c > 1e-7)
        sc = jnp.where(ok, c, 0.0)
        levels.append(
            _select_level(
                sc, per_level_k, 1.0, float(_SURF_SIGMAS[i] / 1.2),
                border=16, grid_cells=grid_cells,
            )
        )
    return _merge_levels(levels, max_keypoints)


# ---------------------------------------------------------------------------
# STAR (CenSurE): bi-level center-surround filters
# ---------------------------------------------------------------------------

_STAR_SIZES = (1, 2, 3, 4, 6, 8, 11)


def censure_keypoints(
    img: jax.Array, max_keypoints: int, grid_cells: int = 0
) -> F.Keypoints:
    """STAR/CenSurE: difference-of-boxes center-surround response.

    Parity target: OpenCV StarDetector (features.cpp:824-827 'STAR' row).
    The octagon bi-level kernels become inner-box minus surround-annulus
    means (separable box filters); responses are scale-normalized and a
    Harris-style line suppressor removes edge responses, per the CenSurE
    paper's line-suppression step.
    """
    responses = []
    for s in _STAR_SIZES:
        inner = box_filter(img, s)
        outer = box_filter(img, 2 * s)
        wi = (2 * s + 1) ** 2
        wo = (4 * s + 1) ** 2
        # annulus mean from the two box means
        ann = (outer * wo - inner * wi) / (wo - wi)
        responses.append(inner - ann)
    levels = []
    per_level_k = max(32, max_keypoints // max(1, len(_STAR_SIZES) - 2))
    stack = jnp.stack(responses)
    amx = jax.vmap(
        lambda x: jax.lax.reduce_window(
            jnp.abs(x), -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
        )
    )(stack)
    gx, gy = F._sobel(img)
    a = box_filter(gx * gx, 2)
    b = box_filter(gy * gy, 2)
    c = box_filter(gx * gy, 2)
    tr = a + b
    det = a * b - c * c
    not_line = det * 10.0 >= tr * tr  # harris ratio ~ CenSurE line suppr.
    for i in range(1, len(_STAR_SIZES) - 1):
        r = jnp.abs(stack[i])
        ok = (
            (r >= amx[i - 1]) & (r >= amx[i + 1]) & (r >= amx[i])
            & (r > 1e-4) & not_line
        )
        sc = jnp.where(ok, r, 0.0)
        levels.append(
            _select_level(
                sc, per_level_k, 1.0, float(_STAR_SIZES[i]),
                border=16, grid_cells=grid_cells,
            )
        )
    return _merge_levels(levels, max_keypoints)


# ---------------------------------------------------------------------------
# MSD: maximal self-dissimilarity
# ---------------------------------------------------------------------------


def _msd_offsets(r_ignore: int = 2, r_search: int = 5) -> np.ndarray:
    offs = []
    for dy in range(-r_search, r_search + 1):
        for dx in range(-r_search, r_search + 1):
            d2 = dy * dy + dx * dx
            if r_ignore**2 < d2 <= r_search**2:
                offs.append((dy, dx))
    # keep every other offset (checker pattern) — halves the shift count
    return np.array(offs[::2], np.int32)


def msd_keypoints(
    img: jax.Array,
    max_keypoints: int,
    patch_radius: int = 3,
    grid_cells: int = 0,
) -> F.Keypoints:
    """MSD: contextual self-dissimilarity saliency.

    Parity target: xfeatures2d::MSDDetector (features.cpp:828-831 'MSD').
    Saliency(p) = min over ring offsets o of SSD(patch(p), patch(p+o));
    each SSD map is a box filter of a squared shifted difference — pure elementwise
    stencil work, no per-pixel loops.
    """
    offs = _msd_offsets()
    w = (2 * patch_radius + 1) ** 2
    sal = None
    for dy, dx in offs:
        d = img - jnp.roll(img, (int(dy), int(dx)), (0, 1))
        ssd = box_filter(d * d, patch_radius) * w
        sal = ssd if sal is None else jnp.minimum(sal, ssd)
    score = F.nms(sal, 3)
    xy, sc, mask = F.select_keypoints_grid(
        score, max_keypoints, grid_cells, border=16
    )
    xy = F.refine_subpixel(score, xy, mask)
    return F.Keypoints(
        xy=xy, score=sc, angle=jnp.zeros_like(sc),
        scale=jnp.ones_like(sc), mask=mask,
    )


# ---------------------------------------------------------------------------
# pyramid FAST (ORB / BRISK-AGAST)
# ---------------------------------------------------------------------------


def pyramid_fast_keypoints(
    img: jax.Array,
    max_keypoints: int,
    threshold: float,
    n_levels: int = 1,
    scale_factor: float = 1.25,
    harris_rank: bool = False,
    grid_cells: int = 0,
) -> F.Keypoints:
    """Multi-scale FAST: ORB (harris_rank=True) / BRISK-AGAST semantics.

    Parity target: OpenCV ORB's pyramid detection with Harris re-ranking
    (features.cpp:804-807 'ORB') and BRISK's AGAST-over-octaves
    (features.cpp:808-811 'BRISK'); AGAST's accelerated decision tree is an
    implementation detail of CPU FAST — here the full segment test is one
    vectorized pass, so both rows share it.
    """
    H, W = img.shape
    levels = []
    per_level_k = max(64, max_keypoints // max(1, n_levels))
    cur = img
    for lv in range(n_levels):
        s = scale_factor**lv
        if lv > 0:
            nh, nw = max(32, int(round(H / s))), max(32, int(round(W / s)))
            cur = jax.image.resize(img, (nh, nw), "linear")
        score = F.fast_score(cur, threshold)
        if harris_rank:
            h = F.harris_score(cur)
            score = jnp.where(score > 0.0, jnp.maximum(h, 1e-12), 0.0)
        score = F.nms(score, 3)
        levels.append(
            _select_level(
                score, per_level_k, float(s), float(s),
                border=16, grid_cells=grid_cells,
            )
        )
    return _merge_levels(levels, max_keypoints)
