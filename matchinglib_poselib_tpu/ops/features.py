"""Feature frontend: corner detection, orientation, descriptors.

Batched equivalent of the reference's detector/descriptor factories
(SURVEY.md M2/M3; features.cpp:145-379 getKeypoints, :397-484
getDescriptors, :506-770 responseFilterGridBased, :792-847 createDetector,
:849-971 createExtractor). The reference delegates to OpenCV's 10 detectors
and 22 descriptors; here the registry provides fixed-shape families covering
both descriptor datatypes the matchers consume:

- detection: FAST segment-test score, Harris, Shi-Tomasi — all as shifted
  elementwise comparisons / separable convolutions (elementwise work, no gathers),
  with reduce_window NMS and per-grid-cell top-k retention (the exact
  fixed-shape analogue of the reference's grid-based response filtering).
- orientation: ORB's intensity-centroid moments over the keypoint patch.
- descriptors: rotation-steered BRIEF-256 (binary, Hamming-matched, the
  ORB/BRISK/FREAK family representative) and a SIFT-like 128-d gradient
  histogram float descriptor (the SIFT/SURF/DAISY/VGG family
  representative). Other reference descriptor names are registry aliases of
  these two families (documented substitution, equal datatype + metric).

Everything is fixed-shape: exactly `max_keypoints` slots per image with a
validity mask; images are (H, W) float32 grayscale in [0, 1].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import DetectorConfig, DescriptorConfig


class Keypoints(NamedTuple):
    xy: jax.Array  # (K, 2) float32 pixel coords (x, y)
    score: jax.Array  # (K,) detector response
    angle: jax.Array  # (K,) orientation in radians
    scale: jax.Array  # (K,) pyramid scale factor (1.0 = base)
    mask: jax.Array  # (K,) bool validity

    @property
    def n(self):
        return jnp.sum(self.mask.astype(jnp.int32))


# ---------------------------------------------------------------------------
# corner scores
# ---------------------------------------------------------------------------

# FAST 16-pixel Bresenham circle offsets (dy, dx), radius 3 — the standard
# segment-test ring (OpenCV FastFeatureDetector semantics, features.cpp:792).
_FAST_RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def _shift2d(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """Shift with zero padding (image stays same shape)."""
    return jnp.roll(img, shift=(dy, dx), axis=(0, 1))


def fast_score(img: jax.Array, threshold: float = 20.0 / 255.0) -> jax.Array:
    """FAST-9/16 segment-test corner response.

    A pixel is a corner if >= 9 contiguous ring pixels are all brighter than
    c + t or all darker than c - t; the response is the sum of absolute
    differences over the qualifying arc (OpenCV's FAST score semantics).

    Bandwidth-lean formulation (the naive one materialized f32 flag/score
    stacks worth ~1 GB device memory per frame — the dominant bandwidth consumer of
    the fused pipeline step): scores accumulate as relu sums directly (a
    ring pixel contributes to the bright score iff diff > t, which is
    exactly relu(diff - t) > 0 — no mask stacks), comparisons live as
    1-byte preds, and the contiguous-arc test is a wrap-extended int8
    cumulative sum (window-of-9 sum == 9). Bit-identical corner decisions
    and scores to the direct formulation.
    """
    # per-position 2D arrays, never a stacked (16, H, W) tensor: the
    # explicit stack defeats XLA's pointwise fusion under vmap — the
    # batched program materialized the f32[B, 16, H, W] ring (~730 MB at
    # B=16 images) plus matching pred stacks, which alone cost more device memory
    # time than the whole single-image detect
    diffs = [
        _shift2d(img, int(dy), int(dx)) - img for dy, dx in _FAST_RING
    ]
    # scores: sum over the qualifying polarity of |diff| - t == relu sums
    score_b = diffs[0] * 0.0
    score_d = diffs[0] * 0.0
    for d in diffs:
        score_b = score_b + jnp.maximum(d - threshold, 0.0)
        score_d = score_d + jnp.maximum(-d - threshold, 0.0)

    def arc9(f):
        # run of >= 9 around the 16-ring by AND-doubling: window [s, s+9)
        # all-true == f[s] & f[s+1..] via a2/a4/a8 prefix ANDs. Pure
        # elementwise bool chains XLA fuses into one kernel.
        a2 = [f[s] & f[(s + 1) % 16] for s in range(16)]
        a4 = [a2[s] & a2[(s + 2) % 16] for s in range(16)]
        a8 = [a4[s] & a4[(s + 4) % 16] for s in range(16)]
        acc = a8[0] & f[8]
        for s in range(1, 16):
            acc = acc | (a8[s] & f[(s + 8) % 16])
        return acc

    is_corner = arc9([d > threshold for d in diffs]) | arc9(
        [d < -threshold for d in diffs]
    )
    score = jnp.maximum(score_b, score_d)
    return jnp.where(is_corner, score, 0.0)


def _sobel(img: jax.Array):
    """Sobel gradients via shifted sums (elementwise)."""
    p = lambda dy, dx: _shift2d(img, dy, dx)
    gx = (
        (p(0, -1) - p(0, 1)) * 2.0
        + (p(-1, -1) - p(-1, 1))
        + (p(1, -1) - p(1, 1))
    )
    gy = (
        (p(-1, 0) - p(1, 0)) * 2.0
        + (p(-1, -1) - p(1, -1))
        + (p(-1, 1) - p(1, 1))
    )
    return gx, gy


def _box3(img: jax.Array) -> jax.Array:
    s = (
        img
        + _shift2d(img, 0, 1) + _shift2d(img, 0, -1)
    )
    return (
        s + _shift2d(s, 1, 0) + _shift2d(s, -1, 0)
    )


def harris_score(img: jax.Array, k: float = 0.04) -> jax.Array:
    """Harris corner response det(M) - k tr(M)^2 with a 3x3 window."""
    gx, gy = _sobel(img)
    a = _box3(gx * gx)
    b = _box3(gy * gy)
    c = _box3(gx * gy)
    det = a * b - c * c
    tr = a + b
    return det - k * tr * tr


def shi_tomasi_score(img: jax.Array) -> jax.Array:
    """Minimum-eigenvalue (GFTT) response."""
    gx, gy = _sobel(img)
    a = _box3(gx * gx)
    b = _box3(gy * gy)
    c = _box3(gx * gy)
    half_tr = 0.5 * (a + b)
    rad = jnp.sqrt(jnp.maximum(half_tr * half_tr - (a * b - c * c), 0.0))
    return half_tr - rad


# ---------------------------------------------------------------------------
# NMS + grid top-k selection
# ---------------------------------------------------------------------------


def nms(score: jax.Array, radius: int = 3) -> jax.Array:
    """Keep only local maxima within (2r+1)^2 windows."""
    w = 2 * radius + 1
    mx = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (w, w), (1, 1), "SAME"
    )
    return jnp.where((score >= mx) & (score > 0.0), score, 0.0)


def select_keypoints_grid(
    score: jax.Array,
    max_keypoints: int,
    grid_cells: int = 0,
    border: int = 16,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Grid-capped top-k keypoint selection.

    The fixed-shape analogue of the reference's adaptive grid response filter
    (responseFilterGridBased, features.cpp:506): the image is divided into
    roughly `grid_cells^2` cells; each cell may contribute at most
    ceil(2 * max_keypoints / n_cells) keypoints; the global top
    `max_keypoints` by response are kept. Returns (xy, score, mask).
    """
    H, W = score.shape
    # suppress borders (descriptor patch support)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    inb = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    score = jnp.where(inb, score, 0.0)

    if grid_cells <= 0:
        grid_cells = max(2, int(np.sqrt(max_keypoints / 2.0)))
    gh = max(1, H // grid_cells)
    gw = max(1, W // grid_cells)
    # pad to multiple of cell size
    Hp = ((H + gh - 1) // gh) * gh
    Wp = ((W + gw - 1) // gw) * gw
    sp = jnp.zeros((Hp, Wp), score.dtype).at[:H, :W].set(score)
    ncy, ncx = Hp // gh, Wp // gw
    cells = sp.reshape(ncy, gh, ncx, gw).transpose(0, 2, 1, 3).reshape(
        ncy * ncx, gh * gw
    )
    per_cell = min(
        max(1, int(np.ceil(2.0 * max_keypoints / (ncy * ncx)))), gh * gw
    )
    vals, idx = _topk_small(cells, per_cell)  # (C, per_cell)
    # convert cell-local flat idx -> global (y, x)
    cy = jnp.arange(ncy * ncx) // ncx
    cx = jnp.arange(ncy * ncx) % ncx
    ly = idx // gw
    lx = idx % gw
    gy = cy[:, None] * gh + ly
    gx = cx[:, None] * gw + lx
    flat_vals = vals.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_x = gx.reshape(-1)
    k = min(max_keypoints, flat_vals.shape[0])
    top_vals, top_i = jax.lax.top_k(flat_vals, k)
    sel_y = flat_y[top_i]
    sel_x = flat_x[top_i]
    mask = top_vals > 0.0
    xy = jnp.stack([sel_x, sel_y], axis=-1).astype(jnp.float32)
    if k < max_keypoints:
        pad = max_keypoints - k
        xy = jnp.concatenate([xy, jnp.zeros((pad, 2), jnp.float32)])
        top_vals = jnp.concatenate([top_vals, jnp.zeros((pad,), top_vals.dtype)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,), bool)])
    return xy, top_vals, mask


def band_width(width: int, bands: int) -> int:
    """Pixel width of one column band, aligned up to a multiple of 4.

    Single source of truth shared by select_keypoints_banded and
    _extract_patches_banded (the banded-slot contract): the alignment
    lets the selection's blk x blk block-reduced grid divide evenly
    into bands for every supported blk (1, 2, 4).
    """
    return ((width + bands - 1) // bands + 3) // 4 * 4


def select_keypoints_banded(
    score: jax.Array,
    max_keypoints: int,
    bands: int = 16,
    border: int = 16,
    nms_radius: int = 3,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Grid-capped keypoint selection, output grouped by column band.

    The per-cell-quota variant of the reference's responseFilterGridBased
    (features.cpp:506 keeps the best responses per grid cell — there is
    no global refill in the reference either): the image is divided into
    ``bands`` column bands x R cell rows, each cell contributes exactly
    its top max_keypoints/(bands*R) responses (masked when the cell has
    fewer corners), and slot b*C..(b+1)*C-1 holds band b's keypoints.

    The band-major output is the contract ``extract_patches`` exploits:
    every keypoint in band b lies within a static 128-wide column window
    of the image, which shrinks the patch-extraction contraction from
    the full image width to one lane tile (90.5 -> 8.3 GFLOP at
    2048 kp x 1392 px — the largest single matmul of the fused step).
    """
    H, W = score.shape
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    inb = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    score = jnp.where(inb, score, 0.0)

    C = max_keypoints // bands  # slots per band
    gw = band_width(W, bands)
    # band-level top-C over each band's pixels: full response adaptivity
    # inside a band — identical to the global top-k there — with only
    # the cross-band capacity fixed. NMS already spaces the responses,
    # so no per-cell quota is needed on top.
    #
    # block pre-reduction FIRST (EXACT for blk <= nms_radius + 1): NMS
    # with window (2r+1)^2 guarantees two survivors are >= r+1 apart in
    # L-inf (up to exact-score ties, which NMS itself keeps and the
    # reference dedups anyway), so max+argmax over blk x blk blocks
    # keeps every survivor and shrinks the top_k operand blk^2-fold.
    # The band top_k over the raw (bands, H*gw) view was the single
    # most expensive op of the detect stage (~366 us/image at 1392x512,
    # slope-timed), and its vmap falls back to a full O(n log n) sort —
    # the round-4 batched-8 regression. Reducing BEFORE the band split
    # keeps every reshuffle (band transpose, padding) on the blk^2-x
    # smaller grid, so the whole selection fuses cleanly under vmap.
    blk = 4 if nms_radius >= 3 else (2 if nms_radius >= 1 else 1)
    Wq = bands * gw
    Hb = ((H + blk - 1) // blk) * blk
    sp = jnp.zeros((Hb, Wq), score.dtype).at[:H, :W].set(score)
    nby, ngx = Hb // blk, Wq // blk
    blocks = (
        sp.reshape(nby, blk, ngx, blk).transpose(0, 2, 1, 3).reshape(
            nby, ngx, blk * blk
        )
    )
    bmax = jnp.max(blocks, axis=-1)  # (nby, ngx) reduced grid
    barg = jnp.argmax(blocks, axis=-1).astype(jnp.int32)
    gwr = gw // blk  # reduced band width (gw is 4-aligned, blk | 4)
    bm = bmax.reshape(nby, bands, gwr).transpose(1, 0, 2).reshape(
        bands, nby * gwr
    )
    ba = barg.reshape(nby, bands, gwr).transpose(1, 0, 2).reshape(
        bands, nby * gwr
    )
    vsel, ridx = jax.lax.top_k(bm, C)  # (bands, C)
    inblk = jnp.take_along_axis(ba, ridx, axis=1)  # (bands, C)
    ysel = (ridx // gwr) * blk + inblk // blk
    xsel = jnp.arange(bands)[:, None] * gw + jnp.minimum(
        (ridx % gwr) * blk + inblk % blk, gw - 1
    )
    xy = jnp.stack(
        [xsel.reshape(-1), ysel.reshape(-1)], axis=-1
    ).astype(jnp.float32)
    sc = vsel.reshape(-1)
    mask = sc > 0.0
    # masked slots keep in-band coordinates (the band window math stays
    # valid for padded slots)
    xy = jnp.where(
        mask[:, None], xy,
        jnp.stack(
            [
                (jnp.arange(max_keypoints) // C) * gw + gw // 2,
                jnp.full((max_keypoints,), H // 2),
            ],
            axis=-1,
        ).astype(jnp.float32),
    )
    return xy, sc, mask


def _topk_small(x: jax.Array, k: int):
    """Exact top-k along the last axis by iterative max extraction.

    k rounds of max/argmax/mask: plain reductions in place of a sort,
    bit-exact, ties resolved to the lowest index like lax.top_k.
    """
    if k > 8:
        return jax.lax.top_k(x, k)
    cols = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    neg = jnp.asarray(-jnp.inf, x.dtype)
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = jnp.argmax(cur, axis=-1)
        v = jnp.take_along_axis(cur, i[..., None], axis=-1)[..., 0]
        vals.append(v)
        idxs.append(i)
        cur = jnp.where(cols == i[..., None], neg, cur)
    return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)


def refine_subpixel(score: jax.Array, xy: jax.Array, mask: jax.Array):
    """Quadratic 3x3 subpixel refinement of keypoint locations."""
    H, W = score.shape
    x = xy[:, 0].astype(jnp.int32)
    y = xy[:, 1].astype(jnp.int32)
    x = jnp.clip(x, 1, W - 2)
    y = jnp.clip(y, 1, H - 2)

    def g(dy, dx):
        return score[y + dy, x + dx]

    dx = 0.5 * (g(0, 1) - g(0, -1))
    dy = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = g(0, 1) + g(0, -1) - 2.0 * g(0, 0)
    dyy = g(1, 0) + g(-1, 0) - 2.0 * g(0, 0)
    ox = jnp.where(jnp.abs(dxx) > 1e-9, -dx / dxx, 0.0)
    oy = jnp.where(jnp.abs(dyy) > 1e-9, -dy / dyy, 0.0)
    ox = jnp.clip(ox, -0.5, 0.5)
    oy = jnp.clip(oy, -0.5, 0.5)
    out = jnp.stack(
        [x.astype(jnp.float32) + ox, y.astype(jnp.float32) + oy], axis=-1
    )
    return jnp.where(mask[:, None], out, xy)


# ---------------------------------------------------------------------------
# patches + orientation
# ---------------------------------------------------------------------------


def extract_patches(
    img: jax.Array, xy: jax.Array, patch: int = 31, bands: int = 0
):
    """(K, patch, patch) patches centered on integer keypoint locations.

    Matmul formulation: patch_k = RowSel_k @ img @ ColSel_k^T with one-hot
    selector matrices, computed as two batched bf16 einsums in place of an
    arbitrary gather. bf16 selectors are exact
    (0/1); the image is rounded to bf16 (~3 decimal digits — immaterial for
    intensity comparisons and gradient histograms).

    bands > 0 (CONTRACT: keypoints came from select_keypoints_banded
    with the same band count, i.e. slot k's keypoint lies in column band
    k // (K/bands)): the column contraction runs per band against a
    static 128-wide window instead of the full image width (90.5 ->
    8.3 GFLOP at 2048 kp x 1392 px, counted from the shapes). Keypoints
    violating the contract get clamped
    (wrong) patches — callers enable this only for banded selections.
    """
    if bands > 0 and xy.shape[0] % bands == 0:
        return _extract_patches_banded(img, xy, patch, bands)
    H, W = img.shape
    r = patch // 2
    x0 = jnp.clip(xy[:, 0].astype(jnp.int32) - r, 0, W - patch)
    y0 = jnp.clip(xy[:, 1].astype(jnp.int32) - r, 0, H - patch)
    dy = jnp.arange(patch)
    rows = y0[:, None] + dy  # (K, P)
    cols = x0[:, None] + dy
    rsel = jax.nn.one_hot(rows, H, dtype=jnp.bfloat16)  # (K, P, H)
    csel = jax.nn.one_hot(cols, W, dtype=jnp.bfloat16)  # (K, P, W)
    # contract the LONG image axis (W) first: the intermediate is
    # (K, P, H) instead of (K, P, W), 2.7x smaller on wide images
    tmp = jnp.einsum(
        "kcw,hw->kch",
        csel,
        img.astype(jnp.bfloat16),
        preferred_element_type=jnp.bfloat16,
        precision=jax.lax.Precision.DEFAULT,
    )
    patches = jnp.einsum(
        "krh,kch->krc",
        rsel,
        tmp,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    return patches


def _extract_patches_banded(
    img: jax.Array, xy: jax.Array, patch: int, B: int
):
    """Banded patch extraction (see extract_patches docstring)."""
    H, W = img.shape
    K = xy.shape[0]
    C = K // B
    r = patch // 2
    gw = band_width(W, B)
    Wb = ((gw + patch + 16 + 127) // 128) * 128  # static window, lane tile
    Wpad = max(W, Wb)
    imgp = img if Wpad == W else jnp.pad(img, ((0, 0), (0, Wpad - W)))
    starts = [min(max(b * gw - r, 0), Wpad - Wb) for b in range(B)]
    bandimg = jnp.stack(
        [jax.lax.slice(imgp, (0, s), (H, s + Wb)) for s in starts]
    )  # (B, H, Wb)

    x0 = jnp.clip(xy[:, 0].astype(jnp.int32) - r, 0, W - patch)
    y0 = jnp.clip(xy[:, 1].astype(jnp.int32) - r, 0, H - patch)
    s_arr = jnp.asarray(starts, jnp.int32)
    relx = jnp.clip(x0.reshape(B, C) - s_arr[:, None], 0, Wb - patch)
    dy = jnp.arange(patch)
    cols = relx[..., None] + dy  # (B, C, P)
    csel = jax.nn.one_hot(cols, Wb, dtype=jnp.bfloat16)
    tmp = jnp.einsum(
        "bcpw,bhw->bcph",
        csel,
        bandimg.astype(jnp.bfloat16),
        preferred_element_type=jnp.bfloat16,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(K, patch, H)
    rows = y0[:, None] + dy
    rsel = jax.nn.one_hot(rows, H, dtype=jnp.bfloat16)
    return jnp.einsum(
        "krh,kch->krc",
        rsel,
        tmp,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )


def orientation_ic(patches: jax.Array) -> jax.Array:
    """ORB intensity-centroid orientation per patch (K,) radians."""
    P = patches.shape[-1]
    r = P // 2
    ys = jnp.arange(P) - r
    xs = jnp.arange(P) - r
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    circ = (yy**2 + xx**2 <= r * r).astype(patches.dtype)
    m01 = jnp.sum(patches * (yy * circ)[None], axis=(-1, -2))
    m10 = jnp.sum(patches * (xx * circ)[None], axis=(-1, -2))
    return jnp.arctan2(m01, m10)


# ---------------------------------------------------------------------------
# BRIEF-256 (steered) binary descriptor
# ---------------------------------------------------------------------------


def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 3) -> np.ndarray:
    """Fixed Gaussian test pattern (n_bits, 2 points, 2 coords).

    BRIEF's isotropic Gaussian sampling (sigma = patch/5) — the pattern the
    original BRIEF paper found best; ORB's learned pattern is a tuned
    variant of the same family.
    """
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    r = patch // 2 - 2
    pts = rng.normal(scale=sigma, size=(n_bits, 2, 2))
    return np.clip(pts, -r, r).astype(np.float32)


_BRIEF_PTS = jnp.asarray(_brief_pattern())  # (256, 2, 2) as (dx, dy)

# ORB-style discretized rotations: precompute integer sample offsets for
# N_ANGLE_BINS rotations of the pattern (OpenCV ORB uses 30 x 12deg bins and
# rounded rotated offsets — features.cpp's ORB extractor does exactly this).
# Sampling then becomes one bf16 selection matmul per bin as matmuls instead
# of per-keypoint gathers.
_N_ANGLE_BINS = 30
_PATCH_FOR_TABLE = 31


def _orb_selection_tables(patch: int = _PATCH_FOR_TABLE) -> np.ndarray:
    pts = _brief_pattern(patch=patch).reshape(-1, 2)  # (512, 2) as (dx, dy)
    r = patch // 2
    tables = []
    for b in range(_N_ANGLE_BINS):
        th = 2.0 * np.pi * b / _N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        gx = np.clip(np.rint(ca * pts[:, 0] - sa * pts[:, 1]), -r, r) + r
        gy = np.clip(np.rint(sa * pts[:, 0] + ca * pts[:, 1]), -r, r) + r
        tables.append((gy * patch + gx).astype(np.int32))
    return np.stack(tables)  # (BINS, 512)


_ORB_IDX = _orb_selection_tables()
# (BINS, 512, patch*patch) one-hot selection tensor, bf16 (exact 0/1)
_ORB_SEL = jnp.asarray(
    np.eye(_PATCH_FOR_TABLE * _PATCH_FOR_TABLE, dtype=np.float32)[_ORB_IDX],
    jnp.bfloat16,
)


def _bilinear_sample_image(img: jax.Array, x: jax.Array, y: jax.Array):
    """Bilinear sample arbitrary-shaped float coords from a (H, W) image.

    Four fused gathers — batch-friendly (no per-keypoint loops).
    """
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(K, 256) {0,1} -> (K, 8) packed uint32."""
    words = bits.astype(jnp.uint32).reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def brief_descriptor_orb(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """Steered BRIEF-256 via ORB-style discretized rotations -> (K, 8) u32.

    The binary-family representative (ORB/BRISK/FREAK/LATCH registry rows
    in features.cpp:849-971 map here). The keypoint angle is quantized to
    one of 30 bins (OpenCV ORB semantics); sampling all bins is one
    bf16 selection einsum as matmuls, then the keypoint's bin is mixed out
    with a one-hot contraction — no gathers anywhere.
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    pf = patches.reshape(K, P * P).astype(jnp.bfloat16)
    samples = jnp.einsum(
        "kp,bsp->kbs",
        pf,
        _ORB_SEL,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )  # (K, BINS, 512)
    two_pi = 2.0 * jnp.pi
    binf = (angles % two_pi) / two_pi * _N_ANGLE_BINS
    bin_idx = jnp.round(binf).astype(jnp.int32) % _N_ANGLE_BINS
    oh = jax.nn.one_hot(bin_idx, _N_ANGLE_BINS, dtype=jnp.float32)
    vals = jnp.einsum("kbs,kb->ks", samples, oh).reshape(K, 256, 2)
    return _pack_bits(vals[..., 0] < vals[..., 1])


def brief_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """Patch-based steered BRIEF-256 (kept for patch-only callers)."""
    if not oriented:
        angles = jnp.zeros_like(angles)
    P = patches.shape[-1]
    c = (P - 1) / 2.0
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    pts = _BRIEF_PTS.reshape(-1, 2)
    px, py = pts[:, 0][None, :], pts[:, 1][None, :]
    gx = c + ca * px - sa * py  # (K, 512) patch coords
    gy = c + sa * px + ca * py
    # gather per patch via one fused take_along_axis on flattened patches
    gx = jnp.clip(gx, 0.0, P - 1.001)
    gy = jnp.clip(gy, 0.0, P - 1.001)
    x0 = jnp.floor(gx).astype(jnp.int32)
    y0 = jnp.floor(gy).astype(jnp.int32)
    fx = gx - x0
    fy = gy - y0
    flat = patches.reshape(patches.shape[0], P * P)

    def tk(yy, xx):
        return jnp.take_along_axis(flat, yy * P + xx, axis=1)

    vals = (
        tk(y0, x0) * (1 - fy) * (1 - fx)
        + tk(y0, x0 + 1) * (1 - fy) * fx
        + tk(y0 + 1, x0) * fy * (1 - fx)
        + tk(y0 + 1, x0 + 1) * fy * fx
    ).reshape(-1, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# SIFT-like float descriptor
# ---------------------------------------------------------------------------


def sift_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """4x4 x 8-bin gradient-orientation histogram -> (K, 128) float32.

    The float-family representative (SIFT/SURF/DAISY/VGG registry rows).
    Gradients are rotated into the keypoint frame; spatial bins use hard
    assignment with Gaussian radial weighting; the result is L2-normalized,
    clamped at 0.2 and renormalized (Lowe's scheme).
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    gx = 0.5 * (jnp.roll(patches, -1, axis=2) - jnp.roll(patches, 1, axis=2))
    gy = 0.5 * (jnp.roll(patches, -1, axis=1) - jnp.roll(patches, 1, axis=1))
    mag = jnp.sqrt(gx * gx + gy * gy)
    ori = jnp.arctan2(gy, gx) - angles[:, None, None]

    c = (P - 1) / 2.0
    ys = (jnp.arange(P) - c) / c  # [-1, 1]
    xs = (jnp.arange(P) - c) / c
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    # rotate coords into keypoint frame
    ca = jnp.cos(-angles)[:, None, None]
    sa = jnp.sin(-angles)[:, None, None]
    xr = ca * xx[None] - sa * yy[None]
    yr = sa * xx[None] + ca * yy[None]
    w_gauss = jnp.exp(-(xx**2 + yy**2) / (2 * 0.6**2))[None]

    # spatial bins: 4x4 over [-1, 1]
    bx = jnp.clip(((xr + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    by = jnp.clip(((yr + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    # orientation bins: 8 over [0, 2pi)
    two_pi = 2.0 * jnp.pi
    ob = jnp.clip(
        ((ori % two_pi) / two_pi * 8.0).astype(jnp.int32), 0, 7
    )
    bin_idx = (by * 4 + bx) * 8 + ob  # (K, P, P) in [0, 128)
    wts = (mag * w_gauss).reshape(K, -1)
    flat_idx = bin_idx.reshape(K, -1)
    onehot = jax.nn.one_hot(flat_idx, 128, dtype=patches.dtype)  # (K, P*P, 128)
    desc = jnp.einsum("kp,kpb->kb", wts, onehot)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    desc = jnp.minimum(desc, 0.2)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    return desc


# ---------------------------------------------------------------------------
# top-level detect + describe
# ---------------------------------------------------------------------------

_DETECTOR_FNS = {
    "FAST": lambda img, cfg: fast_score(img, cfg.fast_threshold / 255.0),
    "HARRIS": lambda img, cfg: harris_score(img),
    "SHITOMASI": lambda img, cfg: shi_tomasi_score(img),
    # ORB = FAST detection with Harris-rank ordering; on the grid-top-k
    # selection path plain FAST score ordering is equivalent in effect
    "ORB": lambda img, cfg: fast_score(img, cfg.fast_threshold / 255.0),
    # BRISK at one level = AGAST segment test = FAST score (scale_space.py
    # handles pyramid_levels > 1)
    "BRISK": lambda img, cfg: fast_score(img, cfg.fast_threshold / 255.0),
}

# registry aliases: reference detector names -> implemented families
# (features.cpp:792-847; README.md:47-66). Scale-space families (SIFT, SURF,
# STAR, MSD, MSER, pyramid ORB/BRISK, KAZE/AKAZE) dispatch to dedicated
# detectors in ops/scale_space.py and ops/nonlinear_diffusion.py.
DETECTOR_ALIASES = {
    "FAST": "FAST", "ORB": "ORB", "HARRIS": "HARRIS", "GFTT": "SHITOMASI",
    "SHITOMASI": "SHITOMASI", "BRISK": "BRISK", "AKAZE": "AKAZE",
    "KAZE": "KAZE", "SIFT": "SIFT", "SURF": "SURF",
    "STAR": "STAR", "MSD": "MSD", "MSER": "MSER",
}

DESCRIPTOR_ALIASES = {
    # steered-BRIEF family
    "ORB": "BRIEF",
    # LATCH: patch-triplet comparisons (descriptors_learned.latch_descriptor)
    "LATCH": "LATCH",
    # AKAZE MLDB / KAZE M-SURF (nonlinear_diffusion module)
    "AKAZE": "MLDB", "KAZE_BIN": "MLDB", "KAZE": "MSURF",
    # BoostDesc family: boosted gradient-map weak learners with procedural
    # (not OpenCV-trained) selection tables — documented substitution, same
    # structure/dims/metric (descriptors_learned.boostdesc_descriptor)
    "BGM": "BGM", "BGM_HARD": "BGM", "BGM_BILINEAR": "BGM",
    "LBGM": "LBGM",
    "BINBOOST_64": "BINBOOST_64", "BINBOOST_128": "BINBOOST_128",
    "BINBOOST_256": "BINBOOST_256",
    # ring-pattern family (true concentric-ring implementations,
    # descriptors_ext.ring_pattern_descriptor)
    "BRISK": "RING", "FREAK": "RING_LOG",
    # BOLD: per-patch stability masks + masked-Hamming matching
    "BOLD": "BOLD",
    # float family
    "SIFT": "SIFT", "SURF": "SURF64", "DAISY": "DAISY",
    # VGG: pooled-gradient features x procedural projection (dims match)
    "VGG_120": "VGG_120", "VGG_80": "VGG_80", "VGG_64": "VGG_64",
    "VGG_48": "VGG_48",
    "RIFF": "RIFF",
}

# LBGM is the float member of the BoostDesc family (L2-matched, like the
# reference's xfeatures2d::BoostDesc LBGM row); all others here are Hamming.
_BINARY_KINDS = (
    "BRIEF", "RING", "RING_LOG", "BOLD", "MLDB", "LATCH", "BGM",
    "BINBOOST_64", "BINBOOST_128", "BINBOOST_256",
)


def is_binary_descriptor(name: str) -> bool:
    kind = DESCRIPTOR_ALIASES.get(name.upper(), "BRIEF")
    return kind in _BINARY_KINDS


def is_bold_descriptor(name: str) -> bool:
    return DESCRIPTOR_ALIASES.get(name.upper(), "BRIEF") == "BOLD"


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_keypoints(img: jax.Array, cfg: DetectorConfig) -> Keypoints:
    """getKeypoints equivalent (features.cpp:145): score -> NMS -> grid top-k.

    img: (H, W) float32 in [0, 1]. Returns fixed-capacity Keypoints.
    Scale-space detector rows dispatch to ops/scale_space.py /
    ops/nonlinear_diffusion.py; single-scale corner rows stay here.
    """
    kind = DETECTOR_ALIASES.get(cfg.kind.upper(), "FAST")
    if kind in ("SIFT", "SURF", "STAR", "MSD", "MSER", "KAZE", "AKAZE") or (
        kind in ("ORB", "BRISK") and cfg.pyramid_levels > 1
    ):
        from matchinglib_poselib_tpu.ops import scale_space

        if kind == "SIFT":
            return scale_space.sift_dog_keypoints(
                img, cfg.max_keypoints, grid_cells=cfg.grid_cells
            )
        if kind == "MSER":
            return scale_space.mser_blob_keypoints(
                img, cfg.max_keypoints, grid_cells=cfg.grid_cells
            )
        if kind == "SURF":
            return scale_space.surf_hessian_keypoints(
                img, cfg.max_keypoints, grid_cells=cfg.grid_cells
            )
        if kind == "STAR":
            return scale_space.censure_keypoints(
                img, cfg.max_keypoints, grid_cells=cfg.grid_cells
            )
        if kind == "MSD":
            return scale_space.msd_keypoints(
                img, cfg.max_keypoints, grid_cells=cfg.grid_cells
            )
        if kind in ("KAZE", "AKAZE"):
            from matchinglib_poselib_tpu.ops import nonlinear_diffusion

            return nonlinear_diffusion.kaze_keypoints(
                img, cfg.max_keypoints, grid_cells=cfg.grid_cells
            )
        return scale_space.pyramid_fast_keypoints(
            img, cfg.max_keypoints, cfg.fast_threshold / 255.0,
            n_levels=cfg.pyramid_levels, scale_factor=cfg.pyramid_scale,
            harris_rank=kind == "ORB", grid_cells=cfg.grid_cells,
        )
    score = nms(_DETECTOR_FNS[kind](img, cfg), cfg.nms_radius)
    if detector_bands(cfg):
        xy, sc, mask = select_keypoints_banded(
            score, cfg.max_keypoints, bands=cfg.column_bands,
            nms_radius=cfg.nms_radius,
        )
    else:
        xy, sc, mask = select_keypoints_grid(
            score, cfg.max_keypoints, cfg.grid_cells
        )
    xy = refine_subpixel(score, xy, mask)
    return Keypoints(
        xy=xy,
        score=sc,
        angle=jnp.zeros_like(sc),
        scale=jnp.ones_like(sc),
        mask=mask,
    )


def detector_bands(cfg: DetectorConfig) -> int:
    """Band count of cfg's keypoint layout, or 0 when not banded.

    Single source of truth for the banded-selection contract between
    detect_keypoints and extract_patches (pipeline passes this through
    to compute_descriptors).
    """
    kind = DETECTOR_ALIASES.get(cfg.kind.upper(), "FAST")
    scale_space = kind in (
        "SIFT", "SURF", "STAR", "MSD", "MSER", "KAZE", "AKAZE"
    ) or (kind in ("ORB", "BRISK") and cfg.pyramid_levels > 1)
    if (
        scale_space
        or cfg.column_bands <= 0
        or cfg.max_keypoints % cfg.column_bands != 0
    ):
        return 0
    return cfg.column_bands


@functools.partial(jax.jit, static_argnames=("cfg", "bands"))
def compute_descriptors(
    img: jax.Array, kps: Keypoints, cfg: DescriptorConfig,
    bands: int = 0,
) -> tuple[jax.Array, Keypoints]:
    """getDescriptors equivalent (features.cpp:397).

    Returns (descriptors, keypoints-with-orientation). Binary descriptors
    are (K, 8) uint32; float descriptors (K, 128) float32.

    bands: pass features.detector_bands(det_cfg) when kps came from the
    banded selection — enables the banded patch-extraction fast path.
    """
    patches = extract_patches(img, kps.xy, cfg.patch_size, bands=bands)
    angles = orientation_ic(patches) if cfg.oriented else jnp.zeros(
        patches.shape[0], img.dtype
    )
    kind = DESCRIPTOR_ALIASES.get(cfg.kind.upper(), "BRIEF")
    if kind == "BRIEF":
        desc = brief_descriptor_orb(patches, angles, cfg.oriented)
    elif kind in ("RING", "RING_LOG"):
        from matchinglib_poselib_tpu.ops import descriptors_ext

        desc = descriptors_ext.ring_pattern_descriptor(
            patches, angles, cfg.oriented, log_spacing=kind == "RING_LOG"
        )
    elif kind == "BOLD":
        from matchinglib_poselib_tpu.ops import descriptors_ext

        bits, mask = descriptors_ext.bold_descriptor(
            patches, angles, cfg.oriented
        )
        # bits and stability mask ride together: (K, 32) uint32
        desc = jnp.concatenate([bits, mask], axis=1)
    elif kind == "RIFF":
        from matchinglib_poselib_tpu.ops import descriptors_ext

        desc = descriptors_ext.riff_descriptor(patches, angles, cfg.oriented)
    elif kind == "MLDB":
        from matchinglib_poselib_tpu.ops import nonlinear_diffusion

        desc = nonlinear_diffusion.mldb_descriptor(
            patches, angles, cfg.oriented
        )
    elif kind in ("MSURF", "SURF64"):
        from matchinglib_poselib_tpu.ops import nonlinear_diffusion

        desc = nonlinear_diffusion.msurf_descriptor(
            patches, angles, cfg.oriented
        )
    elif kind == "LATCH":
        from matchinglib_poselib_tpu.ops import descriptors_learned

        desc = descriptors_learned.latch_descriptor(
            patches, angles, cfg.oriented
        )
    elif kind in ("BGM", "LBGM") or kind.startswith("BINBOOST"):
        from matchinglib_poselib_tpu.ops import descriptors_learned

        desc = descriptors_learned.boostdesc_descriptor(
            patches, angles, kind, cfg.oriented
        )
    elif kind.startswith("VGG"):
        from matchinglib_poselib_tpu.ops import descriptors_learned

        desc = descriptors_learned.vgg_descriptor(
            patches, angles, int(kind.split("_")[1]), cfg.oriented
        )
    elif kind == "DAISY":
        from matchinglib_poselib_tpu.ops import descriptors_learned

        desc = descriptors_learned.daisy_descriptor(
            patches, angles, cfg.oriented
        )
    else:
        desc = sift_descriptor(patches, angles, cfg.oriented)
    return desc, kps._replace(angle=angles)
