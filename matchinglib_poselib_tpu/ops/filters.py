"""Correspondence filters: GMS grid voting, SOF flow statistics, VFC.

Batched equivalents of the reference's match-filter stack:

- GMS (Grid-based Motion Statistics): reference wraps vendored gms-1.0
  (matchinglib/source/gms.cpp:54-84, thirdparty/gms-1.0/src/MatchGMS.cpp).
  Here: scatter-add matches into a (G^2, G^2) cell-pair histogram, score
  each pair by the 9 diagonally-aligned neighbor cells, threshold at
  alpha * sqrt(mean support) — the GMS rule — over 4 half-cell grid
  offsets, all as dense array ops.

- SOF (Statistical Optical Flow), the heart of GMbSOF
  (match_statOptFlow.cpp:2608 getStatisticalMatchingPositions,
  :2266 interpolStatOptFlow, :4410 guidedMatching): per-grid-cell robust
  flow statistics (masked median/mean/std of dx/dy), cell validation via
  (mean - median)/mean against validationTH, nearest-valid-cell fill +
  smoothing of the flow field, and a guided-matching spatial penalty mask
  built from the interpolated flow and its per-cell uncertainty radius.

- VFC (Vector Field Consensus): EM over a Tikhonov-regularized vector field
  with a Gaussian-kernel Gram matrix (matchinglib/source/vfc.cpp, class VFC,
  include/vfc.h:55-82). Fixed-iteration EM; NORMAL (all points as basis) and
  SPARSE (K basis points) variants.

All filters are fixed-shape and mask-aware.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as geo


# ---------------------------------------------------------------------------
# GMS
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("grid", "shape1", "shape2"))
def gms_filter(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    shape1: tuple[int, int],
    shape2: tuple[int, int],
    grid: int = 20,
    alpha: float = 6.0,
) -> jax.Array:
    """Grid-based motion statistics inlier mask.

    pts1, pts2: (N, 2) pixel coords of matched pairs; mask: (N,) validity.
    shape = (height, width). Returns refined (N,) bool mask.
    """
    h1, w1 = shape1
    h2, w2 = shape2
    N = pts1.shape[0]
    maskf = mask.astype(jnp.float32)

    def run_offset(off_x: float, off_y: float):
        # cell indices with half-cell offsets (the 4 GMS grid shifts)
        cx1 = jnp.clip(
            (pts1[:, 0] / w1 * grid + off_x).astype(jnp.int32), 0, grid - 1
        )
        cy1 = jnp.clip(
            (pts1[:, 1] / h1 * grid + off_y).astype(jnp.int32), 0, grid - 1
        )
        cx2 = jnp.clip(
            (pts2[:, 0] / w2 * grid + off_x).astype(jnp.int32), 0, grid - 1
        )
        cy2 = jnp.clip(
            (pts2[:, 1] / h2 * grid + off_y).astype(jnp.int32), 0, grid - 1
        )
        cell1 = cy1 * grid + cx1
        cell2 = cy2 * grid + cx2

        counts = jnp.zeros((grid * grid, grid * grid), jnp.float32)
        counts = counts.at[cell1, cell2].add(maskf)
        c4 = counts.reshape(grid, grid, grid, grid)

        # score(a, b) = sum over the 9 aligned neighbor shifts
        score4 = jnp.zeros_like(c4)
        support4 = jnp.zeros_like(c4)  # number of contributing cell pairs
        occ = (c4 > 0).astype(jnp.float32)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                shifted = jnp.roll(c4, shift=(di, dj, di, dj), axis=(0, 1, 2, 3))
                occ_s = jnp.roll(occ, shift=(di, dj, di, dj), axis=(0, 1, 2, 3))
                score4 = score4 + shifted
                support4 = support4 + occ_s
        # GMS threshold: alpha * sqrt(mean matches per contributing cell)
        mean_per_cell = score4 / jnp.maximum(support4, 1.0)
        thresh4 = alpha * jnp.sqrt(mean_per_cell)
        accept4 = score4 > thresh4

        return accept4.reshape(grid * grid, grid * grid)[cell1, cell2]

    keep = jnp.zeros((N,), bool)
    for ox, oy in ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)):
        keep = keep | run_offset(ox, oy)
    return keep & mask.astype(bool)


# ---------------------------------------------------------------------------
# SOF — statistical optical flow
# ---------------------------------------------------------------------------


class SOFField(NamedTuple):
    """Per-cell flow statistics on a (gy, gx) grid."""

    flow: jax.Array  # (gy, gx, 2) median flow (dx, dy)
    radius: jax.Array  # (gy, gx) search/uncertainty radius
    valid: jax.Array  # (gy, gx) bool — cell had enough consistent matches


_TWO_PI = 2.0 * jnp.pi


def autoth_validation_th(inlier_ratio: jax.Array, binary: bool) -> jax.Array:
    """AUTOTH: SOF validation threshold from the estimated inlier ratio.

    Reference: match_statOptFlow.cpp:766-801 (compiled-in AUTOTH block of
    AdvancedMatching). Float descriptors: th = clip(ratio, 0.3, 0.75).
    Binary descriptors: th = clip(1.5 * ratio + 0.075, -, 0.75) on the
    0.15..0.45 band, saturating to 0.3 / 0.75 outside it.
    """
    r = jnp.asarray(inlier_ratio, jnp.float32)
    if binary:
        mid = jnp.minimum(1.5 * r + 0.075, 0.75)
        return jnp.where(r >= 0.45, 0.75, jnp.where(r <= 0.15, 0.3, mid))
    return jnp.clip(r, 0.3, 0.75)


def _partition_median(
    vals: jax.Array, ckey: jax.Array, counts: jax.Array, starts: jax.Array,
    C: int,
):
    """Per-cell median when cells PARTITION the points.

    One lexicographic sort of the N (cell, value) pairs replaces the
    (C, N) row-sorts of the dense masked formulation (each row of which
    re-sorts the same N values under a different mask) — the profiler
    showed those sorts costing ~0.9 ms/step in sof_statistics. ckey must
    be the cell id with invalid points mapped to C; counts/starts the
    per-cell sizes and exclusive prefix (shared across calls).
    """
    _, vs = jax.lax.sort((ckey, vals), num_keys=2)
    n = counts
    lo = jnp.clip(starts + jnp.maximum(n - 1, 0) // 2, 0, vals.shape[0] - 1)
    hi = jnp.clip(
        starts + jnp.maximum(n - 1, 0) // 2 + jnp.maximum(n - 1, 0) % 2,
        0, vals.shape[0] - 1,
    )
    med = 0.5 * (jnp.take(vs, lo) + jnp.take(vs, hi))
    return jnp.where(n > 0, med, jnp.zeros_like(med))


def _partition_layout(cell: jax.Array, valid: jax.Array, C: int):
    """(ckey, counts, starts) for _partition_median."""
    ckey = jnp.where(valid, cell, C).astype(jnp.int32)
    counts = jnp.bincount(ckey, length=C + 1)[:C]
    starts = jnp.concatenate(
        [jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]]
    )
    return ckey, counts, starts


def _partition_median_batch(
    vals: jax.Array, ckey: jax.Array, counts: jax.Array, starts: jax.Array,
    C: int,
):
    """Per-cell medians of B independent value arrays in ONE batched sort.

    vals: (B, N); the (ckey, value) rows sort independently along the
    last axis (lax.sort treats leading dims as batch), so B medians cost
    one sort dispatch instead of B sequential ones — sof_statistics's
    partition-median chain was ~10 sequential sorts on the fused step's
    critical path. Same math as _partition_median per row.
    """
    B, N = vals.shape
    keys = jnp.broadcast_to(ckey[None], (B, N))
    _, vs = jax.lax.sort((keys, vals), dimension=-1, num_keys=2)
    n = counts
    lo = jnp.clip(starts + jnp.maximum(n - 1, 0) // 2, 0, N - 1)
    hi = jnp.clip(
        starts + jnp.maximum(n - 1, 0) // 2 + jnp.maximum(n - 1, 0) % 2,
        0, N - 1,
    )
    med = 0.5 * (
        jnp.take_along_axis(vs, jnp.broadcast_to(lo[None], (B, C)), axis=1)
        + jnp.take_along_axis(vs, jnp.broadcast_to(hi[None], (B, C)), axis=1)
    )
    return jnp.where(n[None] > 0, med, jnp.zeros_like(med))


def _segment_sums(vals: jax.Array, seg: jax.Array, num_segments: int):
    """Per-segment sums over the last axis as one dense masked reduction.

    vals, seg: (..., N), seg in [0, num_segments). A scatter-add
    (jax.ops.segment_sum) adds with atomics on a GPU, so the program does
    not fix the order of the f32 additions, nor the rounding of each sum;
    the reduction here has a fixed order. The (num_segments, N) mask is
    small at SOF sizes (~85 cells x 2048 points).
    """
    onehot = seg[..., None, :] == jnp.arange(num_segments)[:, None]
    return jnp.sum(jnp.where(onehot, vals[..., None, :], 0.0), axis=-1)


def _partition_moments_batch(
    vals: jax.Array, cell: jax.Array, valid: jax.Array, C: int,
    trim: bool = True,
):
    """Batched per-cell (median, mean, std) over a shared partition.

    vals: (B, N) independent value arrays over the SAME (cell, valid)
    partition. Identical statistics to _partition_moments per row, with
    the B median sorts and B trim sorts batched into one each.
    """
    B, N = vals.shape
    ckey, counts, starts = _partition_layout(cell, valid, C)
    med = _partition_median_batch(vals, ckey, counts, starts, C)  # (B, C)
    cell_c = jnp.clip(cell, 0, C - 1)
    keep = jnp.broadcast_to(valid[None], (B, N))
    if trim:
        dev = jnp.abs(vals - jnp.take_along_axis(
            med, jnp.broadcast_to(cell_c[None], (B, N)), axis=1))
        half = _partition_median_batch(dev, ckey, counts, starts, C)
        keep = keep & (
            dev <= jnp.take_along_axis(
                half, jnp.broadcast_to(cell_c[None], (B, N)), axis=1
            ) + 1e-6
        )
    kf = keep.astype(jnp.float32)
    seg = jnp.where(keep, cell[None], C).astype(jnp.int32)
    n = jnp.maximum(_segment_sums(kf, seg, C + 1)[:, :C], 1.0)
    s1 = _segment_sums(vals * kf, seg, C + 1)[:, :C]
    mean = s1 / n
    dv = vals - jnp.take_along_axis(
        mean, jnp.broadcast_to(cell_c[None], (B, N)), axis=1
    )
    s2 = _segment_sums(dv * dv * kf, seg, C + 1)[:, :C]
    return med, mean, jnp.sqrt(s2 / n)


def _partition_moments(
    vals: jax.Array, cell: jax.Array, valid: jax.Array, C: int,
    trim: bool = True,
):
    """Per-cell (median, mean, std) over a partition; optional IQR trim.

    Same statistics as _masked_moments (getStatisticfromVec,
    match_statOptFlow.cpp:4302) computed with partition sorts + segment
    sums instead of dense (C, N) masked row-sorts.
    """
    ckey, counts, starts = _partition_layout(cell, valid, C)
    med = _partition_median(vals, ckey, counts, starts, C)
    keep = valid
    if trim:
        dev = jnp.abs(vals - med[jnp.clip(cell, 0, C - 1)])
        half = _partition_median(dev, ckey, counts, starts, C)
        keep = valid & (dev <= half[jnp.clip(cell, 0, C - 1)] + 1e-6)
    kf = keep.astype(jnp.float32)
    seg = jnp.where(keep, cell, C).astype(jnp.int32)
    n = jnp.maximum(_segment_sums(kf, seg, C + 1)[:C], 1.0)
    s1 = _segment_sums(vals * kf, seg, C + 1)[:C]
    mean = s1 / n
    dv = vals - mean[jnp.clip(cell, 0, C - 1)]
    s2 = _segment_sums(dv * dv * kf, seg, C + 1)[:C]
    return med, mean, jnp.sqrt(s2 / n)


def _partition_circ_moments(
    ang: jax.Array, cell: jax.Array, valid: jax.Array, C: int,
    trim: bool = True,
):
    """Circular per-cell moments over a partition (branch-cut hypotheses
    as in _masked_circ_moments / getAngularStatistic)."""
    a1 = jnp.mod(ang, _TWO_PI)
    a2 = jnp.mod(ang + jnp.pi, _TWO_PI)
    med1, mean1, std1 = _partition_moments(a1, cell, valid, C, trim)
    med2, mean2, std2 = _partition_moments(a2, cell, valid, C, trim)
    pick1 = std1 <= std2
    med = jnp.where(pick1, med1, jnp.mod(med2 - jnp.pi, _TWO_PI))
    mean = jnp.where(pick1, mean1, jnp.mod(mean2 - jnp.pi, _TWO_PI))
    std = jnp.where(pick1, std1, std2)
    return med, mean, std


def _masked_moments(vals: jax.Array, member: jax.Array, trim: bool = True):
    """Per-row (median, mean, std) over masked entries; optional IQR trim.

    Reference getStatisticfromVec (match_statOptFlow.cpp:4302) with
    rejQuartiles=true computes mean/std after rejecting the lower and upper
    quartiles; the median is taken from the full set.
    """
    med = geo.masked_median(vals, member)
    memberf = member.astype(jnp.float32)
    if trim:
        dev = jnp.abs(vals - med[..., None])
        # IQR band around the median: keep the central half by absolute
        # deviation (rank-based quartile rejection on the folded values)
        half = geo.masked_median(dev, member)
        band = member & (dev <= half[..., None] + 1e-6)
        memberf = band.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(memberf, axis=-1), 1.0)
    mean = jnp.sum(vals * memberf, axis=-1) / n
    var = jnp.sum((vals - mean[..., None]) ** 2 * memberf, axis=-1) / n
    return med, mean, jnp.sqrt(var)


def _masked_circ_moments(ang: jax.Array, member: jax.Array,
                         trim: bool = True):
    """Circular (median, mean, std) per row, wrap-around robust.

    Reference getAngularStatistic (match_statOptFlow.cpp:4177) splits the
    angles at the 0/2pi seam into two branch-cut hypotheses and keeps the
    one with the smaller dispersion. Here both hypotheses (cut at 0 and at
    pi) are evaluated densely and selected per row.
    """
    a1 = jnp.mod(ang, _TWO_PI)  # cut at 0
    a2 = jnp.mod(ang + jnp.pi, _TWO_PI)  # cut at pi (values shifted +pi)
    med1, mean1, std1 = _masked_moments(a1, member, trim)
    med2, mean2, std2 = _masked_moments(a2, member, trim)
    pick1 = std1 <= std2
    med = jnp.where(pick1, med1, jnp.mod(med2 - jnp.pi, _TWO_PI))
    mean = jnp.where(pick1, mean1, jnp.mod(mean2 - jnp.pi, _TWO_PI))
    std = jnp.where(pick1, std1, std2)
    return med, mean, std


def _circ_diff(a: jax.Array, b: jax.Array) -> jax.Array:
    """Smallest absolute angular difference on the circle."""
    d = jnp.mod(a - b, _TWO_PI)
    return jnp.minimum(d, _TWO_PI - d)


@functools.partial(
    jax.jit, static_argnames=("shape", "cell_px", "per_cell")
)
def select_strongest_per_cell(
    xy: jax.Array,
    response: jax.Array,
    mask: jax.Array,
    shape: tuple[int, int],
    cell_px: int = 100,
    per_cell: int = 32,
) -> jax.Array:
    """Keep the `per_cell` strongest keypoints of every grid cell.

    Reference: get_Sparse_KeypointField (match_statOptFlow.cpp:5215) feeds
    the INITIAL matching stage with a few strongest-response keypoints per
    grid element (>= ceil(50 / n_cells) each, response-banded) so the SOF
    field is estimated from a spatially balanced, high-confidence subset.
    Here: rank within each cell by response via two stable sorts; no trees.
    """
    h, w = shape
    gy = max(1, (h + cell_px - 1) // cell_px)
    gx = max(1, (w + cell_px - 1) // cell_px)
    n = xy.shape[0]
    maskb = mask.astype(bool)
    cx = jnp.clip((xy[:, 0] / cell_px).astype(jnp.int32), 0, gx - 1)
    cy = jnp.clip((xy[:, 1] / cell_px).astype(jnp.int32), 0, gy - 1)
    cell = jnp.where(maskb, cy * gx + cx, gy * gx)  # invalid -> sentinel

    # sort by response desc (invalid last), then stably by cell: within each
    # cell the order stays response-descending
    resp = jnp.where(maskb, response, -jnp.inf)
    by_resp = jnp.argsort(-resp, stable=True)
    by_cell = jnp.argsort(cell[by_resp], stable=True)
    order = by_resp[by_cell]  # (N,) final positions
    cs = cell[order]
    pos = jnp.arange(n)
    is_new = jnp.concatenate(
        [jnp.ones(1, bool), cs[1:] != cs[:-1]]
    )
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_new, pos, 0)
    )
    rank = pos - seg_start
    keep_sorted = rank < per_cell
    keep = jnp.zeros(n, bool).at[order].set(keep_sorted)
    return keep & maskb


@functools.partial(
    jax.jit, static_argnames=("shape", "cell_px", "min_per_cell", "std_mult")
)
def sof_statistics(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    shape: tuple[int, int],
    cell_px: int = 100,
    validation_th: float | jax.Array = 0.3,
    min_per_cell: int = 8,
    std_mult: float = 3.5,
) -> SOFField:
    """Per-cell robust flow statistics + dual validation + fill/smooth.

    Reference: getStatisticalMatchingPositions (match_statOptFlow.cpp:2608):

    - per-cell DISTANCE statistics (quartile-rejected median/mean/std of
      the flow magnitude) and ANGLE statistics (getAngularStatistic :4177,
      branch-cut-hypothesis circular stats);
    - dual cell validation (:3410-3450): a cell fails on distances when
      |mean - med| / (mean + 0.1) > validationTH AND |mean - med| > 0.5
      (minAbsDistDiff :2621), and on angles when the circular
      |mean - med| / pi exceeds validationTH / 6 (validThAngDivFact :2620);
    - stats-over-stats band filter (:3488-3530): global angle/distance
      statistics over the valid cells' medians (std floors
      1.07*atan(1/(mu_d+0.1))/4 and 0.5), individual flow vectors outside
      mean +- 4*std (stdMult_th :2619) are removed before the per-cell flow
      medians and search radii are recomputed;
    - search radius r = stdMult * sigma (:2618, stdMult default 3.5,
      clamped to [1, 7] at :2642-2652);
    - interpolStatOptFlow (:2266) fills and smooths invalid cells.

    Membership is a dense (C, N) mask and statistics are masked sorts — no
    trees. validation_th may be a traced scalar (AUTOTH adapts it from the
    estimated inlier ratio, autoth_validation_th); when the primary
    threshold validates zero cells the strict fallback threshold 0.3 is
    applied (the reference's one retry with estim_inlRatio = 0.001 at
    :806-825).
    """
    h, w = shape
    gy = max(1, (h + cell_px - 1) // cell_px)
    gx = max(1, (w + cell_px - 1) // cell_px)
    C = gy * gx
    maskb = mask.astype(bool)
    std_mult = min(max(std_mult, 1.0), 7.0)
    vth = jnp.clip(jnp.asarray(validation_th, jnp.float32), 0.1, 1.0)

    cx = jnp.clip((pts1[:, 0] / cell_px).astype(jnp.int32), 0, gx - 1)
    cy = jnp.clip((pts1[:, 1] / cell_px).astype(jnp.int32), 0, gy - 1)
    cell = cy * gx + cx  # (N,)

    flow = pts2 - pts1  # (N, 2)
    # cells partition the points: per-cell statistics run on partition
    # sorts + segment sums (N log N once) instead of dense (C, N) masked
    # row-sorts (profiled at ~0.9 ms/step in the fused pipeline)
    n_cell = _partition_layout(cell, maskb, C)[1].astype(jnp.float32)

    mag = jnp.linalg.norm(flow, axis=-1)  # (N,)
    ang = jnp.mod(jnp.arctan2(flow[:, 1], flow[:, 0]), _TWO_PI)  # (N,)

    # distance stats + both circular branch-cut hypotheses in ONE
    # batched partition pass (3 value rows, shared partition): the
    # sequential version put ~6 full sorts on the critical path here
    a1 = ang
    a2 = jnp.mod(ang + jnp.pi, _TWO_PI)
    med3, mean3, std3 = _partition_moments_batch(
        jnp.stack([mag, a1, a2]), cell, maskb, C
    )
    d_med, d_mean, d_std = med3[0], mean3[0], std3[0]
    pick1 = std3[1] <= std3[2]
    a_med = jnp.where(pick1, med3[1], jnp.mod(med3[2] - jnp.pi, _TWO_PI))
    a_mean = jnp.where(pick1, mean3[1], jnp.mod(mean3[2] - jnp.pi, _TWO_PI))
    a_std = jnp.where(pick1, std3[1], std3[2])

    # dual validation (distance + angle), per cell
    d_diff = jnp.abs(d_mean - d_med)
    dist_fail = (d_diff / (d_mean + 0.1) > vth) & (d_diff > 0.5)
    a_diff = _circ_diff(a_mean, a_med) / jnp.pi
    ang_fail = a_diff > (vth / 6.0)
    enough = n_cell >= min_per_cell
    valid = enough & ~dist_fail & ~ang_fail
    # AUTOTH retry (:806-825): zero validated cells -> strict threshold 0.3
    fb_dist_fail = (d_diff / (d_mean + 0.1) > 0.3) & (d_diff > 0.5)
    fb_ang_fail = a_diff > 0.05
    valid_fb = enough & ~fb_dist_fail & ~fb_ang_fail
    valid = jnp.where(jnp.any(valid), valid, valid_fb)

    # stats-over-stats: global angle/distance statistics over the medians
    # of the validated cells, with the reference's std floors
    _, g_ang_mean, g_ang_std = _masked_circ_moments(
        a_med[None, :], valid[None, :], trim=False
    )
    _, g_d_mean, g_d_std = _masked_moments(
        d_med[None, :], valid[None, :], trim=False
    )
    g_ang_mean, g_ang_std = g_ang_mean[0], g_ang_std[0]
    g_d_mean, g_d_std = g_d_mean[0], g_d_std[0]
    min_std_ang = 1.07 * jnp.arctan(1.0 / (g_d_mean + 0.1)) / 4.0
    g_ang_std = jnp.maximum(g_ang_std, min_std_ang)
    g_d_std = jnp.maximum(g_d_std, 0.5)

    # band filter individual flow vectors at mean +- 4 sigma, then
    # recompute the per-cell flow medians + dispersion on the survivors
    in_band = (
        (_circ_diff(ang, g_ang_mean) <= 4.0 * g_ang_std)
        & (jnp.abs(mag - g_d_mean) <= 4.0 * g_d_std)
    )
    any_band = jnp.any(in_band & maskb)
    valid2 = maskb & jnp.where(any_band, in_band, maskb)
    ckey2, counts2, starts2 = _partition_layout(cell, valid2, C)
    n2 = counts2.astype(jnp.float32)

    # (dx, dy, mag) medians share one batched sort; the MAD needs the
    # medians first (dependent) and runs as the second round
    med_b = _partition_median_batch(
        jnp.stack([flow[:, 0], flow[:, 1], mag]), ckey2, counts2, starts2, C
    )
    med_dx, med_dy, med_mag2 = med_b[0], med_b[1], med_b[2]
    cmed = jnp.stack([med_dx, med_dy], axis=-1)  # (C, 2)
    dev_pt = jnp.linalg.norm(flow - cmed[cell], axis=-1)  # (N,)
    mad = _partition_median(dev_pt, ckey2, counts2, starts2, C)
    sigma = 1.4826 * mad  # robust sigma from the MAD
    # dispersion bound on the surviving members: a cell with a real
    # dominant flow has sigma far below the flow magnitude; uniform-random
    # cells keep sigma ~ image scale even after the band filter (the
    # reference reaches the same end through its huge stdMult*sigma search
    # radius, which the ratio test then empties — here the cell is marked
    # invalid so the field fill interpolates over it instead)
    sigma_ok = sigma <= vth * jnp.maximum(med_mag2, 80.0)
    valid = valid & sigma_ok & (n2 >= jnp.minimum(min_per_cell, 2.0))

    cell_flow = jnp.stack([med_dx, med_dy], axis=-1).reshape(gy, gx, 2)
    cell_rad = (std_mult * sigma + 4.0).reshape(gy, gx)
    validg = valid.reshape(gy, gx)

    # fill invalid cells by distance-weighted average of valid cells
    yy, xx = jnp.meshgrid(jnp.arange(gy), jnp.arange(gx), indexing="ij")
    coords = jnp.stack([yy, xx], axis=-1).reshape(C, 2).astype(jnp.float32)
    d2 = jnp.sum(
        (coords[:, None, :] - coords[None, :, :]) ** 2, axis=-1
    )  # (C, C)
    wgt = jnp.where(validg.reshape(1, C), 1.0 / (1.0 + d2), 0.0)
    wsum = jnp.maximum(jnp.sum(wgt, axis=1), 1e-9)
    fill_flow = (wgt @ cell_flow.reshape(C, 2)) / wsum[:, None]
    fill_rad = (wgt @ cell_rad.reshape(C)) / wsum
    any_valid = jnp.any(validg)
    flow_out = jnp.where(
        validg.reshape(C, 1), cell_flow.reshape(C, 2), fill_flow
    ).reshape(gy, gx, 2)
    # invalid cells get inflated uncertainty: x2 the interpolated radius
    # PLUS growth with the distance to the nearest valid cell, like the
    # reference's distance-dependent radius growth in interpolStatOptFlow
    # (match_statOptFlow.cpp:2266) — a field supported by a single distant
    # cell must not impose that cell's tight radius everywhere
    dmin = jnp.sqrt(
        jnp.min(jnp.where(validg.reshape(1, C), d2, jnp.inf), axis=1)
    )  # (C,) distance in cell units to the nearest valid cell
    rad_out = jnp.where(
        validg.reshape(C),
        cell_rad.reshape(C),
        2.0 * fill_rad + 0.5 * cell_px * dmin,
    ).reshape(gy, gx)
    rad_out = jnp.where(any_valid, rad_out, jnp.full_like(rad_out, 1e6))
    return SOFField(flow=flow_out, radius=rad_out, valid=validg)


def sof_predict(field: SOFField, pts1: jax.Array, cell_px: int):
    """Predicted positions + radii for query points via bilinear field lookup."""
    gy, gx = field.radius.shape
    # cell-center continuous coords
    fy = jnp.clip(pts1[:, 1] / cell_px - 0.5, 0.0, gy - 1.0)
    fx = jnp.clip(pts1[:, 0] / cell_px - 0.5, 0.0, gx - 1.0)
    y0 = jnp.floor(fy).astype(jnp.int32)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, gy - 1)
    x1 = jnp.minimum(x0 + 1, gx - 1)
    wy = fy - y0
    wx = fx - x0

    def lerp(arr):
        a = arr[y0, x0]
        b = arr[y0, x1]
        c = arr[y1, x0]
        d = arr[y1, x1]
        if arr.ndim == 3:
            wy_, wx_ = wy[:, None], wx[:, None]
        else:
            wy_, wx_ = wy, wx
        return (
            a * (1 - wy_) * (1 - wx_)
            + b * (1 - wy_) * wx_
            + c * wy_ * (1 - wx_)
            + d * wy_ * wx_
        )

    pred = pts1 + lerp(field.flow)
    rad = lerp(field.radius)
    return pred, rad


def sof_spatial_penalty(
    field: SOFField, pts1: jax.Array, pts2: jax.Array, cell_px: int
) -> jax.Array:
    """(N1, N2) penalty matrix: 0 inside the predicted radius, +big outside.

    Feeds match_descriptors(spatial_penalty=...) to reproduce GMbSOF's
    guided matching (search only near the SOF-predicted position).
    """
    pred, rad = sof_predict(field, pts1, cell_px)
    d2 = jnp.sum((pred[:, None, :] - pts2[None, :, :]) ** 2, axis=-1)
    return jnp.where(d2 <= (rad[:, None] ** 2), 0.0, 1e9)


def sof_cell_valid_at(
    field: SOFField, pts: jax.Array, cell_px: int
) -> jax.Array:
    """Whether each query point's (nearest) grid cell validated."""
    gy, gx = field.radius.shape
    cx = jnp.clip((pts[:, 0] / cell_px).astype(jnp.int32), 0, gx - 1)
    cy = jnp.clip((pts[:, 1] / cell_px).astype(jnp.int32), 0, gy - 1)
    return field.valid[cy, cx]


def sof_predict_knn(
    seed_pts1: jax.Array,
    seed_flow: jax.Array,
    seed_mask: jax.Array,
    query_pts: jax.Array,
    k: int = 8,
    std_mult: float = 3.5,
):
    """Seed-kNN flow prediction: the sparse-seed fallback of the SOF field.

    When the seed match set is too sparse for per-cell statistics (every
    grid cell below min_per_cell — the scale-warp regime of
    GMBSOF_EVAL.md, where the grid field is entirely invalid and guided
    matching degenerates to plain ratio matching), predict each query's
    flow from its k nearest seed matches instead: median flow of the
    neighbors, search radius std_mult * (robust dispersion) grown with
    the distance to the neighborhood (the reference grows radii with
    distance-to-support the same way inside interpolStatOptFlow,
    match_statOptFlow.cpp:2266 — this is that mechanism freed from the
    grid). Dense masked top-k — no trees, static shapes.

    Returns (pred (N,2), rad (N,), ok (N,) bool — false when fewer than
    3 seeds exist at all).
    """
    seedb = seed_mask.astype(bool)
    n_seed = jnp.sum(seedb)
    d2 = jnp.sum(
        (query_pts[:, None, :] - seed_pts1[None, :, :]) ** 2, axis=-1
    )
    d2 = jnp.where(seedb[None, :], d2, jnp.inf)
    # approx_max_k: a >=0.95-recall neighbor set is statistically
    # indistinguishable for median/MAD flow statistics
    neg, idx = jax.lax.approx_max_k(
        -d2, k, recall_target=0.95
    )  # (N, k) nearest seeds
    ndist = jnp.sqrt(jnp.maximum(-neg, 0.0))
    nvalid = jnp.isfinite(neg)  # (N, k)
    nflow = seed_flow[idx]  # (N, k, 2)

    # per-query median flow over the valid neighbors (k is tiny: sort)
    big = 1e9
    fx = jnp.where(nvalid, nflow[..., 0], big)
    fy = jnp.where(nvalid, nflow[..., 1], big)
    nv = jnp.maximum(jnp.sum(nvalid, axis=1), 1)

    def masked_med(v):  # (N, k) with invalid = big
        s = jnp.sort(v, axis=1)
        mid_hi = (nv - 1) // 2 + (nv - 1) % 2
        mid_lo = (nv - 1) // 2
        lo = jnp.take_along_axis(s, mid_lo[:, None], axis=1)[:, 0]
        hi = jnp.take_along_axis(s, mid_hi[:, None], axis=1)[:, 0]
        return 0.5 * (lo + hi)

    med = jnp.stack([masked_med(fx), masked_med(fy)], axis=-1)  # (N, 2)
    dev = jnp.linalg.norm(
        jnp.where(nvalid[..., None], nflow - med[:, None, :], 0.0), axis=-1
    )
    sigma = 1.4826 * masked_med(jnp.where(nvalid, dev, big))
    far = jnp.where(nvalid, ndist, 0.0).max(axis=1)
    pred = query_pts + med
    rad = std_mult * sigma + 4.0 + 0.15 * far
    # per-query validity: approx_max_k at recall < 1 can return no finite
    # neighbor for a query (all-invalid tiles), leaving med/sigma at the
    # big sentinel — such queries must keep their grid prediction rather
    # than a ~1e9 px off-image "prediction" whose radius gates nothing
    ok = (n_seed >= 3) & jnp.any(nvalid, axis=1)
    return pred, rad, ok


def sof_filter_matches(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    shape: tuple[int, int],
    cell_px: int = 100,
    validation_th: float = 0.3,
) -> jax.Array:
    """Filter existing matches by SOF-field consistency.

    Reference: filterMatchesSOF (correspondences.cpp:521).
    """
    field = sof_statistics(
        pts1, pts2, mask, shape, cell_px, validation_th
    )
    pred, rad = sof_predict(field, pts1, cell_px)
    d = jnp.linalg.norm(pts2 - pred, axis=-1)
    return mask.astype(bool) & (d <= rad)


# ---------------------------------------------------------------------------
# VFC — vector field consensus
# ---------------------------------------------------------------------------


class VFCResult(NamedTuple):
    inlier_mask: jax.Array  # (N,) bool
    probabilities: jax.Array  # (N,) posterior inlier probability
    field_values: jax.Array  # (N, 2) interpolated field at x1


@functools.partial(jax.jit, static_argnames=("iterations", "n_basis"))
def vfc_filter(
    pts1: jax.Array,
    pts2: jax.Array,
    mask: jax.Array,
    iterations: int = 30,
    beta: float = 0.1,
    lam: float = 3.0,
    gamma_init: float = 0.9,
    theta: float = 0.75,
    n_basis: int = 0,
) -> VFCResult:
    """Vector Field Consensus EM (reference: vfc.cpp class VFC).

    pts1, pts2: (N, 2) in roughly unit-normalized coordinates (the reference
    normalizes by image size first — callers here pass pixel coords scaled
    to [0,1]). ``n_basis`` = 0 selects the NORMAL variant (every point is a
    basis); n_basis > 0 selects SPARSE_VFC with the first K valid points as
    basis. Fixed ``iterations`` EM steps (the reference iterates to maxIter
    with early exit on tolerance; we run the fixed bound).
    """
    N = pts1.shape[0]
    maskf = mask.astype(jnp.float32)
    Y = pts2 - pts1  # flow vectors to regress

    # Gram matrices
    def gauss(a, b):
        d2 = jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
        return jnp.exp(-beta * d2)

    if n_basis and n_basis < N:
        # choose the first K valid points (order carries no bias here)
        order = jnp.argsort(~mask.astype(bool))  # valid first
        bidx = order[:n_basis]
        Xb = pts1[bidx]
    else:
        Xb = pts1
    K = gauss(Xb, Xb)  # (M, M)
    U = gauss(pts1, Xb)  # (N, M)
    M = Xb.shape[0]

    sigma2_0 = jnp.sum(maskf * jnp.sum(Y * Y, axis=-1)) / jnp.maximum(
        jnp.sum(maskf), 1.0
    )
    a_const = 1.0 / 4.0  # uniform outlier density on the unit square-ish

    def em_step(_, carry):
        C, P, sigma2, gamma = carry
        V = U @ C  # (N, 2) field values
        r2 = jnp.sum((Y - V) ** 2, axis=-1)
        # E-step: posterior inlier probability
        pin = gamma * jnp.exp(-r2 / (2.0 * sigma2)) / (2.0 * jnp.pi * sigma2)
        pout = (1.0 - gamma) * a_const
        P = jnp.where(maskf > 0, pin / jnp.maximum(pin + pout, 1e-30), 0.0)
        # M-step: weighted regularized least squares for C
        WU = U * P[:, None]  # (N, M)
        A = U.T @ WU + lam * sigma2 * K
        # trace-scaled jitter: with few flat Gaussian bases A is nearly
        # rank-deficient once sigma2 shrinks
        tr_A = jnp.trace(A) / M
        A = A + (1e-6 + 1e-4 * tr_A) * jnp.eye(M)
        b = WU.T @ Y
        C = jnp.linalg.solve(A, b)
        V = U @ C
        r2 = jnp.sum((Y - V) ** 2, axis=-1)
        sp = jnp.maximum(jnp.sum(P), 1e-6)
        sigma2 = jnp.maximum(jnp.sum(P * r2) / (2.0 * sp), 1e-8)
        gamma = jnp.clip(sp / jnp.maximum(jnp.sum(maskf), 1.0), 0.05, 0.95)
        return C, P, sigma2, gamma

    C0 = jnp.zeros((M, 2), jnp.float32)
    P0 = maskf
    C, P, sigma2, gamma = jax.lax.fori_loop(
        0, iterations, em_step, (C0, P0, sigma2_0, gamma_init)
    )
    V = U @ C
    inl = (P > theta) & mask.astype(bool)
    return VFCResult(inlier_mask=inl, probabilities=P, field_values=V)
