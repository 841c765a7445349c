"""Exact descriptor matching: tiled 2-NN with ratio test and cross-check.

Batched replacement for every matcher backend of the reference
(SURVEY.md M4-M6, M12-M15): the 20+ matcher names (GMBSOF, CASHASH, 8 NMSLIB
ANN methods, ANNOY, 5 FLANN methods) all dispatch to this exact engine —
a documented behavioral substitution: ANN graph/hash indexes exist to avoid
exhaustive distance computation on CPUs; on the device the exhaustive distance
matrix IS the fast path (one matmul), with exact (not approximate)
2-NN recall. Reference entry: getMatches (matchers.cpp:115-736),
ratio test ratioTestFlannMatches (ratioMatches_Flann.cpp:52-200).

Key formulations:
- binary descriptors (B bits packed in uint32): Hamming distance via the
  ±1-matmul identity  ham(a, b) = (B - <s_a, s_b>) / 2  with s = 2*bit - 1,
  computed as matmuls in one (N1, B) @ (B, N2) contraction — no popcount
  loops.
- float descriptors: squared L2 via |a|^2 + |b|^2 - 2<a, b> (matmul).
- 2-NN, Lowe ratio (0.75 — LOWE_RATIO), mutual cross-check, and masking of
  padded keypoints are fused around the distance matrix.

The Pallas kernel (ops/pallas/knn.py) tiles the same computation without
the (N1, N2) matrix; this module is the reference XLA path and the
dispatcher.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import LOWE_RATIO


_BIG = 1e9


class MatchResult(NamedTuple):
    """Fixed-shape match set: one slot per query keypoint."""

    idx: jax.Array  # (N1,) int32 index into set 2 (valid slots only)
    distance: jax.Array  # (N1,) best distance
    second_distance: jax.Array  # (N1,) 2nd-best distance (ratio diagnostics)
    mask: jax.Array  # (N1,) bool — match kept

    @property
    def n_matches(self):
        return jnp.sum(self.mask.astype(jnp.int32))


def bits_to_signs(desc: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """Unpack (N, W) uint32 bit-packed descriptors to (N, 32*W) ±1 values."""
    n, w = desc.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    signs = bits.astype(dtype) * 2.0 - 1.0
    return signs.reshape(n, w * 32)


def hamming_distance_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """(N1, W) x (N2, W) packed uint32 -> (N1, N2) float32 Hamming distances.

    bf16 matmul passes are EXACT here: inputs are ±1 and the f32 accumulator
    carries the integer dot product without rounding, so the fast matmul
    path is explicitly requested.
    """
    s1 = bits_to_signs(d1)
    s2 = bits_to_signs(d2)
    bits = s1.shape[-1]
    dot = jnp.dot(
        s1,
        s2.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    return 0.5 * (bits - dot)


def l2_distance_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """(N1, D) x (N2, D) float -> (N1, N2) squared L2 distances (matmul form)."""
    d1 = d1.astype(jnp.float32)
    d2 = d2.astype(jnp.float32)
    sq1 = jnp.sum(d1 * d1, axis=-1, keepdims=True)
    sq2 = jnp.sum(d2 * d2, axis=-1, keepdims=True)
    dot = jnp.dot(d1, d2.T, preferred_element_type=jnp.float32)
    return jnp.maximum(sq1 + sq2.T - 2.0 * dot, 0.0)


def _top2(dist: jax.Array):
    """Row-wise two smallest distances + argmin. dist: (N1, N2)."""
    neg, idx = jax.lax.top_k(-dist, 2)
    return -neg[..., 0], -neg[..., 1], idx[..., 0]


# The Triton kernel measured faster than the XLA path through
# match_descriptors on an H100 at 4096^2, 8192^2, 16384^2 and 30720^2, where
# the (N1, N2) f32 matrix no longer fits the 50 MB L2. At 2048^2 (the
# pipeline's shape) the matrix fits L2 and the fused step timed the same on
# either path, so the XLA path stays there (PERF.md). Those timings are of
# binary descriptors without the radius gate; float L2 and guided matching
# were not timed at the large shapes and keep the XLA path.
_KERNEL_MIN_CELLS = 4096 * 4096


def kernel_pays(n1: int, n2: int, binary: bool = True,
                guided: bool = False) -> bool:
    """Automatic 2-NN path: the kernel only where it measured faster."""
    return binary and not guided and n1 * n2 >= _KERNEL_MIN_CELLS


def _ratio_fallback_keep(keep, keep_no_ratio, d_best, d_second):
    """Best-ratio fallback for low-texture frames.

    Reference (ratioMatches_Flann.cpp:91-110): when fewer than 30 matches
    survive the ratio test, discard it and keep the matches with the best
    distance ratios instead — half of them when 60 < n < 120, at most 60
    when n > 120, and never a match whose ratio exceeds 0.85. Fixed-shape
    masked selection: rank candidates by ratio and keep the best `target`.
    """
    n_kept = jnp.sum(keep.astype(jnp.int32))
    # d_second == 0 (exact duplicate) is the degenerate fully-ambiguous
    # case the strict Lowe inequality rejects — exclude it here too
    ratios = jnp.where(
        keep_no_ratio & (d_second > 1e-12),
        d_best / jnp.maximum(d_second, 1e-12),
        jnp.inf,
    )
    n_base = jnp.sum(keep_no_ratio.astype(jnp.int32))
    target = jnp.where(
        n_base > 120, 60, jnp.where(n_base > 60, n_base // 2, n_base)
    )
    target = jnp.minimum(
        target, jnp.sum((ratios <= 0.85).astype(jnp.int32))
    )
    rank = jnp.argsort(jnp.argsort(ratios))
    keep_fb = keep_no_ratio & (rank < target)
    return jnp.where(n_kept < 30, keep_fb, keep)


def _nn_xla(desc1, desc2, v1, v2, guide, binary, spatial_penalty,
            cross_check):
    """Dense path: (d_best, d_second, idx, col_best) from the full matrix."""
    if binary:
        dist = hamming_distance_matrix(desc1, desc2)
    else:
        dist = l2_distance_matrix(desc1, desc2)
    if spatial_penalty is not None:
        dist = dist + spatial_penalty
    if guide is not None:
        guide_pred, guide_rad, pts2_xy = guide
        d2g = jnp.sum(
            (guide_pred[:, None, :] - pts2_xy[None, :, :]) ** 2, axis=-1
        )
        dist = jnp.where(d2g <= guide_rad[:, None] ** 2, dist, dist + _BIG)
    dist = jnp.where(v2[None, :], dist, _BIG)
    dist = jnp.where(v1[:, None], dist, _BIG)
    d_best, d_second, idx = _top2(dist)
    # backward top-1: argmin over rows for each column
    col_best = jnp.argmin(dist, axis=0) if cross_check else None
    return d_best, d_second, idx, col_best


def _nn_kernel(desc1, desc2, v1, v2, guide, binary, cross_check, interpret):
    """Fused Triton kernel path (ops/pallas/knn.py): no (N1, N2) matrix."""
    from matchinglib_poselib_tpu.ops.pallas import knn

    if binary:
        a = bits_to_signs(desc1)
        b = bits_to_signs(desc2)
        bits = a.shape[-1]
    else:
        a = desc1.astype(jnp.float32)
        b = desc2.astype(jnp.float32)
        bits = 0
    pred = rad2 = pts2 = None
    if guide is not None:
        pred, rad, pts2 = guide
        rad2 = rad * rad
    d_best, d_second, idx = knn.knn2(
        a, b, v2, pred, rad2, pts2,
        binary=binary, bits=bits, xy_mode=1 if guide is not None else 0,
        interpret=interpret,
    )
    idx = jnp.maximum(idx, 0)
    back = None
    if cross_check:
        # backward top-1 under the mirrored gate
        _, _, back = knn.knn2(
            b, a, v1, pts2, rad2, pred,
            binary=binary, bits=bits, xy_mode=2 if guide is not None else 0,
            interpret=interpret,
        )
    return d_best, d_second, idx, back


def nearest_two(desc1, desc2, v1, v2, guide=None, *, binary: bool,
                cross_check: bool, spatial_penalty=None,
                use_pallas: bool | None = None, interpret: bool = False):
    """2-NN of every desc1 row among valid desc2 rows, and the reverse top-1.

    Returns (d_best, d_second, idx, col_best), where col_best[j] is the
    desc1 row nearest to desc2 row j (None without ``cross_check``); ties
    go to the lowest index on both paths. v1/v2 are bool masks; ``guide``
    is (pred, radius, pts2) or None. The path is chosen as documented in
    match_descriptors.
    """
    ops = (desc1, desc2, v1, v2, guide)

    def xla(*ops):
        return _nn_xla(*ops, binary, spatial_penalty, cross_check)

    def kernel(*ops):
        return _nn_kernel(*ops, binary, cross_check, interpret)

    if use_pallas is None:
        if spatial_penalty is None and kernel_pays(
                desc1.shape[0], desc2.shape[0], binary, guide is not None):
            return jax.lax.platform_dependent(*ops, cuda=kernel, default=xla)
        return xla(*ops)
    return kernel(*ops) if use_pallas else xla(*ops)


@functools.partial(
    jax.jit,
    static_argnames=(
        "binary", "ratio_test", "cross_check", "use_pallas", "ratio_fallback",
        "interpret",
    ),
)
def match_descriptors(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    binary: bool = True,
    ratio_test: bool = True,
    ratio: float = LOWE_RATIO,
    cross_check: bool = True,
    max_distance: float | None = None,
    spatial_penalty: jax.Array | None = None,
    guide_pred: jax.Array | None = None,
    guide_rad: jax.Array | None = None,
    pts2_xy: jax.Array | None = None,
    use_pallas: bool | None = None,
    ratio_fallback: bool = True,
    interpret: bool = False,
) -> MatchResult:
    """Exact 2-NN matching with ratio test and mutual cross-check.

    ``ratio_fallback``: when <30 matches survive the ratio test, keep the
    best-ratio 50% (at most 60, ratio <= 0.85) instead — the reference's
    low-texture fallback (ratioMatches_Flann.cpp:91-110). Here it selects
    among candidates that already passed the cross-check/max-distance
    gates (the reference's FLANN path has neither).

    desc1: (N1, W|D), desc2: (N2, W|D); valid1/valid2 mask padded slots.

    Guided matching (GMbSOF guidedMatching, match_statOptFlow.cpp:4410) —
    restrict candidates of query i to a circle around the SOF-predicted
    position: pass ``guide_pred`` (N1, 2), ``guide_rad`` (N1,) and
    ``pts2_xy`` (N2, 2). ``spatial_penalty`` (N1, N2) is the legacy dense
    form (0 inside / +big outside), XLA path only.

    ``use_pallas``: None = automatic: the fused Triton kernel
    (ops/pallas/knn.py) when the program is lowered for a CUDA GPU and the
    case is one where it measured faster (``kernel_pays``: binary,
    unguided, from 4096^2 up), else the XLA path. True forces the kernel,
    False the XLA path. ``interpret`` runs the forced kernel in the Pallas
    interpreter (tests without a GPU).
    """
    v1 = valid1.astype(bool)
    v2 = valid2.astype(bool)
    guide = None if guide_pred is None else (guide_pred, guide_rad, pts2_xy)
    d_best, d_second, idx, col_best = nearest_two(
        desc1, desc2, v1, v2, guide, binary=binary, cross_check=cross_check,
        spatial_penalty=spatial_penalty, use_pallas=use_pallas,
        interpret=interpret,
    )
    keep = v1 & (d_best < _BIG * 0.5)
    if max_distance is not None:
        keep = keep & (d_best <= max_distance)
    if cross_check:
        keep = keep & (col_best[idx] == jnp.arange(desc1.shape[0]))
    if ratio_test:
        keep_no_ratio = keep
        # strict Lowe inequality: rejects the degenerate d1 == d2 == 0 case
        keep = keep & (d_best < ratio * d_second)
        if ratio_fallback:
            keep = _ratio_fallback_keep(keep, keep_no_ratio, d_best, d_second)
    return MatchResult(
        idx=idx.astype(jnp.int32),
        distance=d_best,
        second_distance=d_second,
        mask=keep,
    )


def gather_matched_points(
    kp1: jax.Array, kp2: jax.Array, result: MatchResult
):
    """(N1, 2) keypoints -> matched coordinate pairs (N1, 2), (N1, 2), mask.

    Slot i holds the coordinates of keypoint i and its matched partner;
    masked slots carry garbage and must be ignored downstream (every
    consumer in this framework is mask-aware).
    """
    return kp1, kp2[result.idx], result.mask


def estimate_inlier_ratio_from_ratios(result: MatchResult) -> jax.Array:
    """Rough inlier-ratio estimate from the distance-ratio distribution.

    Mirrors the reference's SPRT epsilon initialization from match statistics
    (ratioMatches_Flann.cpp:150-200, pose_helper.cpp:2879
    estimateSprtEpsilonInit): fraction of matches whose ratio is decisively
    good (<0.8 of the already-ratio-tested band).
    """
    r = result.distance / jnp.maximum(result.second_distance, 1e-12)
    good = (r < 0.6) & result.mask
    n = jnp.maximum(jnp.sum(result.mask.astype(jnp.float32)), 1.0)
    return jnp.clip(jnp.sum(good.astype(jnp.float32)) / n, 0.05, 0.95)


# ---------------------------------------------------------------------------
# registry: reference matcher names -> engine configs
# ---------------------------------------------------------------------------

# All names accepted by the reference's getMatches dispatch
# (matchers.cpp:137-527). Each maps to the exact engine; GMBSOF additionally
# runs the SOF-guided second pass (models/pipeline.py).
SUPPORTED_MATCHERS = (
    "GMBSOF",
    "CASHASH",
    "SWGRAPH",
    "HNSW",
    "VPTREE",
    "MVPTREE",
    "GHTREE",
    "LISTCLU",
    "SATREE",
    "BRUTEFORCENMS",
    "ANNOY",
    "HIRCLUIDX",
    "HIRKMEANS",
    "LINEAR",
    "LSHIDX",
    "RANDKDTREE",
    "LKOF",
    "LKOFT",
    "ALKOF",
    "ALKOFT",
)


def is_matcher_supported(name: str) -> bool:
    """Parity with matchinglib::IsMatcherSupported (matchers.cpp:1404)."""
    return name.upper() in SUPPORTED_MATCHERS
