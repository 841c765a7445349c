"""Extended descriptor family: ring-pattern binary, RIFF, BOLD.

Gives the reference's descriptor long tail (SURVEY.md M3/M10/M11) real
Batched implementations instead of registry aliases:

- ring_pattern_descriptor — concentric-ring sampling with short-distance
  pairwise comparisons: the BRISK/FREAK-class binary descriptor
  (reference: OpenCV BRISK/FREAK via createExtractor,
  features.cpp:849-971). 512 bits from smoothed ring samples; FREAK's
  retinal layout is the log-spaced ring variant.
- riff_descriptor — retina-inspired float descriptor
  (reference: descriptor-RIFF/riff.cpp:20-53, Retinapattern_Bulid /
  Descriptor_Generation): per-ring-cell intensity + radial/tangential
  gradient statistics in the keypoint frame, L2-normalized.
- bold_descriptor / bold_distance_matrix / match_bold — binary online
  learned descriptor (reference: descriptor-BOLD/bold.cpp:146
  compute_patch): per-patch bit stability masks from affine-rotated
  re-tests; matching uses the two-way masked Hamming distance, expressed
  as ONE dense dot product via a signed/masked embedding so it still
  rides a matmul.

All samplers run on the already-extracted (K, P, P) patch tensor —
bilinear gathers batched over keypoints, no per-keypoint loops.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# ring sampling pattern (BRISK / FREAK class)
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _ring_pattern(n_rings: int = 5, log_spacing: bool = False):
    """Sampling points on concentric rings (unit-radius patch frame) and
    the 512 shortest-distance point pairs (BRISK's comparison rule)."""
    rng = np.random.default_rng(7)
    pts = [(0.0, 0.0)]
    sigmas = [0.05]
    for r in range(1, n_rings + 1):
        if log_spacing:  # FREAK-like retinal layout
            rad = 0.95 * (np.exp(r / n_rings * 1.1) - 1.0) / (np.e**1.1 - 1.0)
        else:  # BRISK-like linear rings
            rad = 0.95 * r / n_rings
        n_pts = 6 + 4 * r
        phase = rng.uniform(0, 2 * np.pi)
        for i in range(n_pts):
            a = phase + 2 * np.pi * i / n_pts
            pts.append((rad * np.cos(a), rad * np.sin(a)))
            sigmas.append(0.03 + 0.12 * rad)
    pts = np.asarray(pts, np.float32)
    sigmas = np.asarray(sigmas, np.float32)

    # short-distance pairs, sorted by distance, first 512
    n = len(pts)
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.hypot(*(pts[i] - pts[j])))
            pairs.append((d, i, j))
    pairs.sort()
    sel = np.asarray([(i, j) for _, i, j in pairs[:512]], np.int32)
    return pts, sigmas, sel


def _smooth_patches(patches):
    """5-tap binomial blur per patch: the ring tests compare smoothed
    samples (BRISK applies per-point Gaussian smoothing; one shared blur
    is the fixed-shape equivalent and halves the bit-flip rate under
    sub-pixel shifts)."""
    k = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], patches.dtype) / 16.0

    def conv(x, axis):
        out = jnp.zeros_like(x)
        for i, ki in enumerate(k):
            out = out + ki * jnp.roll(x, i - 2, axis=axis)
        return out

    return conv(conv(patches, 1), 2)


def _sample_pattern(patches, angles, pts, oriented):
    """(K,P,P) patches, pattern points in [-1,1] -> (K, n_pts) samples."""
    K, P, _ = patches.shape
    c = (P - 1) / 2.0
    if not oriented:
        angles = jnp.zeros_like(angles)
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    px = pts[:, 0][None, :] * c
    py = pts[:, 1][None, :] * c
    gx = jnp.clip(c + ca * px - sa * py, 0.0, P - 1.001)
    gy = jnp.clip(c + sa * px + ca * py, 0.0, P - 1.001)
    x0 = jnp.floor(gx).astype(jnp.int32)
    y0 = jnp.floor(gy).astype(jnp.int32)
    fx = gx - x0
    fy = gy - y0
    flat = patches.reshape(K, P * P)

    def tk(yy, xx):
        return jnp.take_along_axis(flat, yy * P + xx, axis=1)

    return (
        tk(y0, x0) * (1 - fy) * (1 - fx)
        + tk(y0, x0 + 1) * (1 - fy) * fx
        + tk(y0 + 1, x0) * fy * (1 - fx)
        + tk(y0 + 1, x0 + 1) * fy * fx
    )


def _pack512(bits):
    words = bits.astype(jnp.uint32).reshape(-1, 16, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def ring_pattern_descriptor(
    patches: jax.Array,
    angles: jax.Array,
    oriented: bool = True,
    log_spacing: bool = False,
) -> jax.Array:
    """BRISK/FREAK-class 512-bit ring descriptor -> (K, 16) uint32."""
    pts, _, sel = _ring_pattern(log_spacing=log_spacing)
    samples = _sample_pattern(
        _smooth_patches(patches), angles, jnp.asarray(pts), oriented
    )  # (K, n_pts)
    a = jnp.take(samples, jnp.asarray(sel[:, 0]), axis=1)
    b = jnp.take(samples, jnp.asarray(sel[:, 1]), axis=1)
    return _pack512(a < b)


# ---------------------------------------------------------------------------
# RIFF: retina-inspired float descriptor
# ---------------------------------------------------------------------------


def riff_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """(K, 128) float32 retina descriptor (riff.cpp Descriptor_Generation).

    8 rings x 8 angular sectors in the keypoint frame; each cell carries
    (mean intensity, radial-gradient energy) -> 128 dims, L2-normalized
    with Lowe-style clamping. The reference additionally updates keypoint
    orientation/scale from the retina responses; orientation here comes
    from the shared intensity-centroid estimate (features.orientation_ic).
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    c = (P - 1) / 2.0
    ys = (jnp.arange(P, dtype=patches.dtype) - c) / c
    xs = (jnp.arange(P, dtype=patches.dtype) - c) / c
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    ca = jnp.cos(angles)[:, None, None]
    sa = jnp.sin(angles)[:, None, None]
    # pixel coords rotated into the keypoint frame
    rx = ca * xx[None] + sa * yy[None]
    ry = -sa * xx[None] + ca * yy[None]
    rad = jnp.sqrt(rx * rx + ry * ry)
    theta = jnp.arctan2(ry, rx)

    n_rings, n_sect = 8, 8
    ring_idx = jnp.clip((rad * n_rings).astype(jnp.int32), 0, n_rings - 1)
    sect_idx = (
        ((theta + jnp.pi) / (2 * jnp.pi) * n_sect).astype(jnp.int32) % n_sect
    )
    cell = ring_idx * n_sect + sect_idx  # (K, P, P)
    inside = (rad <= 1.0).astype(patches.dtype)

    gx = 0.5 * (jnp.roll(patches, -1, 2) - jnp.roll(patches, 1, 2))
    gy = 0.5 * (jnp.roll(patches, -1, 1) - jnp.roll(patches, 1, 1))
    # radial gradient component in the keypoint frame
    ur = jnp.where(rad > 1e-6, rx / jnp.maximum(rad, 1e-6), 0.0)
    vr = jnp.where(rad > 1e-6, ry / jnp.maximum(rad, 1e-6), 0.0)
    gr = jnp.abs(gx * (ca * ur - sa * vr) + gy * (sa * ur + ca * vr))

    oh = jax.nn.one_hot(
        cell.reshape(K, P * P), n_rings * n_sect, dtype=patches.dtype
    ) * inside.reshape(K, P * P, 1)
    counts = jnp.maximum(jnp.sum(oh, axis=1), 1.0)  # (K, 64)
    mean_i = (
        jnp.einsum("kpc,kp->kc", oh, patches.reshape(K, P * P)) / counts
    )
    mean_g = jnp.einsum("kpc,kp->kc", oh, gr.reshape(K, P * P)) / counts
    desc = jnp.concatenate([mean_i, mean_g], axis=1)  # (K, 128)
    desc = desc - jnp.mean(desc, axis=1, keepdims=True)
    desc = desc / jnp.maximum(
        jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-6
    )
    desc = jnp.minimum(desc, 0.3)
    return desc / jnp.maximum(
        jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-6
    )


# ---------------------------------------------------------------------------
# BOLD: binary online-learned descriptor with per-patch masks
# ---------------------------------------------------------------------------


def bold_descriptor(
    patches: jax.Array,
    angles: jax.Array,
    oriented: bool = True,
    rot_deg: float = 15.0,
):
    """(bits (K, 16) uint32, mask (K, 16) uint32).

    BOLD's online learning (bold.cpp compute_patch): each ring-pattern
    test is re-evaluated under two affine rotations of the patch; a bit
    is kept in the mask only if its value is stable across all three
    views. Matching must use the masked distance (match_bold).
    """
    rot = jnp.deg2rad(jnp.asarray(rot_deg, patches.dtype))
    pts, _, sel = _ring_pattern()
    ptsj = jnp.asarray(pts)
    selj = jnp.asarray(sel)

    smoothed = _smooth_patches(patches)

    def bits_at(extra):
        s = _sample_pattern(smoothed, angles + extra, ptsj, True)
        a = jnp.take(s, selj[:, 0], axis=1)
        b = jnp.take(s, selj[:, 1], axis=1)
        return a < b

    if not oriented:
        angles = jnp.zeros_like(angles)
    b0 = bits_at(0.0)
    bp = bits_at(rot)
    bm = bits_at(-rot)
    stable = (b0 == bp) & (b0 == bm)
    return _pack512(b0), _pack512(stable)


def _signed_masked(bits_u32, mask_u32):
    """uint32-packed (bits, mask) -> (K, 512) signs in {-1,0,1} and (K,)
    mask popcounts."""
    signs = jnp.asarray(
        _unpack_bits(bits_u32) * 2.0 - 1.0, jnp.float32
    )
    m = _unpack_bits(mask_u32).astype(jnp.float32)
    return signs * m, jnp.sum(m, axis=1), signs


def _unpack_bits(words: jax.Array) -> jax.Array:
    n, w = words.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(n, w * 32)


def bold_distance_matrix(
    bits1: jax.Array, mask1: jax.Array, bits2: jax.Array, mask2: jax.Array
) -> jax.Array:
    """Two-way masked Hamming: d(a, b) = ham(a, b | mask_a) +
    ham(a, b | mask_b) (bold.cpp matching rule).

    Matmul form: with s in {-1,+1} and m in {0,1},
    ham(a,b|m_a) = (sum m_a - <s_a m_a, s_b>) / 2, so the full distance
    is one dot product of the augmented embeddings
    u = [-s_a m_a, -s_a, sum(m_a), 1], v = [s_b, s_b m_b, 1, sum(m_b)]:
    d = u . v / 2.
    """
    sm1, c1, s1 = _signed_masked(bits1, mask1)
    sm2, c2, s2 = _signed_masked(bits2, mask2)
    u = jnp.concatenate([-sm1, -s1, c1[:, None], jnp.ones_like(c1)[:, None]],
                        axis=1)
    v = jnp.concatenate([s2, sm2, jnp.ones_like(c2)[:, None], c2[:, None]],
                        axis=1)
    return 0.5 * jnp.dot(u, v.T, preferred_element_type=jnp.float32)


def match_bold(
    bits1, mask1, bits2, mask2, valid1, valid2,
    ratio_test: bool = True, ratio: float = 0.8, cross_check: bool = True,
):
    """2-NN + ratio + cross-check over the masked BOLD distance."""
    from matchinglib_poselib_tpu.ops import matching

    dist = bold_distance_matrix(bits1, mask1, bits2, mask2)
    big = 1e9
    v1 = valid1.astype(bool)
    v2 = valid2.astype(bool)
    dist = jnp.where(v2[None, :], dist, big)
    dist = jnp.where(v1[:, None], dist, big)
    neg, idx = jax.lax.top_k(-dist, 2)
    d_best, d_second = -neg[:, 0], -neg[:, 1]
    keep = v1 & (d_best < big * 0.5)
    if ratio_test:
        keep = keep & (d_best < ratio * d_second)
    if cross_check:
        col_best = jnp.argmin(dist, axis=0)
        keep = keep & (col_best[idx[:, 0]] == jnp.arange(dist.shape[0]))
    return matching.MatchResult(
        idx=idx[:, 0].astype(jnp.int32),
        distance=d_best,
        second_distance=d_second,
        mask=keep,
    )
