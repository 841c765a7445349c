"""Learned-family descriptors: LATCH, BoostDesc (BGM/LBGM/BINBOOST), VGG,
plus the classical DAISY and SURF-64 float descriptors.

Batched equivalents of the reference's xfeatures2d descriptor rows
(SURVEY.md M3; createExtractor features.cpp:849-971). The OpenCV versions of
LATCH/BoostDesc/VGG ship binary blobs of trained parameters that are not
reproducible here; these implementations keep the exact *structure*,
dimensionality, and metric of each descriptor but draw the learned selection
tables procedurally from a fixed-seed RNG (documented behavioral
substitution — same datatype + metric contract for every matcher backend).
DAISY and SURF-64 are faithful implementations (their parameters are
published constants, not training artifacts).

All functions take (K, P, P) pre-extracted patches + per-keypoint angles
and are pure fixed-shape jnp — vmap/jit friendly, einsum-heavy so matmuls
does the pooling work.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def _rotated_grads(patches: jax.Array, angles: jax.Array):
    """Image gradients rotated into the keypoint frame: (K,P,P) rx, ry."""
    gx = 0.5 * (jnp.roll(patches, -1, 2) - jnp.roll(patches, 1, 2))
    gy = 0.5 * (jnp.roll(patches, -1, 1) - jnp.roll(patches, 1, 1))
    ca = jnp.cos(angles)[:, None, None]
    sa = jnp.sin(angles)[:, None, None]
    return ca * gx + sa * gy, -sa * gx + ca * gy


def _pack_words(bits: jax.Array, n_words: int) -> jax.Array:
    """(K, n_words*32) {0,1} -> (K, n_words) uint32."""
    K = bits.shape[0]
    words = bits.astype(jnp.uint32).reshape(K, n_words, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# LATCH: learned arrangements of three patch codes
# ---------------------------------------------------------------------------

_LATCH_BITS = 256
_LATCH_HALF_SSD = 3  # mini-patch radius (7x7 windows, OpenCV default)


@functools.lru_cache(maxsize=None)
def _latch_triplets(patch: int, seed: int = 11) -> np.ndarray:
    """(bits, 3, 2) anchor/positive/negative mini-patch centers."""
    rng = np.random.default_rng(seed)
    r = patch // 2 - _LATCH_HALF_SSD - 1
    return rng.uniform(-r, r, size=(_LATCH_BITS, 3, 2)).astype(np.float32)


def latch_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """LATCH-256: bit = [SSD(anchor, patchA) < SSD(anchor, patchB)].

    Structure per Levi & Hassner's LATCH (xfeatures2d row
    features.cpp:880-884); triplet positions are procedural (module
    docstring). Mini-patch SSDs are computed from box-filtered products —
    three stencil passes, no per-bit loops. Returns (K, 8) uint32, Hamming.
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    trip = jnp.asarray(_latch_triplets(P))  # (B, 3, 2) as (dx, dy)
    c = (P - 1) / 2.0
    ca, sa = jnp.cos(angles), jnp.sin(angles)  # (K,)
    # rotate triplet offsets by keypoint angle -> (K, B, 3) coords
    px = trip[None, :, :, 0]
    py = trip[None, :, :, 1]
    gx = c + ca[:, None, None] * px - sa[:, None, None] * py
    gy = c + sa[:, None, None] * px + ca[:, None, None] * py

    # mean/mean-of-squares integral proxies via box filters over each patch
    w = 2 * _LATCH_HALF_SSD + 1
    k1 = jnp.full((1, 1, w, 1), 1.0, patches.dtype)
    k2 = jnp.full((1, 1, 1, w), 1.0, patches.dtype)
    x = patches[:, None]  # (K, 1, P, P)
    box = jax.lax.conv_general_dilated(
        jax.lax.conv_general_dilated(x, k1, (1, 1), "SAME"), k2, (1, 1), "SAME"
    )[:, 0]
    box2 = jax.lax.conv_general_dilated(
        jax.lax.conv_general_dilated(x * x, k1, (1, 1), "SAME"),
        k2, (1, 1), "SAME",
    )[:, 0]

    def sample(maps, xs, ys):
        # nearest-neighbor gather per keypoint from its own patch
        xi = jnp.clip(jnp.round(xs), 0, P - 1).astype(jnp.int32)
        yi = jnp.clip(jnp.round(ys), 0, P - 1).astype(jnp.int32)
        flat = maps.reshape(K, P * P)
        idx = (yi * P + xi).reshape(K, -1)
        return jnp.take_along_axis(flat, idx, axis=1).reshape(xs.shape)

    s1 = sample(box, gx, gy)  # (K, B, 3) window sums
    s2 = sample(box2, gx, gy)  # window sums of squares
    # SSD(a, b) = sum a^2 + sum b^2 - 2 sum(ab); the cross term needs the
    # actual windows. We approximate with a moment distance
    # d(a,b) ~ (mu_a - mu_b)^2 + (va - vb)^2 — an approximation consistent
    # with the documented procedural-table substitution (it ignores the SSD
    # cross term, so orderings can differ for windows with equal moments but
    # different spatial structure)
    mu = s1 / (w * w)
    var = jnp.maximum(s2 / (w * w) - mu * mu, 0.0)
    da = (mu[:, :, 1] - mu[:, :, 0]) ** 2 + (var[:, :, 1] - var[:, :, 0]) ** 2
    db = (mu[:, :, 2] - mu[:, :, 0]) ** 2 + (var[:, :, 2] - var[:, :, 0]) ** 2
    return _pack_words(da < db, _LATCH_BITS // 32)


# ---------------------------------------------------------------------------
# BoostDesc family: boosted gradient-orientation-map weak learners
# ---------------------------------------------------------------------------

_N_ORI = 8  # gradient orientation bins (BoostDesc's gradient maps)


def _gradient_maps(patches: jax.Array, angles: jax.Array) -> jax.Array:
    """(K, P, P, 8) soft-assigned oriented gradient energy maps."""
    rx, ry = _rotated_grads(patches, angles)
    mag = jnp.sqrt(rx * rx + ry * ry)
    ori = jnp.arctan2(ry, rx)  # [-pi, pi]
    two_pi = 2.0 * jnp.pi
    b = (ori % two_pi) / two_pi * _N_ORI  # [0, 8)
    b0 = jnp.floor(b)
    frac = b - b0
    b0i = b0.astype(jnp.int32) % _N_ORI
    b1i = (b0i + 1) % _N_ORI
    oh0 = jax.nn.one_hot(b0i, _N_ORI, dtype=patches.dtype)
    oh1 = jax.nn.one_hot(b1i, _N_ORI, dtype=patches.dtype)
    return mag[..., None] * (
        oh0 * (1.0 - frac[..., None]) + oh1 * frac[..., None]
    )


@functools.lru_cache(maxsize=None)
def _boost_rects(n_weak: int, patch: int, seed: int) -> np.ndarray:
    """Weak-learner pooling regions: (n_weak, 5) = (y0, x0, y1, x1, ori)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_weak):
        h = rng.integers(3, patch // 2)
        w_ = rng.integers(3, patch // 2)
        y0 = rng.integers(0, patch - h)
        x0 = rng.integers(0, patch - w_)
        out.append((y0, x0, y0 + h, x0 + w_, rng.integers(0, _N_ORI)))
    return np.asarray(out, np.int32)


@functools.lru_cache(maxsize=None)
def _boost_masks(n_weak: int, patch: int, seed: int) -> np.ndarray:
    """(n_weak, P*P*8) flattened region x orientation pooling masks."""
    rects = _boost_rects(n_weak, patch, seed)
    m = np.zeros((n_weak, patch, patch, _N_ORI), np.float32)
    for i, (y0, x0, y1, x1, o) in enumerate(rects):
        m[i, y0:y1, x0:x1, o] = 1.0 / ((y1 - y0) * (x1 - x0))
    return m.reshape(n_weak, -1)


def _weak_responses(
    patches: jax.Array, angles: jax.Array, n_weak: int, seed: int
) -> jax.Array:
    """(K, n_weak) thresholded-at-zero-ready pooled gradient responses."""
    K, P, _ = patches.shape
    gm = _gradient_maps(patches, angles).reshape(K, -1)  # (K, P*P*8)
    masks = jnp.asarray(_boost_masks(n_weak, P, seed))  # (W, P*P*8)
    resp = jnp.einsum(
        "kf,wf->kw",
        gm.astype(jnp.bfloat16),
        masks.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    # per-patch mean-centering mirrors BoostDesc's learned thresholds
    return resp - jnp.mean(resp, axis=1, keepdims=True)


def boostdesc_descriptor(
    patches: jax.Array,
    angles: jax.Array,
    variant: str = "BGM",
    oriented: bool = True,
):
    """BoostDesc family (features.cpp BGM/LBGM/BINBOOST rows).

    BGM: 256 boosted weak learners -> 256-bit Hamming (K, 8) u32.
    BINBOOST_{64,128,256}: d bits, each bit a sign of a small linear
      combination of weak learners (K, d/32) u32.
    LBGM: float projection of 512 weak responses to 64-d L2 (K, 64) f32.
    """
    if not oriented:
        angles = jnp.zeros_like(angles)
    v = variant.upper()
    if v == "BGM":
        resp = _weak_responses(patches, angles, 256, seed=21)
        return _pack_words(resp > 0.0, 8)
    if v.startswith("BINBOOST"):
        d = int(v.split("_")[1])
        resp = _weak_responses(patches, angles, 256, seed=23)
        rng = np.random.default_rng(29 + d)
        proj = jnp.asarray(
            rng.normal(size=(256, d)).astype(np.float32) / 16.0
        )
        z = resp @ proj
        return _pack_words(z > 0.0, d // 32)
    if v == "LBGM":
        resp = _weak_responses(patches, angles, 512, seed=31)
        rng = np.random.default_rng(37)
        proj = jnp.asarray(rng.normal(size=(512, 64)).astype(np.float32))
        z = resp @ proj
        return z / jnp.maximum(
            jnp.linalg.norm(z, axis=-1, keepdims=True), 1e-9
        )
    raise ValueError(f"unknown BoostDesc variant {variant}")


# ---------------------------------------------------------------------------
# VGG: pooled gradient features x linear projection
# ---------------------------------------------------------------------------


def vgg_descriptor(
    patches: jax.Array, angles: jax.Array, dims: int, oriented: bool = True
) -> jax.Array:
    """VGG-{120,80,64,48} (features.cpp VGG rows): Simonyan et al.'s
    pooling-region descriptor — oriented gradient maps pooled over a polar
    arrangement of Gaussian regions, then a learned (here: procedural,
    fixed-seed) low-rank projection to `dims`. L2-normalized float.
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    gm = _gradient_maps(patches, angles)  # (K, P, P, 8)

    # polar pooling regions: 1 center + 2 rings x 8 = 17 Gaussian pools
    c = (P - 1) / 2.0
    ys = (jnp.arange(P) - c) / c
    yy, xx = jnp.meshgrid(ys, ys, indexing="ij")
    centers = [(0.0, 0.0)]
    for r, n in ((0.4, 8), (0.8, 8)):
        for i in range(n):
            th = 2 * np.pi * i / n
            centers.append((r * np.cos(th), r * np.sin(th)))
    pools = jnp.stack(
        [
            jnp.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)) / (2 * 0.25**2))
            for cx, cy in centers
        ]
    )  # (17, P, P)
    feats = jnp.einsum(
        "khwo,rhw->kro",
        gm.astype(jnp.bfloat16),
        pools.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ).reshape(K, -1)  # (K, 136)
    rng = np.random.default_rng(41 + dims)
    proj = jnp.asarray(rng.normal(size=(feats.shape[1], dims)) / 12.0, jnp.float32)
    z = feats @ proj
    return z / jnp.maximum(jnp.linalg.norm(z, axis=-1, keepdims=True), 1e-9)


# ---------------------------------------------------------------------------
# DAISY (faithful): ring-sampled orientation maps
# ---------------------------------------------------------------------------


def daisy_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """DAISY (features.cpp DAISY row), faithful parameters: 8 orientation
    maps smoothed at 3 radial levels, sampled at center + 3 rings x 8 =
    25 locations -> 200-d, per-location L2 normalization (Tola et al.).
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    gm = _gradient_maps(patches, angles)  # (K, P, P, 8)

    # three smoothing levels of the orientation maps (separable blur)
    def blur(maps, sigma):
        r = max(1, int(np.ceil(2.5 * sigma)))
        x = np.arange(-r, r + 1, dtype=np.float64)
        k = np.exp(-0.5 * (x / sigma) ** 2)
        k = jnp.asarray((k / k.sum()).astype(np.float32), maps.dtype)
        m = maps.transpose(0, 3, 1, 2).reshape(K * 8, 1, P, P)
        kh = k.reshape(1, 1, -1, 1)
        kw = k.reshape(1, 1, 1, -1)
        m = jax.lax.conv_general_dilated(m, kh, (1, 1), "SAME")
        m = jax.lax.conv_general_dilated(m, kw, (1, 1), "SAME")
        return m.reshape(K, 8, P, P).transpose(0, 2, 3, 1)

    levels = [blur(gm, s) for s in (1.5, 3.0, 5.0)]

    c = (P - 1) / 2.0
    ca, sa = jnp.cos(angles), jnp.sin(angles)
    locs = [(0.0, 0.0, 0)]
    for li, r in enumerate((0.35, 0.65, 0.95)):
        for i in range(8):
            th = 2 * np.pi * i / 8
            locs.append((r * np.cos(th), r * np.sin(th), li))
    out = []
    for lx, ly, li in locs:
        # rotate sample location into keypoint frame
        sx = c + (ca * lx - sa * ly) * c
        sy = c + (sa * lx + ca * ly) * c
        xi = jnp.clip(jnp.round(sx), 0, P - 1).astype(jnp.int32)
        yi = jnp.clip(jnp.round(sy), 0, P - 1).astype(jnp.int32)
        maps = levels[li].reshape(K, P * P, 8)
        idx = (yi * P + xi)[:, None, None]
        h = jnp.take_along_axis(maps, jnp.broadcast_to(idx, (K, 1, 8)), 1)[:, 0]
        h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-9)
        out.append(h)
    return jnp.concatenate(out, axis=-1)  # (K, 200)


# ---------------------------------------------------------------------------
# SURF-64 (faithful): 4x4 grid of Haar-response statistics
# ---------------------------------------------------------------------------


def surf64_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """SURF 64-d (features.cpp SURF row): 4x4 subregions of Gaussian-weighted
    (sum dx, sum dy, sum |dx|, sum |dy|) in the keypoint frame, normalized.
    Identical structure to Bay et al.; Haar wavelets become central
    differences (exact in the continuous limit, cheaper).
    """
    from matchinglib_poselib_tpu.ops.nonlinear_diffusion import msurf_descriptor

    return msurf_descriptor(patches, angles, oriented)
