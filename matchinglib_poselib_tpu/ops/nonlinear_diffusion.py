"""KAZE/AKAZE: nonlinear-diffusion scale space, Hessian detection, and the
M-SURF / MLDB descriptors.

Batched re-implementation of the reference's KAZE/AKAZE detector and
descriptor rows (SURVEY.md M2/M3; createDetector features.cpp:812-815
'KAZE'/'AKAZE', createExtractor features.cpp:849-971). OpenCV's KAZE builds
a nonlinear scale space with Fast Explicit Diffusion (FED); here each FED
cycle is a fixed-count sequence of explicit Perona–Malik steps — pure
5-point stencils, which XLA fuses into a handful of elementwise passes. Everything
is fixed-shape and branch-free.

Detector: scale-normalized determinant of Hessian computed on each
diffusion level, 3x3x3 extremum test across adjacent levels (same machinery
as ops/scale_space.py).

Descriptors:
- KAZE → M-SURF 64-d float: 4x4 subregions of first-order diffusion-space
  derivatives (sum dx, sum |dx|, sum dy, sum |dy|) with Gaussian weighting.
- AKAZE → MLDB 488-bit binary: 3 grids (2x2, 3x3, 4x4) of per-cell means of
  (intensity, dx, dy); all pairwise cell comparisons per channel.
Both sample a scale- and rotation-steered patch around each keypoint.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import features as F
from matchinglib_poselib_tpu.ops import scale_space as S


# ---------------------------------------------------------------------------
# nonlinear (Perona-Malik) scale space via explicit diffusion steps
# ---------------------------------------------------------------------------


def _pm_g2(gx: jax.Array, gy: jax.Array, k: jax.Array) -> jax.Array:
    """Perona-Malik g2 conductivity 1 / (1 + |grad|^2 / k^2) (KAZE default)."""
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def _edge_shift(x: jax.Array, dy: int, dx: int) -> jax.Array:
    """Shift with edge replication (Neumann boundary: zero flux at border)."""
    H, W = x.shape
    p = jnp.pad(x, ((1, 1), (1, 1)), mode="edge")
    return p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


def _diffusion_step(L: jax.Array, c: jax.Array, tau: float) -> jax.Array:
    """One explicit step of div(c * grad L) with step size tau.

    Standard 4-neighbour discretization: flux through each face uses the
    averaged conductivity of the two adjacent cells. Edge-replicated shifts
    give the zero-flux boundary condition (jnp.roll wraparound would leak
    intensity across opposite borders and fabricate border structure).
    """
    sh = _edge_shift
    cE = 0.5 * (c + sh(c, 0, -1))
    cW = 0.5 * (c + sh(c, 0, 1))
    cS = 0.5 * (c + sh(c, -1, 0))
    cN = 0.5 * (c + sh(c, 1, 0))
    upd = (
        cE * (sh(L, 0, -1) - L)
        + cW * (sh(L, 0, 1) - L)
        + cS * (sh(L, -1, 0) - L)
        + cN * (sh(L, 1, 0) - L)
    )
    return L + tau * upd


def _kcontrast(img: jax.Array, percentile: float = 0.7) -> jax.Array:
    """Contrast factor k: the given percentile of *significant* gradient
    magnitudes of the smoothed image (KAZE's KPercentile scheme builds a
    histogram of nonzero gradients; flat regions must not drag k to zero).
    Gradients use the same /8-normalized Sobel as the diffusion loop.
    """
    g = S.gaussian_blur(img, 1.0)
    gx, gy = F._sobel(g)
    mag = (jnp.sqrt(gx * gx + gy * gy) / 8.0).reshape(-1)
    valid = mag > 0.01 * jnp.max(mag)
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    srt = jnp.sort(jnp.where(valid, mag, jnp.inf))
    idx = jnp.clip((percentile * (n_valid - 1)).astype(jnp.int32),
                   0, mag.shape[0] - 1)
    return jnp.maximum(srt[idx], 1e-4)


_EVOLUTION_TIMES = (1.2, 2.4, 4.8, 9.6, 19.2, 38.4)  # diffusion times per level
_STEPS_PER_LEVEL = 6  # explicit steps between levels (FED-cycle equivalent)


def nonlinear_scale_space(img: jax.Array):
    """Build the evolution levels L_i; returns list of (L, sigma_eff)."""
    k = _kcontrast(img)
    L = S.gaussian_blur(img, 1.0)
    levels = [(L, 1.0)]
    t_prev = 0.5  # t = sigma^2 / 2 for sigma = 1.0
    for t in _EVOLUTION_TIMES:
        tau = (t - t_prev) / _STEPS_PER_LEVEL
        # stability: explicit diffusion needs tau <= 0.25; split further
        n_sub = max(1, int(np.ceil(tau / 0.22)))
        tau_s = tau / n_sub
        for _ in range(_STEPS_PER_LEVEL * n_sub):
            gx, gy = F._sobel(S.gaussian_blur(L, 1.0))
            c = _pm_g2(gx / 8.0, gy / 8.0, k)
            L = _diffusion_step(L, c, tau_s)
        levels.append((L, float(np.sqrt(2.0 * t))))
        t_prev = t
    return levels


def kaze_keypoints(
    img: jax.Array, max_keypoints: int, grid_cells: int = 0
) -> F.Keypoints:
    """KAZE/AKAZE detector: Hessian extrema in the nonlinear scale space."""
    levels = nonlinear_scale_space(img)
    dets = []
    for L, sigma in levels:
        # KAZE computes its multiscale derivatives with sigma-sized Scharr
        # kernels: the aperture, not the (edge-preserving) evolution, is
        # what reduces a small blob's amplitude at coarse levels and makes
        # the sigma^4-normalized response peak at the blob's own scale.
        # Gaussian-blur-then-difference is the same operator in the
        # continuous limit and cheaper.
        G = S.gaussian_blur(L, sigma)
        s = lambda dy, dx: jnp.roll(G, (dy, dx), (0, 1))
        dxx = s(0, 1) + s(0, -1) - 2 * G
        dyy = s(1, 0) + s(-1, 0) - 2 * G
        dxy = 0.25 * (s(1, 1) + s(-1, -1) - s(1, -1) - s(-1, 1))
        dets.append((sigma**2) ** 2 * (dxx * dyy - dxy * dxy))
    maps = jnp.stack(dets)
    mx = jax.vmap(
        lambda x: jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
        )
    )(maps)
    out = []
    per_level_k = max(32, max_keypoints // max(1, len(levels) - 2))
    for i in range(1, len(levels) - 1):
        c = maps[i]
        ok = (c >= mx[i - 1]) & (c >= mx[i + 1]) & (c >= mx[i]) & (c > 1e-8)
        sc = jnp.where(ok, c, 0.0)
        out.append(
            S._select_level(
                sc, per_level_k, 1.0, float(levels[i][1]),
                border=16, grid_cells=grid_cells,
            )
        )
    return S._merge_levels(out, max_keypoints)


# ---------------------------------------------------------------------------
# M-SURF descriptor (KAZE float, 64-d)
# ---------------------------------------------------------------------------


def msurf_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """M-SURF 64-d: 4x4 grid of (sum dx, sum |dx|, sum dy, sum |dy|).

    Gradients are rotated into the keypoint frame and Gaussian-weighted;
    each subregion result is normalized (KAZE's M-SURF variant of the SURF
    descriptor). patches: (K, P, P).
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    gx = 0.5 * (jnp.roll(patches, -1, 2) - jnp.roll(patches, 1, 2))
    gy = 0.5 * (jnp.roll(patches, -1, 1) - jnp.roll(patches, 1, 1))
    ca = jnp.cos(angles)[:, None, None]
    sa = jnp.sin(angles)[:, None, None]
    rx = ca * gx + sa * gy  # gradient in keypoint frame
    ry = -sa * gx + ca * gy

    c = (P - 1) / 2.0
    ys = (jnp.arange(P) - c) / c
    yy, xx = jnp.meshgrid(ys, ys, indexing="ij")
    # coords into the keypoint frame: rotate by -angle (same frame as the
    # rotated gradients above)
    xr = (ca * xx[None] + sa * yy[None])  # (K, P, P)
    yr = (-sa * xx[None] + ca * yy[None])
    w = jnp.exp(-(xx**2 + yy**2) / (2 * 0.55**2))[None]
    bx = jnp.clip(((xr + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    by = jnp.clip(((yr + 1.0) * 2.0).astype(jnp.int32), 0, 3)
    cell = by * 4 + bx  # (K, P, P) in [0, 16)
    oh = jax.nn.one_hot(cell.reshape(K, -1), 16, dtype=patches.dtype)
    feats = jnp.stack(
        [rx, jnp.abs(rx), ry, jnp.abs(ry)], axis=-1
    ).reshape(K, -1, 4) * w.reshape(1, -1, 1)
    desc = jnp.einsum("kpf,kpc->kcf", feats, oh).reshape(K, 64)
    return desc / jnp.maximum(
        jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9
    )


# ---------------------------------------------------------------------------
# MLDB descriptor (AKAZE binary, 488 bits -> 16 u32 words)
# ---------------------------------------------------------------------------


def _grid_cell_ids(P: int, g: int) -> np.ndarray:
    idx = np.minimum((np.arange(P) * g) // P, g - 1)
    return (idx[:, None] * g + idx[None, :]).astype(np.int32)  # (P, P)


def mldb_descriptor(
    patches: jax.Array, angles: jax.Array, oriented: bool = True
) -> jax.Array:
    """AKAZE MLDB: grid means of (L, dx, dy) compared pairwise.

    Grids 2x2 / 3x3 / 4x4 give 4+9+16 = 29 cells; per channel all pairs
    within a grid: 3*(6+36+120) = 486 bits, padded to 512 and packed into
    (K, 16) uint32 — Hamming-matched like the reference's AKAZE row.
    Rotation invariance via rotated cell assignment (keypoint frame).
    """
    K, P, _ = patches.shape
    if not oriented:
        angles = jnp.zeros_like(angles)
    gx = 0.5 * (jnp.roll(patches, -1, 2) - jnp.roll(patches, 1, 2))
    gy = 0.5 * (jnp.roll(patches, -1, 1) - jnp.roll(patches, 1, 1))
    ca = jnp.cos(angles)[:, None, None]
    sa = jnp.sin(angles)[:, None, None]
    rx = ca * gx + sa * gy
    ry = -sa * gx + ca * gy
    chans = jnp.stack([patches, rx, ry], axis=-1)  # (K, P, P, 3)

    c = (P - 1) / 2.0
    ys = (jnp.arange(P) - c) / c
    yy, xx = jnp.meshgrid(ys, ys, indexing="ij")
    # keypoint frame = rotate coords by -angle (matches gradient rotation)
    xr = ca * xx[None] + sa * yy[None]  # (K, P, P) in ~[-1.4, 1.4]
    yr = -sa * xx[None] + ca * yy[None]
    inside = (jnp.abs(xr) <= 1.0) & (jnp.abs(yr) <= 1.0)

    bits = []
    for g in (2, 3, 4):
        bxi = jnp.clip(((xr + 1.0) * 0.5 * g).astype(jnp.int32), 0, g - 1)
        byi = jnp.clip(((yr + 1.0) * 0.5 * g).astype(jnp.int32), 0, g - 1)
        cell = byi * g + bxi  # (K, P, P)
        n_cells = g * g
        oh = jax.nn.one_hot(
            cell.reshape(K, -1), n_cells, dtype=patches.dtype
        ) * inside.reshape(K, -1, 1).astype(patches.dtype)
        sums = jnp.einsum("kpf,kpc->kcf", chans.reshape(K, -1, 3), oh)
        cnt = jnp.maximum(jnp.sum(oh, axis=1), 1.0)  # (K, C)
        means = sums / cnt[..., None]  # (K, C, 3)
        iu, ju = np.triu_indices(n_cells, k=1)
        cmp = means[:, iu, :] > means[:, ju, :]  # (K, pairs, 3)
        bits.append(cmp.reshape(K, -1))
    allbits = jnp.concatenate(bits, axis=1)  # (K, 486)
    pad = 512 - allbits.shape[1]
    allbits = jnp.concatenate(
        [allbits, jnp.zeros((K, pad), allbits.dtype)], axis=1
    )
    words = allbits.astype(jnp.uint32).reshape(K, 16, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
