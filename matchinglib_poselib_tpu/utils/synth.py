"""Seeded stereo scenes with ground truth at KITTI raw geometry (numpy only).

A rig (K1, K2, R, t) and a piecewise-planar textured scene are drawn from a
seed and ray-traced into both views, so every frame comes with its exact
relative pose. The defaults follow KITTI raw: 1392x512 frames, f ~= 980,
principal point (690, 247), a lateral baseline of ~0.54 m, a camera 1.65 m
above the road. The right camera is also turned by 1-3 degrees about a
random axis, so the rotation is not trivially the identity.

Scene: a ground plane, two facades, a back wall, and a handful of
rectangular boards standing at 6-25 m. Each surface carries a two-octave
mosaic of random grey cells whose junctions are corners FAST fires on; the
cell size grows with the surface's distance so cells cover ~6-16 px.

Convention (as everywhere in the package): cam1 = [I | 0], cam2 = [R | t],
a point X in camera-1 coordinates projects to K2 (R X + t) in view 2.

    pair = stereo_pair(seed)          # one frame: img1, img2, K1, K2, R, t
    for pair in frames(12, seed):     # same rig, a fresh scene per frame
        ...
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

WIDTH, HEIGHT = 1392, 512
FOCAL = 980.0
PRINCIPAL = (690.0, 247.0)
BASELINE_M = 0.54
CAMERA_HEIGHT_M = 1.65


class StereoPair(NamedTuple):
    img1: np.ndarray  # (H, W) float32 in [0, 1]
    img2: np.ndarray  # (H, W) float32 in [0, 1]
    K1: np.ndarray  # (3, 3)
    K2: np.ndarray  # (3, 3)
    R: np.ndarray  # (3, 3) cam1 -> cam2
    t: np.ndarray  # (3,) cam1 -> cam2, metres (|t| = baseline)
    depth1: np.ndarray  # (H, W) z-depth of view 1 in metres


class Rig(NamedTuple):
    K1: np.ndarray
    K2: np.ndarray
    R: np.ndarray
    t: np.ndarray
    size: tuple[int, int]  # (H, W)


class _Plane(NamedTuple):
    normal: np.ndarray  # unit normal n; surface n . X = offset
    offset: float
    origin: np.ndarray  # a point on the plane
    e1: np.ndarray  # in-plane axes (texture coordinates)
    e2: np.ndarray
    half: tuple[float, float]  # half extents along e1, e2 (inf = unbounded)
    cell: float  # fine texture cell size in metres
    tex_seed: int


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    k = np.array([
        [0.0, -axis[2], axis[1]],
        [axis[2], 0.0, -axis[0]],
        [-axis[1], axis[0], 0.0],
    ])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def make_rig(seed: int, scale: float = 1.0) -> Rig:
    """KITTI-like rig; ``scale`` shrinks the image and the intrinsics."""
    rng = np.random.default_rng([seed, 0])
    size = (int(round(HEIGHT * scale)), int(round(WIDTH * scale)))
    f = FOCAL * scale
    K1 = np.array([[f, 0.0, PRINCIPAL[0] * scale],
                   [0.0, f, PRINCIPAL[1] * scale],
                   [0.0, 0.0, 1.0]])
    f2 = f * rng.uniform(0.99, 1.01)
    K2 = np.array([[f2, 0.0, PRINCIPAL[0] * scale + rng.uniform(-4, 4) * scale],
                   [0.0, f2, PRINCIPAL[1] * scale + rng.uniform(-2, 2) * scale],
                   [0.0, 0.0, 1.0]])
    R = _rotation(rng.normal(size=3), np.deg2rad(rng.uniform(1.0, 3.0)))
    center2 = np.array([BASELINE_M * rng.uniform(0.95, 1.05),
                        rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01)])
    t = -R @ center2
    return Rig(K1=K1, K2=K2, R=R, t=t, size=size)


def _axis_plane(normal, offset, e1, e2, cell, tex_seed, half=(np.inf, np.inf)):
    normal = np.asarray(normal, float)
    return _Plane(normal=normal, offset=float(offset),
                  origin=normal * offset, e1=np.asarray(e1, float),
                  e2=np.asarray(e2, float), half=half, cell=cell,
                  tex_seed=tex_seed)


def _make_scene(rng: np.random.Generator) -> list[_Plane]:
    tex = lambda: int(rng.integers(0, 2**31))  # noqa: E731
    back = rng.uniform(35.0, 50.0)
    left, right = rng.uniform(6.0, 10.0), rng.uniform(6.0, 10.0)
    planes = [
        _axis_plane((0, 1, 0), CAMERA_HEIGHT_M, (1, 0, 0), (0, 0, 1), 0.35,
                    tex()),
        _axis_plane((0, 0, 1), back, (1, 0, 0), (0, 1, 0), 0.9, tex()),
        _axis_plane((1, 0, 0), -left, (0, 0, 1), (0, 1, 0), 0.45, tex()),
        _axis_plane((1, 0, 0), right, (0, 0, 1), (0, 1, 0), 0.45, tex()),
    ]
    for _ in range(int(rng.integers(6, 10))):
        z = rng.uniform(6.0, 25.0)
        x = rng.uniform(-0.45, 0.45) * z
        w, h = rng.uniform(0.8, 3.0), rng.uniform(0.8, 2.5)
        yaw = np.deg2rad(rng.uniform(-40.0, 40.0))
        normal = np.array([np.sin(yaw), 0.0, -np.cos(yaw)])
        e1 = np.array([np.cos(yaw), 0.0, np.sin(yaw)])
        e2 = np.array([0.0, 1.0, 0.0])
        center = np.array([x, CAMERA_HEIGHT_M - h - rng.uniform(0.0, 1.0), z])
        planes.append(_Plane(
            normal=normal, offset=float(normal @ center), origin=center,
            e1=e1, e2=e2, half=(w, h), cell=0.012 * z, tex_seed=tex(),
        ))
    return planes


def _hash01(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic uniform [0, 1) per integer cell (a, b)."""
    u64 = lambda v: np.asarray(v).astype(np.int64).astype(np.uint64)  # noqa: E731
    with np.errstate(over="ignore"):  # wrap-around multiply is the hash
        x = (u64(a) * np.uint64(0x9E3779B97F4A7C15)
             ^ u64(b) * np.uint64(0xC2B2AE3D27D4EB4F)
             ^ u64(seed) * np.uint64(0x165667B19E3779F9))
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(29)
    return (x >> np.uint64(40)).astype(np.float64) / float(1 << 24)


def _texture(plane: _Plane, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    fine = _hash01(np.floor(u / plane.cell), np.floor(v / plane.cell),
                   plane.tex_seed)
    c = 4.0 * plane.cell
    coarse = _hash01(np.floor(u / c), np.floor(v / c), plane.tex_seed + 1)
    return 0.1 + 0.8 * (0.55 * fine + 0.45 * coarse)


def _rowdot(v: np.ndarray, w: np.ndarray) -> np.ndarray:
    """v (N, 3) . w (3,) row by row, elementwise.

    ``v @ w`` hands large products to BLAS. Called from several Python
    threads at once (frames render in a thread pool), it gave images that
    changed from run to run; the elementwise form gives the images of a
    sequential render on any number of threads.
    """
    return v[:, 0] * w[0] + v[:, 1] * w[1] + v[:, 2] * w[2]


def _rows_times(v: np.ndarray, M: np.ndarray) -> np.ndarray:
    """v (N, 3) @ M (3, 3), elementwise (see _rowdot)."""
    return np.stack([_rowdot(v, M[:, j]) for j in range(3)], axis=-1)


def _trace(planes, origin, dirs):
    """Nearest surface along each ray: (intensity, ray parameter)."""
    n_rays = dirs.shape[0]
    best = np.full(n_rays, np.inf)
    hit = np.full(n_rays, -1)
    for k, p in enumerate(planes):
        denom = _rowdot(dirs, p.normal)
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = (p.offset - origin @ p.normal) / denom
        ok = np.isfinite(lam) & (lam > 1e-3) & (lam < best)
        if np.isfinite(p.half[0]):
            X = origin + lam[:, None] * dirs
            rel = X - p.origin
            ok &= (np.abs(_rowdot(rel, p.e1)) <= p.half[0]) & (
                np.abs(_rowdot(rel, p.e2)) <= p.half[1])
        best = np.where(ok, lam, best)
        hit = np.where(ok, k, hit)
    value = np.full(n_rays, 0.5)
    for k, p in enumerate(planes):
        sel = hit == k
        if not sel.any():
            continue
        X = origin + best[sel, None] * dirs[sel]
        rel = X - p.origin
        value[sel] = _texture(p, _rowdot(rel, p.e1), _rowdot(rel, p.e2))
    return value, best


def _render(planes, K, R_wc, center, size, supersample=2):
    """Ray-trace one view; R_wc maps camera directions to camera-1 frame."""
    H, W = size
    s = supersample
    offs = (np.arange(s) + 0.5) / s - 0.5
    ys, xs = np.meshgrid(np.arange(H, dtype=float), np.arange(W, dtype=float),
                         indexing="ij")
    to_ray = np.linalg.inv(K).T @ R_wc.T  # pixel (x, y, 1) -> ray direction
    acc = np.zeros((H, W))
    for dy in offs:
        for dx in offs:
            pix = np.stack([xs + dx, ys + dy, np.ones_like(xs)], -1)
            val, _ = _trace(planes, center,
                            _rows_times(pix.reshape(-1, 3), to_ray))
            acc += val.reshape(H, W)
    img = acc / (s * s)
    # z-depth at pixel centres (rays have unit z in camera coordinates)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    _, lam = _trace(planes, center, _rows_times(pix, to_ray))
    return img, lam.reshape(H, W)


def render(rig: Rig, scene_seed: int, noise: float = 0.004) -> StereoPair:
    """Ray-trace a fresh scene drawn from ``scene_seed`` through ``rig``."""
    rng = np.random.default_rng([scene_seed, 1])
    planes = _make_scene(rng)
    img1, depth1 = _render(planes, rig.K1, np.eye(3), np.zeros(3), rig.size)
    center2 = -rig.R.T @ rig.t
    img2, _ = _render(planes, rig.K2, rig.R.T, center2, rig.size)
    img1 = img1 + rng.normal(scale=noise, size=img1.shape)
    img2 = img2 + rng.normal(scale=noise, size=img2.shape)
    return StereoPair(
        img1=np.clip(img1, 0.0, 1.0).astype(np.float32),
        img2=np.clip(img2, 0.0, 1.0).astype(np.float32),
        K1=rig.K1, K2=rig.K2, R=rig.R, t=rig.t, depth1=depth1,
    )


def stereo_pair(seed: int, scale: float = 1.0) -> StereoPair:
    """One seeded frame at KITTI geometry (``scale`` < 1 for small tests)."""
    return render(make_rig(seed, scale), scene_seed=seed)


def frame_seed(seed: int, i: int) -> int:
    """Scene seed of frame ``i`` of the stream drawn from ``seed``."""
    return seed * 1_000_003 + i + 1


def frames(n: int, seed: int, scale: float = 1.0) -> Iterator[StereoPair]:
    """``n`` frames of one rig, each with a fresh scene."""
    rig = make_rig(seed, scale)
    for i in range(n):
        yield render(rig, scene_seed=frame_seed(seed, i))
