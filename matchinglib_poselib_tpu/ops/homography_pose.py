"""Pose from multi-plane scenes via homography alignment (Halign).

Batched equivalent of the reference's P9 layer (SURVEY.md):

- estimatePoseHomographies (poselib/source/pose_homography.cpp:127) —
  pose for scenes dominated by one or more planes, where direct E
  estimation is degenerate.
- estimateMultHomographys (pose_homography.cpp:291) — iterative
  extraction of multiple homographies: robustly fit H, remove its
  inliers, repeat.
- Homographys_Alignment / Longuet_Higgins_Solution
  (HomographyAlignment.cpp) — decompose homographies into (R, t, n)
  and pick the physically consistent solution.

Design (behavioral substitution, documented): the reference's joint
iterative alignment (update_h0_rt, LM on homography entries) is replaced
by *candidate scoring*: every extracted plane yields 4 analytic
(R, t, n) candidates (Faugeras SVD decomposition); all candidates from
all planes are scored densely against ALL correspondences (epipolar
inlier count + cheirality vote, one batched pass) and the best wins.
Same decision variable as the reference — which (R, t) explains the
whole scene — computed the batch way instead of the sequential way.

Plane peeling keeps static shapes: a fixed number of rounds
(max_planes), each running the batched robust engine on the
still-unclaimed correspondences; empty rounds yield invalid planes
(masked out downstream).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import HalignConfig, RobustConfig
from matchinglib_poselib_tpu.ops import geometry as geo
from matchinglib_poselib_tpu.ops import robust, solvers


class HomographyDecomposition(NamedTuple):
    R: jax.Array  # (4, 3, 3)
    t: jax.Array  # (4, 3) unit (or zero for pure rotation)
    n: jax.Array  # (4, 3) plane normal in camera 1
    valid: jax.Array  # (4,) bool


class HalignResult(NamedTuple):
    R: jax.Array  # (3, 3) best pose
    t: jax.Array  # (3,) unit translation
    E: jax.Array  # (3, 3) essential matrix of the best pose
    n: jax.Array  # (3,) plane normal of the winning candidate
    inlier_mask: jax.Array  # (N,) epipolar inliers of the best pose
    n_inliers: jax.Array
    homographies: jax.Array  # (P, 3, 3) extracted planes (normalized coords)
    plane_masks: jax.Array  # (P, N) inliers per plane
    plane_valid: jax.Array  # (P,) plane extraction succeeded
    n_planes: jax.Array  # number of valid planes
    is_rotation_only: jax.Array  # best H is (numerically) a pure rotation
    # reference failure semantics (estimatePoseHomographies return value,
    # pose_homography.cpp:120-266): 0 ok, -1 no homographies found,
    # -2 sum of plane strengths too low, -3 alignment failed (no
    # candidate passed scoring/cheirality), -4 pose variables invalid
    # (non-finite). Callers MUST check this and fall back to the robust-E
    # path on failure — the reference degrades detectably, so do we.
    error_code: jax.Array  # int32
    plane_strengths: jax.Array  # (P,) th*n_inl/(actual_th*n_corrs)


def decompose_homography(H: jax.Array) -> HomographyDecomposition:
    """Faugeras SVD decomposition of a calibrated homography.

    H maps normalized camera-1 coords to camera-2: x2 ~ H x1 with
    H = R + t n^T / d. Returns the 4 sign combinations; reference:
    Longuet_Higgins_Solution (HomographyAlignment.cpp) used by
    pose_homography.cpp. Candidates with negative-z normals are still
    emitted — the caller's cheirality vote sorts them out.
    """
    U, S, Vt = jnp.linalg.svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    # scale so the middle singular value is 1
    d1 = d1 / jnp.maximum(d2, 1e-12)
    d3 = d3 / jnp.maximum(d2, 1e-12)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.clip((d1 * d1 - 1.0) / denom, 0.0, None))
    aux3 = jnp.sqrt(jnp.clip((1.0 - d3 * d3) / denom, 0.0, None))

    # Faugeras-Lustman with d2 normalized to 1:
    # sin(theta) = (d1 - d3) x1 x3, cos(theta) = (1 + d1 d3) / (d1 + d3)
    sin_t = (d1 - d3) * aux1 * aux3
    cos_t = (1.0 + d1 * d3) / jnp.maximum(d1 + d3, 1e-12)

    def one(e1, e3):
        st = e1 * e3 * sin_t
        Rp = jnp.asarray(
            [
                [cos_t, 0.0, -st],
                [0.0, 1.0, 0.0],
                [st, 0.0, cos_t],
            ]
        )
        npr = jnp.asarray([e1 * aux1, 0.0, e3 * aux3])
        tp = (d1 - d3) * jnp.asarray([e1 * aux1, 0.0, -e3 * aux3])
        R = s * U @ Rp @ Vt
        t = U @ tp
        n = jnp.swapaxes(Vt, -1, -2) @ npr
        return R, t, n

    combos = [(1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)]
    Rs, ts, ns = [], [], []
    for e1, e3 in combos:
        R, t, n = one(e1, e3)
        Rs.append(R)
        ts.append(t)
        ns.append(n)
    Rs = jnp.stack(Rs)
    ts = jnp.stack(ts)
    ns = jnp.stack(ns)

    tn = jnp.linalg.norm(ts, axis=-1, keepdims=True)
    ts = ts / jnp.maximum(tn, 1e-12)
    # pure rotation (plane at infinity / no parallax): d1 ~ d3 ~ 1
    rot_only = (d1 - d3) < 1e-4
    valid = jnp.isfinite(Rs).all(axis=(-1, -2)) & jnp.isfinite(ts).all(-1)
    return HomographyDecomposition(
        R=Rs, t=jnp.where(rot_only, 0.0, ts), n=ns, valid=valid
    )


@functools.partial(jax.jit, static_argnames=("cfg", "robust_cfg"))
def estimate_multiple_homographies(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array,
    cfg: HalignConfig,
    robust_cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
):
    """Iterative plane peeling (estimateMultHomographys, pose_homography.cpp:291).

    Returns (H (P,3,3), plane_masks (P,N), plane_valid (P,)).
    Round r fits a homography robustly on correspondences not claimed by
    rounds < r; a round with fewer than ``min_plane_inliers`` inliers (or
    too few remaining points) produces an invalid plane.
    """
    fam = robust.homography_family()
    remaining = mask.astype(bool)
    # the reference extracts planes at th_mult_base = 1.5x the pose
    # threshold (pose_homography.cpp:313, applied by default; varTh may
    # grow it further toward 6x): the one-sided transfer error carries
    # both endpoints' noise, so plane EXTRACTION needs the looser band.
    # Plane MEMBERSHIP (what a plane claims away from later peeling
    # rounds, and what its strength counts) stays at the tight 1.0x
    # threshold — a looser claim lets a compromise H swallow points of
    # other planes, which both starves subsequent rounds and inflates
    # strengths; the reference normalizes the same way through its
    # th*n_inl/(actual_th*N) formula (:354).
    th_t = jnp.asarray(threshold_sq, x1.dtype)
    th_h = 2.25 * th_t
    Hs, masks, valids = [], [], []
    for r in range(cfg.max_planes):
        key, sub = jax.random.split(key)
        res = robust.ransac(
            fam, x1, x2, remaining, quality, robust_cfg, sub,
            threshold_sq=th_h,
        )
        H = res.model
        inl = res.inlier_mask
        n_inl = res.n_inliers
        # inlier re-fit (the reference LM-refines every extracted H,
        # refineHomography pose_homography.cpp:825): a minimal 4-point
        # H carries enough model error across the plane's extent to
        # miss ~30% of its members, which fragments one plane over
        # several peeling rounds and mis-fires the plane-strength check
        # downstream. Two all-inlier DLT rounds recover the capture;
        # each is kept only if it does not lose support.
        for _ in range(2):
            H2, ok2 = solvers.solve_homography(
                x1, x2, mask=inl.astype(x1.dtype)
            )
            err2 = solvers.homography_transfer_error(
                H2[None], x1[None], x2[None]
            )[0]
            inl2 = (err2 < th_h) & remaining
            n2 = jnp.sum(inl2).astype(jnp.int32)
            better = ok2 & (n2 >= n_inl)
            H = jnp.where(better, H2, H)
            inl = jnp.where(better, inl2, inl)
            n_inl = jnp.where(better, n2, n_inl)
        # tight membership for peeling and strength accounting
        err_t = solvers.homography_transfer_error(
            H[None], x1[None], x2[None]
        )[0]
        inl_t = (err_t < th_t) & remaining
        n_t = jnp.sum(inl_t).astype(jnp.int32)
        ok = (n_t >= cfg.min_plane_inliers) & (
            jnp.sum(remaining.astype(jnp.int32)) >= fam.sample_size * 2
        )
        plane_mask = inl_t & ok
        Hs.append(jnp.where(ok, H, jnp.eye(3, dtype=x1.dtype)))
        masks.append(plane_mask)
        valids.append(ok)
        remaining = remaining & ~plane_mask
    return jnp.stack(Hs), jnp.stack(masks), jnp.stack(valids)


@functools.partial(jax.jit, static_argnames=("cfg", "robust_cfg"))
def estimate_pose_halign(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array,
    cfg: HalignConfig,
    robust_cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
) -> HalignResult:
    """Pose for (multi-)planar scenes (estimatePoseHomographies,
    pose_homography.cpp:127).

    x1, x2: (N, 2) normalized camera coords; mask: validity; quality:
    PROSAC ordering for the plane extraction.
    """
    if threshold_sq is None:
        threshold_sq = jnp.asarray(robust_cfg.threshold_px**2, x1.dtype)

    Hs, plane_masks, plane_valid = estimate_multiple_homographies(
        x1, x2, mask, quality, cfg, robust_cfg, key, threshold_sq
    )
    P = Hs.shape[0]

    dec = jax.vmap(decompose_homography)(Hs)  # (P, 4, ...)
    Rc = dec.R.reshape(P * 4, 3, 3)
    tc = dec.t.reshape(P * 4, 3)
    nc = dec.n.reshape(P * 4, 3)
    cand_valid = (dec.valid & plane_valid[:, None]).reshape(P * 4)

    maskb = mask.astype(bool)

    def score(R, t, n, ok):
        t_norm = jnp.linalg.norm(t)
        has_t = t_norm > 1e-8
        E = geo.essential_from_rt(R, jnp.where(has_t, t, 1.0))
        err_e = geo.sampson_error(E, x1, x2)
        # rotation-only candidates have no E: score R as the homography
        # x2 ~ R x1 (transfer error in the same normalized units)
        err_r = solvers.homography_transfer_error(
            R[None], x1[None], x2[None]
        )[0]
        err = jnp.where(has_t, err_e, err_r)
        inl = maskb & (err < threshold_sq)
        n_epi = jnp.sum(inl.astype(jnp.int32))
        # MSAC score: continuous, prefers the more accurate model when
        # inlier counts tie (the compromise-H-spanning-two-planes case the
        # reference resolves by joint alignment refinement)
        msac = jnp.sum(jnp.where(inl, threshold_sq - err, 0.0))
        # cheirality gate: most epipolar inliers must triangulate in front
        n_good, _, _ = geo.cheirality_counts(R, t, x1, x2, inl)
        cheir_ok = ~has_t | (n_good >= 0.75 * n_epi.astype(x1.dtype))
        s = jnp.where(ok & cheir_ok & (n_epi > 0), msac, -1.0)
        return s, inl, E

    scores, inls, Es = jax.vmap(score)(Rc, tc, nc, cand_valid)
    best = jnp.argmax(scores)

    Rb, tb, nb, Eb = Rc[best], tc[best], nc[best], Es[best]
    inl = inls[best]
    n_inl = jnp.sum(inl.astype(jnp.int32))
    rot_only = jnp.linalg.norm(tb) < 1e-8
    # rotation-only fallback: E undefined; report R with zero t
    Eb = jnp.where(rot_only, jnp.zeros((3, 3), x1.dtype), Eb)

    # failure detection (reference return codes, pose_homography.cpp:
    # 200 -1 / 243 -2 / 246 -3 / 266 -4). Plane strength is the
    # reference's th*n_inl/(actual_th*n_corrs) (:354); membership is
    # counted at the tight 1.0x threshold, so th/actual_th = 1.
    n_planes = jnp.sum(plane_valid.astype(jnp.int32))
    n_corrs = jnp.maximum(jnp.sum(maskb.astype(x1.dtype)), 1.0)
    strengths = jnp.sum(plane_masks.astype(x1.dtype), axis=1) / n_corrs
    strengths = jnp.where(plane_valid, strengths, 0.0)
    str_sum = jnp.sum(jnp.where(strengths > 0.1, strengths, 0.0))
    pose_finite = jnp.all(jnp.isfinite(Rb)) & jnp.all(jnp.isfinite(tb))
    err_code = jnp.where(
        n_planes == 0,
        -1,
        jnp.where(
            cfg.check_plane_strength & (str_sum <= 0.5),
            -2,
            jnp.where(
                scores[best] < 0.0, -3, jnp.where(pose_finite, 0, -4)
            ),
        ),
    ).astype(jnp.int32)
    return HalignResult(
        R=Rb,
        t=tb,
        E=Eb,
        n=nb,
        inlier_mask=inl,
        n_inliers=n_inl,
        homographies=Hs,
        plane_masks=plane_masks,
        plane_valid=plane_valid,
        n_planes=n_planes,
        is_rotation_only=rot_only,
        error_code=err_code,
        plane_strengths=strengths,
    )
