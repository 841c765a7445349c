"""Core epipolar / camera geometry kernels.

Batched equivalents of the reference's helper layer
(poselib/source/pose_helper.cpp — SURVEY.md P12/P13/P6-math):

- Sampson error               (pose_helper.cpp:115 SampsonL1)
- closest-E SVD projection    (pose_helper.cpp:152 getClosestE)
- E validity check            (pose_helper.cpp:196 validateEssential)
- robust statistics           (pose_helper.cpp:358 getStatsfromVec)
- R <-> quaternion            (pose_helper.cpp:814-1097)
- rotation angles             (pose_helper.cpp:676 getAnglesRotMat)
- E = [t]x R                  (pose_helper.cpp:785 getEfromRT)
- image <-> camera coords     (pose_helper.cpp:1100-1168)
- Oulu-model undistortion     (pose_helper.cpp:1169,1241 LensDist_Oulu)
- pose comparison             (pose_helper.cpp:1296 compareRTs)
- triangulation + cheirality  (five-point-nister/five-point.cpp:150-250
                               recoverPose / decomposeEssentialMat)

Design: every function is pure jnp over arrays whose leading dimensions are
arbitrary batch dims ("..."), so the same code serves one pair, a hypothesis
batch, or a sharded pair batch. No data-dependent shapes; variable-length
point sets carry a boolean/float mask. Float32 throughout;
accumulation-sensitive reductions are explicitly f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# basic linear algebra helpers
# ---------------------------------------------------------------------------


def skew(t: jax.Array) -> jax.Array:
    """Cross-product matrix [t]x for t of shape (..., 3) -> (..., 3, 3)."""
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    z = jnp.zeros_like(tx)
    return jnp.stack(
        [
            jnp.stack([z, -tz, ty], axis=-1),
            jnp.stack([tz, z, -tx], axis=-1),
            jnp.stack([-ty, tx, z], axis=-1),
        ],
        axis=-2,
    )


def essential_from_rt(R: jax.Array, t: jax.Array) -> jax.Array:
    """E = [t]x R (reference: pose_helper.cpp:785 getEfromRT)."""
    return skew(t) @ R


def normalize_vec(v: jax.Array, eps: float = 1e-12) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


# ---------------------------------------------------------------------------
# homogeneous / camera coordinate transforms
# ---------------------------------------------------------------------------


def to_homogeneous(x: jax.Array) -> jax.Array:
    """(..., N, 2) -> (..., N, 3) with trailing ones."""
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def img_to_cam(pts: jax.Array, K: jax.Array) -> jax.Array:
    """Pixel -> normalized camera coords (pose_helper.cpp:1100 ImgToCamCoordTrans).

    pts: (..., N, 2) pixels; K: (..., 3, 3). Returns (..., N, 2).
    """
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    s = K[..., 0, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - s * y) / fx
    return jnp.stack([x, y], axis=-1)


def cam_to_img(pts: jax.Array, K: jax.Array) -> jax.Array:
    """Normalized camera -> pixel coords (pose_helper.cpp:1134 CamToImgCoordTrans)."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    s = K[..., 0, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    x = fx * pts[..., 0] + s * pts[..., 1] + cx
    y = fy * pts[..., 1] + cy
    return jnp.stack([x, y], axis=-1)


def undistort_oulu(
    pts: jax.Array, dist: jax.Array, iterations: int = 20
) -> jax.Array:
    """Iterative Oulu-model undistortion of normalized coords.

    Reference: pose_helper.cpp:1169 Remove_LensDist -> :1241 LensDist_Oulu
    (fixed-point iteration; the reference iterates to tolerance, we use a
    fixed iteration count — static control flow).

    pts: (..., N, 2) normalized (distorted) coords.
    dist: (..., 5) [k1, k2, p1, p2, k3].
    """
    k1 = dist[..., 0][..., None]
    k2 = dist[..., 1][..., None]
    p1 = dist[..., 2][..., None]
    p2 = dist[..., 3][..., None]
    k3 = dist[..., 4][..., None]

    def body(_, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xu = (pts[..., 0] - dx) / radial
        yu = (pts[..., 1] - dy) / radial
        return jnp.stack([xu, yu], axis=-1)

    return jax.lax.fori_loop(0, iterations, body, pts)


def distort_oulu(pts: jax.Array, dist: jax.Array) -> jax.Array:
    """Forward Oulu/Brown distortion of normalized coords (inverse of above)."""
    k1 = dist[..., 0][..., None]
    k2 = dist[..., 1][..., None]
    p1 = dist[..., 2][..., None]
    p2 = dist[..., 3][..., None]
    k3 = dist[..., 4][..., None]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1[..., 0] + r2 * (k2[..., 0] + r2 * k3[..., 0]))
    xd = x * radial + 2.0 * p1[..., 0] * x * y + p2[..., 0] * (r2 + 2.0 * x * x)
    yd = y * radial + p1[..., 0] * (r2 + 2.0 * y * y) + 2.0 * p2[..., 0] * x * y
    return jnp.stack([xd, yd], axis=-1)


# ---------------------------------------------------------------------------
# epipolar residuals
# ---------------------------------------------------------------------------


def epipolar_products(E: jax.Array, x1: jax.Array, x2: jax.Array):
    """Shared terms: x2^T E x1, E x1, E^T x2.

    E: (..., 3, 3); x1, x2: (..., N, 2) normalized camera coords.
    Returns (num, Ex1, Etx2) with shapes (..., N), (..., N, 3), (..., N, 3).
    """
    h1 = to_homogeneous(x1)
    h2 = to_homogeneous(x2)
    Ex1 = h1 @ jnp.swapaxes(E, -1, -2)  # (..., N, 3) rows = E @ x1_i
    Etx2 = h2 @ E  # rows = E^T @ x2_i
    num = jnp.sum(h2 * Ex1, axis=-1)
    return num, Ex1, Etx2


def sampson_error(E: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Squared Sampson distance per correspondence (..., N).

    Reference computes the L1 (signed, denominator-normalized) variant in
    SampsonL1 (pose_helper.cpp:115) and squares it for thresholds
    (computeReprojError2, stereo_pose_refinement.cpp:486 path). We return the
    squared value; use ``jnp.sqrt`` for the L1 magnitude.
    """
    num, Ex1, Etx2 = epipolar_products(E, x1, x2)
    denom = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    # a vanishing denominator means a degenerate model (e.g. E ~ 0), not a
    # perfect fit — score it as a gross error, never as zero
    return jnp.where(
        denom > 1e-12, (num * num) / jnp.maximum(denom, 1e-12), 1e9
    )


def symmetric_epipolar_error(E, x1, x2) -> jax.Array:
    """Symmetric squared distance to epipolar lines (..., N)."""
    num, Ex1, Etx2 = epipolar_products(E, x1, x2)
    g1 = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
    g2 = Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    d1 = jnp.where(g1 > 1e-12, (num * num) / jnp.maximum(g1, 1e-12), 1e9)
    d2 = jnp.where(g2 > 1e-12, (num * num) / jnp.maximum(g2, 1e-12), 1e9)
    return d1 + d2


# ---------------------------------------------------------------------------
# essential-matrix manifold
# ---------------------------------------------------------------------------


def closest_essential(E: jax.Array) -> jax.Array:
    """Project onto the essential manifold: sv -> (s, s, 0), s = (s1+s2)/2.

    Reference: pose_helper.cpp:152 getClosestE. Uses the closed-form 3x3
    SVD (ops/smalllinalg) — this projection sits inside the sequential
    IRLS/LM refinement chains, where XLA's iterative SVD loop costs
    dispatch latency per iteration.
    """
    from matchinglib_poselib_tpu.ops import smalllinalg

    U, s, Vt = smalllinalg.svd3x3(E)
    m = 0.5 * (s[..., 0] + s[..., 1])
    s_new = jnp.stack([m, m, jnp.zeros_like(m)], axis=-1)
    return (U * s_new[..., None, :]) @ Vt


def closest_essential_fast(E: jax.Array) -> jax.Array:
    """Essential-manifold projection via a quadratic matrix polynomial.

    Same projection as closest_essential (U diag(m,m,0) V^T with
    m = (s1+s2)/2) computed WITHOUT an SVD: with M = E^T E sharing V's
    eigenbasis, E g(M) = U diag(s1 g(l1), s2 g(l2), s3 g(l3)) V^T for
    any polynomial g of the eigenvalues l_i = s_i^2, so the quadratic
    interpolating g(l1) = m/s1, g(l2) = m/s2, g(l3) = 0 realizes the
    projection exactly. Eigenvalues come from the Cardano closed form;
    the Newton (divided-difference) coefficient form stays stable in
    the near-manifold s1 -> s2 limit (the confluent difference is
    replaced by the analytic derivative -m/(2 l^1.5)). Straight-line
    code at ~1/6 the sequential depth of the Jacobi svd3x3 path — this
    projection runs INSIDE the IRLS/LO refit chains once per iteration
    (a raw-DLT chain drifts toward fundamental-matrix solutions whose
    late projection collapses the inlier set; KITTI frame-31, round 5).
    """
    dtype = E.dtype
    eps = jnp.asarray(1e-20, dtype)
    M = jnp.swapaxes(E, -1, -2) @ E
    # Cardano eigenvalues of the symmetric PSD M, descending l1>=l2>=l3
    q = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]) / 3.0
    B = M - q[..., None, None] * jnp.eye(3, dtype=dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-38))
    Bn = B / p[..., None, None]
    detBn = (
        Bn[..., 0, 0] * (Bn[..., 1, 1] * Bn[..., 2, 2]
                         - Bn[..., 1, 2] * Bn[..., 2, 1])
        - Bn[..., 0, 1] * (Bn[..., 1, 0] * Bn[..., 2, 2]
                           - Bn[..., 1, 2] * Bn[..., 2, 0])
        + Bn[..., 0, 2] * (Bn[..., 1, 0] * Bn[..., 2, 1]
                           - Bn[..., 1, 1] * Bn[..., 2, 0])
    )
    phi = jnp.arccos(jnp.clip(detBn / 2.0, -1.0, 1.0)) / 3.0
    l1 = q + 2.0 * p * jnp.cos(phi)
    l3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    l1 = jnp.maximum(l1, 0.0)
    l2 = jnp.maximum(l2, 0.0)
    l3 = jnp.maximum(l3, 0.0)
    s1 = jnp.sqrt(l1)
    s2 = jnp.sqrt(l2)
    m = 0.5 * (s1 + s2)
    h1 = m / jnp.maximum(s1, eps)
    h2 = m / jnp.maximum(s2, eps)
    # Newton form g(l) = h1 + dd12 (l-l1) + dd123 (l-l1)(l-l2)
    d12 = l1 - l2
    dd12_generic = (h1 - h2) / jnp.where(jnp.abs(d12) > eps, d12, 1.0)
    dd12_confl = -m / jnp.maximum(2.0 * l1 * jnp.maximum(s1, eps), eps)
    near = jnp.abs(d12) <= 1e-6 * jnp.maximum(l1, eps)
    dd12 = jnp.where(near, dd12_confl, dd12_generic)
    d23 = jnp.maximum(l2 - l3, eps)
    dd23 = h2 / d23  # (h2 - 0) / (l2 - l3)
    dd123 = (dd12 - dd23) / jnp.maximum(l1 - l3, eps)
    eye = jnp.eye(3, dtype=dtype)
    A1 = M - l1[..., None, None] * eye
    A2 = M - l2[..., None, None] * eye
    gM = (
        h1[..., None, None] * eye
        + dd12[..., None, None] * A1
        + dd123[..., None, None] * (A1 @ A2)
    )
    return E @ gM


def essential_residual_stats(E, x1, x2, mask=None):
    """Mean/median squared Sampson error over (masked) correspondences."""
    err = sampson_error(E, x1, x2)
    if mask is None:
        return jnp.mean(err, axis=-1), masked_median(err, jnp.ones_like(err))
    m = mask.astype(err.dtype)
    mean = jnp.sum(err * m, axis=-1) / jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    return mean, masked_median(err, m)


def is_valid_essential(E: jax.Array, tol: float = 1e-3) -> jax.Array:
    """Check singular-value structure (s1 ~ s2, s3 ~ 0).

    Reference: pose_helper.cpp:196 validateEssential (simplified).
    """
    s = jnp.linalg.svd(E, compute_uv=False)
    s = s / jnp.maximum(s[..., :1], 1e-12)
    return (jnp.abs(s[..., 0] - s[..., 1]) < tol * 10.0) & (s[..., 2] < tol * 10.0)


# ---------------------------------------------------------------------------
# rotations / quaternions
# ---------------------------------------------------------------------------


def quat_from_rot(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0.

    Branch-free Shepperd-style selection (reference MatToQuat,
    pose_helper.cpp:861 uses the same 4-case selection with branches; we
    compute all four candidates and pick by the largest pivot — static).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate (unnormalized) quats, each valid when its pivot > 0
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    case = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, case[..., None, None].astype(jnp.int32), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def rot_from_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / jnp.maximum(n, 1e-12)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def quat_mult(a: jax.Array, b: jax.Array) -> jax.Array:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def rotation_angle(R: jax.Array) -> jax.Array:
    """Rotation angle (radians) of R (reference rotDiff semantics)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return jnp.arccos(jnp.clip(0.5 * (tr - 1.0), -1.0, 1.0))


def angles_from_rot(R: jax.Array) -> jax.Array:
    """Euler angles (roll, pitch, yaw) in degrees.

    Reference: pose_helper.cpp:676 getAnglesRotMat (R = Rx*Ry*Rz convention).
    Returns (..., 3) degrees.
    """
    pitch = -jnp.arcsin(jnp.clip(R[..., 0, 2], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 1, 2], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 0, 1], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1) * (180.0 / jnp.pi)


def compare_poses(R1, t1, R2, t2):
    """Pose difference metrics (reference: pose_helper.cpp:1296 compareRTs).

    Returns (rot_diff_deg, t_ang_diff_deg, t_dist).
    """
    dR = jnp.swapaxes(R1, -1, -2) @ R2
    rdiff = rotation_angle(dR) * (180.0 / jnp.pi)
    t1n = normalize_vec(t1)
    t2n = normalize_vec(t2)
    ca = jnp.clip(jnp.sum(t1n * t2n, axis=-1), -1.0, 1.0)
    # translations from E have a sign ambiguity only when comparing raw E's;
    # for recovered poses the sign matters, so report the direct angle.
    tang = jnp.arccos(ca) * (180.0 / jnp.pi)
    tdist = jnp.linalg.norm(t1n - t2n, axis=-1)
    return rdiff, tang, tdist


# ---------------------------------------------------------------------------
# robust statistics (masked, fixed-shape)
# ---------------------------------------------------------------------------


def masked_median(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Median over the masked entries of the last axis.

    Invalid entries are pushed to +inf before sorting; the median index is
    computed from the valid count (reference getStatsfromVec sorts a
    compacted vector — pose_helper.cpp:358).
    """
    m = mask.astype(bool)
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    xs = jnp.sort(jnp.where(m, x, big), axis=-1)
    n = jnp.sum(m, axis=-1).astype(jnp.int32)
    hi = jnp.clip((n - 1) // 2 + (n - 1) % 2, 0, x.shape[-1] - 1)
    lo = jnp.clip((n - 1) // 2, 0, x.shape[-1] - 1)
    vlo = jnp.take_along_axis(xs, lo[..., None], axis=-1)[..., 0]
    vhi = jnp.take_along_axis(xs, hi[..., None], axis=-1)[..., 0]
    med = 0.5 * (vlo + vhi)
    return jnp.where(n > 0, med, jnp.zeros_like(med))


def masked_stats(x: jax.Array, mask: jax.Array):
    """(median, mean, std, MAD) over masked last axis.

    Reference ``statVals`` = {median, arithErr(mean), arithStd, medErr(MAD)}
    (pose_helper.h:64-66, getStatsfromVec pose_helper.cpp:358).
    """
    m = mask.astype(x.dtype)
    n = jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    mean = jnp.sum(x * m, axis=-1) / n
    var = jnp.sum(m * (x - mean[..., None]) ** 2, axis=-1) / n
    med = masked_median(x, mask)
    mad = masked_median(jnp.abs(x - med[..., None]), mask)
    return med, mean, jnp.sqrt(var), mad


# ---------------------------------------------------------------------------
# triangulation + pose recovery
# ---------------------------------------------------------------------------


def _solve3_cramer(A, b):
    """Batched 3x3 solve via the adjugate (closed form, pure elementwise math).

    A: (..., 3, 3), b: (..., 3). Avoids LU for tiny batched systems.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    det = jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) / det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) / det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) / det
    return jnp.stack([x0, x1, x2], axis=-1)


def triangulate_linear(R, t, x1, x2):
    """Two-view linear (DLT) triangulation in camera-1 frame.

    Cameras P1 = [I|0], P2 = [R|t]; x1, x2 normalized coords (..., N, 2).
    Solves the inhomogeneous 4x3 DLT system (w = 1) by 3x3 normal equations
    with a closed-form Cramer solve — fully vectorized elementwise math in
    place of a batched 4x4 eigendecomposition. Reference equivalent:
    five-point.cpp triangulation inside recoverPose (:150-250) and
    triangPts3D (pose_estim.cpp:964).

    Returns (..., N, 3) points in camera-1 coordinates.
    """
    shape = x1.shape[:-1]
    P1 = jnp.broadcast_to(
        jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1),
        R.shape[:-2] + (3, 4),
    )
    P2 = jnp.concatenate([R, t[..., None]], axis=-1)

    def rows(P, x):
        # P: (..., 3, 4) -> broadcast over N
        Pb = P[..., None, :, :]
        r0 = x[..., 0:1] * Pb[..., 2, :] - Pb[..., 0, :]
        r1 = x[..., 1:2] * Pb[..., 2, :] - Pb[..., 1, :]
        return r0, r1

    a0, a1 = rows(P1, x1)
    a2, a3 = rows(P2, x2)
    A4 = jnp.stack([a0, a1, a2, a3], axis=-2)  # (..., N, 4, 4)
    Am = A4[..., :3]  # coefficients of (X, Y, Z)
    bv = -A4[..., 3]  # move the w-column to the rhs (w = 1)
    AtA = jnp.swapaxes(Am, -1, -2) @ Am
    Atb = jnp.einsum("...ij,...i->...j", Am, bv)
    pts = _solve3_cramer(AtA, Atb)
    return pts.reshape(shape + (3,))


def decompose_essential(E: jax.Array):
    """E -> (R1, R2, t) candidates (five-point.cpp decomposeEssentialMat).

    Returns R1, R2 with det=+1 and unit t; the four poses are
    (R1, t), (R1, -t), (R2, t), (R2, -t).
    """
    from matchinglib_poselib_tpu.ops import smalllinalg

    U, _, Vt = smalllinalg.svd3x3(E)
    # enforce proper rotations
    dU = jnp.linalg.det(U)
    dV = jnp.linalg.det(Vt)
    U = U * dU[..., None, None]
    Vt = Vt * dV[..., None, None]
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return R1, R2, t


def cheirality_counts(R, t, x1, x2, mask, dist_thresh: float = 50.0):
    """Count points in front of both cameras with depth < dist_thresh.

    Replicates recoverPose's vote (five-point.cpp:150-250): triangulate,
    require z1 > 0, z2 > 0 and z < dist (the reference uses dist=50 for
    normalized coords).
    """
    X = triangulate_linear(R, t, x1, x2)
    z1 = X[..., 2]
    X2 = X @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    ok = (z1 > 0) & (z2 > 0) & (z1 < dist_thresh) & (z2 < dist_thresh)
    ok = ok & mask.astype(bool)
    return jnp.sum(ok, axis=-1), X, ok


def spread_select(score: jax.Array, k: int) -> jax.Array:
    """Top-k indices of ``score`` with a spatially spread tie-break.

    ``lax.top_k`` breaks ties to the lowest index; on grid-row-major
    keypoint arrays that systematically selects the top of the image — a
    spatially biased subset for cheirality votes and refits (degenerate
    scenes, e.g. a dominant plane at the image top, could flip a vote
    relative to the full set). A deterministic per-index Knuth hash,
    scaled below half the smallest score step (scores here are
    integer-valued class labels), spreads equal-score selection over the
    whole array without disturbing the class order.
    """
    n = score.shape[0]
    h = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    tie = h.astype(score.dtype) * (0.4 / 4294967296.0)
    _, sel = jax.lax.top_k(score + tie, k)
    return sel


def recover_pose(E, x1, x2, mask, dist_thresh: float = 50.0,
                 vote_points: int | None = None):
    """Cheirality-voted pose from E (five-point.cpp:150 recoverPose).

    Returns (R, t, X, good_mask, votes): the winning pose, triangulated
    points in camera-1 frame, per-point cheirality mask, and the vote count.

    vote_points: when set (unbatched call only) and smaller than N, the
    4-fold candidate vote runs on a mask-weighted compaction of that many
    points — the vote needs only a sample to be decisive — and only the
    winning pose is triangulated at full N (4x less triangulation work on
    padded 4096-point pipelines). The returned X/good_mask/votes are
    always full-resolution for the winner.
    """
    R1, R2, t = decompose_essential(E)
    cands_R = jnp.stack([R1, R1, R2, R2], axis=-3)  # (..., 4, 3, 3)
    cands_t = jnp.stack([t, -t, t, -t], axis=-2)  # (..., 4, 3)
    if (
        vote_points is not None
        and x1.ndim == 2
        and vote_points < x1.shape[0]
    ):
        sel = spread_select(mask.astype(x1.dtype), vote_points)
        x1v, x2v, mv = x1[sel], x2[sel], mask[sel]
        x1b = jnp.broadcast_to(x1v[None], (4,) + x1v.shape)
        x2b = jnp.broadcast_to(x2v[None], (4,) + x2v.shape)
        maskb = jnp.broadcast_to(mv[None], (4,) + mv.shape)
        votes_s, _, _ = cheirality_counts(
            cands_R, cands_t, x1b, x2b, maskb, dist_thresh
        )
        best = jnp.argmax(votes_s, axis=-1)
        R = cands_R[best]
        tt = cands_t[best]
        nv, Xw, okw = cheirality_counts(R, tt, x1, x2, mask, dist_thresh)
        return R, tt, Xw, okw, nv
    x1b = jnp.broadcast_to(x1[..., None, :, :], cands_R.shape[:-2] + x1.shape[-2:])
    x2b = jnp.broadcast_to(x2[..., None, :, :], cands_R.shape[:-2] + x2.shape[-2:])
    maskb = jnp.broadcast_to(mask[..., None, :], cands_R.shape[:-2] + mask.shape[-1:])
    votes, X, ok = cheirality_counts(cands_R, cands_t, x1b, x2b, maskb, dist_thresh)
    best = jnp.argmax(votes, axis=-1)

    def take(a, idx):
        return jnp.take_along_axis(
            a, idx.reshape(idx.shape + (1,) * (a.ndim - idx.ndim)), axis=idx.ndim
        ).squeeze(idx.ndim)

    R = take(cands_R, best)
    tt = take(cands_t, best)
    Xw = take(X, best)
    okw = take(ok, best)
    nv = take(votes, best)
    return R, tt, Xw, okw, nv


# ---------------------------------------------------------------------------
# Hartley normalization (for DLT-style solvers)
# ---------------------------------------------------------------------------


def normalize_points(x: jax.Array, mask: jax.Array):
    """Shift to centroid, scale mean distance to sqrt(2). Returns (xn, T).

    T is the 3x3 similarity with xn_h = T @ x_h. Masked points get weight 0.
    """
    m = mask.astype(x.dtype)
    n = jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    mean = jnp.sum(x * m[..., None], axis=-2) / n[..., None]
    d = jnp.linalg.norm(x - mean[..., None, :], axis=-1)
    scale = jnp.sqrt(2.0) / jnp.maximum(
        jnp.sum(d * m, axis=-1) / n, 1e-12
    )
    xn = (x - mean[..., None, :]) * scale[..., None, None]
    z = jnp.zeros_like(scale)
    one = jnp.ones_like(scale)
    T = jnp.stack(
        [
            jnp.stack([scale, z, -scale * mean[..., 0]], axis=-1),
            jnp.stack([z, scale, -scale * mean[..., 1]], axis=-1),
            jnp.stack([z, z, one], axis=-1),
        ],
        axis=-2,
    )
    return xn, T
