"""Bundle adjustment: batched Levenberg-Marquardt with per-point Schur elimination.

Batched equivalent of the reference's SBA wrapper layer (SURVEY.md P10/P11):

- SBAdriver::perform_sba (poselib/source/BA_driver.cpp:1878) driving
  sba_motstr_levmar(_x) / sba_mot_levmar(_x) (BA_driver.cpp:2245-2325) with
  analytic jacobians (include/imgproj.h:54-70) and CLAPACK solves.
- refineStereoBA (pose_estim.cpp:1083-1383): cam0 fixed at the origin,
  post-BA restore guards (reject if dR > 1.25 deg or d||t|| > 0.05 —
  pose_estim.h:239-240).
- refineMultCamBA (pose_estim.cpp:1384-1736): multi-camera variant with
  optional intrinsics refinement.
- modes BA_MOTSTRUCT / BA_MOT / BA_STRUCT / BA_MOT_MOTSTRUCT and the
  least-squares / pseudo-Huber cost choice (BA_driver.h:69-82).

Design (sequential sparse CPU solver -> batched dense-block solver):

- The reference's compressed sparse Schur machinery exists because CPU SBA
  must avoid touching absent observations. Here we keep a *dense* masked
  observation tensor (P points x C cameras x 2) — the visibility mask zeroes
  absent terms and every block operation becomes one batched einsum on the
  matmul/elementwise.
- Points have 3 dof, so their Hessian blocks V_p are 3x3 and eliminated in
  closed form (batched Cramer inverse). The reduced camera system
  S = U - sum_p W_p V_p^-1 W_p^T is (C*D, C*D) dense (C is a small window),
  solved with Cholesky — exactly the sparse-Schur strategy of SBA, with the
  sparsity replaced by masking.
- Jacobians come from `jax.jacfwd` of the per-observation residual, vmapped
  over (P, C): the analytic-jacobian C code of imgproj.h becomes ~40 fused
  XLA ops.
- LM control flow is a fixed-iteration `lax.fori_loop` with accept/reject
  damping updates carried as scalars — no data-dependent shapes.
- Gauge handling: fixed cameras (and fixed intrinsics) are handled by
  zeroing their jacobian columns; LM damping keeps the system positive
  definite along the null directions, so fixed parameters receive ~0 update.
  The two-view scale gauge is removed post-hoc by renormalizing ||t|| = 1
  (poses from E are up-to-scale in the reference as well).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import BAConfig
from matchinglib_poselib_tpu.ops import geometry as geo


# camera parameter block layout (local deltas around the current estimate):
#   [0:3]   so(3) rotation delta (right-multiplied: R <- R expm[w])
#   [3:6]   translation delta
#   [6:11]  intrinsics delta [fx fy cx cy skew]     (if refine_intrinsics)
#   [11:16] distortion delta [k1 k2 p1 p2 k3]       (if refine_intrinsics)
DOF_POSE = 6
DOF_FULL = 16


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues exponential map so(3) -> SO(3), (..., 3) -> (..., 3, 3).

    Uses the Taylor-guarded closed form (safe at ||w|| -> 0)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = geo.skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _apply_cam_delta(delta, R, t, K, dist, refine_intrinsics: bool):
    """Apply a local parameter delta to one camera."""
    Rn = R @ exp_so3(delta[0:3])
    tn = t + delta[3:6]
    if refine_intrinsics:
        dK = delta[6:11]
        Kn = K + jnp.array(
            [[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], K.dtype
        ) * dK[0] + jnp.array(
            [[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], K.dtype
        ) * dK[1] + jnp.array(
            [[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], K.dtype
        ) * dK[2] + jnp.array(
            [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]], K.dtype
        ) * dK[3] + jnp.array(
            [[0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], K.dtype
        ) * dK[4]
        distn = dist + delta[11:16]
    else:
        Kn, distn = K, dist
    return Rn, tn, Kn, distn


def _project(X, R, t, K, dist):
    """World point -> pixel through one camera (with Oulu distortion)."""
    Xc = R @ X + t
    z = jnp.where(jnp.abs(Xc[2]) > 1e-9, Xc[2], 1e-9)
    xn = Xc[:2] / z
    xd = geo.distort_oulu(xn[None, :], dist)[0]
    u = K[0, 0] * xd[0] + K[0, 1] * xd[1] + K[0, 2]
    v = K[1, 1] * xd[1] + K[1, 2]
    return jnp.stack([u, v])


def _residual(delta, X, obs, R, t, K, dist, refine_intrinsics: bool):
    """2-vector reprojection residual for one (point, camera) observation.

    delta = concat(cam_delta (D,), point_delta (3,)).
    """
    D = DOF_FULL if refine_intrinsics else DOF_POSE
    Rn, tn, Kn, distn = _apply_cam_delta(
        delta[:D], R, t, K, dist, refine_intrinsics
    )
    return _project(X + delta[D:], Rn, tn, Kn, distn) - obs


class BAResult(NamedTuple):
    R: jax.Array  # (C, 3, 3)
    t: jax.Array  # (C, 3)
    K: jax.Array  # (C, 3, 3)
    dist: jax.Array  # (C, 5)
    points: jax.Array  # (P, 3)
    initial_cost: jax.Array  # mean robust cost before
    final_cost: jax.Array  # mean robust cost after
    n_iterations: jax.Array


def _robust_weights(r2, delta2, robust: bool):
    """Per-observation IRLS weight from the pseudo-Huber influence.

    robust cost rho(r) = 2 b^2 (sqrt(1 + r^2/b^2) - 1) (BA_driver.h cost
    choice); weight w = rho'(r^2) = 1/sqrt(1 + r^2/b^2)."""
    if not robust:
        return jnp.ones_like(r2)
    return 1.0 / jnp.sqrt(1.0 + r2 / delta2)


def _robust_cost(r2, delta2, robust: bool):
    if not robust:
        return r2
    return 2.0 * delta2 * (jnp.sqrt(1.0 + r2 / delta2) - 1.0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "iterations", "robust", "refine_intrinsics", "refine_structure",
        "refine_motion", "axis_name", "intrinsics_cols",
    ),
)
def bundle_adjust(
    obs: jax.Array,  # (P, C, 2) pixel observations
    vis: jax.Array,  # (P, C) visibility/validity mask
    R: jax.Array,  # (C, 3, 3)
    t: jax.Array,  # (C, 3)
    K: jax.Array,  # (C, 3, 3)
    dist: jax.Array,  # (C, 5)
    X: jax.Array,  # (P, 3) initial structure
    free_cams: jax.Array,  # (C,) 1 = camera pose is optimized
    iterations: int = 20,
    robust: bool = True,
    huber_delta: float = 1.0,
    refine_intrinsics: bool = False,
    refine_structure: bool = True,
    refine_motion: bool = True,
    axis_name: str | None = None,
    intrinsics_cols: tuple[int, ...] | None = None,
) -> BAResult:
    """Masked dense-block sparse-BA (Schur-eliminated LM).

    The four reference modes map to the two boolean flags:
    BA_MOTSTRUCT = (True, True), BA_MOT = (True, False),
    BA_STRUCT = (False, True); BA_MOT_MOTSTRUCT additionally sets
    refine_intrinsics (BA_driver.h:69-82).

    ``axis_name``: when called inside `shard_map` with points sharded over a
    mesh axis, every reduction over the point dimension (camera Hessian
    blocks, Schur sums, gradients, cost) is completed with a `lax.psum` over
    that axis — the distributed windowed-BA design of SURVEY.md §5.7: each
    device owns a point block, the reduced camera system rides ICI.

    ``intrinsics_cols``: when ``refine_intrinsics``, restricts which of the
    10 intrinsic/distortion parameter columns (global indices 6..15 in the
    camera block) are free; None frees all of them. This carries the
    reference's optimInternals selectivity (pose_estim.cpp:1599-1617:
    2 = all intrinsics, 4 = focal only, 5 = distortion only).
    """
    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    P, C = vis.shape
    D = DOF_FULL if refine_intrinsics else DOF_POSE
    dtype = obs.dtype
    visf = vis.astype(dtype)
    delta2 = jnp.asarray(huber_delta**2, dtype)

    # free-parameter mask per camera column (D,) broadcast over cams
    cam_free = free_cams.astype(dtype)[:, None]  # (C, 1)
    if not refine_motion:
        cam_free = cam_free * 0.0
    # pose columns follow free_cams (gauge fixing); intrinsic/distortion
    # columns are free on EVERY camera — the reference refines internals of
    # all cameras, only extrinsics are gauge-fixed (pose_estim.cpp:1585-1623)
    param_free = cam_free * jnp.ones((D,), dtype)[None, :]  # (C, D)
    if refine_intrinsics:
        if intrinsics_cols is None:
            intr = jnp.ones((DOF_FULL - DOF_POSE,), dtype)
        else:
            intr = jnp.asarray(
                [
                    1.0 if i in intrinsics_cols else 0.0
                    for i in range(DOF_POSE, DOF_FULL)
                ],
                dtype,
            )
        param_free = jnp.concatenate(
            [
                param_free[:, :DOF_POSE],
                jnp.broadcast_to(intr[None, :], (C, DOF_FULL - DOF_POSE)),
            ],
            axis=1,
        )

    def residuals_at(Rc, tc, Kc, distc, Xc):
        """(P, C, 2) residual tensor at the current state."""
        def per_obs(Xp, op, Rj, tj, Kj, dj):
            return _project(Xp, Rj, tj, Kj, dj) - op

        f = jax.vmap(  # over cameras
            jax.vmap(per_obs, in_axes=(None, 0, 0, 0, 0, 0)),
            in_axes=(0, 0, None, None, None, None),
        )
        return f(Xc, obs, Rc, tc, Kc, distc)

    def cost_at(Rc, tc, Kc, distc, Xc):
        r = residuals_at(Rc, tc, Kc, distc, Xc)
        r2 = jnp.sum(r * r, axis=-1)
        c = _robust_cost(r2, delta2, robust) * visf
        return allsum(jnp.sum(c)) / jnp.maximum(allsum(jnp.sum(visf)), 1.0)

    def jacobians_at(Rc, tc, Kc, distc, Xc):
        """Per-observation residual r and jacobian blocks (Jc, Jx)."""
        def per_obs(Xp, op, Rj, tj, Kj, dj):
            fn = lambda d: _residual(
                d, Xp, op, Rj, tj, Kj, dj, refine_intrinsics
            )
            z = jnp.zeros((D + 3,), dtype)
            J = jax.jacfwd(fn)(z)  # (2, D+3)
            r = fn(z)
            return r, J[:, :D], J[:, D:]

        f = jax.vmap(
            jax.vmap(per_obs, in_axes=(None, 0, 0, 0, 0, 0)),
            in_axes=(0, 0, None, None, None, None),
        )
        return f(Xc, obs, Rc, tc, Kc, distc)  # (P,C,2),(P,C,2,D),(P,C,2,3)

    init_cost = cost_at(R, t, K, dist, X)

    def lm_step(state):
        Rc, tc, Kc, distc, Xc, lam, cost, n_acc = state
        r, Jc, Jx = jacobians_at(Rc, tc, Kc, distc, Xc)
        r2 = jnp.sum(r * r, axis=-1)
        w = _robust_weights(r2, delta2, robust) * visf  # (P, C)
        Jc = Jc * param_free[None, :, None, :]  # zero fixed-cam columns
        if not refine_structure:
            Jx = Jx * 0.0

        # normal-equation blocks (all masked by w)
        # U_c   = sum_p Jc^T W Jc   (C, D, D)
        U = allsum(jnp.einsum("pcri,pc,pcrj->cij", Jc, w, Jc))
        # V_p   = sum_c Jx^T W Jx   (P, 3, 3)
        V = jnp.einsum("pcri,pc,pcrj->pij", Jx, w, Jx)
        # W_pc  = Jc^T W Jx         (P, C, D, 3)
        Wb = jnp.einsum("pcri,pc,pcrj->pcij", Jc, w, Jx)
        # gradients
        g_c = -allsum(jnp.einsum("pcri,pc,pcr->ci", Jc, w, r))  # (C, D)
        g_x = -jnp.einsum("pcri,pc,pcr->pi", Jx, w, r)  # (P, 3)

        def try_lambda(lam):
            # Marquardt-scaled damping: lam * diag(max(diag(U), 1)) keeps the
            # step scale-invariant across mixed-magnitude parameters (focal
            # ~1e2, distortion ~1e-1, rotation ~1e0); the floor of 1 keeps
            # zeroed (fixed) columns positive definite
            Ud = U + lam * jax.vmap(jnp.diag)(
                jnp.maximum(jnp.diagonal(U, axis1=1, axis2=2), 1.0)
            )
            Vd = V + lam * jax.vmap(jnp.diag)(
                jnp.maximum(jnp.diagonal(V, axis1=1, axis2=2), 1.0)
            )
            Vinv = jnp.linalg.inv(Vd)  # (P, 3, 3) batched tiny inverse

            # Schur complement: S = blockdiag(Ud) - sum_p Wp Vinv Wp^T
            WVi = jnp.einsum("pcij,pjk->pcik", Wb, Vinv)  # (P, C, D, 3)
            S_off = allsum(
                jnp.einsum("pcik,pdlk->cidl", WVi, Wb)
            )  # (C,D,C,D)
            S = -S_off.reshape(C * D, C * D)
            # add block-diagonal Ud (scatter onto the C diagonal blocks)
            idx = jnp.arange(C * D).reshape(C, D)
            S = S.at[idx[:, :, None], idx[:, None, :]].add(Ud)

            rhs = g_c.reshape(C * D) - allsum(
                jnp.einsum("pcik,pk->ci", WVi, g_x)
            ).reshape(C * D)
            dcam = jnp.linalg.solve(S, rhs).reshape(C, D) * param_free
            # back-substitute points
            dX = jnp.einsum(
                "pij,pj->pi",
                Vinv,
                g_x - jnp.einsum("pcij,ci->pj", Wb, dcam),
            )
            if not refine_structure:
                dX = dX * 0.0

            # apply
            Rn = Rc @ exp_so3(dcam[:, 0:3])
            tn = tc + dcam[:, 3:6]
            if refine_intrinsics:
                dk = dcam[:, 6:11]
                Kn = Kc.at[:, 0, 0].add(dk[:, 0])
                Kn = Kn.at[:, 1, 1].add(dk[:, 1])
                Kn = Kn.at[:, 0, 2].add(dk[:, 2])
                Kn = Kn.at[:, 1, 2].add(dk[:, 3])
                Kn = Kn.at[:, 0, 1].add(dk[:, 4])
                dn = distc + dcam[:, 11:16]
            else:
                Kn, dn = Kc, distc
            Xn = Xc + dX
            return Rn, tn, Kn, dn, Xn

        Rn, tn, Kn, dn, Xn = try_lambda(lam)
        new_cost = cost_at(Rn, tn, Kn, dn, Xn)
        accept = new_cost < cost
        lam_next = jnp.where(accept, lam * 0.33, lam * 4.0)
        lam_next = jnp.clip(lam_next, 1e-10, 1e6)

        pick = lambda a, b: jnp.where(accept, a, b)
        return (
            pick(Rn, Rc), pick(tn, tc), pick(Kn, Kc), pick(dn, distc),
            pick(Xn, Xc), lam_next, jnp.minimum(new_cost, cost),
            n_acc + accept.astype(jnp.int32),
        )

    state = (R, t, K, dist, X, jnp.asarray(1e-3, dtype), init_cost,
             jnp.asarray(0, jnp.int32))
    state = jax.lax.fori_loop(0, iterations, lambda i, s: lm_step(s), state)
    Rf, tf, Kf, distf, Xf, _, final_cost, n_acc = state
    return BAResult(
        R=Rf, t=tf, K=Kf, dist=distf, points=Xf,
        initial_cost=init_cost, final_cost=final_cost, n_iterations=n_acc,
    )


# ---------------------------------------------------------------------------
# reference-parity entry points
# ---------------------------------------------------------------------------


class StereoBAResult(NamedTuple):
    R: jax.Array  # (3, 3) refined (or restored) relative rotation
    t: jax.Array  # (3,) unit translation
    K1: jax.Array
    K2: jax.Array
    points: jax.Array  # (P, 3)
    restored: jax.Array  # bool: guards rejected the BA update
    initial_cost: jax.Array
    final_cost: jax.Array


@functools.partial(jax.jit, static_argnames=("cfg",))
def refine_stereo_ba(
    R: jax.Array,
    t: jax.Array,
    x1: jax.Array,  # (P, 2) pixel coords cam1
    x2: jax.Array,  # (P, 2) pixel coords cam2
    X: jax.Array,  # (P, 3) triangulated points (cam1 frame)
    mask: jax.Array,  # (P,) valid-observation mask
    K1: jax.Array,
    K2: jax.Array,
    cfg: BAConfig = BAConfig(),
    dist1: jax.Array | None = None,
    dist2: jax.Array | None = None,
    huber_delta: jax.Array | float | None = None,
) -> StereoBAResult:
    """Two-view BA with cam0 fixed at the origin + restore guards.

    Reference: refineStereoBA (pose_estim.cpp:1083-1383) — quaternion
    motion packing, sba_motstr_levmar, then restore the input pose if
    dR > cfg.angle_thresh_deg or |d||t||| > cfg.t_norm_thresh
    (pose_estim.h:239-240).

    ``huber_delta`` optionally overrides cfg.huber_delta with a traced value
    (used when observations are in normalized rather than pixel units).
    """
    dtype = x1.dtype
    if dist1 is None:
        dist1 = jnp.zeros(5, dtype)
    if dist2 is None:
        dist2 = jnp.zeros(5, dtype)

    t_unit = geo.normalize_vec(t)
    obs = jnp.stack([x1, x2], axis=1)  # (P, 2cams, 2)
    vis = jnp.stack([mask, mask], axis=1)
    Rs = jnp.stack([jnp.eye(3, dtype=dtype), R])
    ts = jnp.stack([jnp.zeros(3, dtype), t_unit])
    Ks = jnp.stack([K1, K2]).astype(dtype)
    dists = jnp.stack([dist1, dist2]).astype(dtype)
    free = jnp.asarray([0.0, 1.0], dtype)

    res = bundle_adjust(
        obs, vis, Rs, ts, Ks, dists, X, free,
        iterations=cfg.iterations,
        robust=cfg.robust,
        huber_delta=cfg.huber_delta if huber_delta is None else huber_delta,
        refine_intrinsics=not cfg.fix_intrinsics,
    )
    R_new, t_new = res.R[1], res.t[1]

    # restore guards (refineStereoBA post checks)
    rdiff, _, _ = geo.compare_poses(R, t_unit, R_new, t_new)
    dtn = jnp.abs(jnp.linalg.norm(t_new) - 1.0)
    worse = res.final_cost >= res.initial_cost
    restore = (rdiff > cfg.angle_thresh_deg) | (dtn > cfg.t_norm_thresh) | worse

    scale = jnp.maximum(jnp.linalg.norm(t_new), 1e-12)
    R_out = jnp.where(restore, R, R_new)
    t_out = jnp.where(restore, t_unit, t_new / scale)
    X_out = jnp.where(restore, X, res.points / scale)
    return StereoBAResult(
        R=R_out, t=t_out, K1=res.K[0], K2=res.K[1], points=X_out,
        restored=restore,
        initial_cost=res.initial_cost, final_cost=res.final_cost,
    )


# map of the reference's optimInternals codes (pose_estim.cpp:1599-1617)
# onto free intrinsic/distortion columns of the camera parameter block
_INTRINSICS_MODES: dict[str, tuple[int, ...] | None] = {
    "none": None,
    "all": tuple(range(6, 16)),  # optimInternals = 2 (+ dists when given)
    "focal": (6, 7),  # optimInternals = 4 (optimFocalOnly)
    "dist": tuple(range(11, 16)),  # optimInternals = 5 (fixCamMat + dists)
}


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "robust", "refine_intrinsics",
                     "intrinsics_mode", "motion_only"),
)
def refine_multi_cam_ba(
    obs: jax.Array,  # (P, C, 2)
    vis: jax.Array,  # (P, C)
    R: jax.Array,  # (C, 3, 3)
    t: jax.Array,  # (C, 3)
    K: jax.Array,  # (C, 3, 3)
    X: jax.Array,  # (P, 3)
    iterations: int = 20,
    robust: bool = True,
    refine_intrinsics: bool = False,
    angle_thresh_deg: float = 1.25,
    t_norm_thresh: float = 0.05,
    dist: jax.Array | None = None,  # (C, 5) per-camera [k1 k2 p1 p2 k3]
    intrinsics_mode: str = "all",
    motion_only: bool = False,
    huber_delta: float = 1.0,
):
    """Multi-camera windowed BA, cam0 fixed (pose_estim.cpp:1384-1735
    refineMultCamBA).

    Reference parity:

    - per-camera distortion is refined together with the intrinsics when
      ``dist`` is given (perform_sba dist_vec path, pose_estim.cpp:1605-1618);
      ``intrinsics_mode`` selects the optimInternals subset: "all" (=2),
      "focal" (=4, optimFocalOnly), "dist" (=5, fixCamMat with dists),
      "none".
    - ``motion_only`` maps BA_MOT (optimMotionOnly, :1505-1508): structure
      is held fixed and NOT written back (:1719-1722).
    - restore is all-or-nothing: if ANY camera moves more than the guards
      allow, every camera / K / dist / point is restored and the function
      reports failure (:1654-1716) — unlike the stereo variant there is no
      per-camera salvage.
    - when focal lengths were refined, the guards are relaxed by the
      relative focal change: tf = min(1.5 * min(f_rel, 2), 2) scales the
      t-norm threshold and rf = max(1, 0.9 * min(f_rel, 2)) the angular one
      (:1679-1687).
    - translation difference is measured between *normalized* old/new
      translations (:1657-1677), not as a norm ratio.

    Returns (BAResult with restored-or-refined parameters, restored flag
    (C,) — all-True or all-False except cam0 which is always False).
    """
    C = R.shape[0]
    dtype = obs.dtype
    have_dist = dist is not None
    if dist is None:
        dist = jnp.zeros((C, 5), dtype)
    mode = intrinsics_mode if refine_intrinsics else "none"
    if mode != "none" and not have_dist and mode != "focal":
        # without distortion inputs only K params may move (reference only
        # refines dist when dists are provided)
        cols: tuple[int, ...] | None = tuple(range(6, 11))
    else:
        cols = _INTRINSICS_MODES[mode]
    res = bundle_adjust(
        obs, vis, R, t, K, dist, X,
        jnp.ones((C,), dtype).at[0].set(0.0),
        iterations=iterations, robust=robust, huber_delta=huber_delta,
        refine_intrinsics=mode != "none",
        refine_structure=not motion_only,
        intrinsics_cols=cols,
    )

    rdiff, _, _ = geo.compare_poses(R, t, res.R, res.t)  # (C,) degrees
    t_old_n = t / jnp.maximum(
        jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12
    )
    t_new_n = res.t / jnp.maximum(
        jnp.linalg.norm(res.t, axis=-1, keepdims=True), 1e-12
    )
    t_diff = jnp.linalg.norm(t_new_n - t_old_n, axis=-1)

    if mode in ("all", "focal"):
        f_rel = jnp.maximum(res.K[:, 0, 0], K[:, 0, 0]) / jnp.maximum(
            jnp.minimum(res.K[:, 0, 0], K[:, 0, 0]), 1e-9
        )
        tf = jnp.minimum(1.5 * jnp.minimum(f_rel, 2.0), 2.0)
        rf = jnp.maximum(1.0, 0.9 * jnp.minimum(f_rel, 2.0))
    else:
        tf = rf = jnp.ones((C,), dtype)

    worse = res.final_cost >= res.initial_cost
    per_cam_bad = (jnp.abs(rdiff) > rf * angle_thresh_deg) | (
        t_diff > tf * t_norm_thresh
    )
    per_cam_bad = per_cam_bad.at[0].set(False)
    failed = jnp.any(per_cam_bad) | worse

    R_out = jnp.where(failed, R, res.R)
    t_out = jnp.where(failed, t, res.t)
    K_out = jnp.where(failed, K, res.K)
    d_out = jnp.where(failed, dist, res.dist)
    X_out = jnp.where(failed | motion_only, X, res.points)
    restore = jnp.broadcast_to(failed, (C,)).at[0].set(False)
    return (
        res._replace(R=R_out, t=t_out, K=K_out, dist=d_out, points=X_out),
        restore,
    )
