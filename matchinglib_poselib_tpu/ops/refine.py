"""Iterative reweighted linear refinement of essential matrices.

Batched equivalent of the reference's linear refinement layer:
- refineEssentialLinear (pose_linear_refinement.cpp:85-640): IRLS on all
  inliers with Torr / pseudo-Huber weights, a shrinking threshold schedule
  th_use = m*th - (i+1)*th_step, and an inlier-loss guard that restores the
  previous model if the inlier count collapses.
- robustEssentialRefine (pose_estim.cpp:337): the same machinery at fixed
  threshold.
- the weighting functions of usac/utils/weightingEssential.cpp:53-165
  (Torr weights, pseudo-Huber weights).

All control flow is a fixed-iteration `lax.fori_loop`; the solver is the
weighted 8pt nonminimal solve (solvers.solve_8pt), matching the reference's
default solver choice; Nister/Stewenius/Kneip nonminimal variants reduce to
the same weighted DLT followed by manifold projection here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import (
    MinimalSolver,
    RefinementConfig,
    RefineWeights,
)
from matchinglib_poselib_tpu.ops import geometry as geo
from matchinglib_poselib_tpu.ops import smalllinalg, solvers


class RefineResult(NamedTuple):
    model: jax.Array  # (3, 3) refined essential matrix
    inlier_mask: jax.Array  # (N,) bool
    n_inliers: jax.Array
    mean_sampson: jax.Array  # mean squared Sampson error on final inliers


def _weights(
    E: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    err_sq: jax.Array,
    th_sq: jax.Array,
    kind: RefineWeights,
):
    """IRLS weights from Sampson residuals.

    Torr weights: the epipolar-gradient normalization 1/sqrt(denom) that
    turns the algebraic DLT error into the Sampson geometric error
    (weightingEssential.cpp:53 computeTorrWeights); pseudo-Huber:
    additionally w = 1/(1 + (e/b)^2)^(1/4), the sqrt of the pseudo-Huber
    influence over the residual (weightingEssential.cpp:101-165).
    """
    _, Ex1, Etx2 = geo.epipolar_products(E, x1, x2)
    denom = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    torr = 1.0 / jnp.sqrt(jnp.maximum(denom, 1e-12))
    if kind == RefineWeights.TORR:
        return torr
    if kind == RefineWeights.PSEUDO_HUBER:
        e = jnp.sqrt(jnp.maximum(err_sq, 1e-20))
        b = jnp.sqrt(jnp.maximum(th_sq, 1e-20))
        s = jnp.sqrt(1.0 + (e / b) ** 2)
        return torr / jnp.sqrt(s)
    return jnp.ones_like(torr)  # SQUARED = plain least squares


@functools.partial(jax.jit, static_argnames=("cfg",))
def refine_essential_linear(
    E0: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    threshold_sq: jax.Array,
    cfg: RefinementConfig = RefinementConfig(),
) -> RefineResult:
    """IRLS refinement of E on all correspondences within a shrinking band.

    E0: (3, 3) initial model; x1, x2: (N, 2); mask: (N,) validity;
    threshold_sq: squared inlier threshold (normalized coords).

    Shrinking schedule (pose_linear_refinement.cpp refineEssentialLinear):
    iteration i uses th_i = m*th - (i+1)*step with step chosen to land at
    1.0*th on the final iteration. The inlier-loss guard restores the
    previous model whenever the refit loses more than half the inliers.
    """
    maskb = mask.astype(bool)
    m = cfg.th_multiplier
    iters = cfg.iterations
    step = (m - 1.0) / max(iters, 1)

    # IRLS rounds run on a fixed-size compaction of the starting band
    # (same rationale as polish_pose_iterative: the 8pt refits are
    # bound by the padded point count, real inlier counts sit well
    # under the cap); the final classification below is on the FULL set
    x1f, x2f, maskf = x1, x2, maskb
    cap = cfg.refine_max_points
    if cap is not None and cap < x1.shape[0]:
        err_pre = geo.sampson_error(E0, x1, x2)
        band_pre = (err_pre < m * threshold_sq) & maskb
        score = band_pre.astype(x1.dtype) + maskb.astype(x1.dtype)
        sel = geo.spread_select(score, cap)
        x1, x2, maskb = x1[sel], x2[sel], maskb[sel]

    err0 = geo.sampson_error(E0, x1, x2)
    inl0 = (err0 < m * threshold_sq) & maskb
    n0 = jnp.sum(inl0).astype(jnp.int32)

    # hoist the weight-independent work out of the IRLS loop: the points
    # never change across iterations, so the Hartley normalization and
    # the DLT design rows are fixed — only the per-point weights vary.
    # (The fixed normalization uses the starting band; conditioning, not
    # exactness, is its job.) The loop body shrinks to one weighted
    # 9x9 normal-matrix build + smallest-eigenvector solve + manifold
    # projection — it sits on an 8-iteration sequential chain where
    # per-iteration op latency is the cost (trace: 626 us for the chain).
    maskb_f = inl0.astype(x1.dtype)
    x1n, T1 = geo.normalize_points(x1, maskb_f)
    x2n, T2 = geo.normalize_points(x2, maskb_f)
    A_rows = solvers.epipolar_rows(x1n, x2n)  # (N, 9) fixed
    T2t = jnp.swapaxes(T2, -1, -2)

    def _refit(w, ns_prev):
        Aw = A_rows * w[:, None]
        AtA = Aw.T @ Aw
        # 2 inverse iterations suffice: the residual eigenvalue of real
        # refit data is orders below lambda_2, and the previous
        # iteration's nullvector warm-starts the iteration (guaranteed
        # O(1) overlap with the target — ADVICE r4). The essential-
        # manifold projection is NOT applied per iteration — Sampson
        # scoring and the IRLS weights are well-defined for the raw DLT
        # solution, and the single projection after the loop lands the
        # final model on the manifold. That projection is SUPPORT-
        # GUARDED below: on some real frames the unconstrained DLT
        # drifts toward a fundamental-matrix solution whose projection
        # moves E by several thresholds and collapses the inlier set
        # (KITTI frame-31, round 5) — the guard then restores the
        # projection of the STARTING model instead, and the caller's
        # inlier-loss guard falls back to the (exactly essential)
        # minimal-solver model.
        ns = smalllinalg.min_eigvec_spd(AtA, iterations=2, v0=ns_prev)
        En = ns.reshape(3, 3)
        E_new = T2t @ En @ T1  # denormalize
        nrm = jnp.sqrt(jnp.sum(E_new * E_new))
        ok = jnp.isfinite(nrm) & (nrm > 1e-12)
        return jnp.where(ok, E_new / jnp.maximum(nrm, 1e-12), E0), ok, ns

    def body(i, carry):
        E, inl, n_inl, ns_prev = carry
        th_i = (m - (i + 1).astype(x1.dtype) * step) * threshold_sq
        err = geo.sampson_error(E, x1, x2)
        band = (err < th_i) & maskb
        w = _weights(E, x1, x2, err, threshold_sq, cfg.weights) * band.astype(
            x1.dtype
        )
        E_new, ok, ns = _refit(w, ns_prev)
        err_new = geo.sampson_error(E_new, x1, x2)
        inl_new = (err_new < threshold_sq) & maskb
        n_new = jnp.sum(inl_new).astype(jnp.int32)
        if cfg.inlier_loss_guard:
            keep = ok & (n_new >= n_inl // 2)
        else:
            keep = ok
        E = jnp.where(keep, E_new, E)
        inl = jnp.where(keep, inl_new, inl)
        n_inl = jnp.where(keep, n_new, n_inl)
        # the fresh nullvector warm-starts the next refit even when the
        # model update is rejected (it is still the best available seed
        # for the shrinking-band problem)
        return E, inl, n_inl, jnp.where(ok, ns, ns_prev)

    inl_init = (err0 < threshold_sq) & maskb
    # seed the warm start with the initial model expressed in the
    # normalized frame (En = T2^-T E0 T1^-1 up to scale; the inverse of
    # the similarity T = [[s,0,tx],[0,s,ty],[0,0,1]] is closed-form)
    def _inv_sim(T):
        s = T[0, 0]
        return jnp.asarray(
            [[1.0 / s, 0.0, -T[0, 2] / s],
             [0.0, 1.0 / s, -T[1, 2] / s],
             [0.0, 0.0, 1.0]], T.dtype)

    ns0 = (_inv_sim(T2).T @ E0 @ _inv_sim(T1)).reshape(9)
    E, inl, n_inl, _ = jax.lax.fori_loop(
        0, iters, body,
        (E0, inl_init, jnp.sum(inl_init).astype(jnp.int32), ns0),
    )
    # support-guarded manifold projection: if projecting the raw DLT
    # iterate collapses its support (the fundamental-drift failure — see
    # _refit), project the STARTING model instead; E0 comes from the
    # robust engine's minimal solver, which is exactly essential, so its
    # projection is a no-op and its support survives.
    E_proj = geo.closest_essential_fast(E)
    err_proj = geo.sampson_error(E_proj, x1, x2)
    n_proj = jnp.sum((err_proj < threshold_sq) & maskb).astype(jnp.int32)
    inl_pre = (err0 < threshold_sq) & maskb
    drifted = n_proj < jnp.sum(inl_pre).astype(jnp.int32) // 2
    E = jnp.where(drifted, geo.closest_essential_fast(E0), E_proj)
    if cfg.solver == MinimalSolver.KNEIP:
        # Kneip rows of the reference's RefineAlg (pose_estim.h:67-77):
        # polish the IRLS result with the rotation eigensolver on the final
        # inliers; keep only if the inlier count does not drop
        from matchinglib_poselib_tpu.ops import eigensolver

        kn = eigensolver.refine_essential_kneip(E, x1, x2, inl)
        err_k = geo.sampson_error(kn.E, x1, x2)
        inl_k = (err_k < threshold_sq) & maskb
        n_k = jnp.sum(inl_k)
        n_cur = jnp.sum(inl)
        err_cur = geo.sampson_error(E, x1, x2)

        def _mean_inl(e, m):
            n = jnp.maximum(jnp.sum(m.astype(e.dtype)), 1.0)
            return jnp.sum(jnp.where(m, e, 0.0)) / n

        # accept on strictly more inliers; break equal-count ties on mean
        # Sampson error, and never accept an empty or non-finite model
        keep = (n_k > 0) & jnp.all(jnp.isfinite(kn.E)) & (
            (n_k > n_cur)
            | ((n_k == n_cur) & (_mean_inl(err_k, inl_k) < _mean_inl(err_cur, inl)))
        )
        E = jnp.where(keep, kn.E, E)
        inl = jnp.where(keep, inl_k, inl)
    # final classification on the FULL (uncompacted) correspondence set
    err = geo.sampson_error(E, x1f, x2f)
    inl = (err < threshold_sq) & maskf
    n_inl = jnp.sum(inl).astype(jnp.int32)
    mean = jnp.sum(err * inl.astype(err.dtype)) / jnp.maximum(
        n_inl.astype(err.dtype), 1.0
    )
    return RefineResult(model=E, inlier_mask=inl, n_inliers=n_inl, mean_sampson=mean)


def _solve_spd_small(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for a tiny SPD system via fully unrolled Cholesky.

    The LM normal matrix H + lam*D is SPD by construction, so no
    pivoting is needed. ``jnp.linalg.solve`` lowers a 5x5 solve to XLA's
    general LU path — a dispatch-latency tax paid once per LM iteration
    across ~30 sequential iterations of the refinement chains; the
    unrolled factorization is pure scalar/vector arithmetic that XLA
    fuses into the surrounding step.
    """
    n = A.shape[0]
    # Cholesky: A = L L^T, unrolled over static columns
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        L[j][j] = d
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / d
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: rotation vector (3,) -> rotation matrix (3, 3)."""
    th2 = jnp.sum(w * w)
    th = jnp.sqrt(th2 + 1e-24)
    K = geo.skew(w / th)
    # Taylor-safe coefficients for tiny angles
    s = jnp.where(th2 > 1e-12, jnp.sin(th), th)
    c1 = jnp.where(th2 > 1e-12, 1.0 - jnp.cos(th), 0.5 * th2)
    return jnp.eye(3, dtype=w.dtype) + s * K + c1 * (K @ K)


def _t_basis(t: jax.Array) -> jax.Array:
    """Orthonormal (3, 2) basis of the tangent plane of the unit sphere at t."""
    e = jax.nn.one_hot(jnp.argmin(jnp.abs(t)), 3, dtype=t.dtype)
    b1 = jnp.cross(t, e)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(t, b1)
    b2 = b2 / jnp.maximum(jnp.linalg.norm(b2), 1e-12)
    return jnp.stack([b1, b2], axis=-1)


class PolishResult(NamedTuple):
    R: jax.Array  # (3, 3)
    t: jax.Array  # (3,) unit
    E: jax.Array  # (3, 3)
    cost: jax.Array  # final robust mean cost


@functools.partial(jax.jit, static_argnames=("iterations", "rotation_only"))
def polish_pose_sampson(
    R: jax.Array,
    t: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    weights: jax.Array,
    threshold_sq: jax.Array,
    iterations: int = 12,
    rotation_only: bool = False,
) -> PolishResult:
    """Levenberg-Marquardt Sampson polish over the 5-DOF (R, t) manifold.

    The decisive final-accuracy step (reference analogue: the nonlinear
    refinement the reference reaches through refineEssentialLinear +
    eigensolver polish, pose_linear_refinement.cpp:85-640): minimize the
    Huber-robustified signed Sampson distance over rotation (so(3) tangent)
    and translation direction (unit-sphere tangent), re-linearized about
    the current pose each iteration. All control flow is a fixed-iteration
    ``lax.fori_loop`` with accept/reject damping — one compiled program,
    no data-dependent shapes.

    weights: (N,) per-point weights (inlier mask as float, optionally
    quality-scaled). threshold_sq: squared normalized threshold used for
    the Huber scale.

    rotation_only: optimize the 3-DOF rotation tangent only, holding the
    translation direction fixed (used by the streaming frame tracker:
    per-frame rotation jitter is real while the rig's translation
    direction is far better estimated by the pool mean).
    """
    dtype = x1.dtype
    # scale residuals to O(1): signed Sampson L1 divided by the threshold
    th_l1 = jnp.sqrt(jnp.maximum(jnp.asarray(threshold_sq, dtype), 1e-18))
    inv_s = 1.0 / th_l1
    w_in = weights.astype(dtype)
    n_w = jnp.maximum(jnp.sum(w_in), 1.0)

    def signed_sampson(Rc, tc):
        E = geo.skew(tc) @ Rc
        num, Ex1, Etx2 = geo.epipolar_products(E, x1, x2)
        den = jnp.sqrt(
            Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
            + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        )
        return num / jnp.maximum(den, 1e-12) * inv_s

    def robust_cost(r):
        # pseudo-Huber with delta = 1 (the threshold, in scaled units)
        return jnp.sum(w_in * 2.0 * (jnp.sqrt(1.0 + r * r) - 1.0)) / n_w

    ndof = 3 if rotation_only else 5

    # convergence latch: the LM chain is the sequential-latency backbone
    # of the pose stage (~40 us/iteration in the fused step); from the
    # warm starts the surrounding rounds provide it typically converges
    # in 3-4 steps (measured step-norm history on KITTI: 1.8e-2 ->
    # 8e-4 -> 4e-5 -> 2e-6 rad), so a while_loop that exits once the
    # PROPOSED step is below tol skips only no-op iterations. The
    # tangent parameters are radians; tol = 1e-5 rad = 6e-4 deg, ~50x
    # below the parity noise floor. A rejected tiny step fires the
    # latch too — at the minimum, LM proposes tiny steps that cannot
    # reduce the cost, and retrying them at higher damping only
    # shrinks them further.
    tol = jnp.asarray(1e-5, dtype)

    def cond(carry):
        _, _, _, lam, i, done = carry
        return (i < iterations) & ~done

    def step(carry):
        Rc, tc, cost, lam, i, done = carry
        B = _t_basis(tc)

        def new_pose(p):
            Rn = Rc @ _exp_so3(p[:3])
            if rotation_only:
                return Rn, tc
            tn = tc + B @ p[3:]
            return Rn, tn / jnp.maximum(jnp.linalg.norm(tn), 1e-12)

        def resid(p):
            Rn, tn = new_pose(p)
            r = signed_sampson(Rn, tn)
            # IRLS sqrt-weights: Huber influence clipped at delta = 1
            wr = jnp.sqrt(
                w_in / jnp.sqrt(1.0 + jax.lax.stop_gradient(r) ** 2)
            )
            return r * wr

        p0 = jnp.zeros(ndof, dtype)
        r0 = resid(p0)
        J = jax.jacfwd(resid)(p0)  # (N, ndof)
        H = J.T @ J
        g = J.T @ r0
        D = jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(ndof, dtype=dtype)
        delta = _solve_spd_small(H + lam * D, -g)
        R_new, t_new = new_pose(delta)
        cost_new = robust_cost(signed_sampson(R_new, t_new))
        ok = jnp.isfinite(cost_new) & (cost_new < cost)
        Rc = jnp.where(ok, R_new, Rc)
        tc = jnp.where(ok, t_new, tc)
        cost = jnp.where(ok, cost_new, cost)
        lam = jnp.where(ok, lam * 0.33, lam * 4.0)
        step_sq = jnp.sum(delta * delta)
        done = (step_sq < tol * tol) | (lam > 1e8)
        return Rc, tc, cost, lam, i + 1, done

    cost0 = robust_cost(signed_sampson(R, t))
    Rf, tf, costf, _, _, _ = jax.lax.while_loop(
        cond, step,
        (R, t, cost0, jnp.asarray(1e-3, dtype), jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
    )
    return PolishResult(R=Rf, t=tf, E=geo.skew(tf) @ Rf, cost=costf)


def polish_pose_iterative(
    R: jax.Array,
    t: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    inliers: jax.Array,
    valid_mask: jax.Array,
    threshold_sq: jax.Array,
    rounds: int = 3,
    iterations: int = 15,
    max_points: int | None = None,
    point_weights: jax.Array | None = None,
    rotation_only: bool = False,
) -> tuple[PolishResult, jax.Array]:
    """Alternate Sampson LM polish with inlier re-selection to a fixed point.

    The single-shot polish converges onto the minimum OF ITS INPUT inlier
    set, which is the robust stage's — biased by the hypothesis that won
    RANSAC. Re-selecting inliers from ALL valid correspondences under the
    polished model and re-polishing walks both the pose and its support to
    a joint fixed point (the reference reaches the same effect through its
    iterative refineEssentialLinear + threshold schedule + final LO,
    pose_linear_refinement.cpp:85-640 / usac estimator refinement). On the
    bundled KITTI pairs this is the accuracy-decisive step: one round stops
    at t_ang ~1.3 deg mean, three rounds reach ~0.42 deg — at/below the
    OpenCV USAC reference workload (PARITY_ACCURACY.md).

    inliers: (N,) float initial support; valid_mask: (N,) float validity of
    the padded correspondence slots (re-selection is confined to it).
    max_points: when set and < N, the LM rounds run on a fixed-size
    compaction of the valid slots (valid inliers first) — the LM cost is
    per-iteration latency bound, so shrinking the padded point set cuts
    the pose-stage time; real valid-match counts sit well under the cap,
    so the re-selection pool is preserved. The returned inlier mask is
    always computed on the FULL input arrays under the final model.
    point_weights: optional (N,) persistent per-point quality weights
    (e.g. the correspondence pool's aggregated Sampson-history weights)
    multiplied into the LM support of EVERY round, so re-selection keeps
    honoring correspondence quality instead of flattening to 0/1.
    Returns the final PolishResult and the final boolean inlier mask.
    """
    dtype = x1.dtype
    valid = valid_mask.astype(bool)
    n = x1.shape[0]

    x1c, x2c = x1, x2
    wc = inliers.astype(dtype)
    validc = valid
    pw = None if point_weights is None else point_weights.astype(dtype)
    if max_points is not None and max_points < n:
        score = valid_mask.astype(dtype) + (inliers > 0).astype(dtype)
        sel = geo.spread_select(score, max_points)
        x1c, x2c = x1[sel], x2[sel]
        wc = inliers.astype(dtype)[sel]
        validc = valid[sel]
        if pw is not None:
            pw = pw[sel]
    if pw is not None:
        wc = wc * jnp.maximum(pw, 1e-3)

    # rounds latch: alternate LM polish and support re-selection until the
    # (pose, support) pair reaches its joint fixed point, then stop — once
    # a round changes the pose by < 2e-5 rad AND leaves the support set
    # unchanged, every further round is a no-op (same input -> same LM
    # minimum), so the dynamic exit is exactly accuracy-preserving while
    # skipping the tail rounds' sequential LM chains.
    def cond(carry):
        _, _, _, _, k, done = carry
        return (k < rounds) & ~done

    def body(carry):
        Rc, tc, wcur, cost, k, _ = carry
        pol = polish_pose_sampson(
            Rc, tc, x1c, x2c, wcur, threshold_sq, iterations=iterations,
            rotation_only=rotation_only,
        )
        err = geo.sampson_error(pol.E, x1c, x2c)
        w_new = ((err < threshold_sq) & validc).astype(dtype)
        if pw is not None:
            w_new = w_new * jnp.maximum(pw, 1e-3)
        # pose delta: rotation angle via trace, translation angle via dot
        ctr = 0.5 * (jnp.trace(pol.R @ Rc.T) - 1.0)
        rot_close = ctr > jnp.cos(jnp.asarray(2e-5, dtype))
        t_close = jnp.abs(jnp.sum(pol.t * tc)) > jnp.cos(
            jnp.asarray(2e-5, dtype)
        )
        support_same = jnp.all(w_new == wcur)
        done = rot_close & t_close & support_same
        return pol.R, pol.t, w_new, pol.cost, k + 1, done

    R, t, wc, cost, _, _ = jax.lax.while_loop(
        cond, body,
        (R, t, wc, jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
    )
    pol = PolishResult(R=R, t=t, E=geo.skew(t) @ R, cost=cost)
    err_full = geo.sampson_error(pol.E, x1, x2)
    return pol, (err_full < threshold_sq) & valid
