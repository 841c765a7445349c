"""Batched robust model estimation (RANSAC / PROSAC / LMEDS / USAC / ARRSAC).

One batched engine replaces the reference's four sequential robust loops
(SURVEY.md §7 stage 3):

- USAC<EssentialMatEstimator>::solve hypothesize-and-verify loop
  (usac/estimators/USAC.h:336-520)
- CvModelEstimator3::runRANSAC / runLMeDS / runARRSAC
  (five-point-nister/modelest.cpp:197,343,483)
- theia::Arrsac::Compute (arrsac/arrsac.h:88-117)

Design mapping (sequential CPU -> batched device):

- hypothesis loop            -> hypothesis *batches*: B minimal samples are
                                solved and densely scored per device step;
                                an outer `lax.while_loop` over batches stops
                                on the standard RANSAC confidence criterion
                                (the batch-granular analogue of USAC's
                                adaptive stopping, USAC.h update_stopping)
- SPRT per-point early exit  -> dense scoring of all N points on the elementwise/matmul
                                (cheaper than branching on the device; SPRT's
                                purpose — skipping bad models early — is
                                subsumed by scoring everything at once)
- PROSAC progressive pool    -> per-batch sampling-pool size n_k growing on
                                the PROSAC schedule over quality-sorted
                                matches (USAC.h generatePROSACMinSample)
- LOSAC inner refinement     -> weighted nonminimal re-solve on the best
                                model's inliers after the loop
                                (USAC.h locallyOptimizeSolution)
- zero-inlier th inflation   -> threshold *1.33 / *1.13 at 1/2 and 2/3 of
                                max batches when no model was found
                                (USAC.h:355-364)
- LMEDS                      -> same machinery, median-of-residuals score
                                and the 2.5*1.4826*sqrt(med) inlier band
                                (modelest.cpp:483 runLMeDS)

Everything is fixed-shape: N correspondences with a validity mask, B
hypotheses per batch, exactly `max_models_per_sample` models per sample.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import (
    MIN_PIX_TH,
    MinimalSolver,
    PIX_MIN_GOOD_TH,
    PoseEstimator,
    RobustConfig,
)
from matchinglib_poselib_tpu.ops import geometry as geo
from matchinglib_poselib_tpu.ops import solvers


class ModelFamily(NamedTuple):
    """A minimal-solver family pluggable into the robust engine."""

    name: str
    sample_size: int
    models_per_sample: int
    # (B, k, 2), (B, k, 2) -> (B, m, 3, 3), (B, m)
    solve: Callable
    # (M, 3, 3), (N, 2), (N, 2) -> (M, N) squared residuals
    error: Callable


def essential_family(
    solver: MinimalSolver = MinimalSolver.NISTER_5PT,
) -> ModelFamily:
    """5pt essential family. Both reference minimal solvers are available
    (EssentialMatEstimator.h:395,463 fivept_nister / fivept_stewenius);
    the Nister closed form is the default — it is the cheaper hypothesis
    generator on the device (polynomial convolutions vs 10x10 eigen-machinery)."""

    def err(E, x1, x2):
        # E: (M, 3, 3); points broadcast over M
        return geo.sampson_error(E, x1[None], x2[None])

    solve = (
        solvers.solve_5pt
        if solver == MinimalSolver.STEWENIUS_5PT
        else solvers.solve_5pt_nister
    )
    name = f"essential_5pt_{'stewenius' if solve is solvers.solve_5pt else 'nister'}"
    return ModelFamily(name, 5, 10, solve, err)


def essential_8pt_family() -> ModelFamily:
    def solve(x1, x2):
        E, v = solvers.solve_8pt(x1, x2)
        return E[:, None], v[:, None]

    def err(E, x1, x2):
        return geo.sampson_error(E, x1[None], x2[None])

    return ModelFamily("essential_8pt", 8, 1, solve, err)


def fundamental_7pt_family() -> ModelFamily:
    """Fundamental-matrix family (usac FundmatrixEstimator, SURVEY.md P4):
    7pt minimal solver (3 models/sample) + Sampson scoring."""

    def err(F, x1, x2):
        return geo.sampson_error(F, x1[None], x2[None])

    return ModelFamily("fundamental_7pt", 7, 3, solvers.solve_7pt, err)


def fundamental_8pt_family() -> ModelFamily:
    def solve(x1, x2):
        F, v = solvers.solve_8pt(x1, x2, essential=False)
        return F[:, None], v[:, None]

    def err(F, x1, x2):
        return geo.sampson_error(F, x1[None], x2[None])

    return ModelFamily("fundamental_8pt", 8, 1, solve, err)


def rotation_reproj_error(R, x1, x2):
    """Squared reprojection error of rotation-only motion: (M, N).

    R: (M, 3, 3); x1, x2: (N, 2) normalized coords.
    Reference: RotationMatEstimator.h residual.
    """
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))  # (N, 3)
    b1r = jnp.einsum("mij,nj->mni", R, b1)  # (M, N, 3)
    pr = b1r[..., :2] / jnp.maximum(jnp.abs(b1r[..., 2:]), 1e-9) * jnp.sign(
        b1r[..., 2:]
    )
    return jnp.sum((pr - x2[None]) ** 2, axis=-1)


def rotation_only_family() -> ModelFamily:
    """Rotation-only family (usac RotationMatEstimator twopt_rotationOnly,
    SURVEY.md P4): 2pt minimal Horn fit + rotational reprojection error."""

    def solve(x1, x2):
        w = jnp.ones(x1.shape[:-1], x1.dtype)
        R = rotation_only_model(x1, x2, w)  # (B, 3, 3)
        v = jnp.all(jnp.isfinite(R), axis=(-1, -2))
        return R[:, None], v[:, None]

    return ModelFamily("rotation_2pt", 2, 1, solve, rotation_reproj_error)


def homography_family() -> ModelFamily:
    def solve(x1, x2):
        H, v = solvers.solve_homography(x1, x2)
        return H[:, None], v[:, None]

    def err(H, x1, x2):
        return solvers.homography_transfer_error(H, x1[None], x2[None])

    return ModelFamily("homography_4pt", 4, 1, solve, err)


class RobustResult(NamedTuple):
    model: jax.Array  # (3, 3)
    inlier_mask: jax.Array  # (N,) bool
    n_inliers: jax.Array  # int32
    inlier_ratio: jax.Array  # f32 (vs valid correspondences)
    score: jax.Array  # engine score of the best model (higher = better)
    threshold: jax.Array  # (possibly inflated) squared threshold actually used
    n_batches: jax.Array  # batches executed by the while_loop
    n_hypotheses: jax.Array  # total models scored (UsacResults.hyp_count parity)
    # UsacResults observability parity (USAC.h:18-60). The dense batched
    # engine has no per-point SPRT, so "verified" counts every
    # (valid model x valid point) residual evaluation.
    n_models_generated: jax.Array = 0  # solver outputs incl. invalid solves
    n_models_rejected: jax.Array = 0  # invalid solves (prevalidation analogue)
    n_points_verified: jax.Array = 0  # residuals evaluated = valid models * N_valid
    n_lo_refinements: jax.Array = 0  # accepted LO re-fits (lo_numRefinements)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sample_without_replacement(key, pool_sizes, k: int, n_total: int):
    """Draw k distinct indices in [0, pool_b) per batch row.

    pool_sizes: (B,) traced pool sizes (PROSAC growth). Uses the classic
    shifted-draw scheme: draw r_j in [0, pool-j) and shift past previously
    chosen indices (kept sorted via a static insertion pass) — O(k^2) static
    ops, no rejection, exact uniformity.
    Returns (B, k) int32 indices < pool_sizes[b].
    """
    B = pool_sizes.shape[0]
    u = jax.random.uniform(key, (B, k))
    chosen = jnp.full((B, k), n_total + 7, jnp.int32)  # sentinel = +inf

    for j in range(k):
        pool_j = jnp.maximum(pool_sizes - j, 1)
        r = jnp.minimum((u[:, j] * pool_j).astype(jnp.int32), pool_j - 1)
        # shift r past each previously chosen index (ascending order matters:
        # process chosen in sorted order; maintain sorted invariant below)
        sorted_prev = jnp.sort(chosen, axis=1)  # sentinels sort last
        for jj in range(k):
            r = jnp.where(r >= sorted_prev[:, jj], r + 1, r)
        chosen = chosen.at[:, j].set(r)
    return chosen


def prosac_pool_schedule(batch_idx, n_valid, sample_size: int, max_batches: int):
    """Growing sampling-pool size: from ~3x sample_size to all matches.

    The reference's PROSAC growth function (USAC.h generatePROSACMinSample)
    grows the pool per-hypothesis; we grow per *batch* geometrically, which
    preserves the semantics (early batches concentrate on high-quality
    matches) at batch granularity.
    """
    n_valid = jnp.maximum(n_valid, sample_size + 2)
    start = jnp.minimum(4 * sample_size, n_valid)
    frac = (batch_idx.astype(jnp.float32) + 1.0) / float(max(max_batches - 1, 1))
    frac = jnp.minimum(frac, 1.0)
    pool = start.astype(jnp.float32) * (n_valid.astype(jnp.float32) / start) ** frac
    return jnp.minimum(jnp.ceil(pool).astype(jnp.int32), n_valid)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _score_models(models, mvalid, err_fn, x1, x2, mask, th_sq, lmeds: bool):
    """Score (M, 3, 3) models. Returns (score, counts, err) per model.

    RANSAC/USAC score = inlier count with an MSAC-style truncated-error
    tiebreak; LMEDS score = -median residual.
    """
    err = err_fn(models, x1, x2)  # (M, N)
    maskf = mask.astype(err.dtype)[None]
    inl = (err < th_sq) & (maskf > 0)
    counts = jnp.sum(inl, axis=-1).astype(jnp.int32)
    trunc = jnp.sum(jnp.minimum(err, th_sq) * maskf, axis=-1)
    if lmeds:
        med = geo.masked_median(err, jnp.broadcast_to(mask[None], err.shape))
        score = -med
    else:
        score = counts.astype(err.dtype) - trunc / (
            th_sq * (jnp.sum(maskf) + 1.0)
        )
    score = jnp.where(mvalid, score, -jnp.inf)
    return score, counts, err


def ransac(
    family: ModelFamily,
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array | None,
    cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
    prior_inlier_ratio: jax.Array | float | None = None,
) -> RobustResult:
    """Batched robust estimation of one model on one correspondence set.

    x1, x2: (N, 2) normalized coords (padded); mask: (N,) validity;
    quality: (N,) higher = better match (PROSAC ordering; None = no PROSAC).
    ``threshold_sq`` overrides cfg.threshold_px (already in normalized^2
    units — callers divide pixel thresholds by the focal length).

    ``prior_inlier_ratio``: batched analogue of the reference's SPRT
    epsilon initialization from match statistics (pose_estim.cpp:1814-1940,
    pose_helper.cpp:2879): the prior bounds the hypothesis budget — the
    while_loop may stop once the hypotheses implied by the prior have been
    drawn AND the best model's support is consistent with it (>= half the
    prior), so easy frames exit after one batch without risking a
    premature stop on an optimistic prior.

    vmap over leading batch dims by wrapping with jax.vmap externally.
    """
    N = x1.shape[0]
    lmeds = cfg.estimator == PoseEstimator.LMEDS
    if threshold_sq is None:
        threshold_sq = jnp.asarray(cfg.threshold_px**2, x1.dtype)
    else:
        threshold_sq = jnp.asarray(threshold_sq, x1.dtype)

    maskb = mask.astype(bool)
    n_valid = jnp.sum(maskb.astype(jnp.int32))

    # PROSAC ordering: valid matches sorted by quality desc; invalid last.
    if quality is None or not cfg.prosac:
        q = jnp.zeros((N,), x1.dtype)
    else:
        q = quality.astype(x1.dtype)
    order = jnp.argsort(jnp.where(maskb, -q, jnp.inf))  # (N,) best-first

    B = cfg.batch_hypotheses
    k = family.sample_size

    def one_batch(batch_idx, th_sq, key):
        pool = prosac_pool_schedule(
            jnp.full((B,), batch_idx), n_valid, k, cfg.max_batches
        )
        if not cfg.prosac or quality is None:
            pool = jnp.full((B,), 1, jnp.int32) * jnp.maximum(n_valid, k)
        else:
            # half of every batch samples the FULL valid pool (plain
            # uniform RANSAC rows): the adaptive confidence stop assumes
            # independent full-population draws, and a biased quality
            # prefix can otherwise certify an early stop on a coherent
            # WRONG structure (KITTI frame 7 key 7: the 63-match prefix
            # yields a 341-inlier model and the loop stopped before ever
            # sampling the 620-inlier model outside the prefix). PROSAC
            # keeps its fast-convergence half; the uniform half restores
            # the stop criterion's evidence basis.
            pool = pool.at[B // 2:].set(jnp.maximum(n_valid, k))
        idx = sample_without_replacement(key, pool, k, N)  # (B, k) in pool space
        idx = order[idx]  # map to actual correspondence indices
        s1 = x1[idx]  # (B, k, 2)
        s2 = x2[idx]
        models, mvalid = family.solve(s1, s2)  # (B, m, 3, 3), (B, m)
        M = B * family.models_per_sample
        models = models.reshape(M, 3, 3)
        mvalid = mvalid.reshape(M)
        score, counts, _ = _score_models(
            models, mvalid, family.error, x1, x2, maskb, th_sq, lmeds
        )
        best = jnp.argmax(score)
        n_rejected = jnp.sum(jnp.logical_not(mvalid)).astype(jnp.int32)
        return models[best], score[best], counts[best], n_rejected

    def cond(state):
        i, best_score, best_count, _, th_sq, done, n_rej = state
        return (i < cfg.max_batches) & jnp.logical_not(done)

    def body(state):
        i, best_score, best_count, best_model, th_sq, _, n_rej = state
        kb = jax.random.fold_in(key, i)
        # zero-inlier threshold inflation (USAC.h:355-364)
        if cfg.inflate_th_on_failure and not lmeds:
            at_half = (i == cfg.max_batches // 2) & (best_count <= k)
            at_two3 = (i == (2 * cfg.max_batches) // 3) & (best_count <= k)
            th_sq = jnp.where(at_half, th_sq * (1.33**2), th_sq)
            th_sq = jnp.where(at_two3, th_sq * (1.13**2), th_sq)
        model, score, count, batch_rej = one_batch(i, th_sq, kb)
        n_rej = n_rej + batch_rej
        better = score > best_score
        best_score = jnp.where(better, score, best_score)
        best_count = jnp.where(better, count, best_count)
        best_model = jnp.where(better, model, best_model)
        # adaptive stopping: P(miss) = (1 - w^k)^(hyps so far) < 1 - conf
        n_hyp = (i + 1.0) * B * family.models_per_sample
        w = best_count.astype(jnp.float32) / jnp.maximum(
            n_valid.astype(jnp.float32), 1.0
        )
        log_pmiss = n_hyp * jnp.log1p(-jnp.clip(w**k, 1e-12, 1.0 - 1e-7))
        done = log_pmiss < jnp.log(1.0 - cfg.confidence)
        if prior_inlier_ratio is not None:
            # SPRT-init parity: the match-statistics prior sizes the budget
            eps = jnp.clip(jnp.asarray(prior_inlier_ratio, jnp.float32),
                           0.0, 0.95)
            hyp_needed = jnp.log(1.0 - cfg.confidence) / jnp.log1p(
                -jnp.clip(eps**k, 1e-12, 1.0 - 1e-7)
            )
            prior_ok = (
                (n_hyp >= hyp_needed)
                & (best_count.astype(jnp.float32)
                   >= 0.5 * eps * n_valid.astype(jnp.float32))
                & (best_count > k)
            )
            done = done | prior_ok
        if lmeds:
            done = jnp.asarray(False)
        return (i + 1, best_score, best_count, best_model, th_sq, done, n_rej)

    init = (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(-jnp.inf, x1.dtype),
        jnp.asarray(0, jnp.int32),
        jnp.eye(3, dtype=x1.dtype),
        threshold_sq,
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
    )
    i, best_score, best_count, best_model, th_sq, _, n_rejected = (
        jax.lax.while_loop(cond, body, init)
    )

    # final inlier classification
    err = family.error(best_model[None], x1, x2)[0]
    if lmeds:
        med = geo.masked_median(err, maskb)
        # robust sigma band (modelest.cpp runLMeDS): 2.5 * 1.4826 * sqrt(med)
        s = 2.5 * 1.4826 * jnp.sqrt(jnp.maximum(med, 1e-20))
        th_out = s * s
    else:
        th_out = th_sq
    inl = (err < th_out) & maskb
    n_inl = jnp.sum(inl).astype(jnp.int32)
    ratio = n_inl.astype(jnp.float32) / jnp.maximum(n_valid.astype(jnp.float32), 1.0)
    n_generated = i * B * family.models_per_sample
    return RobustResult(
        model=best_model,
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=ratio,
        score=best_score,
        threshold=th_out,
        n_batches=i,
        n_hypotheses=n_generated,
        n_models_generated=n_generated,
        n_models_rejected=n_rejected,
        n_points_verified=(n_generated - n_rejected) * n_valid,
        n_lo_refinements=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# local optimization (LOSAC analogue) for essential matrices
# ---------------------------------------------------------------------------


def lo_refine_essential(
    result: RobustResult,
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    iterations: int = 4,
):
    """Iterative weighted 8pt re-fit on the current inlier set.

    Reference: USAC.h locallyOptimizeSolution + the inner-RANSAC 14-point
    refinement of ARRSAC; here the nonminimal solve uses *all* current
    inliers with pseudo-Huber weights, which dominates the 14-point variant.
    Keeps the refined model only if the inlier count does not drop.
    """
    th = result.threshold

    # hoist the weight-independent work (same rationale as
    # refine.refine_essential_linear): fixed Hartley normalization from
    # the starting inliers, fixed DLT rows; the loop body is a weighted
    # 9x9 normal solve. The manifold projection happens once after the
    # loop — Sampson scoring is well-defined for the raw DLT solution.
    from matchinglib_poselib_tpu.ops import smalllinalg

    inl0f = result.inlier_mask.astype(x1.dtype)
    x1n, T1 = geo.normalize_points(x1, inl0f)
    x2n, T2 = geo.normalize_points(x2, inl0f)
    A_rows = solvers.epipolar_rows(x1n, x2n)
    T2t = jnp.swapaxes(T2, -1, -2)

    # convergence latch: each LO round is a weighted refit + full rescore
    # on a sequential chain; once the refit reproduces the current model
    # (E delta below tol, sign-invariant) further rounds are no-ops, so a
    # dynamic while_loop exit is accuracy-neutral and trims the chain.
    def cond(carry):
        _, _, _, _, _, i, done = carry
        return (i < iterations) & ~done

    def body(carry):
        model, inl, n_inl, n_lo, ns_prev, i, _ = carry
        err = geo.sampson_error(model, x1, x2)
        # pseudo-Huber weights on the current inliers
        b2 = jnp.maximum(th, 1e-20)
        w = 1.0 / jnp.sqrt(jnp.sqrt(1.0 + err / b2))
        w = w * inl.astype(w.dtype)
        Aw = A_rows * w[:, None]
        # warm-start the inverse iteration with the previous nullvector
        # (guaranteed O(1) overlap with the target — ADVICE r4). Raw DLT
        # iterates (no per-iterate projection); the caller projects once
        # with a support guard (see estimate_essential_robust).
        ns = smalllinalg.min_eigvec_spd(Aw.T @ Aw, iterations=2, v0=ns_prev)
        E_new = T2t @ ns.reshape(3, 3) @ T1
        nrm = jnp.sqrt(jnp.sum(E_new * E_new))
        ok = jnp.isfinite(nrm) & (nrm > 1e-12)
        E_new = jnp.where(ok, E_new / jnp.maximum(nrm, 1e-12), model)
        err_new = geo.sampson_error(E_new, x1, x2)
        inl_new = (err_new < th) & mask.astype(bool)
        n_new = jnp.sum(inl_new).astype(jnp.int32)
        keep = ok & (n_new >= n_inl)
        # sign-invariant model delta (E is defined up to sign)
        d1 = jnp.sum((E_new - model) ** 2)
        d2 = jnp.sum((E_new + model) ** 2)
        done = keep & (jnp.minimum(d1, d2) < 1e-14)
        model = jnp.where(keep, E_new, model)
        inl = jnp.where(keep, inl_new, inl)
        n_inl = jnp.where(keep, n_new, n_inl)
        n_lo = n_lo + keep.astype(jnp.int32)
        return (model, inl, n_inl, n_lo, jnp.where(ok, ns, ns_prev),
                i + 1, done)

    def _inv_sim(T):
        s = T[0, 0]
        return jnp.asarray(
            [[1.0 / s, 0.0, -T[0, 2] / s],
             [0.0, 1.0 / s, -T[1, 2] / s],
             [0.0, 0.0, 1.0]], T.dtype)

    ns0 = (_inv_sim(T2).T @ result.model @ _inv_sim(T1)).reshape(9)
    model, inl, n_inl, n_lo, _, _, _ = jax.lax.while_loop(
        cond, body,
        (result.model, result.inlier_mask, result.n_inliers,
         jnp.asarray(0, jnp.int32), ns0, jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
    )
    n_valid = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    return result._replace(
        model=model,
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=n_inl.astype(jnp.float32) / n_valid,
        n_lo_refinements=n_lo,
    )


# ---------------------------------------------------------------------------
# degeneracy analysis (QDEGSAC / USAC degeneracy semantics)
# ---------------------------------------------------------------------------


class DegeneracyResult(NamedTuple):
    is_degenerate: jax.Array  # bool: E is unreliable
    h_fraction: jax.Array  # fraction of E-inliers explained by one H
    rot_fraction: jax.Array  # fraction explained by pure rotation
    static_fraction: jax.Array  # fraction explained by no motion
    H: jax.Array  # (3, 3) dominant homography
    R_rotonly: jax.Array  # (3, 3) rotation-only model
    # per-degeneracy-family inlier COUNTS (UsacResults degen_inlier counts,
    # USAC.h:18-60): absolute support of each family on the E-inliers
    h_inliers: jax.Array = 0
    rot_inliers: jax.Array = 0
    static_inliers: jax.Array = 0


def rotation_only_model(x1, x2, weights):
    """Closed-form rotation-only fit via Horn's quaternion method.

    Reference: RotationMatEstimator.h rotationOnly (opengv two-point
    rotation). Bearing vectors b = normalize([x, y, 1]); maximize
    sum w_i <b2_i, R b1_i> -> largest eigenvector of the 4x4 Davenport
    K-matrix (symmetric eigensolve).
    """
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b2 = geo.normalize_vec(geo.to_homogeneous(x2))
    w = weights[..., None]
    Bm = jnp.einsum("...ni,...nj->...ij", b2 * w, b1)  # correlation matrix
    tr = Bm[..., 0, 0] + Bm[..., 1, 1] + Bm[..., 2, 2]
    z = jnp.stack(
        [
            Bm[..., 1, 2] - Bm[..., 2, 1],
            Bm[..., 2, 0] - Bm[..., 0, 2],
            Bm[..., 0, 1] - Bm[..., 1, 0],
        ],
        axis=-1,
    )
    S = Bm + jnp.swapaxes(Bm, -1, -2)
    eye = jnp.eye(3, dtype=Bm.dtype)
    lower = S - tr[..., None, None] * eye
    K = jnp.zeros(Bm.shape[:-2] + (4, 4), Bm.dtype)
    K = K.at[..., 0, 0].set(tr)
    K = K.at[..., 0, 1:].set(z)
    K = K.at[..., 1:, 0].set(z)
    K = K.at[..., 1:, 1:].set(lower)
    _, vecs = jnp.linalg.eigh(K)
    q = vecs[..., :, -1]  # largest eigenvalue -> optimal quaternion (w,x,y,z)
    # this K convention yields the rotation taking b2 -> b1; we want b1 -> b2
    return jnp.swapaxes(geo.rot_from_quat(q), -1, -2)


def analyze_degeneracy(
    E_result: RobustResult,
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    cfg: RobustConfig,
    key: jax.Array,
) -> DegeneracyResult:
    """Score H / rotation-only / no-motion model families on the E-inliers.

    Replaces the reference's sequential QDEGSAC control flow
    (pose_estim.cpp:1983-2130, usac_estimations.cpp:1162
    estimateEssentialQDEGSAC) with "fit all families, compare explained
    fractions" — the same decision rule, batched.
    """
    th = E_result.threshold
    inl = E_result.inlier_mask
    inl_f = inl.astype(x1.dtype)
    n_inl = jnp.maximum(E_result.n_inliers.astype(jnp.float32), 1.0)

    # dominant homography on the E-inliers (small RANSAC). This is a
    # fraction TEST, not a model estimate: no LO polish, one batch, no
    # threshold inflation — 64 4-point samples detect a plane carrying
    # >degen_decision_ratio of the inliers with probability ~1-(1-r^4)^64
    # (> 0.9999 at r = 0.85)
    hcfg = RobustConfig(
        estimator=PoseEstimator.RANSAC,
        solver=MinimalSolver.HOMOGRAPHY,
        batch_hypotheses=min(cfg.batch_hypotheses, 64),
        max_batches=1,
        prosac=False,
        lo_refine=False,
        inflate_th_on_failure=False,
        check_degeneracy=False,
    )
    hres = ransac(
        homography_family(), x1, x2, inl, None, hcfg, key,
        threshold_sq=th,
    )
    h_frac = hres.n_inliers.astype(jnp.float32) / n_inl

    # rotation-only (Horn closed form on inliers) scored with angular resid
    R_ro = rotation_only_model(x1, x2, inl_f)
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b2 = geo.normalize_vec(geo.to_homogeneous(x2))
    b1r = b1 @ jnp.swapaxes(R_ro, -1, -2)
    # compare reprojected direction in normalized image plane
    pr = b1r[..., :2] / jnp.maximum(jnp.abs(b1r[..., 2:]), 1e-9) * jnp.sign(
        b1r[..., 2:]
    )
    rot_err = jnp.sum((pr - x2) ** 2, axis=-1)
    rot_inl = (rot_err < th) & inl
    rot_frac = jnp.sum(rot_inl).astype(jnp.float32) / n_inl

    # no-motion: x2 == x1 within threshold
    static_err = jnp.sum((x2 - x1) ** 2, axis=-1)
    static_inl = (static_err < th) & inl
    static_frac = jnp.sum(static_inl).astype(jnp.float32) / n_inl

    ratio = cfg.degen_decision_ratio
    is_degen = (h_frac > ratio) | (rot_frac > ratio) | (static_frac > ratio)
    return DegeneracyResult(
        is_degenerate=is_degen,
        h_fraction=h_frac,
        rot_fraction=rot_frac,
        static_fraction=static_frac,
        H=hres.model,
        R_rotonly=R_ro,
        h_inliers=hres.n_inliers,
        rot_inliers=jnp.sum(rot_inl).astype(jnp.int32),
        static_inliers=jnp.sum(static_inl).astype(jnp.int32),
    )


# ---------------------------------------------------------------------------
# top-level: robust essential estimation (the reference's estimator menu)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_essential_robust(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array,
    cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
    prior_inlier_ratio: jax.Array | float | None = None,
):
    """Full robust E estimation: RANSAC/PROSAC batches + LO refinement.

    Equivalent of estimateEssentialMat / estimateEssentialOrPoseUSAC
    (pose_estim.cpp:857,1737) for a single (padded) correspondence set.
    Returns (RobustResult, DegeneracyResult | None).
    """
    if cfg.solver == MinimalSolver.EIGHT_PT:
        family = essential_8pt_family()
    else:
        family = essential_family(cfg.solver)
    res = ransac(family, x1, x2, mask, quality, cfg, key, threshold_sq,
                 prior_inlier_ratio=prior_inlier_ratio)
    if cfg.lo_refine:
        res0 = res  # ransac winner: minimal-solver model, exactly essential
        res = lo_refine_essential(res, x1, x2, mask, cfg.lo_inner_iterations)
        # re-classify against the PROJECTED model so the returned mask and
        # counters agree with the returned model (the raw DLT iterate and
        # its manifold projection can disagree at the threshold edge —
        # ADVICE r4). SUPPORT GUARD: on some real frames the raw-DLT LO
        # chain drifts toward a fundamental-matrix solution whose
        # projection moves E by several thresholds and collapses the
        # inlier set (KITTI frame-31, round 5) — keep the LO outcome only
        # if its PROJECTED support does not fall below the pre-LO support,
        # else restore the ransac winner (whose mask is already honest).
        E_proj = geo.closest_essential(res.model)
        err_p = geo.sampson_error(E_proj, x1, x2)
        inl_p = (err_p < res.threshold) & mask.astype(bool)
        n_p = jnp.sum(inl_p).astype(jnp.int32)
        keep_lo = n_p >= res0.n_inliers
        res = res._replace(
            model=jnp.where(keep_lo, E_proj, res0.model),
            inlier_mask=jnp.where(keep_lo, inl_p, res0.inlier_mask),
            n_inliers=jnp.where(keep_lo, n_p, res0.n_inliers),
            n_lo_refinements=jnp.where(
                keep_lo, res.n_lo_refinements, jnp.asarray(0, jnp.int32)
            ),
        )
    if cfg.check_degeneracy:
        degen = analyze_degeneracy(
            res, x1, x2, mask, cfg, jax.random.fold_in(key, 777)
        )
    else:
        degen = None
    return res, degen


# ---------------------------------------------------------------------------
# fundamental / rotation-only robust estimation + QDEGSAC
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "use_8pt"))
def estimate_fundamental_robust(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array | None,
    cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
    use_8pt: bool = False,
) -> RobustResult:
    """Robust fundamental-matrix estimation (estimateFundMatrixUsac,
    usac_estimations.cpp:83). 7pt minimal (3 models/sample) by default."""
    fam = fundamental_8pt_family() if use_8pt else fundamental_7pt_family()
    return ransac(fam, x1, x2, mask, quality, cfg, key, threshold_sq)


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_nomotion_robust(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array | None,
    cfg: RobustConfig,
    key: jax.Array | None = None,
    threshold_sq: jax.Array | float | None = None,
) -> RobustResult:
    """No-motion robust estimation — the last family of the reference's
    estimator menu (usac NoMotionEstimator.h, dispatched alongside
    estimateEssentialMatUsac / estimateRotationMatUsac in
    usac_estimations.cpp; SURVEY.md P4).

    The no-motion hypothesis space contains exactly one model — the
    identity motion (R = I, t = 0) — whose support is every
    correspondence with (normalized) displacement under the threshold.
    The reference still spins its USAC loop to verify that one model; on
    here the search collapses to a single dense scoring pass over all
    points, which is both exact and the fastest possible formulation.
    The returned model slot carries the identity rotation; ``quality``
    and ``key`` are accepted for menu-signature parity and unused.
    """
    del quality, key
    if threshold_sq is None:
        threshold_sq = jnp.asarray(cfg.threshold_px**2, x1.dtype)
    th = jnp.asarray(threshold_sq, x1.dtype)
    maskb = mask.astype(bool)
    err = jnp.sum((x2 - x1) ** 2, axis=-1)
    inl = (err < th) & maskb
    n_inl = jnp.sum(inl).astype(jnp.int32)
    n_valid = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    # MSAC-style score for comparability with the other families
    score = jnp.sum(jnp.where(inl, th - err, 0.0))
    return RobustResult(
        model=jnp.eye(3, dtype=x1.dtype),
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=n_inl.astype(jnp.float32) / n_valid,
        score=score,
        threshold=th,
        n_batches=jnp.asarray(1, jnp.int32),
        n_hypotheses=jnp.asarray(1, jnp.int32),
        n_models_generated=jnp.asarray(1, jnp.int32),
        n_models_rejected=jnp.asarray(0, jnp.int32),
        n_points_verified=jnp.sum(mask.astype(jnp.int32)),
        n_lo_refinements=jnp.asarray(0, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_rotation_robust(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array | None,
    cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
) -> RobustResult:
    """Robust rotation-only estimation (estimateRotationMatUsac,
    usac_estimations.cpp:736): 2pt Horn hypotheses + Horn re-fit on the
    final inlier set (the LO step of the rotation problem)."""
    res = ransac(
        rotation_only_family(), x1, x2, mask, quality, cfg, key, threshold_sq
    )
    # closed-form refit on all inliers (dominates per-sample 2pt models)
    R_fit = rotation_only_model(x1, x2, res.inlier_mask.astype(x1.dtype))
    err = rotation_reproj_error(R_fit[None], x1, x2)[0]
    inl = (err < res.threshold) & mask.astype(bool)
    n_new = jnp.sum(inl).astype(jnp.int32)
    # strict improvement + non-empty support + finite model: a rank-deficient
    # all-points fit must never displace the RANSAC model on a 0-0 tie
    better = (n_new > res.n_inliers) & (n_new > 0) & jnp.all(jnp.isfinite(R_fit))
    n_valid = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)
    return res._replace(
        model=jnp.where(better, R_fit, res.model),
        inlier_mask=jnp.where(better, inl, res.inlier_mask),
        n_inliers=jnp.where(better, n_new, res.n_inliers),
        inlier_ratio=jnp.where(
            better, n_new.astype(jnp.float32) / n_valid, res.inlier_ratio
        ),
    )


class QdegsacResult(NamedTuple):
    result: RobustResult  # the E estimate (valid when not degenerate)
    F_result: RobustResult  # the unconstrained epipolar-geometry estimate
    R_result: RobustResult  # rotation-only estimate on the F-inliers
    is_degenerate: jax.Array  # bool: scene is rotation-dominated
    rot_fraction: jax.Array  # rotation-explained fraction of F-inliers


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_essential_qdegsac(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array,
    cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float | None = None,
) -> QdegsacResult:
    """QDEGSAC: robust F on the full set -> robust rotation-only on the
    F-inliers -> degeneracy decision -> E on the F-inliers.

    Reference control flow: estimateEssentialQDEGSAC
    (usac_estimations.cpp:1162) as dispatched by pose_estim.cpp:1983-2130
    (DEGEN_QDEGSAC). The decision rule — declare rotation-degeneracy when
    the rotation model explains more than ``cfg.degen_decision_ratio`` of
    the F-inliers — matches the fraction comparison of pose_estim.cpp:2102.
    Runs on normalized coords; the F stage is simply the unconstrained
    (projective) epipolar model over those coords.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    fcfg = dataclasses.replace(cfg, check_degeneracy=False, lo_refine=False)
    fres = ransac(
        fundamental_7pt_family(), x1, x2, mask, quality, fcfg, k1,
        threshold_sq,
    )
    rres = estimate_rotation_robust(
        x1, x2, fres.inlier_mask, quality, fcfg, k2, threshold_sq
    )
    rot_frac = rres.n_inliers.astype(jnp.float32) / jnp.maximum(
        fres.n_inliers.astype(jnp.float32), 1.0
    )
    is_degen = rot_frac > cfg.degen_decision_ratio
    # E estimated on the F-supported correspondences (QDEGSAC's final stage)
    eres, _ = estimate_essential_robust(
        x1, x2, fres.inlier_mask, quality,
        dataclasses.replace(cfg, check_degeneracy=False), k3, threshold_sq,
    )
    return QdegsacResult(
        result=eres,
        F_result=fres,
        R_result=rres,
        is_degenerate=is_degen,
        rot_fraction=rot_frac,
    )


# ---------------------------------------------------------------------------
# AutoThEpi: automatic inlier-threshold adaptation
# ---------------------------------------------------------------------------


class AutoThResult(NamedTuple):
    result: RobustResult
    degen: DegeneracyResult | None
    threshold: jax.Array  # adapted threshold (distance units, normalized)
    n_rounds: jax.Array  # rounds actually used before convergence latch


def estimate_essential_autoth(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array,
    quality: jax.Array,
    cfg: RobustConfig,
    key: jax.Array,
    threshold_sq: jax.Array | float,
    min_threshold: jax.Array | float,
    max_threshold: jax.Array | float,
    rounds: int = 3,
) -> AutoThResult:
    """Robust E with automatic threshold adaptation (AutoThEpi,
    pose_estim.cpp:82-300 estimateEVarTH / estimateThresh).

    All thresholds are *distances* in normalized camera units (the caller
    converts pixels via the mean focal length; the reference uses its
    pixToCamFact for the same purpose). Semantics preserved:

    - each round runs the robust engine at the current threshold, then
      re-estimates the threshold from the residual statistics of ALL
      correspondences under the found E: median + 3*1.4826*MAD when the
      mean/median ratio is implausible (<0.5 or >2 — heavy outlier tail),
      else mean + 3*std (estimateThresh, pose_estim.cpp:~200);
    - residuals beyond min(4*th, 5px) are trimmed from the statistics
      (maxInlDist);
    - a runaway estimate (th_tmp >= 5*th and >= 4*PIX_MIN_GOOD_TH) doubles
      the threshold instead (resetting to the minimum once at half the
      maximum), clamped to [min_threshold, max_threshold];
    - iteration stops once the threshold moved by less than 10% or the
      inlier ratio reached 0.67 (the reference's do/while condition);
      rounds after convergence are latched, keeping shapes static — the
      oscillation bookkeeping (th_sem flags) is subsumed by the fixed
      round count.
    """
    th = jnp.sqrt(jnp.asarray(threshold_sq, x1.dtype))
    min_th = jnp.asarray(min_threshold, x1.dtype)
    max_th = jnp.asarray(max_threshold, x1.dtype)
    # 5px trim ceiling and 4*PIX_MIN_GOOD_TH runaway floor in camera units:
    # both scale from the pixel constants by min_th / MIN_PIX_TH
    px_unit = min_th / MIN_PIX_TH
    trim_ceiling = 5.0 * px_unit
    runaway_floor = 4.0 * PIX_MIN_GOOD_TH * px_unit

    maskb = mask.astype(bool)
    frozen = jnp.asarray(False)
    best = None
    n_rounds = jnp.asarray(0, jnp.int32)

    for r in range(rounds):
        key, sub = jax.random.split(key)
        res, _ = estimate_essential_robust(
            x1, x2, mask, quality,
            dataclasses.replace(cfg, check_degeneracy=False), sub,
            threshold_sq=th * th,
        )
        err = jnp.sqrt(jnp.maximum(geo.sampson_error(res.model, x1, x2), 0.0))
        max_inl_dist = jnp.minimum(4.0 * th, trim_ceiling)
        stat_mask = maskb & (err < max_inl_dist)
        med, mean, std, mad = geo.masked_stats(err, stat_mask)
        med_std = 1.4826 * mad
        ratio = mean / jnp.maximum(med, 1e-12)
        th_tmp = jnp.where(
            (ratio > 2.0) | (ratio < 0.5), med + 3.0 * med_std,
            mean + 3.0 * std,
        )
        sane = (th_tmp < 5.0 * th) | (th_tmp < runaway_floor)
        fallback = jnp.where(th < 0.5 * max_th, 2.0 * th, min_th)
        th_new = jnp.clip(jnp.where(sane, th_tmp, fallback), min_th, max_th)

        if best is None:
            best = res
        else:
            best = jax.tree.map(
                lambda old, new: jnp.where(frozen, old, new), best, res
            )
        n_rounds = jnp.where(frozen, n_rounds, r + 1)
        moved = (th / jnp.maximum(th_new, 1e-12) < 0.9) | (
            th_new / jnp.maximum(th, 1e-12) < 0.9
        )
        converged = ~moved | (res.inlier_ratio >= 0.67)
        th = jnp.where(frozen, th, th_new)
        frozen = frozen | converged

    if cfg.check_degeneracy:
        degen = analyze_degeneracy(
            best, x1, x2, mask, cfg, jax.random.fold_in(key, 777)
        )
    else:
        degen = None
    # the adapted threshold: like the reference, estimateThresh runs in the
    # terminating iteration too and its value is stored for the next frame
    return AutoThResult(
        result=best, degen=degen, threshold=th, n_rounds=n_rounds
    )
