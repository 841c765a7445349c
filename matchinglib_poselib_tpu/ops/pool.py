"""Correspondence pool: fixed-capacity SoA arrays with masked device ops.

Batched replacement for the reference's streaming pool machinery
(SURVEY.md P14/P15):

- `std::list<CoordinateProps>` + index map + nanoflann KD-tree
  (stereo_pose_refinement.h:214-217, nanoflannInterface.cpp) becomes one
  fixed-capacity structure-of-arrays with a validity mask. There is no
  index structure at all: spatial queries are masked distance matrices
  (one dense pass over the whole pool in place of tree traversal).
- the full CoordinateProps record (stereo_pose_types.h:34-62) is carried:
  pixel + camera coordinates, triangulated 3D point ``Q`` with the
  ``Q_tooFar`` far-point flag, ``nrFound`` re-detection counter, age in
  estimation iterations, and the per-correspondence Sampson-error history.
  The unbounded ``std::vector<double> SampsonErrors`` becomes the fixed
  sufficient statistics (sum, count, last, previous) — every reference use
  of the history (mean, last value for weights, is-the-error-increasing)
  reads from those four numbers.
- spatial dedup of new correspondences (filterNewCorrespondences,
  stereo_pose_refinement.cpp:2107 + compareCorrespondences :2450):
  nearest-pool-point radius check with the reference's decision rule
  (coincident-point nrFound bump, 5%/20% relative weight bands, age>15
  and increasing-error preferences). The reference compares against every
  pool point in the radius; this version compares against the nearest
  valid one — the dominant term of the same rule, evaluated densely.
- quality weights (computeCorrespondenceWeight :2514): 0.3/0.5/0.2 blend
  of inverse Sampson error, inverse descriptor distance and keypoint
  response, with the far-3D-point down-weighting (:2529-2537).
- capacity eviction (checkPoolSize :2550): concat + top-k by weight —
  insertion and eviction are a single fused sort per frame.

All functions are jitted with static capacities; the pool is a pytree of
equal-length arrays ("Pool") living on device across frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as geo


class Pool(NamedTuple):
    """SoA correspondence pool (capacity P, masked).

    Mirrors CoordinateProps (stereo_pose_types.h:34-62)."""

    pt1: jax.Array  # (P, 2) pixel coords, left
    pt2: jax.Array  # (P, 2) pixel coords, right
    x1: jax.Array  # (P, 2) normalized undistorted cam coords, left
    x2: jax.Array  # (P, 2) normalized undistorted cam coords, right
    desc_dist: jax.Array  # (P,) descriptor distance of the match
    response: jax.Array  # (P,) combined keypoint response
    sampson: jax.Array  # (P,) last squared Sampson error (SampsonErrors.back())
    sampson_prev: jax.Array  # (P,) previous entry of the error history
    sampson_sum: jax.Array  # (P,) running sum of the error history
    sampson_count: jax.Array  # (P,) int32 length of the error history
    q: jax.Array  # (P, 3) triangulated 3D point (camera-1 frame)
    q_valid: jax.Array  # (P,) bool: q has been triangulated
    q_too_far: jax.Array  # (P,) bool: z beyond maxDist3DPtsZ (or behind)
    n_found: jax.Array  # (P,) int32 nrFound re-detection counter
    age: jax.Array  # (P,) int32 estimation iterations alive
    weight: jax.Array  # (P,) eviction/quality weight (higher = better)
    valid: jax.Array  # (P,) bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def n_valid(self):
        return jnp.sum(self.valid.astype(jnp.int32))

    @property
    def mean_sampson(self):
        """meanSampsonError (stereo_pose_types.h:61)."""
        return self.sampson_sum / jnp.maximum(
            self.sampson_count.astype(self.sampson_sum.dtype), 1.0
        )


def empty_pool(capacity: int, dtype=jnp.float32) -> Pool:
    z2 = jnp.zeros((capacity, 2), dtype)
    z1 = jnp.zeros((capacity,), dtype)
    zi = jnp.zeros((capacity,), jnp.int32)
    zb = jnp.zeros((capacity,), bool)
    return Pool(
        pt1=z2, pt2=z2, x1=z2, x2=z2,
        desc_dist=z1, response=z1,
        sampson=jnp.full((capacity,), 1e9, dtype),
        sampson_prev=jnp.full((capacity,), 1e9, dtype),
        sampson_sum=z1, sampson_count=zi,
        q=jnp.zeros((capacity, 3), dtype),
        q_valid=zb, q_too_far=zb,
        n_found=zi, age=zi,
        weight=z1,
        valid=zb,
    )


def correspondence_weight(
    sampson_sq: jax.Array,
    desc_dist: jax.Array,
    response: jax.Array,
    th_sq: jax.Array,
    max_desc_dist: float = 256.0,
    q_too_far: jax.Array | None = None,
    q_z: jax.Array | None = None,
    max_dist_z: float = 50.0,
) -> jax.Array:
    """Quality weight per correspondence (higher = better).

    computeCorrespondenceWeight (stereo_pose_refinement.cpp:2514-2538):
    0.3 * (1 - err/th^2) + 0.5 * (1 - descrDist/max) + 0.2 * response/max,
    multiplied by the far-point penalty 0.5 + 0.9*maxDist3DPtsZ/(2z)
    (0.25 for points behind the camera) when Q_tooFar is set.
    """
    w_err = 1.0 - sampson_sq / jnp.maximum(th_sq, 1e-12)
    w_desc = 1.0 - jnp.clip(desc_dist / max_desc_dist, 0.0, 1.0)
    w_resp = jnp.clip(response, 0.0, 1.0)
    w = 0.3 * w_err + 0.5 * w_desc + 0.2 * w_resp
    if q_too_far is not None and q_z is not None:
        z_pen = jnp.where(
            q_z > 0,
            0.5 + 0.9 * max_dist_z / jnp.maximum(2.0 * q_z, 1e-9),
            0.25,
        )
        w = jnp.where(q_too_far, w * z_pen, w)
    return w


@jax.jit
def filter_new_vs_pool(
    pool: Pool,
    new_pt1: jax.Array,  # (K, 2) pixel coords (left image)
    new_pt2: jax.Array,  # (K, 2) pixel coords (right image)
    new_weight: jax.Array,  # (K,)
    new_valid: jax.Array,  # (K,) bool
    min_dist: jax.Array | float,
):
    """Spatial dedup of new correspondences against the pool.

    filterNewCorrespondences (stereo_pose_refinement.cpp:2107-2207) +
    compareCorrespondences (:2450-2497), against the nearest valid pool
    point in the left image:

    - coincident pair (both endpoints < 0.1px): drop the new one and bump
      the pool entry's nrFound (:2163-2169);
    - same-point pair (< sqrt(2)px at both endpoints): keep the clearly
      better one — the reference's 5% dead-band / 20% decisive band on the
      relative weight difference, with old-age (>15 iterations) and
      increasing-Sampson-error preferences for the new one (:2450-2497);
    - merely nearby (within minPtsDistance): new survives only if decisively
      better than the old (which is then evicted), mirroring :2186-2204.

    Returns (new_valid_out, pool_valid_out, n_found_out).
    """
    d2 = jnp.sum(
        (new_pt1[:, None, :] - pool.pt1[None, :, :]) ** 2, axis=-1
    )  # (K, P)
    d2 = jnp.where(pool.valid[None, :], d2, jnp.inf)
    near = jnp.argmin(d2, axis=1)  # (K,)
    near_d2 = jnp.take_along_axis(d2, near[:, None], axis=1)[:, 0]
    within = (near_d2 < (min_dist * min_dist)) & new_valid.astype(bool)

    d2_pt2 = jnp.sum((new_pt2 - pool.pt2[near]) ** 2, axis=-1)
    same_point = within & (near_d2 < 2.0) & (d2_pt2 < 2.0)
    coincident = same_point & (near_d2 < 0.01) & (d2_pt2 < 0.01)

    old_w = pool.weight[near]
    # compareCorrespondences decision (new vs old), :2450-2497
    rel_new = (new_weight - old_w) / jnp.maximum(new_weight, 1e-12)
    rel_old = (old_w - new_weight) / jnp.maximum(old_w, 1e-12)
    old_is_better = old_w >= new_weight
    # old wins on a >5% margin or when the new lead is inside the dead-band
    decisive_old = old_is_better & ((rel_old >= 0.05) | (rel_old > 0.2))
    dead_band = (~old_is_better) & (rel_new < 0.05)
    decisive_new = (~old_is_better) & (rel_new > 0.2)
    # tie region: prefer the new one for stale or drifting pool entries
    old_age_pref = pool.age[near] > 15
    err_increasing = pool.sampson[near] > pool.sampson_prev[near]
    tie = ~(decisive_old | dead_band | decisive_new)
    new_better = decisive_new | (tie & (old_age_pref | err_increasing))

    drop_new = within & (coincident | jnp.logical_not(new_better))
    kill_old = same_point & new_better & ~coincident
    # nearby-but-distinct: a decisively better new point evicts the old
    kill_old = kill_old | (within & ~same_point & decisive_new)

    new_valid_out = new_valid.astype(bool) & jnp.logical_not(drop_new)
    # several new points can share one nearest pool entry: it is evicted
    # when any of them kills it (a scatter-set of the per-point verdicts
    # would keep whichever write lands last, which on a GPU varies)
    killed = jnp.zeros(pool.valid.shape, jnp.int32).at[near].max(
        kill_old.astype(jnp.int32)
    )
    pool_valid_out = pool.valid & (killed == 0)
    n_found_out = pool.n_found.at[near].add(
        jnp.where(coincident, 1, 0)
    )
    return new_valid_out, pool_valid_out, n_found_out


@jax.jit
def insert_and_evict(
    pool: Pool,
    new_pt1, new_pt2, new_x1, new_x2,
    new_desc_dist, new_response, new_sampson,
    new_weight, new_valid,
) -> Pool:
    """Insert K new correspondences, evicting the lowest-weight entries.

    Batched fusion of addCorrespondencesToPool (:1150-1220) +
    checkPoolSize eviction (:2550): concatenate pool and new rows, keep the
    capacity-P best by (valid, weight) via one top_k. Invalid rows sort
    last, so free slots are always consumed before any eviction happens.
    New rows start their Sampson history with the entry error
    (:1191-1192) and nrFound = 1 (:1203).
    """
    P = pool.capacity
    cat = lambda a, b: jnp.concatenate([a, b], axis=0)
    valid = cat(pool.valid, new_valid.astype(bool))
    weight = cat(pool.weight, new_weight)
    score = jnp.where(valid, weight, -jnp.inf)
    _, keep = jax.lax.top_k(score, P)  # indices of survivors

    K = new_weight.shape[0]
    zi = jnp.zeros((K,), jnp.int32)
    take = lambda a, b: cat(a, b)[keep]
    return Pool(
        pt1=take(pool.pt1, new_pt1),
        pt2=take(pool.pt2, new_pt2),
        x1=take(pool.x1, new_x1),
        x2=take(pool.x2, new_x2),
        desc_dist=take(pool.desc_dist, new_desc_dist),
        response=take(pool.response, new_response),
        sampson=take(pool.sampson, new_sampson),
        sampson_prev=take(pool.sampson_prev, jnp.full((K,), 1e9, new_sampson.dtype)),
        sampson_sum=take(pool.sampson_sum, new_sampson),
        sampson_count=take(pool.sampson_count, zi + 1),
        q=take(pool.q, jnp.zeros((K, 3), new_sampson.dtype)),
        q_valid=take(pool.q_valid, jnp.zeros((K,), bool)),
        q_too_far=take(pool.q_too_far, jnp.zeros((K,), bool)),
        n_found=take(pool.n_found, zi + 1),
        age=take(pool.age, zi),
        weight=weight[keep],
        valid=valid[keep],
    )


@functools.partial(jax.jit, static_argnames=())
def update_pool_state(
    pool: Pool,
    E: jax.Array,
    R: jax.Array,
    t: jax.Array,
    th_sq: jax.Array,
    max_dist_z: jax.Array | float,
) -> Pool:
    """Post-acceptance pool update against the new pose.

    Mirrors the per-correspondence bookkeeping after each accepted
    estimation (stereo_pose_refinement.cpp:905-940): push the new Sampson
    error onto the history, re-triangulate ``Q`` with the Q_tooFar flag
    (z > maxDist3DPtsZ or behind a camera, triangPts3D semantics), bump the
    age, and recompute the eviction weight with the far-point penalty.
    """
    err = geo.sampson_error(E, pool.x1, pool.x2)
    X = geo.triangulate_linear(R, t, pool.x1, pool.x2)
    z2 = (X @ R.T + t)[:, 2]
    in_front = (X[:, 2] > 0) & (z2 > 0)
    too_far = (X[:, 2] > max_dist_z) | jnp.logical_not(in_front)
    w = correspondence_weight(
        err, pool.desc_dist, pool.response, th_sq,
        q_too_far=too_far, q_z=X[:, 2], max_dist_z=max_dist_z,
    )
    return pool._replace(
        sampson=err,
        sampson_prev=pool.sampson,
        sampson_sum=pool.sampson_sum + err,
        sampson_count=pool.sampson_count + 1,
        q=X,
        q_valid=pool.valid,
        q_too_far=too_far & pool.valid,
        age=pool.age + pool.valid.astype(jnp.int32),
        weight=jnp.where(pool.valid, w, 0.0),
    )


@jax.jit
def evict_outliers(pool: Pool, E: jax.Array, th_sq: jax.Array) -> Pool:
    """Drop pool entries inconsistent with the (refined) pose.

    Reference: outlier eviction from the pool after refinement
    (stereo_pose_refinement.cpp:861-908)."""
    err = geo.sampson_error(E, pool.x1, pool.x2)
    return pool._replace(valid=pool.valid & (err < th_sq))


@jax.jit
def far_point_ratio(pool: Pool):
    """ratio3DPtsFar (stereo_pose_refinement.cpp:3206-3210): fraction of
    triangulated pool points flagged Q_tooFar. The reference keeps
    incremental nr_Qs/nr_Q_tooFar counters; the dense pool recomputes the
    same ratio over the currently valid entries."""
    n_q = jnp.sum((pool.q_valid & pool.valid).astype(jnp.int32))
    n_far = jnp.sum((pool.q_too_far & pool.valid).astype(jnp.int32))
    return n_far.astype(jnp.float32) / jnp.maximum(n_q.astype(jnp.float32), 1.0)


@jax.jit
def pool_inlier_stats(pool: Pool, E: jax.Array, th_sq: jax.Array):
    """(n_inliers, n_valid, median/mean/std/MAD of sqrt-Sampson on inliers)."""
    err = geo.sampson_error(E, pool.x1, pool.x2)
    inl = (err < th_sq) & pool.valid
    n_inl = jnp.sum(inl.astype(jnp.int32))
    n_val = pool.n_valid
    stats = geo.masked_stats(jnp.sqrt(jnp.maximum(err, 0.0)), inl)
    return n_inl, n_val, stats
