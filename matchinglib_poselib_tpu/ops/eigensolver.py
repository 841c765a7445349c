"""Kneip eigensolver: direct rotation optimization for relative pose.

Batched equivalent of OpenGV's `eigensolver` used by the reference as a
minimal/nonminimal solver option (EssentialMatEstimator.h:501,669 via
opengv::relative_pose::eigensolver; RefineAlg PR_KNEIP rows of
pose_linear_refinement.cpp and pose_estim.h:67-77).

Kneip & Lynen (ICCV'13): for bearing vectors f1_i <-> f2_i under motion
(R, t), every epipolar plane normal n_i = f2_i x (R f1_i) is orthogonal to
t. The 3x3 covariance M(R) = sum w_i n_i n_i^T therefore has (in the
noise-free case) a zero eigenvalue with eigenvector t. The solver finds

    R* = argmin_R  lambda_min( M(R) ),    t* = eigvec_min( M(R*) )

Here R is parameterized by a Cayley vector around the current estimate and
minimized with a fixed-iteration damped Newton loop; gradients/Hessians
come from `jax.grad`/`jax.hessian` of the smallest eigenvalue of the 3x3 M
(closed-form eigensolve via jnp.linalg.eigh on 3x3 — tiny, batched).
Everything is fixed-shape and fully differentiable; vmap over batches of
problems for hypothesis-style use.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as geo


def _cayley_to_rot(c: jax.Array) -> jax.Array:
    """Cayley vector (..., 3) -> rotation (..., 3, 3). Singularity-free for
    |angle| < pi (fine for refinement steps around a base rotation)."""
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    s = 1.0 + c1 * c1 + c2 * c2 + c3 * c3
    one = jnp.ones_like(c1)
    R = jnp.stack(
        [
            1.0 + c1 * c1 - c2 * c2 - c3 * c3,
            2.0 * (c1 * c2 - c3),
            2.0 * (c1 * c3 + c2),
            2.0 * (c1 * c2 + c3),
            1.0 - c1 * c1 + c2 * c2 - c3 * c3,
            2.0 * (c2 * c3 - c1),
            2.0 * (c1 * c3 - c2),
            2.0 * (c2 * c3 + c1),
            1.0 - c1 * c1 - c2 * c2 + c3 * c3,
        ],
        axis=-1,
    ).reshape(c.shape[:-1] + (3, 3))
    return R / s[..., None, None]


def _m_matrix(R: jax.Array, b1: jax.Array, b2: jax.Array, w: jax.Array):
    """M(R) = sum_i w_i n_i n_i^T with n_i = b2_i x (R b1_i). (..., 3, 3)."""
    Rb1 = jnp.einsum("...ij,...nj->...ni", R, b1)
    n = jnp.cross(b2, Rb1)
    return jnp.einsum("...ni,...nj->...ij", n * w[..., None], n)


def _lambda_min(M: jax.Array) -> jax.Array:
    return jnp.linalg.eigh(M)[0][..., 0]


class EigensolverResult(NamedTuple):
    R: jax.Array  # (3, 3) rotation cam1 -> cam2
    t: jax.Array  # (3,) unit translation (sign resolved by cheirality vote)
    E: jax.Array  # (3, 3) essential matrix [t]x R
    eigenvalue: jax.Array  # final smallest eigenvalue (residual energy)


@functools.partial(jax.jit, static_argnames=("iterations",))
def solve_eigensolver(
    x1: jax.Array,
    x2: jax.Array,
    weights: jax.Array,
    R0: jax.Array | None = None,
    iterations: int = 12,
) -> EigensolverResult:
    """Relative pose by eigenvalue minimization over rotations.

    x1, x2: (N, 2) normalized image coords; weights: (N,) >= 0 (0 = masked
    out). R0: optional initial rotation (identity default — adequate for
    small/medium baselines, matching opengv's usage in the reference).
    """
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b2 = geo.normalize_vec(geo.to_homogeneous(x2))
    w = weights.astype(x1.dtype)
    if R0 is None:
        # seed from the weighted 8pt solution's cheirality-voted rotation —
        # identity seeding strands the Newton iteration in saddle regions
        # for medium rotations (opengv relies on its callers for the same)
        from matchinglib_poselib_tpu.ops import solvers

        E8, ok8 = solvers.solve_8pt(x1, x2, mask=w)
        R8, _, _, _, _ = geo.recover_pose(E8, x1, x2, w > 0.0)
        R0 = jnp.where(ok8, R8, jnp.eye(3, dtype=x1.dtype))

    def energy(c, Rbase):
        return _lambda_min(_m_matrix(Rbase @ _cayley_to_rot(c), b1, b2, w))

    grad_fn = jax.grad(energy)
    hess_fn = jax.hessian(energy)

    def body(_, carry):
        Rbase, lam = carry
        c0 = jnp.zeros(3, x1.dtype)
        g = grad_fn(c0, Rbase)
        H = hess_fn(c0, Rbase)
        # saddle-free Newton: |H| in its eigenbasis escapes the negative-
        # curvature saddles the plain damped Newton stalls in
        evals, V = jnp.linalg.eigh(H)
        scale = jnp.maximum(jnp.abs(evals), 1e-3 * jnp.max(jnp.abs(evals)))
        scale = jnp.maximum(scale, 1e-9)
        step = -(V @ ((V.T @ g) / scale))
        ok = jnp.isfinite(step).all()
        gd = -g / jnp.maximum(jnp.linalg.norm(g), 1e-9) * 0.05
        step = jnp.where(ok, step, gd)
        # line search over a small scale ladder (incl. "no move")
        scales = jnp.asarray([2.0, 1.0, 0.5, 0.25, 0.1, 0.0], x1.dtype)
        cands = scales[:, None] * step[None, :]
        vals = jax.vmap(lambda s: energy(s, Rbase))(cands)
        best = jnp.argmin(vals)
        R_new = Rbase @ _cayley_to_rot(cands[best])
        return R_new, vals[best]

    lam0 = _lambda_min(_m_matrix(R0, b1, b2, w))
    R, lam = jax.lax.fori_loop(0, iterations, body, (R0, lam0))

    # translation = eigenvector of the smallest eigenvalue of M(R*)
    M = _m_matrix(R, b1, b2, w)
    evals, evecs = jnp.linalg.eigh(M)
    t = evecs[..., :, 0]
    # sign by cheirality: the eigenvector's sign is arbitrary, and the
    # epipolar triple product <t, b2 x R b1> is ~0 for consistent data
    # (it IS the epipolar residual), so only triangulated depths decide —
    # count points in front of both cameras for +t vs -t
    maskb = w > 0.0
    n_pos, _, _ = geo.cheirality_counts(R, t, x1, x2, maskb)
    n_neg, _, _ = geo.cheirality_counts(R, -t, x1, x2, maskb)
    t = jnp.where(n_neg > n_pos, -t, t)
    E = geo.essential_from_rt(R, t)
    return EigensolverResult(R=R, t=t, E=E, eigenvalue=lam)


def refine_essential_kneip(
    E0: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    inlier_mask: jax.Array,
    weights: jax.Array | None = None,
    iterations: int = 12,
) -> EigensolverResult:
    """Kneip-style nonminimal refinement of an existing E on its inliers.

    The rotation seed comes from decomposing E0 (cheirality-voted recover),
    then the eigensolver polishes R directly on the inlier set — the
    equivalent of the reference's Kneip RefineAlg rows
    (pose_linear_refinement.cpp solver choice, pose_estim.h:67-77).
    """
    from matchinglib_poselib_tpu.ops.geometry import recover_pose

    w = inlier_mask.astype(x1.dtype)
    if weights is not None:
        w = w * weights
    R0, _, _, _, _ = recover_pose(E0, x1, x2, inlier_mask)
    return solve_eigensolver(x1, x2, w, R0=R0, iterations=iterations)
