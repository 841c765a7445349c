"""Closed-form tiny linear algebra for sequential latency chains.

``jnp.linalg.{svd,eigh,solve}`` on tiny batched matrices run iterative
Jacobi/LU routines — correct, but each call adds loop latency on a
*sequential* chain (the IRLS/LM refinement loops run ~30 dependent
iterations, each with a 3x3 SVD projection and a 9x9 smallest-eigenvector
solve).

This module replaces those inner-loop calls with branch-free closed
forms — pure fused arithmetic XLA folds into the surrounding step:

- ``eigh_sym3x3``: Cardano/trigonometric eigenvalues + cross-product
  eigenvectors of a symmetric 3x3 (ascending order, like jnp.linalg.eigh).
- ``svd3x3``: SVD of a general 3x3 via eigh of A^T A (V), singular
  values from the eigenvalues, U from normalized A V columns with an
  orthonormal completion for (near-)zero singular values.
- ``min_eigvec_spd``: smallest eigenvector of an SPD/PSD NxN (static N)
  by shifted inverse iteration with an unrolled Cholesky solve.

Accuracy notes: f32 closed forms are exact to ~1e-6 relative for the
well-separated spectra these call sites produce (essential-matrix
projection: two similar singular values + one near zero; IRLS normal
matrices: smallest eigenvalue separated by the data residual). The
module is NOT a general SVD replacement — callers with possibly
degenerate spectra should keep jnp.linalg.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def eigh_sym3x3(A: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Eigen-decomposition of a symmetric 3x3 (batched over leading dims).

    Returns (w, V) with ascending eigenvalues w (..., 3) and
    eigenvectors in the columns of V (..., 3, 3) — the jnp.linalg.eigh
    convention. Trigonometric (Cardano) closed form for the values;
    vectors from cross products of the two best-conditioned rows of
    (A - w I), with a deterministic fallback basis for repeated
    eigenvalues.
    """
    dtype = A.dtype
    # scale for conditioning
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-38))
    Bn = B / p[..., None, None]
    detBn = jnp.linalg.det(Bn)
    r = jnp.clip(detBn / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # eigenvalues of A: q + 2 p cos(phi + 2k pi / 3), descending in k=0
    w0 = q + 2.0 * p * jnp.cos(phi)
    w2 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = jnp.stack([w2, w1, w0], axis=-1)  # ascending

    def eigvec(wk):
        # null vector of (A - wk I) via the largest cross product of rows
        M = A - wk[..., None, None] * jnp.eye(3, dtype=dtype)
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = jnp.cross(r0, r1)
        c02 = jnp.cross(r0, r2)
        c12 = jnp.cross(r1, r2)
        n01 = jnp.sum(c01 * c01, axis=-1)
        n02 = jnp.sum(c02 * c02, axis=-1)
        n12 = jnp.sum(c12 * c12, axis=-1)
        best = jnp.stack([n01, n02, n12], axis=-1)
        idx = jnp.argmax(best, axis=-1)
        v = jnp.where(
            (idx == 0)[..., None], c01,
            jnp.where((idx == 1)[..., None], c02, c12),
        )
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 1e-38))
        return v / nrm[..., None], jnp.max(best, axis=-1)

    v0, q0 = eigvec(w[..., 0])
    v2, q2 = eigvec(w[..., 2])
    # middle vector: orthogonal completion (robust to repeated values)
    v1 = jnp.cross(v2, v0)
    n1 = jnp.sqrt(jnp.maximum(jnp.sum(v1 * v1, axis=-1), 1e-38))
    v1 = v1 / n1[..., None]
    # repeated-eigenvalue fallback: if the null space was ill-determined
    # (cross products ~ 0), build any orthonormal frame from the best
    # vector available
    def complete_frame(a):
        e = jnp.where(
            (jnp.abs(a[..., 0:1]) < 0.9),
            jnp.broadcast_to(
                jnp.asarray([1.0, 0.0, 0.0], dtype), a.shape
            ),
            jnp.broadcast_to(
                jnp.asarray([0.0, 1.0, 0.0], dtype), a.shape
            ),
        )
        b = jnp.cross(a, e)
        b = b / jnp.sqrt(
            jnp.maximum(jnp.sum(b * b, axis=-1, keepdims=True), 1e-38)
        )
        c = jnp.cross(a, b)
        return b, c

    bad0 = q0 < 1e-20
    bad2 = q2 < 1e-20
    f1, f2 = complete_frame(v0)
    v1 = jnp.where(bad2[..., None], f1, v1)
    v2 = jnp.where(bad2[..., None], f2, v2)
    g1, g0 = complete_frame(v2)
    v1 = jnp.where(bad0[..., None] & ~bad2[..., None], g1, v1)
    v0 = jnp.where(bad0[..., None] & ~bad2[..., None], g0, v0)
    V = jnp.stack([v0, v1, v2], axis=-1)
    return w, V


def svd3x3(
    A: jax.Array, sweeps: int = 4
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """SVD of a general 3x3 (batched): A = U diag(s) Vt, s descending.

    Unrolled one-sided Jacobi on the COLUMNS of A: each of the 3 column
    pairs per sweep is rotated to mutual orthogonality (the rotation
    accumulates into V); after the sweeps the column norms are the
    singular values and the normalized columns are U, with an
    orthonormal cross-product completion for a (near-)null column — the
    rank-2 essential-matrix case. Repeated singular values are handled
    naturally (the pair is already orthogonal -> identity rotation).
    Branch-free, fully fused arithmetic; 4 sweeps reach f32 roundoff for
    every 3x3 (Jacobi is quadratically convergent).
    """
    dtype = A.dtype
    G = A
    V = jnp.broadcast_to(jnp.eye(3, dtype=dtype), A.shape)

    def rotate(G, V, i, j):
        gi, gj = G[..., :, i], G[..., :, j]
        a = jnp.sum(gi * gi, axis=-1)
        b = jnp.sum(gj * gj, axis=-1)
        c = jnp.sum(gi * gj, axis=-1)
        # Jacobi rotation zeroing the off-diagonal c of the 2x2 Gram
        # block: tan(2*theta) = 2c / (a - b), smaller-angle root
        # t = sign(tau) / (|tau| + sqrt(1 + tau^2)) with tau =
        # (a - b) / (2c); identity rotation when c ~ 0 (branch-free)
        scale = jnp.maximum(a + b, 1e-30)
        tau = (a - b) / jnp.maximum(2.0 * jnp.abs(c), 1e-30 * scale)
        # sign(tau) must be +1 at tau == 0 (equal column norms, the
        # repeated-singular-value case: theta = 45 deg, t = sign(c))
        sgn_tau = jnp.where(tau >= 0, 1.0, -1.0)
        t = jnp.where(
            jnp.abs(c) > 1e-30 * scale,
            sgn_tau * jnp.sign(c)
            / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau)),
            jnp.zeros_like(c),
        )
        cs = 1.0 / jnp.sqrt(1.0 + t * t)
        sn = cs * t
        cs = cs[..., None]
        sn = sn[..., None]
        gi_new = cs * gi + sn * gj
        gj_new = -sn * gi + cs * gj
        vi, vj = V[..., :, i], V[..., :, j]
        vi_new = cs * vi + sn * vj
        vj_new = -sn * vi + cs * vj
        cols_g = [G[..., :, k] for k in range(3)]
        cols_v = [V[..., :, k] for k in range(3)]
        cols_g[i], cols_g[j] = gi_new, gj_new
        cols_v[i], cols_v[j] = vi_new, vj_new
        return jnp.stack(cols_g, axis=-1), jnp.stack(cols_v, axis=-1)

    for _ in range(sweeps):
        for (i, j) in ((0, 1), (0, 2), (1, 2)):
            G, V = rotate(G, V, i, j)

    s = jnp.sqrt(jnp.maximum(jnp.sum(G * G, axis=-2), 0.0))  # (..., 3)

    # sort columns by s descending (3-element network, branch-free)
    def order2(s, G, V, i, j):
        swap = s[..., i] < s[..., j]
        si = jnp.where(swap, s[..., j], s[..., i])
        sj = jnp.where(swap, s[..., i], s[..., j])
        gi = jnp.where(swap[..., None], G[..., :, j], G[..., :, i])
        gj = jnp.where(swap[..., None], G[..., :, i], G[..., :, j])
        vi = jnp.where(swap[..., None], V[..., :, j], V[..., :, i])
        vj = jnp.where(swap[..., None], V[..., :, i], V[..., :, j])
        svals = [s[..., k] for k in range(3)]
        svals[i], svals[j] = si, sj
        cols_g = [G[..., :, k] for k in range(3)]
        cols_g[i], cols_g[j] = gi, gj
        cols_v = [V[..., :, k] for k in range(3)]
        cols_v[i], cols_v[j] = vi, vj
        return (
            jnp.stack(svals, axis=-1),
            jnp.stack(cols_g, axis=-1),
            jnp.stack(cols_v, axis=-1),
        )

    for (i, j) in ((0, 1), (0, 2), (1, 2)):
        s, G, V = order2(s, G, V, i, j)

    U = G / jnp.maximum(s[..., None, :], 1e-38)
    # orthonormal completion of a (near-)null third column
    u2_c = jnp.cross(U[..., :, 0], U[..., :, 1])
    u2_c = u2_c / jnp.sqrt(
        jnp.maximum(jnp.sum(u2_c * u2_c, axis=-1, keepdims=True), 1e-38)
    )
    null3 = s[..., 2] <= 1e-6 * jnp.maximum(s[..., 0], 1e-30)
    u2 = jnp.where(null3[..., None], u2_c, U[..., :, 2])
    U = jnp.concatenate(
        [U[..., :, :2], u2[..., :, None]], axis=-1
    )
    return U, s, jnp.swapaxes(V, -1, -2)


def chol_solve_unrolled(A: jax.Array, B: jax.Array) -> jax.Array:
    """Solve A X = B for SPD A (static NxN, N small) via unrolled Cholesky.

    A: (N, N); B: (N,) or (N, K). Pure scalar arithmetic — no LU/while
    loops; intended for N <= 12 on sequential chains.
    """
    n = A.shape[0]
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
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
    Y = [None] * n
    for i in range(n):
        s = B[i]
        for k in range(i):
            s = s - L[i][k] * Y[k]
        Y[i] = s / L[i][i]
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * X[k]
        X[i] = s / L[i][i]
    out = jnp.stack(X)
    return out[:, 0] if vec else out


def min_eigvec_spd(
    A: jax.Array, iterations: int = 4, v0: jax.Array | None = None
) -> jax.Array:
    """Smallest eigenvector of a PSD NxN (static N) by inverse iteration.

    Replaces ``jnp.linalg.eigh(A)[1][:, 0]`` on sequential chains (the
    IRLS 8pt nullspace: A = AtA of the epipolar design matrix, whose
    smallest eigenvalue is the fit residual — well separated from the
    rest for real data). A relative ridge keeps the unrolled Cholesky
    finite when A is numerically singular.

    v0: optional warm start (the caller's current solution in the IRLS /
    LO refit loops). The all-ones fallback start can be near-orthogonal
    to the target for structured problems (e.g. vec(E) with entries
    summing to ~0 for near-axis-aligned translations), in which case a
    2-iteration budget relies on roundoff seeding; blending v0 with the
    ones vector guarantees O(1) overlap whenever the caller's previous
    iterate is close, while keeping the generic component as a fallback.
    """
    n = A.shape[0]
    ridge = 1e-6 * jnp.trace(A) / n + 1e-30
    As = A + ridge * jnp.eye(n, dtype=A.dtype)
    # deterministic, generic start
    ones = jnp.ones((n,), A.dtype) / jnp.sqrt(jnp.asarray(n, A.dtype))
    if v0 is None:
        v = ones
    else:
        v0n = v0 / jnp.sqrt(jnp.maximum(jnp.sum(v0 * v0), 1e-38))
        v = v0n + 0.125 * ones
        # a non-finite or zero warm start degrades to the generic start
        v = jnp.where(jnp.all(jnp.isfinite(v)), v, ones)
        v = v / jnp.sqrt(jnp.maximum(jnp.sum(v * v), 1e-38))
    for _ in range(iterations):
        v = chol_solve_unrolled(As, v)
        v = v / jnp.sqrt(jnp.maximum(jnp.sum(v * v), 1e-38))
    return v
