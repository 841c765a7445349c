"""Batched minimal solvers: 5pt essential, 8pt, homography DLT.

Batched replacements for the reference's solver kernels (SURVEY.md P3/P6):
- 5pt Nister/Stewenius (reference: five-point-nister/five-point.cpp:260-455
  and opengv fivept_{nister,stewenius}) -> one batched polynomial solver
- 8pt (opengv eightpt; also the nonminimal weighted solver used by
  pose_linear_refinement.cpp:85 refineEssentialLinear)
- 4pt homography DLT (usac HomogEstimator; pose_homography.cpp:674
  runHomogrophyKernel)

Design notes
------------
Nonsymmetric eigendecompositions (the classic route to the 5pt solver's ten
roots) do not lower on every JAX backend. We therefore:

1. build the 4-dim nullspace of the 5x9 epipolar constraint via a *symmetric*
   9x9 eigendecomposition (A^T A — `jnp.linalg.eigh`),
2. recover the ten cubic constraint polynomials **by interpolation**: the
   constraints det(E)=0 and 2 E E^T E - tr(E E^T) E = 0 are exact cubics in
   the nullspace coordinates (x, y, z), so evaluating them at 20 fixed
   generic points and applying a precomputed 20x20 inverse Vandermonde
   recovers all coefficients with two batched matmuls (matmul work, no symbolic
   expansion),
3. Gauss-Jordan-eliminate the 10 degree-3 monomials (one batched 10x10
   `solve`) giving the Stewenius action matrix M_z for multiplication by z
   on the quotient-ring basis [x^2, xy, y^2, xz, yz, z^2, x, y, z, 1],
4. find the *real* eigenvalues of M_z as sign changes of
   g(lam) = det((M_z - lam I)/sqrt(1+lam^2)) on a tan-parametrized grid,
   refined by fixed-count bisection (batched 10x10 determinants — no LU
   needed; the 1/sqrt(1+lam^2) scaling keeps g finite for |lam|→inf),
5. extract each eigenvector by regularized inverse iteration (batched 10x10
   solves) and read off x = v[6]/v[9], y = v[7]/v[9].

Everything is fixed-shape: each minimal sample yields exactly 10 candidate
essential matrices plus a validity mask.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# monomial bookkeeping (host-side, precomputed once)
# ---------------------------------------------------------------------------

# Ordering: first the 10 degree-3 monomials (eliminated), then the 10
# monomials of degree <= 2 (the quotient-ring basis).
_MONOMIALS = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]

# Basis-monomial indices (within the last 10) of x, y, z, 1.
_BASIS_X, _BASIS_Y, _BASIS_Z, _BASIS_1 = 6, 7, 8, 9
# Reduction rows of B for z * {x^2, xy, y^2, xz, yz, z^2} = deg-3 monomials
# {x^2 z, x y z, y^2 z, x z^2, y z^2, z^3} at hi-indices:
_Z_TIMES_BASIS_HI = [4, 5, 6, 7, 8, 9]
# Direct basis hits for z * {x, y, z, 1} = {xz, yz, z^2, z} at lo-indices:
_Z_TIMES_BASIS_LO = [3, 4, 5, 8]


def _eval_monomials(pts: np.ndarray) -> np.ndarray:
    """(K, 3) points -> (K, 20) monomial values."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    cols = [x**px * y**py * z**pz for (px, py, pz) in _MONOMIALS]
    return np.stack(cols, axis=1)


def _pick_interpolation_points(seed_trials: int = 400) -> np.ndarray:
    """Choose 20 generic points minimizing the Vandermonde condition number.

    Done once at import in float64 numpy; the resulting inverse is exact up
    to f64 and baked in as a constant, so runtime cost is two matmuls.
    """
    best_pts, best_cond = None, np.inf
    for s in range(seed_trials):
        rng = np.random.default_rng(1234 + s)
        pts = rng.uniform(-1.0, 1.0, size=(20, 3))
        V = _eval_monomials(pts)
        c = np.linalg.cond(V)
        if c < best_cond:
            best_cond, best_pts = c, pts
    return best_pts


_PTS64 = _pick_interpolation_points()
_VINV64 = np.linalg.inv(_eval_monomials(_PTS64))  # (20, 20)

# device constants (float32)
_INTERP_PTS = jnp.asarray(_PTS64, jnp.float32)  # (20, 3)
_VINV_T = jnp.asarray(_VINV64.T, jnp.float32)  # (20, 20): C = F @ VINV^T


# ---------------------------------------------------------------------------
# nullspace helpers (symmetric eigensolves)
# ---------------------------------------------------------------------------


def solve_small(A: jax.Array, B: jax.Array) -> jax.Array:
    """Batched dense solve for tiny systems, unrolled Gaussian elimination.

    A: (..., n, n), B: (..., n, m) with small static n (<= ~20).
    Every elimination step is a fully vectorized rank-1 update with partial pivoting via argmax +
    gather. Singular systems produce inf/nan (callers mask on isfinite).
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, B], axis=-1)  # (..., n, n+m)
    rows = jnp.arange(n)
    for k in range(n):
        col = jnp.abs(M[..., :, k])
        col = jnp.where(rows >= k, col, -1.0)
        p = jnp.argmax(col, axis=-1)  # (...,)
        # swap rows k <-> p via a permuted gather: idx[k]=p, idx[p]=k
        idx = jnp.where(
            rows == k, p[..., None], jnp.where(rows == p[..., None], k, rows)
        )
        M = jnp.take_along_axis(M, idx[..., :, None], axis=-2)
        piv = M[..., k, k]
        piv = jnp.where(jnp.abs(piv) > 1e-30, piv, 1e-30)
        factor = M[..., :, k] / piv[..., None]
        factor = jnp.where(rows > k, factor, 0.0)
        M = M - factor[..., :, None] * M[..., k : k + 1, :]
    # back substitution (unrolled)
    X = jnp.zeros(A.shape[:-2] + (n, B.shape[-1]), A.dtype)
    for k in reversed(range(n)):
        rhs = M[..., k, n:]
        acc = jnp.einsum(
            "...j,...jm->...m", M[..., k, k + 1 : n], X[..., k + 1 :, :]
        )
        piv = M[..., k, k]
        piv = jnp.where(jnp.abs(piv) > 1e-30, piv, 1e-30)
        xk = (rhs - acc) / piv[..., None]
        X = X.at[..., k, :].set(xk)
    return X


def solve_small_lanes(A: jax.Array, B: jax.Array):
    """Batched small linear solve, batch-in-lanes layout.

    A: (..., n, n), B: (..., n, m) -> X with A @ X = B. Same contract as
    solve_small, but the batch axes are transposed to the minor (lane)
    dimension before the Gauss-Jordan elimination, so every elimination
    step is elementwise over the (padded-to-128) batch axis instead of
    over an n- or m-sized minor dim. ~40x less tile padding for the
    n=m=10 Nister elimination at B=1024. Partial pivoting per lane via
    one-hot row selection. Singular systems yield inf/nan (caller checks
    finiteness), matching solve_small.
    """
    n = A.shape[-1]
    m = B.shape[-1]
    batch = A.shape[:-2]
    M = jnp.concatenate([A, B], axis=-1)  # (..., n, n+m)
    M = jnp.moveaxis(M.reshape((-1,) + M.shape[-2:]), 0, -1)  # (n, n+m, Bt)
    iota = jnp.arange(n)
    for k in range(n):
        col = jnp.abs(M[:, k, :])  # (n, Bt)
        col = jnp.where(iota[:, None] >= k, col, -1.0)
        piv = jnp.argmax(col, axis=0)  # (Bt,)
        sel = iota[:, None] == piv[None, :]  # (n, Bt)
        pivrow = jnp.sum(jnp.where(sel[:, None, :], M, 0.0), axis=0)
        rowk = M[k]  # (n+m, Bt)
        is_k = (iota == k)[:, None, None]
        # swap rows k <-> piv (order matters: write piv slot first)
        M = jnp.where(sel[:, None, :], rowk[None], M)
        rk = pivrow / pivrow[k]  # normalized pivot row, (n+m, Bt)
        M = jnp.where(is_k, rk[None], M)
        # eliminate column k from every other row
        f = jnp.where((iota == k)[:, None], 0.0, M[:, k, :])  # (n, Bt)
        M = M - f[:, None, :] * rk[None, :, :]
        M = jnp.where(is_k, rk[None], M)
    X = jnp.moveaxis(M[:, n:, :], -1, 0)  # (Bt, n, m)
    return X.reshape(batch + (n, m))


def det_small(A: jax.Array) -> jax.Array:
    """Batched determinant of tiny (n, n) matrices via unrolled elimination.

    Same form as solve_small: partial pivoting with sign tracking; fully vectorized over the batch.
    """
    n = A.shape[-1]
    M = A
    rows = jnp.arange(n)
    det = jnp.ones(A.shape[:-2], A.dtype)
    for k in range(n):
        col = jnp.abs(M[..., :, k])
        col = jnp.where(rows >= k, col, -1.0)
        p = jnp.argmax(col, axis=-1)
        idx = jnp.where(
            rows == k, p[..., None], jnp.where(rows == p[..., None], k, rows)
        )
        M = jnp.take_along_axis(M, idx[..., :, None], axis=-2)
        det = det * jnp.where(p == k, 1.0, -1.0)
        piv = M[..., k, k]
        det = det * piv
        safe = jnp.where(jnp.abs(piv) > 1e-30, piv, 1e-30)
        factor = jnp.where(rows > k, M[..., :, k] / safe[..., None], 0.0)
        M = M - factor[..., :, None] * M[..., k : k + 1, :]
    return det


def nullspace_from_ata(A: jax.Array, k: int) -> jax.Array:
    """k smallest-eigenvalue eigenvectors of A^T A. A: (..., M, N) -> (..., N, k).

    The unbatched k=1 case — the weighted 8pt refit inside the
    sequential IRLS/LM refinement chains — uses closed-form shifted
    inverse iteration (smalllinalg.min_eigvec_spd) instead of XLA's
    iterative eigh: the design matrix's residual eigenvalue is well
    separated there, and the eigh loop's dispatch latency is paid once
    per refinement iteration. Batched / k>1 callers keep eigh.
    """
    AtA = jnp.swapaxes(A, -1, -2) @ A
    if k == 1 and AtA.ndim == 2:
        from matchinglib_poselib_tpu.ops import smalllinalg

        return smalllinalg.min_eigvec_spd(AtA)[:, None]
    _, vecs = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    return vecs[..., :, :k]


def nullspace_qr(A: jax.Array) -> jax.Array:
    """Orthonormal nullspace basis of a batched wide matrix via Householder QR.

    A: (..., M, N) with M < N and (generically) full row rank M — the shape
    of every minimal DLT system here. null(A) = orthogonal complement of
    col(A^T); Householder QR of A^T gives Q whose trailing N-M columns are
    exactly that complement. Returns (..., N, N-M).

    This replaces `jnp.linalg.svd(A, full_matrices=True)` for nullspace
    extraction: M Householder reflections are M fused einsum steps, where
    a batched SVD of tiny matrices is an iterative solver loop. For an exact-rank-M
    minimal system every nullspace basis is exactly null, so the SVD's
    singular-value ordering carries no information.
    """
    m, n = A.shape[-2], A.shape[-1]
    dtype = A.dtype
    R = jnp.swapaxes(A, -1, -2)  # (..., n, m)
    iota = jnp.arange(n)
    vs = []
    for j in range(m):
        x = jnp.where(iota >= j, R[..., :, j], 0.0)
        alpha = jnp.sqrt(jnp.sum(x * x, axis=-1))
        sign = jnp.where(x[..., j] >= 0, 1.0, -1.0)
        e_j = (iota == j).astype(dtype)
        v = x + (sign * alpha)[..., None] * e_j
        inv = 2.0 / jnp.maximum(
            jnp.sum(v * v, axis=-1, keepdims=True), 1e-30
        )
        vtR = jnp.einsum("...i,...ij->...j", v, R)
        R = R - (inv[..., None] * v[..., :, None]) * vtR[..., None, :]
        vs.append((v, inv))
    # Q = H_0 H_1 ... H_{m-1}; only its trailing n-m columns are needed,
    # so apply the reflections (innermost first) to e_{m..n-1} directly
    C = jnp.broadcast_to(
        jnp.eye(n, dtype=dtype)[:, m:], A.shape[:-2] + (n, n - m)
    )
    for v, inv in reversed(vs):
        vtC = jnp.einsum("...i,...ij->...j", v, C)
        C = C - (inv[..., None] * v[..., :, None]) * vtC[..., None, :]
    return C


def epipolar_rows(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Row of the DLT system x2^T E x1 = 0 for row-major vec(E).

    x1, x2: (..., N, 2) normalized coords -> (..., N, 9).
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    return jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )


# ---------------------------------------------------------------------------
# 5-point solver
# ---------------------------------------------------------------------------


def _constraint_values(Ebasis: jax.Array) -> jax.Array:
    """Evaluate the 10 cubic constraints at the 20 interpolation points.

    Ebasis: (..., 4, 3, 3) with E(x,y,z) = x*E0 + y*E1 + z*E2 + E3.
    Returns (..., 10, 20).

    Structure-of-arrays form: every intermediate is a (..., 20) array of
    one scalar component: the 20-point axis stays minor and the 3x3
    determinant is closed-form, where an (..., 20, 3, 3) einsum would put
    tiny axes minor and jnp.linalg.det would run a batched LU.
    """
    pts = _INTERP_PTS  # (20, 3)
    wx, wy, wz = pts[:, 0], pts[:, 1], pts[:, 2]  # (20,) constants
    # e[i][j]: (..., 20) — E entries at each interpolation point
    e = [
        [
            Ebasis[..., 0, i, j, None] * wx
            + Ebasis[..., 1, i, j, None] * wy
            + Ebasis[..., 2, i, j, None] * wz
            + Ebasis[..., 3, i, j, None]
            for j in range(3)
        ]
        for i in range(3)
    ]
    # EE^T (symmetric): s[i][l] = sum_j e_ij e_lj
    s = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for l in range(i, 3):
            s[i][l] = s[l][i] = (
                e[i][0] * e[l][0] + e[i][1] * e[l][1] + e[i][2] * e[l][2]
            )
    tr = s[0][0] + s[1][1] + s[2][2]
    # M = 2 (EE^T) E - tr(EE^T) E
    M = [
        [
            2.0 * (s[i][0] * e[0][j] + s[i][1] * e[1][j] + s[i][2] * e[2][j])
            - tr * e[i][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    detE = (
        e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
        - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
        + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0])
    )
    rows = [detE] + [M[i][j] for i in range(3) for j in range(3)]
    return jnp.stack(rows, axis=-2)  # (..., 10, 20)


def _action_matrix(C: jax.Array):
    """Gauss-Jordan eliminate deg-3 monomials; build M_z (..., 10, 10).

    C: (..., 10, 20) cubic coefficient matrix in _MONOMIALS order.
    Returns (Mz, ok) where ok flags well-conditioned elimination.
    """
    C_hi = C[..., :, :10]
    C_lo = C[..., :, 10:]
    B = solve_small_lanes(C_hi, C_lo)  # (..., 10, 10)
    ok = jnp.all(jnp.isfinite(B), axis=(-1, -2))
    B = jnp.where(ok[..., None, None], B, jnp.zeros_like(B))

    top = -B[..., _Z_TIMES_BASIS_HI, :]  # (..., 6, 10)
    eye = jnp.eye(10, dtype=C.dtype)
    bottom = jnp.broadcast_to(
        eye[jnp.asarray(_Z_TIMES_BASIS_LO)], C.shape[:-2] + (4, 10)
    )
    Mz = jnp.concatenate([top, bottom], axis=-2)
    return Mz, ok


_N_THETA = 129  # sign-scan resolution
# 16 halvings of the pi/128 scan interval reach ~2e-7 in theta — at f32
# resolution; the Gauss-Newton polish recovers the remaining digits (42
# was double-precision-grade overkill and 2.6x the root-finding cost)
_N_BISECT = 16  # fixed bisection iterations (theta space)
_MAX_ROOTS = 10


def hessenberg(M: jax.Array):
    """Batched Householder reduction to upper Hessenberg form.

    M: (..., n, n) -> (H, Q) with M = Q H Q^T. Unrolled n-2 reflection
    steps, each a rank-1 update — fully vectorized over the batch (the
    enabler for Hyman determinant evaluation below).
    """
    n = M.shape[-1]
    H = M
    Q = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    rows = jnp.arange(n)
    for k in range(n - 2):
        x = H[..., :, k]
        maskv = rows > k  # entries below the subdiagonal pivot row k+1..n-1
        xm = jnp.where(maskv, x, 0.0)
        normx = jnp.linalg.norm(xm, axis=-1)
        x0 = H[..., k + 1, k]
        alpha = -jnp.sign(jnp.where(x0 == 0, 1.0, x0)) * normx
        v = xm - alpha[..., None] * (rows == (k + 1)).astype(M.dtype)
        vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
        v = v / jnp.where(vn > 1e-20, vn, 1.0)
        # H <- P H P with P = I - 2 v v^T (v supported on rows > k)
        Hv = jnp.einsum("...ij,...j->...i", H, v)
        vH = jnp.einsum("...i,...ij->...j", v, H)
        vHv = jnp.einsum("...i,...i->...", v, Hv)
        H = (
            H
            - 2.0 * v[..., :, None] * vH[..., None, :]
            - 2.0 * Hv[..., :, None] * v[..., None, :]
            + 4.0 * vHv[..., None, None] * v[..., :, None] * v[..., None, :]
        )
        Qv = jnp.einsum("...ij,...j->...i", Q, v)
        Q = Q - 2.0 * Qv[..., :, None] * v[..., None, :]
    return H, Q


def _hyman(H: jax.Array, lam: jax.Array):
    """Hyman's method on upper Hessenberg H: sign-equivalent det + null vec.

    H: (..., n, n); lam: (...,) broadcastable to H batch. Returns (r, x):
    det(H - lam I) = r * prod(subdiagonals) * (-1)^(n-1); the product is
    constant in lam, so sign changes of r over lam locate eigenvalues.
    x (..., n) solves rows 2..n of (H - lam I) x = 0 with x_{n-1} = 1 — at
    a converged eigenvalue it IS the eigenvector (in Hessenberg basis).
    Per-step positive renormalization prevents overflow without affecting
    sign-change detection. No pivoting, no gathers: n-1 unrolled
    O(n)-vector steps in place of LU determinant scans.
    """
    n = H.shape[-1]
    xs = [None] * n
    xs[n - 1] = jnp.ones_like(lam)
    for i in range(n - 1, 0, -1):
        # row i: sum_{j >= i} H[i, j] x_j - lam * x_i + H[i, i-1] x_{i-1} = 0
        s = -lam * xs[i]
        for j in range(i, n):
            s = s + H[..., i, j] * xs[j]
        sub = H[..., i, i - 1]
        sub = jnp.where(jnp.abs(sub) > 1e-25, sub, 1e-25)
        xi = -s / sub
        # renormalize all defined entries by a positive factor to keep
        # magnitudes bounded (sign of r unaffected)
        m = jnp.maximum(jnp.abs(xi), 1.0)
        xs[i - 1] = xi / m
        for j in range(i, n):
            xs[j] = xs[j] / m
    r = -lam * xs[0]
    for j in range(n):
        r = r + H[..., 0, j] * xs[j]
    return r, jnp.stack(xs, axis=-1)


def _real_eigenvalues_hess(H: jax.Array):
    """Real eigenvalues of batched upper-Hessenberg matrices.

    Sign scan of Hyman's r(lam) on a tan-parametrized grid + fixed-count
    bisection. Returns (roots, valid) (..., 10). Complex eigenvalues are
    (correctly) skipped; tight double real roots without a sign change are
    missed — harmless under RANSAC (that hypothesis is simply not
    produced).
    """
    dtype = H.dtype
    eps = 1e-3
    theta = jnp.linspace(
        -jnp.pi / 2 + eps, jnp.pi / 2 - eps, _N_THETA, dtype=dtype
    )
    lam = jnp.tan(theta)
    batch = H.shape[:-2]
    g, _ = _hyman(
        H[..., None, :, :], jnp.broadcast_to(lam, batch + (_N_THETA,))
    )
    sign = jnp.sign(g)
    flips = sign[..., :-1] * sign[..., 1:] < 0  # (..., S-1)

    # first up-to-10 flip interval indices (pad with S-1 -> invalid)
    iota = jnp.arange(_N_THETA - 1)
    cand = jnp.where(flips, iota, _N_THETA - 1)
    cand = jnp.sort(cand, axis=-1)[..., :_MAX_ROOTS]  # (..., 10)
    valid = cand < (_N_THETA - 1)
    cand = jnp.minimum(cand, _N_THETA - 2)

    lo = theta[cand]  # (..., 10)
    hi = theta[cand + 1]
    Hr = H[..., None, :, :]
    g_lo, _ = _hyman(Hr, jnp.tan(lo))

    def body(_, carry):
        lo, hi, g_lo = carry
        mid = 0.5 * (lo + hi)
        g_mid, _ = _hyman(Hr, jnp.tan(mid))
        left = g_lo * g_mid <= 0
        hi = jnp.where(left, mid, hi)
        lo_new = jnp.where(left, lo, mid)
        g_lo = jnp.where(left, g_lo, g_mid)
        return lo_new, hi, g_lo

    lo, hi, _ = jax.lax.fori_loop(0, _N_BISECT, body, (lo, hi, g_lo))
    roots = jnp.tan(0.5 * (lo + hi))
    return roots, valid


def _eigenvector_xy_hess(
    H: jax.Array, Q: jax.Array, z: jax.Array, valid: jax.Array
):
    """x, y from the quotient-basis eigenvector of M_z for eigenvalue z.

    Free byproduct of Hyman's recurrence: at a converged eigenvalue, the
    back-substituted x solves rows 2..n of (H - z I) x = 0 exactly, i.e. it
    IS the eigenvector in the Hessenberg basis; rotate back with Q.
    H, Q: (..., 10, 10); z: (..., R). Returns x, y, ok each (..., R).
    """
    _, xh = _hyman(H[..., None, :, :], z)  # (..., R, 10)
    v = jnp.einsum("...ij,...rj->...ri", Q, xh)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
    w = v[..., _BASIS_1]
    ok = valid & (jnp.abs(w) > 1e-6) & jnp.all(jnp.isfinite(v), axis=-1)
    w_safe = jnp.where(jnp.abs(w) > 1e-12, w, 1.0)
    x = v[..., _BASIS_X] / w_safe
    y = v[..., _BASIS_Y] / w_safe
    # consistency: the eigenvector's z entry must agree with the eigenvalue
    z_hat = v[..., _BASIS_Z] / w_safe
    ok = ok & (jnp.abs(z_hat - z) <= 0.05 * (1.0 + jnp.abs(z)))
    return x, y, ok


def _constraints_at(Ebasis: jax.Array, xyz: jax.Array) -> jax.Array:
    """The 10 cubic constraint values at a single point (x, y, z).

    Ebasis: (4, 3, 3); xyz: (3,). Returns (10,). Used for the Gauss-Newton
    polish (differentiated with jacfwd).
    """
    w = jnp.concatenate([xyz, jnp.ones((1,), xyz.dtype)])
    E = jnp.einsum("b,bij->ij", w, Ebasis)
    detE = jnp.linalg.det(E)
    EEt = E @ E.T
    tr = EEt[0, 0] + EEt[1, 1] + EEt[2, 2]
    M = 2.0 * (EEt @ E) - tr * E
    return jnp.concatenate([detE[None], M.reshape(9)])


def _polish_xyz(Ebasis: jax.Array, xyz: jax.Array, iters: int = 3) -> jax.Array:
    """Damped Gauss-Newton on the 10 algebraic constraints.

    Recovers the precision lost to f32 interpolation/elimination/bisection:
    typically 2-3 orders of magnitude on the final Sampson error.
    Ebasis: (..., 4, 3, 3); xyz: (..., R, 3).

    Structure-of-arrays form: every intermediate is one (..., R) array per
    scalar component, Python-unrolled over the 3x3/constraint indices at
    trace time, so the work is elementwise over the flat hypothesis axis
    instead of (..., R, 3, 3, 3) tensors with tiny minor axes. Jacobians stay ANALYTIC (dE/dp_k = Ebasis_k constant):
    a jacfwd/vmap formulation compiles to thousands of tiny unfused HLO ops.
    """
    # basis components broadcast against the R axis: (..., 1) each
    Bc = [
        [[Ebasis[..., k, i, j, None] for j in range(3)] for i in range(3)]
        for k in range(4)
    ]

    def step(_, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]  # (..., R)
        e = [
            [
                Bc[0][i][j] * x + Bc[1][i][j] * y + Bc[2][i][j] * z
                + Bc[3][i][j]
                for j in range(3)
            ]
            for i in range(3)
        ]
        # EE^T (symmetric)
        s = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for l in range(i, 3):
                s[i][l] = s[l][i] = (
                    e[i][0] * e[l][0] + e[i][1] * e[l][1] + e[i][2] * e[l][2]
                )
        tr = s[0][0] + s[1][1] + s[2][2]
        M = [
            [
                2.0
                * (s[i][0] * e[0][j] + s[i][1] * e[1][j] + s[i][2] * e[2][j])
                - tr * e[i][j]
                for j in range(3)
            ]
            for i in range(3)
        ]
        detE = (
            e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
            - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
            + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0])
        )
        # cofactor matrix (d det / dE_ij)
        cof = [[None] * 3 for _ in range(3)]
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            for j in range(3):
                j1, j2 = (j + 1) % 3, (j + 2) % 3
                cof[i][j] = e[i1][j1] * e[i2][j2] - e[i1][j2] * e[i2][j1]

        # Jacobian wrt p = (x, y, z); k indexes the basis matrix.
        ddet = [None] * 3  # d det / dp_k
        dM = [[[None] * 3 for _ in range(3)] for _ in range(3)]  # [k][i][j]
        for k in range(3):
            d = Bc[k]  # dE/dp_k, entries (..., 1)
            ddet[k] = sum(
                cof[i][j] * d[i][j] for i in range(3) for j in range(3)
            )
            # d(EE^T) = dE E^T + E dE^T (symmetric)
            ds = [[None] * 3 for _ in range(3)]
            for i in range(3):
                for l in range(i, 3):
                    ds[i][l] = ds[l][i] = sum(
                        d[i][j] * e[l][j] + e[i][j] * d[l][j]
                        for j in range(3)
                    )
            dtr = ds[0][0] + ds[1][1] + ds[2][2]
            for i in range(3):
                for j in range(3):
                    dM[k][i][j] = (
                        2.0
                        * (
                            ds[i][0] * e[0][j]
                            + ds[i][1] * e[1][j]
                            + ds[i][2] * e[2][j]
                            + s[i][0] * d[0][j]
                            + s[i][1] * d[1][j]
                            + s[i][2] * d[2][j]
                        )
                        - dtr * e[i][j]
                        - tr * d[i][j]
                    )

        # normal equations: JtJ (3x3 symmetric), JtF (3,)
        def dot_rows(ka, kb):
            acc = ddet[ka] * ddet[kb]
            for i in range(3):
                for j in range(3):
                    acc = acc + dM[ka][i][j] * dM[kb][i][j]
            return acc

        def dot_res(k):
            acc = ddet[k] * detE
            for i in range(3):
                for j in range(3):
                    acc = acc + dM[k][i][j] * M[i][j]
            return acc

        a00 = dot_rows(0, 0) + 1e-8
        a11 = dot_rows(1, 1) + 1e-8
        a22 = dot_rows(2, 2) + 1e-8
        a01 = dot_rows(0, 1)
        a02 = dot_rows(0, 2)
        a12 = dot_rows(1, 2)
        b0, b1, b2 = dot_res(0), dot_res(1), dot_res(2)
        # closed-form 3x3 symmetric solve (cofactors / determinant)
        c00 = a11 * a22 - a12 * a12
        c01 = a02 * a12 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        det = a00 * c00 + a01 * c01 + a02 * c02
        inv_det = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
        dx = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
        dy = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
        dz = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
        dp = jnp.stack([dx, dy, dz], axis=-1)
        dp = jnp.where(jnp.isfinite(dp), dp, jnp.zeros_like(dp))
        return p - dp

    return jax.lax.fori_loop(0, iters, step, xyz)


def det3(E: jax.Array) -> jax.Array:
    """Closed-form determinant of batched 3x3 matrices."""
    return (
        E[..., 0, 0] * (E[..., 1, 1] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 1])
        - E[..., 0, 1] * (E[..., 1, 0] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 0])
        + E[..., 0, 2] * (E[..., 1, 0] * E[..., 2, 1] - E[..., 1, 1] * E[..., 2, 0])
    )


def _adjugate_t(E: jax.Array) -> jax.Array:
    """Transposed adjugate (cofactor matrix) of 3x3: d det(E) / dE."""
    a, b, c = E[..., 0, 0], E[..., 0, 1], E[..., 0, 2]
    d, e, f = E[..., 1, 0], E[..., 1, 1], E[..., 1, 2]
    g, h, i = E[..., 2, 0], E[..., 2, 1], E[..., 2, 2]
    row0 = jnp.stack([e * i - f * h, f * g - d * i, d * h - e * g], axis=-1)
    row1 = jnp.stack([c * h - b * i, a * i - c * g, b * g - a * h], axis=-1)
    row2 = jnp.stack([b * f - c * e, c * d - a * f, a * e - b * d], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def solve_5pt(x1: jax.Array, x2: jax.Array):
    """Batched five-point essential-matrix solver.

    x1, x2: (..., 5, 2) normalized camera coordinates (minimal samples).
    Returns (E, valid): E (..., 10, 3, 3) Frobenius-normalized candidates,
    valid (..., 10) boolean mask of real solutions.

    Reference behavior: five-point.cpp run5Point / opengv fivept_stewenius;
    see module docstring for the derivation.
    """
    A = epipolar_rows(x1, x2)  # (..., 5, 9)
    ns = nullspace_qr(A)  # (..., 9, 4) exact nullspace of the rank-5 system
    Ebasis = jnp.swapaxes(ns, -1, -2).reshape(ns.shape[:-2] + (4, 3, 3))
    # E = x*E0 + y*E1 + z*E2 + 1*E3; the basis assignment is arbitrary for
    # an exact nullspace (the (x,y,z) parametrization absorbs any rotation
    # of the basis).

    C = _constraint_values(Ebasis)  # (..., 10, 20) values at interp points
    C = C @ _VINV_T.astype(C.dtype)  # -> polynomial coefficients
    Mz, okA = _action_matrix(C)
    Hm, Qm = hessenberg(Mz)
    roots, rvalid = _real_eigenvalues_hess(Hm)
    x, y, ok = _eigenvector_xy_hess(Hm, Qm, roots, rvalid)

    xyz = jnp.stack([x, y, roots], axis=-1)  # (..., 10, 3)
    xyz = _polish_xyz(Ebasis, xyz)
    # runaway solutions overflow ||E||^2 to inf in f32, making E/||E|| a
    # ZERO matrix that would pass finite-ness checks — bound xyz first
    ok = ok & jnp.all(jnp.abs(xyz) < 1e4, axis=-1) & jnp.all(
        jnp.isfinite(xyz), axis=-1
    )
    xyz = jnp.clip(jnp.nan_to_num(xyz), -1e4, 1e4)
    coeffs = jnp.concatenate(
        [xyz, jnp.ones(xyz.shape[:-1] + (1,), xyz.dtype)], axis=-1
    )  # (..., 10, 4)
    E = jnp.einsum("...rb,...bij->...rij", coeffs, Ebasis)
    nrm = jnp.linalg.norm(E.reshape(E.shape[:-2] + (9,)), axis=-1)
    E = E / jnp.maximum(nrm, 1e-12)[..., None, None]
    valid = ok & okA[..., None] & (nrm > 1e-9) & jnp.isfinite(nrm) & jnp.all(
        jnp.isfinite(E), axis=(-1, -2)
    )
    E = jnp.where(valid[..., None, None], E, jnp.eye(3, dtype=E.dtype))
    return E, valid


# ---------------------------------------------------------------------------
# 8-point / nonminimal weighted essential or fundamental solver
# ---------------------------------------------------------------------------


def solve_8pt(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array | None = None,
    weights: jax.Array | None = None,
    essential: bool = True,
):
    """Batched (weighted) 8-point solver on N >= 8 correspondences.

    x1, x2: (..., N, 2) normalized coords; mask/weights (..., N) optional.
    With ``essential`` the result is projected to the essential manifold
    ((s,s,0) singular values), else only to rank 2 (fundamental matrix).

    Serves both as minimal 8pt (opengv eightpt) and as the weighted
    nonminimal solver of the linear refinement loop
    (pose_linear_refinement.cpp:85 refineEssentialLinear).
    Hartley normalization is applied for conditioning.
    """
    from matchinglib_poselib_tpu.ops.geometry import normalize_points

    if mask is None:
        mask = jnp.ones(x1.shape[:-1], x1.dtype)
    w = mask.astype(x1.dtype)
    if weights is not None:
        w = w * weights
    x1n, T1 = normalize_points(x1, mask)
    x2n, T2 = normalize_points(x2, mask)
    A = epipolar_rows(x1n, x2n) * w[..., None]
    ns = nullspace_from_ata(A, 1)[..., 0]  # (..., 9)
    En = ns.reshape(ns.shape[:-1] + (3, 3))
    # denormalize: x2^T E x1 with x_n = T x  =>  E = T2^T En T1
    E = jnp.swapaxes(T2, -1, -2) @ En @ T1
    U, s, Vt = jnp.linalg.svd(E)
    if essential:
        m = 0.5 * (s[..., 0] + s[..., 1])
        s_new = jnp.stack([m, m, jnp.zeros_like(m)], axis=-1)
    else:
        s_new = jnp.concatenate(
            [s[..., :2], jnp.zeros_like(s[..., 2:3])], axis=-1
        )
    E = (U * s_new[..., None, :]) @ Vt
    nrm = jnp.linalg.norm(E.reshape(E.shape[:-2] + (9,)), axis=-1)
    E = E / jnp.maximum(nrm, 1e-12)[..., None, None]
    valid = jnp.all(jnp.isfinite(E), axis=(-1, -2)) & (
        jnp.sum(mask.astype(jnp.int32), axis=-1) >= 8
    )
    return E, valid


# ---------------------------------------------------------------------------
# 5-point solver, Nister variant
# ---------------------------------------------------------------------------

# Nister monomial ordering (five-point.cpp run5Point): the eliminated
# monomials are every term nonlinear in (x, y); the remaining basis
# L = [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1] is LINEAR in x and y,
# which is what collapses the problem to a univariate degree-10 polynomial.
_MONOMIALS_NISTER = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _eval_monomial_list(pts: np.ndarray, monomials) -> np.ndarray:
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack(
        [x**px * y**py * z**pz for (px, py, pz) in monomials], axis=1
    )


_VINV_T_NISTER = jnp.asarray(
    np.linalg.inv(_eval_monomial_list(_PTS64, _MONOMIALS_NISTER)).T,
    jnp.float32,
)


def _polymul(a: list, b: list) -> list:
    """Coefficient lists (ascending powers) of jnp arrays -> product."""
    out = [None] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def _polysub(a: list, b: list) -> list:
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        ai = a[i] if i < len(a) else None
        bi = b[i] if i < len(b) else None
        if ai is None:
            out.append(-bi)
        elif bi is None:
            out.append(ai)
        else:
            out.append(ai - bi)
    return out


_N_THETA_N = 257  # denser scan: a degree-10 poly can have close real roots


def _real_roots_poly10(a: jax.Array):
    """Real roots of batched degree-10 polynomials (ascending coeffs).

    a: (..., 11). Homogeneous evaluation P(s, c) = sum a_k s^k c^(10-k)
    with (s, c) = (sin th, cos th), z = tan th — finite over the whole
    projective line, so no overflow at |z| -> inf. Sign-change scan +
    fixed bisection, like the Hessenberg path, but each evaluation is a
    single fused 11-term dot product instead of a 10x10 Hyman recurrence.
    Returns (roots, valid): (..., 10) each.
    """
    dtype = a.dtype
    # normalize for conditioning
    scale = jnp.max(jnp.abs(a), axis=-1, keepdims=True)
    a = a / jnp.maximum(scale, 1e-30)

    theta = jnp.linspace(
        -jnp.pi / 2, jnp.pi / 2, _N_THETA_N, dtype=dtype
    )

    def peval(th):
        # th: (..., R) — homogeneous evaluation, structure-of-arrays:
        # powers built iteratively so every intermediate is (..., R)
        s, c = jnp.sin(th), jnp.cos(th)
        sp = [jnp.ones_like(th)]
        cp = [jnp.ones_like(th)]
        for _ in range(10):
            sp.append(sp[-1] * s)
            cp.append(cp[-1] * c)
        r = jnp.zeros_like(th)
        for k in range(11):
            r = r + a[..., k, None] * (sp[k] * cp[10 - k])
        return r

    # dense scan as ONE matmul against a trace-time-constant (11, S)
    # monomial table — matmul work instead of per-batch transcendentals
    th_np = np.linspace(-np.pi / 2, np.pi / 2, _N_THETA_N)
    tbl = np.stack(
        [np.sin(th_np) ** k * np.cos(th_np) ** (10 - k) for k in range(11)]
    )  # (11, S)
    g = a @ jnp.asarray(tbl, dtype)  # (..., S)
    sign = jnp.sign(g)
    flips = sign[..., :-1] * sign[..., 1:] < 0

    # a degree-10 polynomial has at most 10 real roots, but f32 noise can
    # produce extra spurious crossings; rank candidate intervals by bracket
    # strength (endpoint magnitudes — noise flips sit at rounding level)
    # instead of scan position, so genuine roots are never displaced
    strength = jnp.where(
        flips, jnp.abs(g[..., :-1]) + jnp.abs(g[..., 1:]), -1.0
    )
    _, cand = jax.lax.top_k(strength, _MAX_ROOTS)
    valid = jnp.take_along_axis(strength, cand, axis=-1) > 0
    cand = jnp.minimum(cand, _N_THETA_N - 2)

    lo = theta[cand]
    hi = theta[cand + 1]
    g_lo = peval(lo)

    def body(_, carry):
        lo, hi, g_lo = carry
        mid = 0.5 * (lo + hi)
        g_mid = peval(mid)
        left = g_lo * g_mid <= 0
        hi = jnp.where(left, mid, hi)
        lo_new = jnp.where(left, lo, mid)
        g_lo = jnp.where(left, g_lo, g_mid)
        return lo_new, hi, g_lo

    # 14 halvings of the pi/256 scan interval reach ~7e-7 in theta; the
    # 3D Gauss-Newton polish downstream converges well inside that radius,
    # and each halving is a serial step.
    lo, hi, _ = jax.lax.fori_loop(0, 14, body, (lo, hi, g_lo))
    mid = 0.5 * (lo + hi)
    roots = jnp.tan(mid)
    # exclude the projective point at infinity (theta = +-pi/2)
    valid = valid & (jnp.abs(jnp.abs(mid) - jnp.pi / 2) > 1e-5)
    return roots, valid


def solve_5pt_nister(x1: jax.Array, x2: jax.Array):
    """Batched five-point solver, Nister's closed form.

    Same contract as solve_5pt: x1, x2 (..., 5, 2) -> (E (..., 10, 3, 3),
    valid (..., 10)). Reference: five-point-nister/five-point.cpp:260-455
    run5Point (the B(z)-determinant reduction to a degree-10 polynomial).

    Fewer operations than the Stewenius action-matrix path: the
    10x10 Hessenberg eigen-machinery is replaced by polynomial
    convolutions + a fused scan/bisect, and x, y come from a closed-form
    2x2 least squares instead of eigenvector extraction.
    """
    A = epipolar_rows(x1, x2)  # (..., 5, 9)
    ns = nullspace_qr(A)  # (..., 9, 4) exact nullspace of the rank-5 system
    Ebasis = jnp.swapaxes(ns, -1, -2).reshape(ns.shape[:-2] + (4, 3, 3))
    # E = x E0 + y E1 + z E2 + E3 (basis assignment arbitrary, see solve_5pt)

    F = _constraint_values(Ebasis)  # (..., 10, 20) values at interp points
    C = F @ _VINV_T_NISTER.astype(F.dtype)  # Nister monomial coefficients
    C_hi = C[..., :, :10]
    C_lo = C[..., :, 10:]
    Bm = solve_small_lanes(C_hi, C_lo)  # (..., 10, 10): m_i = -Bm[i] . L
    okA = jnp.all(jnp.isfinite(Bm), axis=(-1, -2))
    Bm = jnp.where(okA[..., None, None], Bm, jnp.zeros_like(Bm))

    # pairs (hi, lo) with monomial identity z * m_lo = m_hi:
    # (x^2 z, x^2), (y^2 z, y^2), (xyz, xy) -> rows (4,5), (6,7), (8,9).
    # Equation: Bm[hi] . L - Bm[lo] . (z L) = 0, linear in x, y:
    #   b_x(z) x + b_y(z) y + b_c(z) = 0
    def row_polys(h, l):
        Bh = Bm[..., h, :]
        Bl = Bm[..., l, :]
        # x coefficients over powers [1, z, z^2, z^3]
        bx = [
            Bh[..., 2],
            Bh[..., 1] - Bl[..., 2],
            Bh[..., 0] - Bl[..., 1],
            -Bl[..., 0],
        ]
        by = [
            Bh[..., 5],
            Bh[..., 4] - Bl[..., 5],
            Bh[..., 3] - Bl[..., 4],
            -Bl[..., 3],
        ]
        bc = [
            Bh[..., 9],
            Bh[..., 8] - Bl[..., 9],
            Bh[..., 7] - Bl[..., 8],
            Bh[..., 6] - Bl[..., 7],
            -Bl[..., 6],
        ]
        return bx, by, bc

    rows = [row_polys(4, 5), row_polys(6, 7), row_polys(8, 9)]
    (b11, b12, b13), (b21, b22, b23), (b31, b32, b33) = rows

    # det B(z): degree-10 polynomial (ascending coefficients, 11 terms),
    # cofactor expansion with the signs folded into p2/p3
    p1 = _polysub(_polymul(b22, b33), _polymul(b23, b32))  # deg 7
    p2 = _polysub(_polymul(b23, b31), _polymul(b21, b33))  # deg 7
    p3 = _polysub(_polymul(b21, b32), _polymul(b22, b31))  # deg 6
    det_terms = _polymul(b11, p1)
    for i, t in enumerate(_polymul(b12, p2)):
        det_terms[i] = det_terms[i] + t
    t3 = _polymul(b13, p3)
    for i, t in enumerate(t3):
        det_terms[i] = det_terms[i] + t
    n_poly = jnp.stack(det_terms, axis=-1)  # (..., 11)

    roots, rvalid = _real_roots_poly10(n_poly)  # (..., 10)

    # x, y per root: least-squares solve of B(z) [x, y, 1]^T = 0
    def eval_poly(coeffs: list, z):
        r = jnp.zeros_like(z)
        for k, ck in enumerate(coeffs):
            r = r + ck[..., None] * z**k
        return r

    z = roots
    M11 = eval_poly(b11, z)
    M12 = eval_poly(b12, z)
    M13 = eval_poly(b13, z)
    M21 = eval_poly(b21, z)
    M22 = eval_poly(b22, z)
    M23 = eval_poly(b23, z)
    M31 = eval_poly(b31, z)
    M32 = eval_poly(b32, z)
    M33 = eval_poly(b33, z)
    # normal equations over the 3 rows: [x y] = -(G^-1 h)
    g11 = M11 * M11 + M21 * M21 + M31 * M31
    g12 = M11 * M12 + M21 * M22 + M31 * M32
    g22 = M12 * M12 + M22 * M22 + M32 * M32
    h1 = M11 * M13 + M21 * M23 + M31 * M33
    h2 = M12 * M13 + M22 * M23 + M32 * M33
    det_g = g11 * g22 - g12 * g12
    det_safe = jnp.where(jnp.abs(det_g) > 1e-30, det_g, 1e-30)
    x = -(g22 * h1 - g12 * h2) / det_safe
    y = -(g11 * h2 - g12 * h1) / det_safe
    ok = rvalid & (jnp.abs(det_g) > 1e-25)

    xyz = jnp.stack([x, y, roots], axis=-1)  # (..., 10, 3)
    xyz = _polish_xyz(Ebasis, xyz)
    ok = ok & jnp.all(jnp.abs(xyz) < 1e4, axis=-1) & jnp.all(
        jnp.isfinite(xyz), axis=-1
    )
    xyz = jnp.clip(jnp.nan_to_num(xyz), -1e4, 1e4)
    coeffs = jnp.concatenate(
        [xyz, jnp.ones(xyz.shape[:-1] + (1,), xyz.dtype)], axis=-1
    )
    E = jnp.einsum("...rb,...bij->...rij", coeffs, Ebasis)
    nrm = jnp.linalg.norm(E.reshape(E.shape[:-2] + (9,)), axis=-1)
    E = E / jnp.maximum(nrm, 1e-12)[..., None, None]
    valid = ok & okA[..., None] & (nrm > 1e-9) & jnp.isfinite(nrm) & jnp.all(
        jnp.isfinite(E), axis=(-1, -2)
    )
    E = jnp.where(valid[..., None, None], E, jnp.eye(3, dtype=E.dtype))
    return E, valid


# ---------------------------------------------------------------------------
# 7-point fundamental solver
# ---------------------------------------------------------------------------


def solve_7pt(x1: jax.Array, x2: jax.Array):
    """Batched 7-point fundamental-matrix solver.

    x1, x2: (..., 7, 2) pixel or normalized coords. F spans the 2D
    nullspace of the 7 epipolar rows: F = F1 + lam * F2 with
    det(F1 + lam F2) = 0 — a cubic in lam solved in closed form
    (trigonometric/Cardano, branch-free). Returns ((..., 3, 3, 3) models,
    (..., 3) validity) — up to 3 real solutions per sample.

    Parity: the reference's FundmatrixEstimator minimal solver
    (usac/estimators/FundmatrixEstimator.h, SURVEY.md P4).
    """
    from matchinglib_poselib_tpu.ops.geometry import normalize_points

    msk = jnp.ones(x1.shape[:-1], x1.dtype)
    x1n, T1 = normalize_points(x1, msk)
    x2n, T2 = normalize_points(x2, msk)
    A = epipolar_rows(x1n, x2n)  # (..., 7, 9)
    ns = nullspace_from_ata(A, 2)  # (..., 9, 2)
    F1 = ns[..., 0].reshape(ns.shape[:-2] + (3, 3))
    F2 = ns[..., 1].reshape(ns.shape[:-2] + (3, 3))

    # det(F1 + lam F2) = c3 lam^3 + c2 lam^2 + c1 lam + c0 via 4-point
    # polynomial interpolation at lam in {0, 1, -1, 2} (exact for a cubic,
    # avoids hand-expanding 3x3 determinant cofactors)
    d0 = det_small(F1)
    d1 = det_small(F1 + F2)
    dm1 = det_small(F1 - F2)
    d2 = det_small(F1 + 2.0 * F2)
    c0 = d0
    c2 = 0.5 * (d1 + dm1) - d0
    c3 = (d2 - 2.0 * d1 + d0 - 2.0 * c2) / 6.0
    c1 = d1 - d0 - c2 - c3

    # roots of c3 x^3 + c2 x^2 + c1 x + c0, branch-free:
    # handle the (rare) degenerate c3 ~ 0 by blending with the quadratic
    eps = 1e-12
    c3_safe = jnp.where(jnp.abs(c3) < eps, jnp.where(c3 < 0, -eps, eps), c3)
    a = c2 / c3_safe
    b = c1 / c3_safe
    c = c0 / c3_safe
    # depressed cubic t^3 + p t + q, x = t - a/3
    p = b - a * a / 3.0
    q = 2.0 * a**3 / 27.0 - a * b / 3.0 + c
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # three-real-root branch (trigonometric)
    pm = jnp.minimum(p, -eps)
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    t_tri = jnp.stack(
        [
            m * jnp.cos(theta),
            m * jnp.cos(theta - two_pi_3),
            m * jnp.cos(theta - 2.0 * two_pi_3),
        ],
        axis=-1,
    )
    # one-real-root branch (Cardano)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    t_car = (u + v)[..., None] * jnp.ones_like(t_tri)

    three_real = disc <= 0.0
    t = jnp.where(three_real[..., None], t_tri, t_car)
    lam = t - (a / 3.0)[..., None]  # (..., 3)
    valid = jnp.concatenate(
        [
            jnp.ones_like(three_real[..., None]),
            jnp.broadcast_to(three_real[..., None], three_real.shape + (2,)),
        ],
        axis=-1,
    )

    Fn = F1[..., None, :, :] + lam[..., None, None] * F2[..., None, :, :]
    # denormalize (same transform convention as solve_8pt)
    F = (
        jnp.swapaxes(T2, -1, -2)[..., None, :, :]
        @ Fn
        @ T1[..., None, :, :]
    )
    nrm = jnp.linalg.norm(F.reshape(F.shape[:-2] + (9,)), axis=-1)
    F = F / jnp.maximum(nrm, 1e-12)[..., None, None]
    valid = valid & jnp.all(jnp.isfinite(F), axis=(-1, -2))
    return F, valid


# ---------------------------------------------------------------------------
# homography DLT
# ---------------------------------------------------------------------------


def homography_rows(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Two DLT rows per correspondence for x2 ~ H x1 (row-major vec(H)).

    x1, x2: (..., N, 2) -> (..., 2N, 9).
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = jnp.zeros_like(u1)
    one = jnp.ones_like(u1)
    r1 = jnp.stack(
        [u1, v1, one, z, z, z, -u2 * u1, -u2 * v1, -u2], axis=-1
    )
    r2 = jnp.stack(
        [z, z, z, u1, v1, one, -v2 * u1, -v2 * v1, -v2], axis=-1
    )
    rows = jnp.stack([r1, r2], axis=-2)  # (..., N, 2, 9)
    return rows.reshape(rows.shape[:-3] + (2 * rows.shape[-3], 9))


def solve_homography(
    x1: jax.Array,
    x2: jax.Array,
    mask: jax.Array | None = None,
    weights: jax.Array | None = None,
):
    """Batched (weighted) homography DLT on N >= 4 correspondences.

    Reference: usac HomogEstimator minimal kernel / pose_homography.cpp:674
    runHomogrophyKernel. Hartley-normalized. Returns (H, valid), H scaled so
    H[2,2] = 1 where possible.
    """
    from matchinglib_poselib_tpu.ops.geometry import normalize_points

    if mask is None:
        mask = jnp.ones(x1.shape[:-1], x1.dtype)
    w = mask.astype(x1.dtype)
    if weights is not None:
        w = w * weights
    x1n, T1 = normalize_points(x1, mask)
    x2n, T2 = normalize_points(x2, mask)
    A = homography_rows(x1n, x2n)
    w2 = jnp.repeat(w, 2, axis=-1)
    A = A * w2[..., None]
    if A.shape[-2] == A.shape[-1] - 1:
        # minimal 4-point sample (8x9, exact rank 8): Householder-QR
        # nullspace — XLA's batched eigh on the 9x9 normal matrices is
        # an iterative loop that dominated the degeneracy H-RANSAC batch.
        # PRECONDITION: nullspace_qr assumes full row rank 8; degenerate
        # samples (collinear / coincident points) yield an arbitrary
        # vector rather than the least-squares nullvector. That is
        # acceptable here by design: minimal samples only feed RANSAC
        # scoring, which rejects the resulting garbage models the same
        # way the reference's kernel rejects degenerate DLT solutions.
        ns = nullspace_qr(A)[..., 0]
    else:
        ns = nullspace_from_ata(A, 1)[..., 0]
    Hn = ns.reshape(ns.shape[:-1] + (3, 3))
    # denormalize: x2n ~ Hn x1n, x_n = T x  =>  H = T2^-1 Hn T1
    H = jnp.linalg.solve(T2, Hn @ T1)
    scale = H[..., 2, 2]
    safe = jnp.abs(scale) > 1e-8
    H = jnp.where(
        safe[..., None, None],
        H / jnp.where(safe, scale, 1.0)[..., None, None],
        H,
    )
    valid = jnp.all(jnp.isfinite(H), axis=(-1, -2)) & (
        jnp.sum(mask.astype(jnp.int32), axis=-1) >= 4
    )
    return H, valid


def homography_transfer_error(H: jax.Array, x1: jax.Array, x2: jax.Array):
    """Squared symmetric-free forward transfer error |x2 - H x1|^2 (..., N)."""
    from matchinglib_poselib_tpu.ops.geometry import to_homogeneous

    h1 = to_homogeneous(x1)
    p = h1 @ jnp.swapaxes(H, -1, -2)
    w = p[..., 2]
    w_safe = jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
    proj = p[..., :2] / w_safe[..., None]
    err = jnp.sum((proj - x2) ** 2, axis=-1)
    return jnp.where(jnp.abs(w) > 1e-12, err, jnp.inf)
