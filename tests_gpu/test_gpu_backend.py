"""GPU tier: the compiled Triton 2-NN kernel and f32 solver numerics.

The CPU suite cannot compile the Pallas kernel (it runs it in interpret
mode) nor run the 5pt solvers' polynomial root-finding on the card; these
tests do both and compare against the XLA path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as geo
from matchinglib_poselib_tpu.ops import matching, solvers

pytestmark = pytest.mark.gpu


def _random_packed(rng, n, w=8):
    return jnp.asarray(rng.integers(0, 2**32, (n, w), dtype=np.uint32))


def _rand_pose(rng, max_deg=20.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(rng.uniform(3.0, max_deg))
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    return R, t


def _corrs(rng, R, t, n):
    X = np.stack([
        rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n),
    ], axis=1)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    return x1, X2[:, :2] / X2[:, 2:]


# ---------------------------------------------------------------------------
# compiled Pallas kNN vs the XLA path (bit-exact for binary)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n1,n2",
    [(150, 230), (512, 1024), (2048, 2048), (1000, 33000)],
)
def test_compiled_knn_binary_exact(rng, n1, n2):
    """Compiled packed kernel == XLA dense path, bit for bit.

    n2 = 33000 exceeds a 32768-column pack width and exercises the
    adaptive pack width on the card.
    """
    d1 = _random_packed(rng, n1)
    d2 = _random_packed(rng, n2)
    v1 = jnp.asarray(rng.random(n1) > 0.1)
    v2 = jnp.asarray(rng.random(n2) > 0.1)
    ref = matching.match_descriptors(d1, d2, v1, v2, binary=True,
                                     use_pallas=False)
    out = matching.match_descriptors(d1, d2, v1, v2, binary=True,
                                     use_pallas=True)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m],
                                  np.asarray(ref.idx)[m])
    np.testing.assert_array_equal(np.asarray(out.distance)[m],
                                  np.asarray(ref.distance)[m])


def test_compiled_knn_float(rng):
    """Float L2 runs in IEEE fp32 (Precision.HIGHEST) in the kernel, as in
    the XLA path under the package default; only the summation order
    differs, so distances agree to ~1e-4 and the matches exactly."""
    d1 = jnp.asarray(rng.normal(size=(301, 128)).astype(np.float32))
    d2 = jnp.asarray(rng.normal(size=(443, 128)).astype(np.float32))
    v = jnp.ones(443, bool)
    ref = matching.match_descriptors(d1, d2, jnp.ones(301, bool), v,
                                     binary=False, use_pallas=False)
    out = matching.match_descriptors(d1, d2, jnp.ones(301, bool), v,
                                     binary=False, use_pallas=True)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m],
                                  np.asarray(ref.idx)[m])
    np.testing.assert_allclose(np.asarray(out.distance)[m],
                               np.asarray(ref.distance)[m], rtol=0, atol=1e-2)


def test_compiled_knn_guided_gate(rng):
    """Radius-gated guided matching on the compiled kernel."""
    n1, n2 = 256, 512
    d1 = _random_packed(rng, n1)
    d2 = jnp.concatenate([d1, _random_packed(rng, n2 - n1)])
    p1 = rng.uniform(0, 300, (n1, 2)).astype(np.float32)
    pred = jnp.asarray(p1 + rng.normal(scale=4.0, size=(n1, 2)))
    pts2 = jnp.asarray(
        np.concatenate([p1, rng.uniform(0, 300, (n2 - n1, 2))]).astype(
            np.float32
        )
    )
    rad = jnp.asarray(rng.uniform(10, 50, (n1,)).astype(np.float32))
    kw = dict(binary=True, guide_pred=pred, guide_rad=rad, pts2_xy=pts2)
    v1, v2 = jnp.ones(n1, bool), jnp.ones(n2, bool)
    ref = matching.match_descriptors(d1, d2, v1, v2, use_pallas=False, **kw)
    out = matching.match_descriptors(d1, d2, v1, v2, use_pallas=True, **kw)
    m = np.asarray(ref.mask)
    assert m.sum() > n1 // 2
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m],
                                  np.asarray(ref.idx)[m])


def test_compiled_knn_all_gated(rng):
    """Empty radius gate on the compiled kernel: zero matches (the packed
    invalid-sentinel regression)."""
    n1, n2 = 64, 256
    d1 = _random_packed(rng, n1)
    d2 = jnp.asarray(np.tile(np.asarray(d1), (n2 // n1, 1)))
    pred = jnp.full((n1, 2), 1e6, jnp.float32)
    rad = jnp.ones(n1, jnp.float32)
    pts2 = jnp.zeros((n2, 2), jnp.float32)
    out = matching.match_descriptors(
        d1, d2, jnp.ones(n1, bool), jnp.asarray(np.arange(n2) % 2 == 0),
        binary=True, ratio_test=False, cross_check=False,
        guide_pred=pred, guide_rad=rad, pts2_xy=pts2, use_pallas=True,
    )
    assert int(out.n_matches) == 0


def test_sharded_match_takes_the_kernel(rng):
    """The db-sharded 2-NN picks the kernel per shard by the same rule as
    match_descriptors (here one shard of 8192 rows, above the 4096^2
    threshold) and returns the single-device result bit for bit."""
    from matchinglib_poselib_tpu.parallel import mesh as pmesh
    from matchinglib_poselib_tpu.parallel.matching import sharded_match

    n1, n2 = 4096, 8192
    assert matching.kernel_pays(n1, n2)
    dq, ddb = _random_packed(rng, n1), _random_packed(rng, n2)
    ddb = ddb.at[:n1].set(dq ^ jnp.uint32(3))  # a partner 2 bits away
    vq, vdb = jnp.ones(n1, bool), jnp.asarray(rng.random(n2) > 0.1)
    mesh = pmesh.make_mesh(jax.devices()[:1], db_parallelism=1)
    fn = jax.jit(lambda *a: sharded_match(mesh, *a))
    # the Pallas kernel lowers to a Triton custom call
    assert "triton" in fn.lower(dq, ddb, vq, vdb).as_text()
    out = fn(dq, ddb, vq, vdb)
    ref = matching.match_descriptors(dq, ddb, vq, vdb, use_pallas=False,
                                     ratio_fallback=False)
    m = np.asarray(ref.mask)
    assert m.sum() > n1 // 2
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m],
                                  np.asarray(ref.idx)[m])
    np.testing.assert_array_equal(np.asarray(out.distance)[m],
                                  np.asarray(ref.distance)[m])


# ---------------------------------------------------------------------------
# 5pt solvers in f32 on the GPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["nister", "stewenius"])
def test_5pt_f32_validity_on_gpu(rng, solver):
    """Batched minimal 5pt on the card: the true pose must appear among the
    solutions for >=90% of noise-free minimal samples, with Sampson
    residuals at f32 noise level."""
    B = 256
    solve = (
        solvers.solve_5pt_nister if solver == "nister" else solvers.solve_5pt
    )
    hits = 0
    x1b = np.zeros((B, 5, 2), np.float32)
    x2b = np.zeros((B, 5, 2), np.float32)
    Es = []
    for b in range(B):
        R, t = _rand_pose(rng)
        x1, x2 = _corrs(rng, R, t, 5)
        x1b[b], x2b[b] = x1, x2
        Es.append(geo.essential_from_rt(
            jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32)))
    models, valid = jax.jit(solve)(jnp.asarray(x1b), jnp.asarray(x2b))
    models = np.asarray(models)  # (B, M, 3, 3)
    valid = np.asarray(valid)
    assert valid.any(axis=1).mean() > 0.9, "too many all-invalid solves"
    for b in range(B):
        E_true = np.asarray(Es[b])
        E_true = E_true / np.linalg.norm(E_true)
        best = np.inf
        for m in range(models.shape[1]):
            if not valid[b, m]:
                continue
            E = models[b, m]
            n = np.linalg.norm(E)
            if n < 1e-12 or not np.isfinite(E).all():
                continue
            E = E / n
            best = min(best, min(np.abs(E - E_true).max(),
                                 np.abs(E + E_true).max()))
        if best < 5e-3:
            hits += 1
    assert hits / B > 0.9, f"true-E recovery rate {hits / B:.2f}"


def test_polish_f32_converges_on_gpu(rng):
    """LM Sampson polish on the card: recovers a pose perturbed by 1 degree."""
    from matchinglib_poselib_tpu.ops import refine

    R, t = _rand_pose(rng, max_deg=10.0)
    x1, x2 = _corrs(rng, R, t, 512)
    x1 = x1 + rng.normal(scale=2e-4, size=x1.shape)
    a = np.deg2rad(1.0)
    Rp = R @ np.array([
        [np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1],
    ])
    pol, inl = refine.polish_pose_iterative(
        jnp.asarray(Rp, jnp.float32), jnp.asarray(t, jnp.float32),
        jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
        jnp.ones(512, jnp.float32), jnp.ones(512, jnp.float32),
        jnp.asarray(4e-6, jnp.float32),
    )
    rd, td, _ = geo.compare_poses(
        pol.R, pol.t, jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32)
    )
    assert float(rd) < 0.1, f"rot {float(rd)}"
    assert float(td) < 0.5, f"t {float(td)}"
    assert int(jnp.sum(inl)) > 450
