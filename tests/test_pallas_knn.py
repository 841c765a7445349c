"""Pallas fused 2-NN kernel vs the XLA reference path.

The kernel (ops/pallas/knn.py) must be bit-identical on indices and
distances (binary) / numerically equal (float) to the dense XLA
formulation in ops/matching.py, including the guided-matching radius gate
and mutual cross-check. Here it runs in the Pallas interpreter; the
compiled Triton kernel is checked on a GPU by tests_gpu/.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from matchinglib_poselib_tpu.ops import matching
from matchinglib_poselib_tpu.ops.pallas import knn


def _random_binary(rng, n, w=8):
    return jnp.asarray(rng.integers(0, 2**32, (n, w), dtype=np.uint32))


@pytest.mark.parametrize("binary", [True, False])
def test_knn2_matches_xla_path(rng, binary):
    n1, n2 = 150, 230
    if binary:
        d1 = _random_binary(rng, n1)
        d2 = _random_binary(rng, n2)
    else:
        d1 = jnp.asarray(rng.normal(size=(n1, 128)).astype(np.float32))
        d2 = jnp.asarray(rng.normal(size=(n2, 128)).astype(np.float32))
    v1 = jnp.asarray(rng.random(n1) > 0.1)
    v2 = jnp.asarray(rng.random(n2) > 0.1)

    ref = matching.match_descriptors(
        d1, d2, v1, v2, binary=binary, use_pallas=False
    )
    out = matching.match_descriptors(
        d1, d2, v1, v2, binary=binary, use_pallas=True, interpret=True
    )
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m], np.asarray(ref.idx)[m])
    np.testing.assert_allclose(
        np.asarray(out.distance)[m], np.asarray(ref.distance)[m],
        rtol=0, atol=1e-2 if not binary else 0,
    )


def test_knn2_guided_gate_matches_xla(rng):
    """Radius-gated (GMbSOF guided) matching: kernel gate == dense penalty."""
    n1, n2 = 120, 180
    d1 = _random_binary(rng, n1)
    # set 2 = noisy copies of set 1 (few bit flips) + distractors, so real
    # matches survive the ratio test
    d1_np = np.asarray(d1)
    flips = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32) & rng.integers(
        0, 2**32, (n1, 8), dtype=np.uint32
    ) & rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = jnp.asarray(
        np.concatenate([d1_np ^ flips, np.asarray(_random_binary(rng, n2 - n1))])
    )
    v1 = jnp.ones(n1, bool)
    v2 = jnp.asarray(rng.random(n2) > 0.05)
    p1 = rng.uniform(0, 200, (n1, 2)).astype(np.float32)
    pred = jnp.asarray(p1 + rng.normal(scale=5.0, size=(n1, 2)))
    pts2 = jnp.asarray(
        np.concatenate([p1, rng.uniform(0, 200, (n2 - n1, 2))]).astype(
            np.float32
        )
    )
    rad = jnp.asarray(rng.uniform(15, 60, (n1,)).astype(np.float32))

    kwargs = dict(
        binary=True, guide_pred=pred, guide_rad=rad, pts2_xy=pts2
    )
    ref = matching.match_descriptors(d1, d2, v1, v2, use_pallas=False, **kwargs)
    out = matching.match_descriptors(
        d1, d2, v1, v2, use_pallas=True, interpret=True, **kwargs
    )
    m = np.asarray(ref.mask)
    assert m.sum() > 0
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m], np.asarray(ref.idx)[m])


def test_knn2_all_invalid_columns(rng):
    """Degenerate input: no valid candidates -> no matches, finite outputs."""
    d1 = _random_binary(rng, 64)
    d2 = _random_binary(rng, 64)
    out = matching.match_descriptors(
        d1, d2, jnp.ones(64, bool), jnp.zeros(64, bool),
        binary=True, use_pallas=True, interpret=True,
    )
    assert int(out.n_matches) == 0


def test_knn2_large_unaligned_shapes(rng):
    """Shapes off the 128 tile grid exercise the padding path."""
    d1 = jnp.asarray(rng.normal(size=(301, 67)).astype(np.float32))
    d2 = jnp.asarray(rng.normal(size=(443, 67)).astype(np.float32))
    v1 = jnp.ones(301, bool)
    v2 = jnp.ones(443, bool)
    ref = matching.match_descriptors(
        d1, d2, v1, v2, binary=False, use_pallas=False
    )
    out = matching.match_descriptors(
        d1, d2, v1, v2, binary=False, use_pallas=True, interpret=True
    )
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(out.mask), m)
    np.testing.assert_array_equal(np.asarray(out.idx)[m], np.asarray(ref.idx)[m])


def test_knn2_all_candidates_gated(rng):
    """Every valid candidate outside the radius gate -> no matches.

    Regression test for the packed-kernel invalid sentinel: invalid
    columns whose ±1 descriptors correlate positively with a query used
    to decode below BIGC and win once every valid candidate was
    radius-gated, leaking a bogus match (and a potentially out-of-range
    index) where the XLA path returns none.
    """
    n1, n2 = 16, 300
    d1_packed = _random_binary(rng, n1)
    # candidates: exact copies of the queries (maximal positive dot),
    # half of them marked invalid
    d2_packed = jnp.asarray(
        np.tile(np.asarray(d1_packed), (n2 // n1 + 1, 1))[:n2]
    )
    valid2 = jnp.asarray(np.arange(n2) % 2 == 0)
    # gate: predictions far away from every candidate, tiny radius
    pred = jnp.full((n1, 2), 1e6, jnp.float32)
    rad2 = jnp.full((n1,), 1.0, jnp.float32)
    pts2 = jnp.zeros((n2, 2), jnp.float32)

    signs1 = matching.bits_to_signs(d1_packed)
    signs2 = matching.bits_to_signs(d2_packed)
    bits = signs1.shape[-1]
    db, ds, idx = knn.knn2(
        signs1, signs2, valid2, pred, rad2, pts2,
        binary=True, bits=bits, xy_mode=1, interpret=True,
    )
    assert np.all(np.asarray(idx) == -1)
    assert np.all(np.asarray(db) >= knn.BIG * 0.5)

    # and with ratio_test off through the public API: still zero matches,
    # identical to the XLA path
    kwargs = dict(
        binary=True, ratio_test=False, cross_check=False,
        guide_pred=pred, guide_rad=rad2, pts2_xy=pts2,
    )
    ref = matching.match_descriptors(
        d1_packed, d2_packed, jnp.ones(n1, bool), valid2,
        use_pallas=False, **kwargs,
    )
    out = matching.match_descriptors(
        d1_packed, d2_packed, jnp.ones(n1, bool), valid2,
        use_pallas=True, interpret=True, **kwargs,
    )
    assert int(ref.n_matches) == 0
    assert int(out.n_matches) == 0


def test_knn2_packed_512bit_exactness(rng):
    """512-bit descriptors stay exact: pack_cols adapts to the column
    count so hamming=512 values remain inside f32's integer range."""
    bits = 512
    n1, n2 = 4, 3000
    s1 = rng.integers(0, 2, size=(n1, bits)) * 2.0 - 1.0
    signs1 = jnp.asarray(s1, jnp.bfloat16)
    s2 = rng.integers(0, 2, size=(n2, bits)) * 2.0 - 1.0
    # plant: exact inverse of query 0 at the last column (hamming = 512)
    s2[n2 - 1] = -s1[0]
    signs2 = jnp.asarray(s2, jnp.bfloat16)
    valid = jnp.ones(n2, jnp.float32)

    d1, d2, idx = knn.knn2(
        signs1, signs2, valid, binary=True, bits=bits, interpret=True
    )
    # brute-force reference
    ham = (bits - s1 @ s2.T) / 2
    best = ham.min(axis=1)
    np.testing.assert_array_equal(np.asarray(d1), best)
    np.testing.assert_array_equal(np.asarray(idx), ham.argmin(axis=1))


def test_knn2_packed_boundary_exactness(rng):
    """Packed path: planted best/second-best at the last columns are exact.

    The packed binary kernel encodes hamming * 32768 + col in one f32
    (exact through col 32767); candidates planted at the two last columns
    with distances 0 and 1 must come back with exact ids and distances.
    """
    bits = 256
    n1, n2 = 8, 4000
    signs1 = jnp.asarray(
        rng.integers(0, 2, size=(n1, bits)) * 2.0 - 1.0, jnp.bfloat16
    )
    signs2 = jnp.asarray(
        rng.integers(0, 2, size=(n2, bits)) * 2.0 - 1.0, jnp.bfloat16
    )
    signs2 = signs2.at[n2 - 1].set(signs1[0])
    flipped = signs1[0].at[17].set(-signs1[0][17])
    signs2 = signs2.at[n2 - 2].set(flipped)
    valid = jnp.ones(n2, jnp.float32)

    d1, d2, idx = knn.knn2(
        signs1, signs2, valid, binary=True, bits=bits, interpret=True
    )
    assert int(idx[0]) == n2 - 1
    assert float(d1[0]) == 0.0
    assert float(d2[0]) == 1.0


@pytest.mark.parametrize(
    "n1,n2,binary",
    [(1, 17, True), (65, 1000, True), (300, 129, False), (97, 257, False)],
)
def test_knn2_pads_unaligned_shapes(rng, n1, n2, binary):
    """N1/N2 off the power-of-two tile grid: padded rows/columns never win."""
    if binary:
        s1 = rng.integers(0, 2, (n1, 256)) * 2.0 - 1.0
        s2 = rng.integers(0, 2, (n2, 256)) * 2.0 - 1.0
        dist = (256 - s1 @ s2.T) / 2
        a, b = jnp.asarray(s1, jnp.bfloat16), jnp.asarray(s2, jnp.bfloat16)
    else:
        s1 = rng.normal(size=(n1, 40)).astype(np.float32)
        s2 = rng.normal(size=(n2, 40)).astype(np.float32)
        dist = ((s1[:, None, :] - s2[None]) ** 2).sum(-1)
        a, b = jnp.asarray(s1), jnp.asarray(s2)
    d1, d2, idx = knn.knn2(a, b, jnp.ones(n2, bool), binary=binary,
                           bits=256 if binary else 0, interpret=True)
    srt = np.sort(dist, axis=1)
    np.testing.assert_array_equal(np.asarray(idx), dist.argmin(axis=1))
    np.testing.assert_allclose(np.asarray(d1), srt[:, 0], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(d2), srt[:, 1], rtol=1e-5)


@pytest.mark.parametrize(
    "n1,n2,tn,tm",
    [(1, 1, 64, 64), (150, 230, 64, 64), (2048, 2048, 64, 64),
     (2048, 2048, 128, 128), (30720, 30720, 64, 64), (1000, 33000, 64, 128)],
)
def test_plan_tiles_cover_the_input(n1, n2, tn, tm):
    n1p, n2p, splits, tps = knn.plan(n1, n2, tn, tm)
    assert n1p % tn == 0 and n1p - n1 < tn
    assert n2p == splits * tps * tm and n2p >= n2
    # splits are cut so that no split is all padding
    assert n2p - n2 < tps * tm
    # about enough blocks to fill the card, unless each split is one tile
    # already or the row tiles alone fill it
    rows = n1p // tn
    assert (rows * splits >= knn._MIN_BLOCKS // 2 or tps == 1
            or (splits == 1 and rows >= knn._MIN_BLOCKS))


def test_auto_path_is_chosen_by_shape_and_platform(rng, monkeypatch):
    """use_pallas=None takes the kernel only where kernel_pays says so, and
    only when the program is lowered for CUDA: on this CPU the lowered
    program never contains it."""
    # shipped choice: XLA at the pipeline's 2048^2, the kernel from 4096^2,
    # for binary unguided matching only (the cases that were timed)
    assert not matching.kernel_pays(2048, 2048)
    assert matching.kernel_pays(4096, 4096)
    assert matching.kernel_pays(30720, 30720)
    assert not matching.kernel_pays(30720, 30720, binary=False)
    assert not matching.kernel_pays(30720, 30720, guided=True)
    d1 = _random_binary(rng, 100)
    d2 = _random_binary(rng, 120)
    v1, v2 = jnp.ones(100, bool), jnp.ones(120, bool)
    monkeypatch.setattr(matching, "_KERNEL_MIN_CELLS", 1)
    assert matching.kernel_pays(100, 120)
    hlo = jax.jit(
        lambda a, b: matching.match_descriptors(a, b, v1, v2).idx
    ).lower(d1, d2).as_text()
    assert "knn2" not in hlo
    ref = matching.match_descriptors(d1, d2, v1, v2, use_pallas=False)
    out = matching.match_descriptors(d1, d2, v1, v2)
    np.testing.assert_array_equal(np.asarray(out.idx), np.asarray(ref.idx))
    monkeypatch.setattr(matching, "_KERNEL_MIN_CELLS", 10**9)
    assert not matching.kernel_pays(100, 120)
