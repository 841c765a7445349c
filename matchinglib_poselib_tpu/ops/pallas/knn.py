"""Fused tiled 2-NN descriptor search (Pallas kernel, Triton route).

The XLA path (ops/matching.py) writes the full (N1, N2) distance matrix to
device memory and reads it back twice: once for the row top-2 and once
for the column argmin of the cross-check. At database scale (30k x 30k)
that matrix is 3.8 GB. This kernel keeps each (TN, TM) distance tile in
registers: one block owns TN query rows, walks its share of the candidate
columns in a ``fori_loop``, and carries only a running (best, second-best)
state, so the matrix never exists.

Blocks run in parallel and in no order, so nothing is carried between
them. When there are too few row tiles to fill the card, the columns are
split across blocks as well (``col_splits``) and the partial top-2 of the
splits are merged by a small XLA sort after the kernel.

Replaces the inner loops of every reference matcher backend (SURVEY.md
M4-M6, M12-M15; matchers.cpp:115-736). The optional fused radius gate
reproduces GMbSOF guided matching (match_statOptFlow.cpp:4410):
candidates outside the SOF-predicted radius get +BIG before the reduction.

Distance formulations (see ops/matching.py for the identities):
- binary: descriptors pre-mapped to +-1 bf16; ham = 0.5 * (bits - <s1, s2>),
  exact: products are +-1 and the f32 accumulator holds the integer sum.
- float: squared L2 = |a|^2 + |b|^2 - 2<a, b>. The contraction runs in
  IEEE fp32 (``Precision.HIGHEST``; Triton would otherwise use TF32), the
  precision of the XLA path under the package's "highest" default, so the
  two agree up to summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

BIG = 1e9
BIGC = 2.0 ** 27  # invalid/gated sentinel of the packed kernel
# Enough blocks to give every SM of an H100 (132) two blocks; fewer row
# tiles than this split the columns across blocks.
_MIN_BLOCKS = 264
# Tiles and Triton settings, one set for the plain and the radius-gated
# kernel. In a sweep on an H100 the gated kernel with 3 stages asked for
# 237,568 B of shared memory, of 232,448 B available, so 2 stages; the
# plain kernel alone read ~11% faster with 3, near the sweep's noise
# (PERF.md).
_BLOCK_ROWS, _BLOCK_COLS, _NUM_WARPS, _NUM_STAGES = 64, 128, 4, 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


def _gate(dist, start, tm, big, xy_mode, row_aux, col_aux):
    """Radius gate: +big on candidates outside the SOF search circle."""
    if not xy_mode:
        return dist
    cols = pl.ds(start, tm)
    qx, qy = row_aux[0][...], row_aux[1][...]
    cx, cy = col_aux[1][cols], col_aux[2][cols]
    dx = qx[:, None] - cx[None, :]
    dy = qy[:, None] - cy[None, :]
    if xy_mode == 1:
        r2 = row_aux[2][...][:, None]
    else:
        r2 = col_aux[3][cols][None, :]
    return jnp.where(dx * dx + dy * dy <= r2, dist, dist + big)


def _kernel(packed: bool, binary: bool, bits: int, pack: float, xy_mode: int,
            tm: int, tiles_per_split: int, n_row_aux: int, n_col_aux: int):
    """Kernel body for one (row tile, column split) block.

    Packed binary (``packed``): for +-1 signs, bits - <s1, s2> is an even
    integer 2*hamming, so with pack = pack_cols / 2

        combined = (bits - dot) * pack + col_id = hamming * pack_cols + col_id

    is exact in f32 (the caller checks the 24-bit range; pack_cols is the
    smallest power of two above every column id). One running min then
    yields the best distance AND its index, lowest index on ties. The
    per-column constant bits*pack + col_id (BIGC + bits*pack for invalid
    columns, so combined >= BIGC even at dot = bits) comes precomputed, so
    the epilogue is one multiply-add and two mins per distance.

    General (float L2, or binary too wide to pack): distances and indices
    are carried separately, lowest index on ties.
    """

    def kernel(a_ref, b_ref, *refs):
        row_aux = refs[:n_row_aux]
        col_aux = refs[n_row_aux:n_row_aux + n_col_aux]
        out_refs = refs[n_row_aux + n_col_aux:]
        split = pl.program_id(1)
        a = a_ref[...]
        tn = a.shape[0]
        if not binary:
            a32 = a.astype(jnp.float32)
            sq1 = jnp.sum(a32 * a32, axis=1)

        def tile(j):
            start = pl.multiple_of((split * tiles_per_split + j) * tm, tm)
            b = b_ref[pl.ds(start, tm), :]
            dot = pl.dot(
                a, b, trans_b=True,
                precision=(
                    jax.lax.Precision.DEFAULT if binary
                    else jax.lax.Precision.HIGHEST
                ),
            )
            return start, b, dot

        if packed:
            def body(j, carry):
                r1, r2 = carry
                start, _, dot = tile(j)
                comb = col_aux[0][pl.ds(start, tm)][None, :] - dot * pack
                comb = _gate(comb, start, tm, BIGC, xy_mode, row_aux, col_aux)
                t1 = jnp.min(comb, axis=1)
                t2 = jnp.min(
                    jnp.where(comb == t1[:, None], BIGC, comb), axis=1
                )
                return (
                    jnp.minimum(r1, t1),
                    jnp.minimum(jnp.maximum(r1, t1), jnp.minimum(r2, t2)),
                )

            init = jnp.full((tn,), BIGC, jnp.float32)
            m1, m2 = jax.lax.fori_loop(0, tiles_per_split, body, (init, init))
            out_refs[0][...] = m1
            out_refs[1][...] = m2
            return

        def body(j, carry):
            d1, d2, i1, i2 = carry
            start, b, dot = tile(j)
            if binary:
                dist = 0.5 * (jnp.float32(bits) - dot)
            else:
                b32 = b.astype(jnp.float32)
                sq2 = jnp.sum(b32 * b32, axis=1)
                dist = jnp.maximum(
                    sq1[:, None] + sq2[None, :] - 2.0 * dot, 0.0
                )
            dist = dist + col_aux[0][pl.ds(start, tm)][None, :]
            dist = _gate(dist, start, tm, BIG, xy_mode, row_aux, col_aux)
            col = (start + jnp.arange(tm)).astype(jnp.float32)[None, :]
            t1 = jnp.min(dist, axis=1)
            j1 = jnp.min(jnp.where(dist == t1[:, None], col, BIG), axis=1)
            dist2 = jnp.where(col == j1[:, None], BIG, dist)
            t2 = jnp.min(dist2, axis=1)
            j2 = jnp.min(jnp.where(dist2 == t2[:, None], col, BIG), axis=1)
            # merge two sorted pairs (d1 <= d2, t1 <= t2); the running
            # pair holds lower column ids, so it wins ties
            run_first = d1 <= t1
            nd2 = jnp.where(run_first, jnp.minimum(d2, t1),
                            jnp.minimum(t2, d1))
            ni2 = jnp.where(
                run_first,
                jnp.where(d2 <= t1, i2, j1),
                jnp.where(t2 < d1, j2, i1),
            )
            return (
                jnp.minimum(d1, t1), nd2,
                jnp.where(run_first, i1, j1), ni2,
            )

        big = jnp.full((tn,), BIG, jnp.float32)
        res = jax.lax.fori_loop(0, tiles_per_split, body, (big,) * 4)
        for ref, val in zip(out_refs, res):
            ref[...] = val

    return kernel


def plan(n1: int, n2: int, block_rows: int = _BLOCK_ROWS,
         block_cols: int = _BLOCK_COLS) -> tuple[int, int, int, int]:
    """Padded sizes and grid: (n1p, n2p, col_splits, tiles_per_split).

    N1 pads to a multiple of ``block_rows``; N2 to a whole number of
    ``block_cols`` tiles per split. The columns are split until there are
    about ``_MIN_BLOCKS`` blocks (at most one split per tile).
    """
    n1p = _round_up(max(n1, 1), block_rows)
    n_col_tiles = -(-max(n2, 1) // block_cols)
    col_splits = -(-_MIN_BLOCKS // (n1p // block_rows))
    col_splits = max(1, min(col_splits, n_col_tiles))
    tiles_per_split = -(-n_col_tiles // col_splits)
    col_splits = -(-n_col_tiles // tiles_per_split)  # least padding
    n2p = tiles_per_split * col_splits * block_cols
    return n1p, n2p, col_splits, tiles_per_split


@functools.partial(
    jax.jit,
    static_argnames=("binary", "bits", "xy_mode", "interpret"),
)
def knn2(
    desc1: jax.Array,
    desc2: jax.Array,
    valid2: jax.Array,
    pred: jax.Array | None = None,
    rad2: jax.Array | None = None,
    pts2: jax.Array | None = None,
    *,
    binary: bool,
    bits: int = 0,
    xy_mode: int = 0,
    interpret: bool = False,
):
    """Two nearest neighbors of every desc1 row among valid desc2 rows.

    desc1: (N1, D) +-1 signs (binary=True, ``bits`` = D) or float values.
    desc2: (N2, D); valid2: (N2,) bool.
    pred/rad2/pts2 (xy_mode != 0): positions (N1, 2)/(N2, 2) and squared
    search radius; candidates outside the circle are gated out (guided
    matching). xy_mode=1: rad2 is (N1,) per query; xy_mode=2: rad2 is
    (N2,) per candidate (mirrored gate for the cross-check direction).

    ``interpret`` runs the kernel in the Pallas interpreter (tests without
    a GPU).

    Returns (d_best, d_second, idx) each (N1,); idx int32 (-1 when no valid
    candidate was inside the gate; d_best >= BIG/2 then).
    """
    n1, d = desc1.shape
    n2 = desc2.shape[0]
    tn, tm = _BLOCK_ROWS, _BLOCK_COLS
    n1p, n2p, splits, tiles_per_split = plan(n1, n2)
    dp = _next_pow2(max(d, 16))

    cdtype = desc1.dtype
    a = jnp.zeros((n1p, dp), cdtype).at[:n1, :d].set(desc1)
    b = jnp.zeros((n2p, dp), cdtype).at[:n2, :d].set(desc2.astype(cdtype))
    valid = jnp.zeros((n2p,), bool).at[:n2].set(valid2.astype(bool))

    # packed fast path (see _kernel): every packed integer up to
    # bits*pack_cols + n2p - 1 must be <= 2^24 (f32 exact-integer range)
    pack_cols = 1 << max(int(n2p - 1).bit_length(), 10)
    packed = binary and bits * pack_cols + n2p - 1 <= 2 ** 24
    pack = pack_cols / 2.0

    if packed:
        # invalid sentinel BIGC + bits*pack: an invalid column with maximal
        # positive correlation (dot = bits) lands exactly on BIGC and is
        # rejected by the strict < BIGC decode
        cols = jnp.arange(n2p, dtype=jnp.float32)
        c0 = jnp.where(valid, jnp.float32(bits) * pack + cols,
                       BIGC + bits * pack)
    else:
        c0 = jnp.where(valid, 0.0, BIG).astype(jnp.float32)
    col_aux = [c0]
    row_aux = []
    if xy_mode:
        def pad_c(v, fill=0.0):
            return jnp.full((n2p,), fill, jnp.float32).at[:n2].set(
                v.astype(jnp.float32))

        def pad_r(v):
            return jnp.zeros((n1p,), jnp.float32).at[:n1].set(
                v.astype(jnp.float32))

        col_aux += [pad_c(pts2[:, 0]), pad_c(pts2[:, 1])]
        row_aux = [pad_r(pred[:, 0]), pad_r(pred[:, 1])]
        if xy_mode == 1:
            row_aux.append(pad_r(rad2))
        else:
            col_aux.append(pad_c(rad2, fill=-1.0))  # padded cols: empty gate

    n_out = 2 if packed else 4
    out = pl.pallas_call(
        _kernel(packed, binary, bits if binary else 0, pack, xy_mode, tm,
                tiles_per_split, len(row_aux), len(col_aux)),
        out_shape=[jax.ShapeDtypeStruct((splits, n1p), jnp.float32)] * n_out,
        grid=(n1p // tn, splits),
        in_specs=[
            pl.BlockSpec((tn, dp), lambda i, s: (i, 0)),
            pl.BlockSpec((n2p, dp), lambda i, s: (0, 0)),
            *[pl.BlockSpec((tn,), lambda i, s: (i,)) for _ in row_aux],
            *[pl.BlockSpec((n2p,), lambda i, s: (0,)) for _ in col_aux],
        ],
        out_specs=[pl.BlockSpec((None, tn), lambda i, s: (s, i))] * n_out,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        cost_estimate=pl.CostEstimate(
            flops=2 * n1p * n2p * dp,
            bytes_accessed=(n1p + n2p * (n1p // tn)) * dp * a.dtype.itemsize,
            transcendentals=0,
        ),
        interpret=interpret,
        name="knn2",
    )(a, b, *row_aux, *col_aux)

    if packed:
        if splits == 1:
            m1, m2 = out[0][0, :n1], out[1][0, :n1]
        else:
            m = jnp.sort(jnp.concatenate(out, axis=0)[:, :n1], axis=0)
            m1, m2 = m[0], m[1]
        ham1 = jnp.floor(m1 / pack_cols)
        col1 = m1 - ham1 * pack_cols
        ok1 = (m1 < BIGC) & (col1 < n2)
        d_best = jnp.where(ok1, ham1, BIG)
        d_second = jnp.where(m2 < BIGC, jnp.floor(m2 / pack_cols), BIG)
        idx = jnp.where(ok1, col1.astype(jnp.int32), -1)
        return d_best, d_second, idx

    d1, d2, i1, i2 = (o[:, :n1] for o in out)
    if splits == 1:
        d_best, d_second, idx_f = d1[0], d2[0], i1[0]
    else:
        ds, is_ = jax.lax.sort(
            (jnp.concatenate([d1, d2]), jnp.concatenate([i1, i2])),
            dimension=0, num_keys=2,
        )
        d_best, d_second, idx_f = ds[0], ds[1], is_[0]
    idx = jnp.where(idx_f >= BIG * 0.5, -1, idx_f).astype(jnp.int32)
    return d_best, d_second, idx
