"""Pod-wide kNN: descriptor matching against a db sharded over devices.

Replaces the reference's threaded ANN queries (NMSLIB 8-thread pool,
nmslib_matchers.h:330-345) with the device-sharded design of SURVEY.md §5.7:
each device scores the queries against its database shard as matmuls, then
the per-shard top-2 candidates are merged with one `all_gather` over the
``db`` mesh axis. Exact 2-NN over the full database, communication is
O(S * N1) scalars (candidates only), never the distance matrix.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from matchinglib_poselib_tpu.config import LOWE_RATIO
from matchinglib_poselib_tpu.ops import matching
from matchinglib_poselib_tpu.parallel.mesh import DB_AXIS, PAIRS_AXIS


_BIG = 1e9


def sharded_match(
    mesh,
    desc_q: jax.Array,
    desc_db: jax.Array,
    valid_q: jax.Array,
    valid_db: jax.Array,
    binary: bool = True,
    ratio: float = LOWE_RATIO,
    ratio_test: bool = True,
    cross_check: bool = True,
) -> matching.MatchResult:
    """Exact 2-NN of replicated queries against a db sharded over DB_AXIS.

    desc_q: (N1, W) replicated; desc_db: (N2, W) sharded on axis 0.
    Returns a MatchResult with global db indices.
    """
    N2 = desc_db.shape[0]
    n_shards = mesh.shape[DB_AXIS]
    assert N2 % n_shards == 0, "db size must divide the db axis"
    shard_rows = N2 // n_shards

    def local_fn(q, dbs, vq, vdb):
        # q: (N1, W) replicated; dbs: (shard_rows, W) this shard's rows.
        # The 2-NN of one shard takes the path match_descriptors would.
        d1, d2, idx, col_best = matching.nearest_two(
            q, dbs, vq.astype(bool), vdb.astype(bool), binary=binary,
            cross_check=cross_check,
        )
        my = jax.lax.axis_index(DB_AXIS)
        gidx = idx + my * shard_rows

        # merge candidates across shards
        d1g = jax.lax.all_gather(d1, DB_AXIS)  # (S, N1)
        d2g = jax.lax.all_gather(d2, DB_AXIS)
        ig = jax.lax.all_gather(gidx, DB_AXIS)  # (S, N1)

        cand_d = jnp.concatenate([d1g, d2g], axis=0)  # (2S, N1)
        cand_i = jnp.concatenate([ig, jnp.full_like(ig, -1)], axis=0)
        order = jnp.argsort(cand_d, axis=0)
        best_d = jnp.take_along_axis(cand_d, order[:1], axis=0)[0]
        second_d = jnp.take_along_axis(cand_d, order[1:2], axis=0)[0]
        best_i = jnp.take_along_axis(cand_i, order[:1], axis=0)[0]

        keep = vq.astype(bool) & (best_d < _BIG * 0.5)
        if ratio_test:
            keep = keep & (best_d < ratio * second_d)
        if cross_check:
            colg = jax.lax.all_gather(col_best.astype(jnp.int32), DB_AXIS)
            keep = keep & (colg.reshape(-1)[best_i] == jnp.arange(q.shape[0]))
        return best_i.astype(jnp.int32), best_d, second_d, keep

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(DB_AXIS), P(), P(DB_AXIS)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    idx, d1, d2, keep = fn(desc_q, desc_db, valid_q, valid_db)
    return matching.MatchResult(idx=idx, distance=d1, second_distance=d2, mask=keep)
