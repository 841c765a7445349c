"""Distributed windowed bundle adjustment over point shards.

The reference runs SBA single-threaded on one host (BA_driver.cpp:2245
sba_motstr_levmar). The scale-out design (SURVEY.md §2.4/§5.7) shards
the structure: each device owns a contiguous block of 3D points and their
observations, computes its partial camera-Hessian / Schur / gradient
contributions, and the reduced camera system is `psum`-completed over the
mesh axis (NVLink within a host, the network across hosts). The camera update is
replicated; point updates stay local to the owning shard. Communication per
LM iteration is O((C*D)^2) scalars — independent of the number of points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from matchinglib_poselib_tpu.ops import ba
from matchinglib_poselib_tpu.parallel.mesh import DB_AXIS


def bundle_adjust_sharded(
    mesh,
    obs: jax.Array,  # (P, C, 2) — P divisible by the db-axis size
    vis: jax.Array,  # (P, C)
    R: jax.Array,  # (C, 3, 3) replicated
    t: jax.Array,  # (C, 3)
    K: jax.Array,  # (C, 3, 3)
    dist: jax.Array,  # (C, 5)
    X: jax.Array,  # (P, 3)
    free_cams: jax.Array,  # (C,)
    iterations: int = 20,
    robust: bool = True,
    huber_delta: float = 1.0,
    refine_intrinsics: bool = False,
) -> ba.BAResult:
    """Run `ops.ba.bundle_adjust` with points sharded over the `db` axis.

    Returns a BAResult whose camera blocks are replicated and whose
    `points` array is the full (gathered) structure.
    """
    n_shards = mesh.shape[DB_AXIS]
    assert obs.shape[0] % n_shards == 0, "points must divide the db axis"

    def local(obs_s, vis_s, X_s, R_, t_, K_, dist_, free_):
        res = ba.bundle_adjust(
            obs_s, vis_s, R_, t_, K_, dist_, X_s, free_,
            iterations=iterations,
            robust=robust,
            huber_delta=huber_delta,
            refine_intrinsics=refine_intrinsics,
            axis_name=DB_AXIS,
        )
        # camera blocks are already identical on every shard (psum'd
        # reductions + deterministic solve); points stay sharded.
        return res

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DB_AXIS), P(DB_AXIS), P(DB_AXIS), P(), P(), P(), P(), P()),
        out_specs=ba.BAResult(
            R=P(), t=P(), K=P(), dist=P(), points=P(DB_AXIS),
            initial_cost=P(), final_cost=P(), n_iterations=P(),
        ),
        check_vma=False,
    )
    return fn(obs, vis, X, R, t, K, dist, free_cams)
