"""Frame-window sharding of the stereo stream (SURVEY.md §5.7).

The reference processes its frame stream strictly sequentially on one host
(stereo_pose_refinement.cpp:416 addNewCorrespondences). This module is the
framework's "sequence parallelism": the stream is cut into contiguous
frame windows, each host/device owns one window, per-frame robust pose
estimation runs data-parallel inside the window, and the window posteriors
are merged with one collective into a stream-level most-likely pose — the
distributed analogue of the reference's pose-history ranking
(getNearToMeanPose, stereo_pose_refinement.cpp:2817).

Communication per step: one psum over (4+4+3+1) scalars per window — the
quaternion outer-product matrix, translation sum and weight sum — riding
NVLink within a host, the network across hosts via jax.distributed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from matchinglib_poselib_tpu.ops import geometry as geo
from matchinglib_poselib_tpu.parallel.mesh import PAIRS_AXIS


def frame_window_sharding(mesh) -> NamedSharding:
    """Shard a (F, ...) frame-stream array into contiguous windows.

    JAX shards the leading axis in contiguous equal blocks over the axis
    order of the mesh, so device i owns frames [i*F/n, (i+1)*F/n) — the
    keyframe-window ownership of SURVEY §5.7.
    """
    return NamedSharding(mesh, P(PAIRS_AXIS))


def windowed_pose_consensus(
    mesh,
    R_frames: jax.Array,  # (F, 3, 3) per-frame pose estimates, F-sharded
    t_frames: jax.Array,  # (F, 3)
    weights: jax.Array,  # (F,) e.g. inlier counts; <=0 drops the frame
):
    """Stream-level most-likely pose from per-window estimates.

    Each device reduces its own frame window; one psum merges the windows.
    The rotation average is the weighted quaternion mean via the largest
    eigenvector of the psum'd 4x4 outer-product matrix (Markley's method)
    — the batched, distributed equivalent of the reference's
    center-of-gravity pose ranking (stereo_pose_refinement.cpp:2817).
    Returns (R_ml, t_ml, total_weight), replicated.
    """

    def local(R_w, t_w, w_w):
        q = geo.quat_from_rot(R_w)  # (f, 4)
        # resolve the q/-q double cover inside the window against the
        # first frame's sign
        sign = jnp.where(jnp.sum(q * q[0:1], axis=-1, keepdims=True) < 0,
                         -1.0, 1.0)
        q = q * sign
        wpos = jnp.maximum(w_w, 0.0)
        M = jnp.einsum("f,fi,fj->ij", wpos, q, q)  # (4, 4)
        ts = jnp.einsum("f,fi->i", wpos, t_frames_normalize(t_w))
        wsum = jnp.sum(wpos)
        M = jax.lax.psum(M, PAIRS_AXIS)
        ts = jax.lax.psum(ts, PAIRS_AXIS)
        wsum = jax.lax.psum(wsum, PAIRS_AXIS)
        # largest eigenvector of the symmetric 4x4 -> mean quaternion
        evals, evecs = jnp.linalg.eigh(M)
        q_ml = evecs[:, -1]
        R_ml = geo.rot_from_quat(q_ml)
        t_ml = ts / jnp.maximum(jnp.linalg.norm(ts), 1e-12)
        return R_ml, t_ml, wsum

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(PAIRS_AXIS), P(PAIRS_AXIS), P(PAIRS_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(R_frames, t_frames, weights)


def t_frames_normalize(t: jax.Array) -> jax.Array:
    return t / jnp.maximum(
        jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12
    )
