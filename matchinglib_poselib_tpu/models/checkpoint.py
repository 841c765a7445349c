"""Checkpoint / resume of the StereoRefine streaming state (SURVEY.md §5.4).

The reference persists nothing (its only outputs are match files and result
CSVs); for long-running streaming this module adds save/restore of the
full `StereoRefine` state — the correspondence pool arrays, the pose/ratio
history, the state-machine counters, and the PRNG key — so a stream can be
stopped and resumed bit-exactly.

Format: a single ``.npz`` per checkpoint (atomic rename on save) plus the
scalar state embedded as arrays. The pool rides as its SoA arrays; restore
rebuilds the jnp arrays on the current default device. An orbax dependency
is deliberately avoided: the state is a handful of flat arrays, and a
self-contained npz keeps restore working in minimal environments.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile

import numpy as np

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import pool as poolops

_FORMAT_VERSION = 2


def save_stereo_refine(sr, path: str | os.PathLike) -> None:
    """Serialize a StereoRefine instance's mutable state to ``path``.

    The calibration/config are NOT stored (they are constructor inputs and
    may contain non-array config); the caller recreates the object with the
    same construction arguments, then calls :func:`load_stereo_refine`.
    """
    path = pathlib.Path(path)
    pool_arrays = {
        f"pool_{name}": np.asarray(val)
        for name, val in sr.pool._asdict().items()
    }
    hist_R = np.stack([h[0] for h in sr.pose_history]) if sr.pose_history \
        else np.zeros((0, 3, 3))
    hist_t = np.stack([h[1] for h in sr.pose_history]) if sr.pose_history \
        else np.zeros((0, 3))
    scalars = {
        "format_version": _FORMAT_VERSION,
        "nr_estimation": int(sr.nr_estimation),
        "frame_idx": int(sr.frame_idx),
        "skip_count": int(sr.skip_count),
        "max_skip_pairs_new": int(sr.max_skip_pairs_new),
        "pose_is_stable": bool(sr.pose_is_stable),
        "most_likely_pose_stable": bool(sr.most_likely_pose_stable),
        "nr_since_robust": int(sr._nr_since_robust),
        "check_pool_robust_tmp": int(sr._check_pool_robust_tmp),
        "init_number_inliers": int(sr._init_number_inliers),
        "failed_refinements": int(sr._failed_refinements),
        "max_pool_size_reached": bool(sr.max_pool_size_reached),
        "nr_consec_stable": int(sr.nr_consec_stable),
        "stability_tries": int(sr._stability_tries),
        "most_likely_idxs": [int(i) for i in sr.most_likely_idxs[-100:]],
        "pose_ratings": [float(r) for r in sr.pose_ratings],
        "err_stat_history": [[float(m), float(s)]
                             for m, s in sr.err_stat_history[-100:]],
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                scalars_json=np.frombuffer(
                    json.dumps(scalars).encode(), dtype=np.uint8
                ),
                R=np.asarray(sr.R),
                t=np.asarray(sr.t),
                E=np.asarray(sr.E),
                R_most_likely=np.asarray(sr.R_most_likely),
                t_most_likely=np.asarray(sr.t_most_likely),
                hist_R=hist_R,
                hist_t=hist_t,
                ratio_history=np.asarray(sr.ratio_history, np.float64),
                # key_data handles both legacy raw uint32[2] keys and typed
                # PRNG keys (jax_enable_custom_prng / jax.random.key)
                prng_key=np.asarray(jax.random.key_data(sr._key)),
                **pool_arrays,
            )
        os.replace(tmp, path)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_stereo_refine(sr, path: str | os.PathLike) -> None:
    """Restore state saved by :func:`save_stereo_refine` into ``sr``.

    ``sr`` must be constructed with the same config (pool capacity must
    match; a mismatch raises).
    """
    with np.load(pathlib.Path(path)) as z:
        scalars = json.loads(bytes(z["scalars_json"]).decode())
        if scalars.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {scalars.get('format_version')} != "
                f"{_FORMAT_VERSION}"
            )
        pool_kwargs = {}
        for name in poolops.Pool._fields:
            arr = z[f"pool_{name}"]
            pool_kwargs[name] = jnp.asarray(arr)
        pool = poolops.Pool(**pool_kwargs)
        if pool.capacity != sr.cfg.max_pool_correspondences:
            raise ValueError(
                f"pool capacity {pool.capacity} != configured "
                f"{sr.cfg.max_pool_correspondences}"
            )
        sr.pool = pool
        sr.R = z["R"]
        sr.t = z["t"]
        sr.E = z["E"]
        sr.R_most_likely = z["R_most_likely"]
        sr.t_most_likely = z["t_most_likely"]
        sr.pose_history = [
            (z["hist_R"][i], z["hist_t"][i])
            for i in range(z["hist_R"].shape[0])
        ]
        sr.ratio_history = [float(r) for r in z["ratio_history"]]
        raw = jnp.asarray(z["prng_key"], jnp.uint32)
        if jax.dtypes.issubdtype(sr._key.dtype, jax.dtypes.prng_key):
            sr._key = jax.random.wrap_key_data(raw)
        else:
            sr._key = raw
        sr.nr_estimation = scalars["nr_estimation"]
        sr.frame_idx = scalars["frame_idx"]
        sr.skip_count = scalars["skip_count"]
        sr.max_skip_pairs_new = scalars["max_skip_pairs_new"]
        sr.pose_is_stable = scalars["pose_is_stable"]
        sr.most_likely_pose_stable = scalars["most_likely_pose_stable"]
        sr._nr_since_robust = scalars["nr_since_robust"]
        sr._check_pool_robust_tmp = scalars["check_pool_robust_tmp"]
        sr._init_number_inliers = scalars["init_number_inliers"]
        sr._failed_refinements = scalars["failed_refinements"]
        sr.max_pool_size_reached = scalars["max_pool_size_reached"]
        sr.nr_consec_stable = scalars["nr_consec_stable"]
        sr._stability_tries = scalars["stability_tries"]
        sr.most_likely_idxs = [int(i) for i in scalars["most_likely_idxs"]]
        sr.pose_ratings = [float(r) for r in scalars["pose_ratings"]]
        sr.err_stat_history = [
            (float(m), float(sd)) for m, sd in scalars["err_stat_history"]
        ]
