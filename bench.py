"""Benchmark: pipeline frames/s, batched pairs/s, 2-NN path times.

Headline (the ONE stdout JSON line): frames/s of the fused
detect+match+pose step on a seeded synthetic KITTI-geometry stereo pair
(utils/synth.py: 1392x512, 2048 keypoints, 96x12-hypothesis 5pt robust
pose), divided by the measured reference-workload CPU baseline
(BASELINE_MEASURED.json: 17.87 frames/s single-thread).

Supplementary metrics (stderr, one JSON object):
- batched pairs/s via StereoPipeline.run_batch (vmap over 8 pairs),
- 2-NN through ops.matching.match_descriptors at 2048x2048 (guided and
  unguided) and 30720x30720 binary descriptors, XLA path and Triton kernel,
  with the contraction's share of the device's bf16 peak,
- per-stage timings (detect / describe / correspondences / pose) as
  separate jit programs.

Runs only on a device listed in PEAKS; anything else is an error. Every
result names the device and the card's power limit.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet):
# FLOP/s bf16 tensor core, FLOP/s fp32 outside the tensor cores, bytes/s
# of device memory.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add its data "
            f"sheet row to bench.PEAKS"
        ) from None


def device_info() -> dict:
    dev = jax.devices()[0]
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()), "card": out.stdout.strip().split("\n")[0],
    }


def _measured_baseline_fps() -> float:
    d = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
    return float(d["single_thread"]["frames_per_s"])


def _load_data(seed: int = 0):
    from matchinglib_poselib_tpu.utils import synth

    p = synth.stereo_pair(seed)
    K1 = jnp.asarray(p.K1, jnp.float32)
    K2 = jnp.asarray(p.K2, jnp.float32)
    d = jnp.zeros(5, jnp.float32)
    return jnp.asarray(p.img1), jnp.asarray(p.img2), K1, K2, d, d


def _time(fn, *args, n_iter=20, warmup=2):
    """Mean wall time per call, ending each window in block_until_ready."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iter


def _configs():
    from matchinglib_poselib_tpu.config import (
        DetectorConfig, DescriptorConfig, MatchingConfig, PoseConfig,
        RobustConfig,
    )

    return (
        DetectorConfig(kind="FAST", max_keypoints=2048, fast_threshold=12.0),
        DescriptorConfig(kind="ORB"),
        MatchingConfig(matcher_name="GMBSOF"),
        PoseConfig(robust=RobustConfig(batch_hypotheses=96, max_batches=12)),
    )


def bench_pipeline(i1, i2, K1, K2, d1, d2):
    """Single-pair fps + per-stage timings."""
    from matchinglib_poselib_tpu.models import pipeline
    from matchinglib_poselib_tpu.ops import features

    det, desc, match, pose_cfg = _configs()
    base_key = jax.random.PRNGKey(0)

    # the per-frame PRNG fold stays inside the jit: a key built on the
    # host each frame would add a host-to-device transfer per dispatch
    def step(a, b, frame_idx):
        key = jax.random.fold_in(base_key, frame_idx)
        corr = pipeline.get_correspondences(a, b, det, desc, match)
        res = pipeline.estimate_pose(
            corr.pts1, corr.pts2, corr.mask, corr.quality,
            K1, K2, d1, d2, pose_cfg, key,
        )
        return res.R, res.t, res.n_inliers

    stepj = jax.jit(step, static_argnums=(2,))
    dt = _time(lambda: stepj(i1, i2, 0), n_iter=50)

    detj = jax.jit(lambda a: features.detect_keypoints(a, det))
    dt_det = _time(lambda: (detj(i1), detj(i2)), n_iter=20)
    kp1 = detj(i1)
    kp2 = detj(i2)
    descj = jax.jit(lambda a, k: features.compute_descriptors(a, k, desc))
    dt_desc = _time(lambda: (descj(i1, kp1), descj(i2, kp2)), n_iter=20)
    corrj = jax.jit(
        lambda a, b: pipeline.get_correspondences(a, b, det, desc, match)
    )
    dt_corr = _time(lambda: corrj(i1, i2), n_iter=20)
    corr = corrj(i1, i2)
    posej = jax.jit(
        lambda c, k: pipeline.estimate_pose(
            c.pts1, c.pts2, c.mask, c.quality, K1, K2, d1, d2, pose_cfg, k
        )
    )
    dt_pose = _time(lambda: posej(corr, base_key), n_iter=20)

    # stages are separate jit programs; the fused step overlaps and fuses
    # across stage boundaries, so their sum can exceed total_fused_ms
    stages_ms = {
        "detect_ms": 1e3 * dt_det,
        "describe_ms": 1e3 * dt_desc,
        "correspondences_ms": 1e3 * dt_corr,
        "pose_ms": 1e3 * dt_pose,
        "total_fused_ms": 1e3 * dt,
    }
    return 1.0 / dt, stages_ms


def bench_batched(i1, i2, K1, K2, d1, d2, batch=8):
    """pairs/s of StereoPipeline.run_batch (vmap over the pair axis)."""
    from matchinglib_poselib_tpu.models.pipeline import StereoPipeline

    det, desc, match, pose_cfg = _configs()
    pipe = StereoPipeline(
        det_cfg=det, desc_cfg=desc, match_cfg=match, pose_cfg=pose_cfg
    )
    imgs1 = jnp.broadcast_to(i1, (batch,) + i1.shape)
    imgs2 = jnp.broadcast_to(i2, (batch,) + i2.shape)
    key = jax.random.PRNGKey(1)

    runj = jax.jit(
        lambda a, b, k: pipe.run_batch(a, b, K1, K2, d1, d2, k)[1].R
    )
    dt = _time(lambda: runj(imgs1, imgs2, key), n_iter=10)
    return batch / dt


def knn_case(n1, n2, guided, seed=0):
    """Binary 256-bit descriptors; set 2 holds noisy copies of set 1."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    m = min(n1, n2)
    flips = (rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (m, 8), dtype=np.uint32))
    d2[:m] = d1[:m] ^ flips
    args = [jnp.asarray(d1), jnp.asarray(d2), jnp.ones(n1, bool),
            jnp.ones(n2, bool)]
    kw = {}
    if guided:
        p1 = rng.uniform(0, [1392, 512], (n1, 2)).astype(np.float32)
        p2 = rng.uniform(0, [1392, 512], (n2, 2)).astype(np.float32)
        p2[:m] = p1[:m] + rng.normal(scale=2.0, size=(m, 2))
        kw = dict(guide_pred=jnp.asarray(p1),
                  guide_rad=jnp.full((n1,), 40.0, jnp.float32),
                  pts2_xy=jnp.asarray(p2))
    return args, kw


def bench_knn(n1, n2, guided=False, n_iter=20):
    """match_descriptors end to end: XLA path vs the Triton kernel."""
    from matchinglib_poselib_tpu.ops import matching

    args, kw = knn_case(n1, n2, guided)
    flops = 2.0 * n1 * n2 * 256 * 2  # forward + cross-check contraction
    peak = peaks(jax.devices()[0].device_kind)["bf16_flops"]
    out = {"n1": n1, "n2": n2, "guided": guided}
    results = {}
    for name, use in (("xla", False), ("kernel", True)):
        f = jax.jit(lambda *a, use=use: matching.match_descriptors(
            *a, use_pallas=use, **kw))
        results[name] = f(*args)
        dt = _time(f, *args, n_iter=n_iter)
        out[f"{name}_ms"] = 1e3 * dt
        out[f"{name}_bf16_peak_share"] = flops / dt / peak
    same = bool(
        np.array_equal(np.asarray(results["xla"].mask),
                       np.asarray(results["kernel"].mask))
        and np.array_equal(np.asarray(results["xla"].idx),
                           np.asarray(results["kernel"].idx))
    )
    out["kernel_equals_xla"] = same
    out["auto_picks_kernel"] = matching.kernel_pays(n1, n2, guided=guided)
    return out


def main():
    from matchinglib_poselib_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    info = device_info()
    peaks(info["kind"])  # fail before measuring on an unknown device
    i1, i2, K1, K2, d1, d2 = _load_data()
    baseline_fps = _measured_baseline_fps()

    fps, stages = bench_pipeline(i1, i2, K1, K2, d1, d2)
    pairs_per_s = bench_batched(i1, i2, K1, K2, d1, d2, batch=8)
    knn = [
        bench_knn(2048, 2048, guided=False),
        bench_knn(2048, 2048, guided=True),
        bench_knn(30720, 30720, guided=False, n_iter=5),
    ]

    detail = {
        "device": info,
        "single_pair_fps": fps,
        "batched8_pairs_per_s": pairs_per_s,
        "batched8_speedup_vs_single": pairs_per_s / fps,
        "baseline_fps_measured_cpu": baseline_fps,
        "stages": stages,
        "knn": knn,
    }
    print(json.dumps(detail, indent=2), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "frames/s detect+match+pose (1392x512, 2048kp, 5pt RANSAC)",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / baseline_fps, 2),
                "device": info["kind"],
                "card": info["card"],
            }
        )
    )


if __name__ == "__main__":
    main()
