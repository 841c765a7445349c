"""Smoke test of the main path on one CUDA GPU (or, with --four, on four).

Drives the detect -> describe -> match -> pose pipeline and the StereoRefine
stream through their public entry points at KITTI raw geometry (1392x512,
2048 keypoints, a 30,000-entry correspondence pool) on seeded synthetic
scenes with ground truth (utils/synth.py), and checks what comes out:

    python chip_smoke.py            # one GPU: compile, pair, batch, stream, kernels
    python chip_smoke.py --four     # four GPUs: sharded paths vs one card only

Phases (one GPU):
  compile  lower + compile the fused single-pair step; memory analysis
  pair     pose vs ground truth; the same step on the host CPU backend;
           ORB descriptor bits GPU vs CPU
  batch    StereoPipeline.run_batch on 8 frames vs the single-pair step:
           bit-equal correspondences and inlier counts, poses within
           0.02 deg. The pose is not bit-equal on the GPU: vmapped
           reductions in the robust stage round differently, and the
           polish brings both within ~5e-3 deg (PERF.md)
  stream   StereoRefine (default config, 30k pool) over 12 frames, run
           twice; prints whether the two runs agree bit for bit
  kernels  the GPU test tier (tests_gpu/) in this process

Every phase runs; any failure makes the exit code non-zero. There is no
CPU fallback: without a GPU the script exits non-zero before any phase.
Times printed here are smoke readings on the named card, not benchmarks.
The last stdout line is the JSON verdict.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
ONE_CARD_PHASES = ("compile", "pair", "batch", "stream", "kernels")
FOUR_CARD_PHASES = ("four",)
ROT_MAX_DEG, TANG_MAX_DEG, MIN_INLIERS = 1.0, 2.0, 300
# Agreement of two runs of one pair, (pose deg, inlier fraction). Batched
# vs single: ~4x the largest gap measured on an H100 over 24 pairs in
# three processes (4.8e-3 deg, equal inliers, bit-equal correspondences),
# a tenth of the error against ground truth. Four cards (two pairs each)
# vs one card (eight): ~3x the largest gap of the one four-card run
# (1.5e-2 deg, 998 vs 996 inliers).
BATCH_TOL = (0.02, 0.0)
FOUR_TOL = (0.05, 0.005)


def same_result(n_inl_a, n_inl_b, rot, tang, tol) -> bool:
    """Two estimates of one pair agree within ``tol`` (see above)."""
    a, b = int(n_inl_a), int(n_inl_b)
    pose_deg, inlier_frac = tol
    return abs(a - b) <= inlier_frac * max(a, b) and max(rot, tang) < pose_deg


@dataclasses.dataclass(frozen=True)
class Sizes:
    scale: float = 1.0  # image scale vs 1392x512
    keypoints: int = 2048
    batch_hypotheses: int = 96
    max_batches: int = 12
    n_batch: int = 8
    n_stream: int = 12
    knn_rows: int = 30720  # queries, and db rows per card (--four)
    ba_points: int = 4096


FULL = Sizes()


def select_phases(argv=None) -> tuple[argparse.Namespace, tuple[str, ...]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU sharded checks")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    return args, FOUR_CARD_PHASES if args.four else ONE_CARD_PHASES


def card_line() -> str:
    """Name and power limit as nvidia-smi reports them (no JAX involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def configs(sizes: Sizes):
    from matchinglib_poselib_tpu.config import (
        DescriptorConfig, DetectorConfig, MatchingConfig, PoseConfig,
        RobustConfig,
    )

    return (
        DetectorConfig(kind="FAST", max_keypoints=sizes.keypoints,
                       fast_threshold=12.0),
        DescriptorConfig(kind="ORB"),
        MatchingConfig(matcher_name="GMBSOF"),
        PoseConfig(robust=RobustConfig(
            batch_hypotheses=sizes.batch_hypotheses,
            max_batches=sizes.max_batches,
        )),
    )


def make_step(sizes: Sizes):
    """Fused single-pair step: correspondences + robust pose."""
    import jax.numpy as jnp

    from matchinglib_poselib_tpu.models import pipeline

    det, desc, match, pose_cfg = configs(sizes)

    def step(img1, img2, K1, K2, key):
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        d = jnp.zeros(5, jnp.float32)
        res = pipeline.estimate_pose(
            corr.pts1, corr.pts2, corr.mask, corr.quality,
            K1, K2, d, d, pose_cfg, key,
        )
        return (res.R, res.t, res.n_inliers, corr.n, corr.pts1, corr.pts2,
                corr.mask)

    return step


def pose_error(R_gt, t_gt, R, t) -> tuple[float, float]:
    import numpy as np

    # atan2 forms: arccos loses ~0.04 deg of resolution near zero in f32
    dR = np.asarray(R_gt, np.float64).T @ np.asarray(R, np.float64)
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                  dR[1, 0] - dR[0, 1]])
    rot = np.degrees(np.arctan2(np.linalg.norm(w) / 2, (np.trace(dR) - 1) / 2))
    a = np.asarray(t_gt, np.float64)
    b = np.asarray(t, np.float64)
    tang = np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)), a @ b))
    return float(rot), float(tang)


def check_pose(label, pair, R, t, n_inl=None):
    rot, tang = pose_error(pair.R, pair.t, R, t)
    msg = f"{label}: rot {rot:.4f} deg, t_ang {tang:.4f} deg"
    if n_inl is not None:
        msg += f", inliers {int(n_inl)}"
    print(msg, flush=True)
    assert rot < ROT_MAX_DEG and tang < TANG_MAX_DEG, msg
    if n_inl is not None:
        assert int(n_inl) >= MIN_INLIERS, msg


class Smoke:
    """State shared by the phases of one run."""

    def __init__(self, seed: int, phases, sizes: Sizes = FULL):
        import jax

        from matchinglib_poselib_tpu.utils import synth

        self.seed, self.sizes = seed, sizes
        self.step = jax.jit(make_step(sizes))
        self.compiled = None
        # render on host threads while the device compiles. Stream and
        # batch frames share one rig (synth.frames); for --four each pair
        # has a rig of its own with the shared intrinsics, so a pair that
        # lands in another pair's slot fails its ground-truth check
        n = sizes.n_batch if "stream" not in phases else max(
            sizes.n_batch, sizes.n_stream)
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        rig = synth.make_rig(seed, sizes.scale)
        self._pair = pool.submit(synth.stereo_pair, seed, sizes.scale)
        self._frames = []
        for i in range(n):
            fseed = synth.frame_seed(seed, i)
            frig = rig if "four" not in phases else synth.make_rig(
                fseed, sizes.scale)._replace(K1=rig.K1, K2=rig.K2)
            self._frames.append(pool.submit(synth.render, frig, fseed))
        pool.shutdown(wait=False)

    @property
    def pair(self):
        return self._pair.result()

    def frames(self, n):
        return [f.result() for f in self._frames[:n]]

    def args(self, pair, key, device=None):
        import jax
        import jax.numpy as jnp

        a = (jnp.asarray(pair.img1), jnp.asarray(pair.img2),
             jnp.asarray(pair.K1, jnp.float32),
             jnp.asarray(pair.K2, jnp.float32), key)
        return a if device is None else jax.device_put(a, device)

    # -- one-card phases ----------------------------------------------------

    def compile(self):
        import jax

        H, W = self.pair.img1.shape
        t0 = time.perf_counter()
        lowered = self.step.lower(*self.args(self.pair, jax.random.PRNGKey(0)))
        self.compiled = lowered.compile()
        dt = time.perf_counter() - t0
        print(f"compile: {H}x{W}, {self.sizes.keypoints} kp, "
              f"{self.sizes.batch_hypotheses}x{self.sizes.max_batches} "
              f"hypotheses: {dt:.1f} s", flush=True)
        print(f"compile: memory_analysis {self.compiled.memory_analysis()}",
              flush=True)

    def pair_phase(self):
        import jax
        import numpy as np

        key = jax.random.PRNGKey(0)
        run = self.compiled or self.step
        t0 = time.perf_counter()
        R, t, n_inl, n_corr, *_ = jax.block_until_ready(
            run(*self.args(self.pair, key)))
        print(f"pair: gpu step {1e3 * (time.perf_counter() - t0):.1f} ms "
              f"(first call), {int(n_corr)} correspondences", flush=True)
        check_pose("pair: gpu vs ground truth", self.pair, R, t, n_inl)

        cpu = jax.devices("cpu")[0]
        t0 = time.perf_counter()
        Rc, tc, n_inl_c, *_ = jax.block_until_ready(
            jax.jit(make_step(self.sizes))(*self.args(self.pair, key, cpu)))
        print(f"pair: cpu step {time.perf_counter() - t0:.1f} s "
              f"(compile included)", flush=True)
        check_pose("pair: cpu vs ground truth", self.pair, Rc, tc, n_inl_c)
        print(f"pair: gpu R {np.asarray(R).round(6).tolist()} "
              f"t {np.asarray(t).round(6).tolist()}")
        print(f"pair: cpu R {np.asarray(Rc).round(6).tolist()} "
              f"t {np.asarray(tc).round(6).tolist()}")
        rot, tang = pose_error(Rc, tc, R, t)
        print(f"pair: gpu vs cpu: rot {rot:.5f} deg, t_ang {tang:.5f} deg, "
              f"inliers {int(n_inl)} vs {int(n_inl_c)}", flush=True)
        assert rot < 0.1, f"gpu and cpu poses differ by {rot} deg"
        self._compare_descriptors(cpu)

    def _compare_descriptors(self, cpu):
        """ORB bits at the keypoints both backends detect."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from matchinglib_poselib_tpu.ops import features

        det, desc, _, _ = configs(self.sizes)

        def describe(img):
            kps = features.detect_keypoints(img, det)
            d, kps = features.compute_descriptors(
                img, kps, desc, bands=features.detector_bands(det))
            return kps.xy, kps.mask, d

        img = jnp.asarray(self.pair.img1)
        out = {}
        for name, dev in (("gpu", None), ("cpu", cpu)):
            x = img if dev is None else jax.device_put(img, dev)
            xy, m, d = jax.jit(describe)(x)
            m = np.asarray(m).astype(bool)
            out[name] = {
                tuple(np.round(p, 3)): w
                for p, w in zip(np.asarray(xy)[m], np.asarray(d)[m])
            }
        shared = out["gpu"].keys() & out["cpu"].keys()
        diff = sum(
            int(np.unpackbits(np.bitwise_xor(out["gpu"][k], out["cpu"][k])
                              .view(np.uint8)).sum())
            for k in shared
        )
        print(f"pair: ORB keypoints gpu {len(out['gpu'])}, cpu "
              f"{len(out['cpu'])}, shared {len(shared)}; descriptor bits "
              f"differing at shared keypoints: {diff}", flush=True)
        assert len(shared) > 0.9 * min(len(out["gpu"]), len(out["cpu"]))

    def batch(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from matchinglib_poselib_tpu.models.pipeline import StereoPipeline

        det, desc, match, pose_cfg = configs(self.sizes)
        frames = self.frames(self.sizes.n_batch)
        K1 = jnp.asarray(frames[0].K1, jnp.float32)
        K2 = jnp.asarray(frames[0].K2, jnp.float32)
        d = jnp.zeros(5, jnp.float32)
        key = jax.random.PRNGKey(1)
        pipe = StereoPipeline(det_cfg=det, desc_cfg=desc, match_cfg=match,
                              pose_cfg=pose_cfg)
        # intrinsics go in as arguments, as in the single-pair step: as
        # closure constants XLA folds them into the arithmetic, which
        # rounds differently
        run = jax.jit(lambda a, b, K1, K2, k: _pose_fields(
            *pipe.run_batch(a, b, K1, K2, d, d, k)))
        imgs1 = jnp.stack([f.img1 for f in frames])
        imgs2 = jnp.stack([f.img2 for f in frames])
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(imgs1, imgs2, K1, K2, key))
        print(f"batch: run_batch of {len(frames)} "
              f"{time.perf_counter() - t0:.1f} s (compile included)",
              flush=True)
        keys = jax.random.split(key, len(frames))
        run1 = self.compiled or self.step
        differ = []
        for i, f in enumerate(frames):
            single = run1(*self.args(f, keys[i]))
            batched = [x[i] for x in out]
            rot, tang = pose_error(single[0], single[1], *batched[:2])
            corr_same = same_correspondences(single[3:], batched[3:])
            print(f"batch: pair {i}: batched vs single rot {rot:.2e} deg, "
                  f"t_ang {tang:.2e} deg, inliers {int(batched[2])} vs "
                  f"{int(single[2])}, correspondences {int(batched[3])} vs "
                  f"{int(single[3])}, bit-equal {corr_same}", flush=True)
            if not (corr_same and same_result(single[2], batched[2], rot,
                                              tang, BATCH_TOL)):
                differ.append(i)
            check_pose(f"batch: pair {i} vs ground truth", f, *batched[:2])
        assert not differ, f"pairs {differ}: run_batch != single-pair step"

    def stream(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from matchinglib_poselib_tpu.config import StereoRefineConfig
        from matchinglib_poselib_tpu.models import pipeline
        from matchinglib_poselib_tpu.models.stereo_refine import StereoRefine

        det, desc, match, _ = configs(self.sizes)
        frames = self.frames(self.sizes.n_stream)
        cfg = StereoRefineConfig()
        corr_fn = jax.jit(
            lambda a, b: pipeline.get_correspondences(a, b, det, desc, match))

        def run(log):
            sr = StereoRefine(frames[0].K1, frames[0].K2, cfg=cfg,
                              seed=self.seed)
            out = []
            for i, f in enumerate(frames):
                t0 = time.perf_counter()
                c = corr_fn(jnp.asarray(f.img1), jnp.asarray(f.img2))
                res = sr.add_new_correspondences(
                    np.asarray(c.pts1), np.asarray(c.pts2),
                    np.asarray(c.mask), np.asarray(c.quality),
                    desc_dist=np.asarray(c.distance),
                )
                out.append(res)
                if log:
                    rot, tang = pose_error(f.R, f.t, res.R, res.t)
                    print(f"stream: frame {i} {res.state:8s} "
                          f"{1e3 * (time.perf_counter() - t0):8.1f} ms  pool "
                          f"{res.pool_size}/{cfg.max_pool_correspondences}  "
                          f"skip {res.skip_count}  inl_ratio "
                          f"{res.inlier_ratio:.3f}  rot {rot:.4f}  "
                          f"t_ang {tang:.4f}", flush=True)
            return out

        first = run(log=True)
        res = first[-1]
        states = [r.state for r in first]
        counts = {s: states.count(s) for s in sorted(set(states))}
        print(f"stream: states {counts}"
              f", reinit {states.count('reinit')}, skipped "
              f"{states.count('skipped')}, pool fill {res.pool_size}/"
              f"{cfg.max_pool_correspondences}", flush=True)
        again = run(log=False)
        same = [a.state == b.state and a.pool_size == b.pool_size
                and np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
                for a, b in zip(first, again)]
        print(f"stream: a second run of the {len(frames)} frames in this "
              f"process agrees bit for bit on {sum(same)} of {len(same)} "
              f"frames (state, pool size, R, t)", flush=True)
        check_pose("stream: refined pose vs ground truth", frames[-1],
                   res.R, res.t)

    def kernels(self):
        import pytest

        class Count:
            passed = failed = skipped = 0

            def pytest_runtest_logreport(self, report):
                if report.failed:
                    self.failed += 1
                elif report.when == "call" and report.passed:
                    self.passed += 1
                elif report.skipped:
                    self.skipped += 1

        c = Count()
        rc = pytest.main([str(REPO / "tests_gpu"), "-q", "-m", "gpu",
                          "-p", "no:cacheprovider"], plugins=[c])
        print(f"kernels: tests_gpu passed {c.passed}, failed {c.failed}, "
              f"skipped {c.skipped}, rc {int(rc)}", flush=True)
        assert rc == 0 and c.failed == 0 and c.skipped == 0 and c.passed > 0

    # -- four-card phase ------------------------------------------------------

    def four(self):
        phase_four(self.seed, self.sizes, self.frames(self.sizes.n_batch))

    def run(self, name):
        return {
            "compile": self.compile, "pair": self.pair_phase,
            "batch": self.batch, "stream": self.stream,
            "kernels": self.kernels, "four": self.four,
        }[name]()


def _pose_fields(corr, pose):
    """The single-pair step's outputs, per pair of a batched result."""
    import jax.numpy as jnp

    n_corr = jnp.sum(corr.mask.astype(jnp.int32), axis=-1)
    return (pose.R, pose.t, pose.n_inliers, n_corr, corr.pts1, corr.pts2,
            corr.mask)


def same_correspondences(a, b) -> bool:
    """(n, pts1, pts2, mask) of two runs: equal counts, masks and points."""
    import numpy as np

    n_a, p1a, p2a, ma = (np.asarray(x) for x in a)
    n_b, p1b, p2b, mb = (np.asarray(x) for x in b)
    m = ma.astype(bool)
    return bool(int(n_a) == int(n_b) and np.array_equal(ma, mb)
                and np.array_equal(p1a[m], p1b[m])
                and np.array_equal(p2a[m], p2b[m]))


def _on_devices(x, n) -> None:
    devs = {s.device for s in x.addressable_shards}
    assert len(devs) == n, f"output on {len(devs)} devices, expected {n}"


def phase_four(seed: int, sizes: Sizes, frames) -> None:
    """Sharded paths on four devices, each against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matchinglib_poselib_tpu.models.pipeline import StereoPipeline
    from matchinglib_poselib_tpu.ops import ba as ba_ops, matching
    from matchinglib_poselib_tpu.parallel import mesh as pmesh
    from matchinglib_poselib_tpu.parallel.ba import bundle_adjust_sharded
    from matchinglib_poselib_tpu.parallel.matching import sharded_match

    devs = jax.devices()[:4]
    assert len(devs) == 4, f"need 4 devices, found {len(devs)}"
    one = devs[0]
    rng = np.random.default_rng(seed)

    # 1. pairs-parallel pipeline: 8 pairs over 4 cards vs one card. Each
    # pair has its own rig, and the pose in slot i must be nearer to rig i
    # than to any other; the correspondence counts must match one card
    # exactly
    det, desc, match, pose_cfg = configs(sizes)
    K = (np.asarray(frames[0].K1, np.float32),
         np.asarray(frames[0].K2, np.float32))
    d = jnp.zeros(5, jnp.float32)
    pipe = StereoPipeline(det_cfg=det, desc_cfg=desc, match_cfg=match,
                          pose_cfg=pose_cfg)
    run = jax.jit(lambda a, b, K1, K2, k: _pose_fields(
        *pipe.run_batch(a, b, K1, K2, d, d, k)))
    imgs = (np.stack([f.img1 for f in frames]),
            np.stack([f.img2 for f in frames]))
    key = jax.random.PRNGKey(1)
    mesh = pmesh.make_mesh(devs, db_parallelism=1)
    psh, rep = pmesh.pairs_sharding(mesh), pmesh.replicated(mesh)
    t0 = time.perf_counter()
    out4 = jax.block_until_ready(
        run(*jax.device_put(imgs, psh), *jax.device_put((*K, key), rep)))
    dt4 = time.perf_counter() - t0
    out1 = run(*jax.device_put((*imgs, *K, key), one))
    for x in out4:
        _on_devices(x, 4)
    for i, f in enumerate(frames):
        R4, t4, n4, c4 = (x[i] for x in out4[:4])
        R1, t1, n1, c1 = (x[i] for x in out1[:4])
        rot, tang = pose_error(R1, t1, R4, t4)
        print(f"four: pairs {i}: 4 cards vs 1 card rot {rot:.2e} deg, t_ang "
              f"{tang:.2e} deg, inliers {int(n4)} vs {int(n1)}, "
              f"correspondences {int(c4)} vs {int(c1)}", flush=True)
        assert int(c4) == int(c1)
        assert same_result(n4, n1, rot, tang, FOUR_TOL)
        check_pose(f"four: pair {i} vs ground truth", f, R4, t4)
        rig_err = [pose_error(g.R, g.t, R4, t4)[0] for g in frames]
        assert int(np.argmin(rig_err)) == i, f"slot {i}: {rig_err}"
    print(f"four: pairs-parallel {len(frames)} pairs {dt4:.1f} s "
          f"(compile included)", flush=True)

    # 2. db-sharded exact 2-NN: N queries vs 4N rows, rows over 4 cards
    n = sizes.knn_rows
    db = rng.integers(0, 2**32, size=(4 * n, 8), dtype=np.uint32)
    plant = rng.choice(4 * n, n, replace=False)
    flips = (rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    q = db[plant] ^ flips  # ~16 of 256 bits flipped
    vq, vdb = np.ones(n, np.float32), np.ones(4 * n, np.float32)
    dmesh = pmesh.make_mesh(devs, db_parallelism=4)
    t0 = time.perf_counter()
    res4 = sharded_match(
        dmesh, jax.device_put(q, pmesh.replicated(dmesh)),
        jax.device_put(db, pmesh.db_sharding(dmesh)),
        jax.device_put(vq, pmesh.replicated(dmesh)),
        jax.device_put(vdb, pmesh.db_sharding(dmesh)),
    )
    jax.block_until_ready(res4)
    dt4 = time.perf_counter() - t0
    res1 = matching.match_descriptors(*jax.device_put((q, db, vq, vdb), one),
                                      ratio_fallback=False)
    for x in res4:
        _on_devices(x, 4)
    m4, m1 = np.asarray(res4.mask), np.asarray(res1.mask)
    print(f"four: db-sharded 2-NN {n} x {4 * n}: matches {m4.sum()} "
          f"(4 cards) vs {m1.sum()} (1 card), {dt4:.1f} s (compile "
          f"included)", flush=True)
    np.testing.assert_array_equal(m4, m1)
    np.testing.assert_array_equal(np.asarray(res4.idx)[m1],
                                  np.asarray(res1.idx)[m1])
    np.testing.assert_array_equal(np.asarray(res4.distance)[m1],
                                  np.asarray(res1.distance)[m1])
    assert m1.sum() > 0.9 * n

    # 3. BA with points sharded over 4 cards vs ops.ba.bundle_adjust
    n_pts, n_cams = sizes.ba_points, 2
    ang = 0.02
    R_gt = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]])
    t_gt = np.array([1.0, 0.05, 0.02]) / np.linalg.norm([1.0, 0.05, 0.02])
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(4, 10, n_pts)], axis=1)
    Rc, tc = np.stack([np.eye(3), R_gt]), np.stack([np.zeros(3), t_gt])
    obs = np.zeros((n_pts, n_cams, 2))
    for c in range(n_cams):
        Xc = X @ Rc[c].T + tc[c]
        obs[:, c] = Xc[:, :2] / Xc[:, 2:3]
    obs += rng.normal(scale=1e-4, size=obs.shape)
    jit = np.deg2rad(0.5)
    Rp = Rc.copy()
    u, _, vt = np.linalg.svd(
        (np.eye(3) + np.array([[0, -jit, 0], [jit, 0, 0], [0, 0, 0]])) @ Rc[1])
    Rp[1] = u @ vt
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ba_args = (f32(obs), np.ones((n_pts, n_cams), np.float32), f32(Rp),
               f32(tc), f32(np.stack([np.eye(3)] * n_cams)),
               np.zeros((n_cams, 5), np.float32), f32(X),
               np.array([0.0, 1.0], np.float32))
    specs = (P(pmesh.DB_AXIS), P(pmesh.DB_AXIS), P(), P(), P(), P(),
             P(pmesh.DB_AXIS), P())
    sharded = [jax.device_put(a, NamedSharding(dmesh, s))
               for a, s in zip(ba_args, specs)]
    res4 = bundle_adjust_sharded(dmesh, *sharded, iterations=8)
    res1 = ba_ops.bundle_adjust(*jax.device_put(ba_args, one), iterations=8)
    for x in (res4.R, res4.t):
        _on_devices(x, 4)
    err = max(float(np.abs(np.asarray(res4.R) - np.asarray(res1.R)).max()),
              float(np.abs(np.asarray(res4.t) - np.asarray(res1.t)).max()))
    rot, _ = pose_error(Rc[1], tc[1], res4.R[1], res4.t[1])
    print(f"four: sharded BA {n_pts} points: 4 cards vs 1 card max |diff| "
          f"{err:.2e}, camera 2 rot {rot:.5f} deg vs planted", flush=True)
    assert err < 5e-5 and rot < 0.05


def main(argv=None) -> int:
    args, phases = select_phases(argv)
    sys.path.insert(0, str(REPO))
    try:
        import jax

        from matchinglib_poselib_tpu.utils.compile_cache import (
            enable_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: cannot import the package: {e}", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default device is {dev.platform})",
              file=sys.stderr)
        return 1
    print(f"chip_smoke: compile cache {enable_compile_cache()}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}")
    try:
        print(f"card: {card_line()}", flush=True)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: nvidia-smi failed: {e}", file=sys.stderr)
        return 1

    smoke = Smoke(args.seed, phases)
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            smoke.run(name)
            print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            failed.append(name)
    stats = dev.memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use', 0) / 2**30:.2f}"
          f" GiB of {stats.get('bytes_limit', 0) / 2**30:.2f} GiB")
    extra = [m for m in ("PIL", "yaml", "cv2") if m in sys.modules]
    if extra:
        print(f"chip_smoke: unexpected imports on the chip path: {extra}")
        failed.append("imports")
    if failed:
        print(f"chip_smoke: failed phases {failed}")
        return 1
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
