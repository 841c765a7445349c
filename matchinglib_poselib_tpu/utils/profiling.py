"""Stage-timing and tracing (SURVEY.md §5.1).

The reference instruments every pipeline stage with cv::getTickCount deltas
gated by an integer verbosity (correspondences.cpp:221-240,361-376,399-410,
496-507; stereo_pose_refinement.cpp:434-462; the noMatch CSV records the
stage taxonomy of timeMeasurements, noMatch_poselib-test/main.cpp:61-73).

This module reproduces that observability on the device:

- ``StageTimer``: wall-clock per-stage timing with `block_until_ready` on
  the stage's outputs so device work is attributed to the stage that
  launched it (async dispatch would otherwise charge everything to the
  first stage that synchronizes).
- the same stage names as the reference's timeMeasurements struct, so the
  CSV columns line up: keypoints / descriptors / matching / filtering /
  robEstimationAndRef / linRefinement / bundleAdjust / stereoRefine.
- ``trace`` context: optional jax.profiler trace for TensorBoard-level
  device profiling (replaces usac/utils/Timer.h's manual instrumentation).

Verbosity follows the reference's integer scheme (0 = silent, >=3 prints
stage times, >=6 prints everything — ConfigPoseEstimation::verbose,
stereo_pose_refinement.h:158).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import jax

# canonical stage names (timeMeasurements, noMatch_poselib-test/main.cpp:61-73
# + matching stages of correspondences.cpp)
STAGES = (
    "keypoints",
    "descriptors",
    "matching",
    "filtering",
    "robEstimationAndRef",
    "linRefinement",
    "bundleAdjust",
    "stereoRefine",
)


def _sync(x: Any) -> None:
    """Block on every array in a pytree (attribute async device work)."""
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


class StageTimer:
    """Accumulates per-stage wall-clock milliseconds.

    Usage::

        timer = StageTimer(verbose=3)
        with timer.stage("matching"):
            result = match(...)         # timer syncs on `result` via report
        timer.report(result)            # or pass outputs to stage(...)

    Stages may repeat; times accumulate. ``times_ms`` maps stage -> ms.
    """

    def __init__(self, verbose: int = 0):
        self.verbose = verbose
        self.times_ms: dict[str, float] = {}
        self._order: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, outputs: Any = None):
        t0 = time.perf_counter()
        holder: dict[str, Any] = {}
        try:
            yield holder
        finally:
            _sync(holder.get("outputs", outputs))
            dt = (time.perf_counter() - t0) * 1e3
            if name not in self.times_ms:
                self._order.append(name)
            self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
            if self.verbose >= 3:
                print(f"[{name}] {dt:.2f} ms")

    def row(self) -> dict[str, float]:
        """CSV-ready mapping with the reference column names (missing
        stages are 0.0, matching timeMeasurements default-init)."""
        return {f"{s}_ms": round(self.times_ms.get(s, 0.0), 3) for s in STAGES}

    def total_ms(self) -> float:
        return sum(self.times_ms.values())

    def reset(self) -> None:
        self.times_ms.clear()
        self._order.clear()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler trace wrapper; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
