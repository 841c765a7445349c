"""Feature-matching CLI (reference: tests/matchinglib-test/main.cpp).

Loads a mono or stereo image sequence by filename prefix, runs the full
correspondence pipeline on every pair, prints match counts and stage
timings, optionally stores keypoints+matches to ``--output_path``.

Usage:
    python -m matchinglib_poselib_tpu.apps.matchinglib_test \
        --img_path <dir> --l_img_pref left_ --r_img_pref right_ \
        --f_detect FAST --d_extr ORB --matcher GMBSOF
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from matchinglib_poselib_tpu.apps import common
from matchinglib_poselib_tpu.utils import io


def build_parser():
    p = argparse.ArgumentParser(
        prog="matchinglib-test",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_matching_options(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.enable_compile_cache()
    import jax.numpy as jnp

    from matchinglib_poselib_tpu.models import pipeline

    det, desc, match = common.matching_configs(args)
    timer = common.StageTimer(args.v)

    pairs = io.load_stereo_sequence(
        args.img_path, args.l_img_pref, args.r_img_pref
    )
    if not pairs:
        seq = io.load_image_sequence(args.img_path, args.l_img_pref)
        pairs = list(zip(seq[:-1], seq[1:]))
    if not pairs:
        raise SystemExit(f"no images found in {args.img_path}")

    out_dir = pathlib.Path(args.output_path) if args.output_path else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    total = 0
    for i, (lp, rp) in enumerate(pairs):
        timer.start("load")
        img1 = jnp.asarray(io.load_image_gray(lp))
        img2 = jnp.asarray(io.load_image_gray(rp))
        timer.stop()
        timer.start("correspondences")
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        n = int(corr.n)
        timer.stop()
        total += n
        print(f"pair {i} ({lp.name} <-> {rp.name}): {n} matches")
        if args.v >= 2:
            m = np.asarray(corr.mask)
            flow = np.asarray(corr.pts2)[m] - np.asarray(corr.pts1)[m]
            if m.any():
                print(
                    f"  flow median ({np.median(flow[:, 0]):.2f}, "
                    f"{np.median(flow[:, 1]):.2f}) px"
                )
        if out_dir:
            m = np.asarray(corr.mask)
            np.savez_compressed(
                out_dir / f"matches_{i:04d}.npz",
                pts1=np.asarray(corr.pts1)[m],
                pts2=np.asarray(corr.pts2)[m],
                distance=np.asarray(corr.distance)[m],
            )
            if args.showNr != -3:
                # headless storeMatches/showMatches parity
                # (matchinglib-test/main.cpp:84,89): side-by-side match
                # image; --showNr caps drawn matches (-3 disables)
                from matchinglib_poselib_tpu.utils import visualize

                img = visualize.draw_matches(
                    np.asarray(img1), np.asarray(corr.pts1),
                    np.asarray(img2), np.asarray(corr.pts2),
                    mask=m, max_draw=args.showNr,
                )
                visualize.write_png(out_dir / f"matches_{i:04d}.png", img)
    print(
        json.dumps(
            {
                "pairs": len(pairs),
                "total_matches": total,
                "stage_ms": {k: round(v, 2) for k, v in timer.stages.items()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
