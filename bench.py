"""End-to-end 2-view reconstruction benchmark on one GPU.

Runs the full pipeline (SIFT x2 -> seeded double-constrained matching ->
triangulation -> filtering -> BA) on the seeded 1024^2 orbital scene
(ssrlcv_tpu.io.scene, seed 0) and prints the card, then ONE JSON line:

    {"metric": "reconstruction_fps", "value": N, "unit": "frames/s", ...}

Every timed region ends in ``block_until_ready``.  Without a GPU it exits
non-zero and reports nothing: a CPU number is not a device number.

Baseline: the reference publishes no throughput numbers; its CI budget for
the same end-to-end 2-view run is a 30-minute Slurm limit on a K40
(scripts/sub-run-sfm-2.sh, BASELINE.md) = 2 frames / 1800 s.  vs_baseline is
ours / that budget — a LOWER BOUND on the true speedup.
"""

import json
import os
import time

BASELINE_FPS = 2.0 / 1800.0  # reference CI budget: 2-view e2e in 30 min on K40
SIZE = 1024
SEED = 0


def run_once(images, cams, seed_features, stage_s=None):
    import jax

    from ssrlcv_tpu.ba.two_view import bundle_adjust_two_view
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.features.sift import generate_features_many
    from ssrlcv_tpu.geometry import filters as F
    from ssrlcv_tpu.matching import match as M

    t = time.perf_counter()

    def tick(name, out):
        nonlocal t
        if stage_s is not None:
            jax.block_until_ready(out)
            now = time.perf_counter()
            stage_s[name] = now - t
            t = now

    f0, f1 = generate_features_many(images, image_ids=[0, 1])
    tick("sift_both", (f0, f1))
    sd = M.seed_distances(f0, seed_features)
    params = MatchParams(epsilon=25.0, delta=5.0)
    dm = M.match_double_constrained(f0, f1, cams, 0, 1, params, seed_dist=sd)
    ms = M.matches_to_matchset(dm, f0, f1, 0, 1)
    tick("match", ms)
    ms = F.linear_cutoff_filter(ms, cams, 100.0)
    ms = F.deterministic_statistical_filter(ms, cams, 3.0, 10)
    tick("filter", ms)
    r = bundle_adjust_two_view(ms, cams, iterations=10, mode="lm")
    jax.block_until_ready(r)
    tick("ba", r)
    return ms, r


def main():
    import numpy as np

    from ssrlcv_tpu.backend import card_lines, enable_compile_cache, require_gpu

    devices = require_gpu()
    cards = card_lines()
    for line in cards:
        print(f"card: {line}")
    enable_compile_cache()

    from ssrlcv_tpu.features.sift import generate_features
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu.io.images import cameras_from_refimages, load_directory
    from ssrlcv_tpu.io.scene import make_scene, write_scene

    scene = make_scene(SEED, SIZE)
    views, _ = write_scene(scene, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                               "out", "bench", "scene"))
    ims = load_directory(views)
    images = [im.pixels for im in ims]
    cams = cameras_from_refimages(ims)
    seed = generate_features(scene.seed_image, image_id=-1)

    run_once(images, cams, seed)  # compilation
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ms, r = run_once(images, cams, seed)
        elapsed = min(elapsed, time.perf_counter() - t0)
    stage_s = {}
    ms, r = run_once(images, cams, seed, stage_s=stage_s)

    n_points = int(np.asarray(ms.mask).sum())
    pc, _ = triangulate_matches(ms, cams)
    pts = np.asarray(pc.points)[np.asarray(ms.mask)]
    height_m = float(np.median(np.abs(scene.height_error_km(pts)))) * 1000.0
    fps = 2.0 / elapsed
    print(json.dumps({
        "metric": "reconstruction_fps",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "baseline_kind": "ci_budget_upper_bound (lower bound of true speedup)",
        "device": {"platform": devices[0].platform, "kind": devices[0].device_kind,
                   "count": len(devices)},
        "card": cards[0],
        "e2e_seconds": elapsed,
        "points": n_points,
        "ba_final_error": float(r.final_error),
        "filtered_cloud_median_height_error_m": height_m,
        "stages": stage_s,
    }))


if __name__ == "__main__":
    main()
