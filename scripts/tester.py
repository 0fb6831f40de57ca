#!/usr/bin/env python
"""Ad-hoc scratch driver (the reference's second executable, src/Tester.cu:36-120):
exercises the logger + the 2-view match -> triangulate path on the golden
fixtures, printing phase timings.  Run on the default device with
`python scripts/tester.py` or on CPU with `SSRLCV_PLATFORM=cpu python
scripts/tester.py`.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

platform = os.environ.get("SSRLCV_PLATFORM")
if platform:
    os.environ["JAX_PLATFORMS"] = platform
import jax

if platform:
    jax.config.update("jax_platforms", platform)
from ssrlcv_tpu.backend import enable_compile_cache  # noqa: E402

enable_compile_cache()

FIXTURE = "/root/reference/test/checkpoints/Pipeline2View"


def main():
    import numpy as np

    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.features.sift import features_from_refdata
    from ssrlcv_tpu.geometry.bundles import generate_bundles
    from ssrlcv_tpu.geometry.triangulation import two_view_triangulate
    from ssrlcv_tpu.io import refdata
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu.logging import Logger
    from ssrlcv_tpu.matching import match as M

    out = os.environ.get("SSRLCV_OUT", "out")
    logger = Logger(out)
    logger.log_state("start")
    logger.start_background_logging(1.0)

    from ssrlcv_tpu.core.types import MatchSet

    fx = refdata.load_fixture_dir(FIXTURE, 2)
    cams = cameras_from_refimages(fx["images"])
    seed = features_from_refdata(fx["seed_features"])
    logger.info(f"loaded fixtures: {int(np.sum(np.asarray(seed.mask)))} seed features")

    logger.log_state("matching start")
    t0 = time.perf_counter()
    sd = M.seed_distances(seed, seed)
    sd.block_until_ready()
    n_seed = int(np.sum(np.asarray(seed.mask)))
    logger.log_state("matching end")
    logger.info(f"seed-distance pass over {n_seed} features "
                f"in {time.perf_counter() - t0:.3f}s")
    del MatchParams, M  # matching exercised above; MatchSet comes from fixture

    kp_par, kp_loc = fx["keypoints0"]
    mm_num, mm_idx = fx["multimatches0"]
    ms = MatchSet.from_flat(kp_par, kp_loc, mm_num, mm_idx)
    n = int(np.asarray(ms.mask).sum())

    logger.log_state("triangulate start")
    t0 = time.perf_counter()
    bundles = generate_bundles(ms, cams)
    cloud, total_err = two_view_triangulate(bundles)
    err = float(np.asarray(total_err))
    logger.log_state("triangulate end")
    logger.info(f"triangulated {n} points, linear error {err:.6f} km^2 "
                f"in {time.perf_counter() - t0:.3f}s")

    logger.stop_background_logging()
    logger.log_state("end")
    print(f"tester: {n} matches, linear error {err:.6f}, log at {logger.path}")


if __name__ == "__main__":
    main()
