"""SFM command-line entry point.

Mirror of the reference executable (SFM.cu:61-359): parse args, load images +
params.csv, run the 6-stage pipeline with stage-door checkpoint/resume, write
PLY artifacts, handle SIGINT by flushing the logger and leaving a resumable
checkpoint directory.

Usage:
    python -m ssrlcv_tpu.pipeline.sfm -d <image_dir> [-s <seed_image>]
        [--epsilon E] [--delta D] [-cpdir DIR] [--pose] [-np]
"""

from __future__ import annotations

import argparse
import signal
import sys

from ssrlcv_tpu.config import MatchParams, PipelineConfig
from ssrlcv_tpu.logging import logger


def parse_args(argv=None) -> argparse.Namespace:
    """CLI flags mirroring the reference arg table (io_util.cpp:158-194)."""
    p = argparse.ArgumentParser(prog="ssrlcv-sfm", description=__doc__)
    p.add_argument("-d", "--directory", required=True, help="directory of images + params.csv")
    p.add_argument("-i", "--image", action="append", default=[], help="individual image path")
    p.add_argument("-s", "--seed", default=None, help="seed image path")
    p.add_argument("--epsilon", type=float, default=5.0, help="epipolar tube half-width, px (SFM.cu:121)")
    p.add_argument("--delta", type=float, default=0.0, help="Earth-radius slack, km (SFM.cu:129)")
    p.add_argument("-cpdir", "--checkpoint-dir", default=None, help="checkpoint/resume directory")
    p.add_argument("--pose", action="store_true", help="run pose estimation, skip BA (SFM.cu:307)")
    p.add_argument("-np", "--noparams", action="store_true", help="skip params.csv")
    p.add_argument("-o", "--output-dir", default="out")
    p.add_argument("--mesh", default=None, metavar="DATAxFEAT",
                   help="run distributed stages over a (data, feat) device "
                        "mesh, e.g. '4x2'; 'auto' = all devices on the data axis")
    return p.parse_args(argv)


def _build_mesh(spec: str):
    import jax

    from ssrlcv_tpu.parallel.mesh import make_mesh

    if spec == "auto":
        return make_mesh()
    data, feat = (int(x) for x in spec.split("x"))
    return make_mesh(jax.devices()[: data * feat], data=data, feat=feat)


def build_state(args: argparse.Namespace):
    """Load the images and cameras, build the mesh and the seed features:
    the PipelineState that run_pipeline starts from.  None when there are
    fewer than two images."""
    from ssrlcv_tpu.features.sift import generate_features
    from ssrlcv_tpu.io.images import load_directory, load_image_with_params
    from ssrlcv_tpu.pipeline.stages import PipelineState

    config = PipelineConfig(
        output_dir=args.output_dir,
        checkpoint_dir=args.checkpoint_dir,
        do_pose=args.pose,
        no_params=args.noparams,
    ).replace(
        match=MatchParams(epsilon=args.epsilon, delta=args.delta),
    )

    with logger.phase("load_images"):
        images = load_directory(args.directory, no_params=args.noparams)
    if len(images) < 2:
        logger.err(f"need at least 2 images, found {len(images)}")
        return None
    logger.info(f"loaded {len(images)} images from {args.directory}")

    state = PipelineState(config=config, images=images)
    if args.mesh:
        state.mesh = _build_mesh(args.mesh)
        logger.info(f"distributed stages over mesh {dict(state.mesh.shape)}")

    if args.seed:
        seed_img = load_image_with_params(args.seed, -1, no_params=True)
        with logger.phase("sift_seed"):
            state.seed_features = generate_features(seed_img.pixels, config.sift, image_id=-1)
    return state


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    from ssrlcv_tpu.backend import enable_compile_cache

    enable_compile_cache()
    if jax.process_count() > 1:
        # multi-process (one per host): every process runs the same
        # pipeline and produces identical artifacts — write them to
        # per-process dirs so shared-filesystem paths never race
        sfx = f"-p{jax.process_index()}"
        args.output_dir = args.output_dir + sfx
        if args.checkpoint_dir:
            args.checkpoint_dir = args.checkpoint_dir + sfx
    logger.log_dir = args.output_dir
    logger.path = f"{args.output_dir}/ssrlcv.log"
    logger.log_state("start")
    logger.start_background_logging(1.0)

    def safe_shutdown(signum, frame):
        # SIGINT handler (SFM.cu:33-38): flush + exit; stage checkpoints on
        # disk stay resumable
        logger.log_state("SIGINT")
        logger.close()
        sys.exit(130)

    previous = signal.signal(signal.SIGINT, safe_shutdown)
    try:
        from ssrlcv_tpu.pipeline.stages import run_pipeline

        state = build_state(args)
        if state is None:
            return 1
        run_pipeline(state)
        logger.log_state("end")
        return 0
    finally:
        logger.close()
        signal.signal(signal.SIGINT, previous)


if __name__ == "__main__":
    sys.exit(main())
