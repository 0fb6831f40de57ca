"""Pipeline stage orchestration with stage-door checkpoint/resume.

Re-design of the reference Pipeline (Pipeline.cuh:17-127, Pipeline.cu)
and the SFM executable's 6-stage state machine (SFM.cu:61-359): each stage is
a function over plain pytrees; after each stage an NPZ checkpoint + ``done``
marker lands in ``<ckpt>/sfm-stage<N>/``, and ``run_pipeline`` resumes at the
first stage whose marker is missing.

Stage order (SFM.cu:209-307):
  0 feature generation -> 1 pose estimation (optional) -> 2 matching
  -> 3 triangulation -> 4 filtering -> 5 bundle adjustment
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ssrlcv_tpu.config import PipelineConfig
from ssrlcv_tpu.core.types import Cameras, FeatureSet, MatchSet, PointCloud
from ssrlcv_tpu.io import checkpoint as ckpt
from ssrlcv_tpu.io import ply
from ssrlcv_tpu.io.images import cameras_from_refimages
from ssrlcv_tpu.io.refdata import RefImage
from ssrlcv_tpu.logging import logger

STAGE_FEATURES = 0
STAGE_POSE = 1
STAGE_MATCHING = 2
STAGE_TRIANGULATION = 3
STAGE_FILTERING = 4
STAGE_BUNDLE_ADJUST = 5
NUM_STAGES = 6


@dataclasses.dataclass
class PipelineState:
    config: PipelineConfig
    images: list          # list[RefImage]
    cameras: Optional[Cameras] = None
    features: Optional[list] = None        # list[FeatureSet]
    seed_features: Optional[FeatureSet] = None
    seed_distances: Optional[jnp.ndarray] = None
    matches: Optional[MatchSet] = None
    cloud: Optional[PointCloud] = None
    ba_error: Optional[tuple] = None
    # optional jax.sharding.Mesh: when set, matching/triangulation/BA run
    # their distributed twins from parallel/sharded.py over it
    mesh: Optional[object] = None
    # batched PushbroomCameras when images[0].is_pushbroom
    # (generateBundles dispatch, PointCloudFactory.cu:845-903)
    pushbrooms: Optional[object] = None


def do_feature_generation(state: PipelineState) -> PipelineState:
    """Stage 0 (doFeatureGeneration, Pipeline.cu:16-72): SIFT per image +
    camera assembly with image-0 ECEF offsetting (done at load)."""
    from ssrlcv_tpu.features.sift import generate_features, log_saturation
    from ssrlcv_tpu.io.images import pushbrooms_from_refimages
    from ssrlcv_tpu.ops import image_ops as ops

    state.cameras = cameras_from_refimages(state.images)
    state.pushbrooms = pushbrooms_from_refimages(state.images)
    shapes = {im.pixels.shape[:2] for im in state.images}
    if state.mesh is not None and len(state.images) > 1 and len(shapes) == 1:
        # image-parallel SIFT: one image per device over the whole mesh
        # (the 95%-of-wall-clock stage; see parallel/sharded.py)
        from ssrlcv_tpu.parallel.sharded import sharded_generate_features

        with logger.phase("sift_sharded"):
            px = jnp.stack([
                ops.to_bw(jnp.asarray(im.pixels))
                if np.asarray(im.pixels).ndim == 3 else jnp.asarray(im.pixels)
                for im in state.images
            ])
            ids = [im.id for im in state.images]
            feats, sat, ovf = sharded_generate_features(
                state.mesh, px, ids, state.config.sift)
        for im, f, s, o in zip(state.images, feats, sat, ovf):
            log_saturation(im.id, s, o, state.config.sift)
            logger.info(f"image {im.id}: {int(f.count())} features")
    elif len(state.images) > 1 and len(shapes) == 1:
        # single device, several same-shape images: phase-pipelined batch
        from ssrlcv_tpu.features.sift import generate_features_many

        with logger.phase("sift_batch"):
            feats = generate_features_many(
                [im.pixels for im in state.images], state.config.sift,
                image_ids=[im.id for im in state.images])
        for im, f in zip(state.images, feats):
            logger.info(f"image {im.id}: {int(f.count())} features")
    else:
        feats = []
        for im in state.images:
            with logger.phase(f"sift_image_{im.id}"):
                feats.append(generate_features(im.pixels, state.config.sift, image_id=im.id))
            logger.info(f"image {im.id}: {int(feats[-1].count())} features")
    state.features = feats
    return state


def do_pose_estimation(state: PipelineState) -> PipelineState:
    """Stage 1 (doPoseEstimation, Pipeline.cu:74-171, optional): refine
    image-1 pose by LM on the 2-view match set."""
    if not state.config.do_pose or len(state.images) != 2:
        return state
    from ssrlcv_tpu.matching import match as M
    from ssrlcv_tpu.pose.lm import refine_relative_pose

    p = state.config.pose
    mp = state.config.match.__class__(
        relative_threshold=p.relative_threshold,
        absolute_threshold=p.absolute_threshold,
        epsilon=p.epsilon,
        delta=p.delta,
    )
    sd = None
    if state.seed_features is not None:
        sd = M.seed_distances(state.features[0], state.seed_features)
    dm = M.match_double_constrained(
        state.features[0], state.features[1], state.cameras, 0, 1, mp, seed_dist=sd
    )
    ms = M.matches_to_matchset(dm, state.features[0], state.features[1], 0, 1)
    with logger.phase("pose_lm"):
        new_cams = refine_relative_pose(ms, state.cameras, p)
    state.cameras = new_cams
    # propagate the refined camera back into the host-side image records
    state.images[1].cam_pos = np.asarray(new_cams.cam_pos[1])
    state.images[1].cam_rot = np.asarray(new_cams.cam_rot[1])
    return state


def do_feature_matching(state: PipelineState) -> PipelineState:
    """Stage 2 (doFeatureMatching, Pipeline.cu:173-241)."""
    from ssrlcv_tpu.matching import match as M
    from ssrlcv_tpu.matching.tracks import generate_matches_exhaustive

    cfg = state.config.match
    logger.log_state("MATCHING")
    sd = None
    if state.seed_features is not None:
        sd = M.seed_distances(state.features[0], state.seed_features)
        state.seed_distances = sd

    if len(state.images) == 2:
        if state.mesh is not None:
            from ssrlcv_tpu.parallel import sharded

            if cfg.mode == "double":
                dm = sharded.sharded_match_double_constrained(
                    state.mesh, state.features[0], state.features[1],
                    state.cameras, 0, 1, cfg, seed_dist=sd,
                )
            else:
                dm = sharded.sharded_match_brute_force(
                    state.mesh, state.features[0], state.features[1], cfg, seed_dist=sd
                )
        elif cfg.mode == "double":
            dm = M.match_double_constrained(
                state.features[0], state.features[1], state.cameras, 0, 1, cfg, seed_dist=sd
            )
        else:
            dm = M.match_brute_force(state.features[0], state.features[1], cfg, seed_dist=sd)
        state.matches = M.matches_to_matchset(dm, state.features[0], state.features[1], 0, 1)
    else:
        # N-view: the O(N^2) pair sweep distributes over the mesh when one
        # is present (each device matches its pair subset; track building
        # stays host-side as in the reference)
        state.matches = generate_matches_exhaustive(
            state.features, state.cameras, cfg,
            seed_features=state.seed_features, mesh=state.mesh,
        )
    logger.info(f"total matches: {int(state.matches.count())}")
    logger.log_state("MATCHING")
    return state


def do_triangulation(state: PipelineState) -> PipelineState:
    """Stage 3 (doTriangulation, Pipeline.cu:260-295)."""
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches

    two_view = len(state.images) == 2
    if state.mesh is not None and two_view and state.pushbrooms is None:
        from ssrlcv_tpu.parallel.sharded import sharded_triangulate

        pc, err = sharded_triangulate(state.mesh, state.matches, state.cameras)
    else:
        pc, err = triangulate_matches(
            state.matches, state.cameras, two_view, pushbrooms=state.pushbrooms)
    state.cloud = pc
    logger.info(f"initial cloud: {int(pc.mask.sum())} points, error {float(err):.6f}")
    _write_cloud(state, "ssrlcv-initial")
    return state


def do_filtering(state: PipelineState) -> PipelineState:
    """Stage 4 (doFiltering, Pipeline.cu:297-369): 2-view linear cutoff then
    deterministic statistical filter; re-triangulate."""
    from ssrlcv_tpu.geometry import filters as F
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches

    cfg = state.config.filter
    two_view = len(state.images) == 2
    ms = state.matches
    if two_view:
        ms = F.linear_cutoff_filter(ms, state.cameras, cfg.linear_cutoff_km,
                                    pushbrooms=state.pushbrooms)
    jump = max(int(round(1.0 / cfg.sample_fraction)), 1)
    ms = F.deterministic_statistical_filter(
        ms, state.cameras, cfg.statistical_sigma, jump, two_view=two_view,
        pushbrooms=state.pushbrooms,
    )
    state.matches = ms
    pc, err = triangulate_matches(ms, state.cameras, two_view,
                                  pushbrooms=state.pushbrooms)
    state.cloud = pc
    logger.info(f"filtered cloud: {int(pc.mask.sum())} points, error {float(err):.6f}")
    _write_cloud(state, "ssrlcv-filtered")
    return state


def do_bundle_adjust(state: PipelineState) -> PipelineState:
    """Stage 5 (doBundleAdjust, Pipeline.cu:371-383; skipped with --pose as
    in SFM.cu:307)."""
    from ssrlcv_tpu.ba.two_view import bundle_adjust

    if len(state.images) != 2:
        from ssrlcv_tpu.ba.nview import bundle_adjust_nview

        result = bundle_adjust_nview(state.matches, state.cameras, state.config.ba)
    elif state.mesh is not None:
        from ssrlcv_tpu.parallel.sharded import sharded_bundle_adjust

        result = sharded_bundle_adjust(
            state.mesh, state.matches, state.cameras,
            iterations=state.config.ba.iterations,
            fix_camera0=state.config.ba.fixed_camera,
        )
    else:
        result = bundle_adjust(state.matches, state.cameras, state.config.ba)
    state.cameras = result.cameras
    state.cloud = result.cloud
    state.ba_error = (float(result.initial_error), float(result.final_error))
    logger.info(
        f"bundle adjust: {state.ba_error[0]:.6f} -> {state.ba_error[1]:.6f}"
    )
    _write_cloud(state, "ssrlcv-BA-final")
    return state


def _write_cloud(state: PipelineState, name: str):
    pts = state.cloud.compact()
    path = os.path.join(state.config.output_dir, name)
    ply.write_ply(path, pts)
    logger.info(f"wrote {path}.ply ({len(pts)} points)")


STAGES = [
    ("features", do_feature_generation),
    ("pose", do_pose_estimation),
    ("matching", do_feature_matching),
    ("triangulation", do_triangulation),
    ("filtering", do_filtering),
    ("bundle_adjust", do_bundle_adjust),
]


def run_pipeline(state: PipelineState) -> PipelineState:
    """Run all stages with stage-door checkpoint/resume (SFM.cu:149-203)."""
    root = state.config.checkpoint_dir
    start = 0
    if root:
        start = ckpt.first_unfinished_stage(root, NUM_STAGES)
        if start > 0:
            logger.info(f"resuming at stage {start}")
            _restore(state, root, start)

    for i in range(start, NUM_STAGES):
        name, fn = STAGES[i]
        logger.log_state(f"stage{i}:{name}:begin")
        state = fn(state)
        logger.log_state(f"stage{i}:{name}:end")
        if root:
            _checkpoint(state, root, i)
    return state


def _checkpoint(state: PipelineState, root: str, stage: int):
    tree = {}
    if state.cameras is not None:
        tree["cameras"] = state.cameras
    if state.features is not None and stage <= STAGE_POSE:
        for j, f in enumerate(state.features):
            tree[f"features{j}"] = f
    if state.matches is not None and stage >= STAGE_MATCHING:
        tree["matches"] = state.matches
    if state.cloud is not None and stage >= STAGE_TRIANGULATION:
        tree["cloud"] = state.cloud
    meta = {"stage": stage}
    if state.matches is not None and stage >= STAGE_MATCHING:
        meta["match_capacity"] = int(state.matches.capacity)
        meta["match_views"] = int(state.matches.kp_loc.shape[1])
    ckpt.save_stage(root, stage, "state", tree, meta=meta)


def _restore(state: PipelineState, root: str, start: int):
    """Rebuild state from the last finished stage's checkpoint."""
    last = start - 1
    # build a 'like' skeleton matching what _checkpoint saved at `last`
    state.cameras = cameras_from_refimages(state.images)
    like = {"cameras": state.cameras}
    if last <= STAGE_POSE:
        cap = state.config.sift.max_keypoints
        state.features = [FeatureSet.empty(cap, parent=im.id) for im in state.images]
        for j in range(len(state.images)):
            like[f"features{j}"] = state.features[j]
    if last >= STAGE_MATCHING:
        meta = ckpt.load_stage_meta(root, last) or {}
        cap = meta.get("match_capacity")
        views = meta.get("match_views", 2)
        if cap is None:
            # legacy checkpoints (pre match_capacity meta): probe the NPZ
            import numpy as _np

            d = ckpt.stage_dir(root, last)
            with _np.load(os.path.join(d, "state.npz")) as z:
                caps = [z[k].shape[0] for k in z.files if z[k].ndim == 3]
                cap = caps[0] if caps else 128
        state.matches = MatchSet.empty(cap, views)
        like["matches"] = state.matches
    if last >= STAGE_TRIANGULATION:
        t = state.matches.capacity
        state.cloud = PointCloud(
            points=jnp.zeros((t, 3), jnp.float32),
            errors=jnp.zeros((t,), jnp.float32),
            mask=jnp.zeros((t,), bool),
        )
        like["cloud"] = state.cloud
    loaded = ckpt.load_stage(root, last, "state", like)
    state.cameras = loaded.get("cameras", state.cameras)
    if state.features is not None and last <= STAGE_POSE:
        state.features = [loaded[f"features{j}"] for j in range(len(state.images))]
    if last >= STAGE_MATCHING:
        state.matches = loaded["matches"]
    if last >= STAGE_TRIANGULATION:
        state.cloud = loaded["cloud"]
