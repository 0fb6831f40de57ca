"""Feature matching: brute force, F-matrix constrained, Earth-segment
("double") constrained.

Re-design of MatchFactory (MatchFactory.cuh:131-311, MatchFactory.cu).
Match generation is one chunked integer-matmul distance sweep with the epipolar
predicate fused into the distance mask; thresholds and invalidation follow
the reference kernels exactly:

  * best-target = argmin distance among targets passing the constraint
  * invalid if best_dist >= absoluteThreshold
    (matchFeaturesDoubleConstrained, MatchFactory.cu:2272-2289)
  * with seed distances: also invalid if
    best_dist / seed_dist > relativeThreshold^2
  * the "double constrained" predicate is the reference's literal test:
    x-range gate around the segment endpoints plus *vertical* distance to
    the segment's line (not perpendicular), MatchFactory.cu:1551-1567.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ssrlcv_tpu.config import MatchParams
from ssrlcv_tpu.core import camera_math
from ssrlcv_tpu.core.types import Cameras, FeatureSet, MatchSet
from ssrlcv_tpu.matching.distance import best_target_chunked, min_distance


class DMatches(NamedTuple):
    """Per-query match results (the reference's Unity<DMatch>)."""

    target_idx: jax.Array  # (Nq,) int32
    distance: jax.Array    # (Nq,) float32
    valid: jax.Array       # (Nq,) bool


def seed_distances(features, seed, chunk: int = 1024, metric: str = "l2sq") -> jax.Array:
    """Nearest seed-descriptor distance per feature
    (MatchFactory::getSeedDistances, MatchFactory.cu:315-346).  Works for any
    descriptor family exposing (descriptors, loc, mask) — SIFT (l2sq) or
    Window_NxN (sad), like the reference's template instantiations
    (MatchFactory.cu:7-12)."""
    return min_distance(features.descriptors, seed.descriptors, seed.mask,
                        chunk=chunk, metric=metric)


def _epipolar_segment_mask(p1, p2, t_loc, epsilon):
    """The double-constrained acceptance test (MatchFactory.cu:1551-1567):
    p1, p2: (C, 2) projected segment endpoints; t_loc: (Nt, 2).
    Returns (C, Nt) bool."""
    swap = p1[:, 0] >= p2[:, 0]
    left = jnp.where(swap[:, None], p2, p1)
    right = jnp.where(swap[:, None], p1, p2)
    tx = t_loc[None, :, 0]
    ty = t_loc[None, :, 1]

    in_x = (tx >= (left[:, 0] - epsilon)[:, None]) & (tx <= (right[:, 0] + epsilon)[:, None])

    vertical = (left[:, 0] == right[:, 0])[:, None]
    top = jnp.minimum(p1[:, 1], p2[:, 1])[:, None]
    bottom = jnp.maximum(p1[:, 1], p2[:, 1])[:, None]
    vert_ok = (top - epsilon <= ty) & (bottom + epsilon >= ty)

    dx = left[:, 0] - right[:, 0]
    slope = (left[:, 1] - right[:, 1]) / jnp.where(dx == 0, 1.0, dx)
    y_line = slope[:, None] * (tx - left[:, 0][:, None]) + left[:, 1][:, None]
    line_ok = jnp.abs(y_line - ty) <= epsilon

    return in_x & jnp.where(vertical, vert_ok, line_ok)


def _fmatrix_mask(q_loc, F, t_loc, epsilon):
    """Plain epipolar-line constraint (matchFeaturesConstrained,
    MatchFactory.cu:1598-1660): perpendicular distance of the target point
    to the epipolar line F @ [q, 1]."""
    qh = jnp.concatenate([q_loc, jnp.ones_like(q_loc[:, :1])], axis=1)  # (C, 3)
    lines = jnp.einsum("ij,cj->ci", F, qh, precision="highest")          # (C, 3)
    d = (
        lines[:, None, 0] * t_loc[None, :, 0]
        + lines[:, None, 1] * t_loc[None, :, 1]
        + lines[:, None, 2]
    )
    norm = jnp.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None]
    return jnp.abs(d) / jnp.maximum(norm, 1e-20) <= epsilon


@partial(jax.jit, static_argnames=("params", "chunk", "index_only", "metric"))
def match_double_constrained(
    query: FeatureSet,
    target: FeatureSet,
    cameras: Cameras,
    query_index: int | jax.Array,
    target_index: int | jax.Array,
    params: MatchParams,
    seed_dist: Optional[jax.Array] = None,
    chunk: int = 1024,
    index_only: bool = False,
    metric: str = "l2sq",
) -> DMatches:
    """Earth-geometry epipolar-segment constrained matching
    (generateDistanceMatchesDoubleConstrained, MatchFactory.cu:600-652).

    index_only: apply the IndexOnly kernels' UNSQUARED relative-seed
    threshold (MatchFactory.cu:2907) instead of the DMatch kernels' squared
    one (:2278) — the reference quirk that makes its N-view pairing looser
    than its 2-view matching.
    """
    qi, ti = query_index, target_index
    P = camera_math.projection_matrix(
        cameras.cam_pos[ti], cameras.cam_rot[ti], cameras.foc[ti],
        cameras.dpix[ti], cameras.size[ti], cameras.ecef_offset[ti],
    )
    p1, p2 = camera_math.epipolar_segment_endpoints(
        query.loc,
        cameras.cam_pos[qi], cameras.cam_rot[qi], cameras.foc[qi],
        cameras.dpix[qi], cameras.size[qi], cameras.ecef_offset[qi],
        P, params.delta,
    )

    idx, dist = best_target_chunked(
        query.descriptors, target.descriptors, target.mask,
        mask_fn=lambda a, b: _epipolar_segment_mask(a, b, target.loc, params.epsilon),
        mask_aux=(p1, p2),
        chunk=chunk,
        metric=metric,
    )
    return _threshold(idx, dist, query.mask, params, seed_dist,
                      squared=not index_only)


@partial(jax.jit, static_argnames=("params", "chunk", "index_only", "metric"))
def match_brute_force(
    query: FeatureSet,
    target: FeatureSet,
    params: MatchParams,
    seed_dist: Optional[jax.Array] = None,
    chunk: int = 1024,
    index_only: bool = False,
    metric: str = "l2sq",
) -> DMatches:
    """Unconstrained kNN matching (generateDistanceMatches,
    MatchFactory.cu:500-560).  index_only: unsquared relative-seed threshold
    (the IndexOnly kernel family quirk, MatchFactory.cu:2751)."""
    idx, dist = best_target_chunked(
        query.descriptors, target.descriptors, target.mask, chunk=chunk,
        metric=metric,
    )
    return _threshold(idx, dist, query.mask, params, seed_dist,
                      squared=not index_only)


@partial(jax.jit, static_argnames=("params", "chunk", "metric"))
def match_fmatrix_constrained(
    query: FeatureSet,
    target: FeatureSet,
    F: jax.Array,
    params: MatchParams,
    seed_dist: Optional[jax.Array] = None,
    chunk: int = 1024,
    metric: str = "l2sq",
) -> DMatches:
    """F-matrix epipolar-line constrained matching
    (generateDistanceMatchesConstrained, MatchFactory.cu:560-600)."""
    idx, dist = best_target_chunked(
        query.descriptors, target.descriptors, target.mask,
        mask_fn=lambda q: _fmatrix_mask(q, F, target.loc, params.epsilon),
        mask_aux=(query.loc,),
        chunk=chunk,
        metric=metric,
    )
    return _threshold(idx, dist, query.mask, params, seed_dist)


def _threshold(idx, dist, q_mask, params: MatchParams, seed_dist, squared=True):
    valid = q_mask & jnp.isfinite(dist) & (dist < params.absolute_threshold)
    if seed_dist is not None:
        # reference DMatch kernels: invalid if dist/seed > relativeThreshold^2
        # (MatchFactory.cu:2278); the IndexOnly kernel family compares
        # UNSQUARED (dist/seed > relativeThreshold, MatchFactory.cu:2751,
        # :2814, :2907) — the N-view pairing is deliberately-or-not looser
        rel = params.relative_threshold ** 2 if squared else params.relative_threshold
        valid = valid & (dist / jnp.maximum(seed_dist, 1e-20) <= rel)
    return DMatches(target_idx=idx, distance=dist, valid=valid)


class IndexPairs(NamedTuple):
    """Index-only matches — the reference's uint2_pair output family
    (MatchFactory.cuh:23, generateMatchesIndexOnly MatchFactory.cu:755-860):
    each pair is ((query image, query feature), (target image, target
    feature)).  Invalid slots keep a == b, the reference's own invalid
    encoding (validate(), MatchFactory.cuh:82-84)."""

    query_parent: jax.Array   # (Nq,) int32 image ids
    query_idx: jax.Array      # (Nq,) int32 feature indices
    target_parent: jax.Array  # (Nq,) int32
    target_idx: jax.Array     # (Nq,) int32
    valid: jax.Array          # (Nq,) bool


def match_index_only(dm: DMatches, query_id: int, target_id: int) -> IndexPairs:
    """DMatches -> index-only uint2_pair form (the IndexOnly kernel family,
    MatchFactory.cuh:346-448; used by generateMatchesExhaustive for track
    building)."""
    n = dm.target_idx.shape[0]
    qidx = jnp.arange(n, dtype=jnp.int32)
    qpar = jnp.full((n,), query_id, jnp.int32)
    # invalid encoding: a == b (both images and indices), as validate() tests
    tpar = jnp.where(dm.valid, jnp.int32(target_id), qpar)
    tidx = jnp.where(dm.valid, dm.target_idx.astype(jnp.int32), qidx)
    return IndexPairs(qpar, qidx, tpar, tidx, dm.valid)


@jax.jit
def validate_matches(dm: DMatches) -> DMatches:
    """Stream-compact valid matches to the front, preserving order
    (validateMatches' thrust::remove_if, MatchFactory.cu:32-135).  Masked
    equivalent: invalid slots move to the tail with distance +inf."""
    order = jnp.argsort(~dm.valid, stable=True)
    return DMatches(
        target_idx=dm.target_idx[order],
        distance=jnp.where(dm.valid[order], dm.distance[order], jnp.inf),
        valid=dm.valid[order],
    )


@partial(jax.jit, static_argnames=())
def refine_matches(dm: DMatches, threshold: jax.Array | float) -> DMatches:
    """Absolute-distance cutoff: drop matches with distance > threshold
    (refineMatches, MatchFactory.cu:137-190).  The reference exits on
    threshold == 0; here the caller must pass a positive threshold."""
    keep = dm.valid & (dm.distance <= threshold)
    return DMatches(target_idx=dm.target_idx, distance=dm.distance, valid=keep)


@jax.jit
def sort_matches(dm: DMatches) -> DMatches:
    """Sort by ascending distance (sortMatches' thrust::sort with
    match_dist_comparator, MatchFactory.cu:191-223); invalid slots sort to
    the end via +inf."""
    key = jnp.where(dm.valid, dm.distance, jnp.inf)
    order = jnp.argsort(key, stable=True)
    return DMatches(
        target_idx=dm.target_idx[order],
        distance=key[order],
        valid=dm.valid[order],
    )


def get_raw_matches(dm: DMatches, query: FeatureSet, target: FeatureSet,
                    query_id: int, target_id: int):
    """Strip distances to raw keypoint-pair Matches (getRawMatches,
    MatchFactory.cu:257-314).  Returns (loc (Nq, 2, 2), parent (Nq, 2),
    valid (Nq,)) in query order — the array-of-struct Match layout flattened
    to struct-of-arrays."""
    tgt = jnp.clip(dm.target_idx, 0, target.capacity - 1)
    loc = jnp.stack([query.loc, target.loc[tgt]], axis=1)
    parent = jnp.broadcast_to(
        jnp.asarray([query_id, target_id], jnp.int32), (dm.valid.shape[0], 2)
    )
    return loc, parent, dm.valid


class FeatureMatches(NamedTuple):
    """Descriptor-carrying matches — the reference's FeatureMatch<T>
    (MatchFactory.cuh:69-72: DMatch + ``T descriptors[2]``), struct-of-arrays.
    Works for any descriptor family (SIFT uint8[128], Window_NxN), like the
    reference's template instantiations (MatchFactory.cu:7-12)."""

    loc: jax.Array          # (Nq, 2, 2) float32 — [query kp, target kp]
    parent: jax.Array       # (Nq, 2) int32 image ids
    descriptors: jax.Array  # (Nq, 2, D) — [query desc, target desc]
    distance: jax.Array     # (Nq,) float32
    valid: jax.Array        # (Nq,) bool


def get_feature_matches(dm: DMatches, query: FeatureSet, target: FeatureSet,
                        query_id: int, target_id: int) -> FeatureMatches:
    """DMatches -> descriptor-carrying FeatureMatch<T> form (the
    matchFeatures* FeatureMatch kernel outputs, MatchFactory.cuh:377-410) in
    query order; invalid slots keep their best-candidate payload like the
    reference kernels and are dropped by validate_matches-style compaction
    downstream."""
    tgt = jnp.clip(dm.target_idx, 0, target.capacity - 1)
    loc = jnp.stack([query.loc, target.loc[tgt]], axis=1)
    desc = jnp.stack([query.descriptors, target.descriptors[tgt]], axis=1)
    parent = jnp.broadcast_to(
        jnp.asarray([query_id, target_id], jnp.int32), (dm.valid.shape[0], 2)
    )
    return FeatureMatches(loc=loc, parent=parent, descriptors=desc,
                          distance=dm.distance, valid=dm.valid)


@partial(jax.jit, static_argnames=("query_id", "target_id", "capacity"))
def _matchset_device(dm: DMatches, q_loc, t_loc, query_id: int,
                     target_id: int, capacity: int) -> MatchSet:
    """Device-side MatchSet assembly: stable argsort on ~valid compacts the
    matches to the front in query order — identical layout and padding to
    the old host-side builder, but the only host traffic is the caller's
    single count fetch (the full DMatches/loc arrays stay on the device)."""
    order = jnp.argsort(~dm.valid, stable=True)[:capacity]
    v = dm.valid[order]
    tgt = jnp.clip(dm.target_idx[order], 0, t_loc.shape[0] - 1)
    kp_loc = jnp.stack([q_loc[order], t_loc[tgt]], axis=1)
    kp_loc = jnp.where(v[:, None, None], kp_loc, 0.0)
    ids = jnp.asarray([query_id, target_id], jnp.int32)
    kp_par = jnp.where(v[:, None], ids[None, :], -1)
    return MatchSet(
        kp_loc=kp_loc,
        kp_parent=kp_par,
        num_views=jnp.where(v, 2, 0).astype(jnp.int32),
        mask=v,
    )


def matches_to_matchset(
    dm: DMatches,
    query: FeatureSet,
    target: FeatureSet,
    query_id: int,
    target_id: int,
    capacity: Optional[int] = None,
) -> MatchSet:
    """Assemble the 2-view MatchSet (Pipeline.cu:210-222): keyPoints[2i] =
    query kp, [2i+1] = matched target kp, track order = query order
    compacted over valid matches (device-side stable compaction; one scalar
    count fetch sizes the capacity like the reference's CPU compaction)."""
    import numpy as np

    if capacity is None:
        n = int(np.asarray(jnp.sum(dm.valid.astype(jnp.int32))))
        capacity = max(((n + 127) // 128) * 128, 128)
    return _matchset_device(dm, query.loc, target.loc, int(query_id),
                            int(target_id), int(capacity))
