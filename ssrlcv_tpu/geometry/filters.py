"""Point-cloud / match-set filters.

Re-design of the reference's filter family (PointCloudFactory.cu:3070-3828).
The reference filters physically rewrite the KeyPoint/MultiMatch arrays with
CPU compaction loops; here a filter is a pure function MatchSet -> MatchSet
that only updates the validity mask (order is preserved, so host-side
compaction of the final cloud reproduces the reference's output ordering
exactly).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ssrlcv_tpu.core.types import Bundles, Cameras, MatchSet, PointCloud
from ssrlcv_tpu.geometry.bundles import generate_bundles
from ssrlcv_tpu.geometry.triangulation import n_view_triangulate, two_view_triangulate


def _with_mask(matches: MatchSet, mask: jax.Array) -> MatchSet:
    return matches.replace(mask=mask)


@partial(jax.jit, static_argnames=("two_view",))
def linear_cutoff_filter(
    matches: MatchSet, cameras: Cameras, cutoff: float, two_view: bool = True, pushbrooms=None,) -> MatchSet:
    """Drop tracks whose linear error exceeds an absolute cutoff (km^2 scale:
    the reference compares the squared gap against ``cutoff`` directly —
    linearCutoffFilter, PointCloudFactory.cu:3500-3651; 100.0 at Pipeline.cu:306).
    """
    bd = generate_bundles(matches, cameras, pushbrooms=pushbrooms)
    if two_view:
        pc, _ = two_view_triangulate(bd)
    else:
        pc, _ = n_view_triangulate(bd)
    keep = matches.mask & (pc.errors <= cutoff) & pc.mask
    return _with_mask(matches, keep)


@partial(jax.jit, static_argnames=("two_view", "sample_jump"))
def deterministic_statistical_filter(
    matches: MatchSet,
    cameras: Cameras,
    sigma: float,
    sample_jump: int,
    two_view: bool = True, pushbrooms=None,) -> MatchSet:
    """Variance-based error filter (deterministicStatisticalFilter,
    PointCloudFactory.cu:3070-3275).

    Samples every ``sample_jump``-th valid track's linear error (in compacted
    order, as the reference samples its physically-compacted arrays), computes
    the sample variance, and drops tracks with error > sigma * stddev.
    """
    bd = generate_bundles(matches, cameras, pushbrooms=pushbrooms)
    if two_view:
        pc, _ = two_view_triangulate(bd)
    else:
        # bug-compatible reference error (last-view^2/numLines) so the
        # variance cutoff reproduces the golden filtered sets
        pc, _ = n_view_triangulate(bd, reference_error_mode=True)
    errors = pc.errors
    valid = matches.mask & pc.mask

    # every k-th valid error, in compacted order (matches the reference's
    # host loop over its compacted arrays)
    order = jnp.cumsum(valid.astype(jnp.int32)) - 1            # compacted index per slot
    n_valid = jnp.sum(valid.astype(jnp.int32))
    sample_count = n_valid // sample_jump
    is_sample = valid & (order % sample_jump == 0) & (order < sample_count * sample_jump)
    w = is_sample.astype(errors.dtype)
    denom = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(errors * w) / denom
    var = jnp.sum(((errors - mean) ** 2) * w) / denom
    cutoff = sigma * jnp.sqrt(var)

    keep = valid & (errors <= cutoff)
    return _with_mask(matches, keep)


@partial(jax.jit, static_argnames=("two_view", "sample_count"))
def nondeterministic_statistical_filter(
    matches: MatchSet,
    cameras: Cameras,
    key: jax.Array,
    sigma: float,
    sample_count: int,
    two_view: bool = True, pushbrooms=None,) -> MatchSet:
    """Random-sample variant (nonDeterministicStatisticalFilter,
    PointCloudFactory.cu:3286-3498): same cutoff construction but the sample
    is drawn uniformly at random."""
    bd = generate_bundles(matches, cameras, pushbrooms=pushbrooms)
    if two_view:
        pc, _ = two_view_triangulate(bd)
    else:
        # bug-compatible reference error (last-view^2/numLines) so the
        # variance cutoff reproduces the golden filtered sets
        pc, _ = n_view_triangulate(bd, reference_error_mode=True)
    errors = pc.errors
    valid = matches.mask & pc.mask

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, matches.capacity, shape=(sample_count,), p=probs)
    sample = errors[idx]
    mean = jnp.mean(sample)
    var = jnp.mean((sample - mean) ** 2)
    cutoff = sigma * jnp.sqrt(var)

    keep = valid & (errors <= cutoff)
    return _with_mask(matches, keep)


@partial(jax.jit, static_argnames=("two_view", "k"))
def planar_cutoff_filter(
    matches: MatchSet,
    cameras: Cameras,
    cutoff: float,
    two_view: bool = True,
    k: int = 10, pushbrooms=None,) -> MatchSet:
    """Drop tracks whose triangulated point lies further than ``cutoff`` from
    the scene's estimated plane (planarCutoffFilter,
    PointCloudFactory.cu:3653-3828): triangulate, estimate the dominant plane
    from octree-neighbourhood normals (camera-facing average) + the cloud
    centroid, flag bundles beyond the point-plane distance
    (filterTwoViewFromEstimatedPlane / filterNView..., :4333-4455)."""
    from ssrlcv_tpu.mesh import octree as oc

    bd = generate_bundles(matches, cameras, pushbrooms=pushbrooms)
    if two_view:
        pc, _ = two_view_triangulate(bd)
    else:
        pc, _ = n_view_triangulate(bd)
    valid = matches.mask & pc.mask

    tree = oc.build_octree(pc.points, valid)
    normals = oc.compute_normals(tree, cameras.cam_pos, k=k)
    w = tree.mask[:, None].astype(normals.dtype)
    avg_normal = jnp.sum(normals * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    avg_normal = avg_normal / jnp.maximum(jnp.linalg.norm(avg_normal), 1e-12)
    wp = valid[:, None].astype(pc.points.dtype)
    avg_point = jnp.sum(pc.points * wp, axis=0) / jnp.maximum(jnp.sum(wp), 1.0)

    dist = jnp.abs(jnp.sum((pc.points - avg_point) * avg_normal, axis=1))
    keep = valid & (dist <= cutoff)
    return _with_mask(matches, keep)


def reduce_bundle_set(matches: MatchSet, fraction: float) -> MatchSet:
    """Keep a deterministic fraction of valid tracks (reduceBundleSet,
    PointCloudFactory.cu:3830-3891): every k-th valid track survives."""
    jump = max(int(round(1.0 / max(fraction, 1e-9))), 1)
    order = jnp.cumsum(matches.mask.astype(jnp.int32)) - 1
    keep = matches.mask & (order % jump == 0)
    return _with_mask(matches, keep)


def compact_matchset(matches: MatchSet) -> MatchSet:
    """Host-side physical compaction (stable order), mirroring the
    reference's CPU keypoint/match rewrite (PointCloudFactory.cu:3178-3273).
    Returns a new MatchSet whose valid tracks are densely packed at the
    front; capacity is preserved (static shapes)."""
    import numpy as np

    mask = np.asarray(matches.mask)
    idx = np.nonzero(mask)[0]
    cap = matches.capacity

    def pack(x):
        x = np.asarray(x)
        out = np.zeros_like(x)
        out[: len(idx)] = x[idx]
        return jnp.asarray(out)

    new_mask = np.zeros(cap, bool)
    new_mask[: len(idx)] = True
    return MatchSet(
        kp_loc=pack(matches.kp_loc),
        kp_parent=pack(matches.kp_parent),
        num_views=pack(matches.num_views),
        mask=jnp.asarray(new_mask),
    )
