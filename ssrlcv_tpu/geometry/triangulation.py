"""Triangulation: 2-view skew-line midpoint and N-view least-squares.

Re-design of the reference's triangulation kernel family
(PointCloudFactory.cu:4457-5293).  One fused, jit-compiled function per
variant over the padded (T, V) bundle tensor; the reference's
shared-memory/atomicAdd error reductions become a single deterministic
``jnp.sum`` (so, unlike the CUDA original, results are reproducible
bit-for-bit run to run).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ssrlcv_tpu.core.types import Bundles, PointCloud


def _cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt):
    """Closest points s1, s2 of two skew lines (the Wikipedia construction
    replicated from computeTwoViewTriangulate, PointCloudFactory.cu:4457-4487).
    """
    cr = _cross(l1_vec, l2_vec)
    n2 = _cross(l2_vec, cr)
    n1 = _cross(l1_vec, cr)
    numer1 = jnp.sum((l2_pnt - l1_pnt) * n2, axis=-1)
    numer2 = jnp.sum((l1_pnt - l2_pnt) * n1, axis=-1)
    denom1 = jnp.sum(l1_vec * n2, axis=-1)
    denom2 = jnp.sum(l2_vec * n1, axis=-1)
    s1 = l1_pnt + (numer1 / denom1)[..., None] * l1_vec
    s2 = l2_pnt + (numer2 / denom2)[..., None] * l2_vec
    return s1, s2


def _masked_safe_lines(bundles: Bundles):
    """Substitute well-conditioned skew lines for masked (padding) tracks.

    Padded tracks carry identical zero keypoints in both views, so their rays
    coincide and the midpoint math divides 0/0.  The forward NaN would be
    masked away, but reverse-mode AD multiplies the zero cotangent by the NaN
    partial (0 * nan = nan) and poisons the whole BA gradient — so the mask
    must cut the data flow *before* the singularity.  Valid tracks pass
    through untouched (bit-identical to the unguarded math)."""
    m = bundles.mask[:, None]
    e1 = jnp.array([1.0, 0.0, 0.0], bundles.vec.dtype)
    e2 = jnp.array([0.0, 1.0, 0.0], bundles.vec.dtype)
    e3 = jnp.array([0.0, 0.0, 1.0], bundles.vec.dtype)
    l1_vec = jnp.where(m, bundles.vec[:, 0], e1)
    l2_vec = jnp.where(m, bundles.vec[:, 1], e2)
    l1_pnt = jnp.where(m, bundles.pnt[:, 0], 0.0)
    l2_pnt = jnp.where(m, bundles.pnt[:, 1], e3)
    return l1_vec, l1_pnt, l2_vec, l2_pnt


@jax.jit
def two_view_triangulate(bundles: Bundles, cutoff: jax.Array | float = jnp.inf) -> tuple[PointCloud, jax.Array]:
    """2-view skew-line midpoint triangulation with linear error.

    Returns (PointCloud, total_linear_error).  Per-point error is
    ||s1 - s2||^2 ("linear error", the reference's reprojection-error analog,
    PointCloudFactory.cu:4531); points with error > cutoff are masked out
    exactly as the cutoff kernel flags ``bundle.invalid``
    (PointCloudFactory.cu:4601-4680).
    """
    l1_vec, l1_pnt, l2_vec, l2_pnt = _masked_safe_lines(bundles)
    s1, s2 = two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt)
    point = (s1 + s2) / 2.0
    err = jnp.sum((s1 - s2) ** 2, axis=-1)
    valid = bundles.mask & (err <= cutoff)
    err_masked = jnp.where(bundles.mask, err, 0.0)
    total = jnp.sum(jnp.where(valid, err_masked, 0.0))
    return PointCloud(points=point, errors=err_masked, mask=valid), total


@partial(jax.jit, static_argnames=("reference_error_mode",))
def n_view_triangulate(bundles: Bundles, reference_error_mode: bool = False) -> tuple[PointCloud, jax.Array]:
    """N-view least-squares line intersection.

    Replicates computeNViewTriangulate (PointCloudFactory.cu:4880-5293):
    S = sum_i (v_i v_i^T - I), C = sum_i (v_i v_i^T - I) p_i, point = S^-1 C,
    over each track's valid views.  Singular S marks the track invalid.

    Per-point error is the mean squared point-line distance over the track's
    views.  (The reference kernel overwrites instead of accumulating inside
    its error loop — PointCloudFactory.cu:4986-5005 — so it effectively
    reports last-view-distance^2 / numLines; we compute the evident intent,
    the mean.)

    Returns (PointCloud, total_angular_error).
    """
    v = bundles.vec / jnp.maximum(jnp.linalg.norm(bundles.vec, axis=-1, keepdims=True), 1e-20)
    view_mask = (
        jnp.arange(bundles.vec.shape[1])[None, :] < bundles.num_views[:, None]
    )  # (T, V)
    w = view_mask[..., None].astype(v.dtype)

    vvT = jnp.einsum("tvi,tvj->tvij", v, v, precision="highest")  # (T, V, 3, 3)
    eye = jnp.eye(3, dtype=v.dtype)
    tmp = (vvT - eye) * w[..., None]
    S = jnp.sum(tmp, axis=1)                                   # (T, 3, 3)
    C = jnp.sum(jnp.einsum("tvij,tvj->tvi", tmp, bundles.pnt * w, precision="highest"), axis=1)

    det = jnp.linalg.det(S)
    ok = jnp.abs(det) > 1e-20
    S_safe = jnp.where(ok[:, None, None], S, eye)
    point = jnp.linalg.solve(S_safe, C[..., None]).squeeze(-1)
    point = jnp.where(ok[:, None], point, 0.0)

    # mean squared point-line distance over valid views
    p1 = bundles.pnt
    p2 = bundles.pnt + v * 1000.0
    a = point[:, None, :] - p1
    b = point[:, None, :] - p2
    c = p2 - p1
    d = _cross(a, b)
    dist = jnp.linalg.norm(d, axis=-1) / jnp.maximum(jnp.linalg.norm(c, axis=-1), 1e-20)
    sq = (dist ** 2) * view_mask
    nv = jnp.maximum(bundles.num_views.astype(v.dtype), 1.0)
    if reference_error_mode:
        # bug-compatible: the reference's error loop overwrites instead of
        # accumulating (PointCloudFactory.cu:4986-5005), so the reported
        # per-point error is (last view's squared distance) / numLines
        last = jnp.maximum(bundles.num_views - 1, 0)
        err = jnp.take_along_axis(sq, last[:, None], axis=1)[:, 0] / nv
    else:
        err = jnp.sum(sq, axis=1) / nv

    valid = bundles.mask & ok
    err = jnp.where(valid, err, 0.0)
    total = jnp.sum(err)
    return PointCloud(points=point, errors=err, mask=valid), total


@partial(jax.jit, static_argnames=("two_view",))
def triangulate(bundles: Bundles, two_view: bool, cutoff: jax.Array | float = jnp.inf):
    """Dispatch matching the pipeline's 2-view/N-view switch (Pipeline.cu:271)."""
    if two_view:
        return two_view_triangulate(bundles, cutoff)
    return n_view_triangulate(bundles)


@partial(jax.jit, static_argnames=("two_view",))
def triangulate_matches(matches, cameras, two_view: bool = True,
                        cutoff: jax.Array | float = jnp.inf, pushbrooms=None):
    """Bundle generation + triangulation fused into ONE jitted program.

    The reference runs this as a single kernel pass (generateBundles then
    computeTwoViewTriangulate back-to-back, PointCloudFactory.cu:4166/4493);
    dispatching `generate_bundles` and `triangulate` as two separate jit
    programs costs an extra host->device round trip per call — call sites
    should use this instead.
    """
    from ssrlcv_tpu.geometry.bundles import generate_bundles

    bd = generate_bundles(matches, cameras, pushbrooms=pushbrooms)
    if two_view:
        return two_view_triangulate(bd, cutoff)
    return n_view_triangulate(bd)


def linear_error_objective(bundles: Bundles) -> jax.Array:
    """Differentiable total linear error — the 2-view BA objective
    (what voidTwoViewTriangulate accumulates, PointCloudFactory.cu:4766-4878).
    """
    l1_vec, l1_pnt, l2_vec, l2_pnt = _masked_safe_lines(bundles)
    s1, s2 = two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt)
    err = jnp.sum((s1 - s2) ** 2, axis=-1)
    return jnp.sum(jnp.where(bundles.mask, err, 0.0))
