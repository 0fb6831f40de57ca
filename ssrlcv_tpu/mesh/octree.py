"""Morton-code point-cloud octree.

Re-design of the reference Octree (Octree.cuh:35-244, Octree.cu): points
are normalised into the unit cube, given interleaved-bit Morton keys at a
target depth (getNodeKeys, Octree.cu:1975), sorted, and uniqued into node
buckets; coarser depths derive by key >> 3.  Instead of the reference's
pointer-linked node/vertex/edge/face arrays, this layout keeps
sorted-key + segment-offset tensors, and neighbourhood queries are key
arithmetic + searchsorted — all static-shape friendly.

Downstream consumers (normals, density filters, implicit surface) only need
k-nearest-neighbour gathers, which are built here from the sorted Morton
ordering: candidate neighbours come from a +-window in Morton order, which
for smooth clouds is a superset-enough approximation refined by true
distance sort.  An exact brute-force fallback covers small clouds.

Accuracy (measured, pinned in tests/test_hierarchy.py): on a 12k-point
terrain cloud at k=6 / window=32 the Morton-window distances average ~1.22x
the exact kNN distances (median 1.0 — most queries are exact, the tail
crosses Morton discontinuities).  Quality-sensitive consumers should prefer
``hierarchy.knn_neighborhood`` (true 27-neighbourhood gather, <1.02x exact).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _expand_bits(v: jax.Array) -> jax.Array:
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (classic Morton interleave helper)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & jnp.uint32(0x30000FF)
    v = (v | (v << 8)) & jnp.uint32(0x300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x30C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x9249249)
    return v


def morton_keys(points: jax.Array, bbox_min: jax.Array, bbox_max: jax.Array, depth: int) -> jax.Array:
    """30-bit Morton keys at the given depth (10 bits/axis max)."""
    scale = (2 ** depth) / jnp.maximum(bbox_max - bbox_min, 1e-12)
    g = jnp.clip(((points - bbox_min) * scale).astype(jnp.int32), 0, 2 ** depth - 1)
    g = g.astype(jnp.uint32)
    key = (
        _expand_bits(g[:, 0])
        | (_expand_bits(g[:, 1]) << 1)
        | (_expand_bits(g[:, 2]) << 2)
    )
    # shift so the key uses exactly 3*depth bits
    return (key >> jnp.uint32(0)).astype(jnp.uint32)


class Octree(NamedTuple):
    """Sorted-point octree: points reordered by Morton key."""

    points: jax.Array      # (N, 3) sorted by key
    keys: jax.Array        # (N,) uint32 Morton keys (sorted)
    order: jax.Array       # (N,) original indices of the sorted points
    mask: jax.Array        # (N,) validity of each sorted slot
    bbox_min: jax.Array    # (3,)
    bbox_max: jax.Array    # (3,)
    depth: int


@partial(jax.jit, static_argnames=("depth",))
def build_octree(points: jax.Array, mask: jax.Array, depth: int = 8) -> Octree:
    """Build the sorted Morton structure (createFinestNodes analogue,
    Octree.cu:356-410).  Invalid points sort to the end (key = max)."""
    big = jnp.where(mask[:, None], points, jnp.inf)
    bbox_min = jnp.min(jnp.where(mask[:, None], points, jnp.inf), axis=0)
    bbox_max = jnp.max(jnp.where(mask[:, None], points, -jnp.inf), axis=0)
    keys = morton_keys(points, bbox_min, bbox_max, depth)
    keys = jnp.where(mask, keys, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(keys)
    return Octree(
        points=points[order],
        keys=keys[order],
        order=order.astype(jnp.int32),
        mask=mask[order],
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        depth=depth,
    )


@partial(jax.jit, static_argnames=("k", "window"))
def knn(tree: Octree, k: int = 8, window: int = 32):
    """Approximate k-nearest neighbours per point from a +-window in Morton
    order, refined by true distance (the replacement for the reference's
    27-neighbourhood node walks, Octree.cuh:178-185).

    Returns (neighbor_idx (N, k) into the *sorted* order, neighbor_dist (N, k)).
    """
    n = tree.points.shape[0]
    offs = jnp.arange(-window, window + 1)
    raw = jnp.arange(n)[:, None] + offs[None, :]
    in_range = (raw >= 0) & (raw < n)                    # (N, 2W+1)
    idx = jnp.clip(raw, 0, n - 1)
    cand = tree.points[idx]                              # (N, 2W+1, 3)
    d = jnp.linalg.norm(cand - tree.points[:, None, :], axis=-1)
    self_mask = offs[None, :] == 0
    valid = in_range & tree.mask[idx] & tree.mask[:, None] & ~self_mask
    d = jnp.where(valid, d, jnp.inf)
    neg_d, nbr = jax.lax.top_k(-d, k)
    nbr_idx = jnp.take_along_axis(idx, nbr, axis=1).astype(jnp.int32)
    return nbr_idx, -neg_d


def knn_exact(points: jax.Array, mask: jax.Array, k: int = 8, chunk: int = 1024):
    """Exact brute-force kNN (tiled); for validation and small clouds."""
    n = points.shape[0]
    n_chunks = (n + chunk - 1) // chunk
    pad = n_chunks * chunk - n
    pp = jnp.pad(points, ((0, pad), (0, 0)))

    def body(pc):
        d = jnp.linalg.norm(pc[:, None, :] - points[None, :, :], axis=-1)
        d = jnp.where(mask[None, :], d, jnp.inf)
        # mask self-distance
        d = jnp.where(d == 0.0, jnp.inf, d)
        neg, idx = jax.lax.top_k(-d, k)
        return idx.astype(jnp.int32), -neg

    idx, dist = jax.lax.map(body, pp.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1, k)[:n], dist.reshape(-1, k)[:n]


@partial(jax.jit, static_argnames=("k", "window"))
def average_neighbor_distances(tree: Octree, k: int = 8, window: int = 32) -> jax.Array:
    """Mean distance to the k nearest neighbours per point
    (averageNeighboorDistances, Octree.cuh:178-185)."""
    _, d = knn(tree, k=k, window=window)
    finite = jnp.isfinite(d)
    return jnp.sum(jnp.where(finite, d, 0.0), axis=1) / jnp.maximum(
        jnp.sum(finite, axis=1), 1
    )


@partial(jax.jit, static_argnames=("k", "window"))
def compute_normals(
    tree: Octree,
    camera_positions: jax.Array,  # (C, 3)
    k: int = 8,
    window: int = 32,
) -> jax.Array:
    """Per-point normals via neighbourhood covariance eigen-analysis with
    camera-facing disambiguation (Octree normal computation,
    Octree.cu:1373-1412 — cuSOLVER SVD becomes a batched 3x3 eigh).

    Returns (N, 3) unit normals in sorted order.
    """
    nbr_idx, _ = knn(tree, k=k, window=window)
    nbrs = tree.points[nbr_idx]                      # (N, k, 3)
    mean = jnp.mean(nbrs, axis=1, keepdims=True)
    centered = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered, precision="highest")
    w, v = jnp.linalg.eigh(cov)
    normals = v[:, :, 0]                             # smallest-eigenvalue vector
    # orient toward the mean camera position
    cam_mean = jnp.mean(camera_positions, axis=0)
    to_cam = cam_mean[None, :] - tree.points
    flip = jnp.sum(normals * to_cam, axis=1) < 0
    normals = jnp.where(flip[:, None], -normals, normals)
    return normals / jnp.maximum(jnp.linalg.norm(normals, axis=1, keepdims=True), 1e-12)


@partial(jax.jit, static_argnames=("k", "window"))
def remove_low_density_points(tree: Octree, sigma: float = 3.0, k: int = 8, window: int = 32):
    """Mask points whose mean neighbour distance exceeds sigma stddevs of the
    population (removeLowDensityPoints, Octree.cuh:194)."""
    avg = average_neighbor_distances(tree, k=k, window=window)
    m = tree.mask
    mu = jnp.sum(jnp.where(m, avg, 0.0)) / jnp.maximum(jnp.sum(m), 1)
    var = jnp.sum(jnp.where(m, (avg - mu) ** 2, 0.0)) / jnp.maximum(jnp.sum(m), 1)
    keep = m & (avg <= mu + sigma * jnp.sqrt(var))
    return tree._replace(mask=keep)


def node_counts(tree: Octree, depth: int) -> np.ndarray:
    """Host-side: number of unique occupied nodes at a coarser depth
    (bottom-up coarse levels, Octree.cu:410-500)."""
    shift = 3 * (tree.depth - depth)
    keys = np.asarray(tree.keys)[np.asarray(tree.mask)]
    return np.unique(keys >> np.uint32(shift)).size


_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)
# 12 cube edges as corner-index pairs
_CUBE_EDGES = np.array(
    [[0, 1], [2, 3], [4, 5], [6, 7],
     [0, 2], [1, 3], [4, 6], [5, 7],
     [0, 4], [1, 5], [2, 6], [3, 7]], np.int64)


def octree_wireframe(tree: Octree, level: int | None = None):
    """Host-side: unique occupied node cubes at `level` as deduplicated corner
    vertices + 12 edges per node — the vertex/edge arrays the reference builds
    on device (Octree.cuh:147-165) and streams via io::ply::Writer
    (io_fmt_ply.cuh:17-37).  Returns (vertices (V, 3) f32, edges (E, 2) i64).
    """
    level = tree.depth if level is None else level
    m = np.asarray(tree.mask)
    pts = np.asarray(tree.points)[m]
    bmin = np.asarray(tree.bbox_min)
    bmax = np.asarray(tree.bbox_max)
    n_cells = 2 ** level
    cell = np.maximum(bmax - bmin, 1e-12) / n_cells
    grid = np.clip(((pts - bmin) / cell).astype(np.int64), 0, n_cells - 1)
    nodes = np.unique(grid, axis=0)                       # (M, 3) occupied cells
    corners = nodes[:, None, :] + _CUBE_CORNERS[None]     # (M, 8, 3) lattice coords
    flat = corners.reshape(-1, 3)
    verts_lattice, inv = np.unique(flat, axis=0, return_inverse=True)
    corner_idx = inv.reshape(-1, 8)                       # (M, 8) dedup'd ids
    edges = corner_idx[:, _CUBE_EDGES].reshape(-1, 2)     # (M*12, 2)
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    vertices = (verts_lattice * cell[None, :] + bmin[None, :]).astype(np.float32)
    return vertices, edges


def write_octree_ply(path_prefix: str, tree: Octree, level: int | None = None):
    """Write <prefix>_points.ply / <prefix>_wireframe.ply (writeVertexPLY /
    writeEdgePLY, Octree.cuh:238-243)."""
    from ssrlcv_tpu.io.ply import write_ply, write_ply_edges

    m = np.asarray(tree.mask)
    p1 = write_ply(path_prefix + "_points.ply", np.asarray(tree.points)[m])
    v, e = octree_wireframe(tree, level)
    p2 = write_ply_edges(path_prefix + "_wireframe.ply", v, e)
    return p1, p2
