"""2-D quadtree over localized data.

Re-design of the reference Quadtree (Quadtree.cuh:44-220): a generic
2-D spatial index over ``LocalizedData<T>`` (data items with float2
locations).  The reference builds pointer-linked node hierarchies; here the
structure is a sorted 2-D Morton ordering with per-depth node extents —
the same design as the 3-D octree (mesh/octree.py), sharing its windowed
neighbourhood queries.  (The reference compiles this but no pipeline stage
references it — SURVEY.md §2.3; provided for API parity and feature lookup.)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _expand_bits_2d(v: jax.Array) -> jax.Array:
    """Spread the low 16 bits with one zero bit between each."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & jnp.uint32(0x00FF00FF)
    v = (v | (v << 4)) & jnp.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & jnp.uint32(0x33333333)
    v = (v | (v << 1)) & jnp.uint32(0x55555555)
    return v


def morton_keys_2d(locs: jax.Array, bbox_min: jax.Array, bbox_max: jax.Array, depth: int) -> jax.Array:
    scale = (2 ** depth) / jnp.maximum(bbox_max - bbox_min, 1e-12)
    g = jnp.clip(((locs - bbox_min) * scale).astype(jnp.int32), 0, 2 ** depth - 1).astype(jnp.uint32)
    return _expand_bits_2d(g[:, 0]) | (_expand_bits_2d(g[:, 1]) << 1)


class Quadtree(NamedTuple):
    locs: jax.Array     # (N, 2) sorted by Morton key
    keys: jax.Array     # (N,) uint32
    order: jax.Array    # (N,) original indices
    mask: jax.Array     # (N,)
    bbox_min: jax.Array
    bbox_max: jax.Array
    depth: int


@partial(jax.jit, static_argnames=("depth",))
def build_quadtree(locs: jax.Array, mask: jax.Array, depth: int = 10) -> Quadtree:
    bbox_min = jnp.min(jnp.where(mask[:, None], locs, jnp.inf), axis=0)
    bbox_max = jnp.max(jnp.where(mask[:, None], locs, -jnp.inf), axis=0)
    keys = morton_keys_2d(locs, bbox_min, bbox_max, depth)
    keys = jnp.where(mask, keys, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(keys)
    return Quadtree(
        locs=locs[order], keys=keys[order], order=order.astype(jnp.int32),
        mask=mask[order], bbox_min=bbox_min, bbox_max=bbox_max, depth=depth,
    )


@partial(jax.jit, static_argnames=("k", "window"))
def knn_2d(tree: Quadtree, k: int = 8, window: int = 32):
    """Windowed kNN in Morton order (the reference's node-neighbourhood
    lookups, Quadtree.cuh:150-220)."""
    n = tree.locs.shape[0]
    offs = jnp.arange(-window, window + 1)
    raw = jnp.arange(n)[:, None] + offs[None, :]
    in_range = (raw >= 0) & (raw < n)
    idx = jnp.clip(raw, 0, n - 1)
    cand = tree.locs[idx]
    d = jnp.linalg.norm(cand - tree.locs[:, None, :], axis=-1)
    valid = in_range & tree.mask[idx] & tree.mask[:, None] & (offs[None, :] != 0)
    d = jnp.where(valid, d, jnp.inf)
    neg_d, nbr = jax.lax.top_k(-d, k)
    return jnp.take_along_axis(idx, nbr, axis=1).astype(jnp.int32), -neg_d


def node_counts_2d(tree: Quadtree, depth: int) -> int:
    """Unique occupied nodes at a coarser depth."""
    shift = 2 * (tree.depth - depth)
    keys = np.asarray(tree.keys)[np.asarray(tree.mask)]
    return int(np.unique(keys >> np.uint32(shift)).size)
