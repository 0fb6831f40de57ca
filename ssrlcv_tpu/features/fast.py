"""FAST corner detector (features/fast).

The reference declares `FAST_FeatureFactory` as an empty roadmap stub
(include/need_implementing/FAST_FeatureFactory.cuh) — this module supplies a
working implementation, going beyond the reference's surface.

FAST-N (Rosten & Drummond 2006): a pixel p is a corner when >= N contiguous
pixels on the 16-pixel Bresenham circle of radius 3 are all brighter than
p + t or all darker than p - t.  The whole detector is expressed as 16
static shifts + elementwise logic + a 3x3 max-pool NMS, so it compiles to a
single fused XLA program with no gathers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# 16-pixel Bresenham circle, radius 3, clockwise from 12 o'clock
# (dy, dx) offsets
_CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    np.int32,
)


def _shifted_ring(img: jax.Array) -> jax.Array:
    """(H, W) -> (H, W, 16): the circle pixel values at each center.  Static
    rolls keep this gather-free (shifts fuse into the surrounding program)."""
    return jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _CIRCLE],
        axis=-1,
    )


@partial(jax.jit, static_argnames=("threshold", "arc_length", "capacity"))
def detect_fast(
    img: jax.Array,
    threshold: float = 20.0,
    arc_length: int = 9,
    capacity: int = 4096,
):
    """Detect FAST corners on a grayscale (H, W) image.

    Returns (locs (capacity, 2) float32 xy, scores (capacity,), mask
    (capacity,)) — fixed-capacity padded outputs in descending-score order,
    the same masked-tensor convention the SIFT front end uses.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    ring = _shifted_ring(img)                        # (H, W, 16)
    d = ring - img[..., None]
    bright = (d > threshold).astype(jnp.float32)
    dark = (d < -threshold).astype(jnp.float32)

    # contiguous-arc test: wrap the 16 flags and take a rolling product of
    # length `arc_length`; any window of all-ones => corner
    def has_arc(flags):
        wrapped = jnp.concatenate([flags, flags[..., : arc_length - 1]], axis=-1)
        acc = jnp.zeros(img.shape, jnp.float32)
        for s in range(16):
            win = wrapped[..., s : s + arc_length]
            acc = jnp.maximum(acc, jnp.prod(win, axis=-1))
        return acc > 0.5

    is_corner = has_arc(bright) | has_arc(dark)

    # score: sum |d| over pixels exceeding the threshold (OpenCV-style proxy)
    score = jnp.sum(jnp.where(jnp.abs(d) > threshold, jnp.abs(d) - threshold, 0.0), axis=-1)
    score = jnp.where(is_corner, score, 0.0)

    # 3x3 non-max suppression via shifted maxima (no reduce_window needed).
    # Ties break lexicographically: a pixel loses to an equal-scoring
    # neighbour that precedes it in raster order, so exactly one of a tied
    # pair survives.
    keep = is_corner & (score > 0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            # roll(score, (dy, dx)) at p holds score[p - (dy, dx)], i.e. the
            # neighbour at offset (-dy, -dx); it precedes p in raster order
            # when -dy < 0 or (-dy == 0 and -dx < 0).
            shifted = jnp.roll(score, (dy, dx), axis=(0, 1))
            precedes = (-dy < 0) or (dy == 0 and -dx < 0)
            keep = keep & ((score > shifted) if precedes else (score >= shifted))

    # border reject (circle radius 3)
    yy, xx = jnp.mgrid[0:h, 0:w]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    keep = keep & interior

    flat_score = jnp.where(keep, score, -1.0).reshape(-1)
    k = min(capacity, h * w)
    top_score, top_idx = jax.lax.top_k(flat_score, k)
    if k < capacity:  # pad back to the requested fixed capacity
        top_score = jnp.concatenate([top_score, jnp.full(capacity - k, -1.0)])
        top_idx = jnp.concatenate([top_idx, jnp.zeros(capacity - k, top_idx.dtype)])
    mask = top_score > 0
    locs = jnp.stack(
        [(top_idx % w).astype(jnp.float32), (top_idx // w).astype(jnp.float32)],
        axis=-1,
    )
    locs = jnp.where(mask[:, None], locs, 0.0)
    return locs, jnp.where(mask, top_score, 0.0), mask
