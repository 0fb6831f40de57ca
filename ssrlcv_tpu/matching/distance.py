"""Descriptor distance computation as integer matrix products.

The reference matcher assigns one 32-thread warp per query feature and scans
every target feature serially (matchFeaturesBruteForce family,
MatchFactory.cu:1462-1700).  Here the O(Nq*Nt) scan becomes
matrix algebra:

    ||q - t||^2 = ||q||^2 + ||t||^2 - 2 q.t^T

where the cross-term is a (Nq, 128) @ (128, Nt) matmul (s8 x s8 -> s32,
which tensor cores run natively).
uint8 descriptors are nibble-split into four int8 matmuls with int32
accumulation, so distances are *exact* integers — bit-identical to the
reference's distProtocol float sums (Feature.cuh:89; integer values < 2^24).

Queries stream through in chunks so only a (chunk, Nt) distance tile ever
materialises; the optional constraint mask is generated per chunk (epipolar
predicates), never as a full (Nq, Nt) matrix.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def _cross_term(q: jax.Array, t: jax.Array) -> jax.Array:
    """Exact integer q @ t^T for uint8 descriptors via nibble splitting:
    q.t = 256*qh.th + 16*(qh.tl + ql.th) + ql.tl — four int8 matmuls."""
    qh = (q >> 4).astype(jnp.int8)
    ql = (q & 15).astype(jnp.int8)
    th = (t >> 4).astype(jnp.int8)
    tl = (t & 15).astype(jnp.int8)

    def mm(a, b):
        return jax.lax.dot_general(
            a, b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    return 256 * mm(qh, th) + 16 * (mm(qh, tl) + mm(ql, th)) + mm(ql, tl)


def distance_matrix(q_desc: jax.Array, t_desc: jax.Array) -> jax.Array:
    """(Nq, 128) x (Nt, 128) uint8 -> (Nq, Nt) int32 exact squared-L2."""
    q = q_desc.astype(jnp.int32)
    t = t_desc.astype(jnp.int32)
    qn = jnp.sum(q * q, axis=1)
    tn = jnp.sum(t * t, axis=1)
    cross = _cross_term(q_desc, t_desc)
    return qn[:, None] + tn[None, :] - 2 * cross


def sad_matrix(q_desc: jax.Array, t_desc: jax.Array) -> jax.Array:
    """(Nq, D) x (Nt, D) uint8 -> (Nq, Nt) int32 exact sum-of-absolute-
    differences — the Window_NxN distProtocol (Feature.cuh:96-130).  L1 has
    no matrix-product factorisation, so this is a broadcast-reduce."""
    q = q_desc.astype(jnp.int32)
    t = t_desc.astype(jnp.int32)
    return jnp.sum(jnp.abs(q[:, None, :] - t[None, :, :]), axis=-1)


def best_target_chunked(
    q_desc: jax.Array,
    t_desc: jax.Array,
    t_valid: jax.Array,
    mask_fn: Optional[Callable] = None,
    mask_aux: Optional[tuple] = None,
    chunk: int = 1024,
    metric: str = "l2sq",
):
    """argmin over targets per query.

    mask_fn(aux_chunk) -> (chunk, Nt) bool of allowed targets; ``mask_aux``
    is a tuple of per-query arrays chunked alongside the descriptors (e.g.
    epipolar segment endpoints).  Returns (best_idx int32, best_dist f32);
    disallowed/invalid targets are +inf, ties resolve to the lowest target
    index.  metric: 'l2sq' (SIFT distProtocol, Feature.cuh:89) or 'sad'
    (Window_NxN distProtocol, Feature.cuh:96-130).
    """
    nq = q_desc.shape[0]
    n_chunks = (nq + chunk - 1) // chunk
    pad = n_chunks * chunk - nq

    def pad0(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    def chunked(x):
        return pad0(x).reshape((n_chunks, chunk) + x.shape[1:])

    aux = tuple(chunked(a) for a in (mask_aux or ()))
    dist_fn = {"l2sq": distance_matrix, "sad": sad_matrix}[metric]

    def body(xs):
        qc = xs[0]
        d = dist_fn(qc, t_desc).astype(jnp.float32)
        bad = ~t_valid[None, :]
        if mask_fn is not None:
            bad = bad | ~mask_fn(*xs[1:])
        d = jnp.where(bad, jnp.inf, d)
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
        return idx, best

    idx, dist = jax.lax.map(body, (chunked(q_desc),) + aux)
    return idx.reshape(-1)[:nq], dist.reshape(-1)[:nq]


@partial(jax.jit, static_argnames=("chunk", "metric"))
def min_distance(q_desc: jax.Array, t_desc: jax.Array, t_valid: jax.Array,
                 chunk: int = 1024, metric: str = "l2sq"):
    """Per-query minimum distance to any valid target — the seed-distance
    pass (getSeedMatchDistances, MatchFactory.cu:1432-1461)."""
    _, dist = best_target_chunked(q_desc, t_desc, t_valid, chunk=chunk, metric=metric)
    return dist
