"""Keypoint orientation assignment.

Re-design of computeThetas + expandKeyPoints
(FeatureFactory.cu:1004-1120): a 36-bin gradient-orientation histogram with
Gaussian distance weighting, parabola-interpolated circular peaks, and up to
``max_orientations`` oriented copies per keypoint.

The per-keypoint CUDA loop becomes a dense gather of a fixed
(2*W_MAX+1)^2 sample grid (masked to each keypoint's true window) and a
set of per-bin masked reductions — no scatter.  Gradients here are the
gradients of the *normalised DoG response* for the keypoint's blur slice,
exactly as the reference computes them (Blur::computeGradients on the DoG
scale space, FeatureFactory.cu:45-54 after conversion).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu.features.detector import SSKeyPoints


def max_window(params: SIFTParams) -> int:
    """Static bound on the orientation window half-width: sigma/pixel_width
    is octave-independent (both scale with 2^o), max refined sigma index is
    blurs-3 + 0.5."""
    ratio = (params.initial_sigma / 0.5) * params.blur_sigma_multiplier ** (
        params.blurs_per_octave - 3 + 0.5
    )
    return int(math.ceil(3.0 * params.orientation_contrib_width * ratio))


def _histogram_for_keypoints(
    grads: jax.Array,        # (B, H, W, 2) per-DoG-slice gradients
    blur: jax.Array,         # (K,)
    loc: jax.Array,          # (K, 2)
    sigma: jax.Array,        # (K,)
    mask: jax.Array,         # (K,)
    pixel_width: float,
    lambda_o: float,
    w_max: int,
):
    """36-bin weighted orientation histograms, (K, 36), plus the
    border-validity flag (window inside image, computeThetas:1017-1023)."""
    h, w = grads.shape[-3], grads.shape[-2]
    win = jnp.ceil(sigma * 3.0 * lambda_o / pixel_width)  # float, per kp

    inside = (
        (loc[:, 0] - win >= 0.0)
        & (loc[:, 1] - win >= 0.0)
        & (loc[:, 0] + win < w - 1)
        & (loc[:, 1] + win < h - 1)
    )
    valid = mask & inside

    s = 2 * w_max + 1
    offs = jnp.arange(s, dtype=jnp.float32) - w_max  # -W..W
    dx = offs[None, :]  # (1, S)
    dy = offs[:, None]  # (S, 1)
    in_win = (jnp.abs(dx) <= win[:, None, None]) & (jnp.abs(dy) <= win[:, None, None])

    cx = jnp.round(loc[:, 0]).astype(jnp.int32)
    cy = jnp.round(loc[:, 1]).astype(jnp.int32)
    xi = jnp.clip(cx[:, None, None] + offs.astype(jnp.int32)[None, None, :], 0, w - 1)
    yi = jnp.clip(cy[:, None, None] + offs.astype(jnp.int32)[None, :, None], 0, h - 1)
    bi = blur[:, None, None]
    g = grads[bi, yi, xi]  # (K, S, S, 2)
    g_x, g_y = g[..., 0], g[..., 1]

    mag = jnp.sqrt(g_x ** 2 + g_y ** 2)
    denom = 2.0 * lambda_o * lambda_o * sigma * sigma
    wgt = mag * jnp.exp(-(dx * dx + dy * dy)[None] / denom[:, None, None])
    wgt = jnp.where(in_win, wgt, 0.0)

    rad10 = jnp.pi / 18.0
    ang = jnp.mod(jnp.arctan2(g_y, g_x) + 2.0 * jnp.pi, 2.0 * jnp.pi)
    bins = jnp.clip(jnp.floor(ang / rad10).astype(jnp.int32), 0, 35)
    # 36 fused masked reductions instead of materialising a (K,S,S,36)
    # one-hot tensor (orders of magnitude less device-memory traffic)
    hist = jnp.stack(
        [jnp.sum(jnp.where(bins == b, wgt, 0.0), axis=(1, 2)) for b in range(36)],
        axis=1,
    )
    return hist, valid


def peaks_from_histograms(hist: jax.Array, valid: jax.Array, params: SIFTParams):
    """Peak finding + parabola interpolation over (K, 36) histograms
    (computeThetas:1075-1090): returns (top_theta, top_ok) each
    (K, max_orientations), thetas in descending histogram magnitude."""
    # circular neighbours
    prev = jnp.roll(hist, 1, axis=1)
    nxt = jnp.roll(hist, -1, axis=1)
    maxh = jnp.max(hist, axis=1, keepdims=True) * params.orientation_threshold
    is_peak = (hist >= maxh) & (hist >= prev) & (hist >= nxt)

    denom = prev - 2.0 * hist + nxt
    off = jnp.where(jnp.abs(denom) > 0, (prev - nxt) / denom, 0.0)
    bcenters = jnp.arange(36, dtype=hist.dtype) * (jnp.pi / 18.0)
    theta = jnp.mod(off * (jnp.pi / 36.0) + bcenters[None, :] + 2.0 * jnp.pi, 2.0 * jnp.pi)

    mags = jnp.where(is_peak, hist, -jnp.inf)
    top_mags, top_idx = jax.lax.top_k(mags, params.max_orientations)
    top_theta = jnp.take_along_axis(theta, top_idx, axis=1)
    # reference drops zero-magnitude slots (bestMagWThetas[i].x == 0)
    top_ok = (top_mags > 0.0) & jnp.isfinite(top_mags) & valid[:, None]
    return top_theta, top_ok


def compute_orientations(
    grads: jax.Array,
    kps: SSKeyPoints,
    pixel_width: float,
    params: SIFTParams,
    chunk: int = 1024,
    w_max: int | None = None,
) -> SSKeyPoints:
    """Expand keypoints to <= max_orientations oriented copies each.

    Output capacity = input capacity * max_orientations, ordered
    (kp0 t0, kp0 t1, kp1 t0, ...) with thetas per keypoint in descending
    histogram magnitude — the reference's emission order
    (computeThetas best-list + thrust::remove compaction)."""
    k = kps.capacity
    if w_max is None:
        w_max = max_window(params)

    def process(chunk_kps):
        blur, loc, sigma, mask = chunk_kps
        hist, valid = _histogram_for_keypoints(
            grads, blur, loc, sigma, mask, pixel_width,
            params.orientation_contrib_width, w_max,
        )
        return peaks_from_histograms(hist, valid, params)

    blur, loc, sigma, mask = kps.blur, kps.loc, kps.sigma, kps.mask
    n_chunks = (k + chunk - 1) // chunk
    pad = n_chunks * chunk - k

    def pad0(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    stacked = (
        pad0(blur).reshape(n_chunks, chunk),
        pad0(loc).reshape(n_chunks, chunk, 2),
        pad0(sigma).reshape(n_chunks, chunk),
        pad0(mask).reshape(n_chunks, chunk),
    )
    thetas, ok = jax.lax.map(process, stacked)
    thetas = thetas.reshape(-1, params.max_orientations)[:k]
    ok = ok.reshape(-1, params.max_orientations)[:k]

    m = params.max_orientations
    rep = lambda x: jnp.repeat(x, m, axis=0)
    return SSKeyPoints(
        blur=rep(kps.blur),
        loc=rep(kps.loc),
        intensity=rep(kps.intensity),
        sigma=rep(kps.sigma),
        theta=thetas.reshape(-1),
        mask=ok.reshape(-1),
    )
