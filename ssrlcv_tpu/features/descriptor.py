"""SIFT descriptor generation.

Re-design of the fillDescriptors kernel
(SIFT_FeatureFactory.cu:475-549): each oriented keypoint gathers gradients
on an integer lattice rotated into its orientation frame, trilinearly
distributes magnitude-weighted contributions over a 4x4 spatial x 8
orientation histogram grid, and the 128-vector is two-pass L2-normalised with
a 0.2 clamp and quantised to uint8.

The reference's one-4x4x8-thread-block-per-keypoint + shared-memory atomics
becomes a dense (samples x cells x bins) weighted tensor contraction per
keypoint chunk — deterministic, no atomics, and one batched contraction
per chunk.

Reference quirks replicated on purpose:
  * the Gaussian weight uses the window width, not sigma
    (SIFT_FeatureFactory.cu:507);
  * gradient angles are taken relative to theta via sign-preserving fmod, so
    angles in (-pi, 0) can occur and only contribute near bin 0
    (SIFT_FeatureFactory.cu:508);
  * the angular distance to bin centres is not wrapped at 2*pi
    (SIFT_FeatureFactory.cu:519-523).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu.features.detector import SSKeyPoints


def max_desc_window(params: SIFTParams) -> int:
    ratio = (params.initial_sigma / 0.5) * params.blur_sigma_multiplier ** (
        params.blurs_per_octave - 3 + 0.5
    )
    return int(math.ceil(params.descriptor_contrib_width * ratio))


def descriptor_epilogue(v: jax.Array, mask: jax.Array) -> jax.Array:
    """Two-pass L2 normalise + 0.2 clamp + uint8 quantise of raw (K, 128)
    histograms (SIFT_FeatureFactory.cu:533-545); dead slots zeroed."""
    n1 = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
    v = jnp.minimum(v / jnp.maximum(n1, 1e-20), 0.2)
    n2 = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
    v = jnp.round(255.0 * v / jnp.maximum(n2, 1e-20))
    desc = jnp.clip(v, 0, 255).astype(jnp.uint8)
    return jnp.where(mask[:, None], desc, 0)


def fill_descriptors(
    grads: jax.Array,       # (B, H, W, 2) normalised-DoG gradients
    kps: SSKeyPoints,       # oriented keypoints (theta filled)
    pixel_width: float,
    params: SIFTParams,
    chunk: int = 512,
    w_max: int | None = None,
):
    """Returns (descriptors (K, 128) uint8, loc_image (K, 2) float32).

    loc_image = octave loc * pixel_width (absolute image coordinates,
    SIFT_FeatureFactory.cu:545).
    """
    h, w = grads.shape[-3], grads.shape[-2]
    if w_max is None:
        w_max = max_desc_window(params)
    s = 2 * w_max + 1
    offs = jnp.arange(s, dtype=jnp.float32) - w_max
    dxg, dyg = jnp.meshgrid(offs, offs, indexing="xy")  # (S, S) sample lattice
    dx = dxg.reshape(-1)
    dy = dyg.reshape(-1)  # (S2,)
    lam = params.descriptor_contrib_width
    rad45 = jnp.pi / 4.0

    # static 4x4 cell center grid in units of windowWidth
    nx = (jnp.arange(4, dtype=jnp.float32) * 0.5 - 0.75)  # (4,)
    cell_x = jnp.tile(nx, 4)                                # cells flattened (16,) x-major?
    cell_y = jnp.repeat(nx, 4)
    # NOTE: reference iterates nx outer, ny inner but bins are indexed
    # [nx][ny][k] and written to values[(ty*4+tx)*8+tz] => value index
    # (ny*4 + nx)*8 + k.  We flatten cells as c = ny*4 + nx below.
    cell_x = jnp.tile(nx, 4)        # c = ny*4 + nx -> x varies fastest
    cell_y = jnp.repeat(nx, 4)

    def process(chunk_kps):
        blur, loc, sigma, theta, mask = chunk_kps
        win = jnp.ceil(sigma * lam / pixel_width)  # (C,) float
        ct = jnp.cos(theta)[:, None]
        st = jnp.sin(theta)[:, None]
        # rotated sample offsets (contribLoc = R(theta) @ (dx, dy))
        cxs = dx[None, :] * ct - dy[None, :] * st  # (C, S2)
        cys = dx[None, :] * st + dy[None, :] * ct
        in_lattice = (jnp.abs(dx)[None, :] <= win[:, None]) & (
            jnp.abs(dy)[None, :] <= win[:, None]
        )
        in_rot = (jnp.abs(cxs) <= win[:, None]) & (jnp.abs(cys) <= win[:, None])
        valid_s = in_lattice & in_rot  # (C, S2)

        xi = jnp.clip(jnp.round(cxs + loc[:, 0:1]).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(cys + loc[:, 1:2]).astype(jnp.int32), 0, h - 1)
        g = grads[blur[:, None], yi, xi]  # (C, S2, 2)
        g_x, g_y = g[..., 0], g[..., 1]
        mag = jnp.sqrt(g_x ** 2 + g_y ** 2)
        wgt = mag * jnp.exp(-(cxs * cxs + cys * cys) / (2.0 * win[:, None] ** 2))
        ang = jnp.fmod(
            jnp.arctan2(g_y, g_x) - theta[:, None] + 2.0 * jnp.pi,
            2.0 * jnp.pi,
        )  # sign-preserving fmod like C fmodf
        wgt = jnp.where(valid_s, wgt, 0.0)

        # rotated cell centres (C, 16)
        hx0 = cell_x[None, :] * win[:, None]
        hy0 = cell_y[None, :] * win[:, None]
        hx = hx0 * ct - hy0 * st
        hy = hx0 * st + hy0 * ct
        binw = win[:, None, None] / 2.0
        ddx = jnp.abs(hx[:, None, :] - cxs[:, :, None])  # (C, S2, 16)
        ddy = jnp.abs(hy[:, None, :] - cys[:, :, None])
        in_cell = (ddx <= binw) & (ddy <= binw)
        wx = 1.0 - ddx / binw
        wy = 1.0 - ddy / binw
        spatial = jnp.where(in_cell, wx * wy, 0.0) * wgt[:, :, None]  # (C, S2, 16)

        kk = jnp.arange(8, dtype=jnp.float32) * rad45
        adist = jnp.abs(ang[:, :, None] - kk[None, None, :])  # (C, S2, 8)
        wang = jnp.where(adist < rad45, 1.0 - adist / rad45, 0.0)

        hist = jnp.einsum(
            "scb,sck->sbk", spatial, wang, precision=jax.lax.Precision.HIGHEST
        )  # (C, 16, 8) — c:=chunk index s, b:=cell, k:=angle bin
        v = hist.reshape(hist.shape[0], 128)

        return descriptor_epilogue(v, mask)

    k = kps.capacity
    n_chunks = (k + chunk - 1) // chunk
    pad = n_chunks * chunk - k

    def pad0(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    stacked = (
        pad0(kps.blur).reshape(n_chunks, chunk),
        pad0(kps.loc).reshape(n_chunks, chunk, 2),
        pad0(kps.sigma).reshape(n_chunks, chunk),
        pad0(kps.theta).reshape(n_chunks, chunk),
        pad0(kps.mask).reshape(n_chunks, chunk),
    )
    desc = jax.lax.map(process, stacked).reshape(-1, 128)[:k]
    loc_image = kps.loc * pixel_width
    return desc, loc_image
