"""Image-space primitives for the scale-space front end.

Vectorised jnp re-implementations of the reference's per-pixel CUDA kernels
(Image.cuh:593-622): float conversion, min-max normalisation, 2x bin /
bilinear upsample with symmetric borders, separable Gaussian convolution, and
central-difference gradients.  Everything operates on (H, W) float32 maps and
fuses under jit.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def to_float(pixels: jax.Array) -> jax.Array:
    """uint8 -> float32, value-preserving 0..255 (convertToFltImage,
    Image.cu:1554 — no /255 scaling)."""
    return pixels.astype(jnp.float32)


def to_bw(pixels: jax.Array) -> jax.Array:
    """(H, W, C) -> (H, W) via the reference's channel mix: RGB uses
    r/4 + g/2 + b/4 in integer math (rgbToBW, Image.cu:1257)."""
    if pixels.ndim == 2:
        return pixels
    c = pixels.shape[-1]
    if c == 3 or c == 4:
        p = pixels.astype(jnp.int32)
        return (p[..., 0] // 4 + p[..., 1] // 2 + p[..., 2] // 4).astype(jnp.uint8)
    return pixels[..., 0]


def normalize_minmax(img: jax.Array) -> jax.Array:
    """Min-max normalise to [0, 1] (normalizeImage, Image.cu:1560)."""
    lo = jnp.min(img)
    hi = jnp.max(img)
    return (img - lo) / (hi - lo)


def bin2x(img: jax.Array) -> jax.Array:
    """2x downsample by 2x2 averaging (binImage, Image.cu float variant)."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def _symmetrize_coords(idx: jax.Array, l: int) -> jax.Array:
    """Symmetric (reflect-with-edge-repeat) coordinate wrap
    (getSymmetrizedCoord, Image.cu:1248)."""
    ll = 2 * l
    i = (idx + ll) % ll
    return jnp.where(i > l - 1, ll - 1 - i, i)


def upsample2x(img: jax.Array) -> jax.Array:
    """2x bilinear upsample (upsampleImage, Image.cu:1393): output (i, j)
    samples input at (i/2, j/2) with floor/floor+1 symmetric taps."""
    h, w = img.shape
    i = jnp.arange(2 * w)
    j = jnp.arange(2 * h)
    x = i * 0.5
    y = j * 0.5
    xm = _symmetrize_coords(x.astype(jnp.int32), w)
    xp = _symmetrize_coords(x.astype(jnp.int32) + 1, w)
    ym = _symmetrize_coords(y.astype(jnp.int32), h)
    yp = _symmetrize_coords(y.astype(jnp.int32) + 1, h)
    fx = (x - jnp.floor(x))[None, :]
    fy = (y - jnp.floor(y))[:, None]
    p_mm = img[ym][:, xm]
    p_mp = img[ym][:, xp]
    p_pm = img[yp][:, xm]
    p_pp = img[yp][:, xp]
    return (
        fx * fy * p_pp
        + (1 - fx) * fy * p_pm
        + fx * (1 - fy) * p_mp
        + (1 - fx) * (1 - fy) * p_mm
    )


def to_rgb(pixels: jax.Array) -> jax.Array:
    """(H, W) grayscale -> (H, W, 3) by channel replication (convertToRGB,
    Image.cuh:597 bwToRGB)."""
    if pixels.ndim == 3:
        return pixels
    return jnp.repeat(pixels[..., None], 3, axis=-1)


def scale_image(img: jax.Array, out_shape: tuple[int, int]) -> jax.Array:
    """Arbitrary-factor bilinear rescale (scaleImage, Image.cuh:600 /
    bilinearInterpolation kernel): output (i, j) samples the input at
    (i*H/H', j*W/W') with symmetric-border floor/floor+1 taps, matching the
    upsample2x tap scheme.  out_shape is static so the gather fuses under jit.
    """
    h, w = img.shape
    oh, ow = out_shape
    x = jnp.arange(ow) * (w / ow)
    y = jnp.arange(oh) * (h / oh)
    xm = _symmetrize_coords(jnp.floor(x).astype(jnp.int32), w)
    xp = _symmetrize_coords(jnp.floor(x).astype(jnp.int32) + 1, w)
    ym = _symmetrize_coords(jnp.floor(y).astype(jnp.int32), h)
    yp = _symmetrize_coords(jnp.floor(y).astype(jnp.int32) + 1, h)
    fx = (x - jnp.floor(x))[None, :]
    fy = (y - jnp.floor(y))[:, None]
    p_mm = img[ym][:, xm]
    p_mp = img[ym][:, xp]
    p_pm = img[yp][:, xm]
    p_pp = img[yp][:, xp]
    return (
        fx * fy * p_pp
        + (1 - fx) * fy * p_pm
        + fx * (1 - fy) * p_mp
        + (1 - fx) * (1 - fy) * p_mm
    )


def gaussian_kernel_1d(sigma: float, pixel_width: float, base_size: int = 8) -> np.ndarray:
    """The reference Blur kernel (FeatureFactory.cu:15-33): tap count
    ceil(base*sigma/pixel_width) bumped to odd; taps are the *unnormalised*
    continuous Gaussian exp(-x^2/2s^2)/(sqrt(2 pi) s) sampled at integers.
    Static (host) computation — sizes must be compile-time constants."""
    k = int(math.ceil(base_size * sigma / pixel_width))
    if k % 2 == 0:
        k += 1
    half = k // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    taps = np.exp(-(x * x) / 2.0 / sigma / sigma) / math.sqrt(2.0 * math.pi) / sigma
    return taps.astype(np.float32)


def convolve_separable_symmetric(img: jax.Array, taps: np.ndarray) -> jax.Array:
    """Separable 2-D convolution with symmetric border (convolveSeparable +
    getSymmetrizedCoord).  The kernel is symmetric so convolution ==
    correlation.

    Lowered as shifted multiply-adds rather than lax.conv: the slice+FMA
    form fuses into one elementwise pass per axis, and its accumulation
    order over taps matches the reference's scalar loop exactly."""
    half = len(taps) // 2
    h, w = img.shape
    # symmetric pad then valid conv; jnp.pad 'symmetric' matches the
    # reference's reflect-with-edge-repeat coordinates for pads <= dim
    pad = jnp.pad(img, ((0, 0), (half, half)), mode="symmetric")
    x = jnp.zeros_like(img)
    for t, tap in enumerate(taps):
        x = x + img.dtype.type(tap) * jax.lax.slice(pad, (0, t), (h, t + w))
    pad = jnp.pad(x, ((half, half), (0, 0)), mode="symmetric")
    y = jnp.zeros_like(img)
    for t, tap in enumerate(taps):
        y = y + img.dtype.type(tap) * jax.lax.slice(pad, (t, 0), (t + h, w))
    return y


def pixel_gradients(img: jax.Array) -> jax.Array:
    """Central-difference gradients, shifted to one-sided at the borders
    (calculatePixelGradients, Image.cu:1583).  Returns (H, W, 2) = (gx, gy).

    Interior: g = p[i+1] - p[i-1]; at border the whole stencil shifts inward
    (e.g. x=0 uses p[2] - p[0])."""
    h, w = img.shape
    xs = jnp.arange(w)
    ys = jnp.arange(h)
    xp = jnp.clip(xs + 1, None, w - 1) + jnp.where(xs == 0, 1, 0)
    xm = jnp.clip(xs - 1, 0, None) + jnp.where(xs == w - 1, -1, 0)
    # careful: reference shifts BOTH taps at the border:
    # x==0   -> (p[2]-p[0])? no: xContrib={1,-1}; if m==-1 both +=1 -> {2,0}
    # x==W-1 -> {W-1,W-3}
    xp = jnp.where(xs == 0, 2, jnp.where(xs == w - 1, w - 1, xs + 1))
    xm = jnp.where(xs == 0, 0, jnp.where(xs == w - 1, w - 3, xs - 1))
    yp = jnp.where(ys == 0, 2, jnp.where(ys == h - 1, h - 1, ys + 1))
    ym = jnp.where(ys == 0, 0, jnp.where(ys == h - 1, h - 3, ys - 1))
    gx = img[:, xp] - img[:, xm]
    gy = img[yp, :] - img[ym, :]
    return jnp.stack([gx, gy], axis=-1)


def make_binnable_shape(h: int, w: int, planned_depth: int) -> tuple[int, int, tuple[int, int]]:
    """Host-side: compute the padded shape makeBinnable (Image.cu:966) would
    produce for binning to `planned_depth`.  Returns (H', W', border)."""
    num_resize = 2 ** planned_depth
    bh = 0 if h % num_resize == 0 else (num_resize - h % num_resize) // 2
    bw = 0 if w % num_resize == 0 else (num_resize - w % num_resize) // 2
    return h + 2 * bh, w + 2 * bw, (bh, bw)


def add_buffer_border(img: jax.Array, border: tuple[int, int]) -> jax.Array:
    """Zero border padding (addBufferBorder) used by makeBinnable."""
    bh, bw = border
    return jnp.pad(img, ((bh, bh), (bw, bw)))
