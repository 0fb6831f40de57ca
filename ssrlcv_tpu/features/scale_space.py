"""Gaussian scale space + difference-of-Gaussians pyramid.

Re-design of the reference ScaleSpace (FeatureFactory.cu:338-440).
Per octave the six blurs form an *incremental* chain — each Blur convolves
the previous blur's output with the full sigma_b kernel (the Blur ctor
mutates the shared pixel buffer, FeatureFactory.cu:11-44) — and each octave
seeds from the 2x-binned output of the previous octave's blur index
numBlurs-3 (keepPixelsAfterBlur = numBlurs-2, FeatureFactory.cu:404).

Pipeline order replicated exactly:
  1. uchar pixels -> float (0..255, no scaling)
  2. makeBinnable pad (images already divisible by 2^(octaves+start) skip)
  3. one 2x bilinear upsample per negative starting octave
  4. per octave: blur chain; bin blur[numBlurs-3] for the next octave;
     then min-max normalise each blur in place (Octave::normalize)
  5. DoG: dog[b] = blur[b+1] - blur[b] over the *normalised* blurs
     (convertToDOG, FeatureFactory.cu:404-440)
  6. findKeyPoints later re-normalises each DoG slice after raw-value
     extrema detection (see detector.py)

Shapes are static per octave, so the whole pyramid jits into one XLA
computation of chained separable convolutions.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu.ops import image_ops as ops


class Octave(NamedTuple):
    """One octave of the (DoG) scale space."""

    dog_raw: jax.Array      # (B-1, H, W) raw DoG values (extrema detection)
    dog_norm: jax.Array     # (B-1, H, W) min-max normalised DoG (refinement+)
    sigmas: tuple           # per-DoG-slice sigma (= gaussian blur sigma b)
    pixel_width: float


def octave_sigmas(params: SIFTParams, octave_index: int) -> list[float]:
    """Absolute sigmas of the gaussian blurs in one octave:
    sigma_b = initial * blur_mult^b, scaled by octave_mult^octave."""
    s0 = params.initial_sigma * (params.octave_sigma_multiplier ** octave_index)
    return [s0 * (params.blur_sigma_multiplier ** b) for b in range(params.blurs_per_octave)]


def _build_octave_blurs(pixels: jax.Array, sigmas: list[float], pixel_width: float, kernel_base: int):
    """Incremental blur chain: I_b = G(sigma_b) * I_{b-1}."""
    blurs = []
    cur = pixels
    for s in sigmas:
        taps = ops.gaussian_kernel_1d(s, pixel_width, kernel_base)
        cur = ops.convolve_separable_symmetric(cur, taps)
        blurs.append(cur)
    return blurs


@partial(jax.jit, static_argnames=("params", "height", "width"))
def build_scale_space(pixels_u8: jax.Array, params: SIFTParams, height: int, width: int):
    """uint8 (H, W) image -> list of Octave pytrees (one per octave).

    The returned tuple has static length = params.num_octaves; octave i has
    pixel width 2^(starting_octave + i) relative to the input image.
    """
    img = ops.to_float(pixels_u8)

    planned = params.starting_octave + params.num_octaves
    h, w = height, width
    # makeBinnable: pad (+bin) only when not divisible (Image.cu:966); the
    # everest-class inputs are powers of two so this is usually a no-op.
    nh, nw, border = ops.make_binnable_shape(h, w, max(planned, 0))
    if (nh, nw) != (h, w):
        img = ops.add_buffer_border(img, border)
        img = ops.bin2x(img)
        h, w = nh // 2, nw // 2

    pixel_width = 1.0
    for _ in range(-params.starting_octave):
        img = ops.upsample2x(img)
        h, w = h * 2, w * 2
        pixel_width /= 2.0
    for _ in range(max(params.starting_octave, 0)):
        img = ops.bin2x(img)
        h, w = h // 2, w // 2
        pixel_width *= 2.0

    octaves = []
    cur = img
    keep = params.blurs_per_octave - 2
    for o in range(params.num_octaves):
        sigmas = octave_sigmas(params, o)
        blurs = _build_octave_blurs(cur, sigmas, pixel_width, params.kernel_size[0])
        if o + 1 < params.num_octaves:
            # next octave seeds from blur[keep-1] (the last blur of the
            # mutated chain buffer), binned 2x
            cur = ops.bin2x(blurs[keep - 1])
        # Octave::normalize(): min-max each gaussian blur before DoG
        normed = [ops.normalize_minmax(b) for b in blurs]
        dog = jnp.stack([normed[b + 1] - normed[b] for b in range(len(blurs) - 1)])
        # findKeyPoints-time normalisation of each DoG slice (used by
        # refinement/edges/orientation/descriptors)
        lo = jnp.min(dog, axis=(1, 2), keepdims=True)
        hi = jnp.max(dog, axis=(1, 2), keepdims=True)
        dog_norm = (dog - lo) / (hi - lo)
        octaves.append(
            Octave(
                dog_raw=dog,
                dog_norm=dog_norm,
                sigmas=tuple(sigmas[:-1]),
                pixel_width=pixel_width,
            )
        )
        pixel_width *= 2.0
    return tuple(octaves)
