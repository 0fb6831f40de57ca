"""Dense SIFT and dense Window_NxN patch descriptors.

Re-design of the reference's dense paths:

  * dense SIFT (generateFeatures dense=true, SIFT_FeatureFactory.cu:32-54 +
    createFeatures :171-230): a descriptor at every interior pixel (12 px
    SIFTBORDER) of the min-max-normalised image, orientation window
    ceil(3*1.5)=5 and descriptor window ceil(6)=6 at unit sigma — exactly
    the windows our sigma-parameterised machinery produces for sigma=1,
    pixel_width=1.
  * Window_NxN SAD patch descriptors (Feature.cuh:96-130,
    FeatureFactory generateNxNWindows): the raw NxN pixel patch at every
    interior pixel; matching uses sum-of-absolute-differences.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from ssrlcv_tpu.core import pytree as struct

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu.core.types import FeatureSet
from ssrlcv_tpu.features.descriptor import fill_descriptors
from ssrlcv_tpu.features.detector import SSKeyPoints
from ssrlcv_tpu.features.orientation import compute_orientations
from ssrlcv_tpu.ops import image_ops as ops

WINDOW_SIZES = (3, 9, 15, 25, 31)  # the reference's Window_NxN instantiations


def _interior_grid(h: int, w: int, border: int):
    ys, xs = np.meshgrid(
        np.arange(border, h - border), np.arange(border, w - border), indexing="ij"
    )
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1).astype(np.float32)


@partial(jax.jit, static_argnames=("params", "w_or", "h", "w"))
def _dense_orientation_field(grads, params: SIFTParams, w_or: int, h: int, w: int):
    """Orientation assignment for EVERY interior pixel as pure stencil
    compute — the dense path's replacement for the per-keypoint
    histogram gather (computeThetas, FeatureFactory.cu:1004-1120, at
    dense=true fixed sigma=1 / pixel_width=1).

    Because the window (±ceil(3·λ_o)=±5) and Gaussian width are the SAME at
    every pixel, the 36-bin weighted histogram field is 36 separable
    11-tap convolutions of mag·[bin==b] — lowered as shifted multiply-adds
    (ops.convolve_separable_symmetric).  Peak
    finding + parabola interpolation then run vectorised over the whole
    field.  No gather, no per-keypoint work.

    Values match _histogram_for_keypoints up to f32 reassociation (the
    separable exp(-dx²/c)·exp(-dy²/c) vs the gather path's fused
    exp(-(dx²+dy²)/c) and the conv accumulation order), so borderline
    threshold/peak ties can flip — the same nondeterminism class the golden
    fixtures already tolerate.

    Returns (theta, ok) flat over (interior pixels × max_orientations) in
    the emission order of compute_orientations: kp-major, orientations in
    descending histogram magnitude.
    """
    lam = params.orientation_contrib_width
    b = params.border
    gx, gy = grads[..., 0], grads[..., 1]
    mag = jnp.sqrt(gx * gx + gy * gy)
    rad10 = jnp.pi / 18.0
    ang = jnp.mod(jnp.arctan2(gy, gx) + 2.0 * jnp.pi, 2.0 * jnp.pi)
    bins = jnp.clip(jnp.floor(ang / rad10).astype(jnp.int32), 0, 35)

    denom = 2.0 * lam * lam  # sigma = 1, pixel_width = 1
    offs = np.arange(-w_or, w_or + 1, dtype=np.float64)
    taps = np.exp(-(offs * offs) / denom).astype(np.float32)

    planes = []
    for bi in range(36):
        f = jnp.where(bins == bi, mag, 0.0)
        # shared shifted-add separable conv; the border mode is unobservable
        # for interior pixels (border=12 > w_or=5), which are all this field
        # is sliced to below
        y = ops.convolve_separable_symmetric(f, taps)
        planes.append(y[b : h - b, b : w - b])
    hist = jnp.stack(planes)  # (36, Hi, Wi) — bin-major: all per-bin math
    # below is elementwise over whole planes

    # peak finding + parabola interpolation, identical formulas to
    # compute_orientations' process() body (orientation.py:151-168)
    prev = jnp.roll(hist, 1, axis=0)
    nxt = jnp.roll(hist, -1, axis=0)
    maxh = jnp.max(hist, axis=0, keepdims=True) * params.orientation_threshold
    is_peak = (hist >= maxh) & (hist >= prev) & (hist >= nxt)
    dd = prev - 2.0 * hist + nxt
    off = jnp.where(jnp.abs(dd) > 0, (prev - nxt) / dd, 0.0)
    bc = (np.arange(36, dtype=np.float64) * np.pi / 18.0).astype(np.float32)
    theta = jnp.mod(
        off * np.float32(np.pi / 36.0) + bc[:, None, None] + np.float32(2.0 * np.pi),
        np.float32(2.0 * np.pi),
    )
    mags = jnp.where(is_peak, hist, -jnp.inf)

    # top-m in descending magnitude via iterative argmax over the bin-major
    # axis; the per-pixel theta select is 36 elementwise wheres, not a gather
    thetas, oks = [], []
    for _ in range(params.max_orientations):
        sel = jnp.argmax(mags, axis=0)  # ties -> lowest bin, like lax.top_k
        top = jnp.max(mags, axis=0)
        th = jnp.zeros_like(top)
        for b2 in range(36):
            th = jnp.where(sel == b2, theta[b2], th)
        thetas.append(th)
        oks.append(top > 0.0)  # drops zero-magnitude slots + -inf no-peak
        mags = jnp.where(
            sel[None, :, :] == jnp.arange(36, dtype=jnp.int32)[:, None, None],
            -jnp.inf,
            mags,
        )
    theta_f = jnp.stack(thetas, axis=-1).reshape(-1)  # kp-major, then ori
    ok_f = jnp.stack(oks, axis=-1).reshape(-1)
    return theta_f, ok_f


@partial(jax.jit, static_argnames=("params", "h", "w", "cap"))
def _dense_compact(theta_f, ok_f, params: SIFTParams, h: int, w: int, cap: int):
    """Device-side stable compaction of the oriented dense field into
    fixed-capacity keypoint arrays (loc, theta, mask) — the interior grid is
    rebuilt on device (iota), so nothing crosses the host link.

    Compaction is ONE multi-operand lax.sort on position-or-sentinel keys
    (no argsort + flat gathers of the ~2M dense slots).  cap may exceed the
    slot count (capacity quantisation at near-saturated images): inputs are
    padded first so the [:cap] slices always have cap rows."""
    b = params.border
    m = params.max_orientations
    wi = w - 2 * b
    hi = h - 2 * b
    xs = jnp.broadcast_to(jnp.arange(b, w - b, dtype=jnp.float32)[None, :], (hi, wi))
    ys = jnp.broadcast_to(jnp.arange(b, h - b, dtype=jnp.float32)[:, None], (hi, wi))
    loc_x = jnp.repeat(xs.reshape(-1), m)
    loc_y = jnp.repeat(ys.reshape(-1), m)
    n = theta_f.shape[0]
    if cap > n:
        pad = cap - n
        theta_f = jnp.pad(theta_f, (0, pad))
        ok_f = jnp.pad(ok_f, (0, pad))
        loc_x = jnp.pad(loc_x, (0, pad))
        loc_y = jnp.pad(loc_y, (0, pad))
        n = cap
    key = jnp.where(ok_f, jnp.arange(n, dtype=jnp.int32), jnp.int32(2**31 - 1))
    _, lx, ly, th, ok = jax.lax.sort(
        (key, loc_x, loc_y, theta_f, ok_f), dimension=0, num_keys=1,
        is_stable=True)
    return (jnp.stack([lx[:cap], ly[:cap]], axis=1), th[:cap], ok[:cap])


@partial(jax.jit, static_argnames=("params", "w_de", "chunk"))
def _dense_describe(grads_plane, loc, theta, mask, image_id,
                    params: SIFTParams, w_de: int, chunk: int = 4096):
    """Descriptor pass + FeatureSet assembly for the compacted dense
    keypoints — one device program, output stays device-resident."""
    cap = loc.shape[0]
    kps = SSKeyPoints(
        blur=jnp.zeros(cap, jnp.int32),
        loc=loc,
        intensity=jnp.zeros(cap, jnp.float32),
        sigma=jnp.ones(cap, jnp.float32),
        theta=theta,
        mask=mask,
    )
    desc, loc_image = fill_descriptors(
        grads_plane[None], kps, 1.0, params, chunk=chunk, w_max=w_de)
    return FeatureSet(
        loc=jnp.where(mask[:, None], loc_image, -1.0),
        sigma=jnp.where(mask, 1.0, 0.0),
        theta=jnp.where(mask, theta, 0.0),
        descriptors=jnp.where(mask[:, None], desc, 0),
        mask=mask,
        parent=jnp.broadcast_to(jnp.asarray(image_id, jnp.int32), (cap,)),
    )


def generate_dense_sift(
    pixels: np.ndarray | jax.Array,
    params: SIFTParams | None = None,
    image_id: int = -1,
    chunk: int = 4096,
    fast: bool | None = None,
) -> FeatureSet:
    """Dense SIFT: one (or up to max_orientations) descriptor per interior
    pixel of the normalised image (SIFT_FeatureFactory.cu:32-54 dense=true).

    fast=True (the default) computes orientations as a 36-bin stencil field
    (no gather) and keeps everything device-resident; the descriptor pass
    gathers per keypoint as the sparse path does.  fast=False is the
    original per-keypoint gather path, kept as the cross-check oracle
    (tests/test_dense.py)."""
    params = params or SIFTParams()
    pixels = jnp.asarray(pixels)
    if pixels.ndim == 3:
        pixels = ops.to_bw(pixels)
    h, w = int(pixels.shape[0]), int(pixels.shape[1])
    if fast is None:
        fast = True

    img = ops.normalize_minmax(ops.to_float(pixels))
    w_or = int(np.ceil(3.0 * params.orientation_contrib_width))      # 5
    w_de = int(np.ceil(params.descriptor_contrib_width))             # 6

    if fast:
        from ssrlcv_tpu.features.sift import _quantize_cap

        # the orientation field is sliced to the interior, so its stencil
        # never reads the symmetric-border values
        if params.border <= w_or:
            raise ValueError(
                f"dense SIFT needs border > orientation window: "
                f"{params.border} <= {w_or}")
        grads_plane = ops.pixel_gradients(img)  # (H, W, 2)
        theta_f, ok_f = _dense_orientation_field(grads_plane, params, w_or, h, w)
        n = int(np.asarray(jnp.sum(ok_f.astype(jnp.int32))))  # one scalar sync
        cap = _quantize_cap(n)
        loc, theta, mask = _dense_compact(theta_f, ok_f, params, h, w, cap)
        return _dense_describe(grads_plane, loc, theta, mask,
                               jnp.int32(image_id), params, w_de, chunk=chunk)

    grads = ops.pixel_gradients(img)[None]  # (1, H, W, 2)

    locs = _interior_grid(h, w, params.border)
    n = len(locs)
    kps = SSKeyPoints(
        blur=jnp.zeros(n, jnp.int32),
        loc=jnp.asarray(locs),
        intensity=jnp.zeros(n, jnp.float32),
        sigma=jnp.ones(n, jnp.float32),
        theta=jnp.zeros(n, jnp.float32),
        mask=jnp.ones(n, bool),
    )
    oriented = compute_orientations(grads, kps, 1.0, params, chunk=chunk, w_max=w_or)
    desc, loc_image = fill_descriptors(grads, oriented, 1.0, params, chunk=chunk, w_max=w_de)

    m = np.asarray(oriented.mask)
    sel = np.nonzero(m)[0]
    k = len(sel)
    cap = max(((k + 127) // 128) * 128, 128)
    out = FeatureSet.empty(cap, parent=image_id)
    return FeatureSet(
        loc=out.loc.at[:k].set(jnp.asarray(np.asarray(loc_image)[sel])),
        sigma=out.sigma.at[:k].set(jnp.asarray(np.asarray(oriented.sigma)[sel])),
        theta=out.theta.at[:k].set(jnp.asarray(np.asarray(oriented.theta)[sel])),
        descriptors=out.descriptors.at[:k].set(jnp.asarray(np.asarray(desc)[sel])),
        mask=out.mask.at[:k].set(True),
        parent=out.parent,
    )


@struct.dataclass
class WindowFeatures:
    """Dense NxN patch descriptors (pytree — flows through the jitted
    matcher family exactly like FeatureSet, mirroring the reference's
    MatchFactory<Window_NxN> instantiations, MatchFactory.cu:7-12).

    descriptors: (K, N*N) uint8 raw patches; loc: (K, 2).
    """

    loc: jax.Array
    descriptors: jax.Array
    mask: jax.Array
    window: int = struct.field(pytree_node=False, default=9)

    @property
    def capacity(self):
        return self.loc.shape[0]


@partial(jax.jit, static_argnames=("window",))
def _extract_patches(pixels: jax.Array, window: int):
    """All NxN patches of the image as (H-N+1)*(W-N+1) rows (x-major like
    the reference's per-pixel windows)."""
    h, w = pixels.shape
    half = window // 2
    patches = jnp.stack(
        [
            pixels[dy : h - window + 1 + dy, dx : w - window + 1 + dx]
            for dy in range(window)
            for dx in range(window)
        ],
        axis=-1,
    )  # (H-N+1, W-N+1, N*N)
    return patches.reshape(-1, window * window)


def generate_window_features(pixels: np.ndarray | jax.Array, window: int = 9, image_id: int = -1) -> WindowFeatures:
    """generateNxNWindows analogue: the raw patch at every interior pixel."""
    assert window in WINDOW_SIZES, f"window must be one of {WINDOW_SIZES}"
    pixels = jnp.asarray(pixels)
    if pixels.ndim == 3:
        pixels = ops.to_bw(pixels)
    h, w = int(pixels.shape[0]), int(pixels.shape[1])
    half = window // 2
    desc = _extract_patches(pixels, window)
    locs = _interior_grid(h, w, half)[: desc.shape[0]]
    # interior grid rows match patch rows: both row-major over the valid area
    return WindowFeatures(
        loc=jnp.asarray(locs),
        descriptors=desc,
        mask=jnp.ones(desc.shape[0], bool),
        window=window,
    )


@partial(jax.jit, static_argnames=("chunk",))
def sad_best_target(q_desc: jax.Array, t_desc: jax.Array, t_valid: jax.Array, chunk: int = 256):
    """Per-query best target under sum-of-absolute-differences — the
    Window_NxN distProtocol (Feature.cuh:96-130).  Chunked: L1 has no
    matrix-product factorisation, so each chunk is a broadcast-reduce."""
    nq = q_desc.shape[0]
    n_chunks = (nq + chunk - 1) // chunk
    pad = n_chunks * chunk - nq
    qp = jnp.pad(q_desc, ((0, pad), (0, 0)))

    t = t_desc.astype(jnp.int32)

    def body(qc):
        q = qc.astype(jnp.int32)
        d = jnp.sum(jnp.abs(q[:, None, :] - t[None, :, :]), axis=-1).astype(jnp.float32)
        d = jnp.where(t_valid[None, :], d, jnp.inf)
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
        return idx, best

    idx, dist = jax.lax.map(body, qp.reshape(n_chunks, chunk, -1))
    return idx.reshape(-1)[:nq], dist.reshape(-1)[:nq]
