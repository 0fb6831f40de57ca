"""SIFT feature generation — the full front end.

Re-design of SIFT_FeatureFactory::generateFeatures
(SIFT_FeatureFactory.cu:17-169): DoG scale space -> keypoint detection ->
descriptor-border check -> orientation assignment -> descriptor fill,
aggregated across octaves into one fixed-capacity FeatureSet.

Per-image work is one jit-compiled program per octave shape; all ragged
compaction is masked.  Feature ordering follows the reference: octave-major,
then blur bucket, then detection order (host-side stable grouping at the
aggregation step).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ssrlcv_tpu.backend import device_path
from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu.core.types import FeatureSet
from ssrlcv_tpu.features import scale_space as ss
from ssrlcv_tpu.features.descriptor import fill_descriptors
from ssrlcv_tpu.features.detector import check_descriptor_border, find_keypoints_octave
from ssrlcv_tpu.features.orientation import compute_orientations
from ssrlcv_tpu.ops import image_ops as ops


def octave_capacity(params: SIFTParams, octave_index: int, height: int, width: int) -> int:
    """Static keypoint capacity per octave: a generous fraction of the
    octave's pixel count (extrema are sparse; saturation is detected at
    aggregation time and logged as a warning)."""
    scale = 2.0 ** (params.starting_octave + octave_index)
    # octave pixel count = (H*W) / scale^2 (scale may be 0.5)
    npix = int(height * width / (scale * scale))
    cap = max(1024, npix // 64)
    # round to a lane-friendly multiple
    return ((cap + 127) // 128) * 128


@partial(jax.jit, static_argnames=("params", "height", "width", "octave_index", "capacity"))
def _detect_octave(
    dog_raw, dog_norm, params: SIFTParams, height: int, width: int,
    octave_index: int, capacity: int,
):
    sigmas = tuple(ss.octave_sigmas(params, octave_index))[: params.blurs_per_octave - 1]
    pixel_width = float(2.0 ** (params.starting_octave + octave_index))
    kps = find_keypoints_octave(dog_raw, dog_norm, sigmas, params, capacity)
    oh, ow = dog_raw.shape[1], dog_raw.shape[2]
    kps = check_descriptor_border(kps, (oh, ow), params.descriptor_contrib_width, pixel_width)
    return kps


@jax.jit
def _octave_gradients(dog_norm):
    # gradients of each normalised DoG slice (Blur::computeGradients on the
    # DOG scale space — orientation and descriptors both read these)
    return jax.vmap(ops.pixel_gradients)(dog_norm)  # (B-1, H, W, 2)


@partial(jax.jit, static_argnames=("params", "octave_index", "w_orient", "w_desc"))
def _describe_octave(
    grads, kps, params: SIFTParams, octave_index: int,
    w_orient: int | None = None, w_desc: int | None = None,
):
    pixel_width = float(2.0 ** (params.starting_octave + octave_index))
    oriented = compute_orientations(grads, kps, pixel_width, params, w_max=w_orient)
    desc, loc_image = fill_descriptors(grads, oriented, pixel_width, params, w_max=w_desc)
    return (
        oriented.blur, loc_image, oriented.sigma, oriented.theta, desc, oriented.mask,
    )


def _bucket_windows(params: SIFTParams, blur: int) -> tuple[int, int]:
    """Static orientation/descriptor window bounds for keypoints of one DoG
    blur bucket: sigma/pixel_width <= (initial/0.5) * mult^(blur + 0.5)
    regardless of octave (refinement shifts sigma by at most half a blur)."""
    import math

    ratio = (params.initial_sigma / 0.5) * params.blur_sigma_multiplier ** (blur + 0.5)
    w_o = int(math.ceil(3.0 * params.orientation_contrib_width * ratio))
    w_d = int(math.ceil(params.descriptor_contrib_width * ratio))
    return w_o, w_d


def _compact_keypoints(kps, bucket: int = 2048, select=None):
    """Host-side compaction of detected keypoints to the smallest bucketed
    capacity: the orientation/descriptor gathers then cost O(real keypoints)
    instead of O(detection capacity) — the static-shape analogue of the
    reference's thrust stream compaction.

    ``select``: optional host bool array restricting which masked keypoints
    to keep (used for per-blur bucketing)."""
    import numpy as np

    from ssrlcv_tpu.features.detector import SSKeyPoints

    m = np.asarray(kps.mask)
    if select is not None:
        m = m & select
    sel = np.nonzero(m)[0]
    n = len(sel)
    cap = max(((n + bucket - 1) // bucket) * bucket, bucket)

    def pack(x, fill=0):
        x = np.asarray(x)
        out = np.full((cap,) + x.shape[1:], fill, x.dtype)
        out[:n] = x[sel]
        return jnp.asarray(out)

    mask = np.zeros(cap, bool)
    mask[:n] = True
    return SSKeyPoints(
        blur=pack(kps.blur, 1),
        loc=pack(kps.loc),
        intensity=pack(kps.intensity),
        sigma=pack(kps.sigma, 1.0),
        theta=pack(kps.theta),
        mask=jnp.asarray(mask),
    )


def _device_compact(kps, capacity: int, select=None):
    """Device-side stable compaction to a fixed capacity: a stable argsort on
    ~mask moves live keypoints to the front in detection order (the jittable
    replacement for host compaction; tail beyond capacity is dropped).

    ``select``: optional device bool array restricting which masked keypoints
    survive (per-blur bucketing inside the fused program)."""
    from ssrlcv_tpu.features.detector import SSKeyPoints

    mask = kps.mask if select is None else (kps.mask & select)
    order = jnp.argsort(~mask, stable=True)[:capacity]
    return SSKeyPoints(
        blur=jnp.maximum(kps.blur[order], 1),
        loc=kps.loc[order],
        intensity=kps.intensity[order],
        sigma=jnp.maximum(kps.sigma[order], 1e-6),
        theta=kps.theta[order],
        mask=mask[order],
    )


def _bucket_capacity(params: SIFTParams, octave_index: int, blur: int,
                     height: int, width: int) -> int:
    """Static per-(octave, blur-bucket) describe capacity.  Measured blur
    distribution decays with blur (everest oct0: 9.1k/7.9k/4.8k out of a
    65536 detect capacity), so cap/4 for the low buckets and cap/8 for the
    top bucket keeps ~1.8x headroom; saturation is detected and logged at
    aggregation."""
    cap = octave_capacity(params, octave_index, height, width)
    frac = 4 if blur < params.blurs_per_octave - 3 else 8
    return max(cap // frac, 1024)


def _describe_buckets(params: SIFTParams):
    """DoG blur slices that can carry extrema: the 3x3x3 search needs a
    slice on each side, so interior slices 1 .. (B-2)-2."""
    return range(1, params.blurs_per_octave - 2)


@partial(jax.jit, static_argnames=("params", "height", "width"))
def _sift_fused(pixels, params: SIFTParams, height: int, width: int):
    """The whole SIFT front end as ONE device program: scale space, per-octave
    detection, device-side compaction, orientation, descriptors.  One host
    dispatch per image, and nothing crosses to the host between stages."""
    octaves = ss.build_scale_space(pixels, params, height, width)
    outs = []
    for o, octave in enumerate(octaves):
        cap = octave_capacity(params, o, height, width)
        kps = _detect_octave(octave.dog_raw, octave.dog_norm, params, height, width, o, cap)
        grads = _octave_gradients(octave.dog_norm)
        pixel_width = float(2.0 ** (params.starting_octave + o))
        # per-blur buckets: each bucket's orientation/descriptor gathers use
        # windows sized for that blur's sigma range instead of the octave
        # worst case (~3x fewer samples; same trick as the unfused path's
        # host-side bucket_describe, but entirely on-device)
        for b in _describe_buckets(params):
            bcap = _bucket_capacity(params, o, b, height, width)
            w_o, w_d = _bucket_windows(params, int(b))
            outs.append(_describe_bucket(
                kps, grads, params, int(b), bcap, w_o, w_d, pixel_width))
    return tuple(outs)


def _describe_bucket(kps, grads, params: SIFTParams, b: int, bcap: int,
                     w_o: int, w_d: int, pixel_width: float):
    """One blur bucket: compact -> orientations -> compact -> descriptors.

    ``grads`` is (B, H, W, 2).  Returns the per-bucket output tuple
    (blur, loc, sigma, theta, desc, mask, sat).
    """
    n_det = jnp.sum((kps.mask & (kps.blur == b)).astype(jnp.int32))
    kb = _device_compact(kps, bcap, select=kps.blur == b)
    oriented = compute_orientations(grads, kb, pixel_width, params, w_max=w_o)
    # compact the 2x-expanded oriented copies back to bcap before the
    # descriptor pass: most keypoints carry one orientation, so the
    # expensive descriptor pass runs over ~half the slots.  The bucket
    # capacities keep ~1.8x headroom over measured counts, so bcap also
    # covers the ~1.1x orientation expansion.
    n_ori = jnp.sum(oriented.mask.astype(jnp.int32))
    oriented = _device_compact(oriented, bcap)
    desc, loc_image = fill_descriptors(grads, oriented, pixel_width, params,
                                       w_max=w_d)
    # exact overflow signal: pre-compaction counts vs capacity (a full
    # mask alone does not imply anything was dropped)
    sat = (n_det > bcap) | (n_ori > bcap)
    return (oriented.blur, loc_image, oriented.sigma, oriented.theta, desc,
            oriented.mask, sat)


def _quantize_cap(n: int, lo: int = 512, frac: int = 8) -> int:
    """Quantized keypoint capacity: round up to pow2(n)/frac granularity so
    count-aware dispatches reuse at most `frac` compiled variants per
    power-of-2 bracket (the persistent compile cache amortises them)."""
    n = max(int(n), 1)
    if n <= lo:
        return lo
    p = 1 << (n - 1).bit_length()
    gran = max(lo // 2, p // frac)
    return ((n + gran - 1) // gran) * gran


@partial(jax.jit, static_argnames=("params",))
def _aggregate_device(outs, image_id, params: SIFTParams):
    """On-device aggregation of per-bucket outputs into one FeatureSet.

    The concatenated bucket order (octave-major, then blur, then detection
    order) is exactly the reference's aggregated feature order, so a stable
    masked compaction reproduces the host `_aggregate` lexsort bit-for-bit.
    Returns (FeatureSet, per-bucket saturation flags, overflow flag).
    """
    loc = jnp.concatenate([o[1] for o in outs])
    sigma = jnp.concatenate([o[2] for o in outs])
    theta = jnp.concatenate([o[3] for o in outs])
    desc = jnp.concatenate([o[4] for o in outs])
    mask = jnp.concatenate([o[5] for o in outs])
    sat = jnp.stack([o[6] for o in outs])

    cap = params.max_keypoints
    # global truncation: total valid features beyond max_keypoints are dropped
    # by the argsort[:cap] below — flag it like per-bucket saturation
    overflow = jnp.sum(mask.astype(jnp.int32)) > cap
    total = mask.shape[0]
    if total < cap:
        pad = cap - total
        loc = jnp.pad(loc, ((0, pad), (0, 0)))
        sigma = jnp.pad(sigma, ((0, pad),))
        theta = jnp.pad(theta, ((0, pad),))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
        mask = jnp.pad(mask, ((0, pad),))
    order = jnp.argsort(~mask, stable=True)[:cap]
    mask = mask[order]
    fs = FeatureSet(
        loc=jnp.where(mask[:, None], loc[order], -1.0),
        sigma=jnp.where(mask, sigma[order], 0.0),
        theta=jnp.where(mask, theta[order], 0.0),
        descriptors=jnp.where(mask[:, None], desc[order], 0),
        mask=mask,
        parent=jnp.broadcast_to(jnp.asarray(image_id, jnp.int32), (cap,)),
    )
    return fs, sat, overflow


@partial(jax.jit, static_argnames=("params", "height", "width"))
def _sift_fused_agg(pixels, image_id, params: SIFTParams, height: int, width: int):
    """_sift_fused + on-device aggregation into one FeatureSet (one device
    program).

    Returns (FeatureSet, per-bucket saturation flags, overflow flag).
    """
    outs = _sift_fused(pixels, params, height, width)
    return _aggregate_device(outs, image_id, params)


def log_saturation(image_id, sat, overflow, params: SIFTParams):
    """Host-side capacity warnings for one image's fused-SIFT run."""
    from ssrlcv_tpu.logging import logger

    n_buckets = len(list(_describe_buckets(params)))
    for i, s in enumerate(np.asarray(sat)):
        if s:
            # buckets iterate DoG blur slices 1..B-3 (_describe_buckets)
            logger.warn(
                f"image {image_id} octave {i // n_buckets} DoG blur slice "
                f"{i % n_buckets + 1}: keypoint capacity saturated — "
                "keypoints were dropped; raise SIFTParams capacity heuristics"
            )
    if bool(np.asarray(overflow)):
        logger.warn(
            f"image {image_id}: total valid features exceed max_keypoints="
            f"{params.max_keypoints} — tail dropped by global aggregation; "
            "raise SIFTParams.max_keypoints"
        )


def generate_features(
    pixels: np.ndarray | jax.Array,
    params: Optional[SIFTParams] = None,
    image_id: int = -1,
    fused: Optional[bool] = None,
) -> FeatureSet:
    """Generate SIFT features for one grayscale uint8 image.

    Mirrors generateFeatures(image, dense=false, maxOrientations=2,
    orientationThreshold=0.8) with the Appendix-A defaults; returns a
    host-compacted FeatureSet ordered (octave, blur bucket, detection order)
    like the reference's aggregated Unity<Feature<SIFT_Descriptor>>.

    ``fused`` (default: the device's path, ``backend.device_path``) runs the
    one-program device-resident front end; otherwise octaves run one by one
    with host compaction between detection and description.
    """
    params = params or SIFTParams()
    pixels = jnp.asarray(pixels)
    if pixels.ndim == 3:
        pixels = ops.to_bw(pixels)
    h, w = int(pixels.shape[0]), int(pixels.shape[1])

    if fused is None:
        fused = device_path() == "gpu"

    if fused:
        # detection, orientation, descriptors AND the final aggregation
        # compile into one program; the FeatureSet stays on the device
        # (matching consumes it there) and only the tiny per-bucket
        # saturation flags reach the host
        fs, sat, overflow = _sift_fused_agg(pixels, jnp.int32(image_id), params, h, w)
        log_saturation(image_id, sat, overflow, params)
        return fs

    blurs_all, locs_all, sig_all, theta_all, desc_all, mask_all, octs_all = (
        [], [], [], [], [], [], []
    )
    octaves = ss.build_scale_space(pixels, params, h, w)

    for o, octave in enumerate(octaves):
        cap = octave_capacity(params, o, h, w)
        detected = _detect_octave(octave.dog_raw, octave.dog_norm, params, h, w, o, cap)
        det_blur = np.asarray(detected.blur)
        grads = _octave_gradients(octave.dog_norm)
        # optionally bucket by DoG blur slice so each bucket's gather window
        # is sized for its actual sigma range (blur-1 keypoints dominate and
        # need a 23^2 sample grid, not the global 45^2 worst case)
        if params.bucket_describe:
            buckets = sorted(set(det_blur[np.asarray(detected.mask)].tolist()))
        else:
            buckets = [None]
        for b in buckets:
            if b is None:
                kps = _compact_keypoints(detected)
                w_o = w_d = None
            else:
                kps = _compact_keypoints(detected, select=det_blur == b)
                w_o, w_d = _bucket_windows(params, int(b))
            blur, loc, sigma, theta, desc, mask = _describe_octave(
                grads, kps, params, o, w_orient=w_o, w_desc=w_d
            )
            blurs_all.append(np.asarray(blur))
            locs_all.append(np.asarray(loc))
            sig_all.append(np.asarray(sigma))
            theta_all.append(np.asarray(theta))
            desc_all.append(np.asarray(desc))
            mask_all.append(np.asarray(mask))
            octs_all.append(np.full(mask_all[-1].shape, o))

    return _aggregate(
        params, image_id, blurs_all, locs_all, sig_all, theta_all,
        desc_all, mask_all, octs_all,
    )


def generate_features_many(
    pixel_list,
    params: Optional[SIFTParams] = None,
    image_ids: Optional[list] = None,
) -> list:
    """Multi-image feature generation on the default device.

    On the fused path every image's program is dispatched before any
    saturation flag is read, so the device runs the images back to back.
    Returns per-image results identical to generate_features."""
    params = params or SIFTParams()
    pxs = []
    for px in pixel_list:
        px = jnp.asarray(px)
        if px.ndim == 3:
            px = ops.to_bw(px)
        pxs.append(px)
    ids = list(image_ids) if image_ids is not None else list(range(len(pxs)))
    if len(ids) != len(pxs):
        raise ValueError(
            f"generate_features_many: {len(pxs)} images but {len(ids)} "
            "image_ids — a silent zip would drop trailing images")

    if device_path() != "gpu":
        return [generate_features(p, params, image_id=i)
                for p, i in zip(pxs, ids)]
    outs = [_sift_fused_agg(p, jnp.int32(i), params, int(p.shape[0]), int(p.shape[1]))
            for p, i in zip(pxs, ids)]
    res = []
    for iid, (fs, sat, ovf) in zip(ids, outs):
        log_saturation(iid, sat, ovf, params)
        res.append(fs)
    return res


def _aggregate(params, image_id, blurs_all, locs_all, sig_all, theta_all,
               desc_all, mask_all, octs_all) -> FeatureSet:
    # saturation check: a fully-masked bucket means the fixed capacity
    # clipped real keypoints (dense-texture images) — surface it loudly
    for m, ov in zip(mask_all, octs_all):
        if m.all():
            from ssrlcv_tpu.logging import logger

            logger.warn(
                f"image {image_id} octave {int(ov[0])}: keypoint capacity "
                f"{len(m)} saturated — keypoints were dropped; raise "
                "SIFTParams capacity heuristics"
            )
    # host aggregation with reference ordering: octave, then blur bucket
    # (stable), then detection order
    blur = np.concatenate(blurs_all)
    loc = np.concatenate(locs_all)
    sigma = np.concatenate(sig_all)
    theta = np.concatenate(theta_all)
    desc = np.concatenate(desc_all)
    mask = np.concatenate(mask_all)
    octv = np.concatenate(octs_all)

    sel = np.nonzero(mask)[0]
    order = np.lexsort((sel, blur[sel], octv[sel]))  # stable (octave, blur)
    sel = sel[order]

    n = len(sel)
    cap = params.max_keypoints
    if n > cap:
        sel = sel[:cap]
        n = cap
    out = FeatureSet.empty(cap, parent=image_id)
    out = FeatureSet(
        loc=out.loc.at[:n].set(jnp.asarray(loc[sel])),
        sigma=out.sigma.at[:n].set(jnp.asarray(sigma[sel])),
        theta=out.theta.at[:n].set(jnp.asarray(theta[sel])),
        descriptors=out.descriptors.at[:n].set(jnp.asarray(desc[sel])),
        mask=out.mask.at[:n].set(True),
        parent=out.parent,
    )
    return out


def features_from_refdata(feat_dict: dict, capacity: Optional[int] = None, parent: int = -1) -> FeatureSet:
    """Build a FeatureSet from a reference .uty feature dump
    (io.refdata.read_sift_features) — used for golden tests and seed
    features."""
    n = len(feat_dict["loc"])
    cap = capacity or ((n + 127) // 128) * 128
    fs = FeatureSet.empty(cap, parent=parent)
    return FeatureSet(
        loc=fs.loc.at[:n].set(jnp.asarray(feat_dict["loc"])),
        sigma=fs.sigma.at[:n].set(jnp.asarray(feat_dict["sigma"])),
        theta=fs.theta.at[:n].set(jnp.asarray(feat_dict["theta"])),
        descriptors=fs.descriptors.at[:n].set(jnp.asarray(feat_dict["values"])),
        mask=fs.mask.at[:n].set(True),
        parent=fs.parent.at[:n].set(jnp.asarray(feat_dict["parent"])),
    )
