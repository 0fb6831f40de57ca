"""Dense stereo disparity.

Re-design of the reference's disparity path (generateDiparityMatches +
disparityScanMatching window-SAD kernels, MatchFactory.cu:1031-1414;
computeStereo depth kernels, PointCloudFactory.cu:23-160).

The CUDA design assigns one window-sized thread block per pixel and scans
disparities serially with shared-memory atomics.  This formulation builds
the classic cost volume instead: for each disparity d the per-pixel SAD is a
box-filtered absolute difference of the shifted image pair — one fused
elementwise+reduce-window op per disparity, batched over the whole image, and
an argmin over the volume (first-minimum tie-break matches the reference's
strict-< scan order).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("max_disparity", "window", "direction"))
def disparity_scan_matching(
    query: jax.Array,            # (H, W) uint8
    target: jax.Array,           # (H, W) uint8
    max_disparity: int = 64,
    window: int = 11,
    direction: str = "right",
):
    """Window-SAD scanline disparity for rectified pairs
    (disparityScanMatching, MatchFactory.cu:1290-1360).

    direction: 'right' (target x >= query x), 'left', or 'undefined'
    (search centred, starting at x - max_disparity//2).

    Returns (disparity (H, W) int32 signed target-x offset, valid (H, W)).
    """
    h, w = query.shape
    q = query.astype(jnp.float32)
    t = target.astype(jnp.float32)
    half = window // 2

    if direction == "right":
        offsets = list(range(0, max_disparity))
    elif direction == "left":
        offsets = list(range(0, -max_disparity, -1))
    else:
        offsets = [o - max_disparity // 2 for o in range(max_disparity)]

    def sad_for_offset(o):
        shifted = jnp.roll(t, -o, axis=1)
        ad = jnp.abs(q - shifted)
        return jax.lax.reduce_window(
            ad, 0.0, jax.lax.add, (window, window), (1, 1), "SAME"
        )

    costs = jnp.stack([sad_for_offset(o) for o in offsets])  # (D, H, W)
    # out-of-image target windows are invalid for that disparity
    xs = jnp.arange(w)[None, None, :]
    offs = jnp.asarray(offsets, jnp.int32)[:, None, None]
    tx = xs + offs
    in_img = (tx - half >= 0) & (tx + half < w)
    costs = jnp.where(in_img, costs, jnp.inf)

    best = jnp.argmin(costs, axis=0)                         # first-min tie-break
    disparity = offs[:, 0, 0][best]
    valid = jnp.isfinite(jnp.min(costs, axis=0))
    # border windows of the query are invalid (reference's minimizedSize crop)
    ys = jnp.arange(h)[:, None]
    interior = (
        (jnp.arange(w)[None, :] >= half)
        & (jnp.arange(w)[None, :] < w - half - 1)
        & (ys >= half)
        & (ys < h - half - 1)
    )
    return disparity.astype(jnp.int32), valid & interior


@partial(jax.jit, static_argnames=("max_disparity", "window", "direction"))
def disparity_matching(
    query: jax.Array,            # (H, W) uint8
    target: jax.Array,           # (H, W) uint8
    fundamental: jax.Array,      # (3, 3)
    max_disparity: int = 64,
    window: int = 11,
    direction: str = "right",
):
    """Window-SAD disparity along per-pixel epipolar lines for non-rectified
    pairs (disparityMatching, MatchFactory.cu:1283-1349): at search step i
    the target x advances by the scan direction and y follows the query
    pixel's epipolar line y = -(a*x + c)/b with (a,b,c) = F @ [x, y, 1].

    Deviation (documented): the reference's racy one-block-per-center window
    writes become per-pixel window centers, and the SAD window samples the
    target around the *shifted* epipolar y of each window pixel rather than
    the center's (exact for straight horizontal lines, O(window*slope)
    otherwise).  Its odd `stop` arithmetic becomes an in-image mask.

    Returns (target_x (H, W) int32, target_y (H, W) int32, valid (H, W)).
    """
    h, w = query.shape
    q = query.astype(jnp.float32)
    t = target.astype(jnp.float32)
    half = window // 2
    F = fundamental.astype(jnp.float32)

    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    a = F[0, 0] * xs + F[0, 1] * ys + F[0, 2]
    b = F[1, 0] * xs + F[1, 1] * ys + F[1, 2]
    c = F[2, 0] * xs + F[2, 1] * ys + F[2, 2]

    if direction == "right":
        offsets = list(range(0, max_disparity))
    elif direction == "left":
        offsets = list(range(0, -max_disparity, -1))
    else:
        offsets = [o - max_disparity // 2 for o in range(max_disparity)]

    def sad_for_offset(o):
        sx = xs + o
        sy = jnp.floor(-(a * sx + c) / jnp.where(b == 0, 1e-20, b)).astype(jnp.int32)
        in_img = (sx - half >= 0) & (sx + half < w) & (sy - half >= 0) & (sy + half < h)
        warped = t[jnp.clip(sy, 0, h - 1), jnp.clip(sx, 0, w - 1)]
        ad = jnp.abs(q - warped)
        cost = jax.lax.reduce_window(ad, 0.0, jax.lax.add, (window, window), (1, 1), "SAME")
        return jnp.where(in_img, cost, jnp.inf), sy

    costs, sys_ = [], []
    for o in offsets:
        cst, sy = sad_for_offset(o)
        costs.append(cst)
        sys_.append(sy)
    costs = jnp.stack(costs)
    sys_ = jnp.stack(sys_)
    best = jnp.argmin(costs, axis=0)
    offs = jnp.asarray(offsets, jnp.int32)
    tx = xs.astype(jnp.int32) + offs[best]
    ty = jnp.take_along_axis(sys_, best[None], axis=0)[0]
    valid = jnp.isfinite(jnp.min(costs, axis=0))
    interior = (
        (xs >= half) & (xs < w - half - 1) & (ys >= half) & (ys < h - half - 1)
    )
    return tx, ty, valid & interior


def _is_parallel_f(F: np.ndarray) -> bool:
    """The reference's 'parallel images' F pattern: all zeros except
    F[1][2] == -1 and F[2][1] == 1 (generateDiparityMatches,
    MatchFactory.cu:1071-1080)."""
    F = np.asarray(F, np.float32)
    pattern_ok = F[1, 2] == -1.0 and F[2, 1] == 1.0
    rest = F.copy()
    rest[1, 2] = 0.0
    rest[2, 1] = 0.0
    return pattern_ok and not np.any(rest != 0.0)


def generate_disparity_matches(
    query: np.ndarray | jax.Array,
    target: np.ndarray | jax.Array,
    fundamental: np.ndarray,
    max_disparity: int = 64,
    window: int = 11,
    direction: str = "right",
):
    """The reference's dense-stereo entry point (generateDiparityMatches,
    MatchFactory.cu:1031-1127): dispatch the rectified scanline kernel when
    F matches the parallel-image pattern, else the epipolar variant; emit
    validated keypoint-pair matches.

    Returns (loc0 (N, 2) float32, loc1 (N, 2) float32) compacted host
    arrays — the Unity<Match> equivalent (parent ids are 0 and 1 by
    construction, MatchFactory.cu:1343-1346).
    """
    if window == 0 or window % 2 == 0 or window > 31:
        raise ValueError("window size must be odd, >0 and <=31 (MatchFactory.cu:1047)")
    q = jnp.asarray(query)
    if max_disparity > q.shape[1]:
        raise ValueError("max disparity cannot exceed image width (MatchFactory.cu:1038)")
    t = jnp.asarray(target)
    if _is_parallel_f(fundamental):
        disp, valid = disparity_scan_matching(q, t, max_disparity, window, direction)
        h, w = q.shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        tx = xs + np.asarray(disp)
        ty = ys
    else:
        txj, tyj, valid = disparity_matching(
            q, t, jnp.asarray(fundamental), max_disparity, window, direction
        )
        h, w = q.shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        tx, ty = np.asarray(txj), np.asarray(tyj)
    m = np.asarray(valid)
    loc0 = np.stack([xs[m], ys[m]], axis=1).astype(np.float32)
    loc1 = np.stack([tx[m], ty[m]], axis=1).astype(np.float32)
    return loc0, loc1


def compute_stereo_scale(disp_matches_loc0, disp_matches_loc1, scale: float = 8.0):
    """z = scale * ||loc0 - loc1|| depth proxy (computeStereo,
    PointCloudFactory.cu:4440-4455; the camera-derived variant hard-codes
    scale 8.0 at :45)."""
    d = jnp.linalg.norm(disp_matches_loc0 - disp_matches_loc1, axis=-1)
    return jnp.concatenate([disp_matches_loc0, (scale * d)[..., None]], axis=-1)


def compute_stereo_focal(loc0, loc1, foc: float, baseline: float, doffset: float = 0.0):
    """z = foc*baseline/(x0 - x1 + doffset) (computeStereo 3-arg variant)."""
    z = foc * baseline / (loc0[..., 0] - loc1[..., 0] + doffset)
    return jnp.stack([loc1[..., 0], loc1[..., 1], z], axis=-1)


def heat_map(values: np.ndarray) -> np.ndarray:
    """Red->green->blue heat map over [0, 1] (heatMap,
    PointCloudFactory.cu:112-144)."""
    v = np.asarray(values, np.float32)
    lowhalf = v <= 0.5
    v2 = np.where(lowhalf, v * 2.0, v * 2.0 - 1.0)
    r = np.where(lowhalf, 255 * (1 - v2) + 0.5, 0)
    g = np.where(lowhalf, 255 * v2 + 0.5, 255 * (1 - v2) + 0.5)
    b = np.where(lowhalf, 0, 255 * v2 + 0.5)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def write_disparity_image(points: np.ndarray, path: str, interpolation_radius: int = 0) -> str:
    """Depth points -> normalised heat-map PNG (writeDisparityImage,
    PointCloudFactory.cu:149-227)."""
    from ssrlcv_tpu.io.images import write_image

    pts = np.asarray(points)
    xs = pts[:, 0].astype(np.int64)
    ys = pts[:, 1].astype(np.int64)
    z = pts[:, 2]
    w = int(xs.max()) + 1
    h = int(ys.max()) + 1
    depth = np.zeros((h, w), np.float32)
    depth[ys, xs] = z
    zmin, zmax = float(z.min()), float(z.max())
    norm = (depth - zmin) / max(zmax - zmin, 1e-12)
    if interpolation_radius > 0:
        from scipy.ndimage import uniform_filter

        norm = uniform_filter(norm, size=2 * interpolation_radius + 1)
    rgb = heat_map(norm)
    if not path.endswith(".png"):
        path += ".png"
    write_image(path, rgb)
    return path
