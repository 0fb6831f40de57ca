"""Point-cloud transforms and debug/analysis writers.

Re-design of the reference's cloud utility kernels
(scale/translate/rotate/average, PointCloudFactory.cu:4019-4164, 5295-5344)
and its debug cloud family (saveDebugCloud, saveDebugLinearErrorCloud,
saveViewNumberCloud, generateSensitivityFunctions,
PointCloudFactory.cu:2293-3068).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ssrlcv_tpu.core import camera_math
from ssrlcv_tpu.core.types import Bundles, Cameras, MatchSet, PointCloud
from ssrlcv_tpu.io import ply


def scale_cloud(points: jax.Array, scale: float) -> jax.Array:
    """scalePointCloud (PointCloudFactory.cu:4019)."""
    return points * scale


def translate_cloud(points: jax.Array, translation: jax.Array) -> jax.Array:
    """translatePointCloud."""
    return points + translation


def rotate_cloud(points: jax.Array, angles: jax.Array) -> jax.Array:
    """rotatePointCloud: XYZ-Euler rotation about the origin."""
    return camera_math.rotate_point(points, angles)


def cloud_average(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Masked centroid (the average kernels, PointCloudFactory.cu:5295)."""
    w = mask[:, None].astype(points.dtype)
    return jnp.sum(points * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)


def save_debug_cloud(
    path: str,
    cloud: PointCloud,
    cameras: Cameras,
    bundles: Optional[Bundles] = None,
    projection_scale: float = 1.0,
) -> str:
    """Color-coded debug PLY (saveDebugCloud, PointCloudFactory.cu:2293):
    cameras RED, cloud points GREEN, camera-projected ray points BLUE."""
    pts = [np.asarray(cloud.points)[np.asarray(cloud.mask)]]
    cols = [np.tile([0, 255, 0], (len(pts[0]), 1))]

    cam = np.asarray(cameras.cam_pos)
    pts.append(cam)
    cols.append(np.tile([255, 0, 0], (len(cam), 1)))

    if bundles is not None:
        m = np.asarray(bundles.mask)
        vec = np.asarray(bundles.vec)[m].reshape(-1, 3)
        pnt = np.asarray(bundles.pnt)[m].reshape(-1, 3)
        proj = pnt + projection_scale * vec
        pts.append(proj)
        cols.append(np.tile([0, 0, 255], (len(proj), 1)))

    allp = np.vstack(pts).astype(np.float32)
    allc = np.vstack(cols).astype(np.uint8)
    return ply.write_ply(path, allp, colors=allc)


def save_linear_error_cloud(path: str, cloud: PointCloud) -> str:
    """Per-point error as a heat gradient (saveDebugLinearErrorCloud)."""
    m = np.asarray(cloud.mask)
    return ply.write_ply_gradient(path, np.asarray(cloud.points)[m], np.asarray(cloud.errors)[m])


def save_view_number_cloud(path: str, cloud: PointCloud, matches: MatchSet) -> str:
    """Color by number of contributing views (saveViewNumberCloud)."""
    m = np.asarray(cloud.mask)
    nv = np.asarray(matches.num_views)[m].astype(np.float32)
    return ply.write_ply_gradient(path, np.asarray(cloud.points)[m], nv)


def generate_sensitivity_functions(
    matches: MatchSet,
    cameras: Cameras,
    out_dir: str,
    deltas: np.ndarray = None,
    prefix: str = "sensitivity",
) -> dict[str, str]:
    """Error-vs-parameter CSV sweeps (generateSensitivityFunctions,
    PointCloudFactory.cu:2293-3068): for each of camera 1's 6 parameters,
    sweep an offset range and record the total linear error."""
    from ssrlcv_tpu.ba.two_view import _pack, make_objective

    if deltas is None:
        deltas = np.linspace(-1e-3, 1e-3, 41)
    obj = jax.jit(make_objective(matches, cameras))
    base = _pack(cameras)
    os.makedirs(out_dir, exist_ok=True)
    names = ["pos_x", "pos_y", "pos_z", "rot_x", "rot_y", "rot_z"]
    out = {}
    for pi, name in enumerate(names):
        rows = []
        for d in deltas:
            p = base.at[1, pi].add(float(d))
            rows.append((float(d), float(obj(p))))
        path = os.path.join(out_dir, f"{prefix}_{name}.csv")
        with open(path, "w") as f:
            f.write("offset,linear_error\n")
            for d, e in rows:
                f.write(f"{d},{e}\n")
        out[name] = path
    return out


def visualize_plane_estimation(
    cloud: PointCloud,
    cameras: Cameras,
    path: str,
    scale: float = 1000.0,
    k: int = 10,
) -> str:
    """Write the planar filter's estimated plane as a quad mesh PLY
    (visualizePlaneEstimation, PointCloudFactory.cu:2813-2885): octree
    camera-facing neighbourhood normals averaged to a plane normal, the
    cloud centroid as the plane point, then a (2*bounds/step)^2 vertex grid
    with z from the point-normal plane equation and quad faces curled in
    the reference's vertex order (top-left, top-right, bottom-right,
    bottom-left)."""
    from ssrlcv_tpu.mesh import octree as oc

    tree = oc.build_octree(cloud.points, cloud.mask)
    normals = oc.compute_normals(tree, cameras.cam_pos, k=k)
    w = tree.mask[:, None].astype(normals.dtype)
    normal = jnp.sum(normals * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    normal = np.asarray(normal / jnp.maximum(jnp.linalg.norm(normal), 1e-12))
    point = np.asarray(cloud_average(cloud.points, cloud.mask))

    step = 40
    bounds = int(scale) - (int(scale) % step)
    xs = np.arange(-bounds, bounds, step, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    nz = normal[2] if abs(normal[2]) > 1e-12 else 1e-12
    gz = point[2] - (normal[0] * (gx - point[0]) + normal[1] * (gy - point[1])) / nz
    vertices = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float32)

    side = len(xs)
    quads = []
    for x in range(side - 1):
        for y in range(side - 1):
            loc = x * side + y
            quads.append([loc, loc + 1, loc + side + 1, loc + side])
    ply.write_ply(path, vertices, faces=np.asarray(quads, np.int32), binary=False)
    return path


def test_bundle_adjustment_noise(
    matches: MatchSet,
    cameras: Cameras,
    key: jax.Array,
    noise_rot: float = 1e-4,
    noise_pos: float = 0.01,
    iterations: int = 10,
):
    """BA self-test with injected camera noise (testBundleAdjustmentTwoView,
    PointCloudFactory.cuh:337-348): perturb camera 1, run BA, report
    (clean_error, noisy_error, recovered_error)."""
    from ssrlcv_tpu.ba.two_view import _pack, bundle_adjust_two_view, make_objective

    obj = make_objective(matches, cameras)
    clean = float(obj(_pack(cameras)))

    k1, k2 = jax.random.split(key)
    noisy_cams = cameras.replace(
        cam_rot=cameras.cam_rot.at[1].add(noise_rot * jax.random.normal(k1, (3,))),
        cam_pos=cameras.cam_pos.at[1].add(noise_pos * jax.random.normal(k2, (3,))),
    )
    noisy = float(obj(_pack(noisy_cams)))
    r = bundle_adjust_two_view(matches, noisy_cams, iterations=iterations, mode="lm")
    return clean, noisy, float(r.final_error)
