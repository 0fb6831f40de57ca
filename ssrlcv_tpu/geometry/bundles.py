"""Ray (bundle) generation from match tracks.

Re-design of the reference's ``generateBundles`` stage
(PointCloudFactory.cu:832-932 host, :4166-4283 kernels): every (track, view)
slot is lifted to a world ray in one fused, fully-vectorised jnp computation
over the padded (T, V) track tensor — no per-match loop, no AoS gather.

Camera parameters are gathered per-slot with a take along the parent-id
tensor, so the whole op is a handful of XLA gathers + elementwise math and
fuses into downstream triangulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssrlcv_tpu.core import camera_math
from ssrlcv_tpu.core.types import Bundles, Cameras, MatchSet, PushbroomCameras


def generate_bundles(matches: MatchSet, cameras: Cameras, params_vec: jax.Array | None = None,
                     pushbrooms=None) -> Bundles:
    """Lift each track's keypoints to world-frame rays.

    Replicates generateBundle (PointCloudFactory.cu:4166-4199): pixel ->
    image-plane point at z=foc (dpix recomputed from fov/foc assuming square
    pixels), rotated by cam_rot, origin cam_pos.

    ``params_vec``: optional (N_cams, 11) override of camera parameters in
    the reference's getFloatVector order (Image.cuh:171-186) — used by bundle
    adjustment to re-generate bundles under perturbed cameras without
    rebuilding the Cameras pytree.

    ``pushbrooms``: optional PushbroomCameras; when given the pushbroom ray
    path runs instead, matching the reference's images[0]->isPushbroom
    dispatch (PointCloudFactory.cu:845-903).
    """
    if pushbrooms is not None:
        return generate_pushbroom_bundles(matches, pushbrooms)
    if params_vec is not None:
        cam_pos = params_vec[:, 0:3]
        cam_rot = params_vec[:, 3:6]
        fov_x = params_vec[:, 6]
        foc = params_vec[:, 8]
    else:
        cam_pos = cameras.cam_pos
        cam_rot = cameras.cam_rot
        fov_x = cameras.fov[:, 0]
        foc = cameras.foc

    parent = jnp.maximum(matches.kp_parent, 0)          # (T, V) — clamp empty slots
    vec, pnt = camera_math.pixel_to_ray(
        matches.kp_loc,
        cam_pos[parent],
        cam_rot[parent],
        foc[parent],
        fov_x[parent],
        cameras.size[parent],
    )
    return Bundles(vec=vec, pnt=pnt, num_views=matches.num_views, mask=matches.mask)


def generate_pushbroom_bundles(matches: MatchSet, pushbrooms: PushbroomCameras) -> Bundles:
    """Pushbroom (HiRISE-style scan camera) ray generation.

    Replicates generatePushbroomBundle (PointCloudFactory.cu:4201-4283):
    solve the quadratic orbit geometry for the craft position at the scan
    roll, advance along-orbit by the row's arc length, roll the image-plane
    point, and emit the position->point ray.
    """
    parent = jnp.maximum(matches.kp_parent, 0)
    loc = matches.kp_loc                                  # (T, V, 2)
    size = pushbrooms.size[parent].astype(jnp.float32)    # (T, V, 2)
    dpix = pushbrooms.dpix[parent]
    foc = pushbrooms.foc[parent]
    roll_deg = pushbrooms.roll[parent]
    radius = pushbrooms.axis_radius[parent]
    altitude = pushbrooms.altitude[parent]
    gsd = pushbrooms.gsd[parent]

    center = size / 2.0
    kp = jnp.stack(
        [
            dpix[..., 0] * (loc[..., 0] - center[..., 0]),
            jnp.zeros_like(loc[..., 0]),
            -foc,
        ],
        axis=-1,
    )
    roll = roll_deg * (jnp.pi / 180.0)
    t = jnp.tan(roll - jnp.pi / 2.0)
    a = 1.0 + t * t
    b = -2.0 * radius * t
    c = radius * radius - (altitude + radius) ** 2
    disc = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
    s1 = (-b + disc) / (2.0 * a)
    s2 = (-b - disc) / (2.0 * a)
    sol = jnp.where(s1 > 0, s1, s2)
    position = jnp.stack([sol, jnp.zeros_like(sol), -t * sol], axis=-1)

    arc_length = gsd * (loc[..., 1] - center[..., 1])
    angle_out = arc_length / radius

    zeros = jnp.zeros_like(roll)
    kp = camera_math.rotate_point(kp, jnp.stack([zeros, roll, zeros], -1))
    position = camera_math.rotate_point(position, jnp.stack([angle_out, zeros, zeros], -1))

    kp = position - kp
    vec = position - kp
    vec = vec / jnp.maximum(jnp.linalg.norm(vec, axis=-1, keepdims=True), 1e-20)
    return Bundles(vec=vec, pnt=position, num_views=matches.num_views, mask=matches.mask)
