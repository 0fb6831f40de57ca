"""Camera geometry: rotations, projections, fundamental matrices.

Vectorised jnp re-implementations of the reference's register-level 3x3
helpers (matrix_util.cuh:12-95, Image.cu:498-716).  All functions operate on
batched arrays and are jit/vmap/grad-safe.

Conventions (identical to the reference):
  * ``rotation_matrix(angles)`` builds R = Rz(z) @ Ry(y) @ Rx(x)
    (matrix_util.cu:257-268); ``rotate_point`` applies R @ p
    (matrix_util.cu:314).
  * A camera's ``cam_rot`` rotates *camera-frame* vectors into the world
    frame; the world->camera projection uses R^T (Image.cu:498 builds P
    from the transpose).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from functools import partial

# Geometry runs at km scale; tiny 3x3 contractions must stay full float32,
# where a GPU's default matmul precision may be TF32 (about 3 decimal digits).
_einsum = partial(jnp.einsum, precision="highest")

from ssrlcv_tpu.config import EARTH_MAX_KM_FROM_CENT, EARTH_MIN_KM_FROM_CENT


def rotation_matrix(angles: jax.Array) -> jax.Array:
    """XYZ-Euler rotation matrix, R = Rz @ Ry @ Rx.

    angles: (..., 3) -> (..., 3, 3).  Matches reference getRotationMatrix
    (matrix_util.cu:257).
    """
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = jnp.cos(x), jnp.sin(x)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cz, sz = jnp.cos(z), jnp.sin(z)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotate_point(point: jax.Array, angles: jax.Array) -> jax.Array:
    """Apply the XYZ-Euler rotation to points (broadcasts).

    point: (..., 3), angles: (..., 3) -> (..., 3).
    Matches reference rotatePoint (matrix_util.cu:314).
    """
    R = rotation_matrix(angles)
    return _einsum("...ij,...j->...i", R, point)


def axis_rotations(R: jax.Array) -> jax.Array:
    """Recover XYZ Euler angles from a rotation matrix
    (matrix_util.cu:244-250)."""
    x = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    y = jnp.arctan2(-R[..., 2, 0], R[..., 2, 2] / jnp.cos(x))
    z = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([x, y, z], axis=-1)


def rotate_point_arbitrary(point: jax.Array, axis: jax.Array, angle: jax.Array) -> jax.Array:
    """Rodrigues rotation about an arbitrary axis (matrix_util.cu:339)."""
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    c, s = jnp.cos(angle), jnp.sin(angle)
    k = 1.0 - c
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    R = jnp.stack(
        [
            jnp.stack([ax * ax * k + c, ax * ay * k - az * s, ax * az * k + ay * s], -1),
            jnp.stack([ax * ay * k + az * s, ay * ay * k + c, ay * az * k - ax * s], -1),
            jnp.stack([ax * az * k - ay * s, ay * az * k + ax * s, az * az * k + c], -1),
        ],
        axis=-2,
    )
    return _einsum("...ij,...j->...i", R, point)


def effective_dpix(foc: jax.Array, fov_x: jax.Array, size_x: jax.Array) -> jax.Array:
    """dpix recomputed from foc/fov as the bundle generator does
    (PointCloudFactory.cu:4178-4180): square pixels assumed."""
    return (foc * jnp.tan(fov_x / 2.0)) / (size_x.astype(jnp.float32) / 2.0)


def pixel_to_ray(
    loc: jax.Array,
    cam_pos: jax.Array,
    cam_rot: jax.Array,
    foc: jax.Array,
    fov_x: jax.Array,
    size: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Lift pixel locations to world-frame unit rays.

    Replicates the reference generateBundle kernel
    (PointCloudFactory.cu:4166-4199): image plane at z=foc, pixel scaled by
    dpix about the image centre, rotated by cam_rot, origin at cam_pos.

    loc: (..., 2); camera fields broadcast against loc's batch shape.
    Returns (vec, pnt): unit direction (...,3) and origin (...,3).
    """
    d = effective_dpix(foc, fov_x, size[..., 0])
    kp = jnp.stack(
        [
            d * (loc[..., 0] - size[..., 0].astype(jnp.float32) / 2.0),
            d * (loc[..., 1] - size[..., 1].astype(jnp.float32) / 2.0),
            jnp.broadcast_to(foc, loc[..., 0].shape),
        ],
        axis=-1,
    )
    vec = rotate_point(kp, cam_rot)
    vec = vec / jnp.linalg.norm(vec, axis=-1, keepdims=True)
    pnt = jnp.broadcast_to(cam_pos, vec.shape)
    return vec, pnt


def projection_matrix(
    cam_pos: jax.Array,
    cam_rot: jax.Array,
    foc: jax.Array,
    dpix: jax.Array,
    size: jax.Array,
    ecef_offset: jax.Array,
) -> jax.Array:
    """3x4 world->pixel projection P = K [R^T | -R^T c]
    (reference getProjectionMatrix, Image.cu:498-540).

    Camera fields: (..., d) -> (..., 3, 4).
    """
    fx = foc / dpix[..., 0]
    fy = foc / dpix[..., 1]
    cx = size[..., 0].astype(jnp.float32) / 2.0
    cy = size[..., 1].astype(jnp.float32) / 2.0
    zero = jnp.zeros_like(fx)
    one = jnp.ones_like(fx)
    K = jnp.stack(
        [
            jnp.stack([fx, zero, cx], -1),
            jnp.stack([zero, fy, cy], -1),
            jnp.stack([zero, zero, one], -1),
        ],
        axis=-2,
    )
    Rt = jnp.swapaxes(rotation_matrix(cam_rot), -1, -2)
    cent = cam_pos + ecef_offset
    t = -_einsum("...ij,...j->...i", Rt, cent)
    Rt4 = jnp.concatenate([Rt, t[..., None]], axis=-1)
    return _einsum("...ik,...kj->...ij", K, Rt4)


def epipolar_segment_endpoints(
    loc: jax.Array,
    q_cam_pos: jax.Array,
    q_cam_rot: jax.Array,
    q_foc: jax.Array,
    q_dpix: jax.Array,
    q_size: jax.Array,
    q_ecef_offset: jax.Array,
    target_P: jax.Array,
    delta: float,
) -> tuple[jax.Array, jax.Array]:
    """Project the Earth-bounded segment of a query pixel's back-projected ray
    into the target image (reference getEpipolarEndpoints,
    MatchFactory.cu:1240-1277).

    loc: (..., 2) query pixel locations; returns (p1, p2) each (..., 2):
    the target-image endpoints at max/min plausible Earth radius +- delta.
    """
    qvec = jnp.stack(
        [
            q_dpix[..., 0] * (loc[..., 0] - q_size[..., 0].astype(jnp.float32) / 2.0),
            q_dpix[..., 1] * (loc[..., 1] - q_size[..., 1].astype(jnp.float32) / 2.0),
            jnp.broadcast_to(q_foc, loc[..., 0].shape),
        ],
        axis=-1,
    )
    qvec = rotate_point(qvec, q_cam_rot)
    qcent = q_cam_pos + q_ecef_offset

    a = jnp.sum(qvec * qvec, axis=-1)
    b = 2.0 * jnp.sum(qvec * qcent, axis=-1)
    cc = jnp.sum(qcent * qcent, axis=-1)
    c1 = cc - (EARTH_MAX_KM_FROM_CENT + delta) ** 2
    c2 = cc - (EARTH_MIN_KM_FROM_CENT - delta) ** 2

    def _hit(cq):
        disc = jnp.maximum(b * b - 4.0 * a * cq, 0.0)
        t = (-jnp.sqrt(disc) - b) / (2.0 * a)
        return t[..., None] * qvec + qcent

    X1 = _hit(c1)
    X2 = _hit(c2)

    def _proj(X):
        Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)
        x = _einsum("...ij,...j->...i", target_P, Xh)
        return x[..., :2] / x[..., 2:3]

    return _proj(X1), _proj(X2)


def fundamental_from_cameras(
    cam_rot0: jax.Array,
    cam_pos0: jax.Array,
    cam_rot1: jax.Array,
    cam_pos1: jax.Array,
    foc_pixels: jax.Array,
    size: jax.Array,
) -> jax.Array:
    """Fundamental matrix from two Euler-parameterised cameras sharing
    intrinsics: F = K^-T [t]_x R K^-1 with R, t the relative world->camera
    motion.  Functional replacement for the reference's
    calcFundamentalMatrix_2View (Image.cu:716) used by the plain-constrained
    matcher; the reference builds the same object through an axis-angle
    decomposition dance.
    """
    cx = size[..., 0].astype(jnp.float32) / 2.0
    cy = size[..., 1].astype(jnp.float32) / 2.0
    zero = jnp.zeros_like(foc_pixels)
    one = jnp.ones_like(foc_pixels)
    K = jnp.stack(
        [
            jnp.stack([foc_pixels, zero, cx], -1),
            jnp.stack([zero, foc_pixels, cy], -1),
            jnp.stack([zero, zero, one], -1),
        ],
        axis=-2,
    )
    R0 = rotation_matrix(cam_rot0)
    R1 = rotation_matrix(cam_rot1)
    # world->cam transforms
    R0t = jnp.swapaxes(R0, -1, -2)
    R1t = jnp.swapaxes(R1, -1, -2)
    # relative motion taking cam0 coords to cam1 coords
    R_rel = jnp.matmul(R1t, R0, precision="highest")
    t_rel = _einsum("...ij,...j->...i", R1t, cam_pos0 - cam_pos1)
    tx = skew(t_rel)
    E = jnp.matmul(tx, R_rel, precision="highest")
    K_inv = jnp.linalg.inv(K)
    return jnp.matmul(jnp.matmul(jnp.swapaxes(K_inv, -1, -2), E, precision="highest"), K_inv, precision="highest")


def skew(v: jax.Array) -> jax.Array:
    """Cross-product (skew-symmetric) matrix: skew(v) @ u = v x u."""
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -v[..., 2], v[..., 1]], -1),
            jnp.stack([v[..., 2], zero, -v[..., 0]], -1),
            jnp.stack([-v[..., 1], v[..., 0], zero], -1),
        ],
        axis=-2,
    )


def point_line_distance_2d(pts: jax.Array, lines: jax.Array) -> jax.Array:
    """Distance of 2-D points (...,2) to homogeneous lines (...,3)."""
    num = jnp.abs(lines[..., 0] * pts[..., 0] + lines[..., 1] * pts[..., 1] + lines[..., 2])
    den = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    return num / jnp.maximum(den, 1e-12)


def point_segment_distance_2d(p: jax.Array, a: jax.Array, b: jax.Array) -> jax.Array:
    """Distance of points p (...,2) to 2-D segments [a, b] (...,2).

    Matches the double-constrained match kernel's in-segment epipolar test
    (MatchFactory.cu:1507-1597): distance to the segment, not the infinite
    line.
    """
    ab = b - a
    ap = p - a
    denom = jnp.maximum(jnp.sum(ab * ab, axis=-1), 1e-20)
    t = jnp.clip(jnp.sum(ap * ab, axis=-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return jnp.linalg.norm(p - proj, axis=-1)
