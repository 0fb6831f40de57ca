"""Levenberg-Marquardt relative-pose refinement.

Re-design of PoseEstimator::LM_optimize (PoseEstimator.cu:314-520).
The residual per match is the skew-line closest-point gap (s1 - s2, 0) in the
relative frame (query camera at origin/identity; target at pose position with
Euler rotation) — getResidual, PoseEstimator.cu:754-820.  The reference
differentiates it by central finite differences *and zeroes the position
columns* (computeResidualsAndJacobian, PoseEstimator.cu:647-738), so only
rotation is optimised; we keep that structure but compute the rotation block
with exact autodiff.

LM schedule replicated: JTJ + lambda*I, SVD pseudo-inverse with singular
values <= 1e-4 clamped, delta = -JTJ^+ JTf; on rejection lambda *= 2 (max 20
inner tries), on acceptance lambda /= 4; up to 50 outer iterations.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssrlcv_tpu.config import PoseParams
from ssrlcv_tpu.core import camera_math
from ssrlcv_tpu.core.types import Cameras, MatchSet


class Pose(NamedTuple):
    """roll/pitch/yaw + position (reference Pose, PoseEstimator.cuh:20)."""

    rot: jax.Array  # (3,) roll, pitch, yaw
    pos: jax.Array  # (3,) in 1/1000 km units (as the reference stores it)


def _residuals(rot, pos, q_loc, t_loc, q_dpix, q_foc, q_size, t_dpix, t_foc, t_size):
    """(N, 4) skew-line gap residuals (getResidual)."""
    qvec = jnp.stack(
        [
            q_dpix[0] * (q_loc[:, 0] - q_size[0] / 2.0),
            q_dpix[1] * (q_loc[:, 1] - q_size[1] / 2.0),
            jnp.full_like(q_loc[:, 0], q_foc),
        ],
        axis=-1,
    )
    qvec = qvec / jnp.linalg.norm(qvec, axis=-1, keepdims=True)
    tvec = jnp.stack(
        [
            t_dpix[0] * (t_loc[:, 0] - t_size[0] / 2.0),
            t_dpix[1] * (t_loc[:, 1] - t_size[1] / 2.0),
            jnp.full_like(t_loc[:, 0], t_foc),
        ],
        axis=-1,
    )
    tvec = camera_math.rotate_point(tvec, rot)
    tvec = tvec / jnp.linalg.norm(tvec, axis=-1, keepdims=True)

    qpnt = jnp.zeros_like(qvec)
    tpnt = jnp.broadcast_to(pos, tvec.shape)

    from ssrlcv_tpu.geometry.triangulation import two_view_midpoints

    s1, s2 = two_view_midpoints(qvec, qpnt, tvec, tpnt)
    gap = s1 - s2
    return jnp.concatenate([gap, jnp.zeros_like(gap[:, :1])], axis=1)


def lm_optimize(
    matches: MatchSet,
    cameras: Cameras,
    params: PoseParams,
) -> Pose:
    """Run the reference's LM loop on the 2-view match set.  Initial pose
    from camera telemetry (LM_optimize:324-331 + Pipeline.cu:105-122)."""
    q_rot = cameras.cam_rot[0]
    # initial relative rotation: R_rel = R0^T R1
    R0 = camera_math.rotation_matrix(cameras.cam_rot[0])
    R1 = camera_math.rotation_matrix(cameras.cam_rot[1])
    rel = jnp.matmul(R0.T, R1, precision="highest")
    rot0 = camera_math.axis_rotations(rel)
    # initial relative position (LM_optimize: target - query, de-rotated by
    # query Euler angles applied in z,y,x order, /1000)
    pos = cameras.cam_pos[1] - cameras.cam_pos[0]
    pos = camera_math.rotate_point_arbitrary(pos, jnp.array([0.0, 0.0, 1.0]), -q_rot[2])
    pos = camera_math.rotate_point_arbitrary(pos, jnp.array([0.0, 1.0, 0.0]), -q_rot[1])
    pos = camera_math.rotate_point_arbitrary(pos, jnp.array([1.0, 0.0, 0.0]), -q_rot[0])
    pos0 = pos / 1000.0

    rot, pos = _lm_loop(
        rot0, pos0, jnp.asarray(params.initial_lambda, jnp.float32),
        matches.kp_loc[:, 0], matches.kp_loc[:, 1], matches.mask,
        cameras.dpix[0], cameras.foc[0], cameras.size[0].astype(jnp.float32),
        cameras.dpix[1], cameras.foc[1], cameras.size[1].astype(jnp.float32),
        params.max_outer_iterations, params.max_inner_iterations,
    )
    return Pose(rot=rot, pos=pos)


@partial(jax.jit, static_argnames=("max_outer", "max_inner"))
def _lm_loop(rot0, pos0, lam0, q_loc, t_loc, mask,
             q_dpix, q_foc, q_size, t_dpix, t_foc, t_size,
             max_outer: int, max_inner: int):
    """The whole LM schedule as ONE module-level jitted device program —
    jitting a per-call closure re-traced every invocation (~0.8 s of host
    trace time on top of ~30 ms of device time)."""

    def res_fn(rot, pos):
        r = _residuals(rot, pos, q_loc, t_loc, q_dpix, q_foc, q_size, t_dpix, t_foc, t_size)
        return jnp.where(mask[:, None], r, 0.0)

    def cost_fn(rot, pos):
        r = res_fn(rot, pos)
        return jnp.sum(r * r)

    def outer(state):
        rot, pos, lam, done, it = state
        r = res_fn(rot, pos)                       # (N, 4)
        Jrot = jax.jacfwd(lambda rr: res_fn(rr, pos))(rot)  # (N, 4, 3)
        J = jnp.concatenate([Jrot, jnp.zeros_like(Jrot)], axis=2)  # pos cols zeroed
        Jf = J.reshape(-1, 6)
        rf = r.reshape(-1)
        JTJ0 = jnp.einsum("ni,nj->ij", Jf, Jf, precision="highest")
        JTf = jnp.einsum("ni,n->i", Jf, rf, precision="highest")
        cost = jnp.sum(rf * rf)

        # inner damping search, BATCHED: the reference's sequential loop
        # (PoseEstimator.cu:430-480) tries lambda, 2*lambda, 4*lambda, ...
        # until a candidate lowers the cost — a deterministic schedule, so
        # all max_inner candidates evaluate at once (one vmapped 6x6 solve +
        # one vmapped cost pass) and argmax picks the FIRST acceptance —
        # the same decision sequence up to f32 reduction-order noise in the
        # vmapped cost sums.
        lams = lam * (2.0 ** jnp.arange(max_inner, dtype=jnp.float32))

        def solve(lam_i):
            # JTJ + lam*I is symmetric PSD, so its SVD pseudo-inverse with
            # the reference's 1e-4 singular-value clamp equals the eigh
            # pseudo-inverse (identical matrix, U = V) — and symmetric eig
            # is cheaper than SVD
            JTJ = JTJ0 + lam_i * jnp.eye(6)
            S, V = jnp.linalg.eigh(JTJ)
            s_inv = jnp.where(S > 1e-4, 1.0 / S, 0.0)
            return -jnp.matmul(V * s_inv[None, :],
                               jnp.matmul(V.T, JTf, precision="highest"),
                               precision="highest")

        deltas = jax.vmap(solve)(lams)                      # (I, 6)
        cand_rot = rot[None, :] + deltas[:, 0:3]
        cand_pos = pos[None, :] + deltas[:, 3:6]
        costs = jax.vmap(cost_fn)(cand_rot, cand_pos)       # (I,)
        ok = costs < cost
        accepted = jnp.any(ok)
        k = jnp.argmax(ok)                                  # first acceptance
        new_rot = cand_rot[k]
        new_pos = cand_pos[k]
        # sequential lambda semantics: each reject doubled it; acceptance at
        # k leaves lambda = lam*2^k (then /4 below); full rejection leaves
        # the fully-doubled value
        lam_f = jnp.where(accepted, lams[k], lam * 2.0 ** max_inner)
        return (
            jnp.where(accepted, new_rot, rot),
            jnp.where(accepted, new_pos, pos),
            jnp.where(accepted, lam_f / 4.0, lam_f),
            done | ~accepted,
            it + 1,
        )

    # the whole <=50-outer-iteration LM schedule runs as DEVICE control flow
    # (one dispatch, one fetch) instead of the reference's host loop, which
    # would pay a device->host round trip per iteration — same pattern as
    # ba/two_view's fori_loop
    def outer_cond(state):
        _, _, _, done, it = state
        return (~done) & (it < max_outer)

    state0 = (rot0, pos0, lam0, jnp.asarray(False), jnp.int32(0))
    rot, pos, _, _, _ = jax.lax.while_loop(outer_cond, outer, state0)
    return rot, pos


def apply_pose(cameras: Cameras, pose: Pose) -> Cameras:
    """Write the refined relative pose back into camera 1
    (Pipeline.cu:127-135): pos1 = pos0 + R(rot0) @ (1000*pose.pos);
    R1 = R(rot0) @ R(pose.rot)."""
    new_pos = cameras.cam_pos[0] + camera_math.rotate_point(
        1000.0 * pose.pos, cameras.cam_rot[0]
    )
    R = jnp.matmul(
        camera_math.rotation_matrix(cameras.cam_rot[0]),
        camera_math.rotation_matrix(pose.rot),
        precision="highest",
    )
    new_rot = camera_math.axis_rotations(R)
    return cameras.replace(
        cam_pos=cameras.cam_pos.at[1].set(new_pos),
        cam_rot=cameras.cam_rot.at[1].set(new_rot),
    )


def refine_relative_pose(matches: MatchSet, cameras: Cameras, params: PoseParams) -> Cameras:
    """doPoseEstimation's LM path (Pipeline.cu:74-171)."""
    pose = lm_optimize(matches, cameras, params)
    return apply_pose(cameras, pose)
