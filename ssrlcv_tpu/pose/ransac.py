"""RANSAC 7-point fundamental-matrix estimation + essential decomposition.

Re-design of PoseEstimator::estimatePoseRANSAC (PoseEstimator.cu:13-312):
the reference batches 7-match systems through cusolverDnSgesvdjBatched and a
per-candidate inlier count; here the whole candidate population is one
batched ``jnp.linalg.svd`` + Newton root solve + a (candidates x matches)
inlier matrix — fully vectorised, no per-candidate kernel launches.

Semantics preserved:
  * 7-point nullspace: last two right-singular vectors F1, F2 of the 7x9
    system; det(x F1 + (1-x) F2) = 0 solved by Newton from x=0, 50 steps
    (computeFMatrixAndInliers, PoseEstimator.cu:521-600)
  * inlier test: symmetric epipolar distance
    (x2^T F x1)^2 / (||F x1||_xy^2 + ||F^T x2||_xy^2) < 0.25
  * essential decomposition E = K^T F K -> 4 (R, t) candidates, cheirality
    vote picks the one with most points in front of both cameras.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssrlcv_tpu.core.types import Cameras, MatchSet

_einsum = partial(jnp.einsum, precision="highest")


class RansacResult(NamedTuple):
    F: jax.Array           # (3, 3) best fundamental matrix
    inliers: jax.Array     # (N,) bool
    num_inliers: jax.Array
    R: jax.Array           # (3, 3) relative rotation (cheirality winner)
    t: jax.Array           # (3,) unit translation


def _det3(m):
    return jnp.linalg.det(m)


def _seven_point_candidates(q, t, key, num_candidates):
    """Sample 7-match subsets and solve for F candidates.

    q, t: (N, 2) pixel locations.  Returns (C, 3, 3) candidate F matrices and
    a (C,) validity flag.
    """
    n = q.shape[0]
    idx = jax.random.randint(key, (num_candidates, 7), 0, n)
    q7 = q[idx]  # (C, 7, 2)
    t7 = t[idx]
    # rows of A: [x2 x1, x2 y1, x2, y2 x1, y2 y1, y2, x1, y1, 1] with
    # x1 = query, x2 = target (epipolar constraint x2^T F x1 = 0)
    x1, y1 = q7[..., 0], q7[..., 1]
    x2, y2 = t7[..., 0], t7[..., 1]
    one = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )  # (C, 7, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F1 = Vt[:, 7, :].reshape(-1, 3, 3)
    F2 = Vt[:, 8, :].reshape(-1, 3, 3)

    # cubic det(x F1 + (1-x) F2) = 0, Newton from 0 (50 iterations)
    def poly(x):
        M = x[:, None, None] * F1 + (1 - x)[:, None, None] * F2
        return _det3(M)

    grad_poly = jax.vmap(jax.grad(lambda x, f1, f2: _det3(x * f1 + (1 - x) * f2)))

    x = jnp.zeros(F1.shape[0])

    def newton(i, x):
        fx = poly(x)
        fpx = grad_poly(x, F1, F2)
        return x - fx / jnp.where(jnp.abs(fpx) > 1e-20, fpx, 1e-20)

    x = jax.lax.fori_loop(0, 50, newton, x)
    ok = jnp.abs(poly(x)) < 1e-5
    F = x[:, None, None] * F1 + (1 - x)[:, None, None] * F2
    return F, ok


def _symmetric_epipolar_sq(F, q, t):
    """(C, N) squared symmetric epipolar distance (PoseEstimator.cu:570-598)."""
    qh = jnp.concatenate([q, jnp.ones_like(q[:, :1])], axis=1)  # (N, 3)
    th = jnp.concatenate([t, jnp.ones_like(t[:, :1])], axis=1)
    Fx1 = jnp.einsum("cij,nj->cni", F, qh, precision="highest")
    Ftx2 = jnp.einsum("cji,nj->cni", F, th, precision="highest")
    num = jnp.einsum("ni,cni->cn", th, Fx1, precision="highest") ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    )
    return num / jnp.maximum(den, 1e-20)


@partial(jax.jit, static_argnames=("num_candidates",))
def estimate_pose_ransac(
    matches: MatchSet,
    cameras: Cameras,
    key: jax.Array,
    inlier_threshold: float = 0.25,
    num_candidates: int = 2048,
) -> RansacResult:
    q = matches.kp_loc[:, 0]
    t = matches.kp_loc[:, 1]
    valid = matches.mask

    F_cands, ok = _seven_point_candidates(q, t, key, num_candidates)
    d = _symmetric_epipolar_sq(F_cands, q, t)  # (C, N)
    inl = (d < inlier_threshold) & valid[None, :]
    counts = jnp.sum(inl, axis=1) * ok
    best = jnp.argmax(counts)
    F = F_cands[best]
    inliers = inl[best]

    # intrinsics (foc in px: foc/dpix — getProjectionMatrix convention)
    fx = cameras.foc[0] / cameras.dpix[0, 0]
    cx = cameras.size[0, 0].astype(jnp.float32) / 2.0
    cy = cameras.size[0, 1].astype(jnp.float32) / 2.0
    K = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], F.dtype
    )
    K = K.at[0, 0].set(fx).at[1, 1].set(fx).at[0, 2].set(cx).at[1, 2].set(cy)
    # K holds focal lengths of ~1e4 px: every product below runs at full
    # float32 precision (a TF32 product would corrupt E and the rotations)
    hi = partial(jnp.matmul, precision="highest")
    E = hi(hi(K.T, F), K)

    U, S, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], F.dtype)
    R1 = hi(hi(U, W), Vt)
    R2 = hi(hi(U, W.T), Vt)
    tvec = U[:, 2]

    Kinv = jnp.linalg.inv(K)

    def cheirality(R, tv):
        # triangulate inlier rays in normalised coords; count points with
        # positive depth in both cameras
        qn = _einsum("ij,nj->ni", Kinv, jnp.concatenate([q, jnp.ones_like(q[:, :1])], 1))
        tn = _einsum("ij,nj->ni", Kinv, jnp.concatenate([t, jnp.ones_like(t[:, :1])], 1))
        # z1 * qn x (R^T(z2*tn - t)) -> use midpoint of rays
        v1 = qn / jnp.linalg.norm(qn, axis=1, keepdims=True)
        v2 = _einsum("ij,nj->ni", R.T, tn)
        v2 = v2 / jnp.linalg.norm(v2, axis=1, keepdims=True)
        p2 = _einsum("ij,j->i", R.T, -tv)
        from ssrlcv_tpu.geometry.triangulation import two_view_midpoints

        s1, s2 = two_view_midpoints(v1, jnp.zeros_like(v1), v2, jnp.broadcast_to(p2, v2.shape))
        X = (s1 + s2) / 2.0
        z1 = X[:, 2]
        Xc2 = _einsum("ij,nj->ni", R, X) + tv
        z2 = Xc2[:, 2]
        return jnp.sum(((z1 > 0) & (z2 > 0)) & inliers)

    votes = jnp.stack(
        [
            cheirality(R1, tvec),
            cheirality(R1, -tvec),
            cheirality(R2, tvec),
            cheirality(R2, -tvec),
        ]
    )
    winner = jnp.argmax(votes)
    R = jnp.where(winner < 2, R1, R2)
    tv = jnp.where(winner % 2 == 0, tvec, -tvec)
    return RansacResult(
        F=F, inliers=inliers, num_inliers=counts[best], R=R, t=tv
    )
