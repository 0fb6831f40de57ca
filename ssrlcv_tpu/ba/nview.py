"""N-view bundle adjustment.

The reference declares this surface but never implemented it
(BundleAdjustNView, PointCloudFactory.cu:2270-2277 — a logged TODO stub).
This module provides the real thing: a damped Newton/LM loop with
exact autodiff gradient and Hessian over all N cameras' 6-dof parameters,
with the N-view objective being the total angular error (sum over tracks of
the mean squared point-line distance after least-squares triangulation).

Camera 0 is pinned (gauge freedom), matching the 2-view convention.  For
large camera counts the (6N)^2 Hessian stays tiny (N cameras, not N points:
the point block is eliminated analytically because the least-squares
triangulation is itself the Schur-complement solve for the points given the
cameras — the structure SURVEY.md §3.5 calls for).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssrlcv_tpu.ba.two_view import lm_solve
from ssrlcv_tpu.config import BAParams
from ssrlcv_tpu.core.types import Cameras, MatchSet, PointCloud
from ssrlcv_tpu.geometry.bundles import generate_bundles
from ssrlcv_tpu.geometry.triangulation import n_view_triangulate


class NViewBAResult(NamedTuple):
    cameras: Cameras
    cloud: PointCloud
    initial_error: jax.Array
    final_error: jax.Array


def _objective(params, matches: MatchSet, cameras: Cameras, n_cams: int):
    cams = cameras.replace(
        cam_pos=params.reshape(n_cams, 6)[:, 0:3],
        cam_rot=params.reshape(n_cams, 6)[:, 3:6],
    )
    bd = generate_bundles(matches, cams)
    pc, total = n_view_triangulate(bd)
    return total, jnp.sum(pc.mask.astype(jnp.float32))


@partial(jax.jit, static_argnames=("iterations", "fix_camera0"))
def bundle_adjust_nview_jit(
    matches: MatchSet,
    cameras: Cameras,
    iterations: int = 10,
    fix_camera0: bool = True,
):
    n_cams = cameras.num_cameras
    p0 = jnp.concatenate([cameras.cam_pos, cameras.cam_rot], axis=1).reshape(-1)
    free = jnp.ones((n_cams, 6), p0.dtype)
    if fix_camera0:
        free = free.at[0].set(0.0)
    free = free.reshape(-1)

    # The raw angular-error objective has a DEGENERATE minimum: tracks whose
    # least-squares system goes singular are masked out of the sum, so the
    # optimiser can "win" by rotating cameras until rays are parallel and
    # every track invalidates (error -> 0 with an empty cloud).  Guard: any
    # candidate that LOSES valid tracks pays a huge penalty — the penalty is
    # piecewise-constant (zero gradient/Hessian, the Newton step is
    # untouched), it only vetoes acceptance of degenerate steps.
    raw = lambda p: _objective(p, matches, cameras, n_cams)
    init_err, n_valid0 = raw(p0)

    def obj_grad(p):
        return raw(p)[0]

    def obj(p):
        e, nv = raw(p)
        return e + 1e6 * jnp.maximum(n_valid0 - nv, 0.0)

    def body(i, state):
        p, best_p, best_e, lam = state
        g = jax.grad(obj_grad)(p) * free
        H = jax.hessian(obj_grad)(p)
        step = lm_solve(H, g, lam, free)
        cand = p - step * free
        e = obj(cand)
        ok = e < best_e
        return (
            jnp.where(ok, cand, best_p),
            jnp.where(ok, cand, best_p),
            jnp.where(ok, e, best_e),
            jnp.where(ok, lam * 0.3, lam * 10.0),
        )

    p, best_p, best_e, _ = jax.lax.fori_loop(
        0, iterations, body, (p0, p0, init_err, jnp.asarray(1e-3, p0.dtype))
    )
    out_cams = cameras.replace(
        cam_pos=best_p.reshape(n_cams, 6)[:, 0:3],
        cam_rot=best_p.reshape(n_cams, 6)[:, 3:6],
    )
    cloud, _ = n_view_triangulate(generate_bundles(matches, out_cams))
    return out_cams, cloud, init_err, best_e


def bundle_adjust_nview(matches: MatchSet, cameras: Cameras, params: BAParams) -> NViewBAResult:
    cams, cloud, e0, e1 = bundle_adjust_nview_jit(
        matches, cameras, iterations=params.iterations, fix_camera0=params.fixed_camera
    )
    return NViewBAResult(cameras=cams, cloud=cloud, initial_error=e0, final_error=e1)
