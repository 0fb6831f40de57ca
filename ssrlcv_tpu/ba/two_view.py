"""Two-view bundle adjustment.

The reference's BundleAdjustTwoView (PointCloudFactory.cu:1832-2262) runs
Newton steps on the 12-dim camera state (2 cameras x {pos, rot}) against the
total linear error, with the gradient and 12x12 Hessian obtained by central
finite differences that re-run the full bundle-generation + triangulation
pipeline ~650 times per iteration.  Here the same objective is differentiated
*exactly* with ``jax.grad`` / ``jax.hessian`` — one fused XLA computation per
iteration instead of 650 kernel-launch round trips — which SURVEY.md §3.5
identifies as the single biggest algorithmic win available.

Faithfulness notes:
  * The reference's default flags are second_order=True, fixed_camera=True
    (PointCloudFactory.cu:1858-1862), and in that configuration its update
    loop ``if (!fixed_camera && j)`` (PointCloudFactory.cu:2149) never
    executes — the shipped BA is a no-op, and the committed golden clouds
    confirm it (2_6float3.uty is bit-identical to 1_6float3.uty).
    ``mode="reference"`` reproduces that exact behaviour for golden parity.
  * ``mode="newton"`` implements the evident intent: alpha-scaled Newton
    steps Delta = alpha * H^+ g with an SVD pseudo-inverse (the cuSOLVER
    Sgesvd path, PointCloudFactory.cu:1511-1830), best-params tracking,
    error-ratio alpha decay, and local-minimum early exit — but actually
    applies the update (camera 0 pinned by zeroing its parameter block).
  * ``mode="lm"`` (default) is a damped Levenberg-Marquardt loop on the same
    objective — the production optimizer.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ssrlcv_tpu.config import BAParams
from ssrlcv_tpu.core.types import Cameras, MatchSet, PointCloud
from ssrlcv_tpu.geometry.bundles import generate_bundles
from ssrlcv_tpu.geometry.triangulation import linear_error_objective, two_view_triangulate


def lm_solve(H, g, lam, free):
    """Damped Levenberg-Marquardt step H_damped^-1 g with pinned parameters
    (``free`` is 1 for a free parameter, 0 for a pinned one: its row and
    column become the identity, so its step is 0).

    The camera block mixes km positions with radian angles, so the damped
    Hessian is badly conditioned: the solve runs at full float32 precision,
    where a GPU's default may round matrix products to TF32."""
    damped = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
    pin = 1.0 - free
    damped = damped * free[:, None] * free[None, :] + jnp.diag(pin)
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.solve(damped, g)


def _apply_params(cameras: Cameras, params: jax.Array) -> Cameras:
    """params: (N, 6) [pos(3), rot(3)] absolute camera state."""
    return cameras.replace(cam_pos=params[:, 0:3], cam_rot=params[:, 3:6])


def _pack(cameras: Cameras) -> jax.Array:
    return jnp.concatenate([cameras.cam_pos, cameras.cam_rot], axis=1)


def make_objective(matches: MatchSet, cameras: Cameras):
    """Total linear error as a function of the packed (N, 6) camera state —
    the exact objective voidTwoViewTriangulate accumulates
    (PointCloudFactory.cu:4766-4878)."""

    def objective(params: jax.Array) -> jax.Array:
        cams = _apply_params(cameras, params)
        bd = generate_bundles(matches, cams)
        return linear_error_objective(bd)

    return objective


class BAResult(NamedTuple):
    cameras: Cameras
    cloud: PointCloud
    initial_error: jax.Array
    final_error: jax.Array
    error_history: jax.Array  # (iterations+1,) padded with final value


@partial(jax.jit, static_argnames=("iterations", "mode", "fix_camera0"))
def bundle_adjust_two_view(
    matches: MatchSet,
    cameras: Cameras,
    iterations: int = 10,
    initial_alpha: float = 0.1,
    svd_rcond: float = 1e-6,
    mode: str = "lm",
    fix_camera0: bool = True,
) -> BAResult:
    """Jit-compiled two-view BA.  See module docstring for modes."""
    objective = make_objective(matches, cameras)
    grad_fn = jax.grad(objective)
    hess_fn = jax.hessian(objective)

    n_cams = cameras.num_cameras
    dim = n_cams * 6
    params0 = _pack(cameras)
    init_err = objective(params0)

    # mask zeroing camera 0's block (reference pins camera 0,
    # PointCloudFactory.cu:2148-2159)
    free = jnp.ones((n_cams, 6), params0.dtype)
    if fix_camera0:
        free = free.at[0].set(0.0)
    free_flat = free.reshape(-1)

    def flat_obj(p_flat):
        return objective(p_flat.reshape(n_cams, 6))

    if mode == "reference":
        # Bug-compatible: no update is ever applied; error history is flat.
        cloud, _ = two_view_triangulate(generate_bundles(matches, cameras))
        hist = jnp.full((iterations + 1,), init_err)
        return BAResult(cameras, cloud, init_err, init_err, hist)

    def newton_step(state):
        params, best_params, best_err, prev_err, alpha, lam, it, done, hist = state
        g = jax.grad(flat_obj)(params.reshape(-1)) * free_flat
        H = jax.hessian(flat_obj)(params.reshape(-1))
        # SVD pseudo-inverse with clamped singular values
        # (calculateImageHessianInverse, PointCloudFactory.cu:1511-1830)
        U, S, Vt = jnp.linalg.svd(H, full_matrices=False)
        s_max = jnp.max(S)
        s_inv = jnp.where(S > svd_rcond * s_max, 1.0 / S, 0.0)
        step = jnp.matmul(Vt.T * s_inv[None, :],
                          jnp.matmul(U.T, g, precision="highest"),
                          precision="highest")
        new_params = params - alpha * (step * free_flat).reshape(n_cams, 6)
        return new_params, lam

    def lm_step(state):
        params, best_params, best_err, prev_err, alpha, lam, it, done, hist = state
        g = jax.grad(flat_obj)(params.reshape(-1)) * free_flat
        H = jax.hessian(flat_obj)(params.reshape(-1))
        step = lm_solve(H, g, lam, free_flat)
        new_params = params - (step * free_flat).reshape(n_cams, 6)
        return new_params, lam

    def body(i, state):
        params, best_params, best_err, prev_err, alpha, lam, it, done, hist = state

        new_params, _ = (newton_step if mode == "newton" else lm_step)(state)
        new_err = objective(new_params)
        improved = new_err < best_err

        # alpha decay by error ratio (PointCloudFactory.cu:2190-2205);
        # lambda adaptation for LM
        ratio = jnp.where(new_err > 0, prev_err / jnp.maximum(new_err, 1e-30), 1.0)
        alpha2 = jnp.where(improved & (i > 0), alpha / jnp.maximum(ratio, 1e-12), alpha)
        lam2 = jnp.where(improved, lam * 0.3, lam * 10.0)

        # on failure: revert to best; first failure halves alpha, later ones stop
        params2 = jnp.where(improved, new_params, best_params)
        alpha3 = jnp.where(improved, alpha2, jnp.where(i == 0, alpha / 100.0, alpha2))
        done2 = done | (~improved & (i > 0))

        best_params2 = jnp.where(improved, new_params, best_params)
        best_err2 = jnp.where(improved, new_err, best_err)
        hist2 = hist.at[i + 1].set(jnp.where(improved, new_err, best_err))

        new_state = (
            params2, best_params2, best_err2,
            jnp.where(improved, new_err, prev_err),
            alpha3, lam2, it + 1, done2, hist2,
        )
        # freeze state once done (reference breaks out of the loop)
        return jax.tree_util.tree_map(
            lambda new, old: jnp.where(done, old, new), new_state, state
        )

    hist0 = jnp.full((iterations + 1,), init_err)
    state0 = (
        params0, params0, init_err, init_err,
        jnp.asarray(initial_alpha, params0.dtype),
        jnp.asarray(1e-3, params0.dtype),
        jnp.asarray(0), jnp.asarray(False), hist0,
    )
    final_state = jax.lax.fori_loop(0, iterations, body, state0)
    best_params, best_err, hist = final_state[1], final_state[2], final_state[8]

    out_cams = _apply_params(cameras, best_params)
    cloud, _ = two_view_triangulate(generate_bundles(matches, out_cams))
    return BAResult(out_cams, cloud, init_err, best_err, hist)


def bundle_adjust(matches: MatchSet, cameras: Cameras, params: BAParams, mode: str = "lm") -> BAResult:
    """Config-driven entry point (Pipeline doBundleAdjust analogue,
    Pipeline.cu:371-383)."""
    return bundle_adjust_two_view(
        matches,
        cameras,
        iterations=params.iterations,
        initial_alpha=params.initial_alpha,
        svd_rcond=params.svd_rcond,
        mode=mode,
        fix_camera0=params.fixed_camera,
    )
