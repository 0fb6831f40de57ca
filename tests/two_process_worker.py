"""Worker for the 2-process jax.distributed smoke test (VERDICT r3 #6 +
r4 #2: the per-device-placement stages run multi-host for real).

Run as: python tests/two_process_worker.py <process_id> <port>

Each of the 2 processes pins the CPU platform, forces 4 virtual local
devices, joins the jax.distributed cluster (the bring-up path of
ssrlcv_tpu.parallel.mesh.initialize_distributed), builds the global
(4, 2) mesh spanning both processes, and runs:

  * sharded_best_target — exact agreement with a local numpy oracle
  * sharded_ba_step — agreement with the dense single-process
    objective/gradient step computed locally
  * sharded_generate_features — image-parallel SIFT across BOTH processes,
    exact agreement with the same per-image program run locally
  * sharded_pairwise_index_matches — the N-view pair sweep split across
    processes, exact agreement with the serial sweep
  * run_pipeline end-to-end over the global mesh — cloud/BA agreement with
    the same pipeline on a local-devices-only mesh

Exits non-zero on any mismatch; the parent test asserts both exit codes.
"""

import os
import sys


def main(pid: int, port: int) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    # NOTE: no persistent compilation cache here — this environment routes
    # compiles through a remote helper whose CPU features differ from the
    # host, and loading its cached CPU AOT results locally risks SIGILL
    # (observed: cpu_aot_loader "+prefer-no-gather not supported" + dead
    # worker).  The worker pays its compiles fresh instead.

    from ssrlcv_tpu.parallel.mesh import (
        DATA_AXIS, FEAT_AXIS, initialize_distributed, make_mesh)

    initialize_distributed(
        coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 8, jax.device_count()

    mesh = make_mesh(jax.devices(), data=4, feat=2)
    from jax.experimental import multihost_utils

    from ssrlcv_tpu.parallel import sharded

    # --- distributed brute-force matching vs numpy oracle -----------------
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    t = rng.integers(0, 256, (128, 128)).astype(np.uint8)
    tv = rng.random(128) > 0.1

    qg = jax.device_put(q, NamedSharding(mesh, P(DATA_AXIS)))
    tg = jax.device_put(t, NamedSharding(mesh, P(FEAT_AXIS)))
    tvg = jax.device_put(tv, NamedSharding(mesh, P(FEAT_AXIS)))
    bi, bd = sharded.sharded_best_target(mesh, qg, tg, tvg)
    bi_np = np.asarray(multihost_utils.process_allgather(bi, tiled=True))
    bd_np = np.asarray(multihost_utils.process_allgather(bd, tiled=True))

    d = ((q.astype(np.int64)[:, None, :] - t.astype(np.int64)[None, :, :]) ** 2).sum(-1)
    d = np.where(tv[None, :], d, np.iinfo(np.int64).max).astype(np.float64)
    ref_idx = d.argmin(axis=1)  # first minimum — the kernel's tie-break
    ref_dist = d.min(axis=1)
    np.testing.assert_array_equal(bi_np, ref_idx)
    np.testing.assert_array_equal(bd_np, ref_dist)

    # --- distributed BA LM step vs the dense local objective --------------
    from ssrlcv_tpu.ba.two_view import _pack, make_objective
    from ssrlcv_tpu.core.types import Cameras, MatchSet
    from ssrlcv_tpu.parallel.sharded import _lm_solve

    n_cams, tracks = 2, 64
    cams = Cameras(
        cam_pos=np.asarray(rng.normal(0, 10, (n_cams, 3)), np.float32),
        cam_rot=np.asarray(rng.normal(0, 0.1, (n_cams, 3)), np.float32),
        fov=np.full((n_cams, 2), 0.0418879, np.float32),
        foc=np.full((n_cams,), 0.8593, np.float32),
        dpix=np.full((n_cams, 2), 3.515625e-05, np.float32),
        size=np.full((n_cams, 2), 1024, np.int32),
        ecef_offset=np.zeros((n_cams, 3), np.float32),
        timestamp=np.zeros((n_cams,), np.int32),
    )
    kp_loc = np.asarray(rng.uniform(100, 900, (tracks, 2, 2)), np.float32)
    ms_np = MatchSet(
        kp_loc=kp_loc,
        kp_parent=np.tile(np.array([0, 1], np.int32), (tracks, 1)),
        num_views=np.full((tracks,), 2, np.int32),
        mask=np.ones((tracks,), bool),
    )
    sh = NamedSharding(mesh, P(DATA_AXIS))
    ms_g = MatchSet(
        kp_loc=jax.device_put(ms_np.kp_loc, sh),
        kp_parent=jax.device_put(ms_np.kp_parent, sh),
        num_views=jax.device_put(ms_np.num_views, sh),
        mask=jax.device_put(ms_np.mask, sh),
    )
    # cameras stay replicated: uncommitted jnp leaves (identical values in
    # every process) close over the shard_map kernel as constants
    cams = jax.tree_util.tree_map(jnp.asarray, cams)
    p0 = _pack(cams).reshape(-1)
    lam = 1e-3
    new_p, err = sharded.sharded_ba_step(mesh, ms_g, cams, p0, lam)
    # P() outputs are replicated: every addressable shard holds the value
    new_p_np = np.asarray(new_p.addressable_shards[0].data)
    err_np = float(np.asarray(err.addressable_shards[0].data))

    # dense single-process reference on local arrays
    obj = make_objective(ms_np, cams)
    flat_obj = lambda p: obj(p.reshape(n_cams, 6))
    g = jax.grad(flat_obj)(p0)
    H = jax.hessian(flat_obj)(p0)
    free = jnp.ones((n_cams, 6)).at[0].set(0.0).reshape(-1)
    step = _lm_solve(H, g * free, jnp.asarray(lam), free)
    ref_p = np.asarray(p0 - step * free)

    np.testing.assert_allclose(err_np, float(flat_obj(p0)), rtol=1e-6)
    np.testing.assert_allclose(new_p_np.reshape(-1), ref_p, rtol=1e-4, atol=1e-7)

    # --- multi-host image-parallel SIFT (VERDICT r4 #2) -------------------
    from ssrlcv_tpu.config import MatchParams, SIFTParams
    from ssrlcv_tpu.features.sift import generate_features

    # process-INTERLEAVED device order: consecutive mesh slots alternate
    # between the two processes, so 2 images / 3 pairs really do land on
    # both hosts (the default order would give them all to process 0)
    devs = jax.devices()
    inter = [devs[(i % 2) * 4 + i // 2] for i in range(8)]
    assert {d.process_index for d in inter[:2]} == {0, 1}
    mesh_i = make_mesh(inter, data=4, feat=2)

    # small feature capacity: the default 65536 makes the sharded 2-view
    # matcher's local distance tile (16k x 32k f32 per virtual device, x
    # several fusion copies) balloon past 60 GB host RAM on the CPU backend
    # (observed OOM kill) — the 128x128 synthetic images have ~2k features
    sp = SIFTParams(max_keypoints=4096)
    base = (rng.random((128, 128)) * 255).astype(np.uint8)
    img1 = np.roll(base, 8, axis=1)  # shifted copy: guaranteed true matches
    px = np.stack([base, img1])

    feats, sat, ovf = sharded.sharded_generate_features(
        mesh_i, jnp.asarray(px), [0, 1], sp)
    assert len(feats) == 2
    for i in range(2):
        # oracle: the SAME per-image fused program run on a local device
        ref_fs = generate_features(px[i], sp, image_id=i, fused=True)
        for name in ("loc", "sigma", "theta", "descriptors", "mask", "parent"):
            np.testing.assert_array_equal(
                np.asarray(getattr(feats[i], name)),
                np.asarray(getattr(ref_fs, name)), err_msg=f"img{i}.{name}")
    n_feat = int(np.asarray(feats[0].mask).sum())
    assert n_feat > 50, f"synthetic image produced only {n_feat} features"

    # --- multi-host N-view pair sweep (VERDICT r4 #2) ---------------------
    from ssrlcv_tpu.matching.tracks import pairwise_index_matches

    feats3 = feats + [generate_features(np.roll(base, 16, axis=1), sp,
                                        image_id=2, fused=True)]
    mp = MatchParams(mode="brute")
    got_pairs = sharded.sharded_pairwise_index_matches(mesh_i, feats3, cams, mp)
    ref_pairs = pairwise_index_matches(feats3, cams, mp)
    assert set(got_pairs) == set(ref_pairs)
    total = 0
    for key in ref_pairs:
        np.testing.assert_array_equal(got_pairs[key], ref_pairs[key],
                                      err_msg=f"pair {key}")
        total += len(ref_pairs[key])
    assert total > 50, f"pair sweep found only {total} matches"

    # --- end-to-end pipeline over the global mesh (VERDICT r4 #2) ---------
    import dataclasses
    import tempfile

    from ssrlcv_tpu.config import PipelineConfig
    from ssrlcv_tpu.io.refdata import RefImage
    from ssrlcv_tpu.pipeline.stages import PipelineState, run_pipeline

    # consistent miniature stereo geometry: cam1 offset -1 km along x, both
    # looking +z; the global +8 px x-roll of img1 is then a fronto-parallel
    # plane at depth foc*B/(8*dpix) = 12.5 km, so triangulation errors are
    # ~0 and the filters keep the cloud
    mini_fov = 2.0 * np.arctan(1e-3 * 64 / 0.1)

    def ref_image(i, pixels):
        return RefImage(
            id=i, size=(128, 128), color_depth=1,
            cam_pos=np.asarray([-1.0 * i, 0.0, 0.0], np.float32),
            cam_rot=np.zeros(3, np.float32),
            fov=np.asarray([mini_fov, mini_fov], np.float32), foc=0.1,
            dpix=np.asarray([1e-3, 1e-3], np.float32), timestamp=0,
            ecef_offset=np.zeros(3, np.float32), is_pushbroom=False,
            pixels=pixels,
        )

    outdir = tempfile.mkdtemp(prefix=f"sfm2p{pid}-")
    config = PipelineConfig(output_dir=outdir).replace(match=mp, sift=sp)
    images = [ref_image(0, base), ref_image(1, img1)]

    def run(with_mesh):
        st = PipelineState(
            config=config,
            images=[dataclasses.replace(im) for im in images],
            mesh=with_mesh)
        return run_pipeline(st)

    got = run(mesh_i)                                     # 2 processes
    local_mesh = make_mesh(jax.local_devices(), data=4, feat=1)
    ref = run(local_mesh)                                 # this process only

    gm = np.asarray(got.cloud.mask)
    rm = np.asarray(ref.cloud.mask)
    assert rm.sum() > 20, f"e2e reconstruction collapsed: {rm.sum()} points"
    # filter cutoffs are float sums whose reduction order differs between the
    # 8-shard and 4-shard partitions: borderline tracks may flip
    agree = (gm == rm).mean()
    assert agree > 0.99, f"cloud masks agree only {agree:.3%}"
    both = gm & rm
    np.testing.assert_allclose(
        np.asarray(got.cloud.points)[both], np.asarray(ref.cloud.points)[both],
        rtol=1e-3, atol=1e-5)
    ge, re_ = got.ba_error, ref.ba_error
    assert abs(ge[1] - re_[1]) <= 1e-2 * max(abs(re_[1]), 1e-6), (ge, re_)

    print(f"worker {pid}: OK ({jax.process_count()} processes, "
          f"{jax.device_count()} global devices, e2e {int(both.sum())} points)")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
