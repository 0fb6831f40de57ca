"""Sharded pipeline stages: distributed matching, triangulation, BA.

New engineering (the reference is strictly single-GPU): the three
scaling-critical stages expressed with ``shard_map`` over the (data, feat)
mesh so XLA inserts the collectives:

  * matching — queries sharded over ``data``, targets sharded over ``feat``;
    each device sweeps its local queries in chunks against its local
    targets (with the epipolar-segment predicate fused in), then a min-reduction over ``feat`` (pmin with index
    packing) produces the global best match per query without ever
    materialising the full matrix.
  * triangulation — embarrassingly data-parallel over tracks; expressed as a
    sharding constraint so jit partitions it automatically.
  * bundle adjustment — per-shard gradient/Hessian blocks of the linear
    error objective psum-reduced over ``data``; the (6N)x(6N) camera solve is
    replicated (the Schur-style pattern from SURVEY.md §5).  The full LM
    driver (``sharded_bundle_adjust``) mirrors ba/two_view's lambda-adaptive
    loop so sharded and single-device runs converge identically.

These are wired into the pipeline via ``run_pipeline(state, mesh=...)``
(pipeline/stages.py) and validated against the single-device stages on the
virtual 8-device CPU mesh in tests/test_sharded.py.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ssrlcv_tpu.ba.two_view import lm_solve
from ssrlcv_tpu.config import MatchParams
from ssrlcv_tpu.core.types import Cameras, FeatureSet, MatchSet
from ssrlcv_tpu.geometry.bundles import generate_bundles
from ssrlcv_tpu.geometry.triangulation import linear_error_objective, two_view_triangulate
from ssrlcv_tpu.matching.distance import best_target_chunked
from ssrlcv_tpu.parallel.mesh import DATA_AXIS, FEAT_AXIS


def _pad_to(x: jax.Array, multiple: int, fill=0) -> jax.Array:
    """Pad the leading axis up to a multiple (static shapes for shard_map)."""
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad, constant_values=fill)


def pad_matchset(ms: MatchSet, multiple: int) -> MatchSet:
    """Pad tracks (mask False) so the track axis divides the data axis."""
    return MatchSet(
        kp_loc=_pad_to(ms.kp_loc, multiple),
        kp_parent=_pad_to(ms.kp_parent, multiple, fill=-1),
        num_views=_pad_to(ms.num_views, multiple),
        mask=_pad_to(ms.mask, multiple),
    )


def sharded_best_target(
    mesh: Mesh,
    q_desc,
    t_desc,
    t_valid,
    p1: Optional[jax.Array] = None,
    p2: Optional[jax.Array] = None,
    t_loc: Optional[jax.Array] = None,
    epsilon: float = 0.0,
):
    """Distributed brute-force kNN: returns (best_idx, best_dist) per query.

    q: (Nq, 128) sharded over data; t: (Nt, 128) sharded over feat.
    Nq % data_size == 0 and Nt % feat_size == 0 required (pad first).

    When (p1, p2, t_loc) are given, the double-constrained epipolar-segment
    predicate (MatchFactory.cu:1551-1567) is fused into the local distance
    tile, exactly as in the single-device paths.
    """
    feat_size = mesh.shape[FEAT_AXIS]
    nt_shard = t_desc.shape[0] // feat_size
    constrained = p1 is not None

    def kernel(q, t, tv, *aux):
        # the local (nq_shard, nt_shard) problem is swept in query chunks
        # exactly as on one device, so no full local distance tile exists
        mask_fn = mask_aux = None
        if constrained:
            from ssrlcv_tpu.matching.match import _epipolar_segment_mask

            lp1, lp2, ltl = aux
            mask_fn = lambda a, b: _epipolar_segment_mask(a, b, ltl, epsilon)
            mask_aux = (lp1, lp2)
        li, ld = best_target_chunked(q, t, tv, mask_fn=mask_fn, mask_aux=mask_aux)
        # globalise the target index for this feat shard
        shard = jax.lax.axis_index(FEAT_AXIS)
        gi = li + shard * nt_shard
        # two min-reductions over the feat axis: global min distance, then
        # the lowest global index among shards achieving it (exact integer
        # distances make the equality test safe)
        bd = jax.lax.pmin(ld, FEAT_AXIS)
        cand = jnp.where(ld == bd, gi, jnp.int32(2**31 - 1))
        bi = jax.lax.pmin(cand, FEAT_AXIS)
        return bi, bd

    in_specs = [P(DATA_AXIS, None), P(FEAT_AXIS, None), P(FEAT_AXIS)]
    args = [q_desc, t_desc, t_valid]
    if constrained:
        in_specs += [P(DATA_AXIS, None), P(DATA_AXIS, None), P(FEAT_AXIS, None)]
        args += [p1, p2, t_loc]
    return shard_map(
        kernel,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
    )(*args)


def sharded_match_double_constrained(
    mesh: Mesh,
    query: FeatureSet,
    target: FeatureSet,
    cameras: Cameras,
    query_index: int,
    target_index: int,
    params: MatchParams,
    seed_dist: Optional[jax.Array] = None,
):
    """Distributed double-constrained matching — the sharded twin of
    matching.match.match_double_constrained, returning identical DMatches
    (exact integer distances make the results bit-equal)."""
    from ssrlcv_tpu.core import camera_math
    from ssrlcv_tpu.matching.match import _threshold

    qi, ti = query_index, target_index
    Pm = camera_math.projection_matrix(
        cameras.cam_pos[ti], cameras.cam_rot[ti], cameras.foc[ti],
        cameras.dpix[ti], cameras.size[ti], cameras.ecef_offset[ti],
    )
    p1, p2 = camera_math.epipolar_segment_endpoints(
        query.loc,
        cameras.cam_pos[qi], cameras.cam_rot[qi], cameras.foc[qi],
        cameras.dpix[qi], cameras.size[qi], cameras.ecef_offset[qi],
        Pm, params.delta,
    )

    dsz, fsz = mesh.shape[DATA_AXIS], mesh.shape[FEAT_AXIS]
    nq = query.capacity
    idx, dist = sharded_best_target(
        mesh,
        _pad_to(query.descriptors, dsz),
        _pad_to(target.descriptors, fsz),
        _pad_to(target.mask, fsz),
        p1=_pad_to(p1, dsz),
        p2=_pad_to(p2, dsz),
        t_loc=_pad_to(target.loc, fsz),
        epsilon=float(params.epsilon),
    )
    idx, dist = _local_pair(idx, dist)
    return _threshold(idx[:nq], dist[:nq], query.mask, params, seed_dist)


def sharded_match_brute_force(
    mesh: Mesh,
    query: FeatureSet,
    target: FeatureSet,
    params: MatchParams,
    seed_dist: Optional[jax.Array] = None,
):
    """Distributed unconstrained matching (sharded twin of
    match_brute_force)."""
    from ssrlcv_tpu.matching.match import _threshold

    dsz, fsz = mesh.shape[DATA_AXIS], mesh.shape[FEAT_AXIS]
    nq = query.capacity
    idx, dist = sharded_best_target(
        mesh,
        _pad_to(query.descriptors, dsz),
        _pad_to(target.descriptors, fsz),
        _pad_to(target.mask, fsz),
    )
    idx, dist = _local_pair(idx, dist)
    return _threshold(idx[:nq], dist[:nq], query.mask, params, seed_dist)


def _local_pair(idx, dist):
    """Under multi-process jax.distributed the matcher outputs are global
    arrays sharded across hosts; the threshold epilogue is tiny host-side
    logic, so gather them (no-op single-process)."""
    from ssrlcv_tpu.parallel.mesh import host_value

    if isinstance(idx, jax.Array) and not idx.is_fully_addressable:
        return jnp.asarray(host_value(idx)), jnp.asarray(host_value(dist))
    return idx, dist


def sharded_generate_features(mesh: Mesh, pixels, image_ids, sift_params):
    """Image-parallel SIFT over every device of the mesh.

    Feature generation dominates pipeline wall clock and each image is
    independent, so the distributed design is pure data parallelism over the
    FLATTENED (data, feat) mesh — the counterpart of the reference's only
    scaling story, independent per-image Slurm jobs
    (scripts/sub-run-sfm-2.sh in the reference).  Zero collectives are
    needed: each image is committed to its device with ``jax.device_put``
    and runs the SAME fused per-image program as ``generate_features`` on a
    GPU.  Dispatch is async, so all devices make progress concurrently;
    results are stitched into global mesh-sharded arrays so downstream
    sharded stages consume them in place.

    pixels: (N, H, W) uint8 grayscale stack; image_ids: (N,) int32.
    Returns (features: list[FeatureSet] length N, sat (N, buckets) bool,
    overflow (N,) bool) — per-image results identical to generate_features
    on the same platform (same program, same device kind).
    """
    from ssrlcv_tpu.features.sift import _sift_fused_agg

    devices = list(mesh.devices.reshape(-1))
    nd = len(devices)
    n = int(pixels.shape[0])
    h, w = int(pixels.shape[1]), int(pixels.shape[2])
    ids = [int(i) for i in np.asarray(image_ids)]
    n_pad = ((n + nd - 1) // nd) * nd
    local_n = n_pad // nd

    # blocked assignment (device d owns images [d*local_n, (d+1)*local_n))
    # to match the global P((data, feat)) layout below; padding slots re-run
    # image 0 with id -1 (device time on otherwise idle devices).
    #
    # Multi-process (jax.distributed): each process computes ONLY the slots
    # whose device it can address (device_put onto a non-addressable device
    # is impossible — VERDICT r4 row 30), then per-image results are
    # host-gathered across processes so every process returns the identical
    # feature list.
    pid = jax.process_index()
    multiproc = any(d.process_index != pid for d in devices)
    slot_ids = [ids[i] if i < n else -1 for i in range(n_pad)]
    owned = [i for i in range(n_pad) if devices[i // local_n].process_index == pid]
    placed = {
        i: jax.device_put(pixels[i if i < n else 0], devices[i // local_n])
        for i in owned
    }
    outs = {
        i: _sift_fused_agg(placed[i], jnp.int32(slot_ids[i]), sift_params, h, w)
        for i in owned
    }

    if multiproc:
        # host-gather: every process stacks its owned slots and allgathers;
        # each image's FeatureSet comes back replicated on every process as
        # host-backed arrays.  process_allgather requires IDENTICAL shapes
        # on every process — blocked construction guarantees that only when
        # the mesh devices split evenly across processes, so fail loudly
        # (not corrupt the gather) otherwise.
        from jax.experimental import multihost_utils

        per_proc_counts = {}
        for d in devices:
            per_proc_counts[d.process_index] = per_proc_counts.get(d.process_index, 0) + 1
        if len(set(per_proc_counts.values())) != 1:
            raise ValueError(
                "sharded_generate_features: mesh devices split unevenly "
                f"across processes ({per_proc_counts}) — the per-image "
                "allgather needs an equal device count per process")

        local_stack = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]),
            *[outs[i] for i in owned])
        gathered = multihost_utils.process_allgather(local_stack)  # (P, S, ...)
        # slot -> (process, position-within-process) in owned order
        slot_of = {}
        for p in range(jax.process_count()):
            p_owned = [i for i in range(n_pad)
                       if devices[i // local_n].process_index == p]
            for pos, i in enumerate(p_owned):
                slot_of[i] = (p, pos)

        def pick(i):
            p, pos = slot_of[i]
            return jax.tree_util.tree_map(lambda x: jnp.asarray(x[p][pos]), gathered)

        per_slot = [pick(i) for i in range(n)]
        feats = [s[0] for s in per_slot]
        sat = jnp.stack([s[1] for s in per_slot])
        ovf = jnp.stack([s[2] for s in per_slot])
        return feats, sat, ovf

    # single-process: stitch per-device stacks into ONE global mesh-sharded
    # pytree — the leading (image) axis is sharded over the flattened mesh,
    # exactly the layout the old shard_map version produced
    sharding = NamedSharding(mesh, P((DATA_AXIS, FEAT_AXIS)))

    def stack_local(d, leaves):
        xs = leaves[d * local_n : (d + 1) * local_n]
        return jnp.stack(xs)  # runs on (and stays committed to) device d

    def to_global(leaves):
        shards = [stack_local(d, leaves) for d in range(nd)]
        shape = (n_pad,) + shards[0].shape[1:]
        return jax.make_array_from_single_device_arrays(shape, sharding, shards)

    outs_l = [outs[i] for i in range(n_pad)]
    fs = jax.tree_util.tree_map(lambda *xs: to_global(list(xs)), *[o[0] for o in outs_l])
    sat = to_global([o[1] for o in outs_l])
    ovf = to_global([o[2] for o in outs_l])
    feats = [jax.tree_util.tree_map(lambda x: x[i], fs) for i in range(n)]
    return feats, sat[:n], ovf[:n]


def sharded_pairwise_index_matches(
    mesh: Mesh,
    features: list,
    cameras: Cameras,
    params: MatchParams,
    seed_features=None,
    pairs: Optional[list] = None,
):
    """Distributed N-view pair sweep (VERDICT r3 #4): the O(N^2) image-pair
    list of generateMatchesExhaustive (MatchFactory.cu:907-1028) is dealt
    round-robin over the flattened mesh and each device runs the existing
    matcher kernel on its pair subset — pure data parallelism over pairs
    (the natural SfM analogue of DP, SURVEY.md §2.4), per-device placement
    like sharded_generate_features.  Feature sets and seed distances are
    replicated to a device at most once and reused across its pairs.

    ``pairs``: explicit (i, j) list (already overlap-filtered by the
    caller); defaults to all i < j.  Returns {(i, j): (n, 2) int64 host
    array of (query_feature, target_feature)} — identical per-pair results
    to the serial pairwise_index_matches (same program per pair).
    """
    from ssrlcv_tpu.matching import match as M

    devices = list(mesh.devices.reshape(-1))
    nd = len(devices)
    n = len(features)
    if pairs is None:
        pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]

    # multi-process: pair k belongs to global device k % nd; each process
    # runs only the pairs on its addressable devices (the reference's
    # independent-job scaling story, per-pair instead of per-run), then pair
    # results are host-allgathered so every process builds identical tracks
    pid = jax.process_index()
    multiproc = any(d.process_index != pid for d in devices)
    owned_pairs = [(k, ij) for k, ij in enumerate(pairs)
                   if devices[k % nd].process_index == pid]

    feat_on = {}
    seed_on = {}
    sd_on = {}
    cams_on = {}

    def get_feat(img, d):
        key = (img, d)
        if key not in feat_on:
            feat_on[key] = jax.device_put(features[img], devices[d])
        return feat_on[key]

    def get_sd(img, d):
        if seed_features is None:
            return None
        key = (img, d)
        if key not in sd_on:
            if d not in seed_on:
                seed_on[d] = jax.device_put(seed_features, devices[d])
            sd_on[key] = M.seed_distances(get_feat(img, d), seed_on[d])
        return sd_on[key]

    def get_cams(d):
        if d not in cams_on:
            cams_on[d] = jax.device_put(cameras, devices[d])
        return cams_on[d]

    # async dispatch round-robin with a bounded in-flight window (a multiple
    # of the device count so every device keeps a queue): caps live DMatch
    # HBM buffers at large pair counts while devices still overlap (ADVICE r4)
    from ssrlcv_tpu.matching.tracks import DISPATCH_WINDOW, windowed_pair_sweep

    def dispatch(w, ij):
        i, j = ij
        d = owned_pairs[w][0] % nd
        if params.mode == "double":
            return M.match_double_constrained(
                get_feat(i, d), get_feat(j, d), get_cams(d), i, j, params,
                seed_dist=get_sd(i, d), index_only=True,
            )
        return M.match_brute_force(
            get_feat(i, d), get_feat(j, d), params,
            seed_dist=get_sd(i, d), index_only=True,
        )

    out = windowed_pair_sweep(
        [ij for _, ij in owned_pairs], dispatch, max(DISPATCH_WINDOW, 4 * nd))
    if multiproc:
        out = _allgather_pair_matches(out, pairs, devices, nd)
    return out


def _allgather_pair_matches(local_out, pairs, devices, nd):
    """Exchange per-pair index matches across processes: each process packs
    its pairs' (n, 2) arrays into one padded int64 buffer (equal shape on
    every process), allgathers, and rebuilds the full {pair: matches} dict —
    every process then holds identical inputs for host-side track building
    (matching the reference semantics, MatchFactory.cu:942-1004)."""
    import jax
    from jax.experimental import multihost_utils

    n_proc = jax.process_count()
    per_proc = [[] for _ in range(n_proc)]
    for k, ij in enumerate(pairs):
        per_proc[devices[k % nd].process_index].append(ij)
    max_pairs = max(len(p) for p in per_proc)
    counts = [len(local_out.get(ij, ())) for ij in per_proc[jax.process_index()]]
    max_n = max(counts, default=0)
    # equal-shape padded buffers: (max_pairs, max_n_global?, 2) — max_n
    # differs per process, so gather the counts first (tiny) to size buffers
    cnt_buf = np.full((max_pairs,), -1, np.int64)
    cnt_buf[: len(counts)] = counts
    all_counts = np.asarray(multihost_utils.process_allgather(cnt_buf))
    cap = max(int(all_counts.max()), 1)
    buf = np.zeros((max_pairs, cap, 2), np.int64)
    for r, ij in enumerate(per_proc[jax.process_index()]):
        m = local_out[ij]
        buf[r, : len(m)] = m
    all_buf = np.asarray(multihost_utils.process_allgather(buf))
    out = {}
    for p in range(n_proc):
        for r, ij in enumerate(per_proc[p]):
            out[ij] = all_buf[p, r, : all_counts[p, r]]
    return out


@functools.lru_cache(maxsize=None)
def _triangulate_jit(mesh: Mesh):
    """Mesh-keyed jitted triangulation step, built once per mesh so repeated
    `sharded_triangulate` calls reuse the same traced function (VERDICT r4
    #8: jitting a fresh closure per call re-traced every invocation)."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def step(ms: MatchSet, cams: Cameras):
        ms = jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(x, sharding), ms
        )
        bd = generate_bundles(ms, cams)
        return two_view_triangulate(bd)

    return jax.jit(step)


def sharded_triangulate(mesh: Mesh, matches: MatchSet, cameras: Cameras):
    """Track-sharded 2-view triangulation: sharding constraints let jit
    partition the whole bundle+triangulate computation over data."""
    cap = matches.capacity
    matches = pad_matchset(matches, mesh.shape[DATA_AXIS])
    pc, err = _triangulate_jit(mesh)(matches, cameras)
    if isinstance(pc.points, jax.Array) and not pc.points.is_fully_addressable:
        # multi-process: the cloud is consumed host-side (PLY, filters) —
        # gather it so every process returns the identical full cloud
        from ssrlcv_tpu.parallel.mesh import host_tree, host_value

        pc = jax.tree_util.tree_map(jnp.asarray, host_tree(pc))
        err = jnp.asarray(host_value(err))
    if pc.points.shape[0] != cap:  # drop the padding tracks again
        pc = jax.tree_util.tree_map(lambda x: x[:cap], pc)
    return pc, err


def sharded_ba_step(
    mesh: Mesh,
    matches: MatchSet,
    cameras: Cameras,
    params_flat,
    lam,
    fix_camera0: bool = True,
):
    """One sharded LM iteration on the 2-view BA objective.

    Tracks are sharded over ``data``; each shard computes its gradient and
    Hessian contribution of the total linear error; psum reduces them; the
    (6N)x(6N) damped solve happens replicated on every device.  This is the
    distributed-BA building block (SURVEY.md §7 step 7); the iteration loop
    lives in ``sharded_bundle_adjust``.
    """
    n_cams = cameras.num_cameras
    matches = pad_matchset(matches, mesh.shape[DATA_AXIS])

    def local_obj(p_flat, kp_loc, kp_parent, num_views, mask):
        ms = MatchSet(kp_loc=kp_loc, kp_parent=kp_parent, num_views=num_views, mask=mask)
        cams = cameras.replace(
            cam_pos=p_flat.reshape(n_cams, 6)[:, 0:3],
            cam_rot=p_flat.reshape(n_cams, 6)[:, 3:6],
        )
        bd = generate_bundles(ms, cams)
        return linear_error_objective(bd)

    free = jnp.ones((n_cams, 6), params_flat.dtype)
    if fix_camera0:
        free = free.at[0].set(0.0)
    free = free.reshape(-1)

    def kernel(p_flat, kp_loc, kp_parent, num_views, mask, lam_):
        e_local, g_local = jax.value_and_grad(local_obj)(
            p_flat, kp_loc, kp_parent, num_views, mask
        )
        H_local = jax.hessian(local_obj)(p_flat, kp_loc, kp_parent, num_views, mask)
        g = jax.lax.psum(g_local, DATA_AXIS) * free
        H = jax.lax.psum(H_local, DATA_AXIS)
        err = jax.lax.psum(e_local, DATA_AXIS)
        step = lm_solve(H, g, lam_, free)
        return p_flat - step * free, err

    return shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P()),
    )(params_flat, matches.kp_loc, matches.kp_parent, matches.num_views, matches.mask,
      jnp.asarray(lam, params_flat.dtype))


def sharded_bundle_adjust(
    mesh: Mesh,
    matches: MatchSet,
    cameras: Cameras,
    iterations: int = 10,
    fix_camera0: bool = True,
    initial_lambda: float = 1e-3,
):
    """Distributed multi-iteration 2-view LM bundle adjustment.

    The full lambda-adaptive loop of ba/two_view.bundle_adjust_two_view
    (mode="lm") with the gradient/Hessian/error psum-reduced over the data
    axis each iteration; all control-flow decisions are made on the psum'd
    scalars, so every device runs the identical replicated loop.

    Returns (cameras, cloud, initial_error, final_error, history) — the same
    surface as ba.two_view.BAResult.
    """
    from ssrlcv_tpu.ba.two_view import BAResult, _apply_params, _pack

    n_cams = cameras.num_cameras
    matches_p = pad_matchset(matches, mesh.shape[DATA_AXIS])
    params0 = _pack(cameras).reshape(-1)

    free = jnp.ones((n_cams, 6), params0.dtype)
    if fix_camera0:
        free = free.at[0].set(0.0)
    free = free.reshape(-1)

    best_flat, init_err, best_err, hist = _ba_jit(mesh, iterations)(
        params0, cameras, free, jnp.asarray(initial_lambda, params0.dtype),
        matches_p.kp_loc, matches_p.kp_parent, matches_p.num_views, matches_p.mask)

    if isinstance(best_flat, jax.Array) and not best_flat.is_fully_addressable:
        # multi-process: P() outputs are replicated — read the local shard
        from ssrlcv_tpu.parallel.mesh import host_value

        best_flat = jnp.asarray(host_value(best_flat))
        init_err = jnp.asarray(host_value(init_err))
        best_err = jnp.asarray(host_value(best_err))
        hist = jnp.asarray(host_value(hist))

    out_cams = _apply_params(cameras, best_flat.reshape(n_cams, 6))
    cloud, _ = sharded_triangulate(mesh, matches, out_cams)
    return BAResult(out_cams, cloud, init_err, best_err, hist)


@functools.lru_cache(maxsize=None)
def _ba_jit(mesh: Mesh, iterations: int):
    """(mesh, iterations)-keyed jitted BA loop: cameras / free-parameter mask
    / initial lambda are traced ARGUMENTS (replicated specs) rather than
    closure captures, so repeated calls hit the jit cache instead of
    re-tracing (VERDICT r4 #8)."""

    def kernel(p0, cameras, free, lam0, kp_loc, kp_parent, num_views, mask):
        n_cams = cameras.cam_pos.shape[0]

        def local_obj(p_flat):
            ms = MatchSet(kp_loc=kp_loc, kp_parent=kp_parent,
                          num_views=num_views, mask=mask)
            cams = cameras.replace(
                cam_pos=p_flat.reshape(n_cams, 6)[:, 0:3],
                cam_rot=p_flat.reshape(n_cams, 6)[:, 3:6],
            )
            return linear_error_objective(generate_bundles(ms, cams))

        def obj(p_flat):
            return jax.lax.psum(local_obj(p_flat), DATA_AXIS)

        init_err = obj(p0)

        def body(i, state):
            params, best_params, best_err, lam, done, hist = state
            e_local, g_local = jax.value_and_grad(local_obj)(params)
            H = jax.lax.psum(jax.hessian(local_obj)(params), DATA_AXIS)
            g = jax.lax.psum(g_local, DATA_AXIS) * free
            step = lm_solve(H, g, lam, free)
            new_params = params - step * free
            new_err = obj(new_params)
            improved = new_err < best_err

            lam2 = jnp.where(improved, lam * 0.3, lam * 10.0)
            params2 = jnp.where(improved, new_params, best_params)
            done2 = done | (~improved & (i > 0))
            best_params2 = jnp.where(improved, new_params, best_params)
            best_err2 = jnp.where(improved, new_err, best_err)
            hist2 = hist.at[i + 1].set(jnp.where(improved, new_err, best_err))

            new_state = (params2, best_params2, best_err2, lam2, done2, hist2)
            return jax.tree_util.tree_map(
                lambda new, old: jnp.where(done, old, new), new_state, state
            )

        hist0 = jnp.full((iterations + 1,), init_err)
        state0 = (
            p0, p0, init_err, lam0,
            jnp.asarray(False), hist0,
        )
        final = jax.lax.fori_loop(0, iterations, body, state0)
        return final[1], init_err, final[2], final[5]

    return jax.jit(
        shard_map(
            kernel,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(DATA_AXIS), P(DATA_AXIS),
                      P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(), P(), P(), P()),
        )
    )
