"""Proof that the 2-view pipeline runs on an NVIDIA GPU at full size.

    python3 chip_smoke.py          # one card: every phase below
    python3 chip_smoke.py --mesh   # four cards: `sfm --mesh 2x2` against one
                                   # card, and nothing else

One process does everything (a second JAX process could not get the card's
memory); a failed phase raises, so the run exits non-zero and prints no
result line.  Phases:

  1. device   - JAX's first device is a GPU; each card's name and power limit
                as nvidia-smi reports them.
  2. scene    - the seeded orbital pair at 1024^2 px plus a seed image of
                other terrain (ssrlcv_tpu.io.scene), written as a directory.
  3. pipeline - ``sfm.main`` (the CLI entry point) cold, compilation
                included, then warm; then the same state stage by stage, each
                stage ended by ``block_until_ready``.
  4. memory   - ``compiled.memory_analysis()`` of the SIFT and match
                programs, and the card's peak bytes in use.
  5. parity   - against the CPU backend of this same process: matching on the
                card's descriptors (integer distances bit-identical), SIFT of
                view 0 (keypoints and descriptors), and both runs' clouds
                against the scene's true surface.

The last line of standard output is the JSON result object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "out", "chip_smoke")
SIZE = 1024
SEED = 0
EPSILON = 25.0   # px (the reference's Pipeline2View job)
DELTA = 5.0      # km

# SIFT parity bars (the reference's own per-keypoint tolerance class,
# test/Pipeline.cu:33, applied to the population): across backends the
# scale-space arithmetic rounds differently, which flips a few
# threshold-borderline detections and orientations
SIFT_KEYPOINT_AGREEMENT = 0.995
SIFT_DESCRIPTOR_AGREEMENT = 0.995
SIFT_DESCRIPTOR_DIST2 = 20
# cloud bars.  The initial and filtered clouds are triangulated with the true
# cameras: their median height error is bounded by 2 ground samples (33 m),
# twice what the CPU run of the 256^2 and 512^2 scenes gives (16 m, about
# 0.17 px of disparity).  BA then moves camera 1 (its linear-error
# objective leaves the pair's scale and attitude free: on the 512^2 CPU run
# 2.0 km and 1.5 degrees, which puts the final cloud ~61 km off the surface),
# so the final cloud is held to the CPU run's own final cloud instead.
# Point counts follow the CPU run up to the keypoints that flip between
# backends.  The BA errors are sums over the filtered points, and the
# statistical filter's 3-sigma cut moves with those flips while the points
# at the cut carry the largest errors (on an H100: 55 of 16,632 filtered
# points and 3.3% of the error); the error BA removes, final over initial,
# does not depend on the cut (0.7% apart on the same run).
CLOUD_MEDIAN_ERROR_KM = 0.033
FINAL_CLOUD_RTOL = 0.1
CLOUD_POINT_COUNT_RTOL = 0.01
BA_ERROR_RTOL = 0.1
BA_REDUCTION_RTOL = 0.02
# a query's double-constrained match may differ between backends only when
# a chosen target sits this close to the float32 predicate's boundary
PREDICATE_BOUNDARY_PX = 1e-2
# four cards against one: features, matches and the initial and filtered
# clouds are the same arithmetic on the same kind of card (identical to
# MESH_EXACT_KM).  BA psum-reduces its gradient and Hessian over the mesh in
# another order, and the LM steps amplify that rounding along the objective's
# free directions (ROADMAP R8): on four H100s the BA-final clouds differed by
# up to 12 m and the BA errors by 0.03%.
MESH_EXACT_KM = 1e-6
MESH_FINAL_CLOUD_TOL_KM = 0.05
MESH_BA_ERROR_RTOL = 1e-3
CLOUD_STAGES = {"triangulation": "initial", "filtering": "filtered",
                "bundle_adjust": "final"}


def result_line(devices) -> str:
    """The contract's last line, for GPU devices only."""
    d0 = devices[0]
    if d0.platform != "gpu":
        raise RuntimeError(f"no result for platform {d0.platform!r}")
    return json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devices)}})


class Report:
    """Prints each number with the card beside it."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, label: str, value) -> None:
        print(f"[{self.card}] {label}: {value}", flush=True)


def _sfm_argv(views: str, seed_path: str, out: str, mesh: str | None = None):
    argv = ["-d", views, "-s", seed_path, "--epsilon", str(EPSILON),
            "--delta", str(DELTA), "-o", out]
    return argv + (["--mesh", mesh] if mesh else [])


def _sync(state):
    import jax

    jax.block_until_ready((state.features, state.seed_features,
                           state.matches, state.cloud, state.cameras))


def cloud_points(cloud) -> np.ndarray:
    return np.asarray(cloud.points)[np.asarray(cloud.mask)]


def run_staged(argv):
    """The pipeline of ``sfm.main(argv)``, stage by stage: returns the final
    state, the seconds of each stage (each ended by block_until_ready) and
    the initial, filtered and final clouds."""
    from ssrlcv_tpu.pipeline import sfm
    from ssrlcv_tpu.pipeline.stages import STAGES

    args = sfm.parse_args(argv)
    times, clouds = {}, {}
    t0 = time.perf_counter()
    state = sfm.build_state(args)
    if state is None:
        raise RuntimeError(f"no pipeline state for {argv}")
    _sync(state)
    times["load+seed_sift"] = time.perf_counter() - t0
    for name, fn in STAGES:
        t0 = time.perf_counter()
        state = fn(state)
        _sync(state)
        times[name] = time.perf_counter() - t0
        if name in CLOUD_STAGES:
            clouds[CLOUD_STAGES[name]] = cloud_points(state.cloud)
    return state, times, clouds


def _host(fs):
    return {k: np.asarray(getattr(fs, k))
            for k in ("loc", "sigma", "theta", "descriptors", "mask", "parent")}


def _boundary_distance(p1, p2, t, eps):
    """Distance (px, float64) of targets ``t`` from the nearest decision
    boundary of the double-constrained predicate of segments (p1, p2)
    (matching.match._epipolar_segment_mask): its x-range gate, and its
    vertical or line test."""
    p1, p2, t = (np.asarray(x, np.float64) for x in (p1, p2, t))
    swap = p1[:, 0] >= p2[:, 0]
    left = np.where(swap[:, None], p2, p1)
    right = np.where(swap[:, None], p1, p2)
    gate_x = np.minimum(np.abs(t[:, 0] - (left[:, 0] - eps)),
                        np.abs(t[:, 0] - (right[:, 0] + eps)))
    top, bottom = np.minimum(p1[:, 1], p2[:, 1]), np.maximum(p1[:, 1], p2[:, 1])
    vert = np.minimum(np.abs(t[:, 1] - (top - eps)), np.abs(t[:, 1] - (bottom + eps)))
    dx = left[:, 0] - right[:, 0]
    slope = (left[:, 1] - right[:, 1]) / np.where(dx == 0, 1.0, dx)
    line = np.abs(np.abs(slope * (t[:, 0] - left[:, 0]) + left[:, 1] - t[:, 1]) - eps)
    return np.minimum(gate_x, np.where(dx == 0, vert, line))


def explain_constrained_differences(dm_card, dm_cpu, q_desc, t_desc, t_loc,
                                    p1, p2, eps):
    """Queries whose double-constrained results differ between the backends
    must be few, must carry exact distances (or none: +inf when no target
    passed), and must have a chosen target within PREDICATE_BOUNDARY_PX of
    the predicate's boundary.  Returns (number of such queries, the largest
    of their boundary distances)."""
    diff = np.flatnonzero((dm_card.target_idx != dm_cpu.target_idx)
                          | (dm_card.distance != dm_cpu.distance)
                          | (dm_card.valid != dm_cpu.valid))
    if len(diff) == 0:
        return 0, 0.0
    if len(diff) > 1e-3 * len(dm_card.valid):
        raise AssertionError(f"constrained matching differs in {len(diff)} queries")
    near = np.full(len(diff), np.inf)
    for dm in (dm_card, dm_cpu):
        ti, d = dm.target_idx[diff], dm.distance[diff]
        fin = np.isfinite(d)
        exact = np.sum((q_desc[diff].astype(np.int64)
                        - t_desc[ti].astype(np.int64)) ** 2, axis=1)
        if not np.array_equal(d[fin], exact[fin].astype(np.float32)):
            raise AssertionError("constrained matching returned an inexact distance")
        near[fin] = np.minimum(near[fin], _boundary_distance(
            p1[diff][fin], p2[diff][fin], t_loc[ti[fin]], eps))
    worst = float(near.max())
    if worst > PREDICATE_BOUNDARY_PX:
        raise AssertionError(
            f"constrained matching differs away from the predicate boundary "
            f"({worst} px) in queries {diff[near > PREDICATE_BOUNDARY_PX][:10]}")
    return int(len(diff)), worst


def check_matching(query, target, cameras, params, seed, cpu):
    """Seed distances, brute-force and double-constrained matching of the
    same descriptors on the card and on ``cpu``.

    The distances are exact integers, so seed distances and brute-force
    matches must be bit-identical.  The double-constrained predicate is
    float32 arithmetic (segment endpoints from sin/cos/sqrt, then a line
    test), which the two backends round differently: a query may differ
    only when one of its two chosen targets lies within
    ``PREDICATE_BOUNDARY_PX`` of the predicate's boundary, and both chosen
    distances must be the exact distances of their targets (or +inf, when
    no target passed on that backend)."""
    import jax

    from ssrlcv_tpu.core import camera_math
    from ssrlcv_tpu.matching import match as M

    def run(q, t, c, s):
        sd = M.seed_distances(q, s)
        bf = M.match_brute_force(q, t, params, seed_dist=sd)
        dm = M.match_double_constrained(q, t, c, 0, 1, params, seed_dist=sd)
        return jax.tree_util.tree_map(np.asarray, (sd, bf, dm))

    (sd_g, bf_g, dm_g) = run(query, target, cameras, seed)
    on_cpu = jax.device_put((query, target, cameras, seed), cpu)
    (sd_c, bf_c, dm_c) = run(*on_cpu)
    for name, a, b in (("seed distance", sd_g, sd_c),
                       ("brute-force target index", bf_g.target_idx, bf_c.target_idx),
                       ("brute-force distance", bf_g.distance, bf_c.distance),
                       ("brute-force valid", bf_g.valid, bf_c.valid)):
        if not np.array_equal(a, b):
            n = int(np.sum(a != b))
            raise AssertionError(f"matching parity: {name} differs in {n} of {a.size}")

    q_desc, t_loc, t_desc = (np.asarray(x) for x in (
        on_cpu[0].descriptors, on_cpu[1].loc, on_cpu[1].descriptors))
    c = on_cpu[2]
    P = camera_math.projection_matrix(c.cam_pos[1], c.cam_rot[1], c.foc[1],
                                      c.dpix[1], c.size[1], c.ecef_offset[1])
    p1, p2 = camera_math.epipolar_segment_endpoints(
        on_cpu[0].loc, c.cam_pos[0], c.cam_rot[0], c.foc[0],
        c.dpix[0], c.size[0], c.ecef_offset[0], P, params.delta)
    n_diff, worst = explain_constrained_differences(
        dm_g, dm_c, q_desc, t_desc, t_loc, np.asarray(p1), np.asarray(p2),
        params.epsilon)
    return {"queries": int(np.sum(np.asarray(query.mask))),
            "seed_distances_and_brute_force": "bit-identical",
            "constrained_matches": int(dm_g.valid.sum()),
            "constrained_differing_queries": n_diff,
            "their_largest_distance_to_the_predicate_boundary_px": worst}


def check_sift(fs_card, fs_cpu):
    """The same SIFT program on the card and on the CPU: the share of CPU
    keypoints found on the card at the same location and orientation, and
    the share of those whose descriptors differ by less than the
    reference's distProtocol bar."""
    from scipy.spatial import cKDTree

    g, c = _host(fs_card), _host(fs_cpu)
    gm, cm = g["mask"], c["mask"]

    def embed(h, m):
        return np.column_stack([h["loc"][m], np.cos(h["theta"][m]), np.sin(h["theta"][m])])

    dist, nn = cKDTree(embed(g, gm)).query(embed(c, cm), k=1)
    found = dist < 1e-2
    keypoints = float(found.mean())
    d = (g["descriptors"][gm][nn[found]].astype(np.int64)
         - c["descriptors"][cm][found].astype(np.int64))
    descriptors = float((np.sum(d * d, axis=1) < SIFT_DESCRIPTOR_DIST2).mean())
    out = {"card": int(gm.sum()), "cpu": int(cm.sum()),
           "keypoint_agreement": keypoints, "descriptor_agreement": descriptors}
    if keypoints < SIFT_KEYPOINT_AGREEMENT or descriptors < SIFT_DESCRIPTOR_AGREEMENT:
        raise AssertionError(f"SIFT parity below its bars: {out}")
    return out


def check_clouds(scene, card_clouds, card_ba, cpu_clouds, cpu_ba):
    """Both runs' clouds against the true surface, and against each other;
    ``*_clouds`` map initial/filtered/final to points, ``*_ba`` are the BA
    (initial, final) errors."""
    def median_error(pts):
        return float(np.median(np.abs(scene.height_error_km(pts))))

    out, bad = {}, []
    for name, pts in card_clouds.items():
        ref = cpu_clouds[name]
        e, e_ref = median_error(pts), median_error(ref)
        out[name] = {"points": len(pts), "cpu_points": len(ref),
                     "median_height_error_km": e, "cpu_median_height_error_km": e_ref}
        if abs(len(pts) - len(ref)) > CLOUD_POINT_COUNT_RTOL * len(ref):
            bad.append(f"{name} point count")
        if name == "final":
            if abs(e - e_ref) > FINAL_CLOUD_RTOL * e_ref:
                bad.append("final cloud vs the CPU run's")
        elif max(e, e_ref) > CLOUD_MEDIAN_ERROR_KM:
            bad.append(f"{name} cloud vs the true surface")
    out["ba_error"] = {"card": list(card_ba), "cpu": list(cpu_ba)}
    if any(abs(a - b) > BA_ERROR_RTOL * abs(b) for a, b in zip(card_ba, cpu_ba)):
        bad.append("BA error")
    r_card, r_cpu = card_ba[1] / card_ba[0], cpu_ba[1] / cpu_ba[0]
    if abs(r_card - r_cpu) > BA_REDUCTION_RTOL * r_cpu:
        bad.append("BA error reduction")
    if bad:
        raise AssertionError(f"outside the bounds ({', '.join(bad)}): {out}")
    return out


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in dir(ma) if k.endswith("_in_bytes")}


def _scene(report):
    from ssrlcv_tpu.io.scene import make_scene, write_scene

    t0 = time.perf_counter()
    scene = make_scene(SEED, SIZE)
    views, seed_path = write_scene(scene, os.path.join(WORK, "scene"))
    report(f"scene (seed {SEED}, {SIZE}^2 px, host)", f"{time.perf_counter() - t0:.1f} s")
    return scene, views, seed_path


def single_card(devices, report):
    import jax

    from ssrlcv_tpu.pipeline import sfm

    scene, views, seed_path = _scene(report)
    argv = _sfm_argv(views, seed_path, os.path.join(WORK, "card"))

    for label in ("cold end-to-end, compilation included", "warm end-to-end"):
        t0 = time.perf_counter()
        if sfm.main(argv) != 0:
            raise RuntimeError(f"sfm.main failed ({label})")
        report(f"sfm.main {label}", f"{time.perf_counter() - t0:.3f} s")
    state, times, clouds = run_staged(argv)
    for name, t in times.items():
        report(f"stage {name}", f"{t:.4f} s")
    report("stages total", f"{sum(times.values()):.4f} s")
    report("features per image", [int(np.asarray(f.mask).sum()) for f in state.features])

    # memory of the two programs that hold the largest intermediates
    from ssrlcv_tpu.features.sift import _sift_fused_agg
    from ssrlcv_tpu.matching import match as M

    sp, mp = state.config.sift, state.config.match
    px = jax.numpy.asarray(state.images[0].pixels)
    report("memory_analysis SIFT program (_sift_fused_agg)", _memory(
        _sift_fused_agg.lower(px, jax.numpy.int32(0), sp, SIZE, SIZE).compile()))
    f0, f1 = state.features
    report("memory_analysis match program (match_double_constrained)", _memory(
        M.match_double_constrained.lower(
            f0, f1, state.cameras, 0, 1, mp, seed_dist=state.seed_distances).compile()))
    report("peak_bytes_in_use", devices[0].memory_stats()["peak_bytes_in_use"])

    # parity against the CPU backend of this process, with the cameras the
    # matching stage used (BA has since moved camera 1)
    from ssrlcv_tpu.io.images import cameras_from_refimages

    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    report("matching parity (card descriptors, card vs CPU)", check_matching(
        f0, f1, cameras_from_refimages(state.images), mp, state.seed_features, cpu))
    report("matching parity took (host, not a card number)",
           f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        cpu_state, _, cpu_clouds = run_staged(
            _sfm_argv(views, seed_path, os.path.join(WORK, "cpu")))
    report("CPU reference pipeline (host, not a card number)",
           f"{time.perf_counter() - t0:.1f} s")
    report("SIFT parity view 0 (card vs CPU, same program)",
           check_sift(state.features[0], cpu_state.features[0]))
    report("clouds vs true surface and the CPU run", check_clouds(
        scene, clouds, state.ba_error, cpu_clouds, cpu_state.ba_error))


def four_cards(devices, report):
    if len(devices) < 4:
        raise RuntimeError(f"--mesh needs 4 GPUs, found {len(devices)}")
    _, views, seed_path = _scene(report)
    one, t_one, c_one = run_staged(_sfm_argv(views, seed_path, os.path.join(WORK, "one")))
    mesh, t_mesh, c_mesh = run_staged(
        _sfm_argv(views, seed_path, os.path.join(WORK, "mesh"), mesh="2x2"))
    for name in t_one:
        report(f"stage {name} one card / mesh 2x2",
               f"{t_one[name]:.4f} s / {t_mesh[name]:.4f} s")
    for i, (a, b) in enumerate(zip(one.features, mesh.features)):
        ha, hb = _host(a), _host(b)
        for k in ha:
            if not np.array_equal(ha[k], hb[k]):
                raise AssertionError(f"image {i} features.{k} differ on the mesh")
    for k in ("kp_loc", "kp_parent", "num_views", "mask"):
        if not np.array_equal(np.asarray(getattr(one.matches, k)),
                              np.asarray(getattr(mesh.matches, k))):
            raise AssertionError(f"matches.{k} differ on the mesh")
    dev = {}
    for name, pa in c_one.items():
        pb = c_mesh[name]
        if pa.shape != pb.shape:
            raise AssertionError(f"{name} cloud sizes differ: {pa.shape} vs {pb.shape}")
        dev[name] = float(np.max(np.abs(pa - pb))) if len(pa) else 0.0
    report("mesh 2x2 vs one card", {
        "features": "identical", "matches": "identical",
        "points": {k: len(v) for k, v in c_one.items()},
        "max_point_difference_km": dev,
        "ba_error": {"one": list(one.ba_error), "mesh": list(mesh.ba_error)}})
    ba_one, ba_mesh = one.ba_error[1], mesh.ba_error[1]
    if (max(dev["initial"], dev["filtered"]) > MESH_EXACT_KM
            or dev["final"] > MESH_FINAL_CLOUD_TOL_KM
            or abs(ba_mesh - ba_one) > MESH_BA_ERROR_RTOL * abs(ba_one)):
        raise AssertionError(f"mesh run outside its tolerances: clouds {dev} km, "
                             f"BA error {ba_mesh} vs {ba_one}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh", action="store_true",
                   help="four cards: --mesh 2x2 against one card, nothing else")
    args = p.parse_args(argv)

    from ssrlcv_tpu.backend import card_lines, enable_compile_cache, require_gpu

    devices = require_gpu()
    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    report = Report(cards[0])
    report("compile cache", enable_compile_cache())
    report("devices", f"{len(devices)} x {devices[0].device_kind}")
    (four_cards if args.mesh else single_card)(devices, report)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
