"""The parity checks of chip_smoke.py, run here with the CPU on both sides
(on the card they compare the card with the CPU backend)."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from ssrlcv_tpu.config import MatchParams, SIFTParams
    from ssrlcv_tpu.features.sift import generate_features
    from ssrlcv_tpu.io.images import cameras_from_refimages, load_directory
    from ssrlcv_tpu.io.scene import make_scene, write_scene

    scene = make_scene(1, 128)
    views, _ = write_scene(scene, str(tmp_path_factory.mktemp("scene")))
    ims = load_directory(views)
    sp = SIFTParams(max_keypoints=2048)
    feats = [generate_features(im.pixels, sp, image_id=i) for i, im in enumerate(ims)]
    seed = generate_features(scene.seed_image, sp, image_id=-1)
    return scene, feats, seed, cameras_from_refimages(ims), MatchParams(epsilon=25.0, delta=5.0)


def test_check_matching_accepts_identical_backends(pair):
    import jax

    import chip_smoke

    _, (f0, f1), seed, cams, mp = pair
    out = chip_smoke.check_matching(f0, f1, cams, mp, seed, jax.devices("cpu")[0])
    assert out["constrained_differing_queries"] == 0
    assert out["queries"] == int(np.asarray(f0.mask).sum()) > 100


def test_check_sift_bars(pair):
    import chip_smoke

    _, (f0, _), _, _, _ = pair
    out = chip_smoke.check_sift(f0, f0)
    assert out["keypoint_agreement"] == out["descriptor_agreement"] == 1.0
    # a descriptor moved past the distProtocol bar on every keypoint fails
    bumped = f0.replace(descriptors=(f0.descriptors.astype(np.int32) + 5).clip(0, 255)
                        .astype(np.uint8))
    with pytest.raises(AssertionError, match="SIFT parity"):
        chip_smoke.check_sift(bumped, f0)


@pytest.mark.parametrize("target,expected", [
    ((50.0, 25.0), 0.0),    # on the line test's +eps boundary
    ((50.0, 0.0), 25.0),    # on the segment: eps from the line boundary
    ((-25.0, 3.0), 0.0),    # on the x-range gate
    ((10.0, 40.0), 15.0),   # outside: 15 px beyond the line boundary
])
def test_predicate_boundary_distance(target, expected):
    import chip_smoke

    d = chip_smoke._boundary_distance(np.array([[0.0, 0.0]]), np.array([[100.0, 0.0]]),
                                      np.array([target]), 25.0)
    np.testing.assert_allclose(d, [expected])


def test_check_clouds_bounds(pair):
    import chip_smoke

    scene = pair[0]
    pts = scene.truth.reshape(-1, 3)[::7]
    clouds = {"initial": pts, "filtered": pts, "final": pts + 0.5}
    out = chip_smoke.check_clouds(scene, clouds, (1.0, 0.5), clouds, (1.0, 0.5))
    assert out["initial"]["median_height_error_km"] < 1e-6
    off = dict(clouds, filtered=pts + np.array([0.0, 0.0, 0.1]))
    with pytest.raises(AssertionError, match="filtered cloud"):
        chip_smoke.check_clouds(scene, off, (1.0, 0.5), clouds, (1.0, 0.5))
    with pytest.raises(AssertionError, match="BA error"):
        chip_smoke.check_clouds(scene, clouds, (1.0, 0.6), clouds, (1.0, 0.5))
    # the filter's cut moves both errors alike: the reduction still agrees
    out = chip_smoke.check_clouds(scene, clouds, (1.05, 0.525), clouds, (1.0, 0.5))
    assert out["ba_error"]["card"] == [1.05, 0.525]


def _dm(idx, dist):
    from ssrlcv_tpu.matching.match import DMatches

    dist = np.asarray(dist, np.float32)
    return DMatches(target_idx=np.asarray(idx, np.int32), distance=dist,
                    valid=np.isfinite(dist))


@pytest.mark.parametrize("case", ["boundary", "no_target_on_one_side", "far", "inexact"])
def test_explain_constrained_differences(case):
    """Card and CPU may disagree on a query only through a target at the
    float32 predicate's boundary, with exact (or infinite) distances."""
    import chip_smoke

    n = 2000
    q_desc = np.zeros((n, 128), np.uint8)
    t_desc = np.zeros((3, 128), np.uint8)
    t_desc[1, 0], t_desc[2, 0] = 3, 4                      # distances 9 and 16
    p1 = np.tile([[0.0, 0.0]], (n, 1))
    p2 = np.tile([[100.0, 0.0]], (n, 1))
    t_loc = np.array([[50.0, 0.0], [50.0, 25.0 + 1e-4], [50.0, 3.0]])
    base_idx, base_d = np.zeros(n, np.int32), np.zeros(n, np.float32)
    card_idx, card_d = base_idx.copy(), base_d.copy()
    cpu_idx, cpu_d = base_idx.copy(), base_d.copy()
    # query 7: the card admits target 1 (on the boundary), the CPU takes 2
    card_idx[7], card_d[7], cpu_idx[7], cpu_d[7] = 1, 9, 2, 16
    if case == "no_target_on_one_side":
        cpu_idx[7], cpu_d[7] = 0, np.inf
    elif case == "far":
        t_loc[1] = (50.0, 10.0)                             # 15 px inside
    elif case == "inexact":
        card_d[7] = 10
    args = (_dm(card_idx, card_d), _dm(cpu_idx, cpu_d), q_desc, t_desc, t_loc,
            p1, p2, 25.0)
    if case in ("far", "inexact"):
        with pytest.raises(AssertionError):
            chip_smoke.explain_constrained_differences(*args)
    else:
        n_diff, worst = chip_smoke.explain_constrained_differences(*args)
        assert n_diff == 1 and worst < 1e-3
