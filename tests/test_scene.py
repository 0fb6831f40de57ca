"""Seeded orbital scene (io/scene.py), the netpbm codec, and the scene
through the 2-view pipeline against its true surface."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def scene64():
    from ssrlcv_tpu.io.scene import make_scene

    return make_scene(3, 64)


@pytest.mark.parametrize("other_seed,same", [(3, True), (4, False)])
def test_scene_is_a_function_of_its_seed(scene64, other_seed, same):
    from ssrlcv_tpu.io.scene import make_scene

    other = make_scene(other_seed, 64)
    for a, b in zip(scene64.images + [scene64.seed_image],
                    other.images + [other.seed_image]):
        assert np.array_equal(a, b) == same
    # the cameras follow the geometry, not the seed
    np.testing.assert_array_equal(scene64.cam_pos, other.cam_pos)
    np.testing.assert_array_equal(scene64.cam_rot, other.cam_rot)


def test_scene_views_are_textured_and_distinct(scene64):
    v0, v1 = scene64.images
    assert v0.shape == v1.shape == (64, 64) and v0.dtype == np.uint8
    assert v0.std() > 20 and v1.std() > 20
    assert not np.array_equal(v0, v1)
    # relief stays inside the camera model's Earth band
    from ssrlcv_tpu.config import EARTH_MAX_KM_FROM_CENT, EARTH_MIN_KM_FROM_CENT

    r = np.linalg.norm(scene64.truth + scene64.ecef_offset, axis=-1)
    assert EARTH_MIN_KM_FROM_CENT < r.min() and r.max() < EARTH_MAX_KM_FROM_CENT


def test_true_points_project_to_their_pixels(scene64):
    """Each pixel's true ground point, projected through camera 0's
    projection matrix, lands on that pixel, and lies on the surface."""
    import jax.numpy as jnp

    from ssrlcv_tpu.core import camera_math

    s = scene64
    P = np.asarray(camera_math.projection_matrix(
        jnp.zeros(3), jnp.asarray(s.cam_rot[0]), jnp.float32(s.foc),
        jnp.asarray([s.dpix, s.dpix], jnp.float32), jnp.asarray([s.size, s.size]),
        jnp.asarray(s.ecef_offset)), np.float64)
    X = s.truth.reshape(-1, 3) + s.ecef_offset
    x = P @ np.concatenate([X, np.ones((len(X), 1))], axis=1).T
    uv = (x[:2] / x[2]).T.reshape(s.size, s.size, 2)
    ys, xs = np.mgrid[0:s.size, 0:s.size]
    # float32 projection matrix at 400 km range: ~1e-2 px
    assert np.abs(uv[..., 0] - xs).max() < 0.05
    assert np.abs(uv[..., 1] - ys).max() < 0.05
    assert np.abs(s.height_error_km(s.truth)).max() < 1e-6


def test_load_directory_reads_the_generated_cameras(scene64, tmp_path):
    from ssrlcv_tpu.io.images import load_directory
    from ssrlcv_tpu.io.scene import write_scene

    views, seed_path = write_scene(scene64, str(tmp_path))
    ims = load_directory(views)
    assert len(ims) == 2
    for i, im in enumerate(ims):
        np.testing.assert_array_equal(im.pixels, scene64.images[i])
        np.testing.assert_array_equal(im.ecef_offset, scene64.ecef_offset)
        np.testing.assert_allclose(im.cam_pos, scene64.cam_pos[i] - scene64.ecef_offset,
                                   atol=1e-3)
        np.testing.assert_array_equal(im.cam_rot, scene64.cam_rot[i])
        assert im.foc == np.float32(scene64.foc)
        np.testing.assert_array_equal(im.fov, np.float32([scene64.fov] * 2))
        np.testing.assert_array_equal(im.dpix, np.float32([scene64.dpix] * 2))
        assert im.size == (64, 64)
    from ssrlcv_tpu.io.images import read_image

    np.testing.assert_array_equal(read_image(seed_path), scene64.seed_image)


@pytest.mark.parametrize("shape,ext", [((17, 23), ".pgm"), ((9, 5, 3), ".ppm")])
def test_netpbm_round_trip(tmp_path, shape, ext):
    from ssrlcv_tpu.io.images import read_image, write_image

    px = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / f"img{ext}")
    write_image(path, px)
    back = read_image(path)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, px)


def test_netpbm_header_comments_and_malformed_files(tmp_path):
    from ssrlcv_tpu.io.images import read_netpbm

    px = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5\n# a comment\n4 3\n# another\n255\n" + px.tobytes())
    np.testing.assert_array_equal(read_netpbm(str(p)), px)
    for bad in (b"P2\n4 3\n255\n" + px.tobytes(),        # ASCII variant
                b"P5\n4 3\n65535\n" + px.tobytes(),      # 16-bit
                b"P5\n4 3\n255\n" + px.tobytes()[:5]):   # truncated
        p.write_bytes(bad)
        with pytest.raises(ValueError):
            read_netpbm(str(p))


def test_scene_pipeline_cloud_matches_true_surface(tmp_path):
    """A 256^2 generated pair through run_pipeline on the CPU: the initial
    and filtered clouds lie on the true surface (median height error within
    2 ground samples, 33 m: the stereo geometry's ~0.2 px disparity noise)."""
    from ssrlcv_tpu.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu.features.sift import generate_features
    from ssrlcv_tpu.io.images import load_directory
    from ssrlcv_tpu.io.scene import make_scene, write_scene
    from ssrlcv_tpu.pipeline.stages import STAGES, PipelineState

    scene = make_scene(0, 256)
    views, _ = write_scene(scene, str(tmp_path / "scene"))
    cfg = PipelineConfig(output_dir=str(tmp_path / "out")).replace(
        sift=SIFTParams(max_keypoints=4096),
        match=MatchParams(epsilon=25.0, delta=5.0))
    state = PipelineState(config=cfg, images=load_directory(views))
    state.seed_features = generate_features(scene.seed_image, cfg.sift, image_id=-1)
    clouds = {}
    for name, fn in STAGES:
        state = fn(state)
        if name in ("triangulation", "filtering"):
            clouds[name] = np.asarray(state.cloud.points)[np.asarray(state.cloud.mask)]
    for name, pts in clouds.items():
        assert len(pts) > 300, (name, len(pts))
        err = np.abs(scene.height_error_km(pts))
        assert np.median(err) < 0.033, (name, np.median(err))
    assert state.ba_error is not None and np.isfinite(state.ba_error).all()
