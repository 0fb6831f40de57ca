"""Unit tests for the round-4 SIFT machinery: count-aware capacity
quantization and the multi-image batch front end's CPU fallback."""

import numpy as np
import jax.numpy as jnp
import pytest


def test_quantize_cap_properties():
    from ssrlcv_tpu.features.sift import _quantize_cap

    # always >= the count, >= the floor, and bounded waste (granularity is
    # max(256, pow2ceil(n)/8), so cap < n + that granularity)
    for n in [0, 1, 17, 511, 512, 513, 1000, 1024, 4766, 9137, 12492, 65536]:
        cap = _quantize_cap(n)
        assert cap >= max(n, 1)
        assert cap >= 512
        if n > 512:
            p = 1 << (n - 1).bit_length()
            assert cap < n + max(256, p // 8) + 1, (n, cap)
    # bounded variant count: all caps in a pow2 bracket hit <= 8 values
    caps = {_quantize_cap(n) for n in range(8193, 16385)}
    assert len(caps) <= 8, caps


def test_generate_features_many_cpu_fallback_matches_single():
    """On CPU the batch API must return exactly what the per-image path
    returns."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.sift import generate_features, generate_features_many

    rng = np.random.default_rng(11)
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    imgs = [
        np.clip(128 + 100 * np.sin(xx / (3.0 + i)) * np.cos(yy / (5.0 - i))
                + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)
        for i in range(2)
    ]
    params = SIFTParams()
    many = generate_features_many(imgs, params, image_ids=[5, 6])
    for i, im in enumerate(imgs):
        ref = generate_features(im, params, image_id=5 + i)
        got = many[i]
        np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(ref.mask))
        np.testing.assert_array_equal(np.asarray(got.loc), np.asarray(ref.loc))
        np.testing.assert_array_equal(
            np.asarray(got.descriptors), np.asarray(ref.descriptors))
        np.testing.assert_array_equal(np.asarray(got.parent), np.asarray(ref.parent))


def test_params_csv_malformed_rows_are_loud_not_silent(tmp_path):
    """A malformed params.csv row must not silently zero a camera (that
    collapses the whole reconstruction minutes later): the row is skipped
    WITH an error log, valid rows still parse."""
    from ssrlcv_tpu.io.images import load_params_csv
    from ssrlcv_tpu.logging import logger

    p = tmp_path / "params.csv"
    p.write_text(
        "good.png,1.0,2.0,3.0,0.1,0.2,0.3,0.04,0.04,0.16,4e-7,4e-7,0,64,64\n"
        "bad.png,np.float32(1.0),2.0,3.0,0.1,0.2,0.3,0.04,0.04,0.16,4e-7,4e-7,0,64,64\n"
    )
    # capture the error call directly (the logger is a process-global whose
    # file sink other tests may already own)
    calls = []
    orig = logger.err
    logger.err = lambda msg: calls.append(msg)
    try:
        params = load_params_csv(str(p))
    finally:
        logger.err = orig
    assert "good.png" in params
    assert "bad.png" not in params
    assert any("cannot parse" in m for m in calls), (
        "malformed row must be logged as an error")


def test_matchset_device_assembly_matches_reference_layout():
    """The device-side MatchSet builder reproduces the documented layout:
    valid matches compacted to the front in query order, zero/-1/0/False
    padding."""
    from ssrlcv_tpu.core.types import FeatureSet
    from ssrlcv_tpu.matching.match import DMatches, matches_to_matchset

    q = FeatureSet.empty(6, parent=0).replace(
        loc=jnp.arange(12, dtype=jnp.float32).reshape(6, 2),
        mask=jnp.ones(6, bool))
    t = FeatureSet.empty(6, parent=1).replace(
        loc=100 + jnp.arange(12, dtype=jnp.float32).reshape(6, 2),
        mask=jnp.ones(6, bool))
    dm = DMatches(
        target_idx=jnp.array([5, 0, 3, 1, 2, 4], jnp.int32),
        distance=jnp.zeros(6),
        valid=jnp.array([False, True, False, True, True, False]),
    )
    ms = matches_to_matchset(dm, q, t, 7, 9)
    assert int(ms.count()) == 3
    locs = np.asarray(ms.kp_loc)
    # query order preserved over valid entries: queries 1, 3, 4
    np.testing.assert_array_equal(locs[0, 0], [2, 3])
    np.testing.assert_array_equal(locs[1, 0], [6, 7])
    np.testing.assert_array_equal(locs[2, 0], [8, 9])
    np.testing.assert_array_equal(locs[0, 1], [100, 101])   # target 0
    np.testing.assert_array_equal(locs[1, 1], [102, 103])   # target 1
    np.testing.assert_array_equal(np.asarray(ms.kp_parent)[0], [7, 9])
    # padding rows
    np.testing.assert_array_equal(locs[3:], 0.0)
    np.testing.assert_array_equal(np.asarray(ms.kp_parent)[3:], -1)
    np.testing.assert_array_equal(np.asarray(ms.num_views)[3:], 0)
    assert not np.asarray(ms.mask)[3:].any()
