"""Dense SIFT + Window_NxN patch descriptor tests."""

import numpy as np
import jax.numpy as jnp


def _texture(h=96, w=96, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8)).astype(np.uint8)
    img = np.kron(base, np.ones((8, 8), np.uint8))
    return img


def test_dense_sift_covers_interior():
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.dense import generate_dense_sift

    img = _texture()
    fs = generate_dense_sift(img, SIFTParams(max_orientations=1))
    n = int(fs.count())
    interior = (96 - 24) * (96 - 24)
    # most interior pixels produce an oriented descriptor
    assert n > 0.5 * interior, (n, interior)
    loc = np.asarray(fs.loc)[:n]
    assert loc.min() >= 12 - 1e-5 and loc.max() < 96 - 12


def test_window_features_patch_content():
    from ssrlcv_tpu.features.dense import generate_window_features

    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    wf = generate_window_features(img, window=3)
    # first patch = rows 0..2, cols 0..2; its loc is the centre (1, 1)
    np.testing.assert_array_equal(np.asarray(wf.loc[0]), [1, 1])
    np.testing.assert_array_equal(
        np.asarray(wf.descriptors[0]), img[0:3, 0:3].reshape(-1)
    )


def test_sad_matching_finds_identical_patch():
    from ssrlcv_tpu.features.dense import generate_window_features, sad_best_target

    img = _texture(48, 48, seed=1)
    shifted = np.roll(img, 5, axis=1)  # target x = query x + 5
    q = generate_window_features(img, window=9)
    t = generate_window_features(shifted, window=9)
    idx, dist = sad_best_target(q.descriptors, t.descriptors, t.mask)
    qloc = np.asarray(q.loc)
    tloc = np.asarray(t.loc)[np.asarray(idx)]
    # away from the wrap seam, the best match should be at x+5
    inner = (qloc[:, 0] > 8) & (qloc[:, 0] < 30)
    dx = tloc[inner, 0] - qloc[inner, 0]
    assert (dx == 5).mean() > 0.8, (dx == 5).mean()
    assert float(np.median(np.asarray(dist)[inner])) == 0.0


def test_dense_orientation_field_matches_gather():
    """The stencil orientation field reproduces the per-keypoint gather
    histograms (compute_orientations) up to f32 reassociation ties."""
    import jax.numpy as jnp
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.dense import _dense_orientation_field, _interior_grid
    from ssrlcv_tpu.features.detector import SSKeyPoints
    from ssrlcv_tpu.features.orientation import compute_orientations
    from ssrlcv_tpu.ops import image_ops as ops

    params = SIFTParams()
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (64, 80)).astype(np.uint8)
    norm = ops.normalize_minmax(ops.to_float(jnp.asarray(img)))
    grads = ops.pixel_gradients(norm)
    w_or = 5

    theta_f, ok_f = _dense_orientation_field(grads, params, w_or, 64, 80)

    locs = _interior_grid(64, 80, params.border)
    n = len(locs)
    kps = SSKeyPoints(
        blur=jnp.zeros(n, jnp.int32), loc=jnp.asarray(locs),
        intensity=jnp.zeros(n, jnp.float32), sigma=jnp.ones(n, jnp.float32),
        theta=jnp.zeros(n, jnp.float32), mask=jnp.ones(n, bool))
    oriented = compute_orientations(grads[None], kps, 1.0, params, w_max=w_or)

    ok_ref = np.asarray(oriented.mask)
    th_ref = np.asarray(oriented.theta)
    ok_new = np.asarray(ok_f)
    th_new = np.asarray(theta_f)
    assert ok_new.shape == ok_ref.shape
    # masks agree except threshold/peak ties from f32 reassociation
    mask_mismatch = (ok_new != ok_ref).mean()
    assert mask_mismatch < 5e-3, mask_mismatch
    both = ok_new & ok_ref
    dth = np.abs(th_new[both] - th_ref[both])
    dth = np.minimum(dth, 2 * np.pi - dth)
    # nearly all common orientations agree tightly
    assert (dth < 1e-3).mean() > 0.999, (dth < 1e-3).mean()


def test_dense_sift_fast_matches_gather_path():
    """generate_dense_sift fast path agrees with the original gather-path
    oracle: same keypoint set (up to ties) and near-identical descriptors."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.dense import generate_dense_sift

    img = _texture(80, 96, seed=5)
    params = SIFTParams()
    fs_fast = generate_dense_sift(img, params, fast=True)
    fs_ref = generate_dense_sift(img, params, fast=False)

    def rows(fs):
        m = np.asarray(fs.mask)
        loc = np.asarray(fs.loc)[m]
        th = np.asarray(fs.theta)[m]
        desc = np.asarray(fs.descriptors)[m]
        out = {}
        for l, t, d in zip(loc, th, desc):
            # an occurrence counter keeps two orientations of one pixel that
            # round alike from colliding and dropping out of the comparison
            key = (float(l[0]), float(l[1]), round(float(t), 3))
            n = 0
            while key + (n,) in out:
                n += 1
            out[key + (n,)] = d
        return out

    a, b = rows(fs_fast), rows(fs_ref)
    common = set(a) & set(b)
    # keypoint sets agree except borderline ties
    assert len(common) > 0.995 * max(len(a), len(b)), (len(a), len(b), len(common))
    dmax = 0.0
    for k in common:
        d = np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
        dmax = max(dmax, float(d.max()))
    # descriptors within the reference's own distProtocol tolerance class
    assert dmax <= 3.0, dmax
