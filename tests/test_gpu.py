"""Card-only parity checks (marker ``gpu``): the card against the CPU backend
of the same process, with the check functions chip_smoke.py runs at full
size.  They skip unless JAX's first device is a GPU; on the card:

    SSRLCV_TEST_PLATFORM=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _features(rng, n, cap, size=256):
    import jax.numpy as jnp

    from ssrlcv_tpu.core.types import FeatureSet

    mask = np.zeros(cap, bool)
    mask[:n] = True
    return FeatureSet(
        loc=jnp.asarray(rng.uniform(0, size, (cap, 2)).astype(np.float32)),
        sigma=jnp.ones(cap, jnp.float32),
        theta=jnp.zeros(cap, jnp.float32),
        descriptors=jnp.asarray(rng.integers(0, 256, (cap, 128)).astype(np.uint8)),
        mask=jnp.asarray(mask),
        parent=jnp.zeros(cap, jnp.int32),
    )


def test_matching_parity_card_vs_cpu(gpu, tmp_path):
    """Seed distances and double-constrained matching bit-identical on the
    card and the CPU, on capacity-padded sets that are not chunk multiples,
    with the scene's real epipolar geometry."""
    import jax

    import chip_smoke
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.io.images import cameras_from_refimages, load_directory
    from ssrlcv_tpu.io.scene import make_scene, write_scene

    views, _ = write_scene(make_scene(0, 256), str(tmp_path))
    cams = cameras_from_refimages(load_directory(views))
    rng = np.random.default_rng(5)
    q, t, s = _features(rng, 3000, 3200), _features(rng, 2900, 3100), _features(rng, 900, 1000)
    out = chip_smoke.check_matching(q, t, cams, MatchParams(epsilon=25.0, delta=5.0),
                                    s, jax.devices("cpu")[0])
    assert out["queries"] == 3000


def test_sift_parity_card_vs_cpu(gpu):
    """The fused SIFT program on the card and on the CPU agree on a scene
    view at the reference's bars."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.sift import _sift_fused_agg
    from ssrlcv_tpu.io.scene import make_scene

    px = make_scene(0, 512).images[0]
    params = SIFTParams(max_keypoints=16384)
    card, _, _ = _sift_fused_agg(jnp.asarray(px), jnp.int32(0), params, 512, 512)
    cpu = jax.devices("cpu")[0]
    host, _, _ = _sift_fused_agg(jax.device_put(px, cpu), jnp.int32(0), params, 512, 512)
    out = chip_smoke.check_sift(card, host)
    assert out["card"] > 1000
