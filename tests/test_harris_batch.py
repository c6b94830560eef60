"""Batched Harris scores and 2-D maxima against the scalar NumPy
reference (tests/np_reference.py), at the shapes the detector batches:
three 120x200 frames and a 190-wide crop (a width that is not a power of
two), thresholds 20 and 300.
"""
import numpy as np
import pytest

from tests import np_reference as ref


@pytest.fixture(scope="module")
def frames():
    from scipy import ndimage

    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (3, 120, 200)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("width", [200, 190])
@pytest.mark.parametrize("thr", [20, 300])
def test_batched_harris_and_maxima_match_reference(frames, width, thr):
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.kernels.harris import harris_score_i32
    from ethzasl_brisk_jax.kernels.nms import maxima2d_mask

    crop = frames[:, :, :width]
    scores = jax.jit(jax.vmap(harris_score_i32))(jnp.asarray(crop))
    masks = jax.jit(jax.vmap(lambda s: maxima2d_mask(s, thr)))(scores)
    for f in range(crop.shape[0]):
        want = ref.harris_scores(crop[f])
        np.testing.assert_array_equal(np.asarray(scores[f]), want)
        np.testing.assert_array_equal(
            np.asarray(masks[f]), ref.maxima2d(want, thr)
        )
    assert int(np.asarray(masks).sum()) > 0  # non-vacuous
