"""Single-device vs multi-device bitwise equality.

SURVEY §4 maps the reference's golden-file discipline onto the scale-out
design: detections, descriptors and matches must be IDENTICAL between a
1-device run and an N-device mesh run (data-parallel frames + model-sharded
matching). Realistic shape: 480x640 frames,
>=1024-keypoint caps, reference-equivalent uniformity config.
"""
import numpy as np
import pytest


def _frames(batch, h, w, seed=3):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (batch, h, w)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)


@pytest.mark.slow
def test_single_vs_multi_device_bitwise():
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.parallel import FramePipeline, make_mesh
    from ethzasl_brisk_jax.pipeline import BriskFeature

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")

    feature = BriskFeature(
        octaves=2,
        uniformity_radius=30.0,
        absolute_threshold=30.0,
        max_candidates=2048,
        max_keypoints=1024,
    )
    frames = jnp.asarray(_frames(8, 480, 640))

    mesh8 = make_mesh(4, 2)
    mesh1 = make_mesh(1, 1)

    with mesh8:
        kps8, desc8, midx8, mdist8 = FramePipeline(
            feature=feature, mesh=mesh8
        ).step(frames)
    with mesh1:
        kps1, desc1, midx1, mdist1 = FramePipeline(
            feature=feature, mesh=mesh1
        ).step(frames)

    # Detections bitwise identical.
    for f in ("x", "y", "size", "angle", "response", "octave", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kps8, f)), np.asarray(getattr(kps1, f)), f
        )
    # Descriptors and matches bitwise identical.
    np.testing.assert_array_equal(np.asarray(desc8), np.asarray(desc1))
    np.testing.assert_array_equal(np.asarray(midx8), np.asarray(midx1))
    np.testing.assert_array_equal(np.asarray(mdist8), np.asarray(mdist1))

    # Sanity: the run actually detected something on every frame.
    assert int(np.asarray(kps8.valid).sum(axis=1).min()) > 50


@pytest.mark.slow
def test_sharded_knn_equals_dense():
    """Model-sharded knn == replicated dense knn, bitwise (idx and dist)."""
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.match.matcher import hamming_distance_matrix
    from ethzasl_brisk_jax.parallel import make_mesh, sharded_knn_match

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")

    rng = np.random.default_rng(11)
    q = jnp.asarray(rng.integers(0, 2**32, (96, 12), dtype=np.uint32))
    t = jnp.asarray(rng.integers(0, 2**32, (256, 12), dtype=np.uint32))
    tv = jnp.asarray(rng.random(256) < 0.9)

    mesh = make_mesh(1, 8)
    with mesh:
        idx, dist = sharded_knn_match(mesh, q, t, tv, k=2)

    d = np.asarray(hamming_distance_matrix(q, t))
    d = np.where(np.asarray(tv)[None, :], d, 385)
    order = np.lexsort((np.broadcast_to(np.arange(256), d.shape), d), axis=1)
    np.testing.assert_array_equal(np.asarray(idx), order[:, :2])
    np.testing.assert_array_equal(
        np.asarray(dist), np.take_along_axis(d, order[:, :2], axis=1)
    )
