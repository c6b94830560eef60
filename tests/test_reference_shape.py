"""Regression: batched detect at the reference's own image size.

An earlier accelerator backend faulted on the batched (8, 640, 800)
detect executable. This CPU test pins the shape + values: batched and
single-frame detect must agree exactly at (640, 800), the shape of
brisk/src/test/test_data/img{1,2}.pgm.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_jax.pipeline import BriskFeature  # noqa: E402

REF_DATA = "/root/reference/brisk/src/test/test_data"


@pytest.mark.slow
def test_batched_detect_reference_shape():
    feature = BriskFeature(
        octaves=2,
        uniformity_radius=0.0,
        absolute_threshold=30.0,
        max_candidates=512,
        max_keypoints=512,
    )

    if os.path.isdir(REF_DATA):
        from ethzasl_brisk_jax.core.image_io import read_pgm

        img1 = read_pgm(os.path.join(REF_DATA, "img1.pgm"))
        img2 = read_pgm(os.path.join(REF_DATA, "img2.pgm"))
        frames_np = np.stack([img1, img2])
    else:  # hermetic fallback: smooth random frames at the same shape
        rng = np.random.default_rng(5)
        base = rng.integers(0, 256, (2, 640, 800)).astype(np.float32)
        k = np.ones((5, 5)) / 25.0
        from scipy import ndimage

        sm = np.stack(
            [ndimage.convolve(b, k, mode="nearest") for b in base]
        )
        frames_np = np.clip(sm, 0, 255).astype(np.uint8)

    frames = jnp.asarray(frames_np)

    def batched(fr):
        def one(img):
            kps = feature.detect(img)
            return kps.x, kps.y, kps.response, kps.valid

        return jax.vmap(one)(fr)

    bx, by, br, bv = jax.jit(batched)(frames)

    for i in range(frames.shape[0]):
        kps = jax.jit(feature.detect)(frames[i])
        for a, b in (
            (bx[i], kps.x), (by[i], kps.y),
            (br[i], kps.response), (bv[i], kps.valid),
        ):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert int(np.asarray(kps.valid).sum()) > 50
