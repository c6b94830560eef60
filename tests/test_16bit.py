"""16-bit image pipeline: uint16 detection + description.

The reference templates its pipeline over 8/16-bit images
(IntegralImage16 integral-image.h:163, Halfsample16
image-down-sampling.cc:56, SmoothedIntensity<float,float> x65536 at
brisk-descriptor-extractor.cc:707-711, float Harris accepting CV_16U at
harris-score-calculator-float.cc:115). Its 16-bit describe wiring is
latently broken upstream (imageScaled never assigned, :672-674), so
these tests validate the INTENDED semantics functionally: a uint16
image that is a pure rescale of a uint8 image must yield near-identical
detections and descriptors (descriptor bits compare smoothed
intensities, which are monotone under intensity scaling).
"""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def tex():
    from scipy import ndimage

    rng = np.random.default_rng(3)
    t = ndimage.gaussian_filter(rng.uniform(0, 255, (240, 320)), 1.5)
    return ((t - t.min()) / (np.ptp(t) + 1e-9) * 255).astype(np.uint8)


def test_u16_detect_matches_u8(tex):
    import jax.numpy as jnp

    from ethzasl_brisk_jax.detect.scale_space import (
        DetectorConfig,
        detect_keypoints,
    )

    cfg8 = DetectorConfig(
        octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
        max_candidates=512, max_keypoints=512,
    )
    # Float Harris on a 257x-scaled image scales scores by ~257^4.
    cfg16 = DetectorConfig(
        octaves=2, uniformity_radius=0.0,
        absolute_threshold=30.0 * 257.0**4,
        max_candidates=512, max_keypoints=512,
    )
    img8 = jnp.asarray(tex)
    img16 = jnp.asarray(tex.astype(np.uint16) * 257)
    kps8 = detect_keypoints(img8, cfg8)
    kps16 = detect_keypoints(img16, cfg16)
    n8 = int(np.asarray(kps8.valid).sum())
    n16 = int(np.asarray(kps16.valid).sum())
    assert n8 > 40
    # Integer vs float Harris: counts agree within a modest band.
    assert abs(n16 - n8) < 0.35 * n8, (n8, n16)

    # Positions: most uint16 detections coincide with uint8 ones.
    p8 = np.stack(
        [np.asarray(kps8.x)[np.asarray(kps8.valid)],
         np.asarray(kps8.y)[np.asarray(kps8.valid)]], 1
    )
    p16 = np.stack(
        [np.asarray(kps16.x)[np.asarray(kps16.valid)],
         np.asarray(kps16.y)[np.asarray(kps16.valid)]], 1
    )
    d = np.linalg.norm(p16[:, None] - p8[None, :], axis=-1).min(axis=1)
    assert (d < 1.5).mean() > 0.8, (d < 1.5).mean()


def test_u16_describe_matches_u8(tex):
    import jax.numpy as jnp

    from ethzasl_brisk_jax.pipeline import BriskFeature

    feature = BriskFeature(
        octaves=0, uniformity_radius=0.0, absolute_threshold=40.0,
        max_candidates=256, max_keypoints=256,
    )
    img8 = jnp.asarray(tex)
    img16 = jnp.asarray(tex.astype(np.uint16) * 257)

    kps = feature._detect_jit(img8)
    k8, d8 = feature.compute(img8, kps)
    k16, d16 = feature.compute(img16, kps)

    v = np.asarray(k8.valid) & np.asarray(k16.valid)
    assert v.sum() > 40
    # Same border filtering (size-based, image-size identical).
    np.testing.assert_array_equal(
        np.asarray(k8.valid), np.asarray(k16.valid)
    )
    # Angles nearly identical (monotone rescale of the long-pair sums).
    da = np.abs(np.asarray(k8.angle)[v] - np.asarray(k16.angle)[v])
    da = np.minimum(da, 360.0 - da)
    assert np.median(da) < 0.5, np.median(da)
    # Descriptors near-identical: fixed-point-vs-float rounding can flip
    # the odd near-threshold comparison only.
    a, b = np.asarray(d8)[v], np.asarray(d16)[v]
    ham = np.array(
        [bin(int(x) ^ int(y)).count("1")
         for x, y in zip(a.reshape(-1), b.reshape(-1))]
    ).reshape(a.shape).sum(axis=1)
    assert np.median(ham) <= 6, (np.median(ham), ham.max())
    assert (ham <= 20).mean() > 0.95
