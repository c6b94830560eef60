"""CameraAwareFeatureGrid: grid-of-virtual-views camera-aware pipeline.

Functional tests against the reference semantics
(brisk/src/camera-aware-feature.cc): a 1x1 grid under NoDistortion must
reproduce the plain pipeline bit-for-bit, and for strong radial
distortion the grid must out-describe the single-virtual-view variant
near the image border (the reference's whole point, .h:68-89).
"""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy as jnp

    return jnp


@pytest.fixture(scope="module")
def feature():
    from ethzasl_brisk_jax.pipeline import BriskFeature

    return BriskFeature(
        octaves=0,
        uniformity_radius=0.0,
        absolute_threshold=35.0,
        max_candidates=512,
        max_keypoints=512,
    )


def _texture(h, w, seed=6):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    return (
        (tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255
    ).astype(np.uint8)


def test_identity_grid_matches_plain_pipeline(feature, jnp):
    """Huge tolerance -> 1x1 grid; NoDistortion -> the virtual view IS
    the original camera (focal=fu, center=principal point, size=image),
    so detections+descriptors must match the plain pipeline exactly on
    keypoints that survive the grid's extra border filter."""
    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.geometry.camera_aware import (
        CameraAwareFeatureGrid,
    )

    h, w = 240, 320
    cam = PinholeCamera.create(300.0, 300.0, w / 2.0, h / 2.0, w, h)
    grid = CameraAwareFeatureGrid(
        camera=cam, feature=feature, distortion_tolerance=10.0
    )
    assert grid.n_x == 1 and grid.n_y == 1
    v = grid._views[0]
    assert (v.pixels_u, v.pixels_v) == (w, h)
    np.testing.assert_allclose(v.center_u, w / 2.0, atol=1e-3)
    np.testing.assert_allclose(v.center_v, h / 2.0, atol=1e-3)
    np.testing.assert_allclose(float(grid.focal), 300.0, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(grid._r_ci_c[0]), np.eye(3), atol=1e-5
    )

    img = jnp.asarray(_texture(h, w))
    # The identity view warp must reproduce the image exactly.
    warped = np.asarray(grid.warp_views(img))[0]
    np.testing.assert_array_equal(warped[:h, :w], np.asarray(img))

    kps_g, desc_g = grid.detect_and_compute(img)
    kps_p, desc_p = feature.detect_and_compute(img)

    # Same detections (grid detects on the original image).
    np.testing.assert_array_equal(np.asarray(kps_g.x), np.asarray(kps_p.x))
    # Grid validity = plain validity + removeBorderKeypoints(2.0).
    s2 = 2.0 * np.asarray(kps_p.size)
    x, y = np.asarray(kps_p.x), np.asarray(kps_p.y)
    ok_border = (
        (x - s2 >= 0) & (y - s2 >= 0) & (x + s2 <= w) & (y + s2 <= h)
    )
    vg = np.asarray(kps_g.valid)
    vp = np.asarray(kps_p.valid)
    np.testing.assert_array_equal(vg, vp & ok_border)
    assert vg.sum() > 30
    # Descriptors: the view path round-trips keypoints through the f32
    # undistort maps (bilinear interpolation, as the reference does), so
    # coordinates can differ in the last ULP and flip the odd
    # short-pair comparison near a threshold. Require near-identity:
    # mean Hamming distance well under a bit.
    dg, dp = np.asarray(desc_g)[vg], np.asarray(desc_p)[vg]
    ham = np.array(
        [bin(int(a) ^ int(b)).count("1")
         for a, b in zip(dg.reshape(-1), dp.reshape(-1))]
    ).reshape(dg.shape).sum(axis=1)
    assert (ham == 0).mean() > 0.98, ham
    assert ham.max() <= 4
    # Angles map back through identity warps: equal to plain's BRISK
    # orientation up to the interpolated back-transform.
    da = np.abs(np.asarray(kps_g.angle)[vg] - np.asarray(kps_p.angle)[vg])
    da = np.minimum(da, 360.0 - da)
    assert da.max() < 0.75


def test_grid_beats_single_view_near_border(feature, jnp):
    """Strong barrel distortion: the single virtual view loses border
    keypoints (they fall outside its usable area / suffer heavy scale
    change); the grid's per-region views keep describing them."""
    from ethzasl_brisk_jax.geometry import (
        PinholeCamera,
        RadialTangentialDistortion,
    )
    from ethzasl_brisk_jax.geometry.camera_aware import (
        CameraAwareFeature,
        CameraAwareFeatureGrid,
        bilinear_remap,
    )

    h, w = 240, 320
    dist = RadialTangentialDistortion.create(-0.31, 0.11, 0.0, 0.0)
    cam = PinholeCamera.create(200.0, 200.0, w / 2.0, h / 2.0, w, h, dist)

    # Synthetic distorted capture of a texture (same recipe as the
    # single-view test): capture[p] = tex[undistort(p)].
    tex = _texture(h, w)
    ys, xs = np.mgrid[0:h, 0:w]
    xn = (xs - w / 2.0) / 200.0
    yn = (ys - h / 2.0) / 200.0
    pu = np.asarray(
        dist.undistort(jnp.asarray(np.stack([xn, yn], -1), jnp.float32))
    )
    u = 200.0 * pu[..., 0] + w / 2.0
    v = 200.0 * pu[..., 1] + h / 2.0
    captured = jnp.asarray(
        np.asarray(
            bilinear_remap(
                jnp.asarray(tex),
                jnp.asarray(u, jnp.float32),
                jnp.asarray(v, jnp.float32),
            )
        )
    )

    grid = CameraAwareFeatureGrid(
        camera=cam, feature=feature, distortion_tolerance=2e-1, margin=40
    )
    assert grid.n_views >= 4  # wide FOV + tolerance 0.2 -> real grid

    # Selection map must cover (nearly) the full image.
    sel = np.asarray(grid._sel_map)
    assert (sel > 0).mean() > 0.98

    kps_g, desc_g = grid.detect_and_compute(captured)
    single = CameraAwareFeature(camera=cam, feature=feature)
    kps_s, desc_s, _ = single.detect_and_compute(captured)

    def near_border_count(kps):
        m = 50.0
        x, y = np.asarray(kps.x), np.asarray(kps.y)
        near = (x < m) | (x >= w - m) | (y < m) | (y >= h - m)
        return int((near & np.asarray(kps.valid)).sum())

    ng, ns = near_border_count(kps_g), near_border_count(kps_s)
    assert ng > 10
    assert ng > ns, (ng, ns)


def test_extraction_direction(feature, jnp):
    """setExtractionDirection analog: e_C = +y must yield ~90 deg angles
    near the image center of an undistorted camera."""
    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.geometry.camera_aware import (
        CameraAwareFeatureGrid,
    )

    h, w = 240, 320
    cam = PinholeCamera.create(300.0, 300.0, w / 2.0, h / 2.0, w, h)
    grid = CameraAwareFeatureGrid(
        camera=cam,
        feature=feature,
        distortion_tolerance=10.0,
        extraction_direction=(0.0, 1.0, 0.0),
    )
    img = jnp.asarray(_texture(h, w))
    kps, _ = grid.detect_and_compute(img)
    v = np.asarray(kps.valid)
    x, y = np.asarray(kps.x)[v], np.asarray(kps.y)[v]
    ang = np.asarray(kps.angle)[v]
    central = (
        (np.abs(x - w / 2.0) < 60) & (np.abs(y - h / 2.0) < 60)
    )
    assert central.sum() > 5
    da = np.abs(ang[central] - 90.0)
    assert np.minimum(da, 360 - da).max() < 3.0
