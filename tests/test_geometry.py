"""Geometry tests: camera round-trips and batched RANSAC on synthetic data."""
import numpy as np
import pytest

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy as jnp

    return jnp


class TestCameras:
    def test_pinhole_roundtrip(self, jnp):
        from ethzasl_brisk_jax.geometry import PinholeCamera

        cam = PinholeCamera.create(450.0, 452.0, 320.0, 240.0, 640, 480)
        rng = np.random.default_rng(0)
        pts = rng.uniform([-1, -1, 1], [1, 1, 5], (100, 3)).astype(np.float32)
        kp, valid = cam.project(jnp.asarray(pts))
        rays = cam.unproject(kp)
        # Rays must be parallel to the original points.
        p = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        cos = np.abs((np.asarray(rays) * p).sum(1))
        assert np.all(cos[np.asarray(valid)] > 1 - 1e-5)

    def test_radtan_roundtrip(self, jnp):
        from ethzasl_brisk_jax.geometry import (
            PinholeCamera,
            RadialTangentialDistortion,
        )

        dist = RadialTangentialDistortion.create(-0.3, 0.1, 1e-3, -2e-3)
        rng = np.random.default_rng(1)
        pn = rng.uniform(-0.5, 0.5, (200, 2)).astype(np.float32)
        pd = dist.distort(jnp.asarray(pn))
        pu = dist.undistort(pd)
        np.testing.assert_allclose(np.asarray(pu), pn, atol=1e-5)

        cam = PinholeCamera.create(
            450.0, 452.0, 320.0, 240.0, 640, 480, dist
        )
        pts = rng.uniform([-0.5, -0.5, 2], [0.5, 0.5, 6], (50, 3)).astype(
            np.float32
        )
        kp, valid = cam.project(jnp.asarray(pts))
        rays = np.asarray(cam.unproject(kp))
        p = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        cos = np.abs((rays * p).sum(1))
        assert np.all(cos[np.asarray(valid)] > 1 - 1e-4)

    def test_equidistant_roundtrip(self, jnp):
        from ethzasl_brisk_jax.geometry import EquidistantDistortion

        dist = EquidistantDistortion.create(-0.01, 0.005, -0.002, 0.001)
        rng = np.random.default_rng(2)
        pn = rng.uniform(-0.8, 0.8, (200, 2)).astype(np.float32)
        pd = dist.distort(jnp.asarray(pn))
        pu = dist.undistort(pd)
        np.testing.assert_allclose(np.asarray(pu), pn, atol=1e-4)


class TestRansac:
    def test_homography(self, jnp):
        import jax

        from ethzasl_brisk_jax.geometry.ransac import ransac_homography

        rng = np.random.default_rng(3)
        h_true = np.array(
            [[0.9, 0.1, 10.0], [-0.05, 1.05, -20.0], [1e-4, -5e-5, 1.0]]
        )
        n = 300
        p1 = rng.uniform(0, 600, (n, 2))
        ph = np.concatenate([p1, np.ones((n, 1))], 1) @ h_true.T
        p2 = ph[:, :2] / ph[:, 2:]
        # 30% outliers.
        out = rng.random(n) < 0.3
        p2[out] += rng.uniform(20, 100, (out.sum(), 2))
        h, mask, n_inl = ransac_homography(
            jax.random.PRNGKey(0),
            jnp.asarray(p1, jnp.float32),
            jnp.asarray(p2, jnp.float32),
            jnp.ones((n,), bool),
            threshold=2.0,
        )
        mask = np.asarray(mask)
        assert int(n_inl) > 0.9 * (~out).sum()
        assert (mask & out).sum() < 8
        h = np.asarray(h)
        np.testing.assert_allclose(h / h[2, 2], h_true, atol=2e-2)

    def test_essential(self, jnp):
        import jax

        from ethzasl_brisk_jax.geometry.ransac import (
            decompose_essential,
            ransac_essential,
        )

        rng = np.random.default_rng(4)
        # Ground-truth relative pose.
        angle = 0.1
        r_true = np.array(
            [
                [np.cos(angle), 0, np.sin(angle)],
                [0, 1, 0],
                [-np.sin(angle), 0, np.cos(angle)],
            ]
        )
        t_true = np.array([0.5, 0.1, 0.05])
        t_true /= np.linalg.norm(t_true)

        n = 400
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
        p_c2 = pts @ r_true.T + t_true
        r1 = pts[:, :2] / pts[:, 2:]
        r2 = p_c2[:, :2] / p_c2[:, 2:]
        out = rng.random(n) < 0.25
        r2[out] += rng.uniform(0.05, 0.2, (out.sum(), 2))

        e, mask, n_inl = ransac_essential(
            jax.random.PRNGKey(1),
            jnp.asarray(r1, jnp.float32),
            jnp.asarray(r2, jnp.float32),
            jnp.ones((n,), bool),
            threshold=1e-5,
        )
        assert int(n_inl) > 0.85 * (~out).sum()
        r, t, n_front = decompose_essential(
            e, jnp.asarray(r1, jnp.float32), jnp.asarray(r2, jnp.float32),
            mask,
        )
        r = np.asarray(r)
        t = np.asarray(t)
        # Rotation within ~0.5 deg; translation direction within ~2 deg.
        assert np.abs(np.trace(r @ r_true.T) - 3) < 3e-4
        assert np.abs(t @ t_true) > 0.999


class TestCameraAware:
    def test_undistorted_extraction(self, jnp):
        """Warp-canonicalized detection on a synthetically distorted image:
        keypoints map back into the distorted frame consistently."""
        import jax

        from ethzasl_brisk_jax.geometry import (
            PinholeCamera,
            RadialTangentialDistortion,
        )
        from ethzasl_brisk_jax.geometry.camera_aware import (
            CameraAwareFeature,
            bilinear_remap,
        )
        from ethzasl_brisk_jax.pipeline import BriskFeature

        rng = np.random.default_rng(6)
        from scipy import ndimage

        tex = ndimage.gaussian_filter(rng.uniform(0, 255, (240, 320)), 1.5)
        tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(
            np.uint8
        )

        dist = RadialTangentialDistortion.create(-0.25, 0.06, 0.0, 0.0)
        cam = PinholeCamera.create(260.0, 260.0, 160.0, 120.0, 320, 240,
                                   dist)
        feature = BriskFeature(
            octaves=0,
            uniformity_radius=0.0,
            absolute_threshold=40.0,
            max_candidates=256,
            max_keypoints=256,
        )
        caf = CameraAwareFeature(camera=cam, feature=feature)

        # Build a "distorted capture" of the texture: the texture IS the
        # undistorted view, so capture[p] = tex[undistort(p)] which means
        # remapping with the *undistort* maps. Reuse warp machinery:
        # distorted pixel -> normalized -> undistort -> virtual pixel.
        ys, xs = np.mgrid[0:240, 0:320]
        xn = (xs - 160.0) / 260.0
        yn = (ys - 120.0) / 260.0
        pu = np.asarray(
            dist.undistort(jnp.asarray(np.stack([xn, yn], -1), jnp.float32))
        )
        u = 260.0 * pu[..., 0] + 160.0
        v = 260.0 * pu[..., 1] + 120.0
        captured = np.asarray(
            bilinear_remap(jnp.asarray(tex), jnp.asarray(u, jnp.float32),
                           jnp.asarray(v, jnp.float32))
        )

        kps, desc, warped = caf.detect_and_compute(jnp.asarray(captured))
        n = int(kps.count())
        assert n > 20

        # The warped view approximates the original texture; detections in
        # the warped view should sit on texture corners: re-detect on the
        # raw texture and check proximity of the two sets.
        kps_ref, _ = feature.detect_and_compute(jnp.asarray(tex))
        from scipy.spatial import cKDTree

        a = np.stack(
            [np.asarray(kps_ref.x)[np.asarray(kps_ref.valid)],
             np.asarray(kps_ref.y)[np.asarray(kps_ref.valid)]], 1
        )
        # Compare in the undistorted (virtual) domain: map detections of
        # the warped view there directly (they were detected there).
        vx = np.asarray(kps.x)[np.asarray(kps.valid)]
        vy = np.asarray(kps.y)[np.asarray(kps.valid)]
        # kps were mapped back to distorted coords; re-map to virtual.
        pn = np.stack([(vx - 160.0) / 260.0, (vy - 120.0) / 260.0], -1)
        puk = np.asarray(
            dist.undistort(jnp.asarray(pn, jnp.float32))
        )
        b = np.stack(
            [260.0 * puk[..., 0] + 160.0, 260.0 * puk[..., 1] + 120.0], 1
        )
        d, _ = cKDTree(a).query(b, distance_upper_bound=3.0)
        assert (np.isfinite(d)).mean() > 0.5, (np.isfinite(d)).mean()
