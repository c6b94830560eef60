"""Camera-model + camera-aware feature demo.

The JAX equivalent of the reference's ``test-cameras`` binary
(``brisk/src/test-cameras.cc:40-174``): build distorted cameras, project
and unproject point clouds, and run camera-aware (virtual-undistorted)
feature extraction on a synthetic capture.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    import jax.numpy as jnp
    import numpy as np

    from ethzasl_brisk_jax.geometry import (
        EquidistantDistortion,
        PinholeCamera,
        RadialTangentialDistortion,
    )
    from ethzasl_brisk_jax.geometry.camera_aware import CameraAwareFeature
    from ethzasl_brisk_jax.pipeline import BriskFeature

    rng = np.random.default_rng(0)
    for name, dist in [
        ("pinhole (no distortion)", None),
        ("radial-tangential", RadialTangentialDistortion.create(
            -0.3, 0.1, 1e-3, -2e-3)),
        ("equidistant", EquidistantDistortion.create(
            -0.01, 0.007, -0.002, 0.001)),
    ]:
        cam = PinholeCamera.create(
            450.0, 451.0, 320.0, 240.0, 640, 480, dist
        )
        pts = rng.uniform([-1, -1, 2], [1, 1, 8], (5000, 3)).astype(
            np.float32
        )
        kp, valid = cam.project(jnp.asarray(pts))
        rays = cam.unproject(kp)
        p = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        cos = np.abs((np.asarray(rays) * p).sum(1))[np.asarray(valid)]
        print(
            f"{name:<26} projected {int(valid.sum())}/5000 in-image; "
            f"unproject alignment: min cos {cos.min():.6f}"
        )

    # Camera-aware extraction on a distorted synthetic capture.
    from scipy import ndimage

    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 1.5)
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)
    dist = RadialTangentialDistortion.create(-0.25, 0.06, 0.0, 0.0)
    cam = PinholeCamera.create(450.0, 450.0, 320.0, 240.0, 640, 480, dist)
    feature = BriskFeature(
        octaves=1, uniformity_radius=0.0, absolute_threshold=40.0,
        max_candidates=512, max_keypoints=512,
    )
    caf = CameraAwareFeature(camera=cam, feature=feature)
    kps, desc, warped = caf.detect_and_compute(jnp.asarray(tex))
    print(f"camera-aware extraction: {int(kps.count())} keypoints "
          f"(mapped back into the distorted frame)")


if __name__ == "__main__":
    main()
