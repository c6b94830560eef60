"""VO front-end test: synthetic planar-texture sequence with known motion.

Renders a textured plane under small camera rotations+translations, runs
the full detect->describe->match->RANSAC pipeline, and checks the
recovered relative rotation/translation directions (monocular scale is
left at unit norm).
"""
import pathlib

import numpy as np
import pytest


from ethzasl_brisk_jax.workloads import render_scene


@pytest.mark.slow
def test_vo_relative_pose():
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.vo import VoConfig, VoFrontend

    rng = np.random.default_rng(0)
    from scipy import ndimage

    texture = ndimage.gaussian_filter(
        rng.uniform(0, 255, (480, 640)), 2.0
    )
    texture = (
        (texture - texture.min()) / (np.ptp(texture) + 1e-9) * 255
    ).astype(np.uint8)

    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)
    angle = 0.02
    r_true = np.array(
        [
            [np.cos(angle), 0, np.sin(angle)],
            [0, 1, 0],
            [-np.sin(angle), 0, np.cos(angle)],
        ]
    )
    t_true = np.array([0.12, 0.03, 0.02])

    img_a = render_scene(texture, cam, np.eye(3), np.zeros(3))
    img_b = render_scene(texture, cam, r_true, t_true)

    feature = BriskFeature(
        octaves=2,
        uniformity_radius=0.0,
        absolute_threshold=40.0,
        max_candidates=1024,
        max_keypoints=1024,
    )
    vo = VoFrontend(camera=cam, feature=feature, config=VoConfig())
    ka, da = vo.process_frame(jnp.asarray(img_a))
    kb, db = vo.process_frame(jnp.asarray(img_b))
    r, t, n_inl, ok, _ = vo.relative_pose(
        jax.random.PRNGKey(2), ka, da, kb, db
    )
    assert bool(ok), f"only {int(n_inl)} inliers"
    r = np.asarray(r)
    t = np.asarray(t)
    rot_err = np.degrees(
        np.arccos(np.clip((np.trace(r @ r_true.T) - 1) / 2, -1, 1))
    )
    t_dir_err = np.degrees(
        np.arccos(
            np.clip(
                abs(t @ (t_true / np.linalg.norm(t_true))), -1, 1
            )
        )
    )
    # f32 8-point + refit; tighter bounds come with GN refinement in ba/.
    assert rot_err < 1.0, rot_err
    assert t_dir_err < 8.0, t_dir_err


@pytest.mark.slow
def test_vo_sequence_integration():
    """Multi-frame run_sequence on a synthetic camera track: integrated
    trajectory stays close to ground truth (with ground-truth scale)."""
    import jax.numpy as jnp

    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.vo import VoConfig, VoFrontend

    rng = np.random.default_rng(1)
    from scipy import ndimage

    texture = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 2.0)
    texture = (
        (texture - texture.min()) / (np.ptp(texture) + 1e-9) * 255
    ).astype(np.uint8)
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)

    # 4-frame track: small forward+side motion with slight yaw.
    n = 4
    frames, r_gt, t_gt = [], [], []
    for i in range(n):
        a = 0.012 * i
        r = np.array(
            [
                [np.cos(a), 0, np.sin(a)],
                [0, 1, 0],
                [-np.sin(a), 0, np.cos(a)],
            ]
        )
        t = np.array([0.08 * i, 0.0, 0.04 * i])
        frames.append(render_scene(texture, cam, r, t))
        r_gt.append(r)
        t_gt.append(t)

    feature = BriskFeature(
        octaves=2,
        uniformity_radius=0.0,
        absolute_threshold=40.0,
        max_candidates=1024,
        max_keypoints=1024,
    )
    vo = VoFrontend(camera=cam, feature=feature, config=VoConfig())
    # Ground-truth step norms as the monocular scale prior.
    norms = [
        np.linalg.norm(
            t_gt[i + 1] - (r_gt[i + 1] @ r_gt[i].T) @ t_gt[i]
        )
        for i in range(n - 1)
    ]
    poses = vo.run_sequence(frames, scale_norms=norms)
    assert len(poses) == n
    # Compare camera centers: pose = world-from-camera; gt center =
    # -R^T t.
    centers = np.stack([p[:3, 3] for p in poses])
    gt_centers = np.stack([-(r.T @ t) for r, t in zip(r_gt, t_gt)])
    err = np.linalg.norm(centers - gt_centers, axis=1)
    # f32 8-point frame-to-frame drift; GN refinement (ba layer) tightens
    # this in the full pipeline.
    assert err.max() < 0.15, err


class TestEvaluate:
    def test_ate_alignment(self):
        from ethzasl_brisk_jax.vo.evaluate import ate_rmse, rpe

        rng = np.random.default_rng(0)
        gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), axis=0)
        # Estimated = similarity-transformed gt + small noise.
        ang = 0.3
        r = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        est = 0.5 * (gt @ r.T) + np.array([1.0, -2.0, 3.0])
        est_noisy = est + rng.normal(0, 0.01, est.shape)
        assert ate_rmse(est_noisy, gt, with_scale=True) < 0.06
        assert ate_rmse(est, gt, with_scale=True) < 1e-6

        poses = np.broadcast_to(np.eye(4), (10, 4, 4)).copy()
        t_err, r_err = rpe(poses, poses)
        assert t_err == 0.0 and r_err < 1e-4

    def test_tum_kitti_parsers(self, tmp_path):
        from ethzasl_brisk_jax.vo.evaluate import (
            load_kitti_trajectory,
            load_tum_trajectory,
            quat_to_rot,
        )

        tum = tmp_path / "gt.txt"
        tum.write_text(
            "# comment\n"
            "1.0 0.1 0.2 0.3 0.0 0.0 0.0 1.0\n"
            "2.0 0.4 0.5 0.6 0.0 0.0 0.7071068 0.7071068\n"
        )
        ts, pos, quat = load_tum_trajectory(str(tum))
        assert ts.tolist() == [1.0, 2.0]
        np.testing.assert_allclose(pos[1], [0.4, 0.5, 0.6])
        r = quat_to_rot(quat)
        np.testing.assert_allclose(r[0], np.eye(3), atol=1e-7)
        # 90-deg z rotation.
        np.testing.assert_allclose(
            r[1], [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6
        )

        kitti = tmp_path / "poses.txt"
        kitti.write_text("1 0 0 5 0 1 0 6 0 0 1 7\n")
        p = load_kitti_trajectory(str(kitti))
        np.testing.assert_allclose(p[0, :3, 3], [5, 6, 7])


@pytest.mark.slow
def test_sequence_eval_harness(tmp_path):
    """Drive tools/sequence_eval.py end to end: synthetic frames written as
    PGM + KITTI-format ground truth -> ATE printed and small."""
    import subprocess
    import sys

    from ethzasl_brisk_jax.core.image_io import write_pgm
    from ethzasl_brisk_jax.geometry import PinholeCamera

    rng = np.random.default_rng(2)
    from scipy import ndimage

    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 2.0)
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)

    gt_lines = []
    for i in range(4):
        a = 0.012 * i
        r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.1 * i, 0.0, 0.03 * i])
        frame = render_scene(tex, cam, r, t)
        write_pgm(str(tmp_path / f"{i:06d}.pgm"), frame)
        # KITTI: world-from-camera [R^T | -R^T t].
        m = np.hstack([r.T, (-r.T @ t)[:, None]])
        gt_lines.append(" ".join(f"{v:.9f}" for v in m.reshape(-1)))
    (tmp_path / "poses.txt").write_text("\n".join(gt_lines) + "\n")

    out = subprocess.run(
        [sys.executable, "tools/sequence_eval.py", str(tmp_path),
         "--gt", str(tmp_path / "poses.txt"), "--gt-format", "kitti",
         "--fu", "400", "--fv", "400", "--cu", "320", "--cv", "240",
         # Hermetic: the subprocess runs on the CPU.
         "--platform", "cpu"],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=400,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    ate_line = [l for l in out.stdout.splitlines() if "ATE RMSE" in l]
    assert ate_line, out.stdout
    ate = float(ate_line[0].split(":")[1])
    # Monocular VO, sim-aligned: loose functional bound.
    assert ate < 0.1, out.stdout
