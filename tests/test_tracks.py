"""End-to-end config-4 slice: detect -> match -> tracks -> triangulate ->
windowed BA on a synthetic scene with known geometry."""
import numpy as np
import pytest

from .test_vo import render_scene


@pytest.mark.slow
def test_tracks_to_ba():
    import jax.numpy as jnp

    from ethzasl_brisk_jax.ba import solve_window_ba
    from ethzasl_brisk_jax.ba.window import _residual_and_jacobians
    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.match.matcher import match_with_ratio_and_crosscheck
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.vo.tracks import build_ba_problem

    rng = np.random.default_rng(3)
    from scipy import ndimage

    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 2.0)
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)

    n = 4
    poses_gt = []
    frames = []
    for i in range(n):
        a = 0.01 * i
        r = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
             [-np.sin(a), 0, np.cos(a)]]
        )
        t = np.array([0.1 * i, 0.01 * i, 0.0])
        poses_gt.append((r, t))
        frames.append(render_scene(tex, cam, r, t))

    feature = BriskFeature(
        octaves=1, uniformity_radius=0.0, absolute_threshold=40.0,
        max_candidates=512, max_keypoints=512,
    )
    kps, descs = [], []
    for f in frames:
        k, d = feature.detect_and_compute(jnp.asarray(f))
        kps.append(k)
        descs.append(d)

    pair_matches = []
    for i in range(1, n):
        best, matched = match_with_ratio_and_crosscheck(
            descs[i], descs[i - 1], kps[i].valid, kps[i - 1].valid,
            max_distance=80,
        )
        # tracks convention: frame i matches into frame i-1.
        pair_matches.append((np.asarray(best), np.asarray(matched)))

    keypoint_xy = [
        np.stack([np.asarray(k.x), np.asarray(k.y)], 1) for k in kps
    ]
    # Perturbed poses (except the first two, anchoring gauge+scale).
    poses_init = []
    for i, (r, t) in enumerate(poses_gt):
        if i < 2:
            poses_init.append((r, t))
        else:
            dw = rng.normal(0, 0.004, 3)
            from ethzasl_brisk_jax.ba import so3_exp

            dr = np.asarray(so3_exp(jnp.asarray(dw[None], jnp.float32)))[0]
            poses_init.append((dr @ r, t + rng.normal(0, 0.02, 3)))

    prob = build_ba_problem(
        cam, poses_init, keypoint_xy, pair_matches,
        max_landmarks=1024, max_observations=4096,
    )
    n_obs = int(np.asarray(prob.valid).sum())
    assert n_obs > 300, n_obs

    res0, _, _, w0 = _residual_and_jacobians(prob)
    rms0 = float(np.sqrt(
        (np.asarray(res0) ** 2).sum(1)[np.asarray(w0) > 0].mean()
    ))
    solved, costs = solve_window_ba(prob, iterations=10, damping=1e-2)
    res1, _, _, w1 = _residual_and_jacobians(solved)
    rms1 = float(np.sqrt(
        (np.asarray(res1) ** 2).sum(1)[np.asarray(w1) > 0].mean()
    ))
    assert rms1 < rms0 * 0.5, (rms0, rms1)
    assert rms1 < 1.0, rms1

    # Optimized later poses closer to ground truth than the perturbed init.
    for i in range(2, 4):
        err_init = np.linalg.norm(poses_init[i][1] - poses_gt[i][1])
        err_opt = np.linalg.norm(
            np.asarray(solved.t)[i] - poses_gt[i][1]
        )
        assert err_opt < err_init, (i, err_init, err_opt)


@pytest.mark.quick
def test_residual_gate_drops_moving_track():
    """max_obs_residual_px invalidates coherently-moving tracks.

    Exact synthetic geometry: static landmarks project with zero
    residual; one track's middle observation is displaced (a moving
    point seen by 3 frames triangulates consistently from its endpoints
    but misfits the middle). The gate must drop that landmark entirely
    (its surviving-observation count falls under min_track_len) and
    keep every static track untouched.
    """
    import jax.numpy as jnp

    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.vo.tracks import build_ba_problem

    rng = np.random.default_rng(0)
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)
    n_frames, n_pts = 3, 12
    pts = np.stack(
        [rng.uniform(-1, 1, n_pts), rng.uniform(-0.8, 0.8, n_pts),
         rng.uniform(4.0, 7.0, n_pts)], 1
    )
    poses = []
    for i in range(n_frames):
        r = np.eye(3)
        t = np.array([-0.3 * i, 0.0, 0.0])   # camera-from-world
        poses.append((r, t))

    keypoint_xy = []
    for (r, t) in poses:
        x_c = pts @ r.T + t
        uv = np.stack(
            [400.0 * x_c[:, 0] / x_c[:, 2] + 320.0,
             400.0 * x_c[:, 1] / x_c[:, 2] + 240.0], 1
        )
        keypoint_xy.append(uv.astype(np.float32))
    # Landmark 0 "moves": displace its middle-frame observation.
    keypoint_xy[1][0, 0] += 25.0

    ident = np.arange(n_pts)
    ones = np.ones(n_pts, bool)
    pair_matches = [(ident, ones), (ident, ones)]

    def n_valid(**kw):
        prob = build_ba_problem(
            cam, poses, keypoint_xy, pair_matches,
            max_landmarks=64, max_observations=256,
            min_track_len=3, **kw,
        )
        return int(np.asarray(prob.valid).sum()), prob

    n_off, _ = n_valid()
    n_on, prob = n_valid(max_obs_residual_px=8.0)
    assert n_off == n_frames * n_pts, n_off
    # The whole 3-observation moving track is gone, nothing else.
    assert n_on == n_frames * (n_pts - 1), (n_on, n_off)
    lm = np.asarray(prob.lm_idx)[np.asarray(prob.valid)]
    assert 0 not in lm
