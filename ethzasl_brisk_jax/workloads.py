"""Seeded workloads shared by ``bench.py``, ``chip_smoke.py`` and the
multi-device dry run (``__graft_entry__.py``).

Nothing here is downloaded: frames, VO scenes and BA problems are made
from a seed. The Harris and AST configurations are the ones the bench
measures, with capacities sized for :func:`seeded_frames`; the
``certify_*`` functions check on the actual frames that no static
capacity truncated, so a config that does not fit its data fails loudly
instead of measuring a different workload.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

H, W = 480, 640
HARRIS_BATCH = 128
AST_BATCH = 32


class CapacityError(AssertionError):
    """A static capacity truncated on the frames it was certified on."""


def seeded_frames(n: int, h: int = H, w: int = W, seed: int = 1) -> np.ndarray:
    """(n, h, w) uint8 frames: uniform noise smoothed by a 5x5 box.

    Denser in corners than natural images, so every capacity of the
    pipelines is exercised.
    """
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, h, w)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)


def harris_feature():
    """The bench-class Harris configuration (reference golden params:
    octaves 2, uniformity radius 30, threshold 20) with per-layer
    candidate caps, exact block top-k, refine and describe caps sized
    for :func:`seeded_frames` (layer maxima about 9.6k/1.8k/2.9k/0.9k,
    describable about 565 per frame; :func:`certify_harris` checks).
    Descriptors use the default gather sampler, the fastest on the H100
    (PERF.md)."""
    from ethzasl_brisk_jax.pipeline import BriskFeature

    return BriskFeature(
        octaves=2,
        uniformity_radius=30.0,
        absolute_threshold=20.0,
        max_candidates=(12288, 4096, 4096, 2048),
        max_keypoints=1024,
        topk_impl="block",
        topk_block_size=2048,
        topk_block_r=256,
        refine_capacity=(768, 384, 256, 128),
        describe_capacity=768,
    )


def harris_feature_small():
    """The knobs of :func:`harris_feature` with capacities for 240x320
    :func:`seeded_frames` (the multi-device dry run)."""
    from ethzasl_brisk_jax.pipeline import BriskFeature

    return BriskFeature(
        octaves=2,
        uniformity_radius=30.0,
        absolute_threshold=20.0,
        max_candidates=(4096, 1024, 1024, 512),
        max_keypoints=512,
        topk_impl="block",
        topk_block_size=1024,
        topk_block_r=128,
        refine_capacity=(384, 192, 128, 64),
        describe_capacity=384,
    )


def ast_detector():
    """Classic BRISK (AGAST/OAST) detection, BriskFeatureDetector(70, 3)
    semantics on the dense engine."""
    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    return BriskFeatureDetector(threshold=70, octaves=3, detect_impl="dense")


def ast_pipeline(mesh):
    from ethzasl_brisk_jax.parallel.frames import AstFramePipeline

    return AstFramePipeline(detector=ast_detector(), mesh=mesh)


def certify_harris(feature, frames):
    """Check that no capacity of ``feature`` truncates on ``frames``.

    Uses the library diagnostics (candidate caps, block top-k sharpness,
    refine caps) and the describable count against the describe budget.
    Returns (observed maxima, the batched detections); raises
    :class:`CapacityError`.
    """
    from ethzasl_brisk_jax.describe.extractor import describable_count

    @jax.jit
    def stats(pat, fr):
        kps, diags = jax.vmap(feature.detect_with_diagnostics)(fr)
        n_desc = describable_count(
            pat, fr, kps, scale_invariant=feature.scale_invariant
        )
        return kps, diags, n_desc

    kps, diags, n_desc = stats(feature.extractor.pattern, frames)
    diags, n_desc = jax.device_get((diags, n_desc))
    budget = feature.describe_capacity * frames.shape[0]
    report = dict(
        cand_max=diags.cand_counts.max(axis=0).tolist(),
        cand_caps=diags.cand_caps[0].tolist(),
        accepted_max=diags.accepted_counts.max(axis=0).tolist(),
        refine_caps=diags.refine_caps[0].tolist(),
        topk_exact=bool(diags.topk_exact.all()),
        describable=int(n_desc),
        describe_budget=int(budget),
    )
    if not (bool(diags.ok.all()) and (not budget or n_desc <= budget)):
        raise CapacityError(f"Harris capacities truncate: {report}")
    return report, kps


def certify_ast(pipe, frames) -> dict:
    """Check the AST per-layer candidate caps of ``pipe`` (an
    AstFramePipeline) on ``frames`` with the library diagnostics.
    Returns the observed maxima; raises :class:`CapacityError`. The
    describe budget is checked on the step's output
    (:func:`certify_describe_budget`)."""
    from ethzasl_brisk_jax.detect.ast_scale_space import (
        ast_capacity_diagnostics,
    )

    det = pipe.detector
    diags = jax.device_get(jax.jit(jax.vmap(
        lambda im: ast_capacity_diagnostics(
            im, det.threshold, det.octaves, det.max_candidates_per_layer
        )
    ))(frames))
    report = dict(
        corner_max=diags.corner_counts.max(axis=0).tolist(),
        cand_caps=diags.cand_caps[0].tolist(),
    )
    if not bool(diags.ok.all()):
        raise CapacityError(f"AST candidate caps truncate: {report}")
    return report


def certify_describe_budget(kps, capacity_per_frame: int) -> int:
    """Check on a compacting step's output that its describe budget
    did not overflow: fewer described keypoints than budget slots proves
    every describable keypoint got one. Returns the described count."""
    n = int(jnp.sum(kps.valid))
    budget = capacity_per_frame * kps.valid.shape[0]
    if capacity_per_frame and n >= budget:
        raise CapacityError(f"describe budget full: {n} of {budget} slots")
    return n


# ---------------------------------------------------------------------------
# Synthetic VO scene and BA problem.
# ---------------------------------------------------------------------------
def make_texture(rng, h: int = 1024, w: int = 1024) -> np.ndarray:
    """Multi-octave noise texture: structure at several scales so BRISK
    finds corners at every pyramid level."""
    from scipy import ndimage

    tex = np.zeros((h, w))
    for sigma, amp in ((1.5, 1.0), (6.0, 1.0), (24.0, 0.8)):
        tex += amp * ndimage.gaussian_filter(
            rng.uniform(-1, 1, (h, w)), sigma
        ) / max(sigma / 8.0, 1.0)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    return (tex * 255).astype(np.uint8)


def render_scene(texture, cam, r, t) -> np.ndarray:
    """Render a two-depth scene (far plane + near slab) at pose (r, t).

    A single plane is degenerate for the essential matrix; the near slab
    adds the parallax needed for a well-conditioned two-view geometry.
    """
    from scipy import ndimage

    h, w = cam.height, cam.width
    ys, xs = np.mgrid[0:h, 0:w]
    xn = (xs - float(cam.cu)) / float(cam.fu)
    yn = (ys - float(cam.cv)) / float(cam.fv)
    rays = np.stack([xn, yn, np.ones_like(xn)], -1)  # posed-camera rays

    def backproject(z0):
        # p_c = lam * ray; p_w = r.T (p_c - t); p_w.z = z0.
        rinv = r.T
        d = rays @ rinv.T          # direction of p_w per unit lam
        o = -(rinv @ t)            # p_w at lam = 0
        lam = (z0 - o[2]) / d[..., 2]
        return o + d * lam[..., None]

    def tex_at(pw):
        u = pw[..., 0] / pw[..., 2] * float(cam.fu) + float(cam.cu)
        v = pw[..., 1] / pw[..., 2] * float(cam.fv) + float(cam.cv)
        return ndimage.map_coordinates(
            texture.astype(np.float32), [v, u], order=1, mode="nearest"
        )

    pw_near = backproject(3.0)
    pw_far = backproject(6.0)
    near_mask = (np.abs(pw_near[..., 0]) < 1.1) & (
        np.abs(pw_near[..., 1]) < 0.85
    )
    img = np.where(near_mask, tex_at(pw_near), tex_at(pw_far))
    return img.astype(np.uint8)


def vo_trajectory(n: int) -> list:
    """Smooth arc: forward motion + gentle yaw + lateral sway, as
    (R, t) camera-from-world poses."""
    poses = []
    for i in range(n):
        a = 0.004 * i
        yaw = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
             [-np.sin(a), 0, np.cos(a)]]
        )
        t = np.array(
            [0.05 * i + 0.01 * np.sin(0.08 * i), 0.004 * np.sin(0.05 * i),
             0.012 * i]
        )
        poses.append((yaw, t))
    return poses


def vo_camera():
    """VGA pinhole camera of the synthetic VO scenes."""
    from ethzasl_brisk_jax.geometry import PinholeCamera

    return PinholeCamera.create(400.0, 400.0, 320.0, 240.0, W, H)


def vo_sequence(n: int, seed: int = 11):
    """(frames, poses): n VGA frames of the two-depth scene along
    :func:`vo_trajectory`."""
    cam = vo_camera()
    tex = make_texture(np.random.default_rng(seed))
    poses = vo_trajectory(n)
    return [render_scene(tex, cam, r, t) for r, t in poses], poses


BA_FIXED_POSES = 2


def synthetic_ba_problem(seed: int = 0, k: int = 6, n_lm: int = 200):
    """A dense BA window (every landmark seen by every pose) with noisy
    initial poses and points, f32. The first ``BA_FIXED_POSES`` poses
    start exact: solved with ``fix_poses=BA_FIXED_POSES`` they fix the
    gauge including scale, so the optimum is unique (the ground truth).
    With one fixed pose, scale is a null direction and f32 rounding alone
    moves the damped solution along it."""
    from ethzasl_brisk_jax.ba import BaProblem, so3_exp

    rng = np.random.default_rng(seed)
    fu = fv = 400.0
    cu, cv = 320.0, 240.0
    centers = np.stack([np.linspace(0, 1.0, k), np.zeros(k), np.zeros(k)], 1)
    pts_gt = rng.uniform([-3, -2, 4], [3, 2, 10], (n_lm, 3))
    kf = np.repeat(np.arange(k), n_lm)
    lm = np.tile(np.arange(n_lm), k)
    t_cam = -centers  # x_c = x_w + t with identity rotations
    x_c = pts_gt[lm] + t_cam[kf]
    uv = np.stack(
        [fu * x_c[:, 0] / x_c[:, 2] + cu, fv * x_c[:, 1] / x_c[:, 2] + cv], 1
    )
    w_noise = rng.normal(0, 0.02, (k, 3)).astype(np.float32)
    w_noise[:BA_FIXED_POSES] = 0
    r0 = np.asarray(so3_exp(jnp.asarray(w_noise)))
    t0 = t_cam + rng.normal(0, 0.02, (k, 3))
    t0[:BA_FIXED_POSES] = t_cam[:BA_FIXED_POSES]
    pts0 = pts_gt + rng.normal(0, 0.05, (n_lm, 3))
    f32 = np.float32
    return BaProblem(
        r=np.asarray(r0, f32),
        t=np.asarray(t0, f32),
        points=np.asarray(pts0, f32),
        kf_idx=np.asarray(kf, np.int32),
        lm_idx=np.asarray(lm, np.int32),
        uv=np.asarray(uv, f32),
        valid=np.ones((len(kf),), bool),
        fu=f32(fu), fv=f32(fv), cu=f32(cu), cv=f32(cv),
    )
