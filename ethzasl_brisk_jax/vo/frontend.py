"""Monocular visual-odometry front-end on BRISK tracks.

New scope beyond the reference (SURVEY.md section 2.5): the reference ends
at matching; the north star's config 3 is a frame-to-frame VO front-end
(TUM fr1-style monocular sequences). Composition:

  detect+describe (pipeline.BriskFeature, Harris path by default —
  fastest dense path) -> ratio+cross-check matching (match.matcher) ->
  unprojection through the camera model (geometry.cameras) ->
  batched-hypothesis essential RANSAC + cheirality decomposition
  (geometry.ransac) -> relative pose (R, t_unit).

Monocular scale is unobservable; translation magnitude is left at unit
norm (callers integrate scale from an external prior, e.g. ground truth
norm for benchmark ATE, or the BA layer).

Everything is jit-compiled with static shapes; per-frame state is a pair
(descriptors, keypoints) carried functionally.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.geometry.cameras import PinholeCamera
from ethzasl_brisk_jax.geometry.ransac import (
    decompose_essential,
    ransac_essential,
    refine_relative_pose,
)
from ethzasl_brisk_jax.match.matcher import match_with_ratio_and_crosscheck
from ethzasl_brisk_jax.pipeline import BriskFeature


@dataclasses.dataclass(frozen=True)
class VoConfig:
    max_hamming: int = 80
    ratio_num: int = 8
    ratio_den: int = 10
    ransac_threshold: float = 2e-5   # Sampson, normalized coords
    ransac_hypotheses: int = 512
    min_inliers: int = 30
    refine_iterations: int = 10      # GN Sampson refinement (0 = off)
    # Per-frame affine photometric normalization before detection:
    # exposure drift (gain/bias) shifts Harris responses across the
    # absolute threshold, destabilizing the detected keypoint set even
    # though BRISK's intensity-comparison bits are order-invariant.
    # Normalizing each frame to a fixed mean/std keeps detections
    # consistent under drift.
    normalize_exposure: bool = False
    norm_target_mean: float = 128.0
    norm_target_std: float = 48.0
    # Minimum spatial spread of the RANSAC inlier consensus, as the
    # inlier bounding-box area fraction of the frame. A consensus
    # concentrated in a small region is the signature of a coherently-
    # moving foreground object (e.g. an occluder box) winning the vote
    # while true-scene matches are depressed (exposure dips) — its
    # epipolar geometry describes the OBJECT's motion, not the
    # camera's. 0 disables.
    min_inlier_spread: float = 0.0


@jax.jit
def normalize_exposure_u8(
    img: jnp.ndarray, target_mean=128.0, target_std=48.0
) -> jnp.ndarray:
    """Affine-normalize a uint8/uint16 frame to a fixed mean/std (u8 out).

    Inverse-gain/bias correction: order-preserving, so descriptor
    comparison bits are unchanged up to requantization; detection
    thresholds see a stationary intensity distribution.
    """
    f = img.astype(jnp.float32)
    m = jnp.mean(f)
    s = jnp.std(f) + 1e-6
    out = (f - m) * (target_std / s) + target_mean
    return jnp.clip(jnp.round(out), 0.0, 255.0).astype(jnp.uint8)


@dataclasses.dataclass(frozen=True)
class VoFrontend:
    """Frame-to-frame monocular VO."""

    camera: PinholeCamera
    feature: BriskFeature
    config: VoConfig = VoConfig()

    def process_frame(self, img: jnp.ndarray):
        """One frame -> (keypoints, descriptors)."""
        if self.config.normalize_exposure:
            img = normalize_exposure_u8(
                img, self.config.norm_target_mean,
                self.config.norm_target_std,
            )
        return self.feature.detect_and_compute(img)

    def correspondences(
        self,
        kp_a: KeyPoints,
        desc_a: jnp.ndarray,
        kp_b: KeyPoints,
        desc_b: jnp.ndarray,
    ):
        """Matches of a's keypoints in b: (pa pixel coords of a, ra, rb
        normalized image coords of both, matched mask), all over a's
        keypoint slots."""
        cfg = self.config
        best, matched = match_with_ratio_and_crosscheck(
            desc_a,
            desc_b,
            kp_a.valid,
            kp_b.valid,
            max_distance=cfg.max_hamming,
            ratio_num=cfg.ratio_num,
            ratio_den=cfg.ratio_den,
        )
        pa = jnp.stack([kp_a.x, kp_a.y], axis=-1)
        pb = jnp.stack(
            [jnp.take(kp_b.x, best), jnp.take(kp_b.y, best)], axis=-1
        )
        ra3 = self.camera.unproject(pa)
        rb3 = self.camera.unproject(pb)
        ra = ra3[..., :2] / ra3[..., 2:3]
        rb = rb3[..., :2] / rb3[..., 2:3]
        return pa, ra, rb, matched

    def relative_pose(
        self,
        key,
        kp_a: KeyPoints,
        desc_a: jnp.ndarray,
        kp_b: KeyPoints,
        desc_b: jnp.ndarray,
    ):
        """Relative pose b->a: returns (R, t_unit, n_inliers, ok,
        inlier mask)."""
        cfg = self.config
        pa, ra, rb, matched = self.correspondences(kp_a, desc_a, kp_b, desc_b)
        e, inl, n_inl = ransac_essential(
            key,
            ra,
            rb,
            matched,
            threshold=cfg.ransac_threshold,
            n_hypotheses=cfg.ransac_hypotheses,
        )
        r, t, n_front = decompose_essential(e, ra, rb, inl)
        if cfg.refine_iterations > 0:
            r, t, _ = refine_relative_pose(
                r, t, ra, rb, inl.astype(ra.dtype),
                iterations=cfg.refine_iterations,
            )
        ok = n_inl >= cfg.min_inliers
        if cfg.min_inlier_spread > 0.0:
            big = jnp.float32(1e9)
            ix = jnp.where(inl, pa[..., 0], big)
            iy = jnp.where(inl, pa[..., 1], big)
            jx = jnp.where(inl, pa[..., 0], -big)
            jy = jnp.where(inl, pa[..., 1], -big)
            area = jnp.maximum(jx.max() - ix.min(), 0.0) * jnp.maximum(
                jy.max() - iy.min(), 0.0
            )
            frame_area = jnp.float32(
                float(self.camera.width) * float(self.camera.height)
            )
            ok &= area >= cfg.min_inlier_spread * frame_area
        return r, t, n_inl, ok, inl

    def run_sequence(self, frames, key=None, scale_norms=None):
        """Host driver: integrate frame-to-frame poses over a sequence.

        frames: iterable of (H, W) uint8 numpy arrays.
        scale_norms: optional per-step translation magnitudes (monocular
        scale prior); defaults to 1.
        Returns list of 4x4 world-from-camera poses (first = identity).
        """
        if key is None:
            key = jax.random.PRNGKey(0)
        poses = [np.eye(4)]
        prev = None
        for i, frame in enumerate(frames):
            cur = self.process_frame(jnp.asarray(frame))
            if prev is not None:
                key, sub = jax.random.split(key)
                r, t, n_inl, ok, _ = self.relative_pose(
                    sub, prev[0], prev[1], cur[0], cur[1]
                )
                r = np.asarray(r)
                t = np.asarray(t)
                s = 1.0 if scale_norms is None else float(
                    scale_norms[i - 1]
                )
                # relative_pose returns points_b = R points_a + t
                # (camera b seen from a); invert for world integration.
                t_ab = np.eye(4)
                t_ab[:3, :3] = r.T
                t_ab[:3, 3] = -r.T @ (t * s)
                if bool(ok):
                    poses.append(poses[-1] @ t_ab)
                else:
                    poses.append(poses[-1].copy())  # lost: hold pose
            prev = cur
        return poses
