"""Long synthetic-sequence VO accuracy benchmark (config 3-4 stand-in).

No KITTI/TUM data ships in this environment (zero egress), so this
renders a 200+ frame two-depth scene along a known trajectory and runs
the full VO front-end (detect -> describe -> ratio/crosscheck match ->
RANSAC essential -> GN refinement) against ground truth, with optional
photometric/occlusion stress:

* exposure drift: sinusoidal per-frame gain/bias (+-25% / +-12 grey),
* occlusion: a moving textured box covering ~8% of the frame.

Prints per-run stats and one JSON line:
  {"metric": "synthetic_vo_ate_rmse_simaligned", ...}

Usage: python tools/synthetic_vo_bench.py [--frames 200] [--stress]
       [--platform cpu|auto] [--json-out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--stress", action="store_true",
                    help="exposure drift + moving occluder")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"])
    ap.add_argument("--normalize-exposure", action="store_true",
                    help="per-frame photometric normalization before "
                         "detection (VoConfig.normalize_exposure)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--seed", type=int, default=11,
                    help="texture/occluder RNG seed (trajectory fixed); "
                         "the 200-frame ATE is chaotic under small "
                         "detector changes, so robustness claims need "
                         "several seeds")
    ap.add_argument("--export", default=None,
                    help="write frames as PGM + KITTI poses.txt to DIR "
                         "(for tools/kitti_eval.py keyframed+BA runs) "
                         "and exit")
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.vo import VoConfig, VoFrontend
    from ethzasl_brisk_jax.vo.evaluate import ate_rmse, rpe
    from ethzasl_brisk_jax.workloads import (
        make_texture,
        render_scene,
        vo_trajectory,
    )

    rng = np.random.default_rng(args.seed)
    tex = make_texture(rng)
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)
    poses = vo_trajectory(args.frames)

    occ_tex = make_texture(rng, 160, 200)
    frames = []
    for i, (r, t) in enumerate(poses):
        f = render_scene(tex, cam, r, t).astype(np.float32)
        if args.stress:
            gain = 1.0 + 0.25 * np.sin(0.11 * i)
            bias = 12.0 * np.sin(0.07 * i + 1.0)
            f = f * gain + bias
            # Moving textured occluder (~8% of the frame).
            oy = int(160 + 120 * np.sin(0.05 * i))
            ox = int(40 + 380 * (0.5 + 0.5 * np.sin(0.023 * i)))
            f[oy:oy + 160, ox:ox + 200] = occ_tex[
                : min(160, 480 - oy), : min(200, 640 - ox)
            ]
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    print(f"rendered {len(frames)} frames "
          f"({'stress' if args.stress else 'clean'})", flush=True)

    if args.export:
        from ethzasl_brisk_jax.core.image_io import write_pgm

        out = pathlib.Path(args.export)
        out.mkdir(parents=True, exist_ok=True)
        gt_lines = []
        for i, (f, (r, t)) in enumerate(zip(frames, poses)):
            write_pgm(str(out / f"{i:06d}.pgm"), f)
            m = np.hstack([r.T, (-r.T @ t)[:, None]])
            gt_lines.append(" ".join(f"{v:.9f}" for v in m.reshape(-1)))
        (out / "poses.txt").write_text("\n".join(gt_lines) + "\n")
        print(f"exported to {out}")
        return

    feature = BriskFeature(
        octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
        max_candidates=1024, max_keypoints=1024,
    )
    vo = VoFrontend(
        camera=cam, feature=feature,
        config=VoConfig(normalize_exposure=args.normalize_exposure),
    )
    est = vo.run_sequence(frames)
    est_pos = np.stack([p[:3, 3] for p in est])

    gt_pose = []
    for r, t in poses:
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ t  # world-from-camera position
        gt_pose.append(m)
    gt_pos = np.stack([m[:3, 3] for m in gt_pose])

    n = min(len(gt_pos), len(est_pos))
    ate = ate_rmse(est_pos[:n], gt_pos[:n], with_scale=True)
    path_len = float(
        np.linalg.norm(np.diff(gt_pos[:n], axis=0), axis=1).sum()
    )
    try:
        rpe_t = float(rpe(np.stack(est[:n]), np.stack(gt_pose[:n]))[0])
    except Exception:
        rpe_t = float("nan")
    print(
        f"frames {n}  path length {path_len:.2f}  "
        f"ATE RMSE (sim-aligned) {ate:.4f} ({100 * ate / path_len:.2f}% "
        f"of path)  RPE-t {rpe_t:.4f}",
        flush=True,
    )
    line = json.dumps(
        {
            "metric": "synthetic_vo_ate_rmse_simaligned"
            + ("_stress" if args.stress else ""),
            "value": round(float(ate), 4),
            "unit": "m",
            "frames": n,
            "path_length": round(path_len, 2),
            "ate_pct_of_path": round(100 * ate / path_len, 3),
        }
    )
    print(line)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(line + "\n")


if __name__ == "__main__":
    main()
