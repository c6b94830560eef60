"""Run the VO front-end over an image sequence and evaluate ATE.

Usage:
  python tools/sequence_eval.py <frames_dir> [--gt tum_or_kitti_file]
      [--fu F --fv F --cu C --cv C]

Frames: sorted .pgm files (use the native loader). With --gt, prints
ATE RMSE (similarity-aligned, handles monocular scale) and RPE. Without,
prints the integrated trajectory. This is the config-3 harness; point it
at TUM fr1 / KITTI data when available.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--gt-format", choices=["tum", "kitti"], default="tum")
    ap.add_argument("--fu", type=float, default=525.0)
    ap.add_argument("--fv", type=float, default=525.0)
    ap.add_argument("--cu", type=float, default=319.5)
    ap.add_argument("--cv", type=float, default=239.5)
    ap.add_argument("--max-frames", type=int, default=200)
    # 'cpu' makes runs hermetic (tests); 'auto' uses JAX's default
    # backend (the GPU if present).
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"])
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from ethzasl_brisk_jax.core.image_io import read_pgm_batch
    from ethzasl_brisk_jax.geometry import PinholeCamera
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.vo import VoConfig, VoFrontend
    from ethzasl_brisk_jax.vo.evaluate import (
        ate_rmse,
        load_kitti_trajectory,
        load_tum_trajectory,
    )

    paths = sorted(
        str(p) for p in pathlib.Path(args.frames_dir).glob("*.pgm")
    )[: args.max_frames]
    if len(paths) < 2:
        raise SystemExit("need at least two .pgm frames")
    frames = read_pgm_batch(paths)
    h, w = frames.shape[1:]

    cam = PinholeCamera.create(args.fu, args.fv, args.cu, args.cv, w, h)
    feature = BriskFeature(
        octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
        max_candidates=1024, max_keypoints=1024,
    )
    vo = VoFrontend(camera=cam, feature=feature, config=VoConfig())
    poses = vo.run_sequence(list(frames))
    positions = np.stack([p[:3, 3] for p in poses])
    print(f"integrated {len(poses)} poses; path length "
          f"{np.linalg.norm(np.diff(positions, axis=0), axis=1).sum():.2f}")

    if args.gt:
        if args.gt_format == "tum":
            _, gt_pos, _ = load_tum_trajectory(args.gt)
        else:
            gt_pos = load_kitti_trajectory(args.gt)[:, :3, 3]
        n = min(len(gt_pos), len(positions))
        err = ate_rmse(positions[:n], gt_pos[:n], with_scale=True)
        print(f"ATE RMSE (sim-aligned): {err:.4f}")


if __name__ == "__main__":
    main()
