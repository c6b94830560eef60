"""Generate a synthetic monocular sequence with KITTI-format ground truth.

Renders a textured two-depth scene (workloads.render_scene) from a
smooth forward+turn trajectory and writes frame_%04d.pgm plus poses.txt
(KITTI odometry format: 12 numbers per line, world-from-camera [R|t]).
Used to validate tools/kitti_eval.py until real KITTI/TUM data is
available (nothing is downloaded).

Usage: python tools/gen_synthetic_seq.py <out_dir> [--frames N]
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    from scipy import ndimage

    from ethzasl_brisk_jax.core.image_io import write_pgm
    from ethzasl_brisk_jax.geometry import PinholeCamera

    from ethzasl_brisk_jax.workloads import render_scene

    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 2.0)
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, 640, 480)

    lines = []
    for i in range(args.frames):
        # Smooth yaw + translation (camera-from-world R, t).
        a = 0.008 * i
        r = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
             [-np.sin(a), 0, np.cos(a)]]
        )
        t = np.array([0.08 * i, 0.01 * np.sin(0.3 * i), 0.02 * i])
        frame = render_scene(tex, cam, r, t)
        write_pgm(str(out / f"frame_{i:04d}.pgm"), frame)
        # KITTI gt = world-from-camera [R|t].
        rw = r.T
        tw = -r.T @ t
        m = np.hstack([rw, tw[:, None]])
        lines.append(" ".join(f"{v:.9e}" for v in m.reshape(-1)))

    (out / "poses.txt").write_text("\n".join(lines) + "\n")
    print(f"wrote {args.frames} frames + poses.txt to {out}")
    print("camera: fu=fv=400 cu=320 cv=240 (pass --fu 400 --fv 400 "
          "--cu 320 --cv 240 to kitti_eval)")


if __name__ == "__main__":
    main()
