"""Live matching pipeline over an image directory.

The batched-device equivalent of the reference's ROS live demo
(``brisk_ros_demo/src/livedemo.cc``): instead of a ROS subscriber + boost
visualizer threads, a native multithreaded loader (native/briskio.cc)
streams PGM frames into the batched device pipeline, which detects,
describes and matches, and prints per-batch statistics (the demo's
FPS/HUD, reference livedemo.cc:213).

Reference-demo semantics (livedemo.cc:316-344, 623-636): the demo
accumulates the first N_REF frames as a persistent REFERENCE collection
(``cv::DescriptorMatcher::add``) and radius-matches every incoming
frame against it, reporting per-reference-image match counts — in
addition to the consecutive-frame matching the batched pipeline step
already performs (including the batch-boundary pair, which earlier
versions skipped).

Usage:
  python examples/live_pipeline.py <dir-with-pgm-frames> [batch] [draw_dir]

With ``draw_dir``, each matched pair is rendered like the reference
visualizer (livedemo.cc:224-296): the two frames side by side, keypoint
circles scaled by size, and green match lines, written as PGM files —
the headless stand-in for its OpenCV window.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

N_REF = 2          # reference frames accumulated (livedemo keeps 1-2)
MATCH_RADIUS = 90  # Hamming radius for the HUD counts


def main():
    import os

    import jax

    if os.environ.get("LIVE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from ethzasl_brisk_jax.core.image_io import read_pgm_batch
    from ethzasl_brisk_jax.match.matcher import (
        DescriptorCollection,
        hamming_distance_matrix,
        radius_match_collection,
    )
    from ethzasl_brisk_jax.parallel import FramePipeline, make_mesh
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.utils.timing import Timing, timer

    directory = pathlib.Path(
        sys.argv[1]
        if len(sys.argv) > 1
        else "/root/reference/brisk/src/test/test_data"
    )
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    draw_dir = pathlib.Path(sys.argv[3]) if len(sys.argv) > 3 else None
    if draw_dir:
        draw_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(str(p) for p in directory.glob("*.pgm"))
    if not paths:
        raise SystemExit(f"no .pgm files in {directory}")
    # Cycle the directory so the demo always has full batches.
    while len(paths) < batch + 1:
        paths = paths + paths

    feature = BriskFeature(
        octaves=2,
        uniformity_radius=0.0,
        absolute_threshold=30.0,
        max_candidates=512,
        max_keypoints=512,
    )
    pipe = FramePipeline(feature=feature, mesh=make_mesh(1, 1))

    # One-shot capacity certification on the first frame (the library
    # diagnostics API — silently-truncating caps would otherwise skew
    # every HUD count).
    from ethzasl_brisk_jax.core.image_io import read_pgm

    first = jnp.asarray(np.asarray(read_pgm(paths[0])))
    _, diag = jax.jit(feature.detect_with_diagnostics)(first)
    if not bool(np.asarray(diag.ok)):
        print(
            "WARNING: detector capacity overflow on the first frame "
            f"(candidates {np.asarray(diag.cand_counts).tolist()} vs "
            f"caps {np.asarray(diag.cand_caps).tolist()}) — weakest "
            "candidates are being dropped; raise max_candidates.",
        )

    reference = DescriptorCollection()

    @jax.jit
    def boundary_match(qd, td, qv, tv):
        """Match the first frame of a batch against the previous
        batch's tail frame (the pair the in-batch step cannot see)."""
        d = hamming_distance_matrix(qd, td)
        d = jnp.where(tv[None, :], d, 385)
        best = jnp.argmin(d, axis=1).astype(jnp.int32)
        bd = jnp.min(d, axis=1)
        return best, jnp.where(qv, bd, 385)

    n_batches = max(1, (len(paths) - 1) // batch)
    prev_tail = None  # (frame_np, desc, valid) of the previous batch tail
    for bi in range(n_batches):
        chunk = paths[bi * batch : bi * batch + batch]
        with timer("0 load (native threaded)"):
            frames_np = read_pgm_batch(chunk)
        frames = jnp.asarray(frames_np)
        with timer("1 detect+describe+match (device)", block_on=None):
            kps, desc, midx, mdist = pipe.step(frames)
            jax.block_until_ready(mdist)
        n_kp = np.asarray(kps.valid).sum(axis=1)
        n_match = (np.asarray(mdist) < MATCH_RADIUS).sum(axis=1)

        # Batch-boundary pair: first frame of this batch vs the last
        # frame of the previous one.
        boundary_n = None
        if prev_tail is not None:
            _, bdist = boundary_match(
                desc[0], prev_tail[1], kps.valid[0], prev_tail[2]
            )
            boundary_n = int((np.asarray(bdist) < MATCH_RADIUS).sum())

        # Persistent reference-frame matching (livedemo semantics).
        if len(reference) < N_REF:
            for fi in range(min(N_REF - len(reference), len(chunk))):
                reference.add(desc[fi], kps.valid[fi])
            print(f"batch {bi}: reference collection now "
                  f"{len(reference)} frame(s)")
        with timer("2 radius-match vs reference (device)"):
            ref_counts = np.zeros((len(chunk), len(reference)), np.int64)
            for fi in range(len(chunk)):
                img_idx, _, _, counts = radius_match_collection(
                    desc[fi], reference, MATCH_RADIUS,
                    query_valid=kps.valid[fi],
                )
                ii = np.asarray(img_idx)
                cc = np.asarray(counts)
                for ri in range(len(reference)):
                    # count matched (query, train) pairs landing on ref ri
                    ref_counts[fi, ri] = int(
                        ((ii >= 0) & (ii == ri)).sum()
                    )
        hud = "  ".join(
            f"ref{ri}:{ref_counts[:, ri].mean():.0f}"
            for ri in range(len(reference))
        )
        print(
            f"batch {bi}: frames {len(chunk)}  "
            f"keypoints/frame {n_kp.mean():.0f}  "
            f"matches/pair {n_match.mean():.0f}"
            + (f"  boundary-pair {boundary_n}" if boundary_n is not None
               else "")
            + f"  ref-matches/frame [{hud}]"
        )
        if draw_dir is not None:
            from examples.draw import draw_matches

            host_kps = jax.tree.map(np.asarray, kps)
            for pi in range(len(chunk) - 1):
                img = draw_matches(
                    frames_np[pi], frames_np[pi + 1],
                    host_kps, pi, np.asarray(midx[pi]),
                    np.asarray(mdist[pi]), max_dist=MATCH_RADIUS,
                )
                from ethzasl_brisk_jax.core.image_io import write_pgm

                write_pgm(
                    str(draw_dir / f"match_{bi:03d}_{pi:02d}.pgm"), img
                )
        prev_tail = (frames_np[-1], desc[-1], kps.valid[-1])
    print()
    print(Timing.print_timing())
    if draw_dir is not None:
        print(f"match visualizations written to {draw_dir}")


if __name__ == "__main__":
    main()
