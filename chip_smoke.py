#!/usr/bin/env python3
"""Chip smoke test: the BRISK detect -> describe -> match path on a GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the multi-device dry run only

Phases, in one process (a failed phase exits nonzero, with no result
line):

1. device    JAX's default backend must be a GPU. Prints its kind and
             count, and nvidia-smi's name and power limit of the card.
2. harris    ``FramePipeline.step`` at 480x640, batch 128, on seeded
             frames; capacities certified on those frames; memory
             analysis, peak memory, compile seconds, warm frames/s.
3. describe  The describe step of the Harris config alone: warm times.
4. ast       ``AstFramePipeline.step`` at 480x640 (threshold 70,
             octaves 3, dense engine), capacities certified; frames/s.
5. parity    Both steps again on the CPU for 4 frames, compared with the
             GPU's first 4 (``utils/backend_parity.py`` semantics); and
             the AST refinement's arithmetic on random inputs, GPU
             against CPU, with its products plain and fenced.
6. geometry  A 12-frame synthetic VO sequence, GPU against CPU: the
             trajectories, each frame pair's matches and inliers, and the
             pose refit from the CPU's inliers on both; the same with the
             geometry's products at default (TF32) precision as a
             control; one window BA solve.
7. gpu tests The tests marked ``gpu`` (``tests/test_gpu.py``), here.

``--four`` runs ``__graft_entry__.dryrun_multichip(4)`` on four real
cards: the (2, 2) mesh against one device, bitwise.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PARITY_FRAMES = 4
TIMED_ITERS = 5
VO_FRAMES = 12
# GPU vs CPU window-BA bounds (the VO's are in utils/backend_parity.py).
# Window BA is one f32 solve with the gauge fixed
# (workloads.BA_FIXED_POSES): the backends differ only in summation
# order and FMA contraction. On the CPU, 1e-6 relative noise on the
# observations moves the poses by ~1e-5 and the far points' depths by
# ~4e-4 (depth is the ill-conditioned direction).
BA_MAX_POSE_DIFF = 1e-4
BA_MAX_POINT_DIFF = 1e-3
BA_MAX_COST = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_runs(fn, args):
    """One warm call, then TIMED_ITERS calls each ended by
    block_until_ready. Returns (seconds per call, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times, out


def compile_step(jitted, *args):
    """AOT-compile a jitted step (the jit cache keeps the executable)
    and report its compile seconds and memory analysis."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    return secs, {
        k: getattr(mem, k)
        for k in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
    }


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_harris(gpu, card):
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.parallel import FramePipeline, make_mesh
    from ethzasl_brisk_jax.parallel.frames import _pipeline_step

    batch = workloads.HARRIS_BATCH
    feature = workloads.harris_feature()
    mesh = make_mesh(1, 1, devices=[gpu])
    pipe = FramePipeline(feature=feature, mesh=mesh)
    frames = jax.device_put(workloads.seeded_frames(batch), gpu)
    cert, kps = workloads.certify_harris(feature, frames)
    log(f"[harris] caps certified on {batch} frames: {cert}")
    with mesh:
        secs, mem = compile_step(
            _pipeline_step, feature.extractor.pattern, frames, feature, mesh
        )
        times, out = timed_runs(pipe.step, (frames,))
    n_valid = jnp.sum(out[0].valid, axis=1)
    log(f"[harris] compile {secs:.1f} s; memory_analysis {mem}; "
        f"peak_bytes_in_use {peak_bytes(gpu)}")
    log(f"[harris] 480x640 batch {batch}: step seconds {times}; "
        f"{batch / min(times):.1f} frames/s (best of {len(times)}), "
        f"keypoints/frame min {int(n_valid.min())} max "
        f"{int(n_valid.max())}; card {card}")
    if int(n_valid.min()) < 50:
        raise AssertionError("Harris step found too few keypoints")
    return feature, frames, kps, out


def phase_describe(feature, frames, kps, card):
    """The describe step alone on the Harris step's detections."""
    from ethzasl_brisk_jax.describe.extractor import (
        extract_descriptors_compact,
    )

    def describe(pat, fr, kp):
        return extract_descriptors_compact(
            pat, fr, kp,
            capacity=feature.describe_capacity * fr.shape[0],
            rotation_invariant=feature.rotation_invariant,
            scale_invariant=feature.scale_invariant,
            skip_small=feature.extractor.skip_small,
        )

    times, (dkp, _) = timed_runs(
        describe, (feature.extractor.pattern, frames, kps)
    )
    log(f"[describe] gather: {1e3 * min(times):.3f} ms per batch of "
        f"{frames.shape[0]} (runs {[round(1e3 * t, 3) for t in times]} ms),"
        f" {int(dkp.valid.sum())} keypoints described; card {card}")


def phase_ast(gpu, card):
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.parallel import make_mesh
    from ethzasl_brisk_jax.parallel.frames import _ast_pipeline_step

    batch = workloads.AST_BATCH
    mesh = make_mesh(1, 1, devices=[gpu])
    pipe = workloads.ast_pipeline(mesh)
    frames = jax.device_put(workloads.seeded_frames(batch, seed=2), gpu)
    cert = workloads.certify_ast(pipe, frames)
    log(f"[ast] caps certified on {batch} frames: {cert}")
    with mesh:
        secs, mem = compile_step(
            _ast_pipeline_step, pipe.detector.extractor.pattern, frames,
            pipe.detector, mesh, pipe.describe_capacity,
        )
        times, out = timed_runs(pipe.step, (frames,))
    n_desc = workloads.certify_describe_budget(out[0], pipe.describe_capacity)
    log(f"[ast] describe budget certified: {n_desc} described of "
        f"{pipe.describe_capacity * batch} slots")
    n_valid = jnp.sum(out[0].valid, axis=1)
    log(f"[ast] compile {secs:.1f} s; memory_analysis {mem}; "
        f"peak_bytes_in_use {peak_bytes(gpu)}")
    log(f"[ast] 480x640 batch {batch}: step seconds {times}; "
        f"{batch / min(times):.1f} frames/s (best of {len(times)}), "
        f"keypoints/frame min {int(n_valid.min())} max "
        f"{int(n_valid.max())}; card {card}")
    if int(n_valid.min()) < 50:
        raise AssertionError("AST step found too few keypoints")
    return pipe, frames, out


def phase_parity(name, step_on, frames, gpu_out, refined_rel=None):
    """Run ``step_on(device, frames)`` on the CPU for the first frames and
    compare with the GPU step's outputs for the same frames."""
    import jax

    from ethzasl_brisk_jax.utils.backend_parity import compare, step_outputs

    cpu = jax.devices("cpu")[0]
    n = PARITY_FRAMES
    kps, desc, midx, mdist = jax.device_get(gpu_out)
    got = step_outputs(
        jax.tree.map(lambda a: a[:n], kps), desc[:n], midx[: n - 1],
        mdist[: n - 1],
    )
    ref = step_outputs(*step_on(cpu, jax.device_put(frames[:n], cpu)))
    fails, seen = compare(ref, got, refined_rel)
    log(f"[parity] {name} GPU vs CPU on {n} frames: {seen}")
    if fails:
        raise AssertionError(f"{name} parity: {fails}")


def harris_on(feature):
    def run(dev, frames):
        import jax

        from ethzasl_brisk_jax.parallel import FramePipeline, make_mesh

        mesh = make_mesh(1, 1, devices=[dev])
        with mesh:
            out = FramePipeline(feature=feature, mesh=mesh).step(frames)
        return jax.device_get(out)

    return run


def ast_on(pipe):
    def run(dev, frames):
        import dataclasses

        import jax

        from ethzasl_brisk_jax.parallel import make_mesh

        mesh = make_mesh(1, 1, devices=[dev])
        with mesh:
            out = dataclasses.replace(pipe, mesh=mesh).step(frames)
        return jax.device_get(out)

    return run


def refinement_arithmetic(gpu) -> dict:
    """Where GPU and CPU f32 arithmetic part, on random inputs.

    ``a/b`` on each backend against the correctly rounded quotient
    (mismatches, max ULP); ``a*b + c*d`` against the unfused sum and
    against fma(a, b, c*d), emulated in f64; and the mismatches, GPU
    against CPU, of the AST refinement functions as the detector runs
    them, and with every product fenced (``_fmul`` exact in f64 under
    x64, the reference-exact CPU mode; the f32 divisions stay)."""
    import jax
    import numpy as np

    from ethzasl_brisk_jax.detect import ast_scale_space as ass
    from ethzasl_brisk_jax.utils.backend_parity import ulp_diff

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    n = 1 << 16
    patches = rng.integers(0, 256, (n, 3, 3)).astype(np.int32)
    scores = (rng.integers(0, 256 * 18, (3, n)) / 18.0).astype(np.float32)
    a, b, c, d = rng.uniform(-1, 1, (4, n)).astype(np.float32)

    def refine(p, s):
        return (ass.ast_subpixel2d(p), ass.refine1d(*s),
                ass.refine1d_1(*s), ass.refine1d_2(*s))

    def run(dev, fn, *args):
        return jax.tree.leaves(jax.device_get(
            jax.jit(fn)(*jax.device_put(args, dev))
        ))

    def mismatches(fn, *args):
        outs = [run(dev, fn, *args) for dev in (gpu, cpu)]
        return sum(int(np.sum(x != y)) for x, y in zip(*outs))

    ieee = a / b
    unfused = a * b + c * d
    fused = (a.astype(np.float64) * b + c * d).astype(np.float32)
    seen = {"of": n}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        q = run(dev, lambda a, b: a / b, a, b)[0]
        m = run(dev, lambda a, b, c, d: a * b + c * d, a, b, c, d)[0]
        seen[f"{name} a/b vs ieee"] = int(np.sum(q != ieee))
        seen[f"{name} a/b max ulp"] = int(ulp_diff(q, ieee).max())
        seen[f"{name} a*b+c*d vs unfused"] = int(np.sum(m != unfused))
        seen[f"{name} a*b+c*d vs fma(a,b,c*d)"] = int(np.sum(m != fused))
    seen["refine gpu vs cpu"] = mismatches(refine, patches, scores)
    with jax.enable_x64(True):
        seen["refine fenced gpu vs cpu"] = mismatches(
            refine, patches, scores
        )
    return seen


def make_vo():
    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.pipeline import BriskFeature
    from ethzasl_brisk_jax.vo import VoConfig, VoFrontend

    feature = BriskFeature(
        octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
        max_candidates=1024, max_keypoints=1024,
    )
    return VoFrontend(
        camera=workloads.vo_camera(), feature=feature, config=VoConfig()
    )


def run_vo(dev, frames, poses):
    """``VoFrontend.run_sequence`` on ``dev``, and for each frame pair the
    correspondences (ra, rb, matched) and the inlier mask its RANSAC
    voted for, drawn with run_sequence's keys."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    with jax.default_device(dev):
        vo = make_vo()
        norms = [
            np.linalg.norm(t1 - (r1 @ r0.T) @ t0)
            for (r0, t0), (r1, t1) in zip(poses, poses[1:])
        ]
        est = vo.run_sequence(frames, scale_norms=norms)
        feats = [vo.process_frame(jnp.asarray(f)) for f in frames]
        key = jax.random.PRNGKey(0)
        pairs = []
        for fa, fb in zip(feats, feats[1:]):
            key, sub = jax.random.split(key)
            _, ra, rb, matched = vo.correspondences(*fa, *fb)
            inl = vo.relative_pose(sub, *fa, *fb)[-1]
            pairs.append(jax.device_get((ra, rb, matched, inl)))
    return est, pairs


def refit(dev, pairs):
    """``pose_from_inliers`` on ``dev`` for each pair's (ra, rb, inliers)."""
    import jax

    from ethzasl_brisk_jax.geometry.ransac import pose_from_inliers

    return [
        jax.device_get(pose_from_inliers(
            *jax.device_put((ra, rb, inl), dev)
        ))
        for ra, rb, _, inl in pairs
    ]


def with_default_precision(fn):
    """Run ``fn`` with the geometry's products (utils/precise.py) at
    Precision.DEFAULT, which a GPU may run in TF32: the control that
    shows what the HIGHEST wrappers keep out."""
    import jax

    from ethzasl_brisk_jax.utils import precise

    saved = precise.HIGHEST
    precise.HIGHEST = jax.lax.Precision.DEFAULT
    jax.clear_caches()  # retrace the jitted geometry with DEFAULT
    try:
        return fn()
    finally:
        precise.HIGHEST = saved
        jax.clear_caches()


def trajectory_diff(a, b):
    import numpy as np

    from ethzasl_brisk_jax.utils.backend_parity import rotation_deg

    rot = max(rotation_deg(x[:3, :3], y[:3, :3]) for x, y in zip(a, b))
    center = max(float(np.linalg.norm(x[:3, 3] - y[:3, 3]))
                 for x, y in zip(a, b))
    return rot, center


def poses_diff(a, b):
    import numpy as np

    from ethzasl_brisk_jax.utils.backend_parity import rotation_deg

    rot = max(rotation_deg(x[0], y[0]) for x, y in zip(a, b))
    t = max(float(np.linalg.norm(x[1] - y[1])) for x, y in zip(a, b))
    return rot, t


def run_ba(dev, problem):
    import jax

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.ba import solve_window_ba

    with jax.default_device(dev):
        out, costs = solve_window_ba(
            jax.device_put(problem, dev), iterations=10,
            fix_poses=workloads.BA_FIXED_POSES,
        )
        return jax.device_get((out, costs))


def phase_geometry(gpu):
    import jax
    import numpy as np

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.utils import backend_parity as bp

    cpu = jax.devices("cpu")[0]
    frames, poses = workloads.vo_sequence(VO_FRAMES)
    (est_g, pairs_g), (est_c, pairs_c) = (
        run_vo(d, frames, poses) for d in (gpu, cpu)
    )
    for i, (g, c) in enumerate(zip(pairs_g, pairs_c)):
        log(f"[geometry] pair {i}: matched {int(c[2].sum())}, matched-mask "
            f"diffs {int((g[2] != c[2]).sum())}, inliers {int(c[3].sum())}, "
            f"inlier-mask diffs {int((g[3] != c[3]).sum())}")
    vo_rot, vo_center = trajectory_diff(est_g, est_c)
    gt = np.stack([-(r.T @ t) for r, t in poses])
    ate = np.linalg.norm(np.stack([p[:3, 3] for p in est_g]) - gt, axis=1)
    log(f"[geometry] VO {len(frames)} frames GPU vs CPU: max rotation "
        f"{vo_rot:.3e} deg, max center {vo_center:.3e} m (bounds "
        f"{bp.VO_MAX_ROT_DEG}, {bp.VO_MAX_CENTER_M}); GPU max center error "
        f"vs ground truth {ate.max():.3e} m")
    ref = refit(cpu, pairs_c)
    refit_rot, refit_t = poses_diff(refit(gpu, pairs_c), ref)
    log(f"[geometry] refit from the CPU's inliers, GPU vs CPU: max "
        f"rotation {refit_rot:.3e} deg, max |t| diff {refit_t:.3e} (bounds "
        f"{bp.REFIT_MAX_ROT_DEG}, {bp.REFIT_MAX_T})")
    ctrl_refit, ctrl_est = with_default_precision(
        lambda: (refit(gpu, pairs_c), run_vo(gpu, frames, poses)[0])
    )
    log("[geometry] control, products at DEFAULT precision on the GPU: "
        "refit max rotation %.3e deg, max |t| diff %.3e; VO max rotation "
        "%.3e deg, max center %.3e m"
        % (*poses_diff(ctrl_refit, ref), *trajectory_diff(ctrl_est, est_c)))
    if refit_rot > bp.REFIT_MAX_ROT_DEG or refit_t > bp.REFIT_MAX_T:
        raise AssertionError("pose refit GPU vs CPU beyond its bounds")
    if vo_rot > bp.VO_MAX_ROT_DEG or vo_center > bp.VO_MAX_CENTER_M:
        raise AssertionError("VO GPU vs CPU beyond its bounds")

    problem = workloads.synthetic_ba_problem()
    (pg, cg), (pc, cc) = run_ba(gpu, problem), run_ba(cpu, problem)

    def diff(*fields):
        return max(
            float(np.abs(np.asarray(getattr(pg, f))
                         - np.asarray(getattr(pc, f))).max())
            for f in fields
        )

    pose_diff, point_diff = diff("r", "t"), diff("points")
    log(f"[geometry] window BA GPU vs CPU: final cost {float(cg[-1]):.4e} "
        f"vs {float(cc[-1]):.4e} (from {float(cg[0]):.4e}), max |r, t| "
        f"diff {pose_diff:.3e}, max |points| diff {point_diff:.3e}")
    if (pose_diff > BA_MAX_POSE_DIFF or point_diff > BA_MAX_POINT_DIFF
            or max(float(cg[-1]), float(cc[-1])) > BA_MAX_COST):
        raise AssertionError("window BA GPU vs CPU beyond its bounds")


def phase_gpu_tests():
    import pytest

    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider",
        str(ROOT / "tests" / "test_gpu.py"),
    ])
    log(f"[gpu tests] pytest -m gpu exit code {int(rc)}")
    if rc != 0:
        raise AssertionError("gpu-marked tests failed")


def phase_four():
    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(4, virtual=False)
    log(f"[four] dryrun_multichip(4): the (2, 2) GPU mesh equals one "
        f"device, bitwise; {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU multi-device dry run")
    args = ap.parse_args(argv)

    # The parity phases need the CPU backend beside the GPU's.
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, str(ROOT))
    try:
        from ethzasl_brisk_jax.utils.backend_parity import AST_REFINED_REL
        from ethzasl_brisk_jax.utils.compile_cache import use_compile_cache
        from ethzasl_brisk_jax.utils.device import (
            NoGpuError,
            device_record,
            gpu_name_and_power_limit,
            require_gpu,
        )
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}",
              file=sys.stderr)
        return 2

    try:
        devices = require_gpu(4 if args.four else 1)
        rec = device_record(devices)
        card = "; ".join(gpu_name_and_power_limit())
        log(f"[device] {rec}; nvidia-smi name, power.limit: {card}")
        use_compile_cache()
        if args.four:
            phase_four()
        else:
            gpu = devices[0]
            feature, frames, kps, out = phase_harris(gpu, card)
            phase_describe(feature, frames, kps, card)
            phase_parity("harris", harris_on(feature), frames, out)
            del kps, out
            pipe, ast_frames, ast_out = phase_ast(gpu, card)
            phase_parity("ast", ast_on(pipe), ast_frames, ast_out,
                         refined_rel=AST_REFINED_REL)
            log(f"[parity] f32 arithmetic on random inputs: "
                f"{refinement_arithmetic(gpu)}")
            phase_geometry(gpu)
            phase_gpu_tests()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # any failed phase: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
