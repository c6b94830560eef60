"""End-to-end throughput on one GPU: detect + describe + match at 640x480.

    python bench.py                      # Harris pipeline (FramePipeline)
    BENCH_PIPELINE=ast python bench.py   # AST pipeline (AstFramePipeline)

Optional: BENCH_BATCH (default: workloads.HARRIS_BATCH / AST_BATCH),
BENCH_ITERS steps per run (10), BENCH_RUNS runs (3).

Prints ONE JSON line on stdout: the best run's frames/s with every run,
the device as JAX reports it, nvidia-smi's name and power limit of the
card, the batch, the first step's seconds (compile included) and the
peak device memory. Log lines go to stderr. The frames are seeded
(``workloads.seeded_frames``) and every static capacity is certified on
them before timing. Each run ends with ``jax.block_until_ready``.
Without a GPU the bench exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.parallel import FramePipeline, make_mesh
    from ethzasl_brisk_jax.utils.compile_cache import use_compile_cache
    from ethzasl_brisk_jax.utils.device import (
        NoGpuError,
        device_record,
        gpu_name_and_power_limit,
        require_gpu,
    )

    try:
        devices = require_gpu()
    except NoGpuError as e:
        log(f"bench: {e}")
        return 1
    card = gpu_name_and_power_limit()[0]
    use_compile_cache()
    pipeline = os.environ.get("BENCH_PIPELINE", "harris")
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    n_runs = int(os.environ.get("BENCH_RUNS", "3"))
    gpu = devices[0]
    mesh = make_mesh(1, 1, devices=[gpu])

    if pipeline == "harris":
        batch = int(os.environ.get("BENCH_BATCH", workloads.HARRIS_BATCH))
        feature = workloads.harris_feature()
        pipe = FramePipeline(feature=feature, mesh=mesh)
        frames = jax.device_put(workloads.seeded_frames(batch), gpu)
        cert, _ = workloads.certify_harris(feature, frames)
        metric = "frames_per_s_640x480_harris_detect_describe_match"
    elif pipeline == "ast":
        batch = int(os.environ.get("BENCH_BATCH", workloads.AST_BATCH))
        pipe = workloads.ast_pipeline(mesh)
        frames = jax.device_put(workloads.seeded_frames(batch, seed=2), gpu)
        cert = workloads.certify_ast(pipe, frames)
        metric = "frames_per_s_640x480_ast_detect_describe_match"
    else:
        log(f"bench: unknown BENCH_PIPELINE {pipeline!r}")
        return 2
    log(f"capacities certified on {batch} seeded frames: {cert}")

    with mesh:
        t0 = time.perf_counter()
        out = jax.block_until_ready(pipe.step(frames))
        first_step_s = time.perf_counter() - t0  # compile + one step
        if pipeline == "ast":
            workloads.certify_describe_budget(out[0], pipe.describe_capacity)
        jax.block_until_ready(pipe.step(frames))
        runs = []
        for _ in range(n_runs):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = pipe.step(frames)
            jax.block_until_ready(out)
            runs.append(batch * iters / (time.perf_counter() - t0))

    n_valid = jnp.sum(out[0].valid, axis=1)
    log(f"{pipeline}: batch {batch}, {iters} steps per run; keypoints/frame "
        f"min {int(n_valid.min())} max {int(n_valid.max())}; card {card}")
    stats = gpu.memory_stats() or {}
    print(json.dumps({
        "metric": metric,
        "value": max(runs),
        "unit": "frames/s/chip",
        "runs": runs,
        "device": device_record(devices),
        "card": card.rsplit(",", 1)[0].strip(),
        "power_limit": card.rsplit(",", 1)[-1].strip(),
        "batch": batch,
        "first_step_s": first_step_s,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
