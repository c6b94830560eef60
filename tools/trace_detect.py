"""Trace the Harris detect step on the GPU and attribute its device time.

    python tools/trace_detect.py [--batch 128] [--steps 3]
        [--out chiprun_out/trace_detect]

Compiles ``jit(vmap(feature.detect))`` of the bench Harris configuration
on seeded 480x640 frames, traces a few warm steps with ``jax.profiler``
and reduces the trace: device busy time per step, the top device ops,
and the device time of the Harris score fusions (the HLO instructions
whose ops carry the ``harris`` name scope) against the least time the
card needs to move their bytes (one uint8 read and one int32 write per
pixel of every pyramid layer, at the published 3.35 TB/s). XLA's command
buffers are switched off here, so that the trace shows each kernel
rather than one graph launch. Refuses to run without a GPU.
"""
from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def scoped_instructions(hlo_text: str, scope: str) -> set[str]:
    """Names of the entry-level HLO instructions whose op_name metadata
    lies under ``scope`` (also with dots turned into underscores, as
    GPU kernel names spell them)."""
    names = set()
    pat = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m and re.search(rf"(^|[/(]){re.escape(scope)}([/)]|$)", m.group(2)):
            names.add(m.group(1))
            names.add(m.group(1).replace(".", "_"))
    return names


def device_events(xplane_path: str):
    """(op name, start ns, duration ns) of every op on the first GPU."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            print(f"trace line {plane.name} / {line.name}: {len(evs)} events")
            if line.name in ("XLA Modules", "XLA Ops", "Steps"):
                continue  # summaries of the stream events
            for ev in evs:
                stats = dict(ev.stats)
                name = stats.get("hlo_op") or ev.name
                events.append((str(name), ev.start_ns, ev.duration_ns))
    return events


def busy_ns(events) -> float:
    """Length of the union of the event intervals."""
    total, end = 0.0, None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if end is None or s > end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def main() -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/trace_detect")
    args = ap.parse_args()

    import jax

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.detect.scale_space import build_pyramid
    from ethzasl_brisk_jax.kernels.harris import harris_score_i32
    from ethzasl_brisk_jax.utils.compile_cache import use_compile_cache
    from ethzasl_brisk_jax.utils.device import (
        gpu_name_and_power_limit,
        require_gpu,
    )

    gpu = require_gpu()[0]
    card = "; ".join(gpu_name_and_power_limit())
    use_compile_cache()
    feature = workloads.harris_feature()
    frames = jax.device_put(workloads.seeded_frames(args.batch), gpu)
    detect = jax.jit(jax.vmap(feature.detect))
    compiled = detect.lower(frames).compile()
    harris_ops = scoped_instructions(compiled.as_text(), "harris")
    jax.block_until_ready(detect(frames))

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        for _ in range(args.steps):
            jax.block_until_ready(detect(frames))
    wall = (time.perf_counter() - t0) / args.steps
    paths = sorted(glob.glob(f"{args.out}/plugins/profile/*/*.xplane.pb"))
    events = device_events(paths[-1])

    per_op = collections.Counter()
    for name, _, d in events:
        per_op[name] += d
    step_busy = busy_ns(events) / args.steps
    harris_seen = [k for k in per_op if k in harris_ops]
    harris_ns = sum(per_op[k] for k in harris_seen) / args.steps

    pyramid = jax.jit(
        jax.vmap(lambda im: build_pyramid(im, feature.config.n_layers))
    )(frames)
    harris = jax.jit(lambda pyr: [jax.vmap(harris_score_i32)(l) for l in pyr])
    jax.block_until_ready(harris(pyramid))
    alone = []
    for _ in range(5):
        t1 = time.perf_counter()
        jax.block_until_ready(harris(pyramid))
        alone.append(time.perf_counter() - t1)
    nbytes = sum(l.size * (1 + 4) for l in pyramid)
    bound_ns = nbytes / PEAK_BYTES_PER_S * 1e9

    print(f"card: {card}; device_kind {gpu.device_kind}")
    print(f"detect step, batch {args.batch} at 480x640: wall "
          f"{wall * 1e3:.3f} ms/step (traced), device busy "
          f"{step_busy / 1e6:.3f} ms/step, {len(events)} device events")
    print(f"harris kernels ({len(harris_seen)} in the trace): "
          f"{harris_ns / 1e6:.3f} ms/step; bytes bound "
          f"{nbytes / 1e6:.1f} MB / 3.35 TB/s = {bound_ns / 1e6:.3f} ms "
          f"-> {bound_ns / max(harris_ns, 1):.1%} of the bound")
    print(f"harris alone over the pyramid (jit, block_until_ready): "
          f"{[round(t * 1e3, 3) for t in alone]} ms -> "
          f"{bound_ns / 1e9 / min(alone):.1%} of the bound")
    print("top device ops (ms/step, harris-scoped marked *):")
    for name, v in per_op.most_common(15):
        mark = "*" if name in harris_ops else " "
        print(f"  {mark} {v / args.steps / 1e6:9.3f}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
