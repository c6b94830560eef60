"""Generate the BRISK v2 sampling-pattern data asset.

Parses the public BRISK v2 pattern table (the ``brisk.ptn`` text format:
point count, then ``x y sigma`` rows, then short-pair and long-pair index
lists — format per reference ``brisk/src/brisk-descriptor-extractor.cc:180-291``)
and stores it as a compressed ``.npz`` data asset inside the package.

This is *data* (sampling-pattern constants published with BRISK v2), not code.

Usage:  python tools/gen_pattern_data.py <path-to-brisk.ptn>
"""
import sys

import numpy as np


def parse_ptn(path: str):
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)
    n_points = int(next(it))
    pts = np.array(
        [[float(next(it)) for _ in range(3)] for _ in range(n_points)],
        dtype=np.float64,
    )  # (N, 3): x, y, sigma
    n_short = int(next(it))
    short_pairs = np.array(
        [[int(next(it)), int(next(it))] for _ in range(n_short)], dtype=np.int32
    )  # (S, 2): i, j
    n_long = int(next(it))
    long_pairs = np.array(
        [[int(next(it)), int(next(it))] for _ in range(n_long)], dtype=np.int32
    )  # (L, 2): i, j
    return pts, short_pairs, long_pairs


def main():
    src = sys.argv[1]
    dst = sys.argv[2] if len(sys.argv) > 2 else (
        "ethzasl_brisk_jax/core/brisk_v2_pattern.npz")
    pts, short_pairs, long_pairs = parse_ptn(src)
    np.savez_compressed(
        dst,
        points=pts,
        short_pairs=short_pairs,
        long_pairs=long_pairs,
    )
    print(f"wrote {dst}: {len(pts)} points, {len(short_pairs)} short, "
          f"{len(long_pairs)} long")


if __name__ == "__main__":
    main()
