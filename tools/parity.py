"""Golden-set parity harness: compare the JAX pipeline vs the reference's
shipped verification datasets (brisk_verification_{harris,ast}.set).

Usage: JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu python tools/parity.py [harris|ast]

Reports per-image keypoint and descriptor agreement. The reference's own
notion of correctness is bit-exact golden comparison
(test-binary-equal.cc:82-88 params; bench-ds.h operator==) — this harness
measures how close the rebuild gets, with canonical (score, x, y) sort to
neutralize std::sort tie-order nondeterminism.
"""
from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ethzasl_brisk_jax.core.golden import read_set  # noqa: E402
from ethzasl_brisk_jax.utils.compile_cache import (  # noqa: E402
    use_compile_cache,
)

# Persistent compile cache: identical-code reruns skip the long
# sequential-loop compile of the exact-cache model.
use_compile_cache()

SET_DIR = "/root/reference/brisk/src/test/test_data"


def canon_order(kp: np.ndarray) -> np.ndarray:
    """Sort (N, F>=5) keypoint rows by (-response, x, y)."""
    return np.lexsort((kp[:, 1], kp[:, 0], -kp[:, 4]))


def align(got_kp, want_kp, xy_tol):
    """Match rows by nearest (x, y) within tol. Returns (gi, wi) indices."""
    from scipy.spatial import cKDTree

    tree = cKDTree(want_kp[:, :2])
    d, j = tree.query(got_kp[:, :2], distance_upper_bound=xy_tol)
    gi = np.where(np.isfinite(d))[0]
    wi = j[gi]
    # Drop duplicate want matches (keep first).
    _, first = np.unique(wi, return_index=True)
    gi, wi = gi[np.sort(first)], wi[np.sort(first)]
    return gi, wi


def compare_entry(name, got_kp, got_desc, want_kp, want_desc, xy_tol=2e-3):
    """got_kp/want_kp: (N, 5+) arrays [x, y, size, angle, response, ...]."""
    print(f"--- {name}")
    print(f"  keypoints: got {len(got_kp)}, want {len(want_kp)}")
    gi, wi = align(got_kp, want_kp, xy_tol)
    n = len(gi)
    miss = np.setdiff1d(np.arange(len(want_kp)), wi)
    extra = np.setdiff1d(np.arange(len(got_kp)), gi)
    print(f"  aligned: {n}; missing {len(miss)}; extra {len(extra)}")
    for lbl, idx, arr in (("missing", miss, want_kp), ("extra", extra, got_kp)):
        if len(idx):
            r = arr[idx, 4]
            print(
                f"  {lbl} responses: min {r.min():.0f} max {r.max():.0f}; "
                f"sample {[tuple(np.round(arr[i, :2], 1)) for i in idx[:4]]}"
            )
    g, w = got_kp[gi], want_kp[wi]
    dxy = np.abs(g[:, :2] - w[:, :2]).max(axis=1)
    resp_eq = g[:, 4] == w[:, 4]
    size_eq = g[:, 2] == w[:, 2]
    print(f"  max dxy: {dxy.max() if n else 0:.2e}; xy bit-eq: "
          f"{(dxy == 0).sum()}/{n}; response equal: {resp_eq.sum()}/{n}")
    if n and not resp_eq.all():
        bad = ~resp_eq
        dr = np.abs(g[bad, 4] - w[bad, 4])
        rel = dr / np.maximum(np.abs(w[bad, 4]), 1e-9)
        sz_eq = g[:, 2] == w[:, 2]
        print(
            f"  resp diffs: max {dr.max():.6g} rel max {rel.max():.2e}; "
            f"size bit-eq {sz_eq.sum()}/{n}; "
            f"mismatch sizes {sorted(set(np.round(w[bad, 2], 2)))[:8]}"
        )
        for i in np.flatnonzero(bad)[:4]:
            print(
                f"    resp#{i}: got {g[i, 4]!r} want {w[i, 4]!r} "
                f"size {g[i, 2]:.4f}/{w[i, 2]:.4f} xy {g[i, :2]}"
            )
    dang = np.abs(g[:, 3] - w[:, 3])
    dang = np.minimum(dang, 360 - dang)
    angle_eq = g[:, 3] == w[:, 3]
    print(f"  angle: bit-eq {angle_eq.sum()}/{n}; "
          f"<0.1deg {(dang < 0.1).sum()}/{n}; max {dang.max():.3f}")
    # Known exception: ONE swapped response-tie pair — the reference's
    # unstable std::sort decides which of two equal-response keypoints
    # survives greedy uniformity; the golden file captured one order.
    tie_pair = (
        len(miss) == 1 and len(extra) == 1
        and dxy.max() == 0 if n else False
    )
    if tie_pair:
        tie_pair = (
            float(want_kp[miss[0], 4]) == float(got_kp[extra[0], 4])
        )
        if tie_pair:
            print("  (1 missing + 1 extra with equal responses: the "
                  "documented response-tie sort-order pair — accepted)")
    desc_ok = True
    if got_desc.size and want_desc.size:
        gb = np.unpackbits(got_desc[gi], axis=1)
        wb = np.unpackbits(want_desc[wi], axis=1)
        hd = (gb != wb).sum(axis=1)
        desc_ok = bool((hd == 0).all())
        print(
            f"  desc: exact rows {(hd == 0).sum()}/{n}; "
            f"mean bit diff {hd.mean():.3f}/{gb.shape[1]}; max {hd.max()}"
        )
        worst = np.argsort(-hd)[:4]
        for i in worst:
            if hd[i]:
                print(
                    f"    worst#{i}: hd={hd[i]} angle {g[i, 3]:.3f} vs "
                    f"{w[i, 3]:.3f} resp {g[i, 4]:.0f} xy {g[i, :2]}"
                )
    # PARITY OK requires: every keypoint aligned (or the single
    # documented tie pair), bit-equal xy, response, size, ANGLE
    # (bench-ds.h:374 gates every field including angle), and every
    # descriptor byte.
    exact_full = n == len(want_kp) == len(got_kp)
    return (
        (exact_full or tie_pair)
        and resp_eq.all()
        and size_eq.all()
        and angle_eq.all()
        and desc_ok
        and ((dxy == 0).all() if n else True)
    )


def run_harris():
    import jax.numpy as jnp

    from ethzasl_brisk_jax.pipeline import BriskFeature

    entries = read_set(os.path.join(SET_DIR, "brisk_verification_harris.set"))
    feature = BriskFeature(
        octaves=0,
        uniformity_radius=30.0,
        absolute_threshold=20.0,
        max_candidates=16384,
        max_keypoints=16384,
        refine_dtype="float64",
        # Op-by-op detection (see BriskFeature.eager_exact): jit-fused
        # FMA contraction on XLA:CPU can flip the last ULP of a refined
        # coordinate vs the reference's scalar C++.
        eager_exact=True,
        # Host libm double atan2 chain — bit-exact angles.
        angle_exact=True,
    )
    all_ok = True
    for e in entries:
        kps, desc = feature.detect_and_compute(jnp.asarray(e.image))
        host = kps.to_numpy()
        got_kp = np.stack(
            [
                host["x"],
                host["y"],
                host["size"],
                host["angle"],
                host["response"],
            ],
            axis=1,
        )
        got_desc = np.asarray(desc)[np.asarray(kps.valid)]
        got_desc = got_desc.view(np.uint8).reshape(len(got_kp), -1)
        want = e.keypoint_array()  # x y size angle response octave class_id
        want_kp = want[:, :5]
        ok = compare_entry(
            e.path, got_kp, got_desc, want_kp, e.descriptors
        )
        all_ok &= bool(ok)
    print("PARITY OK" if all_ok else "PARITY INCOMPLETE")


def run_ast(raw_cache_model="exact"):
    """AST-pipeline golden parity (test-binary-equal.cc:322-331:
    BriskFeatureDetector(70) + default extractor)."""
    import jax.numpy as jnp

    # x64 stays ON: the reference's refinement mixes float operands with
    # double literals (brisk-scale-space.cc:1103 `1024.0 * s_05 + 0.5`),
    # so the C++ arithmetic is double; weak-literal x64 promotion matches.

    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    entries = read_set(os.path.join(SET_DIR, "brisk_verification_ast.set"))
    detector = BriskFeatureDetector(
        threshold=70, octaves=3, raw_cache_model=raw_cache_model,
        # Op-by-op detection: XLA:CPU's x86 backend FMA-contracts fused
        # mul+add chains (uncontrollable via flags), skewing refined
        # response/size tails vs the reference; eager rounds per-op like
        # the scalar C++ (see BriskFeatureDetector.eager_exact).
        eager_exact=True,
        # Host libm double atan2 chain — bit-exact angles.
        angle_exact=True,
    )
    all_ok = True
    for e in entries:
        kps, desc = detector.detect_and_compute(jnp.asarray(e.image))
        m = np.asarray(kps.valid)
        got_kp = np.stack(
            [
                np.asarray(kps.x)[m],
                np.asarray(kps.y)[m],
                np.asarray(kps.size)[m],
                np.asarray(kps.angle)[m],
                np.asarray(kps.response)[m],
            ],
            axis=1,
        )
        got_desc = np.asarray(desc)[m].view(np.uint8)
        want = e.keypoint_array()
        ok = compare_entry(
            e.path, got_kp, got_desc, want[:, :5], e.descriptors,
            xy_tol=5e-3,
        )
        all_ok &= bool(ok)
    print("PARITY OK" if all_ok else "PARITY INCOMPLETE")


def run_v1():
    """BRISK v1 legacy-engine parity vs fixtures generated from the
    compiled reference (tools/refbuild/ref_harness.cc `v1`:
    brisk_v1::BriskFeatureDetector(70, 3) + BriskDescriptorExtractor
    (true, true, 1.0), brisk-v1.cc:567-1425)."""
    import jax.numpy as jnp

    from ethzasl_brisk_jax.core.image_io import read_pgm
    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    fdir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures",
    )
    detector = BriskFeatureDetector(
        threshold=70, octaves=3, version="v1",
        raw_cache_model="exact",
        eager_exact=True,
        angle_exact=True,  # v1 uses the same double-atan2 (brisk-v1.cc:472)
    )
    all_ok = True
    for im in ("img1", "img2"):
        img = read_pgm(os.path.join(SET_DIR, f"{im}.pgm"))
        fix = np.load(os.path.join(fdir, f"v1_golden_{im}.npz"))
        kps, desc = detector.detect_and_compute(jnp.asarray(img))
        m = np.asarray(kps.valid)
        got_kp = np.stack(
            [
                np.asarray(kps.x)[m],
                np.asarray(kps.y)[m],
                np.asarray(kps.size)[m],
                np.asarray(kps.angle)[m],
                np.asarray(kps.response)[m],
            ],
            axis=1,
        )
        got_desc = np.asarray(desc)[m].view(np.uint8)
        want = fix["keypoints"]  # x y size angle response octave
        ok = compare_entry(
            im, got_kp, got_desc, want[:, :5], fix["descriptors"],
            xy_tol=5e-3,
        )
        all_ok &= bool(ok)
    print("PARITY OK" if all_ok else "PARITY INCOMPLETE")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "harris"
    if which == "harris":
        run_harris()
    elif which == "ast":
        run_ast(sys.argv[2] if len(sys.argv) > 2 else "exact")
    elif which == "v1":
        run_v1()
    elif which == "all":
        run_harris()
        run_ast("exact")
        run_v1()
    else:
        raise SystemExit(
            f"unknown pipeline {which!r}; use harris|ast|v1|all"
        )
